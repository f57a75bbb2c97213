"""Public wrapper of the ``degree_histogram`` kernel.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  An empty input or V = 0 returns zeros without a launch.
"""
from __future__ import annotations

import torch

from .. import _lib
from .kernel import degree_histogram_kernel
from .ref import degree_histogram_ref


def degree_histogram(src: torch.Tensor, *, num_vertices: int):
    """Per-vertex count of ``src`` ids in ``[0, num_vertices)`` (-1 padding
    and ids >= V ignored) as int32: ``(num_vertices,)`` for a 1-D ``src``,
    ``(rows, num_vertices)`` for a 2-D ``(rows, P)`` one, row by row (the
    staged build's partitions in one launch)."""
    if src.dtype != torch.int32 or src.dim() not in (1, 2):
        raise ValueError(f"src must be a 1-D or 2-D int32 tensor, got "
                         f"{tuple(src.shape)} {src.dtype}")
    v = int(num_vertices)
    if v < 0:
        raise ValueError(f"num_vertices must be >= 0, got {v}")
    if src.device.type == "cpu":
        return degree_histogram_ref(src, num_vertices=v)
    _lib.require(src, torch.int32, "src")
    _lib.check_device(src)
    if src.numel() == 0 or v == 0:
        return torch.zeros((*src.shape[:-1], v), dtype=torch.int32,
                           device=src.device)
    rows = src if src.dim() == 2 else src[None]
    deg = degree_histogram_kernel(rows.contiguous(), v)
    _lib.LAUNCHES["degree_histogram"] += 1
    return deg if src.dim() == 2 else deg[0]
