"""Public wrapper of the ``neighbor_gather`` kernel.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  B = 0 returns empty results, and E = 0 or V = 0 (a
CSR's offsets then hold only zeros) returns all -1 rows and zero degrees,
without a launch.
"""
from __future__ import annotations

import torch

from .. import _lib
from .kernel import neighbor_gather_kernel
from .ref import neighbor_gather_ref


def neighbor_gather(vertices: torch.Tensor, offsets: torch.Tensor,
                    targets: torch.Tensor, *, width: int = 128):
    """For each vertex id of ``vertices`` (B,) int32: the first ``width``
    entries of its CSR row, padded with -1, and its degree, as
    ``(neighbors (B, width) int32, degrees (B,) int32)``.

    ``offsets`` (V+1,) is a CSR's, int64 or int32; ``targets`` (E,) int32.
    Ids index ``offsets`` as JAX indexes: a negative id wraps once by V+1,
    then clamps to [0, V] (so id -1 reads an all -1 row and degree -E).
    The reference's ``bt`` is the TPU kernel's tile of vertices per grid
    step and has no counterpart here."""
    width = int(width)
    if width <= 0:
        raise ValueError(f"width must be positive, got {width}")
    for t, name in ((vertices, "vertices"), (offsets, "offsets"),
                    (targets, "targets")):
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got {tuple(t.shape)}")
    if vertices.dtype != torch.int32 or targets.dtype != torch.int32:
        raise ValueError(f"vertices and targets must be int32, got "
                         f"{vertices.dtype} and {targets.dtype}")
    if offsets.dtype not in (torch.int64, torch.int32):
        raise ValueError(f"offsets must be int64 or int32, got "
                         f"{offsets.dtype}")
    if offsets.shape[0] == 0:
        raise ValueError("offsets must hold at least one entry (V + 1)")
    if vertices.device.type == "cpu":
        return neighbor_gather_ref(vertices, offsets, targets, width=width)
    _lib.require(vertices, torch.int32, "vertices")
    _lib.require(offsets, offsets.dtype, "offsets")
    _lib.require(targets, torch.int32, "targets")
    _lib.check_device(vertices)
    b, dev = vertices.shape[0], vertices.device
    if b == 0 or targets.shape[0] == 0 or offsets.shape[0] == 1:
        return (torch.full((b, width), -1, dtype=torch.int32, device=dev),
                torch.zeros(b, dtype=torch.int32, device=dev))
    out = neighbor_gather_kernel(vertices.contiguous(), offsets.contiguous(),
                                 targets.contiguous(), width)
    _lib.LAUNCHES["neighbor_gather"] += 1
    return out
