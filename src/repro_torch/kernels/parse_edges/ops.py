"""Public wrapper of the ``parse_bytes`` kernel.

A CPU tensor takes the plain PyTorch version (:mod:`.ref`); a CUDA tensor
launches the kernel or raises.  Nothing falls back.
"""
from __future__ import annotations

import torch

from .. import _lib
from .kernel import parse_bytes_kernel
from .ref import parse_bytes_ref


def parse_bytes(bufs: torch.Tensor, owned_start: int, owned_end: int, *,
                weighted: bool, base: int):
    """Per-byte parse of ``(nb, buf_len)`` uint8 blocks: ``(valid, src,
    dst, w)``, the contract of the reference's ``parse_bytes_kernel``.

    ``bufs`` may be a strided view over a flat span (rows ``beta`` bytes
    apart, overlapping by ``buf_len - beta``); its columns must be
    contiguous.  ``w`` is None when unweighted.
    """
    if bufs.dtype != torch.uint8 or bufs.dim() != 2:
        raise ValueError(f"bufs must be a 2-D uint8 tensor, got "
                         f"{tuple(bufs.shape)} {bufs.dtype}")
    if bufs.device.type == "cpu":
        return parse_bytes_ref(bufs, owned_start, owned_end,
                               weighted=weighted, base=base)
    _lib.require(bufs, torch.uint8, "bufs")
    _lib.check_device(bufs)
    if bufs.shape[1] > 1 and bufs.stride(1) != 1:
        raise ValueError("bufs needs unit column stride")
    if bufs.stride(0) < 0:
        raise ValueError("bufs needs a non-negative row stride")
    if bufs.numel() == 0:
        empty = torch.empty(bufs.shape, dtype=torch.int32, device=bufs.device)
        return (empty.bool(), empty, empty.clone(),
                empty.float() if weighted else None)
    out = parse_bytes_kernel(bufs, owned_start, owned_end, weighted=weighted,
                             base=base)
    _lib.LAUNCHES["parse_bytes"] += 1
    return out
