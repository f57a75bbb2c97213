"""Public wrappers of the ``exclusive_scan`` kernel.

A CPU tensor takes the plain PyTorch version; a CUDA tensor launches the
kernel or raises.  N = 0 returns an empty scan and a zero total without a
launch.
"""
from __future__ import annotations

import torch

from .. import _lib
from .kernel import exclusive_scan_kernel
from .ref import exclusive_scan_ref


def exclusive_scan(x: torch.Tensor):
    """``(exclusive int32 prefix sums, int32 total)`` of a 1-D int32
    tensor; the total stays on ``x``'s device."""
    if x.dtype != torch.int32 or x.dim() != 1:
        raise ValueError(f"x must be a 1-D int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return exclusive_scan_ref(x)
    _lib.require(x, torch.int32, "x")
    _lib.check_device(x)
    if x.shape[0] == 0:
        return x.clone(), torch.zeros((), dtype=torch.int32, device=x.device)
    out = exclusive_scan_kernel(x.contiguous())
    _lib.LAUNCHES["exclusive_scan"] += 1
    return out


def csr_offsets(degrees: torch.Tensor) -> torch.Tensor:
    """degrees (V,) int32 -> offsets (V+1,) int32 through the scan."""
    excl, total = exclusive_scan(degrees)
    return torch.cat([excl, total[None]])
