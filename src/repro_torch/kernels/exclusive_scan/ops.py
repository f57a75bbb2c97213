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


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 1:
        raise ValueError(f"x must be a 1-D int32 tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _scan_cuda(x: torch.Tensor) -> torch.Tensor:
    """``(N+1,)`` int32 on the card: the prefix, then the total."""
    _lib.require(x, torch.int32, "x")
    _lib.check_device(x)
    if x.shape[0] == 0:
        return torch.zeros(1, dtype=torch.int32, device=x.device)
    out = exclusive_scan_kernel(x.contiguous())
    _lib.LAUNCHES["exclusive_scan"] += 1
    return out


def exclusive_scan(x: torch.Tensor):
    """``(exclusive int32 prefix sums, int32 total)`` of a 1-D int32
    tensor; the total stays on ``x``'s device.  On CUDA both are views of
    one ``(N+1,)`` buffer."""
    _check(x)
    if x.device.type == "cpu":
        return exclusive_scan_ref(x)
    out = _scan_cuda(x)
    return out[:-1], out[-1]


def csr_offsets(degrees: torch.Tensor) -> torch.Tensor:
    """degrees (V,) int32 -> offsets (V+1,) int32 through the scan; on
    CUDA the kernel's own output buffer, with no copy."""
    _check(degrees)
    if degrees.device.type == "cpu":
        excl, total = exclusive_scan_ref(degrees)
        return torch.cat([excl, total[None]])
    return _scan_cuda(degrees)
