"""Launch of the ``exclusive_scan`` CUDA kernel (``csrc/exclusive_scan.cu``).

Replaces ``repro/kernels/exclusive_scan/kernel.py:38``
``exclusive_scan_kernel``.  One memset of the look-back scratch and one
single-pass kernel per call.
"""
from __future__ import annotations

import torch

from .. import _lib


def exclusive_scan_kernel(x: torch.Tensor) -> torch.Tensor:
    """``(N+1,)`` int32 for a contiguous CUDA int32 vector with N > 0: the
    exclusive prefix sums in ``[0, N)``, the total at ``N``."""
    n = x.shape[0]
    lib = _lib.lib()
    out = torch.empty(n + 1, dtype=torch.int32, device=x.device)
    scratch = torch.empty(lib.repro_exclusive_scan_scratch_bytes(n),
                          dtype=torch.uint8, device=x.device)
    status = lib.repro_exclusive_scan(x.data_ptr(), n, out.data_ptr(),
                                      scratch.data_ptr(), _lib.stream_of(x))
    _lib.check(status, "exclusive_scan launch")
    return out
