"""Launch of the ``exclusive_scan`` CUDA kernels (``csrc/exclusive_scan.cu``).

Replaces ``repro/kernels/exclusive_scan/kernel.py:38``
``exclusive_scan_kernel``.
"""
from __future__ import annotations

import torch

from .. import _lib


def exclusive_scan_kernel(x: torch.Tensor):
    """``(exclusive prefix sums (N,), total ())`` of a contiguous CUDA int32
    vector with N > 0."""
    n = x.shape[0]
    lib = _lib.lib()
    out = torch.empty_like(x)
    total = torch.empty((), dtype=torch.int32, device=x.device)
    tile_sums = torch.empty(lib.repro_exclusive_scan_tiles(n),
                            dtype=torch.int32, device=x.device)
    status = lib.repro_exclusive_scan(x.data_ptr(), n, out.data_ptr(),
                                      total.data_ptr(), tile_sums.data_ptr(),
                                      _lib.stream_of(x))
    _lib.check(status, "exclusive_scan launch")
    return out, total
