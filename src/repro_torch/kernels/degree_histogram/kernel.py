"""Launch of the ``degree_histogram`` CUDA kernel
(``csrc/degree_histogram.cu``).

Replaces ``repro/kernels/degree_histogram/kernel.py:48``
``degree_histogram_kernel``.
"""
from __future__ import annotations

import torch

from .. import _lib


def degree_histogram_kernel(src: torch.Tensor, num_vertices: int):
    """Degrees ``(num_vertices,)`` int32 of a contiguous CUDA int32 ``src``
    with E > 0 and V > 0."""
    deg = torch.zeros(num_vertices, dtype=torch.int32, device=src.device)
    status = _lib.lib().repro_degree_histogram(
        src.data_ptr(), src.shape[0], deg.data_ptr(), num_vertices,
        _lib.stream_of(src))
    _lib.check(status, "degree_histogram launch")
    return deg
