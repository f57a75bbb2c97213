"""Launch of the ``degree_histogram`` CUDA kernel
(``csrc/degree_histogram.cu``).

Replaces ``repro/kernels/degree_histogram/kernel.py:48``
``degree_histogram_kernel``.  One memset of the output and one kernel per
call, for one row or a batch of rows.
"""
from __future__ import annotations

import torch

from .. import _lib


def degree_histogram_kernel(src: torch.Tensor, num_vertices: int):
    """Degrees ``(rows, num_vertices)`` int32 of a contiguous CUDA int32
    ``(rows, P)`` ``src``, row by row, with rows, P and V > 0."""
    rows, row_len = src.shape
    deg = torch.zeros((rows, num_vertices), dtype=torch.int32,
                      device=src.device)
    status = _lib.lib().repro_degree_histogram(
        src.data_ptr(), rows, row_len, deg.data_ptr(), num_vertices,
        _lib.stream_of(src))
    _lib.check(status, "degree_histogram launch")
    return deg
