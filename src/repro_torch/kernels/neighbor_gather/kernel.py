"""Launch of the ``neighbor_gather`` CUDA kernel
(``csrc/neighbor_gather.cu``).

Replaces ``repro/kernels/neighbor_gather/kernel.py:49``
``neighbor_gather_kernel``.
"""
from __future__ import annotations

import torch

from .. import _lib


def neighbor_gather_kernel(vertices: torch.Tensor, offsets: torch.Tensor,
                           targets: torch.Tensor, width: int):
    """Contiguous CUDA ``vertices`` (B,) int32 with B > 0, ``offsets``
    (V+1,) int64 or int32, ``targets`` (E,) int32 -> ``(neighbors (B,
    width), degrees (B,))`` int32."""
    b = vertices.shape[0]
    out = torch.empty((b, width), dtype=torch.int32, device=vertices.device)
    deg = torch.empty(b, dtype=torch.int32, device=vertices.device)
    status = _lib.lib().repro_neighbor_gather(
        vertices.data_ptr(), b, offsets.data_ptr(), offsets.shape[0],
        int(offsets.dtype == torch.int64), targets.data_ptr(),
        targets.shape[0], out.data_ptr(), deg.data_ptr(), width,
        _lib.stream_of(vertices))
    _lib.check(status, "neighbor_gather launch")
    return out, deg
