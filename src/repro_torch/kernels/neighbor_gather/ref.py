"""Plain PyTorch version of the ``neighbor_gather`` kernel: the contract of
``repro/kernels/neighbor_gather/ref.py::neighbor_gather_ref``."""
from __future__ import annotations

import torch

from ...core.indexing import row_bounds


def neighbor_gather_ref(vertices: torch.Tensor, offsets: torch.Tensor,
                        targets: torch.Tensor, *, width: int = 128):
    """``(neighbors (B, width) int32 padded with -1, degrees (B,) int32)``.

    Row ``i`` holds ``targets[lo + j]`` for ``j < min(deg, width)``, with
    ``lo = offsets[u]``, ``deg = offsets[u + 1] - lo`` indexed as JAX
    indexes (``row_bounds``).  A slot outside
    ``targets`` stays -1, which never happens for a CSR's offsets."""
    e = targets.shape[0]
    lo, deg = row_bounds(vertices, offsets)
    lane = torch.arange(width, dtype=torch.int64, device=vertices.device)
    at = lo[:, None] + lane
    ok = (lane < deg[:, None]) & (at >= 0) & (at < e)
    if e == 0:
        rows = torch.full(at.shape, -1, dtype=torch.int32,
                          device=vertices.device)
    else:
        rows = torch.where(ok, targets[at.clamp(0, e - 1)], -1)
    return rows.to(torch.int32), deg.to(torch.int32)
