"""Plain PyTorch version of the ``degree_histogram`` kernel: the scatter-add
of ``repro/core/degrees.py::degrees_global``, row by row for a 2-D input."""
from __future__ import annotations

import torch


def degree_histogram_ref(src: torch.Tensor, *, num_vertices: int):
    """Count of each id of ``src`` in ``[0, num_vertices)`` along its last
    dimension; -1 padding and ids >= num_vertices are ignored.  int32
    ``(..., num_vertices)``."""
    v = int(num_vertices)
    keep = (src >= 0) & (src < v)
    idx = torch.where(keep, src, v).to(torch.int64)
    deg = torch.zeros((*src.shape[:-1], v + 1), dtype=torch.int32,
                      device=src.device)
    deg.scatter_add_(-1, idx, torch.ones_like(src, dtype=torch.int32))
    return deg[..., :v]
