"""Indexing as the reference's JAX arrays index: the one home of the rule
that both the ``neighbor_gather`` plain version and the walk step follow
(``csrc/neighbor_gather.cu`` states it once more in CUDA)."""
from __future__ import annotations

import torch


def jax_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``idx`` as JAX indexes an ``(n,)`` array with it: a negative index
    wraps once by ``n``, then the index clamps to ``[0, n - 1]``.  int64."""
    i = idx.to(torch.int64)
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2**32 into int32's range (still int64)."""
    return (x + 2**31) % 2**32 - 2**31


def row_bounds(vertices: torch.Tensor, offsets: torch.Tensor):
    """``(lo, deg)`` int64 of each vertex id as the reference reads them:
    ``lo = offsets[u]``, ``deg = offsets[u + 1] - lo``, JAX-indexed, with
    ``u + 1`` wrapping in int32."""
    n_off = offsets.shape[0]
    lo = offsets[jax_index(vertices, n_off)].to(torch.int64)
    u1 = wrap_int32(vertices.to(torch.int64) + 1)
    return lo, offsets[jax_index(u1, n_off)].to(torch.int64) - lo
