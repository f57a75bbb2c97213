"""Vertex degrees and offsets (GVEL Alg. 2), through the port's kernels.

The port of ``repro/core/degrees.py``: degree counting goes through the
``degree_histogram`` kernel and offsets through the ``exclusive_scan``
kernel (plain PyTorch versions on CPU tensors).
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.degree_histogram import degree_histogram
from ..kernels.exclusive_scan import csr_offsets

I32 = torch.int32


def degrees_global(src: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """One shared histogram over all edges (-1 padding ignored)."""
    return degree_histogram(src, num_vertices=num_vertices)


def degrees_partitioned(src: torch.Tensor, num_vertices: int,
                        rho: int = 4) -> torch.Tensor:
    """rho partition-local histograms over contiguous edge chunks:
    ``(rho, V)``, in one launch over the chunks padded with -1 to one
    length; :func:`combine_degrees` sums them."""
    e = src.shape[0]
    chunk = max(-(-e // rho), 1)
    pad = torch.full((rho * chunk - e,), -1, dtype=src.dtype,
                     device=src.device)
    parts = torch.cat([src, pad]).reshape(rho, chunk)
    return degree_histogram(parts, num_vertices=num_vertices)


def combine_degrees(pdeg: torch.Tensor) -> torch.Tensor:
    return torch.sum(pdeg, dim=0, dtype=I32)


def degrees_sort(src: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """Sort + boundary differences: the contention-free alternative."""
    key = torch.where(src >= 0, src, num_vertices).to(I32)
    s = torch.sort(key).values
    ids = torch.arange(num_vertices, dtype=I32, device=src.device)
    lo = torch.searchsorted(s, ids, side="left", out_int32=True)
    hi = torch.searchsorted(s, ids, side="right", out_int32=True)
    return hi - lo


def degrees_np(src: np.ndarray, num_vertices: int) -> np.ndarray:
    """Host oracle."""
    src = src[src >= 0]
    return np.bincount(src, minlength=num_vertices).astype(np.int64)


def offsets_from_degrees(deg: torch.Tensor) -> torch.Tensor:
    """Exclusive scan -> CSR offsets (V+1,) int32."""
    return csr_offsets(deg)
