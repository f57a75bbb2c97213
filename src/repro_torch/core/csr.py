"""In-memory EdgeList -> CSR (GVEL csr-partition-rho), on the edges' device.

The port of ``repro/core/csr.py::convert_to_csr``: the strategy ladder of
the paper's Figures 3-4 (``global`` / ``staged`` with rho partitions /
``binned``) over an EdgeList that is already in memory, as MTX files,
``symmetric=True`` loads and ``save`` produce it.  On a CUDA edge list the
build counts degrees with the ``degree_histogram`` kernel and scans them
with ``exclusive_scan``.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import build
from .types import CSR, EdgeList


def convert_to_csr(el: EdgeList, *, method: str = "staged", rho: int = 4,
                   bin_bits: Optional[int] = None) -> CSR:
    """Convert an EdgeList to a CSR on the same device, int64 offsets,
    through the device builds (:func:`build.build_csr`)."""
    method = method or "staged"
    n = int(el.num_edges)
    v = int(el.num_vertices)
    weighted = el.weights is not None
    src, dst = el.src[:n], el.dst[:n]
    w = el.weights[:n] if weighted else None
    offsets, targets, ww = build.build_csr(
        src, dst, w, v, method=method, rho=rho, bin_bits=bin_bits,
        weighted=weighted)
    return CSR(offsets.to(torch.int64), targets,
               ww if weighted else None, v)
