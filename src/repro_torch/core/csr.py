"""In-memory EdgeList -> CSR (GVEL csr-partition-rho), on the edges' device.

The port of ``repro/core/csr.py::convert_to_csr``: the strategy ladder of
the paper's Figures 3-4 (``global`` / ``staged`` with rho partitions /
``binned``) over an EdgeList that is already in memory, as MTX files,
``symmetric=True`` loads and ``save`` produce it.  On a CUDA edge list the
device build counts degrees with the ``degree_histogram`` kernel and scans
them with ``exclusive_scan``; ``engine="numpy"`` builds on the host instead
(the host engines' build, as in the reference).  :func:`read_csr` and
:func:`csr_to_dense` are the reference's small wrappers.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import build
from .types import CSR, EdgeList, _np


def convert_to_csr(el: EdgeList, *, method: str = "staged", rho: int = 4,
                   bin_bits: Optional[int] = None,
                   engine: str = "device") -> CSR:
    """Convert an EdgeList to a CSR on the same device, int64 offsets.

    ``engine="device"`` (or the reference's name, ``"jax"``) runs the
    device builds (:func:`build.build_csr`); ``engine="numpy"`` builds on
    the host as the reference's numpy engine does -- ``csr_binned_np`` for
    ``method="binned"``, else the stable-sort ``csr_np`` -- and moves the
    CSR to the edge list's device."""
    method = method or "staged"
    if method not in ("global", "staged", "binned"):
        raise ValueError(f"unknown method {method!r}")
    n = int(el.num_edges)
    v = int(el.num_vertices)
    weighted = el.weights is not None
    src, dst = el.src[:n], el.dst[:n]
    w = el.weights[:n] if weighted else None
    if engine == "numpy":
        s, d, ww = _np(src), _np(dst), _np(w)
        if method == "binned":
            csr = build.csr_binned_np(s, d, ww, v, bin_bits=bin_bits)
        else:
            o = build.csr_np(s, d, ww, v)
            csr = build.host_csr(o.offsets, o.targets, o.weights, v)
        return csr.to(src.device)
    if engine not in ("device", "jax"):
        raise ValueError(f"unknown convert_to_csr engine {engine!r}; "
                         f"expected 'device' (or 'jax') or 'numpy'")
    offsets, targets, ww = build.build_csr(
        src, dst, w, v, method=method, rho=rho, bin_bits=bin_bits,
        weighted=weighted)
    return CSR(offsets.to(torch.int64), targets,
               ww if weighted else None, v)


def read_csr(path: str, *, weighted: bool = False, symmetric: bool = False,
             base: int = 1, num_vertices: Optional[int] = None,
             method: str = "staged", rho: int = 4,
             bin_bits: Optional[int] = None, engine: str = "device",
             device=None, **reader_kwargs) -> CSR:
    """File -> CSR on ``device`` (default CUDA) through the front door; the
    reference's back-compat wrapper, with its ``engine="jax"`` read as the
    streaming ``device`` engine."""
    from .loader import load_csr
    return load_csr(path, engine="device" if engine == "jax" else engine,
                    weighted=weighted, symmetric=symmetric, base=base,
                    num_vertices=num_vertices, method=method, rho=rho,
                    bin_bits=bin_bits, device=device, **reader_kwargs)


def csr_to_dense(csr: CSR) -> np.ndarray:
    """A small graph's ``(num_rows, num_vertices)`` int64 edge-count matrix
    on the host (a debugging helper)."""
    out = np.zeros((csr.num_rows, csr.num_vertices), np.int64)
    c = csr.numpy()
    for u in range(c.num_rows):
        np.add.at(out[u], c.targets[c.offsets[u]:c.offsets[u + 1]], 1)
    return out
