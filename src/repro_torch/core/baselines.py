"""The baseline loaders the paper compares GVEL against, on the host.

The port's own copy of ``repro/core/baselines.py``, the same numpy code:

* ``read_edgelist_naive``   -- sequential line loop + ``bytes.split``: the
                               fstream-plain / Hornet / Gunrock analogue
                               (stream extraction, one entry at a time);
* ``read_edgelist_loadtxt`` -- ``np.loadtxt``: the "use the library"
                               baseline;
* ``read_edgelist_pigo``    -- PIGO's algorithm: mmap the file, split it
                               into one equal part per worker, *two passes*
                               (pass 1 counts newlines to size and offset
                               the output; pass 2 parses each part into the
                               shared array, one part after another);
* ``csr_pigo``              -- PIGO's single-stage CSR: a global degree
                               count and one global construction pass (vs
                               GVEL's staged rho-partition build).

Each runs on the CPU and moves its product to ``device`` (default CUDA)
once, at the end; ``device="cpu"`` returns tensors over its own arrays.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from . import parse_np
from .build import host_csr
from .edgelist import host_edgelist
from .env import resolve_device
from .types import CSR, EdgeList, _np


def read_edgelist_naive(path: str, *, weighted: bool = False, base: int = 1,
                        num_vertices: Optional[int] = None,
                        device=None) -> EdgeList:
    device = resolve_device(device)
    srcs, dsts, ws = [], [], []
    with open(path, "rb") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2 or not parts[0].isdigit():
                continue
            srcs.append(int(parts[0]) - base)
            dsts.append(int(parts[1]) - base)
            if weighted:
                ws.append(float(parts[2]) if len(parts) > 2 else 1.0)
    src = np.asarray(srcs, np.int32)
    dst = np.asarray(dsts, np.int32)
    w = np.asarray(ws, np.float32) if weighted else None
    return host_edgelist(src, dst, w, num_vertices, device)


def read_edgelist_loadtxt(path: str, *, weighted: bool = False,
                          base: int = 1, num_vertices: Optional[int] = None,
                          device=None) -> EdgeList:
    device = resolve_device(device)
    cols = np.loadtxt(path, dtype=np.float64, ndmin=2)
    src = cols[:, 0].astype(np.int32) - base
    dst = cols[:, 1].astype(np.int32) - base
    w = cols[:, 2].astype(np.float32) if weighted and cols.shape[1] > 2 else (
        np.ones(len(src), np.float32) if weighted else None)
    return host_edgelist(src, dst, w, num_vertices, device)


def read_edgelist_pigo(path: str, *, weighted: bool = False, base: int = 1,
                       num_vertices: Optional[int] = None,
                       num_workers: int = 8, device=None) -> EdgeList:
    """PIGO two-pass algorithm (COO::read_el_): equal split per worker,
    newline-count pass to compute per-worker write offsets, then parse pass
    into one shared pre-sized array."""
    device = resolve_device(device)
    data = np.memmap(path, dtype=np.uint8, mode="r")
    bounds = parse_np.chunk_bounds(data, num_workers)
    # pass 1: count lines per part (PIGO counts newlines)
    counts = [int(np.count_nonzero(np.asarray(data[lo:hi]) == 10) +
                  (0 if hi == lo or data[hi - 1] == 10 else 1))
              for lo, hi in bounds]
    offsets = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    total = int(offsets[-1])
    src = np.full(total, -1, np.int32)
    dst = np.full(total, -1, np.int32)
    w = np.zeros(total, np.float32) if weighted else None
    # pass 2: parse each part into its reserved range
    for (lo, hi), o in zip(bounds, offsets[:-1]):
        s, d, ww, c = parse_np.parse_chunk_np(np.asarray(data[lo:hi]),
                                              weighted=weighted, base=base)
        src[o:o + c] = s
        dst[o:o + c] = d
        if weighted:
            w[o:o + c] = ww
    valid = src >= 0
    src, dst = src[valid], dst[valid]
    if weighted:
        w = w[valid]
    return host_edgelist(src, dst, w, num_vertices, device)


def csr_pigo(el: EdgeList, *, device=None) -> CSR:
    """PIGO convert_coo_: global degrees, global offsets, one static-schedule
    population pass over the whole edge array (single-stage); built on the
    host from ``el`` wherever it lies, then moved to ``device``."""
    device = resolve_device(device)
    n = int(el.num_edges)
    src = _np(el.src[:n])
    dst = _np(el.dst[:n])
    v = int(el.num_vertices)
    deg = np.bincount(src, minlength=v)
    offsets = np.zeros(v + 1, np.int64)
    np.cumsum(deg, out=offsets[1:])
    # atomic fetch-add slot claim -> deterministic rank via stable sort
    order = np.argsort(src, kind="stable")
    targets = dst[order].astype(np.int32)
    w = None if el.weights is None else _np(el.weights[:n])[order]
    return host_csr(offsets, targets, w, v).to(device)
