"""Edgelist readers and transforms: the host engines and ``symmetrize``.

The port of ``repro/core/edgelist.py``.  Prefer
``loader.load_edgelist(path, engine=...)``; this module keeps the host
parsers and the reference's wrappers:

* ``read_edgelist``         -- a thin wrapper over the loader's streaming
                               ``device`` engine (the parse on the card);
* ``read_edgelist_numpy``   -- the ``numpy`` host engine: the numpy
                               single-pass vectorized parser
                               (:mod:`.parse_np`) over newline-aligned
                               chunks, one after another;
* ``read_edgelist_threads`` -- the ``threads`` host engine: the same parse
                               on a thread pool (GVEL's OpenMP loop);
* ``symmetrize``            -- appends every edge's reverse, on the edge
                               list's device.

The host engines parse on the CPU, as the paper and the reference do, with
the reference's numpy code; the bytes come through
:func:`.codecs.file_bytes`, so gzip and framed text arrive decompressed.
Their edge list moves to ``device`` (default CUDA) once, at the end;
``device="cpu"`` returns tensors over the parse's own arrays.  The paper's
baselines live in :mod:`.baselines`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from . import parse_np
from .env import resolve_device
from .types import EdgeList


def symmetrize(el: EdgeList) -> EdgeList:
    """Append every edge's reverse, after all the forward edges, on the edge
    list's device (symmetric graphs store each edge once; self-loops are
    doubled, as in the reference)."""
    n = int(el.num_edges)
    src, dst = el.src[:n], el.dst[:n]
    w = None if el.weights is None else el.weights[:n].repeat(2)
    return EdgeList(torch.cat([src, dst]), torch.cat([dst, src]), w, 2 * n,
                    el.num_vertices)


def host_edgelist(src: np.ndarray, dst: np.ndarray, w: Optional[np.ndarray],
                  num_vertices: Optional[int], device: torch.device, *,
                  symmetric: bool = False) -> EdgeList:
    """A host parse's int32 ids and float32 weights as an EdgeList on
    ``device``: ``num_vertices`` defaults to the largest id + 1, the
    reverse edges are appended on the host, and the tensors move once."""
    if num_vertices is None:
        num_vertices = int(max(src.max(initial=-1), dst.max(initial=-1))) + 1
    el = EdgeList(torch.from_numpy(src), torch.from_numpy(dst),
                  None if w is None else torch.from_numpy(w), len(src),
                  num_vertices)
    return (symmetrize(el) if symmetric else el).to(device)


def read_edgelist(path: str, *, weighted: bool = False,
                  symmetric: bool = False, base: int = 1,
                  num_vertices: Optional[int] = None,
                  beta: int = 256 * 1024, overlap: int = 64,
                  batch_blocks: int = 8, device=None) -> EdgeList:
    """The streaming ``device`` engine (the reference's wrapper; see
    :func:`.loader.load_edgelist`)."""
    from .loader import load_edgelist
    return load_edgelist(path, engine="device", weighted=weighted,
                         symmetric=symmetric, base=base,
                         num_vertices=num_vertices, beta=beta,
                         overlap=overlap, batch_blocks=batch_blocks,
                         device=device)


def read_edgelist_threads(path: str, *, weighted: bool = False,
                          symmetric: bool = False, base: int = 1,
                          num_vertices: Optional[int] = None,
                          offset: int = 0, num_workers: int = 8,
                          chunks_per_worker: int = 4,
                          device=None) -> EdgeList:
    """Multithreaded host engine (GVEL's OpenMP loop, faithfully).

    Chunks are newline-aligned and *smaller than the worker count*
    (chunks_per_worker x workers) so the pool load-balances like OpenMP
    dynamic scheduling -- the fix for PIGO's equal-split straggler issue
    the paper calls out.  numpy releases the GIL inside its C kernels, so
    threads scale on real cores.
    """
    from concurrent.futures import ThreadPoolExecutor

    from .codecs import file_bytes
    device = resolve_device(device)
    data = file_bytes(path, offset)
    n_chunks = max(num_workers * chunks_per_worker,
                   len(data) // (256 * 1024))     # beta-sized: stay in L2
    bounds = parse_np.chunk_bounds(data, max(1, n_chunks))

    def work(b):
        lo, hi = b
        return parse_np.parse_chunk_np(np.asarray(data[lo:hi]),
                                       weighted=weighted, base=base)

    if num_workers == 1:
        parts = [work(b) for b in bounds]
    else:
        with ThreadPoolExecutor(num_workers) as pool:
            parts = list(pool.map(work, bounds))
    src = (np.concatenate([p[0] for p in parts]) if parts
           else np.zeros(0, np.int64)).astype(np.int32)
    dst = (np.concatenate([p[1] for p in parts]) if parts
           else np.zeros(0, np.int64)).astype(np.int32)
    w = ((np.concatenate([p[2] for p in parts]) if parts
          else np.zeros(0)).astype(np.float32) if weighted else None)
    return host_edgelist(src, dst, w, num_vertices, device,
                         symmetric=symmetric)


def read_edgelist_numpy(path: str, *, weighted: bool = False,
                        symmetric: bool = False, base: int = 1,
                        num_vertices: Optional[int] = None, offset: int = 0,
                        chunk_bytes: int = 256 * 1024,
                        num_chunks: Optional[int] = None,
                        device=None) -> EdgeList:
    """Host engine: single-pass vectorized numpy parse over aligned chunks.

    chunk_bytes defaults to GVEL's beta = 256 KiB: on the CPU the same
    block size that balanced the paper's OpenMP threads keeps the ~15
    vectorized passes resident in L2.
    """
    from .codecs import file_bytes
    device = resolve_device(device)
    data = file_bytes(path, offset)
    n = len(data)
    if num_chunks is None:
        num_chunks = max(1, -(-n // chunk_bytes))
    bounds = parse_np.chunk_bounds(data, num_chunks)
    srcs, dsts, ws = [], [], []
    for lo, hi in bounds:
        s, d, w, _c = parse_np.parse_chunk_np(
            np.asarray(data[lo:hi]), weighted=weighted, base=base)
        srcs.append(s.astype(np.int32))
        dsts.append(d.astype(np.int32))
        if weighted:
            ws.append(w.astype(np.float32))
    src = np.concatenate(srcs) if srcs else np.zeros(0, np.int32)
    dst = np.concatenate(dsts) if dsts else np.zeros(0, np.int32)
    w = (np.concatenate(ws) if ws else np.zeros(0, np.float32)) \
        if weighted else None
    return host_edgelist(src, dst, w, num_vertices, device,
                         symmetric=symmetric)
