"""Synthetic graph generators and text writers, in numpy.

The port's copy of ``repro/core/generate.py``: the same generators draw the
same edges for the same seed, and the writers write the same bytes.
SuiteSparse is out of reach offline, so stand-ins with the shape of the
paper's Table 1 classes are made: RMAT (power-law, high average degree,
like web graphs), uniform (Erdos-Renyi) and grid (low degree, like road
networks and k-mer graphs).
"""
from __future__ import annotations

import numpy as np


def rmat_edges(scale: int, edge_factor: int = 16, *, a=0.57, b=0.19, c=0.19,
               seed: int = 0) -> tuple[np.ndarray, np.ndarray, int]:
    """Graph500-style RMAT generator (power-law degree distribution)."""
    rng = np.random.default_rng(seed)
    v = 1 << scale
    e = v * edge_factor
    src = np.zeros(e, np.int64)
    dst = np.zeros(e, np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(e)
        src_bit = r > ab
        r2 = rng.random(e)
        thresh = np.where(src_bit, c / (c + (1 - abc)) if (c + (1 - abc)) else 0.5,
                          a / ab)
        dst_bit = r2 > thresh
        src |= src_bit.astype(np.int64) << bit
        dst |= dst_bit.astype(np.int64) << bit
    perm = rng.permutation(v)               # de-correlate vertex ids
    return perm[src].astype(np.int64), perm[dst].astype(np.int64), v


def uniform_edges(num_vertices: int, num_edges: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, num_vertices, num_edges),
            rng.integers(0, num_vertices, num_edges), num_vertices)


def grid_edges(side: int):
    """2D grid — road-network-like (avg degree ~2 directed)."""
    v = side * side
    idx = np.arange(v).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()])
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()])
    e = np.concatenate([right, down], axis=1)
    return e[0], e[1], v


def write_edgelist(path: str, src, dst, weights=None, *, base: int = 1) -> None:
    """Write a plain text edgelist (1-based by default, like the paper)."""
    src = np.asarray(src) + base
    dst = np.asarray(dst) + base
    cols = [src.astype(np.int64), dst.astype(np.int64)]
    if weights is not None:
        with open(path, "w") as f:
            for u, v, w in zip(src, dst, np.asarray(weights)):
                f.write(f"{u} {v} {w:.4f}\n")
        return
    # fast writer: build the byte buffer with numpy
    a = np.char.add(np.char.add(src.astype("U11"), " "), dst.astype("U11"))
    with open(path, "w") as f:
        f.write("\n".join(a.tolist()))
        f.write("\n")


def make_graph_file(path: str, kind: str = "rmat", scale: int = 14,
                    edge_factor: int = 16, weighted: bool = False,
                    seed: int = 0) -> tuple[int, int]:
    """Generate + write a graph; returns (num_vertices, num_edges)."""
    if kind == "rmat":
        src, dst, v = rmat_edges(scale, edge_factor, seed=seed)
    elif kind == "uniform":
        src, dst, v = uniform_edges(1 << scale, (1 << scale) * edge_factor, seed)
    elif kind == "grid":
        src, dst, v = grid_edges(1 << (scale // 2))
    else:
        raise ValueError(kind)
    w = None
    if weighted:
        rng = np.random.default_rng(seed + 1)
        w = rng.random(len(src)).astype(np.float32)
    write_edgelist(path, src, dst, w)
    return v, len(src)
