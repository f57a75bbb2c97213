"""The benchmark's graphs: generators and the text writer, frozen here.

Both generators draw each chunk of ``CHUNK`` edges from its own stream,
``SeedSequence([seed, stream, chunk])``, so the edges and the bytes of the
file depend on the seed alone, never on the number of threads that made
them.  The chunks are made and formatted on a thread pool (numpy's random
fills and array arithmetic release the GIL) and written in order.

* ``rmat``: Graph500's Kronecker generator (spec section 3: A=0.57,
  B=0.19, C=0.19, vertex ids permuted by a random permutation; self-loops
  and duplicates kept, as the generator makes them).  The bit loop is
  ``chip_smoke.py::rmat_edges``'s, in float32.
* ``urand``: the GAP Benchmark Suite's uniform random graph: both
  endpoints uniform over the vertices; with ``weights`` the SSSP weights,
  integers uniform in [1, 255].

The writer prints ``u v`` or ``u v w`` lines, ids ``base``-based, one
space between fields (``chip_smoke.py::_ascii``'s vectorised digits).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np

CHUNK = 1 << 22                  # edges a chunk (the unit of a stream)
STREAM_EDGES, STREAM_PERM = 0, 1
WEIGHT_MAX = 255                 # GAP's kRandWeightMax


def _rng(seed: int, *key: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed % (1 << 64), *key]))


def threads() -> int:
    """The threads this process may run on."""
    try:
        return max(len(os.sched_getaffinity(0)), 1)
    except AttributeError:
        return max(os.cpu_count() or 1, 1)


def _rmat_chunk(cfg: Dict, rng: np.random.Generator, n: int):
    a, b, c = cfg["a"], cfg["b"], cfg["c"]
    ab = a + b
    a_norm, c_norm = np.float32(a / ab), np.float32(c / (1.0 - ab))
    s = np.zeros(n, np.int32)
    d = np.zeros(n, np.int32)
    for bit in range(cfg["scale"]):
        sb = rng.random(n, dtype=np.float32) > ab
        db = rng.random(n, dtype=np.float32) > np.where(sb, c_norm, a_norm)
        s |= sb.astype(np.int32) << bit
        d |= db.astype(np.int32) << bit
    return s, d


def _urand_chunk(cfg: Dict, rng: np.random.Generator, n: int):
    v = 1 << cfg["scale"]
    return (rng.integers(0, v, n, dtype=np.int32),
            rng.integers(0, v, n, dtype=np.int32))


GENERATORS = {"rmat": _rmat_chunk, "urand": _urand_chunk}


def num_edges(cfg: Dict) -> int:
    return (1 << cfg["scale"]) * cfg["edge_factor"]


def _ascii(x: np.ndarray, width: int):
    """Right-aligned decimal digits of non-negative ints, and a mask of the
    significant ones."""
    out = np.empty((len(x), width), np.uint8)
    y = x.astype(np.int64)
    for k in range(width - 1, -1, -1):
        out[:, k] = 48 + y % 10
        y //= 10
    nd = 1 + sum((x >= 10 ** k).astype(np.int64) for k in range(1, width))
    keep = np.arange(width)[None, :] >= (width - nd)[:, None]
    return out, keep


def format_lines(columns, widths) -> bytes:
    """One line per row of ``columns`` (non-negative ints): the fields
    separated by one space, each line ended by a newline."""
    n = len(columns[0])
    sep = (np.full((n, 1), 32, np.uint8), np.ones((n, 1), bool))
    parts = []
    for i, (col, width) in enumerate(zip(columns, widths)):
        if i:
            parts.append(sep)
        parts.append(_ascii(col, width))
    parts.append((np.full((n, 1), 10, np.uint8), np.ones((n, 1), bool)))
    mat = np.concatenate([p[0] for p in parts], axis=1)
    keep = np.concatenate([p[1] for p in parts], axis=1)
    return mat[keep].tobytes()


class Graph:
    """A generated graph: 0-based int32 ``src``/``dst`` in file order and
    float32 ``weights`` or None."""

    def __init__(self, src, dst, weights):
        self.src, self.dst, self.weights = src, dst, weights

    @property
    def num_edges(self) -> int:
        return len(self.src)


def make(cfg: Dict, seed: int, path: Optional[str] = None,
         workers: Optional[int] = None) -> Graph:
    """Generate the graph ``cfg`` describes from ``seed`` and, with
    ``path``, write it there as text.  ``cfg`` keys: ``generator``
    (``rmat`` | ``urand``), ``scale``, ``edge_factor``, ``weights``
    (``none`` | ``uniform_int``), ``base``; ``rmat`` also ``a``, ``b``,
    ``c``, ``permute``."""
    gen = GENERATORS[cfg["generator"]]
    v = 1 << cfg["scale"]
    e = num_edges(cfg)
    weighted = cfg["weights"] != "none"
    base = cfg["base"]
    perm = None
    if cfg.get("permute"):
        perm = _rng(seed, STREAM_PERM).permutation(v).astype(np.int32)
    src = np.empty(e, np.int32)
    dst = np.empty(e, np.int32)
    wint = np.empty(e, np.int32) if weighted else None
    id_width = len(str(v - 1 + base))
    widths = (id_width, id_width, len(str(WEIGHT_MAX)))

    def chunk(i: int) -> Optional[bytes]:
        lo = i * CHUNK
        n = min(CHUNK, e - lo)
        rng = _rng(seed, STREAM_EDGES, i)
        s, d = gen(cfg, rng, n)
        if perm is not None:
            s, d = perm[s], perm[d]
        src[lo:lo + n], dst[lo:lo + n] = s, d
        cols = [s + base, d + base]
        if weighted:
            w = rng.integers(1, WEIGHT_MAX + 1, n, dtype=np.int32)
            wint[lo:lo + n] = w
            cols.append(w)
        return format_lines(cols, widths) if path is not None else None

    nchunks = -(-e // CHUNK)
    tmp = None if path is None else path + ".tmp"
    with ThreadPoolExecutor(workers or threads()) as pool:
        if tmp is None:
            list(pool.map(chunk, range(nchunks)))
        else:
            with open(tmp, "wb") as f:
                for text in pool.map(chunk, range(nchunks)):
                    f.write(text)
                # written back now, not while the loads read it
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
    return Graph(src, dst, None if wint is None else wint.astype(np.float32))
