"""Inputs and comparisons shared by the port's serving-path tests (the
cache, query, fault and convert parity files and the card tests).

Imports no jax, so the card tests can use it; not collected by pytest.
Files are made by the port on the CPU from a seed with numpy; the port's
``.gvel`` files are byte-identical to the JAX package's, so both packages
read the same bytes.
"""
import numpy as np
import torch

from repro_torch.core import (convert_to_csr, load_edgelist, save_snapshot,
                              write_edgelist)
from repro_torch.core.build import csr_np

FRAME_BETA = 96        # several frames a section, even on small graphs


def text_file(tmp_path, name, *, seed=0, v=60, e=400, weighted=False,
              base=1, tail=0):
    """A random multigraph text file (vertices ``v - tail ..`` have no
    edges); returns ``(path, v, oracle CSR)``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v - tail, e)
    dst = rng.integers(0, v - tail, e)
    w = (rng.random(e) * 9).round(3).astype(np.float32) if weighted else None
    path = str(tmp_path / f"{name}.el")
    write_edgelist(path, src, dst, w, base=base)
    oracle = csr_np(src.astype(np.int32), dst.astype(np.int32), w, v)
    return path, v, oracle


def snapshot_file(tmp_path, name, *, seed=0, v=60, e=400, weighted=False,
                  compress="zlib", frame_beta=FRAME_BETA, base=1, tail=0,
                  csr=True):
    """``text_file`` saved as a ``.gvel`` (edgelist and, unless
    ``csr=False``, the CSR); returns ``(path, v, oracle CSR)``."""
    el_path, v, oracle = text_file(tmp_path, name, seed=seed, v=v, e=e,
                                   weighted=weighted, base=base, tail=tail)
    el = load_edgelist(el_path, weighted=weighted, num_vertices=v, base=base,
                       device="cpu")
    gv = str(tmp_path / f"{name}.gvel")
    save_snapshot(gv, edgelist=el, csr=convert_to_csr(el) if csr else None,
                  compress=compress, frame_beta=frame_beta)
    return gv, v, oracle


def host(x):
    """A tensor or array as a numpy array (None stays None)."""
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def same(a, b) -> bool:
    """Bitwise equality of two arrays or tensors (floats by bit pattern)."""
    a, b = host(a), host(b)
    if a is None or b is None:
        return a is None and b is None
    if a.dtype.kind == "f":
        a = a.view(np.int32 if a.itemsize == 4 else np.int64)
    if b.dtype.kind == "f":
        b = b.view(np.int32 if b.itemsize == 4 else np.int64)
    return a.shape == b.shape and np.array_equal(a, b)


def same_csr(got, want) -> bool:
    """Offsets (as int64), targets and weights bitwise, and the scalars."""
    return (same(host(got.offsets).astype(np.int64),
                 host(want.offsets).astype(np.int64))
            and same(got.targets, want.targets)
            and same(got.weights, want.weights)
            and int(got.num_vertices) == int(want.num_vertices)
            and int(getattr(got, "row_start", 0))
            == int(getattr(want, "row_start", 0)))


def expect_rows(oracle, lo, hi):
    """The oracle's rows ``[lo, hi)``: (offsets rebased, targets, weights)."""
    e_lo, e_hi = int(oracle.offsets[lo]), int(oracle.offsets[hi])
    w = None if oracle.weights is None else oracle.weights[e_lo:e_hi]
    return (oracle.offsets[lo:hi + 1] - oracle.offsets[lo],
            oracle.targets[e_lo:e_hi], w)


def rows_equal(part, oracle, lo, hi) -> bool:
    off, tgt, w = expect_rows(oracle, lo, hi)
    return (part.row_start == lo and part.num_vertices == oracle.num_vertices
            and same(host(part.offsets).astype(np.int64),
                     off.astype(np.int64))
            and same(part.targets, tgt) and same(part.weights, w))
