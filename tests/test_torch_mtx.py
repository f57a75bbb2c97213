"""The port's MatrixMarket reader held against ``repro.core.mtx`` on the CPU.

Every field (``pattern``/``real``/``integer``) and symmetry
(``general``/``symmetric``), with self-loops, raw and compressed: the
port (``device="cpu"``) and the JAX package (``engine="device"``) read the
same files to the same edge lists and CSRs, bitwise (tolerance 0), and
``mtx_to_snapshot`` writes the same bytes.  A symmetric file's reverse
edges follow the stored ones in entry order, self-loops single.
"""
import gzip

import numpy as np
import pytest
import torch

from repro.core import codecs as jcodecs
from repro.core import mtx as jmtx
from repro.core.source import open_graph as jax_open
import repro_torch
from repro_torch.core import mtx

from repro_torch.core.build import csr_np

import torch_inputs as ti

V = 50


def _oracle(src, dst, w, v):
    """(offsets, targets, weights) of the port's host oracle."""
    o = csr_np(src, dst, w, v)
    return o.offsets, o.targets, o.weights


def _write(path, field, symmetric, seed):
    """An MTX file with 7 self-loops and 3-decimal (or integer) weights,
    which parse exactly; returns its stored edges."""
    src, dst, w = ti.graph_edges(seed, v=V, e=600, weighted=field != "pattern",
                                 isolated=2, loops=7)
    if field == "integer":
        w = np.round(w * 10).astype(np.float32)
    sym = "symmetric" if symmetric else "general"
    with open(path, "w") as f:
        f.write(f"%%MatrixMarket matrix coordinate {field} {sym}\n")
        f.write(f"% a comment\n%\n{V} {V} {len(src)}\n")
        for i in range(len(src)):
            line = f"{src[i] + 1} {dst[i] + 1}"
            if field == "real":
                line += f" {float(w[i]):.3f}"
            elif field == "integer":
                line += f" {int(w[i])}"
            f.write(line + "\n")
    return src, dst, w


def _compress(path, codec):
    if codec == "raw":
        return path
    data = open(path, "rb").read()
    out = path + (".gz" if codec == "gzip" else ".z")
    if codec == "gzip":
        open(out, "wb").write(gzip.compress(data))
    else:
        jcodecs.write_framed(out, data, frame_beta=256)
    return out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("symmetric", [False, True])
def test_write_mtx_is_the_reference_text(tmp_path, weighted, symmetric):
    src, dst, w = ti.graph_edges(1, v=V, e=50, weighted=weighted)
    a, b = str(tmp_path / "a.mtx"), str(tmp_path / "b.mtx")
    mtx.write_mtx(a, torch.from_numpy(src), dst,
                  None if w is None else torch.from_numpy(w), num_vertices=V,
                  symmetric=symmetric)
    jmtx.write_mtx(b, src, dst, w, num_vertices=V, symmetric=symmetric)
    assert open(a).read() == open(b).read()


@pytest.mark.parametrize("field", ["pattern", "real", "integer"])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("codec", ["raw", "gzip", "framed"])
def test_mtx_matches_reference(tmp_path, field, symmetric, codec):
    s, d, w = _write(str(tmp_path / "g.mtx"), field, symmetric, seed=4)
    path = _compress(str(tmp_path / "g.mtx"), codec)
    ref = jax_open(path, engine="device")
    port = repro_torch.open_graph(path, engine="device", device="cpu")
    info = port.info().to_dict()
    assert info.pop("device") == "cpu"
    assert info == ref.info().to_dict()
    assert info["format"] == "mtx" and info["symmetric"] == symmetric
    el, jel = port.edgelist(), ref.edgelist()
    want = ti.mtx_expand(s, d, w) if symmetric else (s, d, w)
    assert el.num_edges == int(jel.num_edges) == len(want[0])
    assert el.num_vertices == jel.num_vertices == V
    assert np.array_equal(el.src.numpy(), np.asarray(jel.src))
    assert np.array_equal(el.dst.numpy(), np.asarray(jel.dst))
    assert np.array_equal(el.src.numpy(), want[0])
    assert np.array_equal(el.dst.numpy(), want[1])
    if field == "pattern":
        assert el.weights is None and jel.weights is None
    else:
        assert el.weights.numpy().tobytes() == np.asarray(jel.weights).tobytes()
        assert el.weights.numpy().tobytes() == want[2].tobytes()
    for method in ("staged", "global", "binned"):
        got, exp = port.csr(method=method), ref.csr(method=method)
        assert got.offsets.dtype == torch.int64
        assert np.array_equal(got.offsets.numpy(), np.asarray(exp.offsets))
        assert np.array_equal(got.targets.numpy(), np.asarray(exp.targets))
        if field != "pattern":
            assert got.weights.numpy().tobytes() == \
                np.asarray(exp.weights).tobytes()
    off, tgt, _ = _oracle(*want, V)
    assert np.array_equal(port.csr().targets.numpy(), tgt)
    part = port.csr(rows=(3, 11))
    assert np.array_equal(part.targets.numpy(), tgt[off[3]:off[11]])
    assert port.degree(V - 1) == ref.degree(V - 1) == 0
    assert np.array_equal(port.neighbors(5).numpy(),
                          np.asarray(ref.neighbors(5)))


@pytest.mark.parametrize("field", ["pattern", "real"])
@pytest.mark.parametrize("compress", [None, "zlib:1"])
def test_mtx_to_snapshot_is_the_reference_file(tmp_path, field, compress):
    path = str(tmp_path / "g.mtx")
    _write(path, field, True, seed=6)
    a, b = str(tmp_path / "a.gvel"), str(tmp_path / "b.gvel")
    meta = mtx.mtx_to_snapshot(path, a, compress=compress, device="cpu")
    jmeta = jmtx.mtx_to_snapshot(path, b, engine="device", compress=compress)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert meta.num_edges == jmeta.num_edges and meta.symmetric
    csr = repro_torch.open_graph(a, device="cpu").csr()
    want = jmtx.read_mtx_csr(path, engine="device")
    got = mtx.read_mtx_csr(path, device="cpu")
    for c in (csr, got):
        assert np.array_equal(c.offsets.numpy(), np.asarray(want.offsets))
        assert np.array_equal(c.targets.numpy(), np.asarray(want.targets))


def test_mtx_refusals_and_options(tmp_path):
    path = str(tmp_path / "g.mtx")
    s, d, _w = _write(path, "pattern", False, seed=8)
    src = repro_torch.open_graph(path, device="cpu")
    with pytest.raises(ValueError, match="stream"):
        src.stream()
    with pytest.raises(ValueError, match="pattern"):
        repro_torch.open_graph(path, device="cpu", weighted=True).edgelist()
    with pytest.raises(ValueError, match="conflicts"):
        repro_torch.open_graph(path, device="cpu", num_vertices=7).edgelist()
    # symmetric=True on a general file doubles every entry, loops included
    sym = repro_torch.open_graph(path, device="cpu", symmetric=True)
    jsym = jax_open(path, engine="device", symmetric=True)
    assert sym.edgelist().num_edges == 2 * len(s)
    assert np.array_equal(sym.csr().targets.numpy(),
                          np.asarray(jsym.csr().targets))
    real = str(tmp_path / "r.mtx")
    _write(real, "real", False, seed=9)
    unweighted = repro_torch.open_graph(real, device="cpu", weighted=False)
    assert unweighted.edgelist().weights is None
    assert unweighted.csr().weights is None
    bad = str(tmp_path / "bad.mtx")
    open(bad, "w").write("%%MatrixMarket matrix array real general\n1 1\n")
    with pytest.raises(ValueError, match="unsupported banner"):
        repro_torch.open_graph(bad, device="cpu")
