"""The port's ``.gvel`` snapshots, ``convert_to_csr`` and ``symmetric=True``
held against the JAX package on the CPU.

The same text files go through ``repro.core`` (``engine="device"``,
``JAX_PLATFORMS=cpu``) and through ``repro_torch`` (``device="cpu"``).
Products are compared bitwise (tolerance 0: integers and float32 bit
patterns); files from ``save`` must be byte-identical.  The port's
laziness is checked by instrumenting its ``codecs.decode_frame`` and
``codecs.decompress_frames``.  Inputs are made from a seed with numpy.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import snapshot as jsnapshot
from repro.core.csr import convert_to_csr as jax_convert
from repro.core.source import open_graph as jax_open
from repro.core.types import EdgeList as JEdgeList
import repro_torch
from repro_torch.core import (EdgeList, codecs, convert_to_csr, snapshot,
                              read_snapshot)
from repro_torch.core.build import csr_np
from repro_torch.core.snapshot import SnapshotError

import torch_inputs as ti

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FMTS = ["raw", "zlib", "zstd"]
SECTIONS = ["both", "edgelist", "csr"]
FRAME_BETA = 96            # several frames a section, even on small graphs
V = 60


def _oracle(src, dst, w, v):
    """(offsets, targets, weights) of the port's host oracle."""
    o = csr_np(src, dst, w, v)
    return o.offsets, o.targets, o.weights


def _compress(fmt):
    return None if fmt == "raw" else fmt


@pytest.fixture(scope="module")
def texts(tmp_path_factory):
    """One text file per (weighted, base): 401 edges (not a power of two,
    not a multiple of rho), 3 isolated tail vertices (kept by opening the
    text with ``num_vertices=V``)."""
    root = tmp_path_factory.mktemp("torch_snapshot")
    out = {}
    for weighted in (False, True):
        for base in (0, 1):
            src, dst, w = ti.graph_edges(3 + 2 * weighted + base, v=V,
                                         e=401, weighted=weighted)
            path = str(root / f"g_{int(weighted)}_{base}.el")
            ti.write_text(path, src, dst, w, base)
            out[(weighted, base)] = (path, src, dst, w)
    return out


def _open_pair(path, **kw):
    return (jax_open(path, engine="device", **kw),
            repro_torch.open_graph(path, device="cpu", **kw))


def _save_pair(tmp_path, text, weighted, base, fmt, sections,
               frame_beta=None):
    """The same text saved by both packages; returns both paths."""
    paths = []
    for who, mod_open in (("jax", jax_open), ("port", None)):
        out = str(tmp_path / f"{who}_{fmt}_{sections}.gvel")
        if who == "jax":
            src = mod_open(text, engine="device", weighted=weighted,
                           base=base, num_vertices=V)
            el = src.edgelist()
            csr = src.csr()
            jsnapshot.save_snapshot(
                out, edgelist=None if sections == "csr" else el,
                csr=None if sections == "edgelist" else csr,
                compress=_compress(fmt), frame_beta=frame_beta)
        else:
            src = repro_torch.open_graph(text, device="cpu",
                                         weighted=weighted, base=base,
                                         num_vertices=V)
            snapshot.save_snapshot(
                out, edgelist=None if sections == "csr" else src.edgelist(),
                csr=None if sections == "edgelist" else src.csr(),
                compress=_compress(fmt), frame_beta=frame_beta)
        paths.append(out)
    return paths


def _eq(a, b):
    """Bitwise equality of a port tensor and a reference array (integers
    by value, floats by bit pattern)."""
    if a is None or b is None:
        return a is None and b is None
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        return a.dtype == b.dtype and a.tobytes() == b.tobytes()
    return a.shape == b.shape and np.array_equal(a, b)


def _assert_csr(got, want, weighted=True):
    assert got.offsets.dtype == torch.int64
    assert got.targets.dtype == torch.int32
    assert got.num_vertices == want.num_vertices
    assert got.row_start == want.row_start
    assert _eq(got.offsets, np.asarray(want.offsets, np.int64))
    assert _eq(got.targets, want.targets)
    assert _eq(got.weights, want.weights if weighted else None)


# ---- save: byte-identical files, read by the other package -------------------

@pytest.mark.parametrize("fmt", ["raw", "zlib"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("csr", [True, False])
def test_save_writes_the_reference_bytes(texts, tmp_path, fmt, weighted, csr):
    text = texts[(weighted, 1)][0]
    ref, port = _open_pair(text, weighted=weighted, num_vertices=V)
    a, b = str(tmp_path / "ref.gvel"), str(tmp_path / "port.gvel")
    spec = None if fmt == "raw" else "zlib:1"
    ref.save(a, compress=spec, csr=csr)
    out = port.save(b, compress=spec, csr=csr)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert out.format == "gvel" and str(out.options.device) == "cpu"
    assert out.info().version == (1 if fmt == "raw" else 2)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("sections", SECTIONS)
@pytest.mark.parametrize("weighted", [False, True])
def test_save_snapshot_bytes_and_cross_reads(texts, tmp_path, fmt, sections,
                                             weighted):
    """``save_snapshot`` from each package's products: the same bytes, and
    each package reads the other's file to the same products."""
    text, src, dst, w = texts[(weighted, 0)]
    jpath, ppath = _save_pair(tmp_path, text, weighted, 0, fmt, sections,
                              frame_beta=FRAME_BETA)
    assert open(jpath, "rb").read() == open(ppath, "rb").read()
    oracle = _oracle(src, dst, w, V)
    for path in (jpath, ppath):
        ref, port = _open_pair(path)
        info = port.info().to_dict()
        assert info.pop("device") == "cpu"
        assert info == ref.info().to_dict()
        if sections != "edgelist":
            # the embedded CSR (or the stream + build of the edgelist)
            got = port.csr()
            _assert_csr(got, ref.csr(), weighted)
            assert _eq(got.offsets, oracle[0]) and _eq(got.targets, oracle[1])
        if sections != "csr":
            el, jel = port.edgelist(), ref.edgelist()
            assert el.num_edges == int(jel.num_edges) == len(src)
            assert el.num_vertices == jel.num_vertices
            assert _eq(el.src, jel.src) and _eq(el.dst, jel.dst)
            assert _eq(el.weights, jel.weights)
            assert _eq(el.src, src) and _eq(el.dst, dst)
        else:
            for s in (port, ref):
                with pytest.raises(SnapshotError if s is port
                                   else jsnapshot.SnapshotError,
                                   match="CSR-only"):
                    s.edgelist()


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("sections", SECTIONS)
@pytest.mark.parametrize("weighted", [False, True])
def test_point_reads_match_reference(texts, tmp_path, fmt, sections,
                                     weighted):
    """``csr()``, ``csr(rows=)``, ``neighbors``, ``degree`` and
    ``frame_cache_stats()`` after the same calls, on every kind of
    snapshot (an edgelist-only one slices its built CSR)."""
    text = texts[(weighted, 1)][0]
    _jpath, path = _save_pair(tmp_path, text, weighted, 1, fmt, sections,
                              frame_beta=FRAME_BETA)
    ref, port = _open_pair(path)
    for u in (0, 1, 17, V // 2, V - 1):
        got, want = port.neighbors(u), ref.neighbors(u)
        assert got.dtype == torch.int32 and got.device.type == "cpu"
        assert _eq(got, want)
        deg = port.degree(u)
        assert isinstance(deg, int) and deg == ref.degree(u)
        if weighted:
            (ids, ww), (rids, rw) = (port.neighbors(u, with_weights=True),
                                     ref.neighbors(u, with_weights=True))
            assert _eq(ids, rids) and _eq(ww, rw)
    for rows in ((9, 31), (0, 5), range(20, 40), (7, 7), (V - 4, V)):
        _assert_csr(port.csr(rows=rows), ref.csr(rows=rows), weighted)
    assert port.frame_cache_stats() == ref.frame_cache_stats()
    _assert_csr(port.csr(), ref.csr(), weighted)
    with pytest.raises(IndexError):
        port.degree(V)


def test_empty_and_isolated_vertices_roundtrip(tmp_path):
    empty = EdgeList(torch.zeros(0, dtype=torch.int32),
                     torch.zeros(0, dtype=torch.int32), None, 0, 5)
    path = str(tmp_path / "empty.gvel")
    csr = convert_to_csr(empty)
    snapshot.save_snapshot(path, edgelist=empty, csr=csr, compress="zlib")
    jpath = str(tmp_path / "jempty.gvel")
    jel = JEdgeList(np.zeros(0, np.int32), np.zeros(0, np.int32), None,
                    np.int64(0), 5)
    jsnapshot.save_snapshot(jpath, edgelist=jel,
                            csr=jax_convert(jel, engine="numpy"),
                            compress="zlib")
    assert open(path, "rb").read() == open(jpath, "rb").read()
    got = repro_torch.open_graph(path, device="cpu").csr()
    assert got.offsets.tolist() == [0] * 6 and got.targets.numel() == 0
    edge_only = str(tmp_path / "edge_only.gvel")
    snapshot.save_snapshot(edge_only, edgelist=empty)
    got = repro_torch.open_graph(edge_only, device="cpu").csr()
    assert got.offsets.tolist() == [0] * 6 and got.num_vertices == 5


# ---- laziness: only the sections and frames a product needs ------------------

def _spy(monkeypatch):
    calls = []
    real_frame, real_full = codecs.decode_frame, codecs.decompress_frames

    def frame_spy(payload, entry, codec, **kw):
        calls.append(("frame", int(kw["context"].rsplit(" ", 1)[1]),
                      entry.index))
        return real_frame(payload, entry, codec, **kw)

    def full_spy(payload, raw_len, codec, **kw):
        calls.append(("full", int(kw["context"].rsplit(" ", 1)[1]), -1))
        return real_full(payload, raw_len, codec, **kw)
    monkeypatch.setattr(codecs, "decode_frame", frame_spy)
    monkeypatch.setattr(codecs, "decompress_frames", full_spy)
    return calls


def _zlib_snapshot(tmp_path, texts, weighted=True, sections="both"):
    return _save_pair(tmp_path, texts[(weighted, 1)][0], weighted, 1, "zlib",
                      sections, frame_beta=FRAME_BETA)[1]


def test_csr_never_decodes_an_edgelist_frame(texts, tmp_path, monkeypatch):
    path = _zlib_snapshot(tmp_path, texts)
    calls = _spy(monkeypatch)
    csr = repro_torch.open_graph(path, device="cpu").csr()
    secs = {sid for _k, sid, _i in calls}
    assert secs == {snapshot.SEC_CSR_OFFSETS, snapshot.SEC_CSR_INDICES,
                    snapshot.SEC_CSR_WEIGHTS}
    # every frame of those sections decoded once, frame by frame
    frames = repro_torch.open_graph(path, device="cpu").info().section_frames
    assert sorted(i for k, s, i in calls if s == snapshot.SEC_CSR_INDICES) \
        == list(range(frames["csr_indices"]))
    assert not [c for c in calls if c[0] == "full"]
    assert csr.weights is not None


def test_unweighted_reads_never_decode_weights(texts, tmp_path, monkeypatch):
    path = _zlib_snapshot(tmp_path, texts)
    calls = _spy(monkeypatch)
    src = repro_torch.open_graph(path, device="cpu", weighted=False)
    assert src.csr().weights is None
    assert src.edgelist().weights is None
    src.neighbors(30)
    src.csr(rows=(3, 9))
    secs = {sid for _k, sid, _i in calls}
    assert snapshot.SEC_EDGE_WEIGHTS not in secs
    assert snapshot.SEC_CSR_WEIGHTS not in secs
    calls.clear()
    repro_torch.open_graph(path, device="cpu").neighbors(30)   # weighted src
    assert snapshot.SEC_CSR_WEIGHTS not in {s for _k, s, _i in calls}


@pytest.mark.parametrize("lo,hi", [(20, 24), (6, 10), (0, 1), (V - 1, V)])
def test_row_ranges_decode_only_touched_frames(texts, tmp_path, monkeypatch,
                                               lo, hi):
    path = _zlib_snapshot(tmp_path, texts)
    frames = repro_torch.open_graph(path, device="cpu").info().section_frames
    assert frames["csr_indices"] > 3          # else the test is vacuous
    _text, src, dst, w = texts[(True, 1)]
    off, tgt, ww = _oracle(src, dst, w, V)
    calls = _spy(monkeypatch)
    s = repro_torch.open_graph(path, device="cpu")
    part = s.csr(rows=(lo, hi))
    assert _eq(part.offsets, off[lo:hi + 1] - off[lo])
    assert _eq(part.targets, tgt[off[lo]:off[hi]])
    assert _eq(part.weights, ww[off[lo]:off[hi]])
    assert not [c for c in calls if c[0] == "full"]

    def expect(n_frames, b_lo, b_hi):
        return {i for i in range(n_frames) if b_lo < b_hi
                and i * FRAME_BETA < b_hi and (i + 1) * FRAME_BETA > b_lo}
    by_sec = {}
    for _k, sid, idx in calls:
        by_sec.setdefault(sid, set()).add(idx)
    assert by_sec[snapshot.SEC_CSR_OFFSETS] == expect(
        frames["csr_offsets"], 8 * lo, 8 * (hi + 1))
    e_lo, e_hi = int(off[lo]), int(off[hi])
    assert by_sec.get(snapshot.SEC_CSR_INDICES, set()) == expect(
        frames["csr_indices"], 4 * e_lo, 4 * e_hi)
    assert set(by_sec) <= {snapshot.SEC_CSR_OFFSETS,
                           snapshot.SEC_CSR_INDICES,
                           snapshot.SEC_CSR_WEIGHTS}
    n = len(calls)
    s.csr(rows=(lo, hi))                      # again: served from the memo
    assert len(calls) == n
    assert s.frame_cache_stats()["hits"] > 0


def test_frame_memo_is_capped(texts, tmp_path, monkeypatch):
    """With ``FRAME_CACHE_BYTES`` lowered in both packages, a point-read
    hammer gives right answers, stays under the cap, and evicts as the
    reference does."""
    path = _zlib_snapshot(tmp_path, texts, weighted=False)
    cap = 3 * FRAME_BETA
    monkeypatch.setattr(snapshot, "FRAME_CACHE_BYTES", cap)
    monkeypatch.setattr(jsnapshot, "FRAME_CACHE_BYTES", cap)
    ref, port = _open_pair(path)
    _text, src, dst, _w = texts[(False, 1)]
    off, tgt, _ = _oracle(src, dst, None, V)
    for _ in range(2):
        for u in range(V):
            assert _eq(port.neighbors(u), tgt[off[u]:off[u + 1]])
            ref.neighbors(u)
    stats = port.frame_cache_stats()
    assert stats == ref.frame_cache_stats()
    # one frame per section may exceed the cap; two sections are read
    assert stats["bytes"] <= 2 * cap and stats["evictions"] > 0


@pytest.mark.parametrize("section", ["csr_offsets", "csr_indices",
                                     "csr_weights", "src", "dst",
                                     "edge_weights"])
def test_damaged_frame_raises_at_first_access(texts, tmp_path, section):
    path = _zlib_snapshot(tmp_path, texts)
    sid = {v: k for k, v in snapshot.SECTION_NAMES.items()}[section]
    entry = [e for e in snapshot.peek_table(path)[4] if e[0] == sid][0]
    data = snapshot.mmap_bytes(path)[entry[2]:entry[2] + entry[3]]
    frame = codecs.frame_table(data)[1]
    blob = bytearray(open(path, "rb").read())
    blob[entry[2] + frame.payload_off + frame.comp_len // 2] ^= 0x20
    open(path, "wb").write(bytes(blob))
    port = repro_torch.open_graph(path, device="cpu")     # no raise at open
    ref = jax_open(path)
    port.info()
    product = (lambda s: s.csr()) if section.startswith("csr") \
        else (lambda s: s.edgelist())
    with pytest.raises(SnapshotError) as got:
        product(port)
    with pytest.raises(jsnapshot.SnapshotError) as want:
        product(ref)
    assert got.value.section == want.value.section == section
    assert section in (snapshot.SECTION_NAMES[sid],)


def test_structural_damage_fails_at_open(texts, tmp_path):
    path = _zlib_snapshot(tmp_path, texts)
    blob = open(path, "rb").read()
    bad = str(tmp_path / "bad.gvel")
    open(bad, "wb").write(blob[:snapshot.HEADER_LEN + 10])
    for opener in (lambda p: repro_torch.open_graph(p, device="cpu"),
                   lambda p: read_snapshot(p, eager=False)):
        with pytest.raises(SnapshotError, match="truncated"):
            opener(bad)
    open(bad, "wb").write(b"GVELSNAP" + b"\x07" + blob[9:])
    with pytest.raises(SnapshotError, match="version"):
        repro_torch.open_graph(bad, device="cpu")
    gz = str(tmp_path / "snap.gvel.gz")
    import gzip
    open(gz, "wb").write(gzip.compress(blob))
    with pytest.raises(ValueError, match="externally compressed"):
        repro_torch.open_graph(gz, device="cpu")


def test_eager_read_checks_every_section(texts, tmp_path):
    path = _zlib_snapshot(tmp_path, texts)
    snap = read_snapshot(path)
    assert snap.decoded_sections() == sorted(snapshot.SECTION_NAMES)
    assert snap.section_codecs() == ["zlib"]
    lazy = read_snapshot(path, eager=False)
    assert lazy.decoded_sections() == []
    assert _eq(lazy.csr(device="cpu").targets, snap.csr_indices)


# ---- stream + build on an edgelist-only snapshot -----------------------------

@pytest.mark.parametrize("method", ["staged", "global", "binned"])
@pytest.mark.parametrize("rho", [4, 3])
def test_exact_length_stream_builds_like_the_reference(texts, tmp_path,
                                                       method, rho):
    text, src, dst, w = texts[(True, 1)]
    assert len(src) % 4 and len(src) % 3 and len(src) & (len(src) - 1)
    path = _save_pair(tmp_path, text, True, 1, "zlib", "edgelist")[1]
    ref, port = _open_pair(path)
    (s, d, ww, total), cap = port.stream()
    assert s.shape == d.shape == ww.shape == (len(src),) == (cap,)
    assert int(total) == len(src) and total.dtype == torch.int32
    assert bool((s >= 0).all())                # no -1 padding
    got = port.csr(method=method, rho=rho)
    _assert_csr(got, ref.csr(method=method, rho=rho))
    off, tgt, wo = _oracle(src, dst, w, V)
    assert got.num_vertices == V               # the header's |V|
    assert _eq(got.offsets, off) and _eq(got.targets, tgt)


def test_snapshot_engine_is_registered_and_routed(texts, tmp_path):
    assert repro_torch.core.available_engines() == [
        "device", "numpy", "pallas", "snapshot", "threads"]
    path = _zlib_snapshot(tmp_path, texts)
    src = repro_torch.open_graph(path, device="cpu", engine="device")
    assert src.options.engine == "snapshot"
    csr = repro_torch.load_csr(path, device="cpu", weighted=True)
    el = repro_torch.load_edgelist(path, device="cpu")
    assert csr.weights is not None and el.weights is None
    with pytest.raises(SnapshotError, match="unweighted"):
        unweighted = _save_pair(tmp_path, texts[(False, 1)][0], False, 1,
                                "raw", "both")[1]
        repro_torch.open_graph(unweighted, device="cpu", weighted=True).csr()
    with pytest.raises(ValueError, match="snapshots are already parsed"):
        src.csr_sharded(None)


# ---- convert_to_csr and symmetric=True ----------------------------------------

@pytest.mark.parametrize("method", ["staged", "global", "binned"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ref_engine", ["jax", "numpy"])
def test_convert_to_csr_matches_reference(texts, method, weighted, ref_engine):
    """The port's device build equals both of the reference's builders."""
    _text, src, dst, w = texts[(weighted, 0)]
    jel = JEdgeList(src, dst, w, np.int64(len(src)), V)
    want = jax_convert(jel, method=method, rho=3, engine=ref_engine)
    got = convert_to_csr(EdgeList.from_numpy(jel, device="cpu"),
                         method=method, rho=3)
    _assert_csr(got, want, weighted)
    assert got.offsets.device.type == "cpu"


@pytest.mark.parametrize("method", ["staged", "global", "binned"])
@pytest.mark.parametrize("weighted", [False, True])
def test_symmetric_text_matches_reference(texts, method, weighted):
    text, src, dst, w = texts[(weighted, 1)]
    ref, port = _open_pair(text, weighted=weighted, symmetric=True,
                           num_vertices=V)
    el, jel = port.edgelist(), ref.edgelist()
    assert el.num_edges == int(jel.num_edges) == 2 * len(src)
    assert _eq(el.src, jel.src) and _eq(el.dst, jel.dst)
    assert _eq(el.weights, jel.weights)
    _assert_csr(port.csr(method=method), ref.csr(method=method), weighted)
    _assert_csr(port.csr(rows=(5, 9), method=method),
                ref.csr(rows=(5, 9), method=method), weighted)
    assert port.degree(5) == ref.degree(5)


def test_symmetric_save_is_the_reference_file(texts, tmp_path):
    text = texts[(False, 0)][0]
    ref, port = _open_pair(text, base=0, symmetric=True, num_vertices=V)
    a, b = str(tmp_path / "a.gvel"), str(tmp_path / "b.gvel")
    ref.save(a)
    port.save(b)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_probe_prints_info(texts, tmp_path):
    path = _zlib_snapshot(tmp_path, texts)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.source", path, "--device",
         "cpu"], capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=os.path.abspath(SRC)))
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout)
    assert got == repro_torch.open_graph(path, device="cpu").info().to_dict()
    assert got["section_frames"]["csr_indices"] > 3


def test_engine_point_read_hooks_match_reference(texts, tmp_path):
    """The port's point reads (the front door's, the only ones it has)
    against the reference engine's row, neighbor and degree hooks, and a
    pinned |V| that differs from the header (the CSR is then built from
    the edgelist, as in the reference)."""
    from repro.core.loader import get_engine as jax_engine
    from repro_torch.core import get_engine
    path = _zlib_snapshot(tmp_path, texts)
    eng, ref = get_engine("snapshot"), jax_engine("snapshot")
    port = repro_torch.open_graph(path, device="cpu", weighted=True)
    _assert_csr(port.csr(rows=(4, 19)),
                ref.read_csr_rows(path, 4, 19, weighted=True))
    ids, w = port.neighbors(8, with_weights=True)
    rids, rw = ref.read_neighbors(path, 8, weighted=True)
    assert _eq(ids, rids) and _eq(w, rw)
    assert port.degree(8) == ref.read_degree(path, 8)
    assert eng.read_csr_prebuilt(path, num_vertices=V + 5) is None
    assert eng.num_vertices_hint(path) == V
    eng.clear_memo()
    ref_src, port = _open_pair(path, num_vertices=V + 5)
    _assert_csr(port.csr(), ref_src.csr())
    assert port.csr().num_vertices == V + 5


@pytest.mark.parametrize("product", ["csr", "edgelist", "stream", "save"])
def test_snapshot_engine_pins_no_file_after_a_load(texts, tmp_path, product):
    """The shared snapshot engine lets go of the file it opened once the
    load that opened it ends, whichever product it served."""
    from repro_torch.core import get_engine
    path = _zlib_snapshot(tmp_path, texts)
    eng = get_engine("snapshot")
    eng.clear_memo()
    g = repro_torch.open_graph(path, device="cpu", weighted=True)
    if product == "save":
        g.save(str(tmp_path / "again.gvel"), csr=False)
    else:
        getattr(g, product)()
    assert eng._memo is None
