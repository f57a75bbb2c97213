"""``repro_torch.core.query``'s selective reads held against the JAX
package's (``tests/test_query.py``) on the CPU.

The same ``.gvel`` files ({raw, zlib, zstd} x weighted x base) and text
files are served through both packages' ``SourceCache.query`` (the
reference read with ``engine="device"``) with the same request streams:
``rows``/``neighbors``/``degree``/``csr`` answers are compared bitwise
with each other and with a numpy oracle, errors by type and message, and
the frames a request decodes are counted in both.
"""
import numpy as np
import pytest

from repro.core import codecs as jcodecs
from repro.core.cache import SourceCache as JCache
from repro_torch.core import codecs, slice_csr
from repro_torch.core.cache import SourceCache

import torch_serving as ts

FMTS = ["raw", "zlib", "zstd"]
CPU = {"device": "cpu"}


def _snapshot(tmp_path, fmt, *, weighted=False, base=1, seed=0, **kw):
    if fmt == "zstd":
        pytest.importorskip("zstandard")
    return ts.snapshot_file(tmp_path, f"q_{fmt}_{weighted}_{base}_{seed}",
                            weighted=weighted, base=base, seed=seed, tail=3,
                            compress=None if fmt == "raw" else fmt, **kw)


def _both(gv, op, **kw):
    """The answer (or the error) of both caches to one request."""
    out = []
    for c, extra in ((SourceCache(), CPU), (JCache(), {})):
        try:
            out.append(c.query(gv, op, **kw, **extra))
        except (ValueError, IndexError) as exc:
            out.append((type(exc).__name__, str(exc).replace(
                "tensor", "array")))
    return out


RANGES = [(7, 7), (0, 0), (5, 6), (59, 60), (57, 60), (17, 43), (0, 60)]
POINTS = (0, 5, 29, 57, 58, 59)


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("base", [0, 1])
def test_rows_and_points_parity(tmp_path, fmt, weighted, base):
    gv, v, oracle = _snapshot(tmp_path, fmt, weighted=weighted, base=base)
    p, j = SourceCache(), JCache()
    for lo, hi in RANGES:
        got = p.query(gv, "rows", rows=(lo, hi), **CPU)
        want = j.query(gv, "rows", rows=(lo, hi))
        assert ts.same_csr(got, want) and ts.rows_equal(got, oracle, lo, hi)
        assert got.offsets.dtype.itemsize == want.offsets.dtype.itemsize
    for u in POINTS:
        got = p.query(gv, "neighbors", vertex=u, **CPU)
        assert ts.same(got, j.query(gv, "neighbors", vertex=u))
        assert ts.same(got, ts.expect_rows(oracle, u, u + 1)[1])
        assert p.query(gv, "degree", vertex=u, **CPU) == j.query(
            gv, "degree", vertex=u)
        if weighted:
            ids, w = p.query(gv, "neighbors", vertex=u, with_weights=True,
                             **CPU)
            rids, rw = j.query(gv, "neighbors", vertex=u, with_weights=True)
            assert ts.same(ids, rids) and ts.same(w, rw)
    assert p.stats() == j.stats()


@pytest.mark.parametrize("fmt", FMTS)
def test_full_range_matches_csr_bitwise(tmp_path, fmt):
    gv, v, _ = _snapshot(tmp_path, fmt, weighted=True)
    c = SourceCache()
    full = c.query(gv, "csr", **CPU)
    part = c.query(gv, "rows", rows=(0, v), **CPU)
    assert part.row_start == 0 and ts.same_csr(part, full)
    assert ts.same_csr(full, JCache().query(gv, "csr"))


def test_range_object_and_pair_equivalent(tmp_path):
    gv, v, oracle = _snapshot(tmp_path, "zlib")
    c = SourceCache()
    a = c.query(gv, "rows", rows=range(11, 37), **CPU)
    b = c.query(gv, "rows", rows=(11, 37), **CPU)
    assert ts.same_csr(a, b) and ts.rows_equal(a, oracle, 11, 37)


@pytest.mark.parametrize("op,kw", [
    ("rows", {"rows": range(0, 10, 2)}), ("rows", {"rows": (7, 3)}),
    ("rows", {"rows": "0:10"}), ("rows", {"rows": (0, 61)}),
    ("rows", {"rows": (-1, 3)}), ("neighbors", {"vertex": -1}),
    ("neighbors", {"vertex": 60}), ("degree", {"vertex": -1}),
    ("degree", {"vertex": 60}),
    ("neighbors", {"vertex": 3, "with_weights": True})])
def test_bad_requests_rejected_like_reference(tmp_path, op, kw):
    gv, v, _ = _snapshot(tmp_path, "raw")
    got, want = _both(gv, op, **kw)
    assert isinstance(got, tuple) and got[0] == want[0]
    assert got[1] == want[1]


def test_text_source_fallback_parity(tmp_path):
    path, v, oracle = ts.text_file(tmp_path, "t", weighted=True, tail=3)
    kw = {"weighted": True, "num_vertices": v}
    p, j = SourceCache(), JCache()
    for lo, hi in ((9, 31), (0, v)):
        got = p.query(path, "rows", rows=(lo, hi), **kw, **CPU)
        assert ts.same_csr(got, j.query(path, "rows", rows=(lo, hi),
                                        engine="device", **kw))
        assert ts.rows_equal(got, oracle, lo, hi)
    ids, w = p.query(path, "neighbors", vertex=13, with_weights=True, **kw,
                     **CPU)
    rids, rw = j.query(path, "neighbors", vertex=13, with_weights=True,
                       engine="device", **kw)
    assert ts.same(ids, rids) and ts.same(w, rw)
    assert p.query(path, "degree", vertex=13, **kw, **CPU) == j.query(
        path, "degree", vertex=13, engine="device", **kw)
    with pytest.raises(IndexError):
        p.query(path, "neighbors", vertex=v, **kw, **CPU)


def test_edgelist_only_snapshot_falls_back(tmp_path):
    gv, v, oracle = _snapshot(tmp_path, "zlib", csr=False)
    c = SourceCache()
    assert ts.rows_equal(c.query(gv, "rows", rows=(4, 25), **CPU), oracle,
                         4, 25)
    assert c.query(gv, "degree", vertex=7, **CPU) == int(
        oracle.offsets[8] - oracle.offsets[7])
    assert ts.same_csr(c.query(gv, "rows", rows=(4, 25), **CPU),
                       JCache().query(gv, "rows", rows=(4, 25)))


def test_num_vertices_override_falls_back(tmp_path):
    gv, v, oracle = _snapshot(tmp_path, "raw")
    p, j = SourceCache(), JCache()
    for lo, hi in ((v, v + 5), (17, 43)):
        got = p.query(gv, "rows", rows=(lo, hi), num_vertices=v + 5, **CPU)
        want = j.query(gv, "rows", rows=(lo, hi), num_vertices=v + 5)
        assert ts.same_csr(got, want)
        assert got.num_vertices == v + 5
    assert ts.host(p.query(gv, "rows", rows=(v, v + 5), num_vertices=v + 5,
                           **CPU).targets).size == 0


def test_slice_csr_rejects_local_csr(tmp_path):
    gv, v, _ = _snapshot(tmp_path, "raw")
    part = SourceCache().query(gv, "rows", rows=(5, 20), **CPU)
    with pytest.raises(ValueError, match="row_start"):
        slice_csr(part, 0, 5)


# ---- partial decode: only the frames the span touches ------------------------

def _spy(monkeypatch, mod):
    calls = []
    real_frame, real_full = mod.decode_frame, mod.decompress_frames

    def frame_spy(payload, entry, codec, **kw):
        calls.append(("frame", kw.get("context", "").rsplit(" ", 1)[1],
                      entry.index))
        return real_frame(payload, entry, codec, **kw)

    def full_spy(*a, **kw):
        calls.append(("full", kw.get("context", ""), -1))
        return real_full(*a, **kw)

    monkeypatch.setattr(mod, "decode_frame", frame_spy)
    monkeypatch.setattr(mod, "decompress_frames", full_spy)
    return calls


@pytest.mark.parametrize("request_", [("rows", {"rows": (20, 24)}),
                                      ("neighbors", {"vertex": 30}),
                                      ("degree", {"vertex": 30}),
                                      ("rows", {"rows": (6, 10)})])
def test_requests_decode_the_reference_frames(tmp_path, monkeypatch,
                                              request_):
    op, kw = request_
    gv, v, oracle = _snapshot(tmp_path, "zlib", weighted=True, frame_beta=64)
    seen = []
    for c, mod, extra in ((SourceCache(), codecs, CPU),
                          (JCache(), jcodecs, {})):
        calls = _spy(monkeypatch, mod)
        c.query(gv, op, **kw, **extra)
        seen.append(sorted(calls))
        n = len(calls)
        c.query(gv, op, **kw, **extra)              # the memo serves it
        assert len(calls) == n
    assert seen[0] == seen[1]
    assert seen[0] and not [x for x in seen[0] if x[0] == "full"]
    secs = {sec for _, sec, _ in seen[0]}
    # a weighted source's rows read weights; a point read never does
    assert secs <= ({"4", "5", "6"} if op == "rows" else {"4", "5"})


def test_rows_property_slice_equals_partial(tmp_path):
    pytest.importorskip("hypothesis")
    from hypothesis import HealthCheck, given, settings, strategies as st

    built = {}

    def snap_for(seed, weighted):
        key = (seed, weighted)
        if key not in built:
            built[key] = ts.snapshot_file(
                tmp_path, f"p{seed}_{weighted}", seed=seed, weighted=weighted,
                frame_beta=64, v=40, e=40 + (seed * 67) % 260)
        return built[key]

    cache, jcache = SourceCache(capacity=16), JCache(capacity=16)

    @settings(max_examples=40, deadline=None,
              suppress_health_check=[HealthCheck.function_scoped_fixture])
    @given(st.integers(0, 5), st.booleans(),
           st.integers(0, 40), st.integers(0, 40))
    def prop(seed, weighted, a, b):
        gv, v, oracle = snap_for(seed, weighted)
        lo, hi = min(a, b), max(a, b)
        part = cache.query(gv, "rows", rows=(lo, hi), **CPU)
        whole = slice_csr(cache.query(gv, "csr", **CPU), lo, hi)
        assert ts.same_csr(part, whole)
        assert ts.same_csr(part, jcache.query(gv, "rows", rows=(lo, hi)))
        assert ts.rows_equal(part, oracle, lo, hi)

    prop()


def test_csr_row_accessors_on_query_products(tmp_path):
    """``CSR.degree``/``neighbors``/``degrees`` on the products a query
    returns equal the reference's on its products."""
    gv, v, _ = _snapshot(tmp_path, "zlib")
    p, j = SourceCache(), JCache()
    for op, kw in (("csr", {}), ("rows", {"rows": (10, 30)})):
        got = p.query(gv, op, **kw, **CPU)
        want = j.query(gv, op, **kw)
        assert ts.same(got.degrees(), want.degrees())
        for u in (0, 3, got.num_rows - 1):
            assert int(got.degree(u)) == int(want.degree(u))
            assert ts.same(got.neighbors(u), want.neighbors(u))

