"""The port's hot-graph cache (``repro_torch.core.cache``) held against the
JAX package's (``tests/test_cache.py``, ``tests/test_frame_cache.py``) on
the CPU.

The same snapshot files and the same request streams go through both
caches (the reference read with ``engine="device"``); answers are compared
bitwise with each other and with a numpy oracle, and ``stats()`` (hits,
misses, evictions, invalidations, the decoded-frame memo, the fault
block) must be equal.  Also: the device is resolved before it enters a
slot, and a cold product is built once however many threads ask for it.
"""
import os
import threading

import numpy as np
import pytest
import torch

from repro.core import snapshot as jsnapshot
from repro.core.cache import SourceCache as JCache
from repro.core.source import open_graph as jax_open
from repro_torch.core import codecs, open_graph, snapshot
from repro_torch.core import cache as cache_mod
from repro_torch.core.cache import SourceCache, default_cache, query

import torch_serving as ts

CPU = {"device": "cpu"}


def _snap(tmp_path, name, **kw):
    return ts.snapshot_file(tmp_path, name, **kw)


def _pair(capacity=4):
    return SourceCache(capacity=capacity), JCache(capacity=capacity)


# ---- LRU semantics -----------------------------------------------------------

def test_lru_bound_and_eviction_order(tmp_path):
    paths = [_snap(tmp_path, f"g{i}", seed=i)[0] for i in range(3)]
    seen = []
    for c, kw in ((SourceCache(capacity=2), CPU), (JCache(capacity=2), {})):
        a = c.get(paths[0], **kw)
        b = c.get(paths[1], **kw)
        log = [len(c), paths[0] in c, paths[1] in c]
        c.get(paths[2], **kw)                   # evicts paths[0]
        log += [len(c), paths[0] in c, paths[1] in c, paths[2] in c,
                c.stats()["evictions"]]
        c.get(paths[1], **kw)
        c.get(paths[0], **kw)                   # now evicts paths[2]
        log += [paths[2] in c, paths[1] in c, c.get(paths[1], **kw) is b]
        # the evicted handle still answers, like a fresh one
        log.append(ts.same(a.neighbors(5), c.get(paths[0], **kw).neighbors(5)))
        log.append(c.stats())
        seen.append(log)
    assert seen[0] == seen[1]
    assert seen[0][:3] == [2, True, True] and seen[0][-2]


def test_capacity_validation():
    for cls in (SourceCache, JCache):
        with pytest.raises(ValueError, match="capacity"):
            cls(capacity=0)


def test_distinct_kwargs_distinct_entries(tmp_path):
    gv, _, _ = _snap(tmp_path, "g", weighted=True)
    c = SourceCache(capacity=4)
    s1 = c.get(gv, **CPU)
    s2 = c.get(gv, weighted=False, **CPU)
    assert s1 is not s2 and len(c) == 2
    assert c.get(gv, **CPU) is s1
    assert ts.host(c.query(gv, "neighbors", vertex=3, with_weights=True,
                           **CPU)[1]) is not None


@pytest.mark.parametrize("spelling", ["cpu", torch.device("cpu")])
def test_device_is_resolved_before_it_enters_the_slot(tmp_path, spelling):
    gv, _, _ = _snap(tmp_path, "g")
    c = SourceCache(capacity=4)
    first = c.get(gv, device="cpu")
    assert c.get(gv, device=spelling) is first
    assert len(c) == 1 and c.stats()["hits"] == 1
    assert first.options.device == torch.device("cpu")


def test_missing_path_raises_and_caches_nothing(tmp_path):
    for c, kw in ((SourceCache(capacity=2), CPU), (JCache(capacity=2), {})):
        with pytest.raises(FileNotFoundError):
            c.get(str(tmp_path / "nope.gvel"), **kw)
        assert len(c) == 0


def test_failed_open_not_cached(tmp_path):
    gv, _, _ = _snap(tmp_path, "g")
    boom = {"n": 2}

    def flaky(path, **kw):
        if boom["n"]:
            boom["n"] -= 1
            raise RuntimeError("transient")
        return open_graph(path, **kw)

    c = SourceCache(capacity=2, open_fn=flaky)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            c.get(gv, **CPU)
    assert len(c) == 0
    assert c.get(gv, **CPU) is c.get(gv, **CPU)


def test_failed_open_releases_waiters(tmp_path):
    """A waiter parked on a failing opener's slot retries and succeeds."""
    gv, _, _ = _snap(tmp_path, "g")
    entered, gate = threading.Event(), threading.Event()
    calls = []

    def flaky(path, **kw):
        calls.append(1)
        if len(calls) == 1:
            entered.set()
            gate.wait(5)
            raise RuntimeError("boom")
        return open_graph(path, **kw)

    c = SourceCache(capacity=2, open_fn=flaky)
    results = {}

    def opener():
        try:
            results["opener"] = c.get(gv, **CPU)
        except RuntimeError as exc:
            results["opener"] = exc

    def waiter():
        entered.wait(5)
        results["waiter"] = c.get(gv, **CPU)

    t1 = threading.Thread(target=opener)
    t2 = threading.Thread(target=waiter)
    t1.start(), t2.start()
    entered.wait(5)
    t2.join(0.3)
    gate.set()
    t1.join(10), t2.join(10)
    assert not t1.is_alive() and not t2.is_alive()
    assert isinstance(results["opener"], RuntimeError)
    assert results["waiter"].neighbors(5) is not None
    assert len(calls) >= 2


def test_stuck_opener_times_out_its_waiters(tmp_path, monkeypatch):
    gv, _, _ = _snap(tmp_path, "g")
    monkeypatch.setattr(cache_mod.faults_mod, "WATCHDOG_S", 0.2)
    gate = threading.Event()

    def stuck(path, **kw):
        gate.wait(5)
        return open_graph(path, **kw)

    c = SourceCache(capacity=2, open_fn=stuck)
    t = threading.Thread(target=lambda: c.get(gv, **CPU))
    t.start()
    while not c._pending:
        pass
    with pytest.raises(cache_mod.StageTimeout, match="still pending"):
        c.get(gv, **CPU)
    gate.set()
    t.join(10)
    assert not t.is_alive()
    assert c.stats()["faults"]["wait_timeouts"] == 1


# ---- invalidation on snapshot swap -------------------------------------------

def test_swap_invalidates_on_next_request(tmp_path):
    out = []
    for c, kw, tag in ((SourceCache(capacity=2), CPU, "p"),
                       (JCache(capacity=2), {}, "j")):
        gv, v, oracle1 = _snap(tmp_path, f"swap{tag}", seed=1)
        got1 = c.query(gv, "neighbors", vertex=7, **kw)
        gv2, _, oracle2 = _snap(tmp_path, f"swap2{tag}", seed=2, e=350)
        os.replace(gv2, gv)
        st = os.stat(gv)
        os.utime(gv, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000_000))
        got2 = c.query(gv, "neighbors", vertex=7, **kw)
        assert ts.same(got1, ts.expect_rows(oracle1, 7, 8)[1])
        assert ts.same(got2, ts.expect_rows(oracle2, 7, 8)[1])
        out.append((ts.host(got1).tolist(), ts.host(got2).tolist(),
                    c.stats()))
    assert out[0] == out[1]
    assert out[0][2]["invalidations"] == 1 and out[0][2]["misses"] == 2


def test_explicit_invalidate(tmp_path):
    p0, _, _ = _snap(tmp_path, "i0")
    p1, _, _ = _snap(tmp_path, "i1", seed=1)
    logs = []
    for c, kw in ((SourceCache(capacity=4), CPU), (JCache(capacity=4), {})):
        c.get(p0, **kw), c.get(p0, weighted=False, **kw), c.get(p1, **kw)
        log = [len(c), c.invalidate(p0), len(c), p1 in c, c.invalidate(p0)]
        c.clear()
        logs.append(log + [len(c), c.stats()["invalidations"]])
    assert logs[0] == logs[1] == [3, 2, 1, True, 0, 0, 3]


# ---- single-flight + threaded hammer -----------------------------------------

def test_cold_open_is_single_flight(tmp_path):
    gv, _, _ = _snap(tmp_path, "g")
    opens = []
    gate = threading.Event()

    def slow_open(path, **kw):
        opens.append(path)
        gate.wait(5)
        return open_graph(path, **kw)

    c = SourceCache(capacity=2, open_fn=slow_open)
    got = []
    threads = [threading.Thread(target=lambda: got.append(c.get(gv, **CPU)))
               for _ in range(8)]
    for t in threads:
        t.start()
    while not opens:
        pass
    gate.set()
    for t in threads:
        t.join(10)
    assert len(opens) == 1, "double-open on a cold path"
    assert len(got) == 8 and all(g is got[0] for g in got)


def test_cold_product_is_built_once(tmp_path, monkeypatch):
    """N threads asking one handle for one cold CSR build it once and all
    get the same object."""
    path, v, oracle = ts.text_file(tmp_path, "cold", v=80, e=900)
    from repro_torch.core import source
    builds = []
    real = source.read_csr_via

    def counting(*a, **kw):
        builds.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(source, "read_csr_via", counting)
    c = SourceCache(capacity=2)
    start = threading.Barrier(8)
    got = []

    def ask():
        start.wait(5)
        got.append(c.query(path, "csr", num_vertices=v, **CPU))

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert len(builds) == 1 and len(got) == 8
    assert all(g is got[0] for g in got)
    assert ts.same_csr(got[0], oracle)
    assert c.stats()["misses"] == 1 and c.stats()["hits"] == 7


def _hammer(c, corpus, kw, n_threads=8, rounds=120):
    start = threading.Barrier(n_threads)
    errors = []

    def worker(wid):
        rng = np.random.default_rng(wid)
        try:
            start.wait(10)
            for _ in range(rounds):
                gv, v, oracle = corpus[rng.integers(0, len(corpus))]
                op = rng.integers(0, 4)
                u = int(rng.integers(0, v))
                if op == 0:
                    got = c.query(gv, "neighbors", vertex=u, **kw)
                    assert ts.same(got, ts.expect_rows(oracle, u, u + 1)[1])
                elif op == 1:
                    assert c.query(gv, "degree", vertex=u, **kw) == int(
                        oracle.offsets[u + 1] - oracle.offsets[u])
                elif op == 2:
                    hi = min(v, u + int(rng.integers(1, 9)))
                    part = c.query(gv, "rows", rows=(u, hi), **kw)
                    assert ts.rows_equal(part, oracle, u, hi)
                else:
                    assert ts.same_csr(c.query(gv, "csr", **kw), oracle)
        except Exception as exc:          # pragma: no cover - failure path
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return errors


def test_threaded_hammer_mixed_ops(tmp_path):
    corpus = [_snap(tmp_path, f"h{i}", seed=i, weighted=(i % 2 == 0))
              for i in range(3)]
    opens = []
    lock = threading.Lock()

    def counting_open(path, **kw):
        with lock:
            opens.append(path)
        return open_graph(path, **kw)

    c = SourceCache(capacity=len(corpus), open_fn=counting_open)
    errors = _hammer(c, corpus, CPU)
    assert not errors, errors[:3]
    assert sorted(opens) == sorted(p for p, _, _ in corpus)
    st = c.stats()
    assert st["misses"] == len(corpus)
    assert st["hits"] == 8 * 120 - len(corpus)
    assert st["evictions"] == 0


# ---- query dispatch ----------------------------------------------------------

def _ops(c, gv, kw):
    info = c.query(gv, "info", **kw)
    full = c.query(gv, "csr", **kw)
    el = c.query(gv, "edgelist", **kw)
    ids, w = c.query(gv, "neighbors", vertex=3, with_weights=True, **kw)
    errs = []
    for op, extra in (("rows", {}), ("neighbors", {}), ("degree", {}),
                      ("pagerank", {})):
        with pytest.raises(ValueError) as ei:
            c.query(gv, op, **extra, **kw)
        errs.append(str(ei.value))
    return info, full, el, ids, w, errs


def test_query_ops_and_validation(tmp_path):
    gv, v, oracle = _snap(tmp_path, "q", weighted=True)
    p, j = _pair(2)
    gi, gfull, gel, gids, gw, gerr = _ops(p, gv, CPU)
    ji, jfull, jel, jids, jw, jerr = _ops(j, gv, {})
    assert gi.section_frames == ji.section_frames
    assert gi.section_frames["csr_offsets"] >= 1
    assert {k: x for k, x in gi.to_dict().items() if k != "device"} == \
        ji.to_dict()
    assert ts.same_csr(gfull, jfull) and ts.same_csr(gfull, oracle)
    assert ts.same(gel.src, jel.src) and ts.same(gel.weights, jel.weights)
    assert int(gel.num_edges) == int(oracle.offsets[-1])
    assert ts.same(gids, jids) and ts.same(gw, jw)
    assert gerr == jerr
    assert "unknown query op" in gerr[-1]
    assert p.stats() == j.stats()


@pytest.mark.parametrize("alias,op", [("full", "csr"), ("csr_rows", "rows"),
                                      ("range", "rows"),
                                      ("point", "neighbors")])
def test_query_aliases(tmp_path, alias, op):
    gv, v, _ = _snap(tmp_path, "a")
    c = SourceCache()
    kw = {"rows": (4, 9)} if op == "rows" else (
        {"vertex": 5} if op == "neighbors" else {})
    a = c.query(gv, alias, **kw, **CPU)
    b = c.query(gv, op, **kw, **CPU)
    if op == "neighbors":
        assert ts.same(a, b)
    else:
        assert ts.same_csr(a, b)


def test_module_level_query_uses_default_cache(tmp_path):
    gv, v, oracle = _snap(tmp_path, "m")
    before = default_cache().stats()["misses"]
    got = query(gv, "degree", vertex=5, **CPU)
    assert got == int(oracle.offsets[6]) - int(oracle.offsets[5])
    assert default_cache() is default_cache()
    assert default_cache().stats()["misses"] == before + 1
    default_cache().invalidate(gv)


# ---- instrumented codec counter ----------------------------------------------

def _spy(monkeypatch, mod):
    calls = []
    real_frame, real_full = mod.decode_frame, mod.decompress_frames

    def frame_spy(payload, entry, codec, **kw):
        calls.append((kw.get("context", ""), entry.index))
        return real_frame(payload, entry, codec, **kw)

    monkeypatch.setattr(mod, "decode_frame", frame_spy)
    monkeypatch.setattr(
        mod, "decompress_frames",
        lambda *a, **kw: calls.append(("FULL", -1)) or real_full(*a, **kw))
    return calls


def test_cached_row_query_decodes_only_touched_frames(tmp_path, monkeypatch):
    from repro.core import codecs as jcodecs
    gv, v, oracle = _snap(tmp_path, "frames")
    seen = []
    for c, mod, kw in ((SourceCache(capacity=2), codecs, CPU),
                       (JCache(capacity=2), jcodecs, {})):
        calls = _spy(monkeypatch, mod)
        frames = c.query(gv, "info", **kw).section_frames
        n0 = len(calls)
        part = c.query(gv, "rows", rows=(20, 24), **kw)
        assert ts.rows_equal(part, oracle, 20, 24)
        touched = sorted(calls[n0:])
        n1 = len(calls)
        c.query(gv, "rows", rows=(20, 24), **kw)
        c.query(gv, "neighbors", vertex=22, **kw)
        seen.append((frames, touched, len(calls) - n1, c.stats()))
    assert seen[0] == seen[1]
    frames, touched = seen[0][0], seen[0][1]
    assert frames["csr_indices"] > 3
    assert touched and all(ctx != "FULL" for ctx, _ in touched)
    assert {ctx.rsplit(" ", 1)[1] for ctx, _ in touched} == {"4", "5"}
    assert seen[0][2] == 0                    # the repeat decodes nothing


# ---- the bounded decoded-frame memo (tests/test_frame_cache.py) ---------------

def _point_hammer(c, gv, v, oracle, kw, rounds=3):
    for _ in range(rounds):
        for u in range(v):
            got = c.query(gv, "neighbors", vertex=u, **kw)
            assert ts.same(got, ts.expect_rows(oracle, u, u + 1)[1]), u


@pytest.mark.parametrize("cap", [4 * ts.FRAME_BETA, 32 << 20])
def test_point_read_hammer_and_frame_stats(tmp_path, monkeypatch, cap):
    """Under a small cap the memo cycles and stays bounded; under a roomy
    one it never evicts: the same counters as the reference either way."""
    monkeypatch.setattr(snapshot, "FRAME_CACHE_BYTES", cap)
    monkeypatch.setattr(jsnapshot, "FRAME_CACHE_BYTES", cap)
    gv, v, oracle = _snap(tmp_path, "hammer", e=1500)
    stats = []
    for c, kw in ((SourceCache(capacity=4), CPU), (JCache(capacity=4), {})):
        _point_hammer(c, gv, v, oracle, kw)
        stats.append(c.stats()["frame_cache"])
    assert stats[0] == stats[1]
    fc = stats[0]
    if cap < (1 << 20):
        assert 0 < fc["bytes"] <= 2 * cap and fc["evictions"] > 0
        assert fc["hits"] > 0
        assert fc["frames"] * ts.FRAME_BETA <= 2 * cap + 2 * ts.FRAME_BETA
    else:
        assert fc["evictions"] == 0 and fc["bytes"] > 0


def test_full_decode_drops_frame_memos(tmp_path):
    gv, v, oracle = _snap(tmp_path, "full")
    src = open_graph(gv, **CPU)
    src.neighbors(3)
    snap = src._selective_snap()
    assert snap.frame_cache_stats()["bytes"] > 0
    full = snap._get(snapshot.SEC_CSR_OFFSETS)      # a whole-section decode
    assert np.array_equal(full, oracle.offsets)
    assert src.frame_cache_stats()["frames"] <= snap.frame_cache_stats()[
        "frames"]
    assert snap._sections[snapshot.SEC_CSR_OFFSETS]._frames_bytes == 0


def test_source_cache_surfaces_frame_stats_of_snapshots_only(tmp_path,
                                                             monkeypatch):
    cap = 4 * ts.FRAME_BETA
    monkeypatch.setattr(snapshot, "FRAME_CACHE_BYTES", cap)
    gv, v, oracle = _snap(tmp_path, "served", e=1500)
    el, _, _ = ts.text_file(tmp_path, "plain", v=4, e=3)
    c = SourceCache(capacity=4)
    for u in range(v):
        c.query(gv, "neighbors", vertex=u, **CPU)
    fc = c.stats()["frame_cache"]
    assert 0 < fc["bytes"] <= 2 * cap and fc["evictions"] > 0
    c.query(el, "degree", vertex=0, **CPU)
    assert c.stats()["frame_cache"] == fc
