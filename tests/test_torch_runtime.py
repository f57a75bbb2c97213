"""The port's ServeRuntime (``repro_torch.serve.runtime``) on the CPU:
twins of tests/test_runtime.py's ten churn tests (snapshot swap under the
live server, straggler degrade, preemption, corpus resume, signal
handlers, a corrupt graph quarantined, a zero-edge graph), and the same
requests through the JAX package's runtime: prompts bitwise, token streams
under the margin rule of tests/torch_lm.py.

Graph files are made by the port from seeds; the port's ``.gvel`` files
are byte-identical to the JAX package's, so both runtimes read the same
bytes.  The model is the reference tests' ``init_params(key(3))`` draw,
carried over with ``params_from_jax``.
"""
import os
import shutil
import signal

import jax
import numpy as np
import pytest

from repro.configs import reduced_config as jreduced
from repro.core.cache import SourceCache as JCache
from repro.models import init_params as jinit
from repro.serve.runtime import ServeRuntime as JRuntime
from repro_torch.configs import reduced_config
from repro_torch.core import (convert_to_csr, load_edgelist, make_graph_file,
                              open_graph, save_snapshot, write_edgelist)
from repro_torch.core.cache import SourceCache
from repro_torch.core.faults import (CorruptGraphError, FaultPlan, FaultSpec,
                                     fault_plan)
from repro_torch.data.corpus import CorpusConfig
from repro_torch.ft.coordinator import FTConfig
from repro_torch.models import params_from_jax
from repro_torch.scripts.chaos_matrix import corrupt_section
from repro_torch.serve.runtime import ServeRuntime
from torch_lm import assert_streams_agree, record_tick_logits

CFG = reduced_config("phi4-mini-3.8b")
CC = CorpusConfig(batch=2, seq=8, vocab_size=CFG.vocab_size, seed=5)


@pytest.fixture(scope="module")
def jparams():
    return jinit(jax.random.key(3), jreduced("phi4-mini-3.8b"))


@pytest.fixture(scope="module")
def params(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), CFG,
                           device="cpu")


@pytest.fixture()
def snaps(tmp_path):
    """Two different graphs as snapshots; ``a`` is the served path."""
    ela = str(tmp_path / "a.el")
    va, _ = make_graph_file(ela, "rmat", scale=7, edge_factor=6, seed=2)
    a = str(tmp_path / "live.gvel")
    open_graph(ela, num_vertices=va, device="cpu").save(a)
    elb = str(tmp_path / "b.el")
    vb, _ = make_graph_file(elb, "uniform", scale=6, edge_factor=4, seed=9)
    b = str(tmp_path / "b.gvel")
    open_graph(elb, num_vertices=vb, device="cpu").save(b)
    return a, b


def _runtime(params, **kw):
    kw.setdefault("batch", 2)
    kw.setdefault("max_seq", 32)
    kw.setdefault("prompt_len", 8)
    kw.setdefault("cache", SourceCache(capacity=4))
    return ServeRuntime(CFG, params, device="cpu", **kw)


def test_serves_more_requests_than_slots(params, snaps):
    a, _ = snaps
    rt = _runtime(params)
    reqs = [rt.submit(a, max_new=4) for _ in range(5)]
    rt.drain()
    assert all(r.done and len(r.out) == 4 for r in reqs)
    st = rt.stats()
    assert st["requests"] == 5 and st["tokens"] == 20
    assert st["ticks"] > 0 and 0 < st["occupancy"] <= 1.0
    assert st["cache"]["hits"] >= 4        # one open, handle reused


def test_deterministic_across_runtimes(params, snaps):
    a, _ = snaps
    rt1 = _runtime(params)
    rt2 = _runtime(params)
    q1 = [rt1.submit(a, max_new=3, rid=i) for i in range(3)]
    q2 = [rt2.submit(a, max_new=3, rid=i) for i in range(3)]
    rt1.drain(), rt2.drain()
    for x, y in zip(q1, q2):
        assert np.array_equal(x.prompt, y.prompt)
        assert x.out == y.out


def test_snapshot_swap_under_live_runtime(params, snaps):
    """Swap the snapshot on disk while requests are in flight: nothing is
    dropped, and the next request resolves the new graph via mtime
    invalidation, no restart."""
    a, b = snaps
    rt = _runtime(params)
    inflight = [rt.submit(a, max_new=4, rid=i) for i in range(5)]
    for _ in range(2):                     # mid-serving, slots busy
        rt.tick()
    shutil.copyfile(b, a)                  # swap under the live server
    post = rt.submit(a, max_new=4, rid=0)  # same rid, new graph bytes
    rt.drain()
    assert all(r.done and len(r.out) == 4 for r in inflight + [post])
    assert rt.cache.stats()["invalidations"] >= 1
    # the post-swap prompt equals a cold open of the swapped file...
    want = _runtime(params).submit(a, max_new=1, rid=0)
    assert np.array_equal(post.prompt, want.prompt)
    # ...and reflects the new graph, not the old one
    assert not np.array_equal(inflight[0].prompt, post.prompt)


def test_straggler_degrades_admission_width(params):
    rt = _runtime(params, ft=FTConfig(straggler_policy="degrade",
                                      straggler_factor=4.0,
                                      straggler_window=6))
    for _ in range(6):
        rt._observe(0.01)
    assert rt.engine.max_active == 2
    rt._observe(1.0)                       # straggler tick -> halve
    assert rt.engine.max_active == 1
    assert rt.stats()["degrades"] == 1
    for _ in range(6):                     # pressure clears -> restore
        rt._observe(0.01)
    assert rt.engine.max_active == 2
    assert rt.stats()["restores"] == 1


def test_degraded_width_still_completes(params, snaps):
    a, _ = snaps
    # huge window: healthy ticks never restore the width mid-test
    rt = _runtime(params, ft=FTConfig(straggler_policy="degrade",
                                      straggler_window=10**6))
    rt.engine.max_active = 1               # degraded: serialized slots
    reqs = [rt.submit(a, max_new=3) for _ in range(4)]
    rt.drain()
    assert all(r.done and len(r.out) == 3 for r in reqs)
    assert max(r.slot for r in reqs) == 0  # only slot 0 ever admitted


def test_preemption_pauses_then_resumes_drain(params, snaps):
    a, _ = snaps
    rt = _runtime(params)
    reqs = [rt.submit(a, max_new=6) for _ in range(4)]
    rt.coord.preempted = True              # simulated SIGTERM
    assert rt.drain() == 0                 # stops at the tick boundary
    assert not all(r.done for r in reqs)   # work still queued, not lost
    rt.coord.preempted = False
    rt.drain()
    assert all(r.done and len(r.out) == 6 for r in reqs)


def test_corpus_through_cache_resumes(params, snaps):
    a, _ = snaps
    rt = _runtime(params)
    ref = []
    with rt.corpus(a, CC) as stream:
        for _ in range(5):
            ref.append(next(stream)[1]["tokens"].numpy())
    assert rt.stats()["resumes"] == 0
    with rt.corpus(a, CC, start_step=2) as stream:
        for want in range(2, 5):
            step, batch = next(stream)
            assert step == want
            assert np.array_equal(batch["tokens"].numpy(), ref[step])
    assert rt.stats()["resumes"] == 1
    # the corpus resolved through the same cache the requests use
    assert rt.cache.stats()["hits"] >= 1


def test_close_restores_signal_handlers(params):
    before = signal.getsignal(signal.SIGUSR1)
    with ServeRuntime(CFG, params, batch=2, max_seq=16,
                      cache=SourceCache(capacity=2),
                      ft=FTConfig(handle_signals=True), device="cpu") as rt:
        assert signal.getsignal(signal.SIGUSR1) == rt.coord._on_signal
        assert signal.getsignal(signal.SIGTERM) == rt.coord._on_signal
    assert signal.getsignal(signal.SIGUSR1) == before


# ---- robustness: corrupt graphs + degenerate graphs ---------------------------

def _compressed_snap(tmp_path, name, *, seed=2):
    """zlib-framed snapshot with small frames (corruption is section-
    local, so the quarantine scope is observable)."""
    el = str(tmp_path / (name + ".el"))
    v, _ = make_graph_file(el, "rmat", scale=7, edge_factor=6, seed=seed)
    elist = load_edgelist(el, num_vertices=v, base=1, device="cpu")
    gv = str(tmp_path / name)
    save_snapshot(gv, edgelist=elist, csr=convert_to_csr(elist),
                  compress="zlib", frame_beta=96)
    return gv, v


def test_corrupt_graph_quarantined_while_others_serve(params, tmp_path):
    """A CRC-failing section quarantines (path, section), requests against
    it get a structured CorruptGraphError, admission degrades via the
    straggler path, other graphs keep serving, and a swap on disk
    recovers -- all visible in stats()."""
    live, _ = _compressed_snap(tmp_path, "live.gvel", seed=2)
    good, _ = _compressed_snap(tmp_path, "good.gvel", seed=9)
    shutil.copyfile(live, live + ".bak")
    rt = _runtime(params)
    corrupt_section(live, "csr_indices")

    with pytest.raises(CorruptGraphError) as ei:
        rt.submit(live, max_new=2)
    assert ei.value.path == live and ei.value.section == "csr_indices"
    assert rt.engine.max_active == 1          # degraded, not stalled
    # repeat offenders fail fast from quarantine, no second degrade
    with pytest.raises(CorruptGraphError, match="quarantined"):
        rt.submit(live, max_new=2)
    # ...while other graphs in the same cache/runtime still serve
    req = rt.submit(good, max_new=3)
    rt.drain()
    assert req.done and len(req.out) == 3
    st = rt.stats()
    assert st["corrupt_requests"] == 1
    assert st["degrades"] == 1
    faults_st = st["cache"]["faults"]
    assert faults_st["quarantines"] == 1
    assert faults_st["quarantined"][0]["section"] == "csr_indices"
    assert any("fault: corrupt graph" in e for e in rt.coord.events)

    # swap the good bytes back: quarantine lifts, requests serve again
    os.replace(live + ".bak", live)
    os.utime(live)
    req2 = rt.submit(live, max_new=2)
    rt.drain()
    assert req2.done and len(req2.out) == 2
    assert rt.cache.stats()["faults"]["recovered"] >= 1


def test_zero_edge_graph_serves_end_to_end(params, tmp_path):
    """A V>0, E=0 graph flows through SourceCache.query -> neighbors/
    degree -> a full ServeRuntime request, under an injected open fault
    (retried transparently)."""
    el = str(tmp_path / "zero.el")
    write_edgelist(el, np.array([], np.int64), np.array([], np.int64),
                   None, base=1)
    elist = load_edgelist(el, num_vertices=6, base=1, device="cpu")
    gv = str(tmp_path / "zero.gvel")
    save_snapshot(gv, edgelist=elist, csr=convert_to_csr(elist),
                  compress="zlib", frame_beta=64)

    rt = _runtime(params)
    plan = FaultPlan([FaultSpec("open", "oserror", times=1)])
    with fault_plan(plan):
        nbrs = rt.cache.query(gv, "neighbors", vertex=0, device="cpu")
        assert nbrs.numel() == 0
        assert int(rt.cache.query(gv, "degree", vertex=5, device="cpu")) == 0
        req = rt.submit(gv, max_new=3)       # edgeless walk: self-loops
        rt.drain()
    assert req.done and len(req.out) == 3
    assert len(set(req.prompt.tolist())) == 1
    assert plan.injected() == {"open:oserror": 1}
    assert rt.cache.stats()["faults"]["open_retries"] == 1
    assert rt.stats()["corrupt_requests"] == 0


# ---- the two packages' runtimes on the same requests --------------------------

def test_prompts_and_streams_match_the_jax_runtime(params, jparams, snaps,
                                                   tmp_path):
    """Requests against a snapshot and a text graph, with drawn and pinned
    starts: every prompt equals the JAX runtime's bitwise for the same
    ``(seed, rid, graph)``; the drained token streams agree under the
    margin rule."""
    a, b = snaps
    text = str(tmp_path / "c.el")
    make_graph_file(text, "rmat", scale=6, edge_factor=5, seed=4)
    rt = _runtime(params, seed=13, batch=3)
    jrt = JRuntime(jreduced("phi4-mini-3.8b"), jparams, batch=3, max_seq=32,
                   prompt_len=8, cache=JCache(capacity=4), seed=13)
    jlogits = record_tick_logits(jrt.engine)
    kinds = [{}, {"rid": 40}, {"start": 3}, {"prompt_len": 5}]
    got, want = [], []
    for i in range(9):
        path = (a, b, text)[i % 3]
        kw = dict(kinds[i % 4], max_new=1 + i % 5)
        if "rid" in kw:
            kw["rid"] += i
        got.append(rt.submit(path, **kw))
        want.append(jrt.submit(path, **kw))
    for x, y in zip(got, want):
        assert x.rid == y.rid
        assert x.prompt.dtype == np.int32
        assert np.array_equal(x.prompt, np.asarray(y.prompt)), x.rid
    rt.drain(), jrt.drain()
    assert len({r.rid for r in want}) == len(want)
    assert_streams_agree({r.rid: r.out for r in got},
                         {r.rid: r.out for r in want}, jlogits)
    jrt.close()
