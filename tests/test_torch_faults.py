"""The port's fault injection and recovery held against the JAX package's
(``tests/test_faults.py``) on the CPU.

The same plans run through ``repro.core.faults`` and
``repro_torch.core.faults``, and the same files through both packages'
loaders and caches (the reference read with ``engine="device"``): plans
parse and fire alike, damage the same bytes, the loads recover to bitwise
equal CSRs, and errors, their fields and messages, ``injected()`` and the
cache's ``stats()`` counters agree.  Every test starts and ends with no
plan and zeroed counters in both packages; a plan armed from the
environment runs in a subprocess with its own timeout.
"""
import errno
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.core import faults as jfaults
from repro.core import open_graph as jax_open
from repro.core.cache import SourceCache as JCache
from repro.core.codecs import iter_decompressed_frames as j_iter_frames
import repro_torch
from repro_torch.core import blocks, codecs, faults, open_graph
from repro_torch.core.cache import SourceCache
from repro_torch.core.faults import (CorruptGraphError, FaultPlan, FaultSpec,
                                     ShardLoadError, StageTimeout,
                                     fault_plan, plan_from_env,
                                     set_fault_plan)
from repro_torch.core.snapshot import SnapshotError
from repro_torch.scripts.chaos_matrix import corrupt_section

import torch_serving as ts

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def _clean_faults():
    """No plan or counter leaks across tests, in either package."""
    for mod in (faults, jfaults):
        mod.set_fault_plan(None)
        mod.reset_counters()
    yield
    for mod in (faults, jfaults):
        mod.set_fault_plan(None)
        mod.reset_counters()


def _jplan(plan):
    """The reference twin of a port plan."""
    return jfaults.FaultPlan(
        [jfaults.FaultSpec(**vars(f)) for f in plan.faults], seed=plan.seed)


def _graph_file(tmp_path, name="g.el", *, v=50, e=300, seed=0):
    rng = np.random.default_rng(seed)
    path = str(tmp_path / name)
    repro_torch.core.write_edgelist(path, rng.integers(0, v, e),
                                    rng.integers(0, v, e), None, base=1)
    return path, v


def _snapshot(tmp_path, name="g", *, seed=0):
    gv, v, _ = ts.snapshot_file(tmp_path, name, seed=seed, v=50, e=300)
    return gv, v


def _pair_csr(path, v, jplan=None, plan=None, **kw):
    ref = jax_open(path, engine="device", num_vertices=v, faults=jplan,
                   **kw).csr()
    got = open_graph(path, num_vertices=v, device="cpu", faults=plan,
                     **kw).csr()
    return ref, got


# ---- plans, parsing, deterministic corruption --------------------------------


SPECS = ["seed=3; block:oserror@2*2 ;frame:bitflip@1~web",
         "open:oserror*3;mmap:latency~web", "", "  ",
         "seed=9;frame:truncate@4*-1;block:stall@0"]


@pytest.mark.parametrize("spec", SPECS)
def test_plan_from_env_grammar_matches_reference(spec):
    got, want = plan_from_env(spec), jfaults.plan_from_env(spec)
    if want is None:
        assert got is None
        return
    assert got.seed == want.seed
    assert [vars(f) for f in got.faults] == [vars(f) for f in want.faults]


@pytest.mark.parametrize("bad,match", [("disk:oserror@0", "site"),
                                       ("block:explode@0", "kind"),
                                       ("justtext", "bad entry")])
def test_plan_from_env_rejects_like_reference(bad, match):
    with pytest.raises(ValueError, match=match) as got:
        plan_from_env(bad)
    with pytest.raises(ValueError) as want:
        jfaults.plan_from_env(bad)
    assert str(got.value) == str(want.value)


def test_match_consumes_budget_and_filters_path():
    plan = FaultPlan([FaultSpec("open", "oserror", times=2, path="web")])
    ref = _jplan(plan)
    for where in ("other.gvel", "a/web.gvel", "a/web.gvel", "a/web.gvel"):
        assert (len(plan.match("open", 0, where))
                == len(ref.match("open", 0, where)))
    assert plan.injected() == ref.injected() == {"open:oserror": 2}
    assert plan.total_injected() == ref.total_injected() == 2


@pytest.mark.parametrize("kind", ["bitflip", "truncate", "oserror"])
@pytest.mark.parametrize("seed,index,salt", [(7, 0, 3), (7, 0, 4), (0, 5, 0),
                                             (123, 2, 99)])
def test_the_same_plan_damages_the_same_bytes(kind, seed, index, salt):
    data = bytes(np.random.default_rng(seed).integers(0, 256, 777, np.uint8))
    spec = FaultSpec("frame", kind, index=index, times=-1)
    plan = FaultPlan([spec], seed=seed)
    got = plan.corrupt(data, spec, salt=salt)
    want = _jplan(plan).corrupt(data, _jplan(plan).faults[0], salt=salt)
    assert got == want
    assert plan.corrupt(data, spec, salt=salt) == got      # deterministic
    if kind == "bitflip":
        assert sum(x != y for x, y in zip(got, data)) == 1
    elif kind == "truncate":
        assert 0 < len(got) < len(data)
    else:
        assert got == data
    for _ in range(5):
        assert plan.match("frame", index)                  # never exhausts


def test_fault_plan_context_restores_previous():
    outer = FaultPlan([])
    set_fault_plan(outer)
    inner = FaultPlan([])
    with fault_plan(inner):
        assert faults.active_plan() is inner
        with fault_plan(None):                            # no-op nesting
            assert faults.active_plan() is inner
    assert faults.active_plan() is outer


def test_env_plan_is_armed_at_import():
    code = ("import repro_torch.core.faults as f, sys\n"
            "p = f.active_plan()\n"
            "print(p.seed, [(s.site, s.kind, s.index, s.times, s.path) "
            "for s in p.faults], "
            "sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('repro.')))\n")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               REPRO_FAULTS="seed=7;block:oserror@3*2;frame:bitflip@0~web")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == (
        "7 [('block', 'oserror', 3, 2, ''), ('frame', 'bitflip', 0, 1, "
        "'web')] []")


# ---- retry machinery ---------------------------------------------------------


def _flaky(fails, exc):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= fails:
            raise exc
        return "ok"
    return fn, calls


@pytest.mark.parametrize("fails,exc,attempts,ok", [
    (2, OSError(errno.EIO, "flaky"), 3, True),
    (1, OSError(errno.EAGAIN, "flaky"), 2, True),
    (5, OSError(errno.EAGAIN, "flaky"), 2, False),
    (5, FileNotFoundError(errno.ENOENT, "gone", "x"), 5, False),
])
def test_call_with_retries_matches_reference(fails, exc, attempts, ok):
    results = []
    for mod in (faults, jfaults):
        fn, calls = _flaky(fails, exc)
        retried = []
        try:
            out = mod.call_with_retries(fn, attempts=attempts,
                                        backoff_s=0.001,
                                        on_retry=retried.append)
        except OSError as e:
            out = type(e)
        results.append((out, len(calls), len(retried),
                        mod.counters()["io_retries"]))
    assert results[0] == results[1]
    assert (results[0][0] == "ok") == ok


@pytest.mark.parametrize("exc", [OSError(errno.EIO, "x"),
                                 OSError(errno.ESTALE, "x"),
                                 FileNotFoundError(errno.ENOENT, "x"),
                                 PermissionError(errno.EACCES, "x"),
                                 ValueError("x")])
def test_is_transient_classification(exc):
    assert faults.is_transient(exc) == jfaults.is_transient(exc)


# ---- streaming load: retry parity + watchdog ---------------------------------


def test_streaming_load_retries_transient_block_faults_bitwise(tmp_path):
    path, v = _graph_file(tmp_path)
    clean = open_graph(path, num_vertices=v, device="cpu").csr()
    plan = FaultPlan([FaultSpec("block", "oserror", index=0, times=2),
                      FaultSpec("block", "latency", index=0, delay_s=0.01)])
    jplan = _jplan(plan)
    ref, got = _pair_csr(path, v, jplan, plan)
    assert plan.injected() == jplan.injected() == {"block:oserror": 2,
                                                   "block:latency": 1}
    assert faults.counters() == jfaults.counters()
    assert faults.counters()["io_retries"] == 2
    assert ts.same_csr(got, clean) and ts.same_csr(got, ref)


@pytest.mark.parametrize("codec", ["raw", "gzip", "framed"])
def test_block_fault_sites_cover_every_source(tmp_path, codec):
    path, v = _graph_file(tmp_path)
    if codec == "gzip":
        import gzip
        with open(path, "rb") as f, gzip.open(path + ".gz", "wb") as g:
            g.write(f.read())
        path += ".gz"
    elif codec == "framed":
        codecs.compress_file_framed(path, path + ".z", frame_beta=1024)
        path += ".z"
    plan = FaultPlan([FaultSpec("block", "oserror", index=0, times=1,
                                path=os.path.basename(path))])
    jplan = _jplan(plan)
    ref, got = _pair_csr(path, v, jplan, plan, beta=1024)
    assert plan.injected() == jplan.injected() == {"block:oserror": 1}
    assert ts.same_csr(got, ref)


def test_streaming_load_exhausted_retries_raise(tmp_path):
    path, v = _graph_file(tmp_path)
    plan = FaultPlan([FaultSpec("block", "oserror", index=0, times=-1)])
    with pytest.raises(OSError, match="injected transient") as got:
        open_graph(path, num_vertices=v, device="cpu", faults=plan).csr()
    with pytest.raises(OSError) as want:
        jax_open(path, engine="device", num_vertices=v,
                 faults=_jplan(plan)).csr()
    assert str(got.value) == str(want.value)
    assert faults.counters() == jfaults.counters()


def test_stuck_block_source_raises_stage_timeout(tmp_path, monkeypatch):
    path, v = _graph_file(tmp_path)
    msgs = []
    for mod, opener in ((faults, lambda p: open_graph(
            path, num_vertices=v, device="cpu", faults=p)),
            (jfaults, lambda p: jax_open(path, engine="device",
                                         num_vertices=v, faults=p))):
        monkeypatch.setattr(mod, "WATCHDOG_S", 0.3)
        plan = mod.FaultPlan([mod.FaultSpec("block", "stall", index=0,
                                            delay_s=2.0)])
        t0 = time.perf_counter()
        with pytest.raises(mod.StageTimeout,
                           match=r"byte span \[0, ") as ei:
            opener(plan).csr()
        assert time.perf_counter() - t0 < 1.5      # within budget, no hang
        assert mod.counters()["stage_timeouts"] == 1
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_faulty_block_source_damages_the_reference_rows(tmp_path):
    """A data fault damages the staged rows the reference damages (bit for
    bit in the damaged row), in a copy: the arena slot stays clean."""
    from repro.core import blocks as jblocks
    data = np.frombuffer(("\n".join(f"{i} {i * 7 % 1000}" for i in
                                    range(2000)) + "\n").encode(), np.uint8)
    plan_b = blocks.plan_blocks(len(data), beta=1024, overlap=64)
    jplan_b = jblocks.plan_blocks(len(data), beta=1024, overlap=64)
    ids = np.arange(2, 6)
    plan = FaultPlan([FaultSpec("block", "bitflip", index=3),
                      FaultSpec("block", "truncate", index=5)], seed=11)
    jplan = _jplan(plan)
    arena = blocks.StagingArena(blocks.flat_len(len(ids), plan_b))
    with fault_plan(plan):
        src = faults.wrap_block_source(blocks.MemoryBlockSource(data), "f")
        assert isinstance(src, faults.FaultyBlockSource)
        flat = src.stage(plan_b, ids, arena=arena.slot(0))
    with jfaults.fault_plan(jplan):
        jsrc = jfaults.wrap_block_source(jblocks.MemoryBlockSource(data), "f")
        rows = jsrc.stage(jplan_b, ids)
    got = blocks.block_view(flat, plan_b)
    assert plan.injected() == jplan.injected() == {"block:bitflip": 1,
                                                   "block:truncate": 1}
    assert np.array_equal(got[1], rows[1])      # block 3, bit-flipped
    assert np.array_equal(got[3], rows[3])      # block 5, truncated
    assert not np.array_equal(rows[1], jblocks.MemoryBlockSource(data).stage(
        jplan_b, ids)[1])
    clean = blocks.MemoryBlockSource(data).stage(plan_b, ids)
    assert np.array_equal(arena.slot(0).take(len(clean)), clean)


class _Fence:
    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


def test_retried_stage_waits_its_fence_once(tmp_path):
    """An injected failure fires before the slot is taken, so the retry
    takes it once and waits on its fence once."""
    data = np.frombuffer(b"1 2\n" * 2000, np.uint8)
    plan_b = blocks.plan_blocks(len(data), beta=1024, overlap=64)
    arena = blocks.StagingArena(blocks.flat_len(2, plan_b))
    fence = _Fence()
    arena.fence(0, fence)
    with fault_plan(FaultPlan([FaultSpec("block", "oserror", index=0,
                                         times=2)])):
        src = faults.wrap_block_source(blocks.MemoryBlockSource(data), "f")
        flat = faults.call_with_retries(
            lambda: src.stage(plan_b, np.arange(2), arena=arena.slot(0)),
            backoff_s=0.001)
    assert fence.waits == 1
    assert faults.counters()["io_retries"] == 2
    assert np.array_equal(flat, blocks.MemoryBlockSource(data).stage(
        plan_b, np.arange(2)))


def test_mmap_site_fires_once_per_map(tmp_path):
    gv, v = _snapshot(tmp_path)
    plan = FaultPlan([FaultSpec("mmap", "oserror", times=1)])
    with fault_plan(plan), pytest.raises(OSError, match="injected"):
        blocks.mmap_bytes(gv)
    assert blocks.mmap_bytes(gv).size == os.path.getsize(gv)
    assert plan.injected() == {"mmap:oserror": 1}


def test_frame_site_damages_what_the_reference_damages(tmp_path):
    """A frame bitflip fails the same frame in both packages' decoders,
    with the same message (the damage is seeded by the frame index)."""
    raw = bytes(np.random.default_rng(0).integers(0, 256, 4096, np.uint8))
    stream = codecs.compress_frames(raw, codecs.get_codec("zlib"),
                                    frame_beta=512)
    msgs = []
    for mod, it in ((faults, codecs.iter_decompressed_frames),
                    (jfaults, j_iter_frames)):
        from repro.core.codecs import get_codec as jget
        codec = (codecs.get_codec("zlib") if mod is faults
                 else jget("zlib"))
        plan = mod.FaultPlan([mod.FaultSpec("frame", "bitflip", index=3)],
                             seed=5)
        with mod.fault_plan(plan), pytest.raises(ValueError) as ei:
            list(it(stream, codec, context="s"))
        msgs.append(str(ei.value))
        assert plan.injected() == {"frame:bitflip": 1}
    assert msgs[0] == msgs[1] and "frame 3" in msgs[0]
    entry = codecs.frame_table(stream)[3]
    with fault_plan(FaultPlan([FaultSpec("frame", "bitflip", index=3)],
                              seed=5)), pytest.raises(ValueError) as ei:
        codecs.decode_frame(stream, entry, codecs.get_codec("zlib"),
                            context="s")
    assert str(ei.value) == msgs[0]


# ---- SourceCache: open retries, quarantine, swap recovery --------------------


def test_cache_open_retries_transient(tmp_path):
    gv, _ = _snapshot(tmp_path)
    out = []
    for mod, cache, kw in ((faults, SourceCache(capacity=2),
                            {"device": "cpu"}),
                           (jfaults, JCache(capacity=2), {})):
        with mod.fault_plan(mod.FaultPlan([mod.FaultSpec("open", "oserror",
                                                         times=2)])):
            info = cache.query(gv, "info", **kw)
        out.append((info.num_vertices, cache.stats()["faults"]))
    assert out[0] == out[1]
    assert out[0][1]["open_retries"] == 2 and out[0][1]["io_retries"] == 2


def _quarantine_run(tmp_path, mod, cache, kw):
    gv = str(tmp_path / f"live_{mod.__name__.split('.')[0]}.gvel")
    src, v = _snapshot(tmp_path, "live")
    with open(src, "rb") as f, open(gv, "wb") as g:
        g.write(f.read())
    other, _ = _snapshot(tmp_path, "other", seed=4)
    log = [cache.query(gv, "degree", vertex=3, **kw)]
    cache.invalidate()
    corrupt_section(gv, "csr_indices")
    with pytest.raises(mod.CorruptGraphError) as ei:
        cache.query(gv, "csr", **kw)
    log.append((ei.value.path == gv, ei.value.section, ei.value.op))
    with pytest.raises(mod.CorruptGraphError, match="quarantined") as ei:
        cache.query(gv, "neighbors", vertex=3, **kw)
    log.append((ei.value.section, ei.value.op))
    log.append(cache.query(gv, "info", **kw).num_vertices)
    log.append(cache.query(gv, "degree", vertex=3, **kw))
    log.append(cache.query(other, "csr", **kw).num_vertices)
    st = cache.stats()["faults"]
    log.append({k: st[k] for k in ("quarantines", "corrupt_errors",
                                   "recovered")})
    log.append([{**q, "path": q["path"] == gv} for q in st["quarantined"]])
    with open(src, "rb") as f, open(gv + ".new", "wb") as g:
        g.write(f.read())
    os.replace(gv + ".new", gv)
    os.utime(gv, ns=(time.time_ns(), time.time_ns() + 1_000_000_000))
    full = cache.query(gv, "csr", **kw)
    st = cache.stats()
    log.append((full.num_vertices, st["faults"]["recovered"],
                st["faults"]["quarantined"], st["invalidations"]))
    return log, full


def test_corrupt_section_quarantines_and_swap_recovers(tmp_path):
    got, gcsr = _quarantine_run(tmp_path, faults, SourceCache(capacity=4),
                                {"device": "cpu"})
    want, wcsr = _quarantine_run(tmp_path, jfaults, JCache(capacity=4), {})
    assert got == want
    assert want[1] == (True, "csr_indices", "csr")
    assert want[-1][1] == 1 and want[-1][2] == []
    assert ts.same_csr(gcsr, wcsr)


def test_report_corrupt_unknown_section_blocks_everything_but_info(tmp_path):
    gv, _ = _snapshot(tmp_path)
    cache = SourceCache()
    err = cache.report_corrupt(gv, ValueError("mystery damage"), op="csr")
    jerr = JCache().report_corrupt(gv, ValueError("mystery damage"),
                                   op="csr")
    assert isinstance(err, CorruptGraphError)
    assert (str(err), err.section, err.op, err.path) == (
        str(jerr), jerr.section, jerr.op, jerr.path)
    with pytest.raises(CorruptGraphError):
        cache.query(gv, "degree", vertex=0, device="cpu")
    assert cache.query(gv, "info", device="cpu").num_edges == 300


@pytest.mark.parametrize("section", ["csr_indices", "csr_offsets", "dst"])
def test_snapshot_error_carries_section(tmp_path, section):
    gv, _ = _snapshot(tmp_path)
    corrupt_section(gv, section)
    product = "edgelist" if section == "dst" else "csr"
    with pytest.raises(SnapshotError) as got:
        getattr(open_graph(gv, device="cpu"), product)()
    with pytest.raises(Exception) as want:
        getattr(jax_open(gv), product)()
    assert got.value.section == want.value.section == section


# ---- uniform truncation/corruption messages ----------------------------------


def test_codec_errors_name_frame_and_byte_offset():
    from repro.core.codecs import get_codec as jget
    raw = bytes(np.random.default_rng(0).integers(0, 256, 4096, np.uint8))
    stream = codecs.compress_frames(raw, codecs.get_codec("zlib"),
                                    frame_beta=512)
    bad = bytearray(stream)
    bad[20] ^= 0xFF
    for data, ctx in ((stream[:-5], "cut"), (stream + b"\x01\x02\x03", "hdr"),
                      (bytes(bad), "bad")):
        with pytest.raises(ValueError, match=r"frame \d+ .*byte \d+") as got:
            list(codecs.iter_decompressed_frames(
                data, codecs.get_codec("zlib"), context=ctx))
        with pytest.raises(ValueError) as want:
            list(j_iter_frames(data, jget("zlib"), context=ctx))
        assert str(got.value) == str(want.value)


# ---- zero-edge / empty graphs through the serving path -----------------------


def _degenerate_run(mod, cache, gv, v, kw):
    plan = mod.FaultPlan([mod.FaultSpec("open", "oserror", times=1),
                          mod.FaultSpec("mmap", "latency", times=1,
                                        delay_s=0.01)])
    with mod.fault_plan(plan):
        info = cache.query(gv, "info", **kw)
        csr = cache.query(gv, "csr", **kw)
        extra = []
        if v:
            extra = [ts.host(cache.query(gv, "neighbors", vertex=v - 1,
                                         **kw)).tolist(),
                     cache.query(gv, "degree", vertex=0, **kw)]
    return ((info.num_vertices, info.num_edges), csr.num_vertices,
            ts.host(csr.offsets).astype(np.int64).tolist(),
            len(ts.host(csr.targets)), extra, plan.injected(),
            cache.stats()["faults"]["open_retries"])


@pytest.mark.parametrize("v", [0, 5])
def test_degenerate_graphs_serve_under_faults(tmp_path, v):
    el = str(tmp_path / f"z{v}.el")
    repro_torch.core.write_edgelist(el, np.array([], np.int64),
                                    np.array([], np.int64), None, base=1)
    gv = str(tmp_path / f"z{v}.gvel")
    e = repro_torch.load_edgelist(el, num_vertices=v, device="cpu")
    repro_torch.core.save_snapshot(gv, edgelist=e,
                                   csr=repro_torch.core.convert_to_csr(e),
                                   compress="zlib", frame_beta=64)
    got = _degenerate_run(faults, SourceCache(), gv, v, {"device": "cpu"})
    want = _degenerate_run(jfaults, JCache(), gv, v, {})
    assert got == want
    assert got[0] == (v, 0) and got[2] == [0] * (v + 1)
    assert got[5]["open:oserror"] == 1 and got[6] == 1


def test_zero_edge_streaming_matches_reference(tmp_path):
    el = str(tmp_path / "z.el")
    repro_torch.core.write_edgelist(el, np.array([], np.int64),
                                    np.array([], np.int64), None, base=1)
    ref, got = _pair_csr(el, 6)
    assert ts.same_csr(got, ref) and len(got.targets) == 0


# ---- structured errors -------------------------------------------------------


def test_shard_load_error_carries_log():
    err = ShardLoadError("shard 2 failed", shard=2,
                         fault_log=["attempt 1: OSError: x"])
    assert err.shard == 2 and err.fault_log == ["attempt 1: OSError: x"]
    assert isinstance(err, RuntimeError)
    assert faults.SHARD_RETRIES == jfaults.SHARD_RETRIES


def test_stats_faults_block_shape(tmp_path):
    gv, _ = _snapshot(tmp_path)
    got, want = SourceCache(), JCache()
    got.query(gv, "info", device="cpu")
    want.query(gv, "info")
    assert got.stats() == want.stats()
    assert got.stats()["faults"]["injected"] == {}


def test_handle_plan_covers_every_product(tmp_path):
    """``open_graph(faults=)``: the edgelist, csr, stream, save and the
    snapshot point reads all run under the handle's plan."""
    path, v = _graph_file(tmp_path)
    plan = FaultPlan([FaultSpec("block", "oserror", index=0, times=-1)])
    g = open_graph(path, num_vertices=v, device="cpu", faults=plan)
    for product in (g.edgelist, g.csr, g.stream,
                    lambda: g.save(str(tmp_path / "o.gvel"))):
        with pytest.raises(OSError, match="injected"):
            product()
    assert faults.active_plan() is None          # restored after each
    gv, _ = _snapshot(tmp_path)
    plan = FaultPlan([FaultSpec("frame", "bitflip", index=0, times=-1)])
    s = open_graph(gv, device="cpu", faults=plan)
    for read in (lambda: s.neighbors(0), lambda: s.degree(0),
                 lambda: s.csr(rows=(0, 2))):
        with pytest.raises(SnapshotError):
            read()
    assert open_graph(gv, device="cpu").degree(0) >= 0


def test_chaos_twin_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    env.pop("REPRO_FAULTS", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.scripts.chaos_matrix",
         "--device", "cpu", "--seed", "3"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert [ln.split("]")[0] for ln in lines[:4]] == [
        "chaos[transient-retry", "chaos[stuck-reader",
        "chaos[quarantine-swap", "chaos[sigterm-resume"]
    assert lines[-1] == "chaos matrix: 4 scenario(s) green (seed=3)"


def test_chaos_twin_runs_shard_reexec_in_a_cpu_world():
    """The twin's ``shard-reexec``: two gloo ranks, shard 0 re-executed once
    and bitwise equal to the clean load, then a shard that never recovers
    raising ``ShardLoadError`` on both ranks."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    env.pop("REPRO_FAULTS", None)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.scripts.chaos_matrix",
         "--device", "cpu", "--seed", "3", "--scenario", "shard-reexec"],
        env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[0].startswith("chaos[shard-reexec]: d=2, 1 shard "
                               "re-execution bitwise equal")
    assert lines[-1] == "chaos matrix: 1 scenario(s) green (seed=3)"
