"""The load path's spans and counters (``repro_torch.core.tracing``) on the
CPU at scale 10: what a load records under ``torch.profiler`` and that it
records nothing, and enters no profiler range, without one; that its spans
become profiler ranges only when ``tracing.MIRROR`` asks.

The one card test (marked ``cuda``) adds the copies, the pinned arena and
its fences.  The module imports no jax.
"""
import collections
import os
import sys
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import repro_torch
from repro_torch.core import blocks, faults, generate, loader, tracing
from repro_torch.core.blocks import flat_len, plan_blocks
from repro_torch.kernels import _lib

BETA, BATCH = 2048, 2          # 64 blocks of a 129 KB file: 32 batches
GEOMETRY = {"beta": BETA, "batch_blocks": BATCH}
PATH_SPANS = {"gvel.open", "gvel.setup", "gvel.batch", "gvel.wait",
              "gvel.h2d", "gvel.parse", "gvel.stage", "gvel.sync",
              "gvel.complete"}
IN_A_BATCH = {"gvel.wait", "gvel.h2d", "gvel.parse"}
CSR_SPANS = PATH_SPANS | {"gvel.csr", "gvel.build"}
EDGELIST_SPANS = PATH_SPANS | {"gvel.edgelist"}


@pytest.fixture(scope="module")
def graph(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tracing") / "g.el")
    generate.make_graph_file(path, "rmat", scale=10, edge_factor=16)
    return path


@pytest.fixture(autouse=True)
def _clean():
    """No record, plan or counter leaks across tests."""
    tracing.take()
    faults.set_fault_plan(None)
    faults.reset_counters()
    yield
    tracing.take()
    faults.set_fault_plan(None)
    faults.reset_counters()


def _load(path, product, device="cpu", **kw):
    g = repro_torch.open_graph(path, device=device, **GEOMETRY, **kw)
    return g.csr() if product == "csr" else g.edgelist()


def _profiled(path, product="csr", device="cpu", **kw):
    """One load under the profiler, inside a host range as the benchmark
    takes it: ``(product, record, profiler)``."""
    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function("gvelbench.load.0"):
            out = _load(path, product, device, **kw)
            if device != "cpu":
                torch.cuda.synchronize()
    recs = tracing.take()
    assert len(recs) == 1
    return out, recs[0], prof


def _by_name(rec):
    out = collections.defaultdict(list)
    for s in rec["spans"]:
        out[s["name"]].append(s)
    return out


def _batches(path):
    plan = plan_blocks(os.path.getsize(path), beta=BETA, overlap=64)
    return plan, -(-plan.num_blocks // BATCH)


def _refuse_ranges(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a profiler range was opened")
    monkeypatch.setattr(tracing, "_record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)


def test_no_profiler_records_nothing_and_enters_no_range(graph, monkeypatch):
    monkeypatch.setattr(tracing, "MIRROR", True)
    _refuse_ranges(monkeypatch)
    for product in ("csr", "edgelist"):
        _load(graph, product)
    assert tracing.take() == []
    assert tracing._requests == 0 and tracing.here() is None
    # not recording, a span is one shared no-op and a count keeps nothing
    assert tracing.span("gvel.a") is tracing.span("gvel.b")
    tracing.count("batches", 5)
    assert tracing.take() == []


@pytest.mark.parametrize("product", ["csr", "edgelist"])
def test_a_load_records_its_path_under_one_id(graph, product):
    _, rec, _ = _profiled(graph, product)
    spans = _by_name(rec)
    want = CSR_SPANS if product == "csr" else EDGELIST_SPANS
    assert set(spans) == want
    root = spans[f"gvel.{product}"][0]
    assert root["parent"] == 0 and spans["gvel.open"][0]["parent"] == 0
    assert len(spans["gvel.open"]) == 1 and len(spans[f"gvel.{product}"]) == 1
    # the batch loop's steps sit in their batch, every other span directly
    # under the product's root
    batches = {s["span"]: s for s in spans["gvel.batch"]}
    for name in want - {"gvel.open", f"gvel.{product}"}:
        outer = batches if name in IN_A_BATCH else {root["span"]: root}
        for s in spans[name]:
            assert s["parent"] in outer, name
            o = outer[s["parent"]]
            assert o["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= o["end_ns"], name
    assert all(s["parent"] == root["span"] for s in spans["gvel.batch"])
    assert spans["gvel.open"][0]["end_ns"] <= root["start_ns"]
    assert len(spans["gvel.setup"]) == 2         # the file, the pipeline
    assert len(spans["gvel.sync"]) == 2          # the edge, vertex counts
    assert len({s["span"] for s in rec["spans"]}) == len(rec["spans"])
    assert isinstance(rec["id"], int)


@pytest.mark.parametrize("product", ["csr", "edgelist"])
def test_spans_are_no_profiler_ranges_unless_mirrored(graph, product,
                                                      monkeypatch):
    """By default a recorded load opens no range of the profiler's own, so
    the ids the profiler gives its ranges are those of an untraced port."""
    if not os.environ.get("REPRO_TRACE_RANGES"):
        assert tracing.MIRROR is False
    monkeypatch.setattr(tracing, "MIRROR", False)
    _refuse_ranges(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _load(graph, product)
    (rec,) = tracing.take()
    want = CSR_SPANS if product == "csr" else EDGELIST_SPANS
    assert set(_by_name(rec)) == want
    assert not [e.name() for e in prof.profiler.kineto_results.events()
                if e.name().startswith("gvel.")]


def test_stage_runs_on_the_prefetch_thread(graph):
    _, rec, _ = _profiled(graph)
    spans = _by_name(rec)
    stage = {s["thread"] for s in spans["gvel.stage"]}
    wait = {s["thread"] for s in spans["gvel.wait"]}
    assert len(stage) == 1 and len(wait) == 1 and stage != wait
    assert wait == {s["thread"] for s in spans["gvel.csr"]}


def test_one_stage_and_one_wait_a_batch(graph):
    _, num_batches = _batches(graph)
    _, rec, _ = _profiled(graph)
    spans = _by_name(rec)
    assert rec["counters"]["batches"] == num_batches == 32
    for name in ("gvel.stage", "gvel.batch", "gvel.wait", "gvel.h2d",
                 "gvel.parse"):
        assert len(spans[name]) == num_batches, name


def test_bytes_staged_and_the_pinned_arena(graph, monkeypatch):
    class Pinned(blocks.StagingArena):
        """The card's pinned arena, held in pageable memory here."""

        def __init__(self, nbytes, slots=2, pin=False):
            super().__init__(nbytes, slots, pin=True)

        def _alloc(self, n):
            return torch.full((n,), blocks.NEWLINE, dtype=torch.uint8)

    monkeypatch.setattr(loader, "StagingArena", Pinned)
    plan, num_batches = _batches(graph)
    staged = sum(flat_len(min(BATCH, plan.num_blocks - i * BATCH), plan)
                 for i in range(num_batches))
    for _ in range(2):                # counted once a load, every load
        _, rec, _ = _profiled(graph)
        c = rec["counters"]
        assert c["bytes_staged"] == staged
        assert c["pinned_bytes_allocated"] == 2 * flat_len(BATCH, plan)
        assert {k for k in c if not k.startswith(("launches.", "faults."))} \
            == {"batches", "bytes_staged", "pinned_bytes_allocated"}


def test_launch_and_fault_differences(graph, monkeypatch):
    parse = loader.parse_accumulate

    def counted(*a, **k):
        _lib.LAUNCHES["parse_accumulate"] += 1
        return parse(*a, **k)
    monkeypatch.setattr(loader, "parse_accumulate", counted)
    _lib.LAUNCHES["parse_accumulate"] += 7     # before the load: not its own
    plan = faults.FaultPlan([faults.FaultSpec("block", "oserror", index=3,
                                              times=2)])
    _, rec, _ = _profiled(graph, faults=plan)
    c = rec["counters"]
    assert c["launches.parse_accumulate"] == c["batches"] == 32
    assert c["faults.io_retries"] == 2
    # only what the request moved: no zero entries for idle kernels
    assert "faults.stage_timeouts" not in c and all(c.values())
    assert {k.split(".", 1)[1] for k in c if k.startswith("launches.")} \
        <= set(_lib.LAUNCHES)


def test_mirrored_spans_keep_the_profiler_clock(graph, monkeypatch):
    """Mirrored, every span of the calling thread is in the profiler's
    trace, and in each of three loads the starts of 99% of them lie within
    50 us of the trace's, all within 5 ms (the process can lose its core
    between the two clock reads)."""
    monkeypatch.setattr(tracing, "MIRROR", True)
    for _ in range(3):
        _, rec, prof = _profiled(graph)
        kineto = collections.defaultdict(list)
        for e in prof.profiler.kineto_results.events():
            if e.name().startswith("gvel."):
                kineto[e.name()].append(e.start_ns())
        caller = _by_name(rec)["gvel.csr"][0]["thread"]
        mine = collections.defaultdict(list)
        for s in rec["spans"]:
            if s["thread"] == caller:
                mine[s["name"]].append(s["start_ns"])
        assert set(kineto) == set(mine) == CSR_SPANS - {"gvel.stage"}
        lags = []
        for name, starts in mine.items():
            assert len(kineto[name]) == len(starts), name
            lags += [abs(a - b) / 1e3 for a, b in
                     zip(sorted(starts), sorted(kineto[name]))]
        lags.sort()
        assert len(lags) > 100
        assert lags[int(0.99 * len(lags))] <= 50, lags[-5:]
        assert lags[-1] <= 5000, lags[-5:]


@pytest.mark.parametrize("product", ["csr", "edgelist"])
def test_products_are_the_same_traced_or_not(graph, product):
    plain = _load(graph, product)
    traced, _, _ = _profiled(graph, product)
    names = (("offsets", "targets") if product == "csr"
             else ("src", "dst"))
    for n in names:
        assert torch.equal(getattr(plain, n), getattr(traced, n)), n
    assert plain.num_vertices == traced.num_vertices


def test_a_load_that_raises_leaves_no_open_span(graph, tmp_path):
    bad = tmp_path / "long.el"
    lines = [f"{i} {i + 1}" for i in range(1, 600)]
    lines[300] = "1 " + "9" * 200                 # crosses a block start
    bad.write_text("\n".join(lines) + "\n")
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="overlap"):
            repro_torch.open_graph(str(bad), device="cpu", beta=256,
                                   batch_blocks=2).csr()
    assert tracing.here() is None and tracing._requests == 0
    (rec,) = tracing.take()
    spans = _by_name(rec)
    assert len(spans["gvel.csr"]) == 1             # closed by the error
    assert spans["gvel.wait"][-1]["end_ns"] <= spans["gvel.csr"][0]["end_ns"]
    _, clean, _ = _profiled(graph)
    assert clean["id"] != rec["id"]
    assert set(_by_name(clean)) == CSR_SPANS
    assert len(_by_name(clean)["gvel.csr"]) == 1


def test_take_keeps_the_last_64_loads(graph):
    with profile(activities=[ProfilerActivity.CPU]):
        ids = [repro_torch.open_graph(graph, device="cpu")._trace.id
               for _ in range(tracing.KEEP + 6)]
    recs = tracing.take()
    assert [r["id"] for r in recs] == ids[-tracing.KEEP:]
    assert all([s["name"] for s in r["spans"]] == ["gvel.open"]
               for r in recs)
    assert tracing.take() == []


def test_a_handle_shares_its_id_with_later_products(graph):
    with profile(activities=[ProfilerActivity.CPU]):
        g = repro_torch.open_graph(graph, device="cpu", **GEOMETRY)
        g.edgelist()
        g.csr()
        g.csr()                                    # memoized: not recorded
    (rec,) = tracing.take()
    roots = [s["name"] for s in rec["spans"] if s["parent"] == 0]
    assert sorted(roots) == ["gvel.csr", "gvel.edgelist", "gvel.open"]
    assert len(_by_name(rec)["gvel.build"]) == 1


def test_threads_record_into_one_load_without_losing_any():
    """More threads than cores, switching often, spans and counts into one
    load while it is taken from."""
    workers, each = 3 * (os.cpu_count() or 4), 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            load = tracing.begin()
            with tracing.request(load, "gvel.open"):
                pass                        # kept now: take() drains it
            with tracing.request(load, "gvel.csr"):
                at = tracing.here()

                def work():
                    for _ in range(each):
                        with tracing.span("gvel.stage", at):
                            tracing.count("bytes_staged", 3)
                            with tracing.span("gvel.stage.fence"):
                                pass
                threads = [threading.Thread(target=work)
                           for _ in range(workers)]
                for t in threads:
                    t.start()
                taken = [tracing.take() for _ in range(20)]
                for t in threads:
                    t.join(timeout=60)
                assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    recs = [r for batch in taken for r in batch] + tracing.take()
    spans = collections.Counter(s["name"] for r in recs for s in r["spans"])
    staged = sum(r["counters"].get("bytes_staged", 0) for r in recs)
    assert {r["id"] for r in recs} == {load.id}
    assert spans == {"gvel.stage": workers * each,
                     "gvel.stage.fence": workers * each, "gvel.open": 1,
                     "gvel.csr": 1}
    assert sum(map(len, taken)) >= 1
    assert staged == 3 * workers * each


@pytest.mark.cuda
def test_card_load_counts_staging_and_launches(graph):
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("needs a CUDA device of capability >= 9.0")
    plan, num_batches = _batches(graph)
    plain = _load(graph, "csr", device="cuda")
    traced, rec, prof = _profiled(graph, device="cuda")
    assert torch.equal(plain.offsets, traced.offsets)
    assert torch.equal(plain.targets, traced.targets)
    c = rec["counters"]
    span = flat_len(BATCH, plan)
    assert c["pinned_bytes_allocated"] == 2 * span
    assert c["launches.parse_accumulate"] == c["batches"] == num_batches
    assert c["launches.exclusive_scan"] == c["launches.degree_histogram"] == 1
    spans = _by_name(rec)
    fences = spans["gvel.stage.fence"]
    assert len(fences) == num_batches - 2          # every slot reuse
    stages = {s["span"] for s in spans["gvel.stage"]}
    assert {s["parent"] for s in fences} <= stages
    assert set(spans) == CSR_SPANS | {"gvel.stage.fence"}
