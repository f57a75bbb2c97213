"""The readers of the port's own spans and counters, over made-up loads
that carry a ``program`` record, and the join of the port's records to the
profiled loads (``gvelbench/program.py``)."""
import os
import sys

import numpy as np
import pytest

from gvelbench import graphs, harness, program, trace
from gvelbench.tests.test_gvelbench_metrics import data, load

NEW = ("open_ms", "dispatch_ms", "stage_ms", "stage_wait_ms",
       "stage_gb_per_s", "finish_ms", "idle_stage_wait_pct")
OLD = ("window_edges_per_s", "load_s_p75", "h2d_ms", "parse_device_ms",
       "parse_roofline", "build_device_ms", "build_roofline",
       "load_kernel_ms", "device_idle_pct")

# us from the load's start: (name, start, end, thread)
SPANS = [("gvel.open", 1, 3, 1), ("gvel.csr", 4, 95, 1),
         ("gvel.setup", 4, 6, 1), ("gvel.setup", 6, 7, 1),
         ("gvel.stage", 5, 9, 2), ("gvel.stage", 26, 34, 2),
         ("gvel.stage.fence", 27, 29, 2),
         ("gvel.batch", 10, 30, 1), ("gvel.wait", 10, 25, 1),
         ("gvel.h2d", 26, 28, 1), ("gvel.parse", 28, 30, 1),
         ("gvel.batch", 35, 52, 1), ("gvel.wait", 35, 50, 1),
         ("gvel.h2d", 50, 51, 1), ("gvel.parse", 51, 52, 1),
         ("gvel.sync", 52, 54, 1), ("gvel.build", 54, 60, 1),
         ("gvel.complete", 60, 90, 1)]


def record(offset, rid=1, staged=1000):
    """The port's record of a load that starts at ``offset`` us."""
    spans = [{"name": n, "start_ns": (s + offset) * 1000,
              "end_ns": (e + offset) * 1000, "thread": t,
              "parent": 0 if n in ("gvel.open", "gvel.csr") else 2,
              "span": i + 1} for i, (n, s, e, t) in enumerate(SPANS)]
    return {"id": rid, "spans": spans,
            "counters": {"bytes_staged": staged, "batches": 2}}


def with_program(offset, lost=0):
    ld = load(offset, lost)
    ld["program"] = record(offset)
    return ld


@pytest.fixture
def traced():
    return data([with_program(0), with_program(1000)])


@pytest.mark.parametrize("name,value", [
    ("open_ms", (2 + 2 + 1) / 1e3),
    ("dispatch_ms", (20 + 17 - 15 - 15) / 1e3),
    ("stage_ms", (4 + 8) / 1e3),
    ("stage_wait_ms", (15 + 15) / 1e3),
    ("stage_gb_per_s", 1000 / ((12 - 2) * 1e3)),
    ("finish_ms", (2 + 6 + 30) / 1e3),
])
def test_program_readers(traced, name, value):
    assert traced.value(name) == pytest.approx(value)


def test_idle_stage_wait_pct_joins_the_two_clocks(traced):
    # records: 0-15, 20-26, 30-31, 40-42 of a 0-100 span, so the card idles
    # 15-20, 26-30, 31-40, 42-100 (76 us); the waits 10-25 and 35-50 cover
    # 15-20, 35-40 and 42-50 of it (18 us)
    ld = traced.loads[0]
    assert program.idle(ld) == [(15, 20), (26, 30), (31, 40), (42, 100)]
    assert traced.value("idle_stage_wait_pct") == pytest.approx(
        100 * 18 / 76)


def test_intersect_and_idle_edges():
    assert program.intersect([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert program.intersect([], [(0, 1)]) == 0
    ld = {"span": (0, 10), "records": [("k", -5, 2), ("k", 8, 12)]}
    assert program.idle(ld) == [(2, 8)]
    assert program.idle({"span": (0, 10), "records": []}) == [(0, 10)]


def test_a_load_that_lost_a_record_takes_its_program_with_it():
    d = data([with_program(0, lost=1), with_program(1000)])
    assert len(d.loads) == 1 and len(program.loads(d)) == 1
    assert d.value("stage_wait_ms") == pytest.approx(0.030)
    assert d.value("open_ms") == pytest.approx(0.005)


def test_the_nine_readers_read_as_before(traced):
    before = data()
    for name in OLD:
        assert traced.value(name) == before.value(name), name
    assert harness.breakdown(traced) == harness.breakdown(before)


def test_no_program_record_reads_nothing(monkeypatch):
    monkeypatch.setattr(program, "_take", lambda: [])
    d = data()
    for name in NEW:
        assert d.value(name) is None, name
    assert all(ld["program"] is None for ld in d.loads)


def test_a_port_without_tracing_gives_no_records(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.core.tracing", None)
    assert program._take() == []


def test_attach_by_the_most_overlap():
    loads = [load(0), load(1000), load(5000)]
    program.attach(loads, [record(1000, rid=7), record(0, rid=3),
                           record(20000, rid=9),
                           record(0, rid=4, staged=5)])
    assert loads[0]["program"]["id"] == 3
    # a second record of one load adds its spans and counters
    assert loads[0]["program"]["counters"]["bytes_staged"] == 1005
    assert len(loads[0]["program"]["spans"]) == 2 * len(SPANS)
    assert loads[1]["program"]["id"] == 7
    assert loads[2]["program"] is None


def test_readers_take_the_ports_records_once(monkeypatch):
    taken = []

    def take():
        taken.append(1)
        return [record(0), record(1000)]
    monkeypatch.setattr(program, "_take", take)
    d = data()
    assert d.value("stage_ms") == pytest.approx(0.012)
    assert d.value("finish_ms") == pytest.approx(0.038)
    assert len(taken) == 1


def test_the_ports_records_of_a_cpu_load(tmp_path):
    """The readers over the port's real records: a scale-10 load under the
    CPU profiler, inside the benchmark's host range."""
    torch = pytest.importorskip("torch")
    rt = harness.import_program()
    from repro_torch.core import generate, tracing
    from torch.profiler import ProfilerActivity, profile
    path = str(tmp_path / "g.el")
    generate.make_graph_file(path, "rmat", scale=10, edge_factor=16)
    tracing.take()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for j in range(2):
            with trace.load_range(torch, j):
                rt.open_graph(path, device="cpu", beta=2048,
                              batch_blocks=2).csr()
    ids = np.arange(10, dtype=np.int32)
    result = {"profiled": trace.collect(prof), "loads_s": [],
              "window_s": None}
    d = harness.RunData(result, graphs.Graph(ids, ids, None),
                        os.path.getsize(path), "NVIDIA H100 80GB HBM3")
    assert len(d.loads) == 2
    for name in NEW:
        assert d.value(name) > 0, name
    # no card records on the CPU: the whole span idles, the waits in it
    assert 0 < d.value("idle_stage_wait_pct") < 100
    assert [ld["program"]["counters"]["batches"] for ld in d.loads] == \
        [32, 32]
    for ld in d.loads:
        lo, hi = ld["span"]
        for s in ld["program"]["spans"]:
            assert lo <= s["start_ns"] / 1e3 <= s["end_ns"] / 1e3 <= hi
