"""The sharded cell's four-rank runner at scale 10 on the CPU, over gloo:
a run is correct; the control is not, nor is a run with the timed path
broken underneath (a load a cache answers, half the batches left out, the
exchange left out or one bucket of it, an edge altered); and a rank that
exits early stops the run at once."""
import signal
import time

import pytest

from gvelbench import control, harness, ranks
from gvelbench.tests import patches

CELL = "graph500-s22-d4.csr-sharded"
SMALL = {"scale": 10, "geometry": patches.SMALL_GEOMETRY}


@pytest.fixture(autouse=True)
def put_back():
    yield
    patches.undo()


def run(fault="sharded_cpu"):
    result, found = harness.run(CELL, 2**31 + 19, 0.5, False,
                                t0=time.monotonic(), device="cpu",
                                cfg_override=SMALL,
                                patch=f"gvelbench.tests.patches:{fault}",
                                say=lambda m: None)
    assert found == []
    return result


def test_a_sharded_run_is_correct():
    r = run()
    assert r["correct"], r["checks"]
    assert list(r["checks"]) == ["vertices_off", "offsets_wrong",
                                 "targets_wrong", "loads_off_launches"]
    assert r["failed"] == 0 and r["attempted"] >= 2
    assert set(r["metrics"]) == {"peak_device_gib", "setup_s"}
    assert r["device"]["count"] == 4


def test_the_sharded_control_is_not_correct():
    row = control.run_control(CELL, 23, cfg_override=SMALL)
    assert not row["correct"], row
    assert row["checks"]["targets_wrong"] > 0


@pytest.mark.parametrize("fault", ["sharded_cached", "sharded_half_batches",
                                   "no_exchange", "dropped_bucket",
                                   "sharded_altered"])
def test_a_broken_load_is_not_correct(fault):
    r = run(fault)
    assert not r["correct"], (fault, r["checks"])


def test_a_rank_that_exits_stops_the_run(monkeypatch):
    monkeypatch.setattr(ranks, "SPARE_S", 30.0)
    worlds = []
    stop = ranks.Ranks.stop

    def kept(self):
        worlds.append(self)
        stop(self)
    monkeypatch.setattr(ranks.Ranks, "stop", kept)

    def too_long(*_):
        raise TimeoutError("the run outlived the test's 60 s")
    before = signal.signal(signal.SIGALRM, too_long)
    signal.alarm(60)
    t0 = time.monotonic()
    try:
        with pytest.raises(harness.BenchError, match="rank 2 of 4 exited"):
            run("rank_exits")
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, before)
    assert time.monotonic() - t0 < 30
    assert worlds and all(p.poll() is not None for p in worlds[0].procs)
