"""Each traffic mix's control flow at scale 10 on the CPU, through the
harness's whole run but the look for a card; then the same run with the
timed path broken underneath, and the control, each of which has to come
out not correct.  The spare cells (:mod:`.spare`) run too."""
import time

import pytest

from gvelbench import control, harness
from gvelbench.tests import patches, spare

# the sharded cell's runs are test_gvelbench_sharded.py's
CELLS = [w["name"] for w in spare.bench()["workloads"] if w["chips"] == 1]
SMALL = {"scale": 10}
COUNT = "gvelbench.tests.patches:count_cpu_launches"


@pytest.fixture(autouse=True)
def put_back(monkeypatch):
    extended = spare.bench()
    monkeypatch.setattr(harness, "benchmark", lambda root=None: extended)
    yield
    patches.undo()


def run(cell, patch=COUNT, seconds=0.3, trace=False):
    result, found = harness.run(cell, 2**31 + 17, seconds, trace,
                                t0=time.monotonic(), device="cpu",
                                cfg_override=SMALL, patch=patch,
                                say=lambda m: None)
    assert found == []
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_a_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks"
    assert r["failed"] == 0 and r["attempted"] >= 2
    m = r["metrics"]
    assert set(m) == {"peak_device_gib", "setup_s"}
    assert m["setup_s"]["value"] > 0
    assert r["device"]["count"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    row = control.run_control(cell, 23, cfg_override=SMALL)
    assert not row["correct"], row


FAULTS = [(cell, fault) for cell in CELLS
          for fault in ("cached", "half_batches", "altered")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_broken_load_is_not_correct(cell, fault):
    r = run(cell, patch=f"gvelbench.tests.patches:{fault}")
    assert not r["correct"], (fault, r["checks"])
