"""A traced run of each one-card cell at scale 14 on the card: the
launch check, the trace's readers and the comparison, end to end."""
import time

import pytest

from gvelbench import harness

ONE_CARD = [w["name"] for w in harness.benchmark()["workloads"]
            if w["chips"] == 1]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available() or \
            torch.cuda.get_device_capability() < (9, 0):
        pytest.skip("needs a CUDA device of capability >= 9.0")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ONE_CARD)
def test_traced_run_on_the_card(card, cell):
    r, found = harness.run(cell, 2**32 + 3, 1.0, True, t0=time.monotonic(),
                           cfg_override={"scale": 14}, say=lambda m: None)
    assert found == [] and r["correct"], r["checks"]
    assert r["device"]["busy_s"] > 0
    assert r["metrics"]["parse_device_ms"]["value"] > 0
    assert 0 < r["metrics"]["parse_roofline"]["value"] <= 100
