"""BENCHMARK.json against the rules it must keep: its keys, names,
units and limits, and a file under the benchmark for every configuration,
traffic mix and per-layer metric it names."""
import json
import re

import pytest

from gvelbench import harness

BENCH = harness.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
METRIC_KEYS = {"name", "unit", "better", "source"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and \
        isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["gvelbench"]
    assert all(PATH.fullmatch(p) for p in BENCH["paths"])
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert not any(w.startswith("/") or ".." in w for w in cmd)


def test_names_and_units():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and line(c["source"]) and \
            line(c["why"])
        assert c["file"].startswith("gvelbench/")
        assert len(c["reduced"]) <= 16 and \
            all(NAME.fullmatch(k) for k in c["reduced"])
        names.append(c["name"])
    assert len(set(names)) == len(names)
    cells = []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.fullmatch(w[k]) for k in ("name", "config",
                                                  "traffic"))
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line(w["why"])
        cells.append(w["name"])
    assert len(set(cells)) == len(cells)
    assert len({(w["config"], w["traffic"])
                for w in BENCH["workloads"]}) == len(cells)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= \
        max(1, len(cells) // 4)
    metrics = []
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m["workloads"]) <= set(cells) if "workloads" in m \
            else True
        metrics.append(m["name"])
    assert len(set(metrics)) == len(metrics)


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(e2e) == {"peak_device_gib", "setup_s"}
    for m in e2e.values():
        assert set(m) - {"workloads"} == METRIC_KEYS | {"bound"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] <= 0.25


def test_per_layer_metrics():
    layers = {}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == METRIC_KEYS | {"layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] == "peak_device_gib"
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        layers.setdefault(m["layer"], []).append(m["name"])
    assert set(layers) == {"front door", "host staging and H2D", "parse",
                           "build", "bucketing", "exchange", "device"}


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(cfg):
    data = harness.read_json(harness.ROOT / cfg["file"])
    assert data["name"] == cfg["name"]
    assert sorted(data["reduced"]) == sorted(cfg["reduced"])
    assert data["assumed"]


def test_every_cell_and_metric_has_its_file():
    for w in BENCH["workloads"]:
        cell, cfg, traffic = harness.cell_parts(BENCH, w["name"])
        assert w["chips"] == traffic.get("ranks", 1)
        assert traffic["product"] in ("csr", "edgelist", "csr_sharded")
    for m in BENCH["per_layer"]:
        assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
    for w in BENCH["workloads"]:
        assert [m for m in BENCH["per_layer"] if harness.applies(m, w["name"])]
