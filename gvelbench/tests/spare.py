"""Cells whose data files the benchmark holds but ``BENCHMARK.json`` does
not run yet: the tests run their mixes and configurations through the
harness as if it did."""
import copy

from gvelbench import harness

CONFIGS = [{"name": "gap-urand-s22-w",
            "file": "gvelbench/configs/gap-urand-s22-w.json"},
           {"name": "gap-urand-s22-wsym",
            "file": "gvelbench/configs/gap-urand-s22-wsym.json"}]
WORKLOADS = [
    {"name": "gap-urand-s22-w.csr", "config": "gap-urand-s22-w",
     "traffic": "csr", "chips": 1},
    {"name": "gap-urand-s22-wsym.csr", "config": "gap-urand-s22-wsym",
     "traffic": "csr", "chips": 1},
    {"name": "gap-urand-s22-wsym.edgelist", "config": "gap-urand-s22-wsym",
     "traffic": "edgelist", "chips": 1},
    {"name": "graph500-s22.edgelist", "config": "graph500-s22",
     "traffic": "edgelist", "chips": 1},
]


def bench():
    """``BENCHMARK.json`` with the spare cells added."""
    b = copy.deepcopy(harness.benchmark())
    names = {c["name"] for c in b["configs"]}
    b["configs"] += [c for c in CONFIGS if c["name"] not in names]
    cells = {w["name"] for w in b["workloads"]}
    b["workloads"] += [w for w in WORKLOADS if w["name"] not in cells]
    return b
