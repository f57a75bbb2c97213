"""The control of ``correct``: the plain reference put in the program's
place with one guarantee of the configuration broken, judged by the
benchmark's own comparison (``harness.compare``).  It has to come out not
correct.  The benchmark's runs never run it.

    python -m gvelbench.control --workload graph500-s22.csr \\
        --seeds 11 12 13

prints one JSON line a seed with the numbers compared, and exits 1 if the
control passed on any seed.  The loads' CSRs get rows in reverse file
order (an unstable build), the edge list comes grouped by source, and the
sharded CSR's ranks 0 and 1 hold each other's rows.  No card is needed:
the control is host NumPy at the cell's own size.
"""
import argparse
import json
import sys
from typing import Dict

from . import graphs, harness, reference


def control_result(graph: graphs.Graph, traffic: Dict, cfg: Dict) -> Dict:
    """What a run would report, with the control's products of the edges
    as the product holds them."""
    src, dst, w = reference.product_edges(graph, cfg)
    v = reference.vertex_count(src, dst)
    if traffic["product"] == "edgelist":
        got = reference.control_edges(src, dst, w)
    elif traffic["product"] == "csr_sharded":
        got = reference.control_shards(src, dst, w, v, traffic["ranks"])
    else:
        got = reference.control_csr(src, dst, w, v)
    return {"off_launches": 0, "checked": {0: got}}


def run_control(name: str, seed: int, cfg_override=None) -> Dict:
    cell, cfg, traffic = harness.cell_parts(harness.benchmark(), name)
    cfg = dict(cfg, **(cfg_override or {}))
    graph = graphs.make(cfg, seed)
    checks = harness.compare(control_result(graph, traffic, cfg), graph,
                             traffic, cfg)
    return {"workload": name, "seed": seed,
            "correct": all(v == 0 for v in checks.values()),
            "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gvelbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    passed = False
    for seed in args.seeds:
        row = run_control(args.workload, seed)
        passed |= row["correct"]
        print(json.dumps(row), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
