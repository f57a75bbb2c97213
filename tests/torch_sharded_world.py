"""One rank of the port's sharded-load matrix on the CPU (gloo), for
``tests/test_torch_sharded.py``; not collected by pytest, imports no jax.

    RANK=k WORLD_SIZE=4 REPRO_WORLD_INIT=... \\
        python tests/torch_sharded_world.py SPEC.json OUTDIR

(``repro_torch.scripts.local_world.spawn`` sets the environment.)  Each case
of the spec runs on every rank; a load writes the rank's rows to
``OUTDIR/{case}_{rank}.npz``, and every case's error, if any, goes into
``OUTDIR/rank{rank}.json`` with the fault counters and the memo checks.
"""
import json
import os
import sys

import numpy as np

from repro_torch.core import (FaultPlan, FaultSpec, distributed, faults,
                              host_shard_and_load, open_graph)
from repro_torch.core.loader import LoadOptions, read_csr_sharded_via
from repro_torch.scripts import local_world


def run_case(case, mesh, rank):
    kind, path = case["kind"], case["path"]
    kw = dict(case.get("open", {}))
    if "rank_beta" in case:              # ranks that pinned other geometry
        kw["beta"] = case["rank_beta"][rank]
    if kind == "open":
        return open_graph(path, device="cpu", **kw).csr_sharded(
            mesh, **case.get("call", {}))
    if kind == "faulty":
        plan = FaultPlan([FaultSpec(**f) for f in case["faults"]], seed=7)
        return open_graph(path, device="cpu", faults=plan, **kw).csr_sharded(
            mesh)
    if kind == "stream":
        return distributed.load_csr_sharded_stream(mesh, "data", path, **kw)
    if kind == "host_shard":
        return host_shard_and_load(mesh, "data", path, **kw)
    if kind == "via":
        return read_csr_sharded_via(path, LoadOptions(**kw), mesh=mesh,
                                    **case.get("call", {}))
    raise ValueError(f"unknown case kind {kind!r}")


def main(spec_path, out_dir):
    with open(spec_path) as f:
        cases = json.load(f)
    mesh, rank, _world = local_world.join("gloo", "cpu")
    report = {"errors": {}, "counters": {}}
    try:
        for case in cases:
            name = case["name"]
            faults.reset_counters()
            try:
                csr = run_case(case, mesh, rank)
            except (ValueError, RuntimeError) as exc:
                report["errors"][name] = [type(exc).__name__, str(exc)]
                continue
            report["counters"][name] = faults.counters()
            arrays = {"offsets": csr.offsets.numpy(),
                      "targets": csr.targets.numpy(),
                      "meta": np.array([csr.num_vertices, csr.row_start])}
            if csr.weights is not None:
                arrays["weights"] = csr.weights.numpy()
            np.savez(os.path.join(out_dir, f"{name}_{rank}.npz"), **arrays)
        src = open_graph(cases[0]["path"], device="cpu",
                         **cases[0].get("open", {}))
        first = src.csr_sharded(mesh)
        report["memo"] = [src.csr_sharded(mesh) is first,
                          src.csr_sharded(mesh, rho=8) is not first]
    finally:
        local_world.leave()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
