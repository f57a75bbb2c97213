"""One rank of a real gloo world for ``tests/test_torch_dryrun.py``: the
same cells the test's fake world runs, on real tensors; not collected by
pytest, imports no jax.

    RANK=k WORLD_SIZE=n REPRO_WORLD_INIT=... \\
        python tests/torch_dryrun_world.py SPEC.json OUTDIR

(``repro_torch.scripts.local_world.spawn`` sets the environment.)  The
spec names the mesh's shape (``("data", "model")``) and the cells (the
keywords of :func:`cell_of`); each cell's step runs once on this rank's
arguments (``dryrun.materialize`` with a seed) under
``launch.counters.Recorder``, and the rank writes
``OUTDIR/rank{rank}.json``: per cell ``dryrun.counts_of``, the memory
entry and the bytes of its state and batch summed leaf by leaf, or the
error.
"""
import json
import os
import sys
import traceback

import torch

from repro_torch import configs
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import ShapeCase
from repro_torch.scripts import local_world


def cell_of(arch, seq, batch, kind="train", **cell):
    """``(cfg, shape, build_cell keywords)`` of one small cell of a
    reduced arch."""
    return (configs.reduced_config(arch), ShapeCase("small", seq, batch, kind),
            cell)


def leaf_bytes(args) -> int:
    """The bytes of the step's arguments, leaf by leaf: the model's
    parameters, the moments (their local pieces), the step and the
    batch."""
    def nbytes(t):
        t = t.to_local() if hasattr(t, "to_local") else t
        return t.numel() * t.element_size()
    state, batch = args[0], args[-1]
    total = sum(nbytes(t) for t in batch.values())
    if hasattr(state, "params"):
        total += nbytes(state.step)
        total += sum(nbytes(t) for t in list(state.mu.values())
                     + list(state.nu.values()))
        state = state.params
    return total + sum(nbytes(p) for p in state.parameters())


def main(spec_path, out_dir):
    with open(spec_path) as f:
        spec = json.load(f)
    torch.manual_seed(0)
    torch.set_num_threads(1)        # the ranks share the host's cores
    mesh, rank, _ = local_world.join("gloo", "cpu", spec["mesh"],
                                     ("data", "model"))
    got = {}
    try:
        for name, kw in spec["cells"].items():
            try:
                cfg, shape, cell = cell_of(**kw)
                fn, args, _ = dryrun.build_cell(cfg, shape, mesh, **cell)
                args = dryrun.materialize(args, "cpu", seed=rank)
                nbytes = leaf_bytes(args)
                out, rec, _ = dryrun.measure(fn, args)
                got[name] = {**dryrun.counts_of(rec),
                             "memory": dryrun.memory_of(args, out, rec),
                             "leaf_bytes": nbytes}
            except Exception:           # reported per cell to the test
                got[name] = {"error": traceback.format_exc()}
    finally:
        local_world.leave()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(got, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
