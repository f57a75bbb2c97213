"""A cell on several cards: one process a rank, started and watched by the
run's own process.

:class:`Ranks` is the parent's side.  It starts ``d`` processes of
``python -m gvelbench.ranks <spec>`` once the kernel library is built, so
that no two ranks run ``nvcc`` at once, and passes each its ``RANK`` and
``WORLD_SIZE``; the rendezvous is a ``file://`` store in the run's
temporary directory, and each rank's output goes to files there.  A rank
that exits with another code than 0, or a world that runs past
``seconds + SPARE_S``, has every rank killed and raises ``BenchError``, so
the parent never waits on a rank stuck in a collective.

A rank (:func:`main`) sets ``cuda:k``, joins the world as a :class:`World`
(a one-axis ``DeviceMesh`` over NCCL, gloo on the CPU, and a gloo group on
the host for rank 0's stop flag), waits for the graph file, and runs
``harness.run_loads``.  It writes its result as JSON and the rows it
copied as ``.npz``, with the forbidden modules it loaded.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List

import numpy as np

from . import harness

SPARE_S = 240.0          # a world's time past its window before it is killed
POLL_S = 0.05
ROWS = ("offsets", "targets", "weights")


class World:
    """This rank's place in the world: its ``mesh`` (one axis, ``axis``)
    and the host group on which rank 0's decisions reach the others."""

    def __init__(self, device_type: str, axis: str, init: str):
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        self.dist = dist
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method=f"file://{init}", rank=rank,
                                world_size=size)
        self.mesh = init_device_mesh(device_type, (size,),
                                     mesh_dim_names=(axis,))
        self.host = dist.new_group(backend="gloo")

    def barrier(self) -> None:
        self.dist.barrier(group=self.host)

    def agree(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank."""
        import torch
        t = torch.tensor([int(flag)])
        self.dist.broadcast(t, src=0, group=self.host)
        return bool(t.item())

    def close(self) -> None:
        self.dist.destroy_process_group()


class Ranks:
    """The parent's side of a world of ``d`` ranks running ``spec`` in
    ``workdir``."""

    def __init__(self, spec: Dict, d: int, workdir: str):
        self.d, self.dir = d, Path(workdir)
        self.seconds = spec["seconds"]
        self.spec = self.dir / "spec.json"
        with open(self.spec, "w") as f:
            json.dump(dict(spec, ranks=d,
                           init=str(self.dir / "rendezvous")), f)
        self.procs: List[subprocess.Popen] = []
        self.deadline = None

    def start(self) -> None:
        env = dict(os.environ, WORLD_SIZE=str(self.d))
        for k in range(self.d):
            with open(self.dir / f"rank{k}.out", "w") as out, \
                    open(self.dir / f"rank{k}.err", "w") as err:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "gvelbench.ranks",
                     str(self.spec)], cwd=harness.ROOT,
                    env=dict(env, RANK=str(k)), stdout=out, stderr=err))
        self.deadline = time.monotonic() + self.seconds + SPARE_S

    def wait(self) -> Dict:
        """Every rank's result, merged (:func:`merge`), once all have exited
        with 0."""
        while True:
            codes = [p.poll() for p in self.procs]
            bad = [k for k, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                self.stop()
                k = bad[0]
                raise harness.BenchError(
                    f"rank {k} of {self.d} exited with {codes[k]}; every "
                    f"rank was stopped.  Its last output:\n{self._tail(k)}")
            if all(c == 0 for c in codes):
                break
            if time.monotonic() > self.deadline:
                self.stop()
                raise harness.BenchError(
                    f"the {self.d} ranks ran past "
                    f"{self.seconds + SPARE_S:.0f} s; every rank was stopped")
            time.sleep(POLL_S)
        return merge([self._result(k) for k in range(self.d)])

    def stop(self) -> None:
        """Kill the ranks still running and wait until each has ended."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def _tail(self, k: int, n: int = 3000) -> str:
        return (self.dir / f"rank{k}.err").read_text()[-n:]

    def _result(self, k: int) -> Dict:
        r = harness.read_json(self.dir / f"rank{k}.json")
        arrays = np.load(self.dir / f"rank{k}.npz")
        r["checked"] = {int(i): dict(meta, **{
            key: arrays[f"{i}.{key}"] if f"{i}.{key}" in arrays else None
            for key in ROWS}) for i, meta in r["checked"].items()}
        return r


def merge(results: List[Dict]) -> Dict:
    """One result from every rank's: rank 0's loads, window and clock, the
    fullest card's peak, the checked loads' rows in rank order, the loads
    in which any rank's parse launches were off, every rank's profiled
    loads and the forbidden modules any rank loaded."""
    r = dict(results[0])
    r["peak_bytes"] = max(x["peak_bytes"] for x in results)
    r["checked"] = {i: [x["checked"][i] for x in results]
                    for i in results[0]["checked"]}
    off = set().union(*(x["off_loads"] for x in results))
    r["off_loads"], r["off_launches"] = sorted(off), len(off)
    r["expected_launches"] = [x["expected_launches"] for x in results]
    r["profiled"] = [ld for x in results for ld in x["profiled"]]
    r["forbidden"] = sorted(set().union(*(x["forbidden"] for x in results)))
    return r


def main(argv=None) -> int:
    spec = Path((sys.argv[1:] if argv is None else argv)[0])
    r = harness.run_loads(harness.read_json(spec))
    k = r["rank"]
    arrays, meta = {}, {}
    for i, rows in r["checked"].items():
        meta[i] = {"num_vertices": int(rows["num_vertices"]),
                   "row_start": int(rows["row_start"])}
        arrays.update({f"{i}.{key}": rows[key] for key in ROWS
                       if rows[key] is not None})
    r["checked"] = meta
    r["forbidden"] = harness.forbidden_modules()
    np.savez(spec.parent / f"rank{k}.npz", **arrays)
    with open(spec.parent / f"rank{k}.json.tmp", "w") as f:
        json.dump(r, f)
    os.replace(spec.parent / f"rank{k}.json.tmp",
               spec.parent / f"rank{k}.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
