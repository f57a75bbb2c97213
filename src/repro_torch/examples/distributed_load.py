"""Distributed graph loading across a device mesh (GVEL staged at
scale); the twin of the reference's ``examples/distributed_load.py``.

One process a rank, in a ``torchrun`` world or one this script spawns:

  PYTHONPATH=src torchrun --nproc-per-node 8 -m repro_torch.examples.distributed_load
  PYTHONPATH=src python -m repro_torch.examples.distributed_load --world 2 \\
      [--backend gloo] [--device cpu]

Without a world in the environment and with ``--world 1`` (the default)
the process is a world of one.  Each rank streams its byte span of the
file and the packed edges reach their owners in one ``all_to_all``
(``GraphSource.csr_sharded``); rank 0 prints what the reference prints.
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

SRC = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _join(backend: str, device: str):
    """This process's rank of the world in the environment (``torchrun``'s
    or ``local_world.spawn``'s), or a world of one: ``(mesh, rank, world,
    own_store_dir)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..scripts import local_world
    if local_world.INIT_ENV in os.environ:
        mesh, rank, world = local_world.join(backend, device)
        return mesh, rank, world, None
    if "RANK" in os.environ:                      # torchrun
        dist.init_process_group(backend)
        world = dist.get_world_size()
        mesh = init_device_mesh(device, (world,), mesh_dim_names=("data",))
        return mesh, dist.get_rank(), world, None
    store = tempfile.mkdtemp()
    dist.init_process_group(backend, init_method=f"file://{store}/rdv",
                            rank=0, world_size=1)
    return (init_device_mesh(device, (1,), mesh_dim_names=("data",)), 0, 1,
            store)


def rank_main(backend: str, device: str, graph=None) -> dict:
    """One rank: the sharded load of the graph (``graph``'s ``(path, v,
    e)``, or made by rank 0 and announced), the reference's prints on rank
    0; returns this rank's ``{"rank", "world", "csr"}`` (on the host)."""
    import torch
    import torch.distributed as dist

    from ..core import make_graph_file, open_graph
    from ..core.env import resolve_device
    from ..scripts import local_world

    resolve_device(device)
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", 0)))
        torch.cuda.set_device(local % torch.cuda.device_count())
    mesh, rank, n, store = _join(backend, device)
    tmp = None
    try:
        if rank == 0:
            print(f"devices: {n}")
        if graph is None:
            tmp = tempfile.mkdtemp() if rank == 0 else None
            made = [None]
            if rank == 0:
                path = os.path.join(tmp, "g.el")
                made = [(path,) + tuple(make_graph_file(
                    path, "rmat", scale=12, edge_factor=8))]
            dist.broadcast_object_list(made, src=0)
            graph = made[0]
        path, v, e = graph
        if rank == 0:
            print(f"graph: |V|={v:,} |E|={e:,}")

        # each rank parses its byte range, the partial degrees are summed,
        # the packed edges reach their owners in one all_to_all, and each
        # rank builds its rows' CSR (contention-free)
        dev = torch.device(device, torch.cuda.current_device()) \
            if device == "cuda" else torch.device(device)
        csr = open_graph(path, num_vertices=v, device=dev).csr_sharded(mesh)
        mine = csr.offsets[-1:].to(torch.int64)
        counts = [torch.empty_like(mine) for _ in range(n)]
        dist.all_gather(counts, mine)
        counts = [int(c) for c in counts]
        rows_per = csr.num_rows
        if rank == 0:
            print(f"vertex-partitioned CSR: {n} shards x {rows_per} rows; "
                  f"total edges={sum(counts):,}")
        assert sum(counts) == e
        if rank == 0:
            for k in range(min(n, 4)):
                print(f"  shard {k}: owns vertices [{k*rows_per}, "
                      f"{(k+1)*rows_per}) with {counts[k]:,} edges")
            print("OK")
        dist.barrier()
        return {"rank": rank, "world": n, "csr": csr.numpy()}
    finally:
        local_world.leave()
        for d in (tmp, store):
            if d:
                shutil.rmtree(d, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    p.add_argument("--backend", default=None,
                   help="nccl (the default on cuda) or gloo (on cpu; two "
                   "ranks sharing one card need it too)")
    p.add_argument("--world", type=int, default=1,
                   help="ranks to spawn when no world is in the "
                   "environment")
    args = p.parse_args(argv)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    from ..scripts import local_world
    in_world = local_world.INIT_ENV in os.environ or "RANK" in os.environ
    if in_world or args.world == 1:
        rank_main(backend, args.device)
        return 0
    return spawn_world(args.world, backend, args.device)


def spawn_world(world: int, backend: str, device: str, *,
                timeout: float = 600) -> int:
    """Run the example as a world of ``world`` processes on this host
    (``local_world.spawn``), each rank's output passed on; the largest
    exit code."""
    from ..scripts import local_world
    argv = [sys.executable, "-m", __spec__.name, "--device", device,
            "--backend", backend]
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=SRC if not path
               else os.pathsep.join([SRC, path]))
    runs = local_world.spawn(argv, world, timeout=timeout, env=env)
    for k, run in enumerate(runs):
        sys.stdout.write(run.stdout)
        if run.returncode:
            sys.stderr.write(f"rank {k} exited {run.returncode}:\n"
                             f"{run.stderr[-4000:]}")
    return max(run.returncode for run in runs)


if __name__ == "__main__":
    raise SystemExit(main())
