"""A ``torch.distributed`` world of processes on one host, for the sharded
load's and the data-parallel step's checks (the chaos twin's
``shard-reexec``, the CPU parity tests and ``chip_smoke.py``'s two-rank
phases).

:func:`spawn` runs one command as ``world`` processes, passing each its
rank the way ``torchrun`` does (``RANK``, ``WORLD_SIZE``) and a rendezvous
file (``REPRO_WORLD_INIT``): a ``file://`` store needs no TCP port, so
worlds started side by side (test workers) cannot collide.  A rank calls
:func:`join` for its ``DeviceMesh`` and :func:`leave` at the end.
"""
from __future__ import annotations

import os
import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

INIT_ENV = "REPRO_WORLD_INIT"


def spawn(argv: Sequence[str], world: int, *, timeout: float,
          env: Optional[dict] = None, workdir: Optional[str] = None
          ) -> List[subprocess.CompletedProcess]:
    """Run ``argv`` as ranks ``0 .. world-1`` and wait for all of them
    (``timeout`` seconds in all; on expiry every rank is killed and
    ``TimeoutError`` raised).  The rendezvous file goes in a fresh
    directory under ``workdir`` (default: the system's temporary one)."""
    init_dir = tempfile.mkdtemp(prefix="world_", dir=workdir)
    base = dict(os.environ if env is None else env, WORLD_SIZE=str(world))
    base[INIT_ENV] = os.path.join(init_dir, "rendezvous")
    # output to files, not pipes: a rank blocked on a full pipe would stall
    # the others in their next collective
    logs = [(os.path.join(init_dir, f"rank{k}.out"),
             os.path.join(init_dir, f"rank{k}.err")) for k in range(world)]
    procs = []
    try:
        for k, (so, se) in enumerate(logs):
            with open(so, "w") as fo, open(se, "w") as fe:
                procs.append(subprocess.Popen(
                    list(argv), env=dict(base, RANK=str(k)), stdout=fo,
                    stderr=fe))
        deadline = time.monotonic() + timeout
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.01))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"a world of {world} ranks of {list(argv)} ran "
                           f"past {timeout}s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [subprocess.CompletedProcess(p.args, p.returncode, _read(so),
                                        _read(se))
            for p, (so, se) in zip(procs, logs)]


def _read(path: str) -> str:
    with open(path) as f:
        return f.read()


def join(backend: str, device_type: str, shape: Optional[Sequence[int]] = None,
         names: Sequence[str] = ("data",)):
    """This process's rank of the world :func:`spawn` started: the default
    process group (``backend``: ``"gloo"`` or ``"nccl"``) and a
    ``DeviceMesh`` of ``device_type`` over every rank, of ``shape`` (one
    axis of every rank by default) with axes ``names``.  Returns ``(mesh,
    rank, world)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group(backend, init_method=f"file://"
                            f"{os.environ[INIT_ENV]}", rank=rank,
                            world_size=world)
    mesh = init_device_mesh(device_type, tuple(shape or (world,)),
                            mesh_dim_names=tuple(names))
    return mesh, rank, world


def leave() -> None:
    """Tear the default process group down."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
