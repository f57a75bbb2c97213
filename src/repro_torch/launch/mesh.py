"""The meshes over the processes of a ``torch.distributed`` world; the
port of ``repro/launch/mesh.py``.

Single pod: ``(16, 16)``     axes ``("data", "model")``          = 256 ranks
Multi pod:  ``(2, 16, 16)``  axes ``("pod", "data", "model")``   = 512 ranks

Functions, not module constants: importing this module touches no
process group.  :func:`fake_world` starts a world of the ``fake`` backend
in this one process (every collective returns at once, its data
untouched): the dry run (``launch/dryrun.py``) builds a production mesh
over it and runs a cell's step on fake tensors as rank 0 of 256 or 512.
The reference's TPU roofline constants (``PEAK_FLOPS_BF16``, ``HBM_BW``,
``ICI_BW``) do not carry over to the card.
"""
from __future__ import annotations

import contextlib

PRODUCTION = {False: ((16, 16), ("data", "model")),
              True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The reference's production mesh as a ``DeviceMesh`` of
    ``device_type`` over the default process group, which must hold 256
    ranks (512 with ``multi_pod``)."""
    import math

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = PRODUCTION[bool(multi_pod)]
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != math.prod(shape):
        raise ValueError(f"the {'multi' if multi_pod else 'single'}-pod "
                         f"mesh {shape} needs {math.prod(shape)} ranks; the "
                         f"world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_host_mesh(model: int = 1, *, device_type: str = "cuda"):
    """A ``("data", "model")`` ``DeviceMesh`` of shape ``(world // model,
    model)`` over every rank of the default process group (initialised
    by the caller, or by ``torchrun``'s environment).  A ``"cuda"`` mesh
    raises without CUDA; ``"cpu"`` (gloo) only where the caller asks."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..core.env import resolve_device
    resolve_device(device_type)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if model < 1 or world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"world of {world} ranks")
    return init_device_mesh(device_type, (world // model, model),
                            mesh_dim_names=("data", "model"))


@contextlib.contextmanager
def fake_world(world: int, *, rank: int = 0, like: str = "gloo"):
    """A default process group of ``world`` ranks of the ``fake`` backend
    in this process, as rank ``rank``, destroyed on exit.  Where the code
    picks a collective by backend it takes ``like``'s (``"gloo"`` or
    ``"nccl"``), the world the fake one stands for."""
    import torch.distributed as dist
    # registers the "fake" backend; its store is never read
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ..distributed import collectives
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    if like not in ("gloo", "nccl"):
        raise ValueError(f"a fake world stands for gloo or nccl, not "
                         f"{like!r}")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    collectives.FAKE_ROUTE[0] = like
    try:
        yield
    finally:
        collectives.FAKE_ROUTE[0] = None
        if dist.is_initialized():
            dist.destroy_process_group()
