"""The training mesh over the processes of a ``torch.distributed`` world;
the port of ``repro/launch/mesh.py``'s ``make_host_mesh``.

A function, not a module constant: importing this module touches no
process group.  The reference's production meshes (``(16, 16)`` and
``(2, 16, 16)``, 256 and 512 ranks) come with the next slice of the
port; its TPU roofline constants do not carry over to the card.
"""
from __future__ import annotations


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
