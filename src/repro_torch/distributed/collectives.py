"""The collectives the data-parallel step runs along one axis of a
``torch.distributed.device_mesh.DeviceMesh``: the reference's
``lax.psum_scatter`` and ``lax.all_gather(tiled=True)`` over a named
axis.

NCCL runs each in one call (``reduce_scatter_tensor``,
``all_gather_into_tensor``).  Gloo (the CPU tests, and the card's
two-rank check that shares one card) may lack both for CUDA tensors, so
it reduce-scatters by sending each rank its segment of every rank with
``all_to_all_single`` and summing them here in rank order, and gathers
with the list form of ``all_gather``; one route for gloo on both devices
keeps the sum's order fixed.  No backend falls back to another; a failed
collective raises.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..core.distributed import _axis as axis_group          # noqa: F401
from ..core.distributed import _mesh_device as mesh_device  # noqa: F401

# the backend a ``fake`` world stands for (``launch.mesh.fake_world``)
FAKE_ROUTE = [None]


def is_nccl(group) -> bool:
    """Whether ``group`` runs NCCL's route: an NCCL group, or a fake one
    that stands for NCCL."""
    backend = dist.get_backend(group)
    if backend == "fake":
        return FAKE_ROUTE[0] == "nccl"
    return backend == "nccl"


def reduce_scatter(out: torch.Tensor, flat: torch.Tensor, group) -> None:
    """``out`` (``(c,)``) := the sum over the group's ranks of segment
    ``k`` of their ``flat`` (``(n * c,)``), on rank ``k``."""
    n = group.size()
    if is_nccl(group):
        dist.reduce_scatter_tensor(out, flat, group=group)
        return
    parts = torch.empty_like(flat)
    dist.all_to_all_single(parts, flat, group=group)
    parts = parts.view(n, -1)
    out.copy_(parts[0])
    for j in range(1, n):
        out.add_(parts[j])



def all_gather_flat(out: torch.Tensor, shard: torch.Tensor, group) -> None:
    """``out`` (``(n * c,)``) := every rank's ``shard`` (``(c,)``) in rank
    order; ``shard`` may be this rank's segment of ``out``."""
    if is_nccl(group):
        dist.all_gather_into_tensor(out, shard, group=group)
        return
    dist.all_gather(list(out.view(group.size(), -1).unbind(0)),
                    shard.clone(), group=group)
