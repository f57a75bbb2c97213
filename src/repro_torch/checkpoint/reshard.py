"""Elastic resharding: restore a checkpoint onto another mesh; the port of
``repro/checkpoint/reshard.py``.

Checkpoints hold whole logical leaves, so going from N ranks to M is:
build the new mesh, derive each leaf's placements on it from the sharding
rules, restore (each rank reads its own slices of the memory-mapped
files).  The path a job takes when it restarts at another width after
losing ranks (``ft/coordinator.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..distributed import sharding as shd
from ..distributed.collectives import mesh_device
from . import io


def reshard_restore(template, directory: str, cfg, mesh, *, fsdp: bool,
                    step: Optional[int] = None):
    """Restore a train state of the param-shaped layout onto ``mesh``: the
    parameters by :func:`~..distributed.sharding.param_placements`, the
    moments and the error buffer (where there is one) by
    ``moment_placements``, each a ``DTensor`` of which this rank holds its
    slice.  ``template`` (``train.state.abstract_state`` will do, at the
    checkpoint's ``tp``) gives the structure; its model comes back with
    ``DTensor`` parameters, which
    ``distributed.tensor_parallel.shard_model`` turns into a model that
    runs on the mesh's model axis.  Returns ``(state, step)``."""
    model = template.params
    pp = shd.param_placements(model, cfg, mesh, fsdp=fsdp)
    mp = shd.moment_placements(model, cfg, mesh, fsdp=fsdp)
    placements = {"params": pp, "mu": mp, "nu": mp}
    if template.error is not None:
        placements["error"] = mp
    template.step = torch.zeros((), dtype=torch.int32,
                                device=mesh_device(mesh))
    return io.restore(template, directory, step, mesh=mesh,
                      placements=placements)
