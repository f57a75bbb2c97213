"""Training state; the port of ``repro/train/state.py``.

The reference's pytree leaves are, here, a model and dicts keyed by its
parameter names (``model.named_parameters()``): ``mu``/``nu`` are Adam's
moments and ``error`` the gradient compression's error feedback, each a
tensor of its parameter's shape.  ``checkpoint/io.py`` lays them out as
the reference's stacked leaves on disk.  A ZeRO-1 state
(``train.step.make_zero1_local_state``) keys its flat moments by the
reference's leaf paths instead.

The parameters are f32 master weights, or bf16 for the reference's
``BF16_STATE_ARCHS`` (``init_state(model, dtype=torch.bfloat16)`` casts
every leaf, the norms included, as the reference's ``build_cell`` does);
the moments start in the parameters' dtype and the optimizer's mixed
sequence hands back f32 moments from step 1 on, as the reference's does,
so a state's moments may be bf16 or f32 and both are valid states and
checkpoints.  On a model that ``distributed.tensor_parallel.shard_model``
has sharded (over ``"model"``, and with ``fsdp`` over the data axes) the
parameters are the rank's pieces; the moments are too, or, for the step
on a mesh (``train.step.make_train_step(..., mesh=...)``), ``DTensor``s
placed by ``sharding.moment_placements``: the FSDP leaves' moments the
parameter's piece, the others ZeRO-1's slice over the data axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

Leaves = Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    step: torch.Tensor           # () int32, on the model's device
    params: torch.nn.Module      # f32 or bf16 weights (repro_torch.models)
    mu: Leaves                   # Adam first moment
    nu: Leaves                   # Adam second moment
    error: Optional[Leaves] = None   # gradient-compression error feedback


def zeros_like_params(model: torch.nn.Module, dtype=None) -> Leaves:
    """A zero tensor per parameter (of its dtype unless told), by name."""
    return {n: torch.zeros(p.shape, dtype=dtype or p.dtype, device=p.device)
            for n, p in model.named_parameters()}


def cast_model(model: torch.nn.Module, dtype) -> torch.nn.Module:
    """Every parameter of ``model`` (norms included) in ``dtype``,
    trainable: the reference's state of ``BF16_STATE_ARCHS``.  In place."""
    for name, p in list(model.named_parameters()):
        owner, _, attr = name.rpartition(".")
        mod = model.get_submodule(owner) if owner else model
        setattr(mod, attr, torch.nn.Parameter(p.detach().to(dtype),
                                              requires_grad=True))
    return model


def _mesh_moments(model: torch.nn.Module, mesh, dtype=None) -> Leaves:
    """Zero moments as ``DTensor``s on ``mesh`` by
    ``sharding.moment_placements`` of the model's ``fsdp``: this rank
    holds the piece of each, its parameter's piece cut once more along
    the dim ZeRO-1 gives the data axes."""
    from torch.distributed.tensor import DTensor

    from ..distributed.sharding import moment_placements, whole_shape
    fsdp = bool(getattr(model, "data_dims", None))
    pl = moment_placements(model, model.cfg, mesh, fsdp=fsdp)
    names = tuple(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.mesh.shape))
    dd = getattr(model, "data_dims", {})
    out = {}
    for name, p in model.named_parameters():
        shape = list(p.shape)
        for a, place in zip(names, pl[name]):
            if place.is_shard() and a != "model" and \
                    dd.get(name) != place.dim:
                shape[place.dim] //= sizes[a]
        whole = whole_shape(model, name)
        stride = tuple(math.prod(whole[i + 1:]) for i in range(len(whole)))
        local = torch.zeros(shape, dtype=dtype or p.dtype, device=p.device)
        out[name] = DTensor.from_local(local, mesh, pl[name], run_check=False,
                                       shape=whole, stride=stride)
    return out


def init_state(model: torch.nn.Module, *, compression: bool = False,
               dtype=None, mesh=None) -> TrainState:
    """Step 0, zero moments of the params' dtype and, with
    ``compression``, a zero f32 error buffer.  ``dtype`` casts the
    model's parameters first (:func:`cast_model`).  With ``mesh`` (the
    mesh ``shard_model`` sharded the model over) the moments are
    :func:`_mesh_moments`, the state of the step on a mesh."""
    if dtype is not None:
        cast_model(model, dtype)
    step = torch.zeros((), dtype=torch.int32,
                       device=next(model.parameters()).device)
    if mesh is not None:
        if compression:
            raise ValueError("the step on a mesh has no compression")
        return TrainState(step, model, _mesh_moments(model, mesh),
                          _mesh_moments(model, mesh), None)
    err = zeros_like_params(model, torch.float32) if compression else None
    return TrainState(step, model, zeros_like_params(model),
                      zeros_like_params(model), err)


def abstract_state(cfg, *, tp: int = 1, compression: bool = False,
                   dtype=None) -> TrainState:
    """:func:`init_state` of an f32 model of ``cfg`` (heads padded at
    ``tp``; every leaf in ``dtype`` where given) on the ``meta`` device:
    every shape and dtype, no storage."""
    from ..models.transformer import Transformer
    return init_state(Transformer(cfg, tp=tp, device="meta",
                                  dtype=torch.float32),
                      compression=compression, dtype=dtype)
