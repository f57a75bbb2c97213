"""Checkpoints of a train state: async, atomic, in the reference's
on-disk layout; the port of ``repro/checkpoint/io.py``.

Layout (the reference's):  ``<dir>/step_<n>/``
           ``manifest.json``        shapes, dtypes, step
           ``<flat.key.path>.npy``  one file per leaf

A leaf's key is its path in the reference's ``TrainState`` pytree: ``0``
for the step, ``1.embed``, ``1.seg0.sub0.attn.wq`` ... for the params,
``2.`` ``3.`` ``4.`` the same paths for ``mu``, ``nu`` and the error
buffer (absent, a ``None`` leaf, without compression).  The reference
stacks each segment's per-layer leaves over a leading axis; the port
stacks its layers' tensors on save and unstacks them on restore
(``models.transformer.reference_paths``).  A ZeRO-1 state's flat moments
(``train.step.make_zero1_local_state``) are keyed by the reference's paths
already and keep their ``(n_dp, size / n_dp)`` shape.  A checkpoint
written by either package therefore restores in the other.

In a ``torch.distributed`` world every rank calls :func:`save`: a
``DTensor`` leaf is gathered whole (a collective), rank 0 alone writes,
and a synchronous save ends at a barrier.  :func:`restore` reads the
``.npy`` files memory-mapped and copies into each ``DTensor`` leaf of the
template its own slice alone; with ``placements`` (and ``mesh``) it puts
each named leaf on the mesh as a new ``DTensor``, so no rank holds a
whole leaf it does not keep (``reshard.py``).

A model that ``distributed.tensor_parallel.shard_model`` has sharded
saves the reference's logical leaves too: each piece of its parameters,
moments and error buffer is gathered whole over the model group (every
rank takes part), and a restore into such a model copies each rank its
piece (``tensor_parallel.take``), so a checkpoint crosses between ``tp``
widths and packages.

Leaves are copied to the host before a save returns or its writer thread
starts, so an async save never reads a tensor that the next step
changes.  Saves go to a ``.tmp`` directory and an atomic rename, so a
preemption mid-save never corrupts the latest checkpoint.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..distributed import tensor_parallel as tpar
from ..models.transformer import reference_paths
from ..train.state import TrainState

_SEP = "."
_TREEDEF = "TrainState(step, params, mu, nu, error)"


_TREES = (("1", "params"), ("2", "mu"), ("3", "nu"), ("4", "error"))


def _entries(state: TrainState):
    """``(reference key, tree, name, layer index or None)`` for every
    tensor of the state past its step; ``(prefix, None, None, None)`` for
    an absent tree.  A name that is not a parameter's (a ZeRO-1 moment's)
    is its reference path already."""
    paths = reference_paths(state.params)
    for idx, field in _TREES:
        tree = getattr(state, field)
        if tree is None:
            yield idx, None, None, None
            continue
        if field == "params":
            tree = dict(tree.named_parameters())
        for name in tree:
            path, j = paths.get(name, (name, None))
            yield idx + _SEP + path, field, name, j


def _flatten(state: TrainState) -> Dict[str, object]:
    """Reference key -> the tensor, ``{layer index: tensor}`` for a
    stacked leaf, or None (an absent error buffer)."""
    flat: Dict[str, object] = {"0": state.step}
    for key, field, name, j in _entries(state):
        if field is None:
            flat[key] = None
            continue
        tree = getattr(state, field)
        t = tree.get_parameter(name) if field == "params" else tree[name]
        t = _whole_piece(state.params, name, t)
        if j is None:
            flat[key] = t
        else:
            flat.setdefault(key, {})[j] = t
    return flat


def _layout(model, name: str):
    """(the model group, parameter ``name``'s layout) on a sharded model;
    (None, None) elsewhere and for a key that is not a parameter's."""
    mg = getattr(model, "mg", None)
    if mg is None or name not in getattr(model, "layouts", {}):
        return None, None
    return mg, model.layouts[name]


def _whole_piece(model, name: str, t: torch.Tensor) -> torch.Tensor:
    """A sharded model's piece ``t`` of leaf ``name`` gathered whole (a
    collective); ``t`` itself elsewhere."""
    mg, layout = _layout(model, name)
    return t if layout is None else tpar.whole(t.detach(), layout, mg)


def _is_dtensor(t) -> bool:
    return hasattr(t, "full_tensor")


def _whole(t) -> torch.Tensor:
    """A ``DTensor``'s global value: its local shards gathered along each
    mesh dim that shards it, the innermost first (the list form of
    ``all_gather``, which gloo has for CUDA tensors too; the sharding
    rules shard only dims their axes divide, so shards are even)."""
    local, mesh = t.to_local(), t.device_mesh
    for i in reversed(range(mesh.ndim)):
        pl = t.placements[i]
        if pl.is_shard():
            group = mesh.get_group(i)
            parts = [torch.empty_like(local) for _ in range(group.size())]
            dist.all_gather(parts, local.contiguous(), group=group)
            local = torch.cat(parts, dim=pl.dim)
    return local


def _host(t: torch.Tensor, keep: bool) -> Optional[np.ndarray]:
    """A host copy of ``t`` (a ``DTensor`` gathered whole: every rank
    takes part), or None where ``keep`` is false."""
    t = t.detach()
    if _is_dtensor(t):
        t = _whole(t)
    return t.to("cpu", copy=True).numpy() if keep else None


def save(state: TrainState, directory: str, step: int, *,
         async_: bool = False):
    """Write a checkpoint; returns a ``join()`` handle when ``async_``.
    In a world every rank calls it and rank 0 writes; a synchronous save
    returns on every rank once the checkpoint is in place."""
    world = dist.is_available() and dist.is_initialized()
    keep = not world or dist.get_rank() == 0
    flat = {}
    for k, v in _flatten(state).items():
        if isinstance(v, dict):
            layers = [_host(v[j], keep) for j in range(len(v))]
            if keep:
                flat[k] = np.stack(layers)
        elif v is not None:
            flat[k] = _host(v, keep)

    def write():
        if not keep:
            return
        final = os.path.join(directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
        manifest = {"step": step, "treedef": _TREEDEF,
                    "leaves": {k: {"shape": list(v.shape),
                                   "dtype": str(v.dtype)}
                               for k, v in flat.items()},
                    "shards": 1}
        for k, v in flat.items():
            np.save(os.path.join(tmp, k + ".npy"), v)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)

    if async_:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        return t
    write()
    if world:
        dist.barrier()
    return None


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def _put(dst: torch.Tensor, arr: np.ndarray, what: str) -> None:
    if tuple(arr.shape) != tuple(dst.shape):
        raise ValueError(f"checkpoint leaf {what} has shape {arr.shape}, "
                         f"the state wants {tuple(dst.shape)}")
    if _is_dtensor(dst):
        dst.to_local().copy_(torch.from_numpy(np.array(
            _local_slice(arr, dst.device_mesh, dst.placements))))
        return
    dst.copy_(torch.from_numpy(np.array(arr)))


def _local_slice(arr: np.ndarray, mesh, placements) -> np.ndarray:
    """This rank's slice of the global ``arr`` under ``placements``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        arr.shape, mesh, placements)
    return arr[tuple(slice(o, o + n) for o, n in zip(offset, shape))]


def _placed(arr: np.ndarray, mesh, placements, dtype) -> torch.Tensor:
    """A ``DTensor`` of the global ``arr`` on ``mesh``, this rank holding
    its slice alone."""
    from torch.distributed.tensor import DTensor

    from ..distributed.collectives import mesh_device
    local = torch.from_numpy(np.array(_local_slice(arr, mesh, placements)))
    local = local.to(device=mesh_device(mesh), dtype=dtype)
    stride = tuple(int(np.prod(arr.shape[i + 1:]))
                   for i in range(len(arr.shape)))
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=arr.shape, stride=stride)


@torch.no_grad()
def restore(template: TrainState, directory: str,
            step: Optional[int] = None, *, mesh=None, placements=None):
    """Load a checkpoint into ``template``'s tensors, in place, on their
    devices (a ``DTensor`` leaf: its local slice); a ``None`` error buffer
    stays None.  ``placements`` (``{"params" | "mu" | "nu" | "error":
    {name: placements}}``, with ``mesh``) puts those leaves on ``mesh`` as
    new ``DTensor``s instead (the template's may be on ``meta``): the
    model's parameters are replaced by ``DTensor`` parameters.  Returns
    ``(state, step)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    placements = placements or {}
    if placements and mesh is None:
        raise ValueError("restore: placements need their mesh")
    files: Dict[str, np.ndarray] = {}

    def load(key):
        if key not in files:
            files[key] = np.load(os.path.join(d, key + ".npy"),
                                 mmap_mode="r")
        return files[key]

    _put(template.step, load("0"), "0")
    entries = list(_entries(template))
    stacked = {}
    for key, field, name, j in entries:
        if field is not None and j is not None:
            stacked[key] = stacked.get(key, 0) + 1
    for key, field, name, j in entries:
        if field is None:
            continue
        arr = load(key)
        if j is not None:
            if arr.shape[0] != stacked[key]:
                raise ValueError(f"checkpoint leaf {key} stacks "
                                 f"{arr.shape[0]} layers, the state has "
                                 f"{stacked[key]}")
            arr, what = arr[j], f"{key}[{j}]"
        else:
            what = key
        tree = getattr(template, field)
        dst = tree.get_parameter(name) if field == "params" else tree[name]
        pl = placements.get(field, {}).get(name)
        if pl is None:
            mg, layout = _layout(template.params, name)
            if layout is not None:      # this rank's piece of the leaf
                arr = tpar.take(torch.from_numpy(np.array(arr)), layout,
                                mg.rank, mg.size).numpy()
            _put(dst, arr, what)
            continue
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"checkpoint leaf {what} has shape "
                             f"{arr.shape}, the state wants "
                             f"{tuple(dst.shape)}")
        new = _placed(arr, mesh, pl, dst.dtype)
        if field == "params":
            owner, _, attr = name.rpartition(".")
            mod = tree.get_submodule(owner)
            setattr(mod, attr, torch.nn.Parameter(
                new, requires_grad=dst.requires_grad))
        else:
            tree[name] = new
    return template, step
