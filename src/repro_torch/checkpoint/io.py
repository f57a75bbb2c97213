"""Checkpoints of a train state: async, atomic, in the reference's
on-disk layout; the port of ``repro/checkpoint/io.py`` (its elastic
``reshard.py`` waits for the multi-device slice).

Layout (the reference's):  ``<dir>/step_<n>/``
           ``manifest.json``        shapes, dtypes, step
           ``<flat.key.path>.npy``  one file per leaf

A leaf's key is its path in the reference's ``TrainState`` pytree: ``0``
for the step, ``1.embed``, ``1.seg0.sub0.attn.wq`` ... for the params,
``2.`` ``3.`` ``4.`` the same paths for ``mu``, ``nu`` and the error
buffer (absent, a ``None`` leaf, without compression).  The reference
stacks each segment's per-layer leaves over a leading axis; the port
stacks its layers' tensors on save and unstacks them on restore
(``models.transformer.reference_paths``).  A checkpoint written by
either package therefore restores in the other.

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

from ..models.transformer import reference_paths
from ..train.state import TrainState

_SEP = "."
_TREEDEF = "TrainState(step, params, mu, nu, error)"


def _flatten(state: TrainState) -> Dict[str, object]:
    """Reference key -> the tensor, ``{layer index: tensor}`` for a
    stacked leaf, or None (an absent error buffer)."""
    paths = reference_paths(state.params)
    flat: Dict[str, object] = {"0": state.step}
    trees = (("1", dict(state.params.named_parameters())),
             ("2", state.mu), ("3", state.nu), ("4", state.error))
    for idx, tree in trees:
        if tree is None:
            flat[idx] = None
            continue
        for name, t in tree.items():
            path, j = paths[name]
            key = idx + _SEP + path
            if j is None:
                flat[key] = t
            else:
                flat.setdefault(key, {})[j] = t
    return flat


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", copy=True).numpy()


def save(state: TrainState, directory: str, step: int, *,
         async_: bool = False):
    """Write a checkpoint; returns a ``join()`` handle when ``async_``."""
    flat = {}
    for k, v in _flatten(state).items():
        if isinstance(v, dict):
            flat[k] = np.stack([_host(v[j]) for j in range(len(v))])
        elif v is not None:
            flat[k] = _host(v)

    def write():
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
    dst.copy_(torch.from_numpy(np.array(arr)))


@torch.no_grad()
def restore(template: TrainState, directory: str,
            step: Optional[int] = None):
    """Load a checkpoint into ``template``'s tensors, in place, on their
    devices; a ``None`` error buffer stays None.  Returns ``(state,
    step)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    for k, v in _flatten(template).items():
        if v is None:
            continue
        arr = np.load(os.path.join(d, k + ".npy"))
        if isinstance(v, dict):
            if arr.shape[0] != len(v):
                raise ValueError(f"checkpoint leaf {k} stacks {arr.shape[0]} "
                                 f"layers, the state has {len(v)}")
            for j, t in v.items():
                _put(t, arr[j], f"{k}[{j}]")
        else:
            _put(v, arr, k)
    return template, step
