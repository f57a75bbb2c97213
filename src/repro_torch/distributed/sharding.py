"""Sharding rules: a parameter's role -> its layout on the mesh; the port
of ``repro/distributed/sharding.py``.

Mesh axes: ``("pod", "data", "model")`` or ``("data", "model")``.
``"model"`` carries tensor parallelism (Q heads, ``d_ff``, ``d_inner``,
experts where they divide); ``("pod", "data")`` carry data parallelism,
and with ``fsdp`` also shard the large matrices; optimizer moments take
ZeRO-1 on top of their param's spec (the first still-replicated dim that
divides).

The rules are pure functions of a leaf's path and shape in the
reference's params pytree (its per-segment leaves stacked over a leading
layer axis), the config and an ``{axis: size}`` mapping.  Each returns the
reference's ``PartitionSpec`` as a tuple with one entry per dim: ``None``,
an axis name, or a tuple of names (a one-name tuple is its name, as
``PartitionSpec`` normalises it).  Every rule replicates a dim its axes do
not divide: correctness never depends on layout.

The tree mappers turn a spec into ``DTensor`` placements for the port's
per-layer tensors: ``Shard(d)`` on each mesh dim whose axis the spec puts
on dim ``d``, ``Replicate()`` elsewhere, the stacked leading entry
dropped.  A per-layer tensor cannot shard the layer axis, so where a
moment's rule puts a data axis there, that mesh dim replicates the layer's
moment instead.  :func:`cache_placements` is ``cache_shardings``'s port
for the per-layer caches; :func:`cache_model_dim` tells a layer which dim
of its cache a rank holds a slice of.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

Axes = Mapping[str, int]
Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def _norm(entry) -> Entry:
    if isinstance(entry, tuple) and len(entry) == 1:
        return entry[0]
    return entry


def _axsize(axes: Axes, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        return axes[names]
    return math.prod(axes[a] for a in names)


def _maybe(axes: Axes, names, dim: int):
    """``names`` if their size divides ``dim``, else None (replicate)."""
    if names is None or dim % _axsize(axes, names) != 0:
        return None
    return names


def batch_axes(axes: Axes, batch: int) -> Optional[Tuple[str, ...]]:
    """The largest prefix-combination of the data axes that divides
    ``batch``."""
    cands = [("pod", "data")] if "pod" in axes else []
    cands.append(("data",))
    for c in cands:
        if batch % _axsize(axes, c) == 0:
            return c
    return None


def dp_axes(axes: Axes) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axes else ("data",)


def param_pspec(path: Sequence[str], shape: Sequence[int], cfg, axes: Axes,
                *, fsdp: bool) -> Spec:
    """The reference's spec of the param leaf at ``path`` (a tuple of
    names, ``("seg0", "sub0", "attn", "wq")``) of the stacked ``shape``."""
    name = path[-1]
    stacked = any(p.startswith("seg") for p in path)
    shape = tuple(shape)
    rank = len(shape) - (1 if stacked else 0)
    dims = shape[1:] if stacked else shape
    tp = "model"
    fa = dp_axes(axes) if fsdp else None

    def mb(names, dim):
        return _maybe(axes, names, dim)

    def spec(*parts) -> Spec:
        if len(parts) != rank:
            raise ValueError(f"{path} {shape}: {len(parts)} spec entries")
        return tuple(_norm(p) for p in ((None,) if stacked else ()) + parts)

    if name == "embed":
        return tuple(_norm(p) for p in (mb(tp, shape[0]), mb(fa, shape[1])))
    if rank == 1:   # norms, biases, lam, D
        big = dims[0] >= 1024
        return spec(mb(tp, dims[0]) if big and name in ("conv_b", "dt_bias",
                                                        "D", "lam") else None)
    if name in ("wq", "wk", "wv"):
        return spec(mb(fa, dims[0]), mb(tp, dims[1]), None)
    if name == "wo":
        return spec(mb(tp, dims[0]), None, mb(fa, dims[2]))
    if name in ("w_in", "w_gate") and rank == 2:
        return spec(mb(fa, dims[0]), mb(tp, dims[1]))
    if name == "w_out" and rank == 2:
        return spec(mb(tp, dims[0]), mb(fa, dims[1]))
    if name == "router":
        return spec(mb(fa, dims[0]), None)
    if name in ("w_in", "w_gate") and rank == 3:   # moe (E, D, F)
        if mb(tp, dims[0]) is not None:            # expert parallel
            return spec(tp, mb(fa, dims[1]), None)
        return spec(None, mb(fa, dims[1]), mb(tp, dims[2]))
    if name == "w_out" and rank == 3:              # moe (E, F, D)
        if mb(tp, dims[0]) is not None:
            return spec(tp, None, mb(fa, dims[2]))
        return spec(None, mb(tp, dims[1]), mb(fa, dims[2]))
    if name == "in_proj":                          # (D, 2*inner)
        return spec(mb(fa, dims[0]), mb(tp, dims[1]))
    if name == "out_proj":                         # (inner, D)
        return spec(mb(tp, dims[0]), mb(fa, dims[1]))
    if name == "conv_w":                           # (k, inner)
        return spec(None, mb(tp, dims[1]))
    if name == "x_proj":                           # (inner, dt_rank+2N)
        return spec(mb(tp, dims[0]), None)
    if name == "dt_proj":                          # (dt_rank, inner)
        return spec(None, mb(tp, dims[1]))
    if name == "A_log":                            # (inner, N)
        return spec(mb(tp, dims[0]), None)
    if name in ("wr", "wi"):                       # (W, W) row-parallel
        return spec(mb(tp, dims[0]), None)
    return spec(*([None] * rank))


def zero1_pspec(pspec: Spec, shape: Sequence[int], axes: Axes) -> Spec:
    """ZeRO-1: the first still-replicated dim that the data axes divide
    is sharded over them (skipped when the spec already uses a data axis,
    as FSDP's do)."""
    da = dp_axes(axes)
    size = _axsize(axes, da)
    parts = list(pspec) + [None] * (len(shape) - len(pspec))
    used = set()
    for p in parts:
        used.update(p if isinstance(p, tuple) else (p,))
    if any(a in used for a in da):
        return tuple(parts)
    for i, (p, d) in enumerate(zip(parts, shape)):
        if p is None and d % size == 0 and d >= size:
            parts[i] = _norm(da)
            return tuple(parts)
    return tuple(parts)


def batch_pspec(axes: Axes, batch: int, rank: int) -> Spec:
    """A batch leaf of ``rank`` dims: dim 0 over :func:`batch_axes`."""
    return (_norm(batch_axes(axes, batch)),) + (None,) * (rank - 1)


def cache_pspec(path: Sequence[str], shape: Sequence[int], cfg,
                axes: Axes) -> Spec:
    """A decode cache leaf (leading stacked layer dim): batch over the
    data axes; KV heads (else the sequence), the mamba/rglru inner dim
    over ``"model"``."""
    name = path[-1]
    dims = tuple(shape)[1:]
    b = dims[0] if dims else 1
    ba = _norm(batch_axes(axes, b))

    def mb(names, dim):
        return _maybe(axes, names, dim)

    if name in ("k", "v"):
        if mb("model", dims[2]) is not None:
            return (None, ba, None, "model", None)
        return (None, ba, mb("model", dims[1]), None, None)
    if name == "conv":
        return (None, ba, None, mb("model", dims[2]))
    if name == "ssm":
        return (None, ba, mb("model", dims[1]), None)
    if name == "h":
        return (None, ba, mb("model", dims[1]))
    return (None,) * len(shape)


def cache_model_dim(name: str, shape: Sequence[int], cfg,
                    tp: int) -> Optional[int]:
    """The dim of a per-layer cache leaf of the whole ``shape`` (no
    stacked axis) that :func:`cache_pspec` splits over ``"model"`` at
    ``tp``, or None (whole on every rank)."""
    spec = cache_pspec((name,), (1,) + tuple(shape), cfg,
                       {"data": 1, "model": tp})
    for d, entry in enumerate(spec[1:]):
        if entry == "model":
            return d
    return None


# ---- specs -> DTensor placements ----------------------------------------------

def mesh_axes(mesh) -> Dict[str, int]:
    """A ``DeviceMesh``'s ``{axis: size}``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def placements(spec: Spec, mesh_dims: Sequence[str], *, skip: int = 0):
    """One placement per mesh dim for a tensor whose dims are ``spec``'s
    past its first ``skip``: ``Shard(d)`` where the spec puts that dim's
    axis on dim ``d``, ``Replicate()`` elsewhere (also where it is on a
    skipped dim)."""
    from torch.distributed.tensor import Replicate, Shard
    where = {}
    for d, entry in enumerate(spec):
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if a is not None:
                where[a] = d
    out = []
    for a in mesh_dims:
        d = where.get(a)
        out.append(Shard(d - skip) if d is not None and d >= skip
                   else Replicate())
    return tuple(out)


def _stacked(model):
    """Each parameter's name -> (its reference path as a tuple, the
    stacked shape of that leaf, whether the leaf is stacked)."""
    from ..models.transformer import reference_paths
    paths = reference_paths(model)
    count: Dict[str, int] = {}
    for _name, (path, j) in paths.items():
        count[path] = max(count.get(path, 0), (j or 0) + 1)
    out = {}
    for name, p in model.named_parameters():
        path, j = paths[name]
        lead = () if j is None else (count[path],)
        out[name] = (tuple(path.split(".")), lead + whole_shape(model, name),
                     j is not None)
    return out


def whole_shape(model, name: str) -> Tuple[int, ...]:
    """A parameter's whole shape: its own, but on a model that
    ``tensor_parallel.shard_model`` has sharded, where the split dim is
    ``tp`` times the rank's."""
    shape = list(model.get_parameter(name).shape)
    mg = getattr(model, "mg", None)
    layout = getattr(model, "layouts", {}).get(name)
    if mg is not None and layout is not None:
        shape[layout[1]] *= mg.size
    return tuple(shape)


def param_specs(model, cfg, axes: Axes, *, fsdp: bool) -> Dict[str, Spec]:
    """Each parameter's name -> its reference leaf's stacked spec."""
    return {name: param_pspec(path, shape, cfg, axes, fsdp=fsdp)
            for name, (path, shape, _) in _stacked(model).items()}


def param_placements(model, cfg, mesh, *, fsdp: bool):
    """Each parameter's name -> its DTensor placements on ``mesh``."""
    axes = mesh_axes(mesh)
    stacked = _stacked(model)
    return {name: placements(spec, mesh.mesh_dim_names,
                             skip=int(stacked[name][2]))
            for name, spec in param_specs(model, cfg, axes,
                                          fsdp=fsdp).items()}


def moment_placements(model, cfg, mesh, *, fsdp: bool):
    """Each parameter's name -> its moments' (and error buffer's)
    placements: ZeRO-1 on top of the param spec."""
    axes = mesh_axes(mesh)
    stacked = _stacked(model)
    return {name: placements(zero1_pspec(spec, stacked[name][1], axes),
                             mesh.mesh_dim_names, skip=int(stacked[name][2]))
            for name, spec in param_specs(model, cfg, axes,
                                          fsdp=fsdp).items()}


def cache_placements(caches, cfg, mesh):
    """``cache_shardings``'s port: each layer's cache leaves (the whole
    ones, ``models.transformer.init_caches(..., device="meta")`` will do)
    -> their placements on ``mesh``, one dict a layer."""
    axes = mesh_axes(mesh)
    return [{name: placements(cache_pspec((name,), (1,) + tuple(t.shape),
                                          cfg, axes),
                              mesh.mesh_dim_names, skip=1)
             for name, t in layer.items()} for layer in caches]


def batch_placements(mesh, batch):
    """Each batch leaf's name -> its placements (dim 0 over the data
    axes that divide it)."""
    axes = mesh_axes(mesh)
    return {k: placements(batch_pspec(axes, v.shape[0], v.dim()),
                          mesh.mesh_dim_names)
            for k, v in batch.items()}
