"""Tensor parallelism over the ``"model"`` axis of a ``DeviceMesh``: the
execution the reference leaves to XLA's partitioner (``param_shardings`` /
``cache_shardings`` on a ``("data", "model")`` mesh), written out in
PyTorch's idiom.

The primitives are ``torch.autograd.Function``s over the model group
(Megatron's regions):

* :func:`copy_to`: identity forward, all-reduce backward.  A replicated
  activation entering a rank's share of a computation (the input of a
  column-parallel product, the router's gates under expert parallelism)
  gets the other ranks' share of its gradient this way.
* :func:`reduce_from`: all-reduce forward, identity backward (the end of a
  row-parallel product).
* :func:`split`: this rank's slice of a replicated tensor forward, the
  slices all-gathered backward (a replicated leaf a sharded layer uses in
  part: Mamba's ``D`` below 1,024 channels).
* :func:`gather`: the slices all-gathered forward, this rank's slice
  backward.

:func:`row_parallel` sums a row-parallel product's partial products in f32
and rounds to bf16 once, as the reference's single ``einsum`` on one
device does; rounding each partial first would add an error the
reference lacks.  Without grad (serving) the reductions run in place and
no autograd node is made.

:func:`shard_model` turns a whole model (padded at its ``tp``: ``models.
transformer.Transformer(cfg, tp=...)``) into this rank's shard of every
parameter by ``sharding.param_placements`` and binds the model group;
:func:`gather_model` is its inverse.  Each parameter keeps a *layout*:
``None`` (whole on every rank), ``("shard", d)`` (dim ``d`` split in
``tp`` contiguous pieces, the placement's ``Shard(d)``) or ``("halves",
d)``.  The last is the recurrent kinds' ``in_proj`` (``(D, 2 * inner)``,
``x`` and ``z`` side by side): the rule shards it contiguously, which at
``tp = 2`` would give rank 0 all of ``x`` and rank 1 all of ``z``, while
the conv and the state are split over ``inner``.  A rank therefore
stores its slice of each half; :func:`take` and :func:`whole` map it to
and from the reference's layout bitwise, and the checkpoints go through
them.

With ``fsdp=True`` :func:`shard_model` also splits each leaf the rules
shard over the data axes (``distributed/fsdp.py``): a rank keeps the
data group's piece of its model piece, and the layers read it whole
through ``fsdp.use``.  :func:`piece_of` and :func:`whole_of` map a leaf
to and from its piece on both axes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

BF16 = torch.bfloat16
F32 = torch.float32

Layout = Optional[Tuple[str, int]]


@dataclasses.dataclass(frozen=True, eq=False)
class ModelGroup:
    """The ranks of one row of a mesh's ``"model"`` axis: the process
    group, its size and this rank's index in it."""
    group: object
    size: int
    rank: int

    def __deepcopy__(self, memo):
        return self         # a handle on the world's group: copies share it


def model_group(mesh) -> Optional[ModelGroup]:
    """The mesh's model group; None where it has no ``"model"`` axis or
    one of size 1."""
    from .collectives import axis_group
    names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
    if "model" not in names:
        return None
    group, size, k = axis_group(mesh, "model")
    return ModelGroup(group, size, k) if size > 1 else None


def _grad_path(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


# ---- the autograd primitives ---------------------------------------------------

class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg):
        ctx.mg = mg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # contiguous: ranks' gradients may arrive with other strides, and
        # a collective pairs elements in memory order
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.mg.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mg, op):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=op, group=mg.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _all_gather(x: torch.Tensor, dim: int, mg: ModelGroup) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(mg.size)]
    dist.all_gather(parts, x.contiguous(), group=mg.group)
    return torch.cat(parts, dim=dim)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mg):
        ctx.dim, ctx.mg = dim, mg
        n = x.shape[dim] // mg.size
        return x.narrow(dim, mg.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.mg), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mg):
        ctx.dim, ctx.mg, ctx.n = dim, mg, x.shape[dim]
        return _all_gather(x, dim, mg)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.mg.rank * ctx.n, ctx.n).contiguous(), \
            None, None


def copy_to(x: torch.Tensor, mg: Optional[ModelGroup]) -> torch.Tensor:
    """Identity forward, the gradient all-reduced over the group."""
    if mg is None or not _grad_path(x):
        return x
    return _Copy.apply(x, mg)


def reduce_from(x: torch.Tensor, mg: Optional[ModelGroup],
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """All-reduce forward (in place on ``x`` without grad where it is
    contiguous: pass a tensor nothing else holds), identity backward."""
    if mg is None:
        return x
    if _grad_path(x):
        return _Reduce.apply(x, mg, op)
    x = x.contiguous()
    dist.all_reduce(x, op=op, group=mg.group)
    return x


def split(x: torch.Tensor, dim: int, mg: Optional[ModelGroup]) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim``; backward
    all-gathers the slices' gradients (each rank gets the whole)."""
    if mg is None:
        return x
    if _grad_path(x):
        return _Split.apply(x, dim, mg)
    n = x.shape[dim] // mg.size
    return x.narrow(dim, mg.rank * n, n)


def gather(x: torch.Tensor, dim: int, mg: Optional[ModelGroup]) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order;
    backward keeps this rank's slice."""
    if mg is None:
        return x
    if _grad_path(x):
        return _Gather.apply(x, dim, mg)
    return _all_gather(x, dim, mg)


def row_parallel(a: torch.Tensor, w: torch.Tensor,
                 mg: Optional[ModelGroup]) -> torch.Tensor:
    """``a @ w`` in bf16 where ``a``'s last dim and ``w``'s first are this
    rank's slice: the partial products in f32, summed over the group,
    rounded to bf16 once.  Without a group, the plain bf16 product."""
    if mg is None:
        return a @ w.to(BF16)
    part = a.to(F32) @ w.to(BF16).to(F32)
    return reduce_from(part, mg).to(BF16)


# ---- layouts -------------------------------------------------------------------

def take(t: torch.Tensor, layout: Layout, rank: int, size: int) -> torch.Tensor:
    """This rank's piece of the whole tensor ``t`` under ``layout``."""
    if layout is None:
        return t
    how, d = layout
    if how == "shard":
        return t.chunk(size, dim=d)[rank]
    x, z = t.chunk(2, dim=d)
    return torch.cat([x.chunk(size, dim=d)[rank], z.chunk(size, dim=d)[rank]],
                     dim=d)


def whole(t: torch.Tensor, layout: Layout,
          mg: Optional[ModelGroup]) -> torch.Tensor:
    """The whole tensor from every rank's piece ``t`` (a collective
    under a sharded layout)."""
    if layout is None or mg is None:
        return t
    how, d = layout
    parts = [torch.empty_like(t) for _ in range(mg.size)]
    dist.all_gather(parts, t.detach().contiguous(), group=mg.group)
    if how == "shard":
        return torch.cat(parts, dim=d)
    halves = [p.chunk(2, dim=d) for p in parts]
    return torch.cat([h[0] for h in halves] + [h[1] for h in halves], dim=d)


_HALVES = ("in_proj",)
# leaves a sharded layer uses in part where the rule keeps them whole
_SPLIT_WHEN_WHOLE = ("conv_b", "dt_bias", "D", "lam")


def model_layouts(model, cfg, mesh, *, fsdp: bool = False) -> Dict[str, Layout]:
    """Each parameter's layout on ``mesh``'s model axis, from
    ``sharding.param_placements`` (``fsdp`` moves no split over
    ``"model"``; ``fsdp.data_dims`` gives the data axes' split)."""
    from .sharding import param_placements
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names:
        return {n: None for n, _ in model.named_parameters()}
    at = names.index("model")
    out = {}
    for name, pl in param_placements(model, cfg, mesh, fsdp=fsdp).items():
        p = pl[at]
        if not p.is_shard():
            out[name] = None
        elif name.rsplit(".", 1)[-1] in _HALVES:
            out[name] = ("halves", p.dim)
        else:
            out[name] = ("shard", p.dim)
    return out


def _check_layer(name: str, mod, lay: Dict[str, Layout]) -> Optional[str]:
    """How a layer module runs under its leaves' layouts: None (whole,
    no collectives) or its mode; raises where they disagree."""
    def sharded(leaf):
        return lay.get(f"{name}.{leaf}") is not None

    kind = type(mod).__name__
    if kind == "Attention":
        if sharded("wk") and not sharded("wq"):
            raise ValueError(f"{name}: KV heads split over 'model' with "
                             f"the query heads whole (heads padded at "
                             f"another tp)")
        return "heads" if sharded("wq") else None
    if kind == "MLP":
        legs = [sharded(w) for w in ("w_in", "w_out", "w_gate")
                if getattr(mod, w) is not None]
    elif kind == "MoE":
        if not sharded("w_in"):
            return None
        return "experts" if lay[f"{name}.w_in"][1] == 0 else "ff"
    elif kind == "Mamba":
        legs = [sharded(w) for w in ("in_proj", "conv_w", "x_proj", "dt_proj",
                                     "A_log", "out_proj")]
    elif kind == "RGLRU":
        legs = [sharded(w) for w in ("in_proj", "conv_w", "wr", "wi",
                                     "out_proj")]
    else:
        return None
    if any(legs) and not all(legs):
        raise ValueError(f"{name}: the sharding rules split some of its "
                         f"matrices over 'model' and not others; no layout "
                         f"of the layer runs that")
    return "inner" if all(legs) else None


@torch.no_grad()
def shard_model(model, cfg, mesh, *, fsdp: bool = False):
    """Keep this rank's shard of every parameter of ``model`` (whole, or
    a ``DTensor`` as ``checkpoint.reshard.reshard_restore`` gives it: its
    ``to_local()`` where that is the shard) by its placement on
    ``mesh``'s ``"model"`` axis and, with ``fsdp``, on its data axes, and
    bind the model group (and the data group) to the model and its
    layers.  In place; returns the model.  A leaf the rules keep whole
    stays whole on every rank."""
    mg = model_group(mesh)
    lay = model_layouts(model, cfg, mesh, fsdp=fsdp)
    dg, dd = None, {}
    if fsdp:
        from . import fsdp as fs
        dg = fs.data_group(mesh)
        if dg is not None:
            dd = {n: d for n, d in fs.data_dims(model, cfg, mesh).items()
                  if d is not None}
    for name, p in list(model.named_parameters()):
        t = _piece(p.detach(), lay[name], mg, mesh, dd.get(name), dg)
        _replace(model, name, t.contiguous().clone(), p.requires_grad)
    _bind(model, mg, lay if mg is not None else {}, dg, dd)
    return model


def _piece(t: torch.Tensor, layout: Layout, mg: Optional[ModelGroup],
           mesh, ddim: Optional[int] = None,
           dg: Optional[ModelGroup] = None) -> torch.Tensor:
    """This rank's piece under ``layout`` (and data dim ``ddim``) of a
    whole tensor or of a ``DTensor``: its local shard where that is the
    piece already (``Shard`` on the model axis and on the data axes,
    replicated elsewhere), else gathered whole and cut."""
    if hasattr(t, "to_local"):
        from torch.distributed.tensor import Replicate, Shard

        from .sharding import dp_axes, mesh_axes
        data = dp_axes(mesh_axes(mesh))
        want = [Shard(layout[1]) if (a == "model" and layout is not None
                                     and layout[0] == "shard")
                else Shard(ddim) if (a in data and ddim is not None)
                else Replicate() for a in mesh.mesh_dim_names]
        if list(t.placements) == want and t.device_mesh == mesh:
            return t.to_local()
        t = t.full_tensor()
    return _cut(t, layout, mg, ddim, dg)


def _cut(t, layout, mg, ddim, dg):
    if mg is not None:
        t = take(t, layout, mg.rank, mg.size)
    if ddim is not None and dg is not None:
        t = t.chunk(dg.size, dim=ddim)[dg.rank]
    return t


def piece_of(model, name: str, t: torch.Tensor) -> torch.Tensor:
    """This rank's piece of parameter ``name``'s whole value ``t`` on a
    sharded model (``t`` itself on another)."""
    return _cut(t, getattr(model, "layouts", {}).get(name),
                getattr(model, "mg", None),
                getattr(model, "data_dims", {}).get(name),
                getattr(model, "dg", None))


def whole_of(model, name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole value of parameter ``name`` from every rank's piece ``t``
    (its gradient, a moment of its shape or itself; collectives over the
    data and model groups where they split it)."""
    d = getattr(model, "data_dims", {}).get(name)
    if d is not None:
        from .fsdp import all_gather_dim
        t = all_gather_dim(t, d, model.dg)
    return whole(t, getattr(model, "layouts", {}).get(name),
                 getattr(model, "mg", None))


@torch.no_grad()
def gather_model(model):
    """The inverse of :func:`shard_model`: every parameter whole on every
    rank (a collective), the groups unbound.  In place."""
    for name, p in list(model.named_parameters()):
        t = whole_of(model, name, p.detach())
        _replace(model, name, t.contiguous().clone(), p.requires_grad)
    _bind(model, None, {})
    return model


def _replace(model, name: str, t: torch.Tensor, grad: bool) -> None:
    owner, _, attr = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    setattr(mod, attr, torch.nn.Parameter(t, requires_grad=grad))


def _bind(model, mg: Optional[ModelGroup], lay: Dict[str, Layout],
          dg: Optional[ModelGroup] = None,
          dd: Optional[Dict[str, int]] = None) -> None:
    dd = dict(dd or {})
    model.mg, model.layouts = mg, dict(lay)
    model.dg, model.data_dims = dg, dd
    model.vocab_mg = mg if lay.get("embed") is not None else None
    for name, mod in model.named_modules():
        mod.dg = dg
        mod.fsdp_dims = {leaf: dd[f"{name}.{leaf}" if name else leaf]
                         for leaf, _ in mod.named_parameters(recurse=False)
                         if (f"{name}.{leaf}" if name else leaf) in dd}
        if not name:
            continue
        mode = _check_layer(name, mod, lay) if mg is not None else None
        mod.mg = mg if mode is not None else None
        mod.tp_mode = mode
        mod.mesh_mg = mg           # the group, whatever the layer's mode
        mod.split_leaves = tuple(
            leaf for leaf in _SPLIT_WHEN_WHOLE
            if mode is not None and hasattr(mod, leaf)
            and lay.get(f"{name}.{leaf}") is None)


def local_of(mod, leaf: str) -> torch.Tensor:
    """A layer's leaf as its rank uses it: its own slice of a leaf the
    rules keep whole (:func:`split`), else the parameter."""
    t = getattr(mod, leaf)
    if leaf in getattr(mod, "split_leaves", ()):
        return split(t, 0, mod.mg)
    return t
