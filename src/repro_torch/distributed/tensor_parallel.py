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
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

BF16 = torch.bfloat16
F32 = torch.float32
FSDP_LATER = ("FSDP execution (weights sharded over the data axes) is not "
              "ported: the local-accumulation step keeps parameters "
              "replicated over them")

Layout = Optional[Tuple[str, int]]


@dataclasses.dataclass(frozen=True, eq=False)
class ModelGroup:
    """The ranks of one row of a mesh's ``"model"`` axis: the process
    group, its size and this rank's index in it."""
    group: object
    size: int
    rank: int


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
    ``sharding.param_placements``."""
    from .sharding import param_placements
    if fsdp:
        raise NotImplementedError(FSDP_LATER)
    names = tuple(mesh.mesh_dim_names)
    if "model" not in names:
        return {n: None for n, _ in model.named_parameters()}
    at = names.index("model")
    out = {}
    for name, pl in param_placements(model, cfg, mesh, fsdp=False).items():
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
    ``mesh``'s ``"model"`` axis, and bind the model group to the model and
    its layers.  In place; returns the model.  A leaf the
    rules keep whole stays whole on every rank."""
    mg = model_group(mesh)
    lay = model_layouts(model, cfg, mesh, fsdp=fsdp)
    for name, p in list(model.named_parameters()):
        t = _piece(p.detach(), lay[name], mg, mesh)
        _replace(model, name, t.contiguous().clone(), p.requires_grad)
    _bind(model, mg, lay if mg is not None else {})
    return model


def _piece(t: torch.Tensor, layout: Layout, mg: Optional[ModelGroup],
           mesh) -> torch.Tensor:
    """This rank's piece under ``layout`` of a whole tensor or of a
    ``DTensor``: its local shard where that is the piece already
    (``Shard`` on the model axis, replicated elsewhere), else gathered
    whole and cut."""
    if hasattr(t, "to_local"):
        from torch.distributed.tensor import Replicate, Shard
        want = [Shard(layout[1]) if (a == "model" and layout is not None
                                     and layout[0] == "shard")
                else Replicate() for a in mesh.mesh_dim_names]
        if list(t.placements) == want and t.device_mesh == mesh:
            return t.to_local()
        t = t.full_tensor()
    return t if mg is None else take(t, layout, mg.rank, mg.size)


@torch.no_grad()
def gather_model(model):
    """The inverse of :func:`shard_model`: every parameter whole on every
    rank (a collective), the model group unbound.  In place."""
    mg, lay = getattr(model, "mg", None), getattr(model, "layouts", {})
    for name, p in list(model.named_parameters()):
        t = whole(p.detach(), lay.get(name), mg)
        _replace(model, name, t.contiguous().clone(), p.requires_grad)
    _bind(model, None, {})
    return model


def _replace(model, name: str, t: torch.Tensor, grad: bool) -> None:
    owner, _, attr = name.rpartition(".")
    mod = model.get_submodule(owner) if owner else model
    setattr(mod, attr, torch.nn.Parameter(t, requires_grad=grad))


def _bind(model, mg: Optional[ModelGroup], lay: Dict[str, Layout]) -> None:
    model.mg, model.layouts = mg, dict(lay)
    model.vocab_mg = mg if lay.get("embed") is not None else None
    for name, mod in model.named_modules():
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
