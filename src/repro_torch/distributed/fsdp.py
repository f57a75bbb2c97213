"""FSDP over the data axes of a ``DeviceMesh``: the weights sharded by
``sharding.param_placements(..., fsdp=True)``, which the reference leaves
to XLA's partitioner (``launch/dryrun.py``'s ``build_cell`` on a
``("data", "model")`` mesh), written out in PyTorch's idiom.

A rank keeps one piece of each leaf the rules split over the data axes
(``wq``'s ``d_model``, the embedding's ``d_model``, an MoE's ``d_model``;
the model axis keeps its own split, on another dim) and the whole of the
rest.  A layer reads its leaves whole, gathered at use: :func:`use` wraps
a module in a view whose data-sharded leaves are all-gathered over the
data group the first time the view reads them (:func:`leaf` for one
read).  The gather is an autograd region, Megatron's ``gather`` over the
data group: the forward all-gathers the pieces into the whole leaf (whole
over the data axes; over ``"model"`` it is still the rank's piece), the
backward reduce-scatters the whole gradient into the piece's ``.grad``
(the ranks' shares summed in f32 in rank order, then cast to the piece's
dtype).  A view lives for one layer's application: under the
checkpointed remat policies (``"full"`` by default) the whole leaves die
with the unit and the recompute gathers them again, so no gathered leaf
stays alive across layers.  Without remat autograd keeps each layer's
bf16 copy for the backward, as an unsharded model would.

The data group is the ranks that share a model index: one mesh dim, or
the data axes flattened (``("pod", "data")``, the pod major), as
``sharding.dp_axes`` names them.

The batch is split over the data axes (``sharding.batch_axes``) by the
steps that take a mesh.  Every layer kind but MoE works row by row; an
MoE forms its routing groups over the global token order, so where a
group would span ranks (a rank's tokens not a whole number of groups)
:func:`rows_over` has the layer gather its input rows over the group
(:func:`gather_rows`), route and run the global tokens on every rank and
keep its own rows: the groups, the capacities and the aux loss are the
reference's.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch
import torch.distributed as dist

from .collectives import reduce_scatter
from .sharding import dp_axes, mesh_axes
from .tensor_parallel import ModelGroup

F32 = torch.float32


def data_group(mesh) -> Optional[ModelGroup]:
    """The ranks of ``mesh``'s data axes that share this rank's place on
    the other axes: the group, its size and this rank's index in it;
    None where the data axes hold one rank."""
    names = tuple(mesh.mesh_dim_names)
    axes = tuple(a for a in dp_axes(mesh_axes(mesh)) if a in names)
    if not axes:
        return None
    if len(axes) == 1:
        sub = mesh[axes[0]]
    else:
        sub = mesh[axes]._flatten()
    group = sub.get_group()
    size = group.size()
    return ModelGroup(group, size, sub.get_local_rank()) if size > 1 \
        else None


def data_dims(model, cfg, mesh) -> Dict[str, Optional[int]]:
    """Each parameter's dim (of the port's per-layer tensor) that the
    rules split over the data axes at ``fsdp=True``; None for a leaf they
    keep whole there."""
    from .sharding import param_placements
    names = tuple(mesh.mesh_dim_names)
    at = [i for i, a in enumerate(names) if a in dp_axes(mesh_axes(mesh))]
    out = {}
    for name, pl in param_placements(model, cfg, mesh, fsdp=True).items():
        dims = {pl[i].dim for i in at if pl[i].is_shard()}
        if len(dims) > 1:
            raise ValueError(f"{name}: the data axes split dims {dims}")
        out[name] = dims.pop() if dims else None
    return out


# ---- the region --------------------------------------------------------------

def all_gather_dim(x: torch.Tensor, dim: int, dg: ModelGroup) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x) for _ in range(dg.size)]
    dist.all_gather(parts, x.detach().contiguous(), group=dg.group)
    return torch.cat(parts, dim=dim)


def reduce_scatter_dim(g: torch.Tensor, dim: int,
                       dg: ModelGroup) -> torch.Tensor:
    """This rank's slice along ``dim`` of the sum over the group of every
    rank's ``g``: summed in f32 (in rank order over gloo, whose
    ``all_to_all`` moves the shares in ``g``'s own dtype), cast to
    ``g``'s dtype."""
    flat = g.movedim(dim, 0).contiguous()
    shape = (flat.shape[0] // dg.size,) + tuple(flat.shape[1:])
    out = torch.empty(flat.numel() // dg.size, dtype=F32, device=g.device)
    if dist.get_backend(dg.group) == "nccl":
        reduce_scatter(out, flat.view(-1).to(F32), dg.group)
    else:
        parts = torch.empty_like(flat).view(dg.size, -1)
        dist.all_to_all_single(parts.view(-1), flat.view(-1), group=dg.group)
        out.copy_(parts[0])
        for j in range(1, dg.size):
            out.add_(parts[j])
        del parts
    return out.view(shape).movedim(0, dim).to(g.dtype).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, dg):
        ctx.dim, ctx.dg = dim, dg
        return all_gather_dim(x, dim, dg)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.dg), None, None


def _gather(x: torch.Tensor, dim: int, dg: ModelGroup) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _Gather.apply(x, dim, dg)
    return all_gather_dim(x, dim, dg)


def gather_leaf(piece: torch.Tensor, dim: int,
                dg: ModelGroup) -> torch.Tensor:
    """The whole leaf (over the data axes) from every rank's ``piece``;
    the backward reduce-scatters its gradient into the piece's."""
    return _gather(piece, dim, dg)


def leaf(mod, name: str) -> torch.Tensor:
    """Module ``mod``'s leaf ``name`` whole over the data axes: gathered
    where ``shard_model(..., fsdp=True)`` split it, else the attribute."""
    t = getattr(mod, name)
    dim = getattr(mod, "fsdp_dims", {}).get(name)
    return t if dim is None else gather_leaf(t, dim, mod.dg)


class _Whole:
    """A module read through its whole leaves: each data-sharded leaf is
    gathered once, on first read, and kept as long as the view; a child
    module reads as a view too; every other attribute is the module's."""

    __slots__ = ("_mod", "_got")

    def __init__(self, mod):
        object.__setattr__(self, "_mod", mod)
        object.__setattr__(self, "_got", {})

    def __getattr__(self, name):
        got = self._got
        if name not in got:
            mod = self._mod
            v = getattr(mod, name)
            if isinstance(v, torch.nn.Module):
                v = use(v)
            elif name in getattr(mod, "fsdp_dims", {}):
                v = gather_leaf(v, mod.fsdp_dims[name], mod.dg)
            elif name in type(mod).__dict__ and hasattr(v, "__func__"):
                # its methods see the view; not kept, which would make a
                # cycle that holds the gathered leaves until the collector
                return v.__func__.__get__(self)
            else:
                return v
            got[name] = v
        return got[name]


def use(mod):
    """``mod`` as a layer reads it: a view of whole leaves on a model
    that ``shard_model(..., fsdp=True)`` sharded, else ``mod`` itself."""
    if getattr(mod, "dg", None) is None:
        return mod
    return _Whole(mod)


# ---- rows ----------------------------------------------------------------------

def gather_rows(x: torch.Tensor, dg: ModelGroup) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0) in rank order, the global order
    of the batch; the backward sums the ranks' gradients of each row into
    its owner's."""
    return _gather(x, 0, dg)


def own_rows(x: torch.Tensor, dg: ModelGroup) -> torch.Tensor:
    """This rank's rows of the global ``x`` (dim 0)."""
    n = x.shape[0] // dg.size
    return x.narrow(0, dg.rank * n, n)


@contextlib.contextmanager
def rows_over(model, dg: Optional[ModelGroup]):
    """Within the block, the batch rows of ``model``'s forward are this
    rank's share over ``dg`` (None: the whole batch): its MoE layers route
    over the global token order."""
    if dg is None:
        yield
        return
    mods = [m for m in model.modules() if type(m).__name__ == "MoE"]
    for m in mods:
        m.rows = dg
    try:
        yield
    finally:
        for m in mods:
            m.rows = None
