"""train_step factories: loss -> grads -> clip -> (optional compression) ->
AdamW; the port of ``repro/train/step.py``.

Gradients come from ``loss.backward()`` into each parameter's ``.grad``
(f32 for f32 master weights; a bf16 state, the reference's
``BF16_STATE_ARCHS``, has bf16 gradients and hands them to the
optimizer's mixed sequence, ``train/optimizer.py``).  With
``accum_steps > 1`` the batch splits into ``(accum,
B/accum)`` as the reference's does, each microbatch's backward adds its
gradients to the last (the reference's running sum), and the summed loss
and gradients are scaled by ``1/accum``.

:func:`make_train_step` is the single-card step; with a ``mesh`` it is
the reference's GSPMD step on a mesh (:func:`_mesh_train_step`): the
state
placed by the sharding rules, the weights sharded over the data axes too
where ``shard_model(..., fsdp=True)`` sharded them (FSDP,
``distributed/fsdp.py``), the batch split over the data axes, the
moments ZeRO-1's.
:func:`make_local_accum_train_step` is the reference's shard_map step
over the data axes of a ``DeviceMesh``: every rank takes the global batch,
computes on its rows of dim 0, accumulates its raw gradients over the
microbatches and reduces once a step (an f32 all-reduce, or the int8
``compressed_allreduce``); with ``zero1`` it reduce-scatters instead, runs
Adam on its ``1/n`` shard against the flat moments of
:func:`make_zero1_local_state` and all-gathers the update.

The reference's leaf is the stacked one (``models.transformer.
reference_paths``): a ZeRO-1 shard of ``seg0.sub0.mlp.w_in`` spans layer
boundaries, and the int8 scale is one per stacked leaf.  So both gather a
leaf's per-layer gradients into one flat buffer in stacked order (each
layer's ``.grad`` freed as it is copied) before they quantize or scatter.

On a ``("data", "model")`` mesh with a model axis > 1 the model is one
that ``distributed.tensor_parallel.shard_model`` has sharded: each rank
runs the tensor-parallel forward and backward on its shard and the
gradients are reduced over the data axes alone.  The f32 all-reduce is
elementwise, so it reduces each rank's shard as it is.  The int8
all-reduce and ZeRO-1 work on the reference's *logical* leaf (one scale a
leaf, a flat split into ``n`` segments), so per leaf they gather the
sharded gradient over ``"model"`` first, run the reduction unchanged and
keep the rank's slice: the payloads stay bitwise the reference's, at the
cost of one whole leaf held at a time.  The gradient norm counts each
logical element once (the sharded leaves' squares summed over the model
group, the whole ones taken once).  ZeRO-1 keeps the reference's moment
layout, ``(n_dp, ceil(P / (n_dp tp)) tp)`` split over ``("data",
"model")``: a rank updates its ``1 / tp`` of its data shard against its
block of the moments, and the updated shard is gathered over both axes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from ..distributed.collectives import (all_gather_flat, axis_group,
                                       mesh_device, reduce_scatter)
from ..distributed import fsdp
from ..distributed import tensor_parallel as tpar
from ..distributed.compression import compress_with_feedback, int8_allreduce_
from ..distributed.sharding import dp_axes, mesh_axes, whole_shape
from ..models.transformer import loss_fn, reference_paths, stacked_rank
from .optimizer import (OptimizerConfig, adam_consts, adamw_leaf,
                        adamw_update, clip_by_global_norm, make_scratch,
                        scale_grads, schedule)
from .state import TrainState

F32 = torch.float32


def _backward(model, batch, cfg, remat_policy, accum_steps: int,
              sums=None):
    """The loss summed over ``accum_steps`` microbatches of ``batch``
    (detached), with the summed gradients in each parameter's ``.grad``;
    with ``sums`` (a dict), a parameter that is not f32 hands each
    microbatch's gradient to ``sums[name]`` instead, where they add up in
    f32 (the reference's scan sums into an f32 accumulator)."""
    model.zero_grad(set_to_none=True)
    if accum_steps == 1:
        loss = loss_fn(model, batch, cfg, remat_policy)
        loss.backward()
        return loss.detach()
    b = next(iter(batch.values())).shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into "
                         f"{accum_steps} microbatches")
    micro = {k: v.reshape((accum_steps, b // accum_steps)
                          + tuple(v.shape[1:]))
             for k, v in batch.items()}
    loss = None
    for i in range(accum_steps):
        li = loss_fn(model, {k: v[i] for k, v in micro.items()}, cfg,
                     remat_policy)
        li.backward()
        loss = li.detach() if loss is None else loss + li.detach()
        if sums is not None:
            for name, p in model.named_parameters():
                if p.dtype != F32:
                    g, p.grad = p.grad, None
                    sums[name] = g.to(F32) if name not in sums \
                        else sums[name].add_(g)
    return loss


def make_train_step(cfg, oc: OptimizerConfig, *,
                    remat_policy: Optional[str] = "full",
                    compression: bool = False, accum_steps: int = 1,
                    mesh=None):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the
    model, moments and error buffer are updated in place and the step
    advances; ``metrics`` holds ``loss``, ``grad_norm`` (before the clip)
    and ``lr``, f32 scalars on the model's device.  With ``mesh``, the
    reference's GSPMD step on a model ``shard_model`` sharded over it
    (:func:`_mesh_train_step`)."""
    if mesh is not None:
        if compression:
            raise ValueError("the step on a mesh has no compression: use "
                             "make_local_accum_train_step's int8 mode")
        return _mesh_train_step(cfg, oc, mesh, remat_policy=remat_policy,
                                accum_steps=accum_steps)

    def train_step(state: TrainState, batch):
        model = state.params
        dev = state.step.device
        batch = {k: v.to(dev) for k, v in batch.items()}
        sums = {} if accum_steps > 1 else None
        loss = _backward(model, batch, cfg, remat_policy, accum_steps, sums)
        grads = {n: p.grad if p.grad is not None else sums[n]
                 for n, p in model.named_parameters()}
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            loss = loss * inv
            for g in grads.values():
                g.mul_(inv)
        scratch = make_scratch(grads.values())
        grads, gnorm = clip_by_global_norm(grads, oc.clip_norm, scratch)
        error = state.error
        if compression:
            grads, error = compress_with_feedback(grads, error)
        params = dict(model.named_parameters())
        _, mu, nu, lr = adamw_update(params, grads, state.mu, state.nu,
                                     state.step, oc, scratch)
        del grads, scratch
        model.zero_grad(set_to_none=True)
        new_state = TrainState(state.step + 1, model, mu, nu, error)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


# ---- the reference's leaves ----------------------------------------------------

Members = List[Tuple[str, torch.Tensor]]


def reference_leaves(model) -> Dict[str, Members]:
    """Each leaf of the reference's params pytree, in its flatten order
    (sorted paths) -> its ``(name, parameter)`` members in stacked
    order."""
    paths = reference_paths(model)
    found: Dict[str, list] = {}
    for name, p in model.named_parameters():
        path, j = paths[name]
        found.setdefault(path, []).append((0 if j is None else j, name, p))
    return {path: [(n, p) for _, n, p in sorted(found[path],
                                                key=lambda t: t[0])]
            for path in sorted(found)}


def _logical(model, name: str, t: torch.Tensor) -> torch.Tensor:
    """The whole value of parameter ``name``'s piece ``t`` (its gradient
    or itself): gathered over the model group where it is sharded."""
    return tpar.whole(t, getattr(model, "layouts", {}).get(name),
                      getattr(model, "mg", None))


def _flat_grads(members: Members, size: int, model=None) -> torch.Tensor:
    """The members' whole gradients in stacked order in one f32 buffer of
    ``size`` (zero past their end); each ``.grad`` is freed once it is
    copied."""
    p0 = members[0][1]
    flat = torch.empty(size, dtype=F32, device=p0.device)
    off = 0
    for name, p in members:
        g = _logical(model, name, p.grad) if model is not None else p.grad
        k = g.numel()
        flat[off:off + k].copy_(g.reshape(-1))
        p.grad = None
        off += k
    flat[off:].zero_()
    return flat


def _unflatten(members: Members, flat: torch.Tensor, model, grad: bool):
    """Each member's piece of the whole values ``flat`` (stacked order)
    into its ``.grad`` (``grad``) or the parameter itself."""
    mg = getattr(model, "mg", None)
    lay = getattr(model, "layouts", {})
    off = 0
    for name, p in members:
        shape = whole_shape(model, name)
        k = math.prod(shape)
        t = flat[off:off + k].view(shape)
        if mg is not None:
            t = tpar.take(t, lay.get(name), mg.rank, mg.size)
        if grad:
            p.grad = t if mg is None else t.contiguous()
        else:
            p.copy_(t)
        off += k


def _leaf_size(members: Members, model=None) -> int:
    if model is None:
        return sum(p.numel() for _, p in members)
    return sum(math.prod(whole_shape(model, n)) for n, _ in members)


def int8_reduce_leaf_(model, members: Members, groups, factor: float) -> None:
    """One reference leaf's gradients (``members``, stacked order) times
    ``factor``, int8-all-reduced over each data group in turn on the whole
    leaf (gathered over the model group on a sharded model), each
    member's piece written back into its ``.grad``."""
    tp_model = model if getattr(model, "mg", None) is not None else None
    size = _leaf_size(members, tp_model)
    padded = [-(-size // g.size()) * g.size() for g in groups]
    flat = _flat_grads(members, max(padded), tp_model).mul_(factor)
    for g, length in zip(groups, padded):
        int8_allreduce_(flat[:length], g)          # padded to its own n
    _unflatten(members, flat, model, grad=True)


def _grad_norm(model, mg, grads=None, dg=None) -> torch.Tensor:
    """The global norm of the model's gradients (``grads`` by name, else
    each ``.grad``), each logical element counted once: the squares of
    the leaves split over the model group summed over it, of those split
    over the data group (FSDP) over that, the whole ones (equal on every
    rank) added once."""
    lay = getattr(model, "layouts", {})
    dd = getattr(model, "data_dims", {})
    sums: Dict[Tuple[bool, bool], torch.Tensor] = {}
    for name, p in model.named_parameters():
        g = (p.grad if grads is None else grads[name]).to(F32)
        key = (dg is not None and name in dd, lay.get(name) is not None)
        sq = torch.sum(g * g)
        sums[key] = sq if key not in sums else sums[key] + sq
    total = None
    for (over_data, over_model) in sorted(sums):
        sq = sums[(over_data, over_model)]
        if over_data:
            dist.all_reduce(sq, group=dg.group)
        if over_model and mg is not None:
            dist.all_reduce(sq, group=mg.group)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


# ---- the data-parallel step ----------------------------------------------------

def make_local_accum_train_step(cfg, oc: OptimizerConfig, mesh, *,
                                remat_policy: Optional[str] = "full",
                                accum_steps: int = 1,
                                int8_allreduce: bool = False,
                                zero1: bool = False,
                                batch_axes=("data",)):
    """Returns ``train_step(state, batch) -> (state, metrics)`` for this
    rank of ``mesh``: one gradient reduction a step over the mesh's
    ``batch_axes`` (module docstring).  ``batch`` is the global batch;
    the rank's rows of dim 0 are its shard (the first axis major).  The
    parameters stay replicated, bitwise equal on every rank.  With
    ``zero1`` (one data axis) the state's moments are those of
    :func:`make_zero1_local_state`.  On a model that ``shard_model(...,
    fsdp=True)`` sharded, the step gathers the parameters' pieces whole
    over the data group at entry (and the moments', but ZeRO-1's), runs
    as on an unsharded model and keeps the pieces of the new state: the
    reference's ``shard_map`` takes them whole (``in_specs`` ``P()``).
    ``metrics``: the loss averaged over the ranks, the gradient norm
    before the clip, the learning rate."""
    axes = mesh_axes(mesh)
    mg = tpar.model_group(mesh)
    manual = tuple(a for a in batch_axes if a in axes)
    if not manual:
        raise ValueError(f"the mesh {tuple(axes)} has none of the batch "
                         f"axes {tuple(batch_axes)}")
    if zero1 and len(manual) != 1:
        raise NotImplementedError("zero1 local step: single DP axis for now")
    groups = [axis_group(mesh, a) for a in manual]
    n = math.prod(size for _, size, _ in groups)
    shard = 0
    for _, size, k in groups:
        shard = shard * size + k
    group0, n0, k0 = groups[0]

    def pmean(x):
        for g, size, _ in groups:
            dist.all_reduce(x, group=g)
            x = x / size
        return x

    def reduce_replicated(model, inv):
        """The f32 all-reduce (or the int8 one) of every gradient over the
        data axes, scaled by ``inv / n`` first; the reduced gradients by
        parameter name (this rank's shards)."""
        if not int8_allreduce:
            for p in model.parameters():
                p.grad.mul_(inv / n)
                for g, _, _ in groups:
                    dist.all_reduce(p.grad, group=g)
            return {name: p.grad for name, p in model.named_parameters()}
        for members in reference_leaves(model).values():
            int8_reduce_leaf_(model, members, [g for g, _, _ in groups],
                              inv / n)
        return {name: p.grad for name, p in model.named_parameters()}

    def zero1_update(state, inv):
        """Reduce-scatter, clip and Adam on this rank's shard of each
        leaf (its ``1 / tp`` of the data shard under a model group), then
        all-gather the updated shard into the parameters.  Returns
        ``(grad_norm, lr)``."""
        model = state.params
        tp_model = model if mg is not None else None
        tp, j = (mg.size, mg.rank) if mg is not None else (1, 0)
        leaves = reference_leaves(model)
        gshard = {}
        for path, members in leaves.items():
            c = -(-_leaf_size(members, tp_model) // n0)
            flat = _flat_grads(members, n0 * c, tp_model).mul_(inv)
            out = torch.empty(c, dtype=F32, device=flat.device)
            reduce_scatter(out, flat, group0)
            del flat
            gshard[path] = out.div_(n0)
        sq = sum(torch.sum(g * g) for g in gshard.values())
        dist.all_reduce(sq, group=group0)
        gnorm = torch.sqrt(sq)
        scale = torch.clamp(torch.div(gnorm.new_tensor(oc.clip_norm),
                                      torch.clamp_min(gnorm, 1e-12)), max=1.0)
        lr = schedule(state.step, oc)
        t = state.step.to(F32) + 1.0
        bc1 = 1.0 - oc.b1 ** t
        bc2 = 1.0 - oc.b2 ** t
        for path, members in leaves.items():
            g = gshard.pop(path).mul_(scale)
            m, v = _local_row(state.mu[path], k0), _local_row(state.nu[path],
                                                               k0)
            c = g.numel()
            if m.numel() * tp != c:
                raise ValueError(f"zero1 moments of {path} hold "
                                 f"{m.numel() * tp} elements a data rank, "
                                 f"its gradient shard {c}")
            cm = c // tp
            g = g[j * cm:(j + 1) * cm]
            m.mul_(oc.b1).add_(g, alpha=1 - oc.b1)
            v.mul_(oc.b2).addcmul_(g, g, value=1 - oc.b2)
            gathered = torch.empty(n0 * c, dtype=F32, device=g.device)
            pshard = gathered[k0 * c + j * cm:k0 * c + (j + 1) * cm]
            _copy_span(members, k0 * c + j * cm, pshard, tp_model)
            s = torch.div(v, bc2).sqrt_().add_(oc.eps)
            u = torch.div(m, bc1, out=g).div_(s)
            del s
            if stacked_rank(*members[0]) >= 2:
                u.add_(pshard, alpha=oc.weight_decay)
            pshard.sub_(u.mul_(lr))
            del g, u
            mine = gathered[k0 * c:(k0 + 1) * c]
            if mg is not None:
                all_gather_flat(mine, pshard, mg.group)
            all_gather_flat(gathered, mine, group0)
            _unflatten(members, gathered, model, grad=False)
            del gathered, pshard, mine
        return gnorm, lr

    def local_step(state: TrainState, batch):
        model = state.params
        dev = state.step.device
        have = getattr(model, "mg", None)
        if mg is not None and (have is None or have.group is not mg.group):
            raise ValueError(f"a mesh with a 'model' axis of {mg.size} "
                             f"needs a model that tensor_parallel."
                             f"shard_model has sharded over it")
        b = next(iter(batch.values())).shape[0]
        if b % n:
            raise ValueError(f"global batch {b} does not split over "
                             f"{n} data-parallel ranks")
        rows = slice(shard * (b // n), (shard + 1) * (b // n))
        mine = {k: v[rows].to(dev) for k, v in batch.items()}
        loss = _backward(model, mine, cfg, remat_policy, accum_steps)
        inv = 1.0 / accum_steps
        loss = pmean(loss * inv)
        with torch.no_grad():
            if zero1:
                gnorm, lr = zero1_update(state, inv)
                mu, nu = state.mu, state.nu
            else:
                grads = reduce_replicated(model, inv)
                scratch = make_scratch(grads.values())
                if mg is None:
                    grads, gnorm = clip_by_global_norm(grads, oc.clip_norm,
                                                       scratch)
                else:
                    gnorm = _grad_norm(model, mg)
                    scale_grads(grads, gnorm, oc.clip_norm)
                _, mu, nu, lr = adamw_update(
                    dict(model.named_parameters()), grads, state.mu,
                    state.nu, state.step, oc, scratch)
                del grads, scratch
        model.zero_grad(set_to_none=True)
        new_state = TrainState(state.step + 1, model, mu, nu, state.error)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    def train_step(state: TrainState, batch):
        model = state.params
        if getattr(model, "dg", None) is None:
            return local_step(state, batch)
        # FSDP: the reference's shard_map takes the parameters (and, but
        # for ZeRO-1's own layout, the moments) whole over the data axes
        held, moments = fsdp.unshard(model, () if zero1 else
                                     (state.mu, state.nu))
        mu, nu = (state.mu, state.nu) if zero1 else moments
        new, metrics = local_step(
            TrainState(state.step, model, mu, nu, state.error), batch)
        cut = fsdp.reshard(model, held, () if zero1 else (new.mu, new.nu))
        mu, nu = (new.mu, new.nu) if zero1 else cut
        return TrainState(new.step, model, mu, nu, new.error), metrics

    return train_step


def _local_row(t: torch.Tensor, k: int) -> torch.Tensor:
    """This rank's row of a ZeRO-1 moment: a ``DTensor``'s local row, or
    row ``k`` of a whole tensor."""
    to_local = getattr(t, "to_local", None)
    return to_local()[0] if to_local is not None else t[k]


def _copy_span(members: Members, start: int, out: torch.Tensor,
               model=None) -> None:
    """``out`` := elements ``[start, start + len(out))`` of the members'
    whole parameters flattened in stacked order (zero past their end)."""
    end, off, pos = start + out.numel(), 0, 0
    for name, p in members:
        w = p.detach() if model is None else _logical(model, name, p.detach())
        k = w.numel()
        lo, hi = max(start, off), min(end, off + k)
        if lo < hi:
            out[pos:pos + hi - lo].copy_(w.reshape(-1)[lo - off:hi - off])
            pos += hi - lo
        off += k
    out[pos:].zero_()


# ---- ZeRO-1's state ------------------------------------------------------------

def make_zero1_local_state(model, n_dp: int, tp: int = 1, *,
                           mesh=None) -> TrainState:
    """The state :func:`make_local_accum_train_step` consumes with
    ``zero1``: the model and, per reference leaf (keyed by its path), flat
    zero moments of shape ``(n_dp, size / n_dp)``, ``size`` the leaf's
    element count rounded up to a multiple of ``n_dp * tp`` (the
    reference's layout).  With ``mesh`` each moment is a ``DTensor``
    sharded over ``"data"`` on dim 0 and, where ``tp > 1``, over
    ``"model"`` on dim 1 (the reference's ``("data", "model")`` layout),
    and a rank holds its block alone; without, whole tensors on the
    model's device.  A sharded model's leaves count whole."""
    dev = next(model.parameters()).device
    tp_model = model if (getattr(model, "mg", None) is not None or
                         getattr(model, "dg", None) is not None) else None
    if mesh is not None:
        from torch.distributed.tensor import DTensor, Replicate, Shard
        axes = mesh_axes(mesh)
        if axes.get("data") != n_dp or axes.get("model", 1) != tp:
            raise ValueError(f"n_dp={n_dp}, tp={tp} but the mesh has "
                             f"{axes}")
        placements = [Shard(0) if a == "data" else
                      Shard(1) if a == "model" and tp > 1 else Replicate()
                      for a in axes]
        dev = mesh_device(mesh)

    def flat(members):
        size = -(-_leaf_size(members, tp_model) // (n_dp * tp)) * (n_dp * tp)
        c = size // n_dp
        if mesh is None:
            return torch.zeros((n_dp, c), dtype=F32, device=dev)
        return DTensor.from_local(torch.zeros((1, c // tp), dtype=F32,
                                              device=dev),
                                  mesh, placements, run_check=False,
                                  shape=(n_dp, c), stride=(c, 1))

    leaves = reference_leaves(model)
    step = torch.zeros((), dtype=torch.int32, device=dev)
    return TrainState(step, model, {k: flat(m) for k, m in leaves.items()},
                      {k: flat(m) for k, m in leaves.items()}, None)


def abstract_zero1_local_state(cfg, n_dp: int, tp: int = 1) -> TrainState:
    """:func:`make_zero1_local_state`'s shapes on the ``meta`` device,
    the heads padded at ``tp``."""
    from .state import abstract_state
    return make_zero1_local_state(abstract_state(cfg, tp=tp).params, n_dp,
                                  tp)


# ---- the GSPMD step on a mesh ----------------------------------------------------

def _reduced(g: torch.Tensor, dg) -> torch.Tensor:
    """``g`` summed over the data group in f32, in its own dtype (in
    place for f32)."""
    t = g.to(F32)
    dist.all_reduce(t, group=dg.group)
    return t.to(g.dtype)


def _moment_dim(m, mesh, data_dim: Optional[int]) -> Optional[int]:
    """The dim a ``DTensor`` moment splits over the data axes that its
    parameter's piece does not (ZeRO-1's slice); None for a plain tensor
    (the parameter's piece) and where there is none."""
    if not hasattr(m, "to_local"):
        return None
    data = dp_axes(mesh_axes(mesh))
    dims = {pl.dim for a, pl in zip(mesh.mesh_dim_names, m.placements)
            if a in data and pl.is_shard()}
    dims.discard(data_dim)
    if len(dims) > 1:
        raise ValueError(f"a moment split over the data axes on dims {dims}")
    return dims.pop() if dims else None


def _placed_like(new: torch.Tensor, old):
    """A moment's new local tensor ``new`` in the ``DTensor`` placement of
    ``old`` (``new`` itself where ``old`` is a plain tensor)."""
    if not hasattr(old, "to_local"):
        return new
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(new, old.device_mesh, old.placements,
                              run_check=False, shape=old.shape,
                              stride=old.stride())


def _mesh_train_step(cfg, oc: OptimizerConfig, mesh, *,
                     remat_policy: Optional[str] = "full",
                     accum_steps: int = 1):
    """The reference's GSPMD ``make_train_step`` (``jax.jit`` with the
    state placed by ``param_shardings`` / ``moment_shardings``) on this
    rank of ``mesh``, for a model that ``tensor_parallel.shard_model``
    sharded over it (``fsdp`` or not) and a state of
    ``train.state.init_state(model, mesh=mesh)`` (or restored by
    ``reshard_restore``).  ``batch`` is the global batch.

    * The batch splits into microbatches ``(accum, B / accum)``, and this
      rank takes its rows of each by ``sharding.batch_axes``; its MoE
      layers route over the global token order (``fsdp.rows_over``).
    * Each microbatch's loss is this rank's mean over its rows, scaled by
      ``1 / n`` (``n`` the ranks of the data axes) before the backward: the
      FSDP leaves' gradients are reduce-scattered into their pieces in the
      backward, the others all-reduced after it, so each microbatch's
      gradient is the global batch's in the parameter's dtype, and they
      add up in f32 over the microbatches, as the reference's scan does.
    * The gradient norm counts each logical element once; the clip and
      AdamW run on the pieces: an FSDP leaf against its piece's moments,
      another leaf against ZeRO-1's slice of its moments, after which the
      new slices are all-gathered over the data axes.  A leaf the model
      axis holds in halves (the recurrent kinds' ``in_proj``) is taken to
      its moments' contiguous layout and back.
    * The state keeps its placements; the moments of a bf16 state turn
      f32 after the first step (``train/optimizer.py``).

    ``metrics``: the loss averaged over the data ranks, the gradient norm
    before the clip, the learning rate."""
    from ..distributed.sharding import batch_axes
    axes = mesh_axes(mesh)
    mg = tpar.model_group(mesh)
    dg = fsdp.data_group(mesh)
    n_dp = dg.size if dg is not None else 1
    data_size = math.prod(axes[a] for a in dp_axes(axes) if a in axes)

    def check(model):
        have_mg = getattr(model, "mg", None)
        if (mg is None) != (have_mg is None) or (
                mg is not None and have_mg.group is not mg.group):
            raise ValueError("the model is not sharded over this mesh's "
                             "'model' axis (tensor_parallel.shard_model)")
        have_dg = getattr(model, "dg", None)
        if have_dg is not None and (dg is None or have_dg.group
                                    is not dg.group):
            raise ValueError("the model is sharded over another mesh's data "
                             "axes")

    def rows(batch):
        """This rank's rows of each microbatch: ``(micro, n_b, k)``."""
        b = next(iter(batch.values())).shape[0]
        if b % accum_steps:
            raise ValueError(f"batch {b} does not split into "
                             f"{accum_steps} microbatches")
        mb = b // accum_steps
        ba = batch_axes(axes, b)
        n_b = math.prod(axes[a] for a in ba) if ba else 1
        if n_b not in (1, data_size):
            raise NotImplementedError(f"a batch of {b} splits over {ba} "
                                      f"alone, not every data axis")
        if mb % n_b:
            raise ValueError(f"microbatch {mb} does not split over {n_b} "
                             f"data-parallel ranks")
        micro = {k: v.reshape((accum_steps, mb) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        return micro, n_b, (dg.rank if n_b > 1 else 0)

    def backward(model, batch):
        """The microbatches' summed loss and each parameter's gradient of
        the global batch (f32 sums over microbatches where there are
        several)."""
        dev = next(model.parameters()).device
        micro, n_b, k = rows(batch)
        per = next(iter(micro.values())).shape[1] // n_b
        dd = getattr(model, "data_dims", {})
        grads: Dict[str, torch.Tensor] = {}
        loss = None
        model.zero_grad(set_to_none=True)
        with fsdp.rows_over(model, dg if n_b > 1 else None):
            for i in range(accum_steps):
                mine = {key: v[i, k * per:(k + 1) * per].to(dev)
                        for key, v in micro.items()}
                li = loss_fn(model, mine, cfg, remat_policy)
                (li * (1.0 / n_dp) if n_dp > 1 else li).backward()
                loss = li.detach() if loss is None else loss + li.detach()
                for name, p in model.named_parameters():
                    g, p.grad = p.grad, None
                    if dg is not None and name not in dd:
                        g = _reduced(g, dg)
                    if name not in grads:
                        grads[name] = g.to(F32) if accum_steps > 1 else g
                    else:
                        grads[name].add_(g)
        return loss, grads

    def update(model, grads, state):
        """Clip and AdamW on the pieces; returns ``(mu, nu, grad_norm,
        lr)``."""
        dd = getattr(model, "data_dims", {})
        lay = getattr(model, "layouts", {})
        gnorm = _grad_norm(model, mg, grads, dg)
        scale_grads(grads, gnorm, oc.clip_norm)
        consts = adam_consts(state.step, oc)
        mu, nu = dict(state.mu), dict(state.nu)
        for name, p in model.named_parameters():
            g = grads.pop(name)
            m, v = mu[name], nu[name]
            z = _moment_dim(m, mesh, dd.get(name)) if dg is not None \
                else None
            layout = lay.get(name)
            halves = (layout is not None and layout[0] == "halves"
                      and hasattr(m, "to_local"))
            flat = ("shard", layout[1]) if halves else None
            pp = p.detach()
            if halves:      # to the moments' contiguous layout
                g = tpar.take(tpar.whole(g, layout, mg), flat, mg.rank,
                              mg.size)
                pp = tpar.take(tpar.whole(pp, layout, mg), flat, mg.rank,
                               mg.size)
            if z is not None:
                g = g.chunk(n_dp, dim=z)[dg.rank]
                pp = pp.chunk(n_dp, dim=z)[dg.rank]
            if halves or z is not None:
                pp = pp.contiguous()
            g = g.contiguous()
            ml = m.to_local() if hasattr(m, "to_local") else m
            vl = v.to_local() if hasattr(v, "to_local") else v
            s = torch.empty(pp.shape, dtype=F32, device=pp.device)
            m2, v2 = adamw_leaf(name, pp, g, ml, vl, s, oc, consts)
            del g, s
            if m2 is not ml:
                mu[name] = _placed_like(m2, m)
            if v2 is not vl:
                nu[name] = _placed_like(v2, v)
            if z is not None:
                pp = fsdp.all_gather_dim(pp, z, dg)
            if halves:
                pp = tpar.take(tpar.whole(pp, flat, mg), layout, mg.rank,
                               mg.size)
            if halves or z is not None:
                p.detach().copy_(pp)
        return mu, nu, gnorm, consts[0]

    def train_step(state: TrainState, batch):
        model = state.params
        check(model)
        loss, grads = backward(model, batch)
        inv = 1.0 / accum_steps
        with torch.no_grad():
            if accum_steps > 1:
                loss = loss * inv
                for g in grads.values():
                    g.mul_(inv)
            if dg is not None:
                dist.all_reduce(loss, group=dg.group)
                loss = loss / n_dp
            mu, nu, gnorm, lr = update(model, grads, state)
        new_state = TrainState(state.step + 1, model, mu, nu, None)
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step
