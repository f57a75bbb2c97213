"""AdamW with a cosine schedule and global-norm clipping; the port of
``repro/train/optimizer.py`` (ZeRO-1's sharded Adam, on flat moments, is
in ``train/step.py``).

The formulas and their order of operations are the reference's.  The
clip and the update run leaf by leaf and in place (``mul_``, ``add_``,
``addcmul_``) with one scratch the size of the largest leaf: at
phi4-mini's full width separate temporaries for the embedding's moments,
update and decay would take about 10 GB more.  The update consumes the
gradients (it writes its step into them).

Weight decay follows the reference's rule, ``p.ndim >= 2``, on the rank
of the reference's leaf: its per-layer leaves are stacked with a leading
layer axis, so every layer's parameter decays there, the ``(d,)`` norms,
``lam``, ``D``, ``dt_bias`` and ``conv_b`` included, and only
``final_norm`` does not (``models.transformer.stacked_rank``).  The port
reproduces that quirk.

A bf16 state (the reference's ``BF16_STATE_ARCHS``: every parameter and
both moments bf16 at step 0) follows the reference's dtype sequence, op
by op: the norm in f32; the clip as ``g.f32 * scale`` rounded once to the
gradient's dtype; ``b1 * m`` (and ``b2 * v``) in the moment's own dtype,
its constant rounded to it, then promoted by the f32 ``(1 - b1) * g``, so
that the moments come back f32 from step 1 on; ``wd * p`` in the
parameter's dtype; ``p - lr (upd + decay)`` in f32, then cast to the
parameter's dtype.  An all-f32 leaf takes the in-place path above,
unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional

import torch

from ..models.transformer import stacked_rank

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(step: torch.Tensor, oc: OptimizerConfig) -> torch.Tensor:
    """Linear warm-up to ``lr``, then a cosine to ``min_lr`` over
    ``decay_steps``: an f32 scalar on the step's device."""
    step = step.to(F32)
    warm = oc.lr * step / max(oc.warmup_steps, 1)
    t = torch.clamp((step - oc.warmup_steps) / max(oc.decay_steps, 1),
                    0.0, 1.0)
    cos = oc.min_lr + 0.5 * (oc.lr - oc.min_lr) * (1 + torch.cos(math.pi * t))
    return torch.where(step < oc.warmup_steps, warm, cos)


def make_scratch(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    """An f32 buffer the size of the largest leaf, on their device."""
    leaves = list(leaves)
    n = max(t.numel() for t in leaves)
    return torch.empty(n, dtype=F32, device=leaves[0].device)


def _like(scratch: Optional[torch.Tensor], t: torch.Tensor) -> torch.Tensor:
    if scratch is None:
        return torch.empty_like(t, dtype=F32)
    return scratch[:t.numel()].view(t.shape)


def global_norm(leaves: Iterable[torch.Tensor],
                scratch: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``sqrt`` of the summed squares of every leaf, in f32 (each leaf
    squared into ``scratch`` when given)."""
    total = None
    for t in leaves:
        t = t.to(F32)
        s = torch.mul(t, t, out=_like(scratch, t)).sum()
        total = s if total is None else total + s
    return torch.sqrt(total)


@torch.no_grad()
def scale_grads(grads: Dict[str, torch.Tensor], norm: torch.Tensor,
                max_norm: float) -> None:
    """Scale every gradient, in place, by ``min(1, max_norm / norm)``
    (a gradient of another dtype than f32: ``g.f32 * scale`` rounded
    once to it)."""
    scale = torch.clamp(torch.div(norm.new_tensor(max_norm),
                                  torch.clamp_min(norm, 1e-12)), max=1.0)
    for t in grads.values():
        if t.dtype == F32:
            t.mul_(scale)
        else:
            t.copy_(t.to(F32).mul_(scale))


@torch.no_grad()
def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float,
                        scratch: Optional[torch.Tensor] = None):
    """Scale every gradient, in place, by ``min(1, max_norm / norm)``;
    returns ``(grads, norm)``, the norm before the clip."""
    g = global_norm(grads.values(), scratch)
    scale_grads(grads, g, max_norm)
    return grads, g


def adam_consts(step: torch.Tensor, oc: OptimizerConfig):
    """``(lr, bc1, bc2)`` of the step: the learning rate and the bias
    corrections ``1 - b ** (step + 1)``, f32 scalars."""
    lr = schedule(step, oc)
    t = step.to(F32) + 1.0
    return lr, 1.0 - oc.b1 ** t, 1.0 - oc.b2 ** t


@torch.no_grad()
def adamw_leaf(name: str, p: torch.Tensor, g: torch.Tensor,
               m: torch.Tensor, v: torch.Tensor, s: torch.Tensor,
               oc: OptimizerConfig, consts):
    """:func:`adamw_update` of one leaf ``p`` (updated in place; ``g``
    overwritten; ``s`` an f32 scratch of its shape).  Returns its new
    moments: ``m`` and ``v`` themselves on the all-f32 path, new f32
    tensors on the mixed one."""
    lr, bc1, bc2 = consts
    if not all(x.dtype == F32 for x in (p, g, m, v)):
        return _mixed_step(name, p, g, m, v, s, oc, lr, bc1, bc2)
    m.mul_(oc.b1).add_(g, alpha=1 - oc.b1)
    v.mul_(oc.b2).addcmul_(g, g, value=1 - oc.b2)
    torch.div(v, bc2, out=s).sqrt_().add_(oc.eps)
    upd = torch.div(m, bc1, out=g).div_(s)
    if stacked_rank(name, p) >= 2:
        upd.add_(p, alpha=oc.weight_decay)
    p.sub_(upd.mul_(lr))
    return m, v


@torch.no_grad()
def adamw_update(params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], mu: Dict[str, torch.Tensor],
                 nu: Dict[str, torch.Tensor], step: torch.Tensor,
                 oc: OptimizerConfig, scratch: Optional[torch.Tensor] = None):
    """One AdamW step over ``params`` (name -> tensor), in place:
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g g``, ``p -= lr
    ((m / bc1) / (sqrt(v / bc2) + eps) + wd p)``, the decay only where
    the reference's leaf has rank >= 2.  ``grads`` are overwritten.  A
    leaf with a bf16 parameter, gradient or moment takes the reference's
    mixed sequence (module docstring), and its new f32 moments replace
    the entries of ``mu`` and ``nu``.  Returns ``(params, mu, nu, lr)``."""
    consts = adam_consts(step, oc)
    for name, p in params.items():
        mu[name], nu[name] = adamw_leaf(name, p, grads[name], mu[name],
                                        nu[name], _like(scratch, p), oc,
                                        consts)
    return params, mu, nu, consts[0]


def _const(x: float, like: torch.Tensor) -> torch.Tensor:
    """The constant ``x`` rounded to ``like``'s dtype, as the reference's
    weakly typed Python float takes the dtype of the array it meets."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _widened(m: torch.Tensor, b: float) -> torch.Tensor:
    """``b * m`` in ``m``'s dtype, then f32 (in place for an f32 ``m``)."""
    if m.dtype == F32:
        return m.mul_(b)
    return torch.mul(m, _const(b, m)).to(F32)


def _mixed_step(name, p, g, m, v, s, oc, lr, bc1, bc2):
    """:func:`adamw_update` of one leaf in the reference's mixed dtype
    sequence; ``s`` is an f32 scratch of ``p``'s shape.  Returns the new
    f32 moments."""
    g32 = g.to(F32)
    m2 = _widened(m, oc.b1)
    m2.add_(torch.mul(g32, 1 - oc.b1, out=s))
    v2 = _widened(v, oc.b2)
    v2.add_(torch.mul(g32, 1 - oc.b2, out=s).mul_(g32))
    torch.div(v2, bc2, out=s).sqrt_().add_(oc.eps)
    upd = torch.div(m2, bc1, out=g32).div_(s)
    if stacked_rank(name, p) >= 2:
        upd.add_(torch.mul(p, _const(oc.weight_decay, p)).to(F32))
    upd.mul_(lr)
    if p.dtype == F32:
        p.sub_(upd)
    else:
        p.copy_(torch.sub(p, upd, out=s))
    return m2, v2
