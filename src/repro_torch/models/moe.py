"""Mixture-of-Experts layer (group-wise dispatch, Switch/GLaM style); the
port of ``repro/models/moe.py``.

Tokens are reshaped into groups of ``group_size`` (a ragged count is
zero-padded, and the padded rows are routed and claim capacity like any
other).  Each token's top-k experts are chosen one at a time by argmax; a
choice's position in its expert is its prefix rank within the group, the
k-th choices queuing behind all first choices, and a position at or past
the capacity drops the token from that expert.  Dispatch and combine are
the reference's one-hot ``(G, S, E, C)`` products: each output sums at
most one product (dispatch) or ``top_k`` products (combine) in f32, so
they equal a gather and a scatter.  The expert products are batched
matrix products over ``E``.

Under tensor parallelism (``distributed/tensor_parallel.py``) the experts
are split over the model group where ``tp`` divides ``E`` (expert
parallel: a rank runs its experts on the tokens dispatched to them and the
combine's f32 partial sums are reduced over the group), else each
expert's ``d_ff`` where ``tp`` divides it (column- and row-parallel, the
expert outputs reduced before the combine), else the layer runs whole.
The router and the capacity positions are computed on every rank from the
same replicated input and weights, so the routing is bitwise the same on
all of them.

Where a step splits the batch over the data axes (``distributed/
fsdp.py``) the groups are still the global token order's: a rank whose
rows are not a whole number of groups gathers the rows of the data group
first (:func:`moe_apply`).
"""
from __future__ import annotations

import math

import torch

from ..distributed import fsdp
from ..distributed import tensor_parallel as tpar
from .layers import BF16, F32, dense_init, param, silu


class MoE(torch.nn.Module):
    """``router (D, E)``, ``w_in``/``w_gate (E, D, F)``, ``w_out (E, F,
    D)``, all of the model's matrix dtype."""

    def __init__(self, cfg, *, device=None, dtype=BF16):
        super().__init__()
        d, m = cfg.d_model, cfg.moe
        self.router = param((d, m.num_experts), device, dtype)
        self.w_in = param((m.num_experts, d, m.d_ff), device, dtype)
        self.w_gate = param((m.num_experts, d, m.d_ff), device, dtype)
        self.w_out = param((m.num_experts, m.d_ff, d), device, dtype)

    def init_(self, g: torch.Generator) -> None:
        """The reference's scales (``1/sqrt(d)`` in, ``1/sqrt(d_ff)`` out),
        drawn one expert at a time: one f32 draw of a large arch's
        ``w_in`` would be tens of GB."""
        d, f = self.w_in.shape[1:]
        self.router.copy_(dense_init(g, self.router.shape, 1 / math.sqrt(d)))
        for w, scale in ((self.w_in, 1 / math.sqrt(d)),
                         (self.w_gate, 1 / math.sqrt(d)),
                         (self.w_out, 1 / math.sqrt(f))):
            for e in range(w.shape[0]):
                w[e].copy_(dense_init(g, w.shape[1:], scale))


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.nn.one_hot(idx, n)`` in f32: an index outside ``[0, n)`` gives
    an all-zero row (``F.one_hot`` raises instead)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(F32)


def route(p, xg: torch.Tensor, cfg):
    """The router of groups ``xg (G, S, D)`` bf16 -> (each round's expert
    choices, ``top_k`` tensors ``(G, S)``; ``combined (G, S, E, C)`` f32,
    a kept choice's gate at its expert and position, else 0; the aux
    loss)."""
    m = cfg.moe
    e_n = m.num_experts
    g, gs, _ = xg.shape
    probs = torch.softmax((xg @ p.router.to(BF16)).to(F32), dim=-1)  # (G,S,E)

    cap = int(gs * m.top_k / e_n * m.capacity_factor)
    cap = max(cap, m.top_k)

    # top-k selection, one expert at a time (the first index on a tie)
    choices, gates, masks = [], [], []
    remaining = probs
    for _ in range(m.top_k):
        idx = torch.argmax(remaining, dim=-1)                  # (G,S)
        onehot = _one_hot(idx, e_n)                            # (G,S,E)
        choices.append(idx)
        gates.append((probs * onehot).sum(dim=-1))             # (G,S)
        masks.append(onehot)
        remaining = remaining * (1.0 - onehot)

    # aux load-balance loss (Switch): mean over experts of f_e * p_e * E
    me = probs.mean(dim=1)                                     # (G,E)
    fe = masks[0].mean(dim=1)                                  # (G,E)
    aux = (me * fe).sum(dim=-1).mean() * e_n

    # capacity positions: prefix rank within expert across the group,
    # k-th choices queue behind all first choices
    combined = torch.zeros((g, gs, e_n, cap), dtype=F32, device=xg.device)
    prior = torch.zeros((g, e_n), dtype=F32, device=xg.device)
    for mask, gate in zip(masks, gates):
        pos = torch.cumsum(mask, dim=1) - mask + prior[:, None, :]  # (G,S,E)
        prior = prior + mask.sum(dim=1)
        keep = (pos < cap).to(F32) * mask                    # dropped beyond C
        pos_oh = _one_hot(pos.to(torch.int32), cap)
        combined = combined + gate[:, :, None, None] * keep[..., None] * pos_oh
    return choices, combined, aux


def _experts(p, xin: torch.Tensor, mg=None) -> torch.Tensor:
    """The expert MLPs over their dispatched rows ``xin (E, GC, D)`` ->
    ``(E, GC, D)`` bf16; with ``mg``, each expert's ``d_ff`` is this
    rank's slice and the row-parallel partial products are reduced."""
    h = torch.bmm(xin, p.w_in.to(BF16))                        # (E,GC,F)
    gt = torch.bmm(xin, p.w_gate.to(BF16))
    h = silu(gt.to(F32)).to(BF16) * h
    return tpar.row_parallel(h, p.w_out, mg)           # batched over E


def moe_apply(p, x: torch.Tensor, cfg):
    """x: ``(B, S, D)`` bf16 -> (``(B, S, D)`` bf16, the load-balancing
    aux loss, an f32 scalar).  Where ``x`` is this rank's rows of a batch
    split over ``p.rows`` (``fsdp.rows_over``) and a routing group of the
    global batch would span ranks, the rows are gathered, the global
    tokens routed and run, and this rank's rows kept."""
    rows = getattr(p, "rows", None)
    if rows is not None:
        tokens = x.shape[0] * x.shape[1]
        if tokens % min(cfg.moe.group_size, rows.size * tokens):
            y, aux = _moe(p, fsdp.gather_rows(x, rows), cfg)
            return fsdp.own_rows(y, rows), aux
    return _moe(p, x, cfg)


def _moe(p, x: torch.Tensor, cfg):
    e_n = cfg.moe.num_experts
    b, s, d = x.shape
    tokens = b * s
    gs = min(cfg.moe.group_size, tokens)
    g = -(-tokens // gs)
    pad = g * gs - tokens
    xf = x.reshape(tokens, d)
    if pad:      # ragged batches (prefill/serve): pad, drop on the way out
        xf = torch.cat([xf, xf.new_zeros((pad, d))])
    xg = xf.view(g, gs, d)
    _, combined, aux = route(p, xg, cfg)
    cap = combined.shape[-1]

    dispatch = (combined > 0).to(BF16)                         # (G,S,E,C)
    mg, mode = getattr(p, "mg", None), getattr(p, "tp_mode", None)
    if mode == "experts":       # this rank's experts alone
        el = p.w_in.shape[0]
        e0 = mg.rank * el
        mine = slice(e0, e0 + el)
        xin = torch.einsum("gsd,gsec->egcd", tpar.copy_to(xg, mg),
                           dispatch[:, :, mine]).reshape(el, g * cap, d)
        out = _experts(p, xin).view(el, g, cap, d)
        comb = tpar.copy_to(combined, mg)[:, :, mine]
        y = torch.einsum("egcd,gsec->gsd", out.to(F32),
                         comb.to(BF16).to(F32))
        y = tpar.reduce_from(y, mg).to(BF16)
    else:
        xin = torch.einsum("gsd,gsec->egcd", xg, dispatch).reshape(
            e_n, g * cap, d)
        out = _experts(p, tpar.copy_to(xin, mg), mg).view(e_n, g, cap, d)
        y = torch.einsum("egcd,gsec->gsd", out, combined.to(BF16))
    y = y.reshape(g * gs, d)
    if pad:
        y = y[:tokens]
    return y.reshape(b, s, d), aux
