"""RG-LRU recurrent block (RecurrentGemma's temporal-mixing layer); the port
of ``repro/models/rglru.py``.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
a_t = exp(-c * softplus(Lambda) * sigmoid(r_t))

with input/recurrence gates r_t, i_t from linear maps of x.  The block is
conv1d(4) -> RG-LRU, wrapped by linear in/out projections.  ``lam`` and
the state ``h`` are f32, as the reference uses them; the matrices, the
conv taps and the conv bias are held in the model's dtype (bf16 to serve,
f32 to train) and cast to bf16 at each use, as the reference casts them.

The prefill runs the reference's chunks (``chunk=256``, ``nch = max(1, S //
chunk)``); each chunk's gates are made for that chunk alone and its
recurrence is scanned from the carried state by ``repro::linear_scan``
(``kernels/linear_scan``) over the ``W`` channels: on the card one launch
of the Hopper kernel a chunk (sequential in f32, so a state differs from
the reference's by f32 rounding only), on the CPU the reference's
associative scan in torch ops.  Decode is the O(1) step.  Training runs
:func:`rglru_apply` under autograd (the scan's backward is the same scan
run in reverse); no op writes in place.

Under tensor parallelism (``distributed/tensor_parallel.py``) the width
``W`` is split over the model group: ``in_proj`` is column-parallel (a
rank's slice of the ``x`` half and of the gate half: the ``"halves"``
layout), ``conv_w`` local, ``wr``/``wi`` row-parallel (each gate's partial
products reduced, then the rank's columns kept), ``out_proj``
row-parallel; ``conv_b`` and ``lam`` are split where the rules shard them
(1,024 and up) and sliced locally otherwise.  The state ``h`` and the conv
window hold the rank's channels.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tpar
from ..kernels.linear_scan import linear_scan
from .layers import (BF16, F32, dense_init, depthwise_conv, param,
                     softplus)

_C = 8.0


class RGLRU(torch.nn.Module):
    """``in_proj (d, 2w)`` (x, gate), ``conv_w (4, w)``, ``conv_b (w,)``,
    ``wr``/``wi (w, w)``, ``lam (w,)`` f32, ``out_proj (w, d)``."""

    def __init__(self, cfg, *, device=None, dtype=BF16):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        self.in_proj = param((d, 2 * w), device, dtype)
        self.conv_w = param((4, w), device, dtype)
        self.conv_b = param((w,), device, dtype)
        self.wr = param((w, w), device, dtype)
        self.wi = param((w, w), device, dtype)
        self.lam = param((w,), device, F32)
        self.out_proj = param((w, d), device, dtype)

    def init_(self, g: torch.Generator) -> None:
        """The reference's init: ``1/sqrt(d)`` and ``1/sqrt(w)`` scales, conv
        taps ``0.1``, a zero bias, ``lam = 2`` (softplus ~ 2.1: slow
        decay)."""
        d, w = self.in_proj.shape[0], self.wr.shape[0]
        for t, scale in ((self.in_proj, 1 / math.sqrt(d)),
                         (self.conv_w, 0.1), (self.wr, 1 / math.sqrt(w)),
                         (self.wi, 1 / math.sqrt(w)),
                         (self.out_proj, 1 / math.sqrt(w))):
            t.copy_(dense_init(g, t.shape, scale))
        self.conv_b.zero_()
        self.lam.fill_(2.0)


def _gate(p, u: torch.Tensor, w: str = "wr") -> torch.Tensor:
    """``u @ w`` in bf16; row-parallel under a group, this rank's columns
    kept."""
    mg = getattr(p, "mg", None)
    return tpar.split(tpar.row_parallel(u, getattr(p, w), mg), -1, mg)


def _gates(p, u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """u: bf16 ``(B, L, W)`` -> f32 ``a`` and the gated input."""
    r = torch.sigmoid(_gate(p, u).to(F32))
    i = torch.sigmoid(_gate(p, u, "wi").to(F32))
    log_a = -_C * softplus(tpar.local_of(p, "lam")) * r      # (B,L,W)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * u.to(F32))
    return a, gated


def _scan_chunk(state: torch.Tensor, a: torch.Tensor, gated: torch.Tensor):
    """One chunk of the reference's outer scan: ``state (B, W)`` and the
    chunk's ``a``/gated input ``(B, L, W)`` -> (the state after the chunk,
    the states ``h (B, L, W)``)."""
    h = linear_scan(a, gated, state)
    return h[:, -1], h


def _out(p, h: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    y = h.to(BF16) * F.gelu(g.to(F32), approximate="tanh").to(BF16)
    return tpar.row_parallel(y, p.out_proj, getattr(p, "mg", None))


def rglru_mix(p, u_raw: torch.Tensor, g: torch.Tensor, cfg, *,
              chunk: int = 256, state=None):
    """The layer after ``in_proj``: ``u_raw``/``g`` ``(B, S, W)`` bf16 ->
    (out ``(B, S, D)``, the f32 state ``(B, W)`` after the last token)."""
    b, s_len, w = u_raw.shape
    u = depthwise_conv(F.pad(u_raw, (0, 0, 3, 0)), p.conv_w.to(BF16),
                       tpar.local_of(p, "conv_b").to(BF16), s_len)
    if state is None:
        state = torch.zeros((b, w), dtype=F32, device=u.device)
    nch = max(1, s_len // chunk)
    ch = s_len // nch
    uc = u.reshape(b, nch, ch, w)
    hs = []
    for c in range(nch):
        state, h = _scan_chunk(state, *_gates(p, uc[:, c]))
        hs.append(h)
    # a clone, not a view that would keep the last chunk's states alive
    return _out(p, torch.cat(hs, dim=1), g), state.clone()


def in_proj(p, x: torch.Tensor):
    """``x (B, S, D)`` -> the conv input and the gate branch, ``(B, S,
    W)`` bf16 each (this rank's channels)."""
    h = tpar.copy_to(x, getattr(p, "mg", None)) @ p.in_proj.to(BF16)
    return h.chunk(2, dim=-1)


def rglru_apply(p, x: torch.Tensor, cfg, *, chunk: int = 256, state=None,
                return_state: bool = False):
    """x: ``(B, S, D)`` bf16 -> ``(B, S, D)`` (and the f32 state ``(B, W)``
    after the last token)."""
    u, g = in_proj(p, x)
    out, state = rglru_mix(p, u, g, cfg, chunk=chunk, state=state)
    return (out, state) if return_state else out


def init_rglru_cache(cfg, batch: int, device=None,
                     width: int = 0) -> Dict[str, torch.Tensor]:
    """Zero states of ``width`` channels (default all of the width)."""
    w = width or cfg.lru_width or cfg.d_model
    return {"conv": torch.zeros((batch, 3, w), dtype=BF16, device=device),
            "h": torch.zeros((batch, w), dtype=F32, device=device)}


def rglru_decode(p, x: torch.Tensor, cache, cfg):
    """x: ``(B, 1, D)`` one token -> (out, the new ``{"conv", "h"}``)."""
    u, g = in_proj(p, x)                                    # (B,1,W)
    win = torch.cat([cache["conv"], u], dim=1)              # (B,4,W)
    u1 = depthwise_conv(win, p.conv_w.to(BF16),
                        tpar.local_of(p, "conv_b").to(BF16), 1)
    a, gated = _gates(p, u1)
    h = a[:, 0] * cache["h"] + gated[:, 0]
    return _out(p, h[:, None], g), {"conv": win[:, 1:], "h": h}
