"""Mamba-1 (S6) selective-state-space layer; the port of
``repro/models/mamba.py``.

The prefill runs the reference's chunks (``chunk=256``): each chunk's
``dA``/``dBu`` (``(B, L, d_inner, d_state)`` f32) are made for that chunk
alone and scanned from the carried state by ``repro::linear_scan``
(``kernels/linear_scan``) over ``d_inner * d_state`` channels: on the card
one launch of the Hopper kernel a chunk (sequential in f32, so a state
differs from the reference's by f32 rounding only), on the CPU the
reference's associative scan in torch ops.  The chunk's states are read
by ``C`` and dropped; only the last is carried, so no ``(B, S, d_inner,
d_state)`` tensor exists and live memory is O(chunk), as in the
reference.  Decode is the O(1) step.  ``A_log``, ``D`` and ``dt_bias``
are f32, as the reference uses them; the matrices and the conv are held
in the model's dtype (bf16 to serve, f32 to train) and cast to bf16 at
each use.
Training runs :func:`mamba_apply` under autograd; the scan's backward
is the same scan run in reverse (``kernels/linear_scan/ops.py``), and it
keeps each chunk's ``dA`` and states for it.  No op writes in place.

Under tensor parallelism (``distributed/tensor_parallel.py``) ``d_inner``
is split over the model group: ``in_proj`` is column-parallel (a rank
holds its slice of the ``x`` half and of the ``z`` half: the ``"halves"``
layout), ``x_proj`` and ``out_proj`` row-parallel (``(dt, B, C)`` reduced
before the split), ``conv_w``, ``dt_proj`` and ``A_log`` local, and
``conv_b``, ``dt_bias`` and ``D`` split where the rules shard them (1,024
channels and up) and sliced locally otherwise.  The conv and SSM states
hold the rank's channels.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from ..distributed import tensor_parallel as tpar
from ..kernels.linear_scan import linear_scan
from .layers import (BF16, F32, dense_init, depthwise_conv, param, silu,
                     softplus)


class Mamba(torch.nn.Module):
    """``in_proj (d, 2 di)``, ``conv_w (d_conv, di)``, ``conv_b (di,)``,
    ``x_proj (di, dt_rank + 2 N)``, ``dt_proj (dt_rank, di)``, ``dt_bias
    (di,)`` f32, ``A_log (di, N)`` f32, ``D (di,)`` f32, ``out_proj (di,
    d)``."""

    def __init__(self, cfg, *, device=None, dtype=BF16):
        super().__init__()
        d, s, di = cfg.d_model, cfg.ssm, cfg.d_inner
        self.in_proj = param((d, 2 * di), device, dtype)
        self.conv_w = param((s.d_conv, di), device, dtype)
        self.conv_b = param((di,), device, dtype)
        self.x_proj = param((di, s.dt_rank + 2 * s.d_state), device, dtype)
        self.dt_proj = param((s.dt_rank, di), device, dtype)
        self.dt_bias = param((di,), device, F32)
        self.A_log = param((di, s.d_state), device, F32)
        self.D = param((di,), device, F32)
        self.out_proj = param((di, d), device, dtype)

    def init_(self, g: torch.Generator) -> None:
        """The reference's init: ``dt_bias = softplus^-1(0.01)``, ``A_log =
        log(1..N)`` on every channel, ``D = 1``."""
        d, di = self.in_proj.shape[0], self.D.shape[0]
        rank, n = self.dt_proj.shape[0], self.A_log.shape[1]
        for t, scale in ((self.in_proj, 1 / math.sqrt(d)),
                         (self.conv_w, 0.1), (self.x_proj, 1 / math.sqrt(di)),
                         (self.dt_proj, 1 / math.sqrt(rank)),
                         (self.out_proj, 1 / math.sqrt(di))):
            t.copy_(dense_init(g, t.shape, scale))
        self.conv_b.zero_()
        self.dt_bias.copy_(torch.log(torch.expm1(
            torch.full((di,), 0.01, dtype=F32, device=self.D.device))))
        self.A_log.copy_(torch.log(torch.arange(
            1, n + 1, dtype=F32, device=self.D.device)).expand(di, n))
        self.D.fill_(1.0)


def in_proj(p, x: torch.Tensor):
    """``x (B, S, D)`` -> the conv input and the gate, ``(B, S, di)`` bf16
    each (this rank's channels)."""
    h = tpar.copy_to(x, getattr(p, "mg", None)) @ p.in_proj.to(BF16)
    return h.chunk(2, dim=-1)


def _ssm_inputs(p, u: torch.Tensor, cfg):
    """u: ``(B, L, di)`` post-conv bf16 -> (dA, dBu, C)."""
    s = cfg.ssm
    mg = getattr(p, "mg", None)
    bc = tpar.copy_to(tpar.row_parallel(u, p.x_proj, mg).to(F32), mg)
    dt, bm, cm = bc.split([s.dt_rank, s.d_state, s.d_state], dim=-1)
    dt = softplus((dt.to(BF16) @ p.dt_proj.to(BF16)).to(F32)
                  + tpar.local_of(p, "dt_bias"))             # (B,L,di)
    a = -torch.exp(p.A_log)                                        # (di, N)
    da = torch.exp(dt[..., None] * a)                              # (B,L,di,N)
    dbu = dt[..., None] * bm[:, :, None, :] * u.to(F32)[..., None]
    return da, dbu, cm


def _read(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``einsum("bdn,bn->bd")``: a state ``(B, di, N)`` read by ``C``."""
    return torch.einsum("bdn,bn->bd", h, c)


def _scan_chunk(state: torch.Tensor, da: torch.Tensor, dbu: torch.Tensor,
                cm: torch.Tensor):
    """The reference's ``_scan_chunk``: ``state (B, di, N)`` and one
    chunk's ``dA``/``dBu`` ``(B, L, di, N)`` and ``C`` ``(B, L, N)`` ->
    (the state after the chunk, ``y (B, L, di)``), the recurrence scanned
    over ``di * N`` channels."""
    b, length, di, n = da.shape
    h = linear_scan(da.reshape(b, length, di * n),
                    dbu.reshape(b, length, di * n),
                    state.reshape(b, di * n)).view(b, length, di, n)
    # a clone, not a view that would keep the chunk's states alive
    return h[:, -1].clone(), torch.einsum("bldn,bln->bld", h, cm)


def _conv_silu(win: torch.Tensor, p, length: int) -> torch.Tensor:
    conv = depthwise_conv(win, p.conv_w.to(BF16),
                          tpar.local_of(p, "conv_b").to(BF16), length)
    return silu(conv.to(F32)).to(BF16)


def _finish(p, y: torch.Tensor, u: torch.Tensor, z: torch.Tensor):
    y = y + u.to(F32) * tpar.local_of(p, "D")
    y = y.to(BF16) * silu(z.to(F32)).to(BF16)
    return tpar.row_parallel(y, p.out_proj, getattr(p, "mg", None))


def mamba_mix(p, u_raw: torch.Tensor, z: torch.Tensor, cfg, *,
              chunk: int = 256, state=None):
    """The layer after ``in_proj``: ``u_raw``/``z`` ``(B, S, di)`` bf16 ->
    (out ``(B, S, D)``, the f32 state ``(B, di, N)``)."""
    b, s_len, di = u_raw.shape
    dc = cfg.ssm.d_conv
    u = _conv_silu(F.pad(u_raw, (0, 0, dc - 1, 0)), p, s_len)
    if state is None:
        state = torch.zeros((b, di, cfg.ssm.d_state), dtype=F32,
                            device=u.device)
    nch = max(1, s_len // chunk)
    ch = s_len // nch
    uc = u.reshape(b, nch, ch, di)
    ys = []
    for c in range(nch):
        state, y = _scan_chunk(state, *_ssm_inputs(p, uc[:, c], cfg))
        ys.append(y)
    return _finish(p, torch.cat(ys, dim=1), u, z), state


def mamba_apply(p, x: torch.Tensor, cfg, *, chunk: int = 256, state=None,
                return_state: bool = False):
    """x: ``(B, S, D)``.  Full-sequence form (prefill)."""
    u, z = in_proj(p, x)
    out, state = mamba_mix(p, u, z, cfg, chunk=chunk, state=state)
    return (out, state) if return_state else out


def init_mamba_cache(cfg, batch: int, device=None,
                     inner: int = 0) -> Dict[str, torch.Tensor]:
    """Zero states of ``inner`` channels (default all of ``d_inner``)."""
    di = inner or cfg.d_inner
    return {
        "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, di), dtype=BF16,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.ssm.d_state), dtype=F32,
                           device=device),
    }


def mamba_decode(p, x: torch.Tensor, cache, cfg):
    """x: ``(B, 1, D)`` one token -> (out, the new ``{"conv", "ssm"}``)."""
    u, z = in_proj(p, x)                                    # (B,1,di)
    win = torch.cat([cache["conv"], u], dim=1)              # (B,dc,di)
    u1 = _conv_silu(win, p, 1)                              # (B,1,di)
    da, dbu, cm = _ssm_inputs(p, u1, cfg)
    h = da[:, 0] * cache["ssm"] + dbu[:, 0]                 # (B,di,N)
    y = _read(h, cm[:, 0])[:, None]                         # (B,1,di)
    return _finish(p, y, u1, z), {"conv": win[:, 1:], "ssm": h}
