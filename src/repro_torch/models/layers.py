"""Shared neural building blocks: norms, RoPE, embeddings, masks and the
initializer; the port of ``repro/models/layers.py``.

The dtype sequence is the reference's, step for step: activations are
bf16; ``rms_norm`` and RoPE work in f32 and cast back; masks are additive
f32 (``NEG_INF``).  Plain tensor code: the reference reaches no Pallas
kernel here.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

BF16 = torch.bfloat16
F32 = torch.float32
NEG_INF = -1e9


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 accumulation and a ``1 + scale`` gain, cast back to
    the input's dtype."""
    xf = x.to(F32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.to(F32))).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def rope_tables(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(cos, sin)``, each ``(B, S, 1, hd/2)`` f32, for ``positions``
    ``(B, S)``: computed once per forward and shared by its layers."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    angles = positions[..., None].to(F32) * freqs
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def apply_rope(x: torch.Tensor, tables) -> torch.Tensor:
    """x: ``(B, S, H, hd)``; ``tables``: ``(cos, sin)`` from
    :func:`rope_tables` for its positions.  Rotates split halves in f32 and
    casts back."""
    cos, sin = tables
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` (``logaddexp(x, 0)``): ``max(x, 0) + log1p(exp(
    -|x|))``, the reference's sequence (``F.softplus`` rounds otherwise)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s sequence, ``x * sigmoid(x)``: it matches the
    reference bitwise on far more f32 inputs than ``F.silu`` (99.6% against
    77% of a million normal draws on the CPU)."""
    return x * torch.sigmoid(x)


def depthwise_conv(win: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   length: int) -> torch.Tensor:
    """The causal depthwise conv of the recurrent kinds over ``win`` (``(B,
    length + taps - 1, W)``): the bf16 products of the taps ``w`` (``(taps,
    W)``) summed tap by tap in bf16, plus the bias ``b``; the reference's
    ``sum(...)``."""
    out = win[:, 0:length] * w[0]
    for i in range(1, w.shape[0]):
        out = out + win[:, i:i + length] * w[i]
    return out + b


def param(shape: Sequence[int], device=None, dtype=BF16) -> torch.nn.Parameter:
    """An uninitialised weight, bf16 unless told, with no gradient until
    its model is made trainable (an f32 ``Transformer``): ``init_params``
    draws it, ``params_from_jax`` copies it in (``models/transformer.py``).
    Every use casts a matrix to bf16, as the reference casts its f32
    params."""
    return torch.nn.Parameter(torch.empty(tuple(shape), dtype=dtype,
                                          device=device), requires_grad=False)


def embed_lookup(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``(V, D)`` table -> ``(B, S, D)`` bf16 activations (the rows are
    gathered from the table in its own dtype, then cast)."""
    return embedding[tokens].to(BF16)


def dense_init(generator: torch.Generator, shape: Sequence[int],
               scale: float) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in f32 on the generator's device (the
    reference's initializer: ``scale`` is ``1 / sqrt(fan_in)`` but for the
    embedding)."""
    w = torch.randn(tuple(shape), generator=generator, dtype=F32,
                    device=generator.device)
    return w.mul_(scale)


def causal_mask(sq: int, sk: int, q_offset: int = 0, window=None,
                device=None) -> torch.Tensor:
    """``(sq, sk)`` additive f32 mask; ``q_offset`` = absolute position of
    ``q[0]``.  Made without writing in place: a selective checkpoint that
    keeps every op's output caches it."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    ok = kpos <= qpos
    if window is not None:
        ok = ok & (kpos > qpos - window)
    return torch.where(ok, 0.0, NEG_INF).to(F32)
