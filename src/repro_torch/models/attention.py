"""GQA attention: full, chunked and sliding-window, with KV caches; the
port of ``repro/models/attention.py``.

The dtype sequence is the reference's: projections take bf16 in (each
weight cast to bf16 at its use) and give bf16 out; the bf16 scores are divided by ``sqrt(hd)`` rounded to bf16,
then cast to f32, where the additive ``-1e9`` mask and the softmax run;
the probabilities are cast to bf16 before the product with V.  Explicit
tensor ops throughout (``scaled_dot_product_attention`` would change that
sequence).

Sliding-window archs keep only ``window`` KV entries in the decode cache,
a ring written at ``pos % window`` (floor modulo, ``torch.remainder``);
position-aware masking keeps the softmax right for both layouts.  The
decode step writes its cache rows in place and returns the same dict.
``cross_attention`` (the VLM's ``xattn`` layers) attends over image
embeddings with no RoPE and no mask.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict

import torch

from .layers import (BF16, F32, NEG_INF, apply_rope, causal_mask,
                     dense_init, param)


class Attention(torch.nn.Module):
    """``wq (d, h, hd)``, ``wk``/``wv (d, kh, hd)``, ``wo (h, hd, d)``."""

    def __init__(self, cfg, *, device=None, dtype=BF16):
        super().__init__()
        d, h, kh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
            cfg.head_dim
        self.wq = param((d, h, hd), device, dtype)
        self.wk = param((d, kh, hd), device, dtype)
        self.wv = param((d, kh, hd), device, dtype)
        self.wo = param((h, hd, d), device, dtype)

    def init_(self, g: torch.Generator) -> None:
        """The reference's scales: ``1/sqrt(d)`` for q, k, v and
        ``1/sqrt(h*hd)`` for the output."""
        d, h, hd = self.wq.shape
        for w, scale in ((self.wq, 1 / math.sqrt(d)),
                         (self.wk, 1 / math.sqrt(d)),
                         (self.wv, 1 / math.sqrt(d)),
                         (self.wo, 1 / math.sqrt(h * hd))):
            w.copy_(dense_init(g, w.shape, scale))


def project_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``: ``(B, S, D)`` x ``(D, H, hd)``."""
    d, h, k = w.shape
    return (x @ w.to(BF16).reshape(d, h * k)).unflatten(-1, (h, k))


def project_out(out: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``: ``(B, S, H, hd)`` x ``(H, hd, D)``."""
    h, k, d = wo.shape
    return out.flatten(-2) @ wo.to(BF16).reshape(h * k, d)


def _qkv(p, x, tables):
    """q, k (rotated by ``tables``, :func:`~.layers.rope_tables`) and v."""
    q = apply_rope(project_in(x, p.wq), tables)
    k = apply_rope(project_in(x, p.wk), tables)
    return q, k, project_in(x, p.wv)


@functools.lru_cache(maxsize=None)
def _sqrt_bf16(hd: int) -> float:
    """``sqrt(hd)`` rounded to bf16, as the reference divides by it."""
    return float(torch.tensor(math.sqrt(hd), dtype=F32).to(BF16))


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: ``(B, Sq, H, hd)``, k: ``(B, Sk, K, hd)`` -> bf16 ``(B, K, G, Sq,
    Sk)``: each of a KV head's G query heads against its keys."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd).permute(0, 2, 3, 1, 4)   # b k g q h
    s = torch.matmul(qg.reshape(b, kh, g * sq, hd), k.permute(0, 2, 3, 1))
    return s.view(b, kh, g, sq, -1) / _sqrt_bf16(hd)


def _gqa_out(probs: torch.Tensor, v: torch.Tensor, h: int) -> torch.Tensor:
    """bf16 probs ``(B, K, G, Sq, Sk)`` x v ``(B, Sk, K, hd)`` -> ``(B, Sq,
    H, hd)``."""
    b, kh, g, sq, sk = probs.shape
    out = torch.matmul(probs.reshape(b, kh, g * sq, sk), v.permute(0, 2, 1, 3))
    return out.view(b, kh, g, sq, -1).permute(0, 3, 1, 2, 4).reshape(
        b, sq, h, v.shape[-1])


def full_attention(q, k, v, *, q_offset: int = 0, window=None,
                   causal: bool = True):
    """Attention with the whole score matrix materialised."""
    scores = _gqa_scores(q, k).to(F32)
    if causal:
        scores = scores + causal_mask(q.shape[1], k.shape[1], q_offset,
                                      window, device=q.device)
    probs = torch.softmax(scores, dim=-1).to(BF16)
    return _gqa_out(probs, v, q.shape[2])


def chunked_attention(q, k, v, *, chunk: int = 512, window=None):
    """Causal attention over q chunks: live memory O(chunk * S).  Each
    chunk sees its whole key prefix, so it equals :func:`full_attention`.
    Used when ``S > 2048``."""
    s = q.shape[1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    return torch.cat([full_attention(q[:, i:i + chunk], k, v, q_offset=i,
                                     window=window)
                      for i in range(0, s, chunk)], dim=1)


def self_attention(q, k, v, cfg, *, chunk: int):
    """Causal attention over a whole sequence, the reference's rule: the
    score matrix materialised up to 2,048 tokens, q chunks of ``chunk``
    beyond (512 in the prefill, 1,024 in training)."""
    if q.shape[1] <= 2048:
        return full_attention(q, k, v, window=cfg.window)
    return chunked_attention(q, k, v, chunk=chunk, window=cfg.window)


def attention_train(p, x, tables, cfg, *, chunk: int = 1024):
    """The training forward of an ``attn`` layer: ``x (B, S, D)`` bf16 and
    its positions' RoPE ``tables`` -> ``(B, S, D)`` bf16."""
    q, k, v = _qkv(p, x, tables)
    return project_out(self_attention(q, k, v, cfg, chunk=chunk), p.wo)


# ---- KV cache (decode) ------------------------------------------------------

@dataclasses.dataclass
class CacheSpec:
    length: int          # cache capacity: min(window, max_seq)
    ring: bool           # True for sliding-window ring buffers


def cache_spec(cfg, max_seq: int) -> CacheSpec:
    if cfg.window is not None and cfg.window < max_seq:
        return CacheSpec(cfg.window, True)
    return CacheSpec(max_seq, False)


def init_cache(cfg, spec: CacheSpec, batch: int,
               device=None) -> Dict[str, torch.Tensor]:
    shape = (batch, spec.length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=BF16, device=device),
            "v": torch.zeros(shape, dtype=BF16, device=device)}


def attention_decode(p, x, pos, cache, spec: CacheSpec, cfg, tables):
    """One-token decode step.  x: ``(B, 1, D)``; pos: ``(B,)`` int32
    absolute positions, ``tables`` their RoPE tables.  Writes each row's
    new K/V at its slot (``pos % length`` for a ring) in place and attends
    over the valid entries."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, x, tables)

    slot = torch.remainder(pos, spec.length) if spec.ring else pos
    bidx = torch.arange(b, device=x.device)
    k, v = cache["k"], cache["v"]
    k[bidx, slot] = k_new[:, 0]
    v[bidx, slot] = v_new[:, 0]

    # key absolute positions for masking
    lane = torch.arange(spec.length, device=x.device, dtype=pos.dtype)[None]
    cur = pos[:, None]
    if spec.ring:
        # entry at slot s holds the latest position p with p % L == s, p <= pos
        kpos = cur - torch.remainder(cur - lane, spec.length)
    else:
        kpos = lane.expand(b, spec.length)
    valid = (kpos <= cur) & (kpos > cur - (cfg.window or 10**9))

    scores = _gqa_scores(q, k).to(F32)                  # (B,K,G,1,L)
    mask = torch.zeros(valid.shape, dtype=F32, device=x.device).masked_fill_(
        ~valid, NEG_INF)[:, None, None, None, :]
    probs = torch.softmax(scores + mask, dim=-1).to(BF16)
    out = _gqa_out(probs, v, q.shape[2])
    return project_out(out, p.wo), cache


# ---- cross attention (VLM) ---------------------------------------------------

def image_kv(p, kv_embeds: torch.Tensor):
    """The image K/V of an ``xattn`` layer: ``kv_embeds (B, N, D)`` ->
    ``(B, N, K, hd)`` each, no RoPE (the layer's prefill cache)."""
    return project_in(kv_embeds, p.wk), project_in(kv_embeds, p.wv)


def attend_image(p, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Queries of ``x (B, S, D)`` (no RoPE) against an image's K/V, with no
    mask, projected out."""
    out = full_attention(project_in(x, p.wq), k, v, causal=False)
    return project_out(out, p.wo)


def cross_attention(p, x: torch.Tensor, kv_embeds: torch.Tensor) -> torch.Tensor:
    """x: ``(B, S, D)`` queries; kv_embeds: ``(B, N, D)`` image tokens (no
    mask).  ``p``: an :class:`Attention` (the reference's
    ``init_xattn_params`` is ``init_attn_params``)."""
    return attend_image(p, x, *image_kv(p, kv_embeds))
