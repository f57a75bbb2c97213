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

Tensor parallelism (``distributed/tensor_parallel.py``): Q heads are
padded to ``cfg.padded_heads(tp)`` (the padded heads of ``wq`` and ``wo``
zero) and a rank runs its contiguous slice of them; ``wk``/``wv`` are
split over KV heads where ``num_kv_heads % tp == 0`` and whole otherwise,
and ``wo`` is row-parallel.  The grouping is the reference's over the
padded count, ``G = h_pad // num_kv_heads``, so a rank's heads can straddle
KV heads (and padding moves real heads to other KV heads): each local
head reads KV head ``head // G`` (:func:`kv_for_heads`).  A KV cache the
rules split over the sequence (KV heads that ``tp`` does not divide) is
read by a softmax over ranks: every rank scores all the step's query heads
against its slice of positions, the maxima and sums are combined over the
group and then the outputs; only the rank holding ``pos``'s slot writes
it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import struct
from typing import Dict, Optional

import torch

from ..distributed import tensor_parallel as tpar
from .layers import (BF16, F32, NEG_INF, apply_rope, causal_mask,
                     dense_init, param)


class Attention(torch.nn.Module):
    """``wq (d, h, hd)``, ``wk``/``wv (d, kh, hd)``, ``wo (h, hd, d)``, with
    ``h = cfg.padded_heads(tp)``."""

    def __init__(self, cfg, *, tp: int = 1, device=None, dtype=BF16):
        super().__init__()
        d, kh, hd = cfg.d_model, cfg.num_kv_heads, cfg.head_dim
        h = cfg.padded_heads(tp)
        self.num_heads, self.padded_heads, self.num_kv_heads = \
            cfg.num_heads, h, kh
        self.image_tokens = cfg.num_image_tokens
        self.wq = param((d, h, hd), device, dtype)
        self.wk = param((d, kh, hd), device, dtype)
        self.wv = param((d, kh, hd), device, dtype)
        self.wo = param((h, hd, d), device, dtype)

    def init_(self, g: torch.Generator) -> None:
        """The reference's scales: ``1/sqrt(d)`` for q, k, v and
        ``1/sqrt(h*hd)`` for the output (``h`` padded); the padded heads
        of ``wq`` and ``wo`` zero, so they stay inert."""
        d, h, hd = self.wq.shape
        for w, scale in ((self.wq, 1 / math.sqrt(d)),
                         (self.wk, 1 / math.sqrt(d)),
                         (self.wv, 1 / math.sqrt(d)),
                         (self.wo, 1 / math.sqrt(h * hd))):
            w.copy_(dense_init(g, w.shape, scale))
        self.wq[:, self.num_heads:].zero_()
        self.wo[self.num_heads:].zero_()


def project_in(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhk->bshk")``: ``(B, S, D)`` x ``(D, H, hd)``."""
    d, h, k = w.shape
    return (x @ w.to(BF16).reshape(d, h * k)).unflatten(-1, (h, k))


def project_out(out: torch.Tensor, wo: torch.Tensor,
                mg: Optional[tpar.ModelGroup] = None) -> torch.Tensor:
    """``einsum("bshk,hkd->bsd")``: ``(B, S, H, hd)`` x ``(H, hd, D)``;
    row-parallel over the group's heads where ``mg`` is given."""
    h, k, d = wo.shape
    return tpar.row_parallel(out.flatten(-2), wo.reshape(h * k, d), mg)


def _heads(p):
    """``(h_pad, h0, hl)``: the padded head count and this rank's slice."""
    hl = p.wq.shape[1]
    mg = getattr(p, "mg", None)
    return (p.padded_heads, mg.rank * hl, hl) if mg is not None \
        else (hl, 0, hl)


def _kv_split(p) -> bool:
    return p.wk.shape[1] < p.num_kv_heads


def _project_kv(p, x, w):
    """k or v of ``x``: this rank's KV heads where they are split, else
    every KV head, its gradient summed over the group (each rank reads
    them for its own query heads)."""
    mg = getattr(p, "mg", None)
    if _kv_split(p):
        return project_in(tpar.copy_to(x, mg), w)
    return tpar.copy_to(project_in(x, w), mg)


def _qkv(p, x, tables=None):
    """q, k (rotated by ``tables``, :func:`~.layers.rope_tables`; none
    given: no RoPE) and v of this rank's heads."""
    q = project_in(tpar.copy_to(x, getattr(p, "mg", None)), p.wq)
    k = _project_kv(p, x, p.wk)
    if tables is not None:
        q, k = apply_rope(q, tables), apply_rope(k, tables)
    return q, k, _project_kv(p, x, p.wv)


@functools.lru_cache(maxsize=None)
def _kv_plan(h_pad: int, kh: int, tp: int, kv_split: bool):
    """For each rank of ``tp``, the KV heads its query heads (``h_pad /
    tp`` consecutive ones) read, ``head // G`` with ``G = h_pad // kh``, as
    indices into the rank's KV heads (all ``kh``, or its ``kh / tp`` where
    they are split): ``("slice", [(a, b), ...])`` where on every rank each
    of ``[a, b)`` serves the same number of consecutive heads, else
    ``("index", [idx, ...])``.  One form for all ranks, so that every rank
    builds the same graph: the backward pass then runs its collectives
    in the same order everywhere."""
    g, hl = h_pad // kh, h_pad // tp
    plans = []
    for r in range(tp):
        k0 = r * (kh // tp) if kv_split else 0
        plans.append(tuple((r * hl + i) // g - k0 for i in range(hl)))
    spans = []
    for idx in plans:
        a, b = idx[0], idx[-1] + 1
        per = hl // (b - a)
        if per * (b - a) != hl or idx != tuple(a + i // per
                                                for i in range(hl)):
            return ("index", plans)
        spans.append((a, b))
    return ("slice", spans)


def kv_for_heads(p, k: torch.Tensor, v: torch.Tensor):
    """k, v ``(B, S, K, hd)`` of this rank's KV heads -> those its query
    heads read, consecutive query heads sharing one (the reference's ``h
    // kh`` grouping of the padded count); where a rank's slice straddles
    KV heads unevenly, one KV head per query head on every rank."""
    mg = getattr(p, "mg", None)
    if mg is None:
        return k, v
    how, per_rank = _kv_plan(p.padded_heads, p.num_kv_heads, mg.size,
                             _kv_split(p))
    if how == "slice":
        a, b = per_rank[mg.rank]
        return k[:, :, a:b], v[:, :, a:b]
    idx = torch.tensor(per_rank[mg.rank], device=k.device)
    return k.index_select(2, idx), v.index_select(2, idx)


@functools.lru_cache(maxsize=None)
def _sqrt_bf16(hd: int) -> float:
    """``sqrt(hd)`` rounded to f32 and then to bf16 (to nearest, ties to
    even), as the reference divides by it; from the float's bits, with no
    tensor a fake mode (the dry run's) could intercept."""
    bits = struct.unpack("<I", struct.pack("<f", math.sqrt(hd)))[0]
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
    return struct.unpack("<f", struct.pack("<I", bits))[0]


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


def attend(p, q, k, v, cfg, *, chunk: int) -> torch.Tensor:
    """This rank's heads' causal attention over a whole sequence,
    projected out: ``q`` its heads, ``k``/``v`` its KV heads."""
    ks, vs = kv_for_heads(p, k, v)
    return project_out(self_attention(q, ks, vs, cfg, chunk=chunk), p.wo,
                       getattr(p, "mg", None))


def attention_train(p, x, tables, cfg, *, chunk: int = 1024):
    """The training forward of an ``attn`` layer: ``x (B, S, D)`` bf16 and
    its positions' RoPE ``tables`` -> ``(B, S, D)`` bf16."""
    q, k, v = _qkv(p, x, tables)
    return attend(p, q, k, v, cfg, chunk=chunk)


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


def _softmax_over_ranks(q, k, v, mask, mg) -> torch.Tensor:
    """Every query head of ``q`` ``(B, 1, H, hd)`` against this rank's
    slice of the positions (``k``/``v`` ``(B, L/tp, K, hd)``, additive f32
    ``mask`` broadcast to the scores or None): each rank's maximum and sum
    of exponentials are gathered, the probabilities made against the
    group's and cast to bf16 as the reference's softmax, and the rank's
    f32 products with V summed over the group -> ``(B, 1, H, hd)`` bf16."""
    scores = _gqa_scores(q, k).to(F32)                       # (B,K,G,1,Ll)
    if mask is not None:
        scores = scores + mask
    m = scores.amax(dim=-1, keepdim=True)
    s = torch.exp(scores - m).sum(dim=-1, keepdim=True)
    stats = tpar.gather(torch.stack([m, s])[None], 0, mg)    # (tp,2,...)
    top = stats[:, 0].amax(dim=0)
    total = (stats[:, 1] * torch.exp(stats[:, 0] - top)).sum(dim=0)
    probs = (torch.exp(scores - top) / total).to(BF16)
    b, kh, g, sq, sk = probs.shape
    part = torch.matmul(probs.reshape(b, kh, g * sq, sk).to(F32),
                        v.permute(0, 2, 1, 3).to(F32))
    out = tpar.reduce_from(part, mg).to(BF16)
    return out.view(b, kh, g, sq, -1).permute(0, 3, 1, 2, 4).reshape(
        b, sq, q.shape[2], v.shape[-1])


def _attend_slice(p, q, k, v, mask):
    """The step's attention where the cache holds this rank's slice of the
    positions: every head's query (gathered over the group), a softmax
    over ranks, then this rank's heads projected out."""
    mg = p.mesh_mg
    h_pad, h0, hl = _heads(p)
    q_all = tpar.gather(q, 2, getattr(p, "mg", None))
    out = _softmax_over_ranks(q_all, k, v, mask, mg)
    return project_out(out[:, :, h0:h0 + hl], p.wo, getattr(p, "mg", None))


def attention_decode(p, x, pos, cache, spec: CacheSpec, cfg, tables):
    """One-token decode step.  x: ``(B, 1, D)``; pos: ``(B,)`` int32
    absolute positions, ``tables`` their RoPE tables.  Writes each row's
    new K/V at its slot (``pos % length`` for a ring) in place and attends
    over the valid entries."""
    b = x.shape[0]
    q, k_new, v_new = _qkv(p, x, tables)
    k, v = cache["k"], cache["v"]
    span = k.shape[1]
    sliced = span < spec.length             # the cache split over positions
    start = p.mesh_mg.rank * span if sliced else 0

    slot = torch.remainder(pos, spec.length) if spec.ring else pos
    bidx = torch.arange(b, device=x.device)
    if sliced:          # only the rank holding the slot writes it
        mine = (slot >= start) & (slot < start + span)
        at = torch.clamp(slot - start, 0, span - 1)
        keep = mine[:, None, None]
        k[bidx, at] = torch.where(keep, k_new[:, 0], k[bidx, at])
        v[bidx, at] = torch.where(keep, v_new[:, 0], v[bidx, at])
    else:
        k[bidx, slot] = k_new[:, 0]
        v[bidx, slot] = v_new[:, 0]

    # key absolute positions for masking
    lane = torch.arange(start, start + span, device=x.device,
                        dtype=pos.dtype)[None]
    cur = pos[:, None]
    if spec.ring:
        # entry at slot s holds the latest position p with p % L == s, p <= pos
        kpos = cur - torch.remainder(cur - lane, spec.length)
    else:
        kpos = lane.expand(b, span)
    valid = (kpos <= cur) & (kpos > cur - (cfg.window or 10**9))
    mask = torch.zeros(valid.shape, dtype=F32, device=x.device).masked_fill_(
        ~valid, NEG_INF)[:, None, None, None, :]
    if sliced:
        return _attend_slice(p, q, k, v, mask), cache

    ks, vs = kv_for_heads(p, k, v)
    scores = _gqa_scores(q, ks).to(F32)                 # (B,K,G,1,L)
    probs = torch.softmax(scores + mask, dim=-1).to(BF16)
    out = _gqa_out(probs, vs, q.shape[2])
    return project_out(out, p.wo, getattr(p, "mg", None)), cache


# ---- cross attention (VLM) ---------------------------------------------------

def image_kv(p, kv_embeds: torch.Tensor):
    """The image K/V of an ``xattn`` layer: ``kv_embeds (B, N, D)`` ->
    ``(B, N, K, hd)`` each (this rank's KV heads), no RoPE (the layer's
    prefill cache, before its placement)."""
    return _project_kv(p, kv_embeds, p.wk), _project_kv(p, kv_embeds, p.wv)


def attend_image(p, x: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> torch.Tensor:
    """Queries of ``x (B, S, D)`` (no RoPE) against an image's K/V, with no
    mask, projected out.  K/V holding a slice of the image tokens (a cache
    split over them) are read by a softmax over ranks."""
    q = project_in(tpar.copy_to(x, getattr(p, "mg", None)), p.wq)
    if k.shape[1] < p.image_tokens:         # the cache split over tokens
        return _attend_slice(p, q, k, v, None)
    ks, vs = kv_for_heads(p, k, v)
    out = full_attention(q, ks, vs, causal=False)
    return project_out(out, p.wo, getattr(p, "mg", None))


def cross_attention(p, x: torch.Tensor, kv_embeds: torch.Tensor) -> torch.Tensor:
    """x: ``(B, S, D)`` queries; kv_embeds: ``(B, N, D)`` image tokens (no
    mask).  ``p``: an :class:`Attention` (the reference's
    ``init_xattn_params`` is ``init_attn_params``)."""
    return attend_image(p, x, *image_kv(p, kv_embeds))
