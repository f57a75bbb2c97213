"""Model stack: init, prefill and decode; the port of
``repro/models/transformer.py`` for serving.

A :class:`Transformer` holds the tied embedding and every matrix in bf16
once (the reference keeps f32 params and casts each to bf16 at every use:
the same values), and the norm scales in f32.  :func:`init_params` draws
the weights on the model's device from a ``torch.Generator``;
:func:`params_from_jax` carries the JAX package's param pytree over,
unstacking its per-segment leading axis.

Caches are a list with one ``{"k", "v"}`` dict per layer in execution
order; :func:`forward_decode` updates them in place.  ``forward_train``,
``loss_fn`` and the remat policies come with the training slice (ROADMAP
Queue 1 item 5).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.env import resolve_device
from . import attention as attn
from . import blocks
from .layers import (F32, dense_init, embed_lookup, param, rms_norm,
                     rope_tables)

Caches = List[Dict[str, torch.Tensor]]


class Transformer(torch.nn.Module):
    """``embed (V, D)`` (tied with the head), ``final_norm (D,)`` and one
    :class:`~.blocks.Block` per layer in execution order."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
        blocks.check_ported(cfg)
        self.cfg = cfg
        self.embed = param((cfg.vocab_size, cfg.d_model), device)
        self.final_norm = param((cfg.d_model,), device, F32)
        self.layers = torch.nn.ModuleList(
            blocks.Block(kind, cfg, device=device)
            for kind in blocks.layer_kinds(cfg))

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def init_params(cfg, seed: int = 0, *, device=None) -> Transformer:
    """A model with the reference's init scales, drawn on ``device``
    (default CUDA) from ``torch.Generator(device).manual_seed(seed)``."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)
    g = torch.Generator(device=dev).manual_seed(int(seed))
    d = cfg.d_model
    model.embed.copy_(dense_init(g, model.embed.shape, d ** -0.5))
    model.final_norm.zero_()
    for layer in model.layers:
        layer.init_(g)
    return model


@torch.no_grad()
def params_from_jax(tree, cfg, device=None) -> Transformer:
    """The JAX package's ``init_params`` pytree (numpy arrays, f32) as a
    :class:`Transformer` on ``device`` (default CUDA).  Segment ``si``'s
    params are stacked over a leading axis ``n``; layer ``j`` of the
    segment takes index ``j`` of every leaf."""
    dev = resolve_device(device)
    model = Transformer(cfg, device=dev)

    def put(dst: torch.Tensor, arr, what: str) -> None:
        arr = np.array(arr, dtype=np.float32)      # a writable copy
        if tuple(arr.shape) != tuple(dst.shape):
            raise ValueError(f"params_from_jax: {what} has shape "
                             f"{arr.shape}, the model wants {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr))

    put(model.embed, tree["embed"], "embed")
    put(model.final_norm, tree["final_norm"], "final_norm")
    layers = iter(model.layers)
    for si, (pattern, n) in enumerate(blocks.plan_segments(cfg)):
        seg = tree[f"seg{si}"]
        for j in range(n):
            for i, _ in enumerate(pattern):
                src, blk, at = seg[f"sub{i}"], next(layers), f"seg{si}[{j}].sub{i}"
                put(blk.norm1, np.asarray(src["norm1"])[j], f"{at}.norm1")
                put(blk.norm2, np.asarray(src["norm2"])[j], f"{at}.norm2")
                for name in ("wq", "wk", "wv", "wo"):
                    put(getattr(blk.attn, name),
                        np.asarray(src["attn"][name])[j], f"{at}.attn.{name}")
                for name, w in (("w_in", blk.mlp.w_in), ("w_out", blk.mlp.w_out),
                                ("w_gate", blk.mlp.w_gate)):
                    if w is not None:
                        put(w, np.asarray(src["mlp"][name])[j],
                            f"{at}.mlp.{name}")
    return model


def _input_embeds(model: Transformer, batch, cfg) -> torch.Tensor:
    if "image_embeds" in batch:
        raise blocks.not_ported("xattn")
    if cfg.embed_stub and "frames" in batch:
        raise blocks.not_ported("embed_stub")
    return embed_lookup(model.embed, batch["tokens"])


# ---- serving ------------------------------------------------------------------

def init_caches(cfg, batch: int, max_seq: int, device=None) -> Caches:
    """Zeroed KV caches, one dict per layer, on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    spec = attn.cache_spec(cfg, max_seq)
    return [blocks.init_layer_cache(kind, cfg, spec, batch, dev)
            for kind in blocks.layer_kinds(cfg)]


def forward_prefill(model: Transformer, batch, cfg, max_seq: int):
    """Prompt ``{"tokens": (B, S)}`` -> (last-token logits ``(B, V)``
    bf16, caches)."""
    x = _input_embeds(model, batch, cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    tables = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    spec = attn.cache_spec(cfg, max_seq)
    caches = []
    for layer in model.layers:
        x, c = blocks.apply_layer_prefill(layer.kind, layer, x, positions,
                                          cfg, spec, tables)
        caches.append(c)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x[:, -1] @ model.embed.t(), caches


def forward_decode(model: Transformer, batch, caches: Caches, cfg,
                   max_seq: int):
    """One-token step: ``{"token": (B,), "pos": (B,)}`` -> (logits ``(B,
    V)`` bf16, caches updated in place)."""
    pos = batch["pos"]
    x = embed_lookup(model.embed, batch["token"][:, None])
    tables = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    spec = attn.cache_spec(cfg, max_seq)
    for layer, cache in zip(model.layers, caches):
        x, _ = blocks.apply_layer_decode(layer.kind, layer, x, pos, cache,
                                         spec, cfg, tables)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x[:, 0] @ model.embed.t(), caches
