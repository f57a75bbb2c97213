"""Model stack: init, prefill and decode; the port of
``repro/models/transformer.py`` for serving.

A :class:`Transformer` holds the tied embedding and every matrix in bf16
once (the reference keeps f32 params and casts each to bf16 at every use:
the same values), and the norm scales in f32.  :func:`init_params` draws
the weights on the model's device from a ``torch.Generator``;
:func:`params_from_jax` carries the JAX package's param pytree over,
unstacking its per-segment leading axis.

Caches are a list with one dict per layer in execution order (each
kind's, ``models/blocks.py``); :func:`forward_decode` updates them in
place.  ``forward_train``, ``loss_fn`` and the remat policies come with
the training slice (ROADMAP Queue 1 item 5).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..core.env import resolve_device
from . import attention as attn
from . import blocks
from .layers import (BF16, F32, dense_init, embed_lookup, param, rms_norm,
                     rope_tables)

Caches = List[Dict[str, torch.Tensor]]


class Transformer(torch.nn.Module):
    """``embed (V, D)`` (tied with the head), ``final_norm (D,)`` and one
    :class:`~.blocks.Block` per layer in execution order."""

    def __init__(self, cfg, *, device=None):
        super().__init__()
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


def _leaves(tree, prefix: str = "") -> Dict[str, object]:
    """A nested dict's leaves under their dotted paths."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


@torch.no_grad()
def params_from_jax(tree, cfg, device=None) -> Transformer:
    """The JAX package's ``init_params`` pytree (numpy arrays, f32) as a
    :class:`Transformer` on ``device`` (default CUDA).  Segment ``si``'s
    params are stacked over a leading axis ``n``; layer ``j`` of the
    segment takes index ``j`` of every leaf.  A block's parameter names are
    the pytree's dotted paths (``attn.wq``, ``moe.w_in``, ``rglru.lam``,
    ``mamba.A_log``, ``xattn.wo``, ``mlp.w_gate``, ``norm2``); a leaf
    missing on either side or of another shape raises ``ValueError``."""
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
                src, blk = _leaves(seg[f"sub{i}"]), next(layers)
                at = f"seg{si}[{j}].sub{i}"
                mine = dict(blk.named_parameters())
                if sorted(src) != sorted(mine):
                    raise ValueError(f"params_from_jax: {at} has leaves "
                                     f"{sorted(src)}, the model wants "
                                     f"{sorted(mine)}")
                for name, w in mine.items():
                    put(w, np.asarray(src[name])[j], f"{at}.{name}")
    return model


def _input_embeds(model: Transformer, batch, cfg) -> torch.Tensor:
    if cfg.embed_stub and "frames" in batch:
        return batch["frames"].to(BF16)
    return embed_lookup(model.embed, batch["tokens"])


def _rope(positions: torch.Tensor, cfg):
    """The RoPE tables of a forward's positions (none for an arch without
    attention heads)."""
    if not cfg.num_heads:
        return None
    return rope_tables(positions, cfg.head_dim, cfg.rope_theta)


# ---- serving ------------------------------------------------------------------

def init_caches(cfg, batch: int, max_seq: int, device=None) -> Caches:
    """Zeroed caches, one dict per layer, on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    spec = attn.cache_spec(cfg, max_seq)
    return [blocks.init_layer_cache(kind, cfg, spec, batch, dev)
            for kind in blocks.layer_kinds(cfg)]


def forward_prefill(model: Transformer, batch, cfg, max_seq: int):
    """Prompt ``{"tokens": (B, S)}`` (or ``{"frames": (B, S, D)}`` for an
    ``embed_stub`` arch; ``"image_embeds": (B, N, D)`` for ``xattn``
    layers) -> (last-token logits ``(B, V)`` bf16, caches)."""
    x = _input_embeds(model, batch, cfg)
    img = batch.get("image_embeds")
    if img is not None:
        img = img.to(BF16)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    tables = _rope(positions, cfg)
    spec = attn.cache_spec(cfg, max_seq)
    caches = []
    for layer in model.layers:
        x, c = blocks.apply_layer_prefill(layer.kind, layer, x, positions,
                                          cfg, spec, tables, img)
        caches.append(c)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x[:, -1] @ model.embed.t(), caches


def forward_decode(model: Transformer, batch, caches: Caches, cfg,
                   max_seq: int):
    """One-token step: ``{"token": (B,), "pos": (B,)}`` -> (logits ``(B,
    V)`` bf16, caches updated in place)."""
    pos = batch["pos"]
    x = embed_lookup(model.embed, batch["token"][:, None])
    tables = _rope(pos[:, None], cfg)
    spec = attn.cache_spec(cfg, max_seq)
    for layer, cache in zip(model.layers, caches):
        x, _ = blocks.apply_layer_decode(layer.kind, layer, x, pos, cache,
                                         spec, cfg, tables)
    x = rms_norm(x, model.final_norm, cfg.norm_eps)
    return x[:, 0] @ model.embed.t(), caches
