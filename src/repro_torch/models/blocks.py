"""Per-layer assembly and the serving modes (prefill and decode); the port
of ``repro/models/blocks.py``.

A *segment* is a repeated pattern of layer kinds (``("attn",)`` for the
dense stacks).  The reference scans each segment over stacked params; the
port holds one :class:`Block` per layer in execution order (segment by
segment, each pattern repeated ``n`` times), which is the order the scan
visits them.

Only the ``"attn"`` kind with a dense MLP is ported.  ``xattn`` waits for
the VLM/audio item, ``mamba`` and ``rglru`` for the recurrent kinds, and
``cfg.moe`` for the MoE item (ROADMAP Queue 1 item 5); each raises
:class:`NotImplementedError` naming it.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import attention as attn
from . import mlp as mlpm
from .layers import BF16, F32, param, rms_norm

# the ROADMAP item (Queue 1 item 5) that ports each branch not yet here
_LATER = {
    "xattn": "VLM/audio (xattn, embed_stub)",
    "embed_stub": "VLM/audio (xattn, embed_stub)",
    "mamba": "the recurrent kinds (rglru.py, mamba.py)",
    "rglru": "the recurrent kinds (rglru.py, mamba.py)",
    "moe": "MoE (models/moe.py)",
}


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP Queue 1 item 5, "
        f"{_LATER[what]}")


def plan_segments(cfg) -> List[Tuple[Tuple[str, ...], int]]:
    p = cfg.layer_pattern
    n_full = cfg.num_layers // len(p)
    segs = [(p, n_full)]
    rem = cfg.num_layers - n_full * len(p)
    if rem:
        segs.append((p[:rem], 1))
    return segs


def layer_kinds(cfg) -> List[str]:
    """The kind of each layer in execution order (segment by segment)."""
    return [kind for pattern, n in plan_segments(cfg)
            for _ in range(n) for kind in pattern]


def check_ported(cfg) -> None:
    """Raise :class:`NotImplementedError` for an arch this slice cannot
    run."""
    if cfg.moe is not None:
        raise not_ported("moe")
    for kind in layer_kinds(cfg):
        if kind != "attn":
            raise not_ported(kind)


class Block(torch.nn.Module):
    """One ``"attn"`` layer: ``norm1``, attention, ``norm2``, dense MLP.
    Norm scales are f32, the matrices bf16."""

    def __init__(self, kind: str, cfg, *, device=None):
        super().__init__()
        if kind != "attn":
            raise not_ported(kind) if kind in _LATER else ValueError(kind)
        if cfg.moe is not None:
            raise not_ported("moe")
        self.kind = kind
        d = cfg.d_model
        self.norm1 = param((d,), device, F32)
        self.attn = attn.Attention(cfg, device=device)
        self.norm2 = param((d,), device, F32)
        self.mlp = mlpm.MLP(d, cfg.d_ff, cfg.mlp, device=device)

    def init_(self, g: torch.Generator) -> None:
        self.norm1.zero_()
        self.norm2.zero_()
        self.attn.init_(g)
        self.mlp.init_(g)


# ---- prefill (returns caches) -------------------------------------------------

def apply_layer_prefill(kind: str, p: Block, x, positions, cfg,
                        spec: attn.CacheSpec, tables):
    if kind != "attn":
        raise not_ported(kind)
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    q, k, v = attn._qkv(p.attn, h, tables)
    if x.shape[1] <= 2048:
        out = attn.full_attention(q, k, v, window=cfg.window)
    else:
        out = attn.chunked_attention(q, k, v, window=cfg.window)
    x = x + attn.project_out(out, p.attn.wo)
    cache = _fill_cache(k, v, positions, spec)
    h2 = rms_norm(x, p.norm2, cfg.norm_eps)
    x = x + mlpm.mlp_apply(p.mlp, h2, cfg.mlp)
    return x, cache


def _fill_cache(k, v, positions, spec: attn.CacheSpec) -> Dict[str, torch.Tensor]:
    b, s = k.shape[0], k.shape[1]
    keep = min(s, spec.length)
    ck = torch.zeros((b, spec.length) + tuple(k.shape[2:]), dtype=BF16,
                     device=k.device)
    cv = torch.zeros_like(ck)
    if spec.ring:
        slots = torch.remainder(positions[:, -keep:], spec.length)
        bi = torch.arange(b, device=k.device)[:, None]
        ck[bi, slots] = k[:, -keep:]
        cv[bi, slots] = v[:, -keep:]
    else:
        ck[:, :keep] = k[:, :keep]
        cv[:, :keep] = v[:, :keep]
    return {"k": ck, "v": cv}


def init_layer_cache(kind: str, cfg, spec: attn.CacheSpec, batch: int,
                     device=None) -> Dict[str, torch.Tensor]:
    if kind == "attn":
        return attn.init_cache(cfg, spec, batch, device)
    raise not_ported(kind) if kind in _LATER else ValueError(kind)


# ---- decode -------------------------------------------------------------------

def apply_layer_decode(kind: str, p: Block, x, pos, cache, spec, cfg,
                       tables):
    if kind != "attn":
        raise not_ported(kind)
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    y, cache = attn.attention_decode(p.attn, h, pos, cache, spec, cfg,
                                     tables)
    x = x + y
    h2 = rms_norm(x, p.norm2, cfg.norm_eps)
    x = x + mlpm.mlp_apply(p.mlp, h2, cfg.mlp)
    return x, cache
