"""Per-layer assembly and the three execution modes (train, prefill and
decode); the port of ``repro/models/blocks.py``.

A *segment* is a repeated pattern of layer kinds: ``("attn",)`` for
homogeneous stacks, ``("rglru", "rglru", "attn")`` for RecurrentGemma,
``("attn",) * 4 + ("xattn",)`` for the vision model.  The reference scans
each segment over stacked params; the port holds one :class:`Block` per
layer in execution order (segment by segment, each pattern repeated ``n``
times), which is the order the scan visits them.

Each kind's cache is a dict: ``{"k", "v"}`` for ``attn`` (the KV cache,
written in place by the decode) and ``xattn`` (the image K/V, read only),
``{"conv", "h"}`` for ``rglru`` and ``{"conv", "ssm"}`` for ``mamba``
(the decode puts the new state into the same dict).

Under tensor parallelism each layer runs its rank's share
(``distributed/tensor_parallel.py``) and each cache leaf holds the rank's
piece by ``distributed.sharding.cache_pspec``: KV heads where ``tp``
divides them, else the positions (or image tokens) where it divides
those, else the whole; the recurrent states their channels.  On a model
sharded over the data axes too (FSDP), each mode reads the layer through
``fsdp.use``: its leaves whole, gathered at use, for this layer alone.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..distributed import fsdp
from ..distributed.sharding import cache_model_dim
from . import attention as attn
from . import mamba as mb
from . import mlp as mlpm
from . import moe as moem
from . import rglru as rg
from .layers import BF16, F32, param, rms_norm

KINDS = ("attn", "xattn", "mamba", "rglru")


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


class Block(torch.nn.Module):
    """One layer: ``norm1`` and its mixer (``attn``, ``xattn``, ``mamba``
    or ``rglru``), then, but for ``mamba``, ``norm2`` and the MLP (``moe``
    in an ``attn`` layer when ``cfg.moe`` is set, else ``mlp``).  The
    submodules' parameter names are the reference's pytree keys.  Norm
    scales are f32."""

    def __init__(self, kind: str, cfg, *, tp: int = 1, device=None,
                 dtype=BF16):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(kind)
        self.kind = kind
        d = cfg.d_model
        self.norm1 = param((d,), device, F32)
        if kind in ("attn", "xattn"):
            self.add_module(kind, attn.Attention(cfg, tp=tp, device=device,
                                                 dtype=dtype))
        elif kind == "mamba":
            self.mamba = mb.Mamba(cfg, device=device, dtype=dtype)
        else:
            self.rglru = rg.RGLRU(cfg, device=device, dtype=dtype)
        if kind == "mamba":
            return
        self.norm2 = param((d,), device, F32)
        if kind == "attn" and cfg.moe is not None:
            self.moe = moem.MoE(cfg, device=device, dtype=dtype)
        else:
            self.mlp = mlpm.MLP(d, cfg.d_ff, cfg.mlp, device=device,
                                dtype=dtype)

    def init_(self, g: torch.Generator) -> None:
        for child in self.children():
            child.init_(g)
        self.norm1.zero_()
        if self.kind != "mamba":
            self.norm2.zero_()

    def ffn(self, x: torch.Tensor, cfg):
        """``x`` plus the MLP (or MoE) of ``norm2(x)``, and the MoE's aux
        loss (None for an MLP)."""
        h2 = rms_norm(x, self.norm2, cfg.norm_eps)
        if hasattr(self, "moe"):
            y, aux = moem.moe_apply(self.moe, h2, cfg)
        else:
            y, aux = mlpm.mlp_apply(self.mlp, h2, cfg.mlp), None
        return x + y, aux


# ---- train forward -----------------------------------------------------------

def apply_layer_train(kind: str, p: Block, x, cfg, tables,
                      image_embeds=None):
    """One layer's training forward, the prefill's arithmetic with no
    cache: ``x (B, S, D)`` bf16 -> (``x``, the MoE aux loss or None)."""
    p = fsdp.use(p)
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    if kind == "attn":
        x = x + attn.attention_train(p.attn, h, tables, cfg)
    elif kind == "xattn":
        if image_embeds is None:
            raise ValueError(f"{cfg.name}: an xattn layer needs "
                             f"image_embeds")
        x = x + attn.cross_attention(p.xattn, h, image_embeds)
    elif kind == "mamba":
        return x + mb.mamba_apply(p.mamba, h, cfg), None
    else:
        x = x + rg.rglru_apply(p.rglru, h, cfg)
    return p.ffn(x, cfg)


# ---- prefill (returns caches) -------------------------------------------------

def apply_layer_prefill(kind: str, p: Block, x, positions, cfg,
                        spec: attn.CacheSpec, tables, image_embeds=None):
    p = fsdp.use(p)
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    if kind == "attn":
        q, k, v = attn._qkv(p.attn, h, tables)
        x = x + attn.attend(p.attn, q, k, v, cfg, chunk=512)
        cache = _placed(_fill_cache(k, v, positions, spec), cfg, p)
    elif kind == "xattn":
        if image_embeds is None:
            raise ValueError(f"{cfg.name}: an xattn layer's prefill needs "
                             f"image_embeds")
        k, v = attn.image_kv(p.xattn, image_embeds)
        x = x + attn.attend_image(p.xattn, h, k, v)
        cache = _placed({"k": k, "v": v}, cfg, p)
    elif kind == "mamba":
        dc = cfg.ssm.d_conv
        u_raw, z = mb.in_proj(p.mamba, h)
        y, state = mb.mamba_mix(p.mamba, u_raw, z, cfg)
        return x + y, {"conv": u_raw[:, -(dc - 1):].contiguous(),
                       "ssm": state}
    else:
        u_raw, g = rg.in_proj(p.rglru, h)
        y, state = rg.rglru_mix(p.rglru, u_raw, g, cfg)
        x = x + y
        cache = {"conv": u_raw[:, -3:].contiguous(), "h": state}
    return p.ffn(x, cfg)[0], cache


def _placed(cache, cfg, p: "Block"):
    """A prefill's K/V cache as this rank keeps it: split over the
    positions (or image tokens) where the rules split it so; the KV-head
    split comes from the projections already."""
    mg = getattr(p, "mesh_mg", None)
    if mg is None:
        return cache
    k = cache["k"]
    shape = k.shape[:2] + (p.get_submodule(p.kind).num_kv_heads, k.shape[3])
    if cache_model_dim("k", shape, cfg, mg.size) != 1:
        return cache
    n = k.shape[1] // mg.size
    return {name: t.narrow(1, mg.rank * n, n).contiguous()
            for name, t in cache.items()}


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
                     device=None, tp: int = 1) -> Dict[str, torch.Tensor]:
    """A layer's zero cache; at ``tp > 1`` the piece one rank of the
    model group holds."""
    if kind in ("attn", "xattn"):
        n = spec.length if kind == "attn" else cfg.num_image_tokens
        shape = [batch, n, cfg.num_kv_heads, cfg.head_dim]
        dim = cache_model_dim("k", shape, cfg, tp)
        if dim is not None:
            shape[dim] //= tp
        return {"k": torch.zeros(shape, dtype=BF16, device=device),
                "v": torch.zeros(shape, dtype=BF16, device=device)}
    if kind == "mamba":
        di = cfg.d_inner
        if cache_model_dim("ssm", (batch, di, cfg.ssm.d_state), cfg,
                           tp) is not None:
            di //= tp
        return mb.init_mamba_cache(cfg, batch, device, di)
    if kind == "rglru":
        w = cfg.lru_width or cfg.d_model
        if cache_model_dim("h", (batch, w), cfg, tp) is not None:
            w //= tp
        return rg.init_rglru_cache(cfg, batch, device, w)
    raise ValueError(kind)


# ---- decode -------------------------------------------------------------------

def apply_layer_decode(kind: str, p: Block, x, pos, cache, spec, cfg,
                       tables):
    """One token through one layer; ``cache`` (the layer's dict) is updated
    in place and returned."""
    p = fsdp.use(p)
    h = rms_norm(x, p.norm1, cfg.norm_eps)
    if kind == "attn":
        y, cache = attn.attention_decode(p.attn, h, pos, cache, spec, cfg,
                                         tables)
    elif kind == "xattn":
        # the image K/V, as the prefill left it (zeros if it never ran)
        y = attn.attend_image(p.xattn, h, cache["k"], cache["v"])
    elif kind == "mamba":
        y, new = mb.mamba_decode(p.mamba, h, cache, cfg)
        cache.update(new)
        return x + y, cache
    else:
        y, new = rg.rglru_decode(p.rglru, h, cache, cfg)
        cache.update(new)
    return p.ffn(x + y, cfg)[0], cache
