"""Analytic FLOP/byte accounting for the roofline terms; the port's own
copy of ``repro/launch/accounting.py`` (plain arithmetic over a config:
every function returns the reference's number exactly).

The reference accounts analytically because XLA's ``cost_analysis()``
counts a while-loop body once, not times its trip count, and its steps
are scans over layers, microbatches and attention/SSM chunks; the port's
eager steps have no such count at all, so the same first-principles
bookkeeping serves both (``chip_smoke.train_bound`` takes its FLOPs from
:func:`step_flops`).

Conventions (the reference's):
  * 2 flops per MAC; backward = 2x forward; remat('full'/'nothing')
    recomputes forward once -> 4x forward total for matmuls.
  * causal attention scores+values: 4*S^2*H*hd per sequence halved for
    causality; sliding window replaces one S by min(S, W).
  * padded Q heads and MoE capacity slack are counted as real work
    (they burn real matrix-unit cycles) -- the useful ratio exposes them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class CellCost:
    flops_total: float          # all chips, one step
    bytes_per_device: float     # HBM traffic per chip, one step
    model_flops: float          # 6*N*D / 2*N_active*D (spec definition)


def _layer_matmul_params(cfg, tp: int) -> Dict[str, float]:
    """Matmul params per layer kind, with TP head padding counted."""
    d, f = cfg.d_model, cfg.d_ff
    hd = cfg.head_dim or 0
    hp = cfg.padded_heads(tp)
    kv = cfg.num_kv_heads
    out = {}
    attn = d * hp * hd + 2 * d * kv * hd + hp * hd * d
    mlp = (3 if cfg.mlp in ("swiglu", "geglu") else 2) * d * f
    if cfg.moe:
        m = cfg.moe
        # dense-dispatch MoE: every expert runs its capacity slice
        cap_work = m.top_k * m.capacity_factor     # tokens of expert work/tok
        out["attn"] = attn + d * m.num_experts + cap_work * 3 * d * m.d_ff
    else:
        out["attn"] = attn + mlp
    out["xattn"] = hp * hd * d * 2 + 2 * d * kv * hd + mlp
    if cfg.ssm:
        di, st, dr = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.dt_rank
        out["mamba"] = (2 * d * di + di * (dr + 2 * st) + dr * di + di * d
                        + di * st)   # scan ~ di*st MACs/token
    if cfg.lru_width:
        w = cfg.lru_width
        out["rglru"] = 2 * d * w + 2 * w * w + w * d + mlp
    return out


def _attn_flops_per_seq(cfg, tp: int, s: int, kind: str) -> float:
    """Score+value flops for ONE sequence in ONE attention layer (fwd)."""
    if not cfg.num_heads:
        return 0.0
    hp = cfg.padded_heads(tp)
    hd = cfg.head_dim
    if kind == "decode":
        s_kv = min(s, cfg.window or s)
        return 4.0 * s_kv * hp * hd               # one query token
    s_kv = min(s, cfg.window or s)
    if cfg.window and cfg.window < s:
        return 4.0 * s * s_kv * hp * hd           # banded
    return 4.0 * s * s * hp * hd * 0.5            # causal half


def step_flops(cfg, tp: int, *, seq: int, batch: int, kind: str,
               remat: str = "full") -> float:
    """Total flops across all chips for one step."""
    pat = cfg.pattern_layers
    per_kind = _layer_matmul_params(cfg, tp)
    tokens = batch * (1 if kind == "decode" else seq)

    matmul = sum(per_kind.get(k, per_kind.get("attn", 0.0)) for k in pat)
    fwd = 2.0 * matmul * tokens
    fwd += 2.0 * cfg.d_model * cfg.vocab_size * (
        batch if kind in ("decode", "prefill") else tokens)   # logits
    n_attn = sum(1 for k in pat if k == "attn")
    n_x = sum(1 for k in pat if k == "xattn")
    fwd += n_attn * batch * _attn_flops_per_seq(cfg, tp, seq, kind)
    if n_x:
        q = 1 if kind == "decode" else seq
        fwd += n_x * batch * 4.0 * q * cfg.num_image_tokens \
            * cfg.padded_heads(tp) * cfg.head_dim

    if kind == "train":
        factor = 3.0 if remat in (None, "everything") else 4.0
        return fwd * factor
    return fwd


def step_bytes_per_device(cfg, tp: int, mesh_size: int, *, seq: int,
                          batch: int, kind: str, accum: int = 1,
                          fsdp: bool = False, state_bytes: int = 4) -> float:
    """Estimated HBM traffic per chip for one step.

    train:  params read per microbatch (fwd + bwd + remat recompute)
            + optimizer update (read p,g,mu,nu; write p,mu,nu)
            + layer-boundary residuals written+read (+logits)
    decode: params once + cache read/modify/write
    prefill: params once + residual/caches written
    """
    p_total = cfg.param_count()
    p_shards = mesh_size if fsdp else tp
    p_dev = p_total * 2.0 / p_shards                 # bf16 compute copies
    d = cfg.d_model
    dp = max(mesh_size // tp, 1)
    b_dev = max(batch // dp, 1)

    if kind == "train":
        b_micro = max(b_dev // accum, 1)
        resid = cfg.num_layers * b_micro * seq * d * 2.0 / tp
        logits = b_micro * seq * cfg.vocab_size * 2.0 / tp
        traffic = accum * (3.0 * p_dev + 2.0 * resid + 2.0 * logits)
        traffic += 7.0 * p_total * state_bytes / p_shards   # adam update
        return traffic

    if kind == "prefill":
        kv = max(cfg.num_kv_heads, 1) * (cfg.head_dim or 0)
        cache = cfg.num_layers * b_dev * min(seq, cfg.window or seq) \
            * kv * 2.0 / tp
        resid = cfg.num_layers * b_dev * seq * d * 2.0 / tp
        return p_dev + cache + 2.0 * resid

    # decode: every live weight + the whole cache crosses HBM once
    kv = max(cfg.num_kv_heads, 1) * (cfg.head_dim or 0)
    cache = cfg.num_layers * b_dev * min(seq, cfg.window or seq) * kv * 4.0 / tp
    if cfg.ssm:
        cache += cfg.num_layers * b_dev * cfg.d_inner \
            * (cfg.ssm.d_state + cfg.ssm.d_conv) * 4.0 / tp
    active_dev = cfg.active_param_count() * 2.0 / p_shards
    return active_dev + cache


def model_flops(cfg, *, seq: int, batch: int, kind: str) -> float:
    """Spec definition: 6*N*D train / 2*N_active*D inference."""
    if kind == "train":
        return 6.0 * cfg.active_param_count() * batch * seq
    if kind == "prefill":
        return 2.0 * cfg.active_param_count() * batch * seq
    return 2.0 * cfg.active_param_count() * batch


def cell_cost(cfg, tp: int, mesh_size: int, *, seq: int, batch: int,
              kind: str, accum: int = 1, remat: str = "full",
              fsdp: bool = False) -> CellCost:
    return CellCost(
        flops_total=step_flops(cfg, tp, seq=seq, batch=batch, kind=kind,
                               remat=remat),
        bytes_per_device=step_bytes_per_device(
            cfg, tp, mesh_size, seq=seq, batch=batch, kind=kind,
            accum=accum, fsdp=fsdp),
        model_flops=model_flops(cfg, seq=seq, batch=batch, kind=kind),
    )
