"""Model configuration for the assigned architecture pool.

One frozen dataclass describes every family (dense / moe / ssm / hybrid /
vlm / audio); per-arch files in repro_torch.configs instantiate it with the
assignment's exact numbers.  The port's own copy of the reference's
``models/config.py`` (which imports no JAX).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden dim
    group_size: int = 2048       # GSPMD dispatch group (tokens)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: Optional[int] = None     # default ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    mlp: str = "swiglu"          # swiglu | relu2 | gelu | geglu
    rope_theta: float = 10000.0
    window: Optional[int] = None          # sliding-window attention
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # layer-kind pattern, cycled to num_layers ("attn" | "rglru" | "mamba"
    # | "xattn"); homogeneous patterns scan over layers, mixed patterns
    # scan over super-blocks of len(pattern) layers.
    layer_pattern: Tuple[str, ...] = ("attn",)
    lru_width: Optional[int] = None       # rg-lru recurrence width
    num_image_tokens: int = 0             # vlm cross-attn kv length
    embed_stub: bool = False              # audio: inputs are frame embeddings
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    sub_quadratic: bool = False           # eligible for long_500k
    scan_layers: bool = True
    notes: str = ""

    def __post_init__(self):
        if self.head_dim is None and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm is not None and self.ssm.dt_rank is None:
            object.__setattr__(
                self, "ssm",
                dataclasses.replace(self.ssm, dt_rank=-(-self.d_model // 16)))

    # ---- derived ------------------------------------------------------------
    @property
    def pattern_layers(self) -> Tuple[str, ...]:
        """The concrete kind of each of the num_layers layers."""
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    def padded_heads(self, tp: int) -> int:
        """Q heads padded up to a multiple of tp (Megatron-style TP padding;
        the roofline's useful-flops ratio accounts the waste honestly)."""
        return -(-self.num_heads // tp) * tp if self.num_heads else 0

    def kv_shardable(self, tp: int) -> bool:
        return self.num_kv_heads > 0 and self.num_kv_heads % tp == 0

    def heads_shardable(self, tp: int) -> bool:
        return self.num_heads > 0 and self.num_heads % tp == 0

    @property
    def d_inner(self) -> int:
        return self.ssm.expand * self.d_model if self.ssm else 0

    def param_count(self) -> int:
        """Analytic N for MODEL_FLOPS = 6*N*D (total params)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd = self.head_dim or 0
        n = v * d  # embed (tied head)
        if not self.tie_embeddings:
            n += v * d
        per = {}
        per["attn"] = d * self.num_heads * hd + 2 * d * self.num_kv_heads * hd \
            + self.num_heads * hd * d + 2 * d
        if self.mlp in ("swiglu", "geglu"):
            per_mlp = 3 * d * f
        else:
            per_mlp = 2 * d * f
        per["attn"] += per_mlp
        per["xattn"] = per["attn"] + d * self.num_heads * hd \
            + 2 * d * self.num_kv_heads * hd + self.num_heads * hd * d
        if self.moe:
            e, fe = self.moe.num_experts, self.moe.d_ff
            per["attn"] = per["attn"] - per_mlp + d * e + e * 3 * d * fe
        if self.ssm:
            di, st, dr = self.d_inner, self.ssm.d_state, self.ssm.dt_rank
            per["mamba"] = (d * 2 * di + self.ssm.d_conv * di
                            + di * (dr + 2 * st) + dr * di + di * st + di
                            + di * d + d)
        if self.lru_width:
            w = self.lru_width
            per["rglru"] = d * 2 * w + 2 * 4 * w + 3 * w + w * d + 3 * d * f + 2 * d
        return n + sum(per.get(k, per.get("attn", 0))
                       for k in self.pattern_layers)

    def active_param_count(self) -> int:
        """N_active for MoE MODEL_FLOPS."""
        if not self.moe:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        e, k, fe = self.moe.num_experts, self.moe.top_k, self.moe.d_ff
        full = self.param_count()
        unused_experts = L * (e - k) * 3 * d * fe
        return full - unused_experts
