"""Architecture registry: --arch <id> -> ModelConfig.

The port's own copy of the reference's ``configs`` package: the 10 arch
files are data, and every config equals the reference's field for field.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig, MoEConfig, SSMConfig

from .nemotron_4_15b import CONFIG as _nemotron
from .granite_20b import CONFIG as _granite
from .starcoder2_7b import CONFIG as _starcoder2
from .phi4_mini_3_8b import CONFIG as _phi4
from .recurrentgemma_2b import CONFIG as _rg
from .mixtral_8x22b import CONFIG as _mixtral
from .llama4_maverick_400b import CONFIG as _llama4
from .musicgen_large import CONFIG as _musicgen
from .llama32_vision_11b import CONFIG as _llama_vision
from .falcon_mamba_7b import CONFIG as _falcon_mamba

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        _nemotron, _granite, _starcoder2, _phi4, _rg, _mixtral, _llama4,
        _musicgen, _llama_vision, _falcon_mamba,
    ]
}

# archs whose params are sharded fully (FSDP) when they train; the
# dense 15-20B archs keep tensor parallelism with sharded optimizer
# state.  The sets are the reference's: the training slice reads them.
FSDP_ARCHS = {"mixtral-8x22b", "llama4-maverick-400b-a17b"}

# archs whose training state is kept in bf16 (the 100B+ MoEs)
BF16_STATE_ARCHS = {"mixtral-8x22b", "llama4-maverick-400b-a17b"}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def reduced_config(name: str) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    cfg = get_config(name)
    pat = cfg.layer_pattern
    layers = max(len(pat), 2 * len(pat))
    kw = dict(
        num_layers=layers,
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else None,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        window=min(cfg.window, 32) if cfg.window else None,
        lru_width=64 if cfg.lru_width else None,
        num_image_tokens=8 if cfg.num_image_tokens else 0,
    )
    if cfg.moe:
        # capacity 8.0: no token dropping at smoke scale, so the cached
        # decode path is exactly comparable with the full forward
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4,
                                        top_k=cfg.moe.top_k, d_ff=64,
                                        group_size=64, capacity_factor=8.0)
    if cfg.ssm:
        kw["ssm"] = SSMConfig(d_state=4, d_conv=4, expand=2, dt_rank=8)
    return dataclasses.replace(cfg, **kw)
