"""The model zoo in PyTorch: the port of ``repro/models``.

Every layer kind of the 10 archs trains, prefills and decodes: dense and
MoE ``"attn"`` layers, the recurrent ``"rglru"`` and ``"mamba"`` kinds,
the VLM's ``"xattn"`` cross-attention over image embeddings, and frame
inputs for an ``embed_stub`` (audio) arch.
"""
from .config import ModelConfig, MoEConfig, SSMConfig
from .transformer import (REMAT_POLICIES, Transformer, forward_decode,
                          forward_prefill, forward_train, init_caches,
                          init_params, loss_fn, params_from_jax)

__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "Transformer",
    "init_params", "params_from_jax", "init_caches", "forward_prefill",
    "forward_decode", "forward_train", "loss_fn", "REMAT_POLICIES",
]
