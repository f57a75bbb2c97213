"""The model zoo's serving path in PyTorch: the port of ``repro/models``.

Dense ``"attn"`` stacks (phi4-mini, starcoder2, nemotron-4, granite and
the attention layers of the others) prefill and decode; MoE, the
recurrent kinds and the VLM/audio inputs raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""
from .config import ModelConfig, MoEConfig, SSMConfig
from .transformer import (Transformer, forward_decode, forward_prefill,
                          init_caches, init_params, params_from_jax)

__all__ = [
    "ModelConfig", "MoEConfig", "SSMConfig", "Transformer",
    "init_params", "params_from_jax", "init_caches", "forward_prefill",
    "forward_decode",
]
