"""musicgen-large [audio]: decoder-only over EnCodec tokens.
Backbone only — the EnCodec frontend is a stub: train/prefill consume
precomputed frame embeddings (B, S, D); decode consumes code ids.
[arXiv:2306.05284; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    mlp="gelu",
    embed_stub=True,
    sub_quadratic=False,
    notes="MHA (kv == heads == 32, shardable 16-way).",
)
