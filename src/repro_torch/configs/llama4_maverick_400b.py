"""llama4-maverick-400b-a17b [moe]: 128 experts top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    mlp="swiglu",
    moe=MoEConfig(num_experts=128, top_k=1, d_ff=8192, capacity_factor=2.0),
    sub_quadratic=False,           # full attention -> long_500k skipped
    notes="true EP: 128 experts / TP=16 = 8 per shard; 40 q heads pad to 48; "
          "FSDP over data axes for the 400B params.",
)
