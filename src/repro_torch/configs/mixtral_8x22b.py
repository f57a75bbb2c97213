"""mixtral-8x22b [moe]: 8 experts top-2, SWA. [arXiv:2401.04088; hf]"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=32768,
    mlp="swiglu",
    window=4096,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=16384),
    sub_quadratic=True,            # SWA window 4096: O(S*W)
    notes="8 experts < TP=16: tensor-parallel experts (d_ff sharded); "
          "FSDP over data axes for the 140B params.",
)
