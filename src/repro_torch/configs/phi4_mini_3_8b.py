"""phi4-mini-3.8b [dense]: RoPE SwiGLU GQA. [arXiv:2412.08905; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=200064,
    mlp="swiglu",
    sub_quadratic=False,
    notes="24 q heads pad to 32 under TP=16.",
)
