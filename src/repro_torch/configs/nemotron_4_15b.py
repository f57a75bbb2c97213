"""nemotron-4-15b [dense]: GQA kv=8, squared-ReLU MLP, RoPE.
[arXiv:2402.16819; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=24576,
    vocab_size=256000,
    mlp="relu2",
    sub_quadratic=False,
    notes="squared-ReLU MLP (2 matmuls), RoPE, GQA 48q/8kv.",
)
