"""granite-20b [dense]: llama-arch code model, MQA (kv=1).
[arXiv:2405.04324; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp="swiglu",
    sub_quadratic=False,
    notes="MQA: single kv head replicated across TP (1 % 16 != 0).",
)
