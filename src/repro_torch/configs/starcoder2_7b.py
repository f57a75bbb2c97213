"""starcoder2-7b [dense]: GQA kv=4, RoPE. [arXiv:2402.19173; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    mlp="gelu",
    sub_quadratic=False,
    notes="36 q heads pad to 48 under TP=16 (zeroed pad heads).",
)
