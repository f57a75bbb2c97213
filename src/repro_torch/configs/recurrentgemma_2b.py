"""recurrentgemma-2b [hybrid]: RG-LRU + local attention 2:1, GeGLU MLP.
[arXiv:2402.19427; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    mlp="geglu",
    window=2048,
    layer_pattern=("rglru", "rglru", "attn"),
    lru_width=2560,
    sub_quadratic=True,            # recurrence + windowed attention: O(S)
    notes="8 full (rglru,rglru,attn) super-blocks + 2 trailing rglru; "
          "10 q heads pad to 16 under TP=16.",
)
