"""llama-3.2-vision-11b [vlm]: cross-attn image layers every 5th layer.
Vision tower is a stub: input_specs supplies (B, 1601, D) patch embeddings.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    mlp="swiglu",
    layer_pattern=("attn", "attn", "attn", "attn", "xattn"),
    num_image_tokens=1601,
    sub_quadratic=False,
    notes="8 (4 self + 1 cross) super-blocks = 40 layers.",
)
