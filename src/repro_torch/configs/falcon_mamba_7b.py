"""falcon-mamba-7b [ssm]: Mamba-1, attention-free, d_state=16.
[arXiv:2410.05355; unverified]"""
from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    layer_pattern=("mamba",),
    sub_quadratic=True,            # O(1) state per token
    notes="pure mamba blocks, no attention/MLP; d_inner=8192 TP-sharded.",
)
