"""zamba2-1.2b [hybrid]: 38 Mamba2 layers (d_state=64) + a weight-shared
attention(+MLP) block applied every 6 layers.  [arXiv:2411.15242; hf]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32000, ssm_state=64, shared_attn_every=6,
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
    vocab=512, ssm_state=16, ssm_head_dim=16, shared_attn_every=2,
    sub_quadratic=True,
)
