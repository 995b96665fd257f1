"""rwkv6-1.6b "Finch" [ssm/linear-attn]: 24L, attention-free time mixing
with data-dependent decay, squared-ReLU channel mix. [arXiv:2404.05892]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="rwkv6-1.6b", family="rwkv",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=7168,
    vocab=65536, rwkv_head_dim=64,
    sub_quadratic=True,
)

SMOKE = ArchConfig(
    name="rwkv6-smoke", family="rwkv",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=224,
    vocab=512, rwkv_head_dim=16,
    sub_quadratic=True,
)
