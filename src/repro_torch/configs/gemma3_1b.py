"""gemma3-1b [dense]: 26L d=1152 4H MQA (kv=1) head_dim=256, 5 local
(sliding 512) : 1 global pattern, qk-norm, tied 262k embeddings.
[hf:google/gemma-3-1b-pt]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab=262144, d_head=256, sliding_window=512, global_every=6,
    use_qk_norm=True, tie_embeddings=True, rope_theta=1_000_000.0,
    sub_quadratic=True,   # decode cost dominated by 512-wide local windows
)

SMOKE = ArchConfig(
    name="gemma3-smoke", family="dense",
    n_layers=4, d_model=64, n_heads=2, n_kv_heads=1, d_ff=128,
    vocab=512, d_head=32, sliding_window=16, global_every=2,
    use_qk_norm=True, tie_embeddings=True,
    sub_quadratic=True,
)
