"""stablelm-3b [dense]: 32L d=2560 32H (MHA) SwiGLU ff=6912.
[hf:stabilityai/stablelm-2-1_6b family; unverified]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab=50304,
)

SMOKE = ArchConfig(
    name="stablelm-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=160, vocab=512,
)
