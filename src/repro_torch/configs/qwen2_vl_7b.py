"""qwen2-vl-7b [vlm]: 28L d=3584 28H GQA kv=4 ff=18944, M-RoPE
(sections 16/24/24); vision frontend is a stub providing patch
embeddings per the brief. [arXiv:2409.12191; hf]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152064, rope_theta=1_000_000.0,
    mrope_sections=(16, 24, 24), n_vision_tokens=256, vision_grid=16,
)

SMOKE = ArchConfig(
    name="qwen2-vl-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=160, vocab=512,
    mrope_sections=(2, 3, 3), n_vision_tokens=16, vision_grid=4,
)
