"""granite-34b [dense, code]: 88L d=6144 48H MQA (kv=1), non-gated GELU
MLP ff=24576 (llama-arch w/ MQA). [arXiv:2405.04324; hf]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab=49152, gated_mlp=False,
)

SMOKE = ArchConfig(
    name="granite-smoke", family="dense",
    n_layers=3, d_model=96, n_heads=6, n_kv_heads=1, d_ff=192, vocab=512,
    gated_mlp=False,
)
