"""whisper-medium [audio enc-dec]: 24+24L d=1024 16H MHA ff=4096 GELU,
learned positions, conv frontend stubbed to precomputed frame embeddings
(per the brief).  max_target_positions extended to 32768 to exercise the
decode_32k cell (official: 448). [arXiv:2212.04356]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, enc_frames=1500, max_target_positions=32768,
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=512, enc_frames=32, max_target_positions=256,
)
