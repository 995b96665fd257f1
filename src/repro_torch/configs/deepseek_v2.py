"""deepseek-v2-236b [moe+MLA]: 60L d=5120 128H MLA (kv_lora=512,
q_lora=1536, qk 128 nope + 64 rope, v 128); layer 0 dense (ff 12288),
layers 1..59 MoE with 160 routed experts ff=1536 top-6 + 2 shared.
~236B total / ~21B active. [arXiv:2405.04434; hf]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_ff=1536,
    vocab=102400, use_mla=True, q_lora=1536, kv_lora=512,
    qk_nope=128, qk_rope=64, v_head_dim=128,
    n_experts=160, top_k=6, n_shared_experts=2, d_ff_expert=1536,
    moe_every=1, n_dense_layers=1, dense_d_ff=12288,
)

SMOKE = ArchConfig(
    name="deepseek-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=96, vocab=512,
    use_mla=True, q_lora=32, kv_lora=24, qk_nope=16, qk_rope=8, v_head_dim=16,
    n_experts=8, top_k=2, n_shared_experts=1, d_ff_expert=96,
    moe_every=1, n_dense_layers=1, dense_d_ff=192,
    capacity_factor=8.0,
)
