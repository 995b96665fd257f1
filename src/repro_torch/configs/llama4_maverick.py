"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H GQA kv=8; every 2nd
layer is MoE with 128 routed experts (top-1, sigmoid router) + 1 shared
expert (ff 8192); dense layers ff 16384.  ~400B total / ~17B active.
[hf:meta-llama/Llama-4 family]"""
from .base import ArchConfig

FULL = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202048, d_head=128, rope_theta=500_000.0,
    n_experts=128, top_k=1, n_shared_experts=1, d_ff_expert=8192,
    moe_every=2, dense_d_ff=16384, router_softmax=False,
)

SMOKE = ArchConfig(
    name="llama4-smoke", family="moe",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
    n_experts=8, top_k=1, n_shared_experts=1, d_ff_expert=128,
    moe_every=2, dense_d_ff=256, router_softmax=False,
    capacity_factor=8.0,
)
