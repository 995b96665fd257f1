"""Architecture + shape configuration schema of the LM registry (a copy
of ``repro.configs.base``: the port imports nothing of the JAX package).

One ``ArchConfig`` instance per architecture lives in
``repro_torch/configs/<arch_id>.py`` (exact published hyper-parameters)
as ``FULL``, together with ``SMOKE``, a reduction of the same family for
CPU tests.  The four input shapes are global constants here.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | rwkv | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None    # default: d_model // n_heads
    rope_theta: float = 10000.0
    use_qk_norm: bool = False
    tie_embeddings: bool = False
    gated_mlp: bool = True
    # --- sliding-window pattern (gemma3: 5 local : 1 global) ---
    sliding_window: Optional[int] = None
    global_every: int = 0           # every Nth layer is global (0 = all full)
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: Optional[int] = None
    moe_every: int = 1              # a MoE layer every N layers
    n_dense_layers: int = 0         # leading dense layers (deepseek-v2: 1)
    dense_d_ff: Optional[int] = None  # ffn width of the non-MoE layers
    router_softmax: bool = True
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    moe_impl: str = "gather"   # gather (pjit scatter) | sharded (shard_map local)
    # --- MLA (deepseek-v2) ---
    use_mla: bool = False
    q_lora: int = 1536
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head_dim: int = 128
    # --- SSM / hybrid (zamba2) ---
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    shared_attn_every: int = 0      # hybrid: shared attn+mlp block every N ssm layers
    # --- RWKV ---
    rwkv_head_dim: int = 64
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_frames: int = 1500
    max_target_positions: int = 32768
    # --- VLM (qwen2-vl) ---
    mrope_sections: Optional[Tuple[int, int, int]] = None
    n_vision_tokens: int = 0
    vision_grid: int = 16
    # --- capability flags ---
    sub_quadratic: bool = False     # eligible for long_500k
    has_decoder: bool = True        # encoder-only archs have no decode step
    remat: bool = True              # checkpoint layer bodies in train_step

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    phase: str                      # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

# smoke-test shape: tiny everything, CPU-friendly
SMOKE_SHAPE = ShapeConfig("smoke", 64, 2, "train")
