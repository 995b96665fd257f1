"""Attention blocks: GQA/MQA (full, sliding-window, cross) and DeepSeek MLA
(port of ``repro.models.attention``).

Each block exposes:
  *_specs(cfg)                      — ParamSpec tree for one layer
  *_forward(p, x, ...)              — full-sequence (train / prefill)
  *_decode(p, x, cache, pos, ...)   — single-token step against a KV cache

Caches are plain dicts of tensors.  Sliding-window layers use a
ring-buffer cache of exactly ``window`` slots.  MLA decode uses the
*absorbed* low-rank form: only the latent and the shared rope key are
cached, and W_UK/W_UV are folded into the score/output projections.

Differences from JAX that the port spells out:

* ``jnp.einsum`` promotes mixed dtypes (a float32 query against a
  bfloat16 cache computes in float32); ``torch.einsum`` refuses them, so
  :func:`_einsum` promotes first.  The softmax weights are still cast to
  the value dtype before the weighted sum, as in JAX.
* ``pos`` is a Python int: the slot arithmetic needs no device scalar and
  no host sync.  JAX's ``dynamic_update_slice`` clamps a start past the
  cache; here a position past a full cache raises instead.
* The decode steps write the new K/V (or latent) into the cache in place
  and return the same dict; JAX returns new arrays.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .common import ParamSpec, apply_mrope, apply_rope, causal_mask, rms_norm, sliding_mask

NEG_INF = -1e30   # masked scores, float32, as in JAX


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` after JAX's dtype promotion of the operands."""
    dt = ops[0].dtype
    for o in ops[1:]:
        dt = torch.promote_types(dt, o.dtype)
    return torch.einsum(eq, *(o.to(dt) for o in ops))


# ---------------------------------------------------------------------------
# GQA / MQA
# ---------------------------------------------------------------------------


def gqa_specs(d_model: int, n_heads: int, n_kv: int, d_head: int,
              use_qk_norm: bool = False) -> dict:
    s = {
        "wq": ParamSpec((d_model, n_heads, d_head), ("embed", "heads", "head_dim"), "scaled"),
        "wk": ParamSpec((d_model, n_kv, d_head), ("embed", "kv_heads", "head_dim"), "scaled"),
        "wv": ParamSpec((d_model, n_kv, d_head), ("embed", "kv_heads", "head_dim"), "scaled"),
        "wo": ParamSpec((n_heads, d_head, d_model), ("heads", "head_dim", "embed"), "scaled"),
    }
    if use_qk_norm:
        s["q_norm"] = ParamSpec((d_head,), ("head_dim",), "zeros")
        s["k_norm"] = ParamSpec((d_head,), ("head_dim",), "zeros")
    return s


def _project_qkv(p: dict, x: torch.Tensor):
    q = _einsum("bsd,dhk->bshk", x, p["wq"])
    k = _einsum("bsd,dhk->bshk", x, p["wk"])
    v = _einsum("bsd,dhk->bshk", x, p["wv"])
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    return q, k, v


def _gqa_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: Optional[torch.Tensor]) -> torch.Tensor:
    """q: (B,Sq,H,D); k,v: (B,Sk,Kv,D); mask: (Sq,Sk) or (B,Sq,Sk) or None.

    Scores in float32 (promoted), masked to -1e30, a float32 softmax, the
    weights cast to v's dtype for the weighted sum: JAX's steps.
    """
    b, sq, h, d = q.shape
    kv = k.shape[2]
    group = h // kv
    q = q.reshape(b, sq, kv, group, d)
    scores = _einsum("bskgd,btkd->bkgst", q, k).float()
    scores = scores / math.sqrt(d)
    if mask is not None:
        m = mask if mask.dim() == 3 else mask[None]
        scores = torch.where(m[:, None, None, :, :], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = _einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(b, sq, h, v.shape[-1])


Q_BLOCK = 1024
_BLOCKED_MIN_SEQ = 2048  # below this the plain (S, S) path is cheaper


def _attend_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  start_q: int, start_k: int, window: Optional[int]
                  ) -> torch.Tensor:
    """One query block of :func:`_attend_qblocks` against its KV slice."""
    qi = start_q + torch.arange(q.shape[1], device=q.device)[:, None]
    kj = start_k + torch.arange(k.shape[1], device=q.device)[None, :]
    m = kj <= qi
    if window is not None:
        m &= kj > qi - window
    return _gqa_attend(q, k, v, m[None].expand(q.shape[0], *m.shape))


def _attend_qblocks(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: Optional[int] = None, q_block: int = Q_BLOCK):
    """Causal GQA attention over query blocks.

    Bounds live score memory to (B, H, q_block, L) where L = Sk (full) or
    window + q_block (sliding — the KV slice is narrowed per block, so
    sliding layers are O(S*w) compute AND memory).  The queries are padded
    to a multiple of ``q_block`` (padded rows are cropped), and each block
    is JAX's scan step: the same slice, mask and :func:`_gqa_attend`.
    Under autograd each block is checkpointed, as JAX's scan step is: the
    backward pass recomputes its scores instead of keeping every block's
    softmax weights (the whole (S, S) matrix).
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    pad = -sq % q_block
    if pad:  # padded query rows see only kv[0], get cropped after
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    nb = (sq + pad) // q_block
    use_slice = window is not None and window + q_block < sk
    l_kv = window + q_block if use_slice else sk
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    outs = []
    for i in range(nb):
        start_q = i * q_block
        start_k = (min(max(start_q + q_block - l_kv, 0), sk - l_kv)
                   if use_slice else 0)
        args = (q[:, start_q:start_q + q_block], k[:, start_k:start_k + l_kv],
                v[:, start_k:start_k + l_kv], start_q, start_k, window)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False)
                    if grad else _attend_block(*args))
    return torch.cat(outs, dim=1)[:, :sq]


def attend_causal(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: Optional[int] = None, q_offset: int = 0):
    """Causal (optionally sliding-window) attention; picks the blocked path
    for long sequences.  q_offset: absolute position of q[0]."""
    sq = q.shape[1]
    if sq >= _BLOCKED_MIN_SEQ and q_offset == 0 and sq == k.shape[1]:
        return _attend_qblocks(q, k, v, window=window)
    sk = k.shape[1]
    mask = (sliding_mask(sq, sk, window, q_offset, q.device) if window is not None
            else causal_mask(sq, sk, q_offset, q.device))
    return _gqa_attend(q, k, v, mask)


def _rotate_qk(q, k, positions, rope_theta, mrope_sections, mrope_positions,
               use_rope):
    if mrope_sections is not None:
        return (apply_mrope(q, mrope_positions, mrope_sections, rope_theta),
                apply_mrope(k, mrope_positions, mrope_sections, rope_theta))
    if use_rope:
        return (apply_rope(q, positions, rope_theta),
                apply_rope(k, positions, rope_theta))
    return q, k


def gqa_forward(p: dict, x: torch.Tensor, *, positions: torch.Tensor,
                rope_theta: float = 10000.0, window: Optional[int] = None,
                mrope_sections: Optional[tuple] = None,
                mrope_positions: Optional[torch.Tensor] = None,
                bidirectional: bool = False, use_rope: bool = True) -> torch.Tensor:
    """Full-sequence GQA. x: (B,S,D); positions: (B,S) int32."""
    q, k, v = _project_qkv(p, x)
    q, k = _rotate_qk(q, k, positions, rope_theta, mrope_sections,
                      mrope_positions, use_rope)
    if bidirectional:
        out = _gqa_attend(q, k, v, None)
    else:
        out = attend_causal(q, k, v, window=window)
    return _einsum("bshk,hkd->bsd", out, p["wo"])


def gqa_init_cache(n_layers: int, batch: int, max_seq: int, n_kv: int, d_head: int,
                   window: Optional[int] = None, dtype=torch.bfloat16,
                   device="cuda") -> dict:
    """Stacked (over layers) KV cache; ring-buffer when ``window`` is set."""
    slots = min(window, max_seq) if window is not None else max_seq
    cache = {
        "k": torch.zeros((n_layers, batch, slots, n_kv, d_head), dtype=dtype, device=device),
        "v": torch.zeros((n_layers, batch, slots, n_kv, d_head), dtype=dtype, device=device),
    }
    if window is not None:
        cache["slot_pos"] = torch.full((n_layers, slots), -1, dtype=torch.int32,
                                       device=device)
    return cache


def cache_axes(window: Optional[int] = None) -> dict:
    """Logical axes of one stacked GQA cache (for sharding rules)."""
    kv = {"k": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
          "v": ("layers", "batch", "cache_seq", "kv_heads", "head_dim")}
    if window is not None:
        kv["slot_pos"] = ("layers", "cache_seq")
    return kv


def gqa_fill_cache(p: dict, x: torch.Tensor, *, positions, rope_theta=10000.0,
                   window: Optional[int] = None, max_seq: int = 0,
                   mrope_sections=None, mrope_positions=None, use_rope: bool = True):
    """Prefill: run full-seq attention AND return this layer's cache entries."""
    q, k, v = _project_qkv(p, x)
    q, k = _rotate_qk(q, k, positions, rope_theta, mrope_sections,
                      mrope_positions, use_rope)
    s = x.shape[1]
    out = attend_causal(q, k, v, window=window)
    out = _einsum("bshk,hkd->bsd", out, p["wo"])
    if window is not None:  # ring layout: absolute pos t lives at slot t % window
        b, _, n_kv, d_head = k.shape
        take = min(window, s)
        t_abs = torch.arange(s - take, s, dtype=torch.int32, device=x.device)
        idx = (t_abs % window).long()
        k_c = k.new_zeros((b, window, n_kv, d_head))
        v_c = v.new_zeros((b, window, n_kv, d_head))
        k_c[:, idx] = k[:, s - take:]
        v_c[:, idx] = v[:, s - take:]
        slot_abs = torch.full((window,), -1, dtype=torch.int32, device=x.device)
        slot_abs[idx] = t_abs
        return out, {"k": k_c, "v": v_c, "slot_pos": slot_abs}
    pad = max_seq - s
    k_c = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    v_c = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    return out, {"k": k_c, "v": v_c}


def _check_pos(pos: int, slots: int) -> None:
    if not 0 <= pos < slots:
        raise ValueError(f"decode position {pos} outside a cache of {slots} "
                         f"slots (size max_seq to the prompt and new tokens)")


def gqa_decode(p: dict, x: torch.Tensor, layer_cache: dict, pos: int, *,
               rope_theta=10000.0, window: Optional[int] = None,
               mrope_sections=None, mrope_positions=None, use_rope: bool = True):
    """One-token step. x: (B,1,D); pos: the current position (an int).

    Writes the new K/V into ``layer_cache`` in place; returns (out
    (B,1,D), the cache).
    """
    q, k, v = _project_qkv(p, x)
    pos_arr = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
    q, k = _rotate_qk(q, k, pos_arr, rope_theta, mrope_sections,
                      mrope_positions, use_rope)
    k_cache, v_cache = layer_cache["k"], layer_cache["v"]
    slots = k_cache.shape[1]
    if window is not None:
        slot = pos % slots
    else:
        _check_pos(pos, slots)
        slot = pos
    k_cache[:, slot] = k[:, 0]
    v_cache[:, slot] = v[:, 0]
    if window is not None:
        slot_pos = layer_cache["slot_pos"]
        slot_pos[slot].fill_(pos)   # `slot_pos[slot] = pos` copies from the host
        valid = (slot_pos >= 0) & (slot_pos > pos - window) & (slot_pos <= pos)
        mask = valid[None, None, :]                       # (1,1,slots)
    else:
        mask = (torch.arange(slots, device=x.device) <= pos)[None, None, :]
    out = _gqa_attend(q, k_cache, v_cache, mask.expand(x.shape[0], 1, slots))
    return _einsum("bshk,hkd->bsd", out, p["wo"]), layer_cache


# ---------------------------------------------------------------------------
# Cross attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_forward(p: dict, x: torch.Tensor, enc_k: torch.Tensor, enc_v: torch.Tensor):
    """x: (B,S,D); enc_k/enc_v: (B,T,Kv,D) precomputed from encoder output."""
    q = _einsum("bsd,dhk->bshk", x, p["wq"])
    out = _gqa_attend(q, enc_k, enc_v, None)
    return _einsum("bshk,hkd->bsd", out, p["wo"])


def cross_encode_kv(p: dict, enc_out: torch.Tensor):
    k = _einsum("btd,dhk->bthk", enc_out, p["wk"])
    v = _einsum("btd,dhk->bthk", enc_out, p["wv"])
    return k, v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2): multi-head latent attention
# ---------------------------------------------------------------------------


def mla_specs(d_model: int, n_heads: int, *, q_lora: int, kv_lora: int,
              qk_nope: int, qk_rope: int, v_dim: int) -> dict:
    return {
        "wq_a": ParamSpec((d_model, q_lora), ("embed", "q_lora"), "scaled"),
        "q_norm": ParamSpec((q_lora,), ("q_lora",), "zeros"),
        "wq_b": ParamSpec((q_lora, n_heads, qk_nope + qk_rope),
                          ("q_lora", "heads", "head_dim"), "scaled"),
        "wkv_a": ParamSpec((d_model, kv_lora + qk_rope), ("embed", "kv_lora"), "scaled"),
        "kv_norm": ParamSpec((kv_lora,), ("kv_lora",), "zeros"),
        "wk_b": ParamSpec((kv_lora, n_heads, qk_nope), ("kv_lora", "heads", "head_dim"), "scaled"),
        "wv_b": ParamSpec((kv_lora, n_heads, v_dim), ("kv_lora", "heads", "head_dim"), "scaled"),
        "wo": ParamSpec((n_heads, v_dim, d_model), ("heads", "head_dim", "embed"), "scaled"),
    }


def _mla_qkv(p: dict, x: torch.Tensor, positions, rope_theta, qk_nope: int, qk_rope: int):
    c_q = rms_norm(x @ p["wq_a"], p["q_norm"])
    q = _einsum("bsq,qhk->bshk", c_q, p["wq_b"])
    q_nope, q_rope = q[..., :qk_nope], q[..., qk_nope:]
    q_rope = apply_rope(q_rope, positions, rope_theta)
    kv_a = x @ p["wkv_a"]
    kv_lora = p["kv_norm"].shape[0]
    c_kv = rms_norm(kv_a[..., :kv_lora], p["kv_norm"])        # (B,S,kv_lora)
    k_rope = kv_a[..., kv_lora:][:, :, None, :]                # (B,S,1,rope)
    k_rope = apply_rope(k_rope, positions, rope_theta)[:, :, 0, :]
    return q_nope, q_rope, c_kv, k_rope


def mla_forward(p: dict, x: torch.Tensor, *, positions, rope_theta: float,
                qk_nope: int, qk_rope: int) -> torch.Tensor:
    """Full-sequence MLA, expanded form (train / prefill), q-blocked when
    long: q/k = [nope | rope] per head (the 1/sqrt(nope+rope) scale falls
    out of the concatenated head dim), v has its own dim."""
    b, s, _ = x.shape
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, positions, rope_theta, qk_nope, qk_rope)
    k_nope = _einsum("bsc,chk->bshk", c_kv, p["wk_b"])
    v = _einsum("bsc,chv->bshv", c_kv, p["wv_b"])
    h = q_nope.shape[2]
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(b, s, h, qk_rope)], dim=-1)
    out = attend_causal(q, k, v)
    return _einsum("bshv,hvd->bsd", out, p["wo"])


def mla_init_cache(n_layers: int, batch: int, max_seq: int, kv_lora: int,
                   qk_rope: int, dtype=torch.bfloat16, device="cuda") -> dict:
    return {
        "c_kv": torch.zeros((n_layers, batch, max_seq, kv_lora), dtype=dtype, device=device),
        "k_rope": torch.zeros((n_layers, batch, max_seq, qk_rope), dtype=dtype, device=device),
    }


def mla_cache_axes() -> dict:
    return {"c_kv": ("layers", "batch", "cache_seq", "kv_lora"),
            "k_rope": ("layers", "batch", "cache_seq", None)}


def mla_fill_cache(p: dict, x: torch.Tensor, *, positions, rope_theta, qk_nope,
                   qk_rope, max_seq: int):
    out = mla_forward(p, x, positions=positions, rope_theta=rope_theta,
                      qk_nope=qk_nope, qk_rope=qk_rope)
    _, _, c_kv, k_rope = _mla_qkv(p, x, positions, rope_theta, qk_nope, qk_rope)
    pad = max_seq - x.shape[1]
    return out, {
        "c_kv": torch.nn.functional.pad(c_kv, (0, 0, 0, pad)),
        "k_rope": torch.nn.functional.pad(k_rope, (0, 0, 0, pad)),
    }


def mla_decode(p: dict, x: torch.Tensor, layer_cache: dict, pos: int, *,
               rope_theta: float, qk_nope: int, qk_rope: int):
    """Absorbed-form single-token MLA: cache only (c_kv, k_rope), written
    in place.

    scores_t = q_nope W_UK c_kv_t + q_rope k_rope_t  (W_UK absorbed into q)
    out      = (attn @ c_kv) W_UV                    (W_UV absorbed after)
    """
    b = x.shape[0]
    pos_arr = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(
        p, x, pos_arr, rope_theta, qk_nope, qk_rope)
    c_cache, r_cache = layer_cache["c_kv"], layer_cache["k_rope"]
    slots = c_cache.shape[1]
    _check_pos(pos, slots)
    c_cache[:, pos] = c_kv_new[:, 0]
    r_cache[:, pos] = k_rope_new[:, 0]
    q_eff = _einsum("bshk,chk->bshc", q_nope, p["wk_b"])     # absorb W_UK
    scale = 1.0 / math.sqrt(qk_nope + qk_rope)
    scores = (_einsum("bshc,btc->bhst", q_eff, c_cache)
              + _einsum("bshk,btk->bhst", q_rope, r_cache)).float() * scale
    mask = (torch.arange(slots, device=x.device) <= pos)[None, None, None, :]
    w = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1).to(x.dtype)
    out_c = _einsum("bhst,btc->bshc", w, c_cache)             # (B,1,H,kv_lora)
    out = _einsum("bshc,chv->bshv", out_c, p["wv_b"])         # absorb W_UV
    out = _einsum("bshv,hvd->bsd", out, p["wo"])
    return out, layer_cache
