"""Whisper-style encoder-decoder backbone (port of ``repro.models.encdec``).

The audio conv frontend is a STUB: the inputs are precomputed frame
embeddings (B, enc_frames, d_model).  The transformer backbone: pre-LN
encoder with bidirectional self-attention and learned positions, decoder
with causal self-attention + cross attention, no RoPE (whisper uses
absolute embeddings).

Decode caches: decoder self-attention KV (ring-free, full) plus the
cross-attention K/V computed once from the encoder output at prefill.
``decode_step`` writes the self-attention KV in place.

Recomputation, as JAX's: with ``cfg.remat`` every encoder layer is
checkpointed (``torch.utils.checkpoint``) whatever the phase, and every
decoder layer of the training loss; the backward pass recomputes them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from . import attention as attn
from .common import (ParamSpec, chunked_softmax_ce, layer_norm, positions,
                     stack_specs, tree_index)


def _mlp_gelu(p, x):
    return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]


def _mlp_gelu_specs(d_model, d_ff):
    return {"w_up": ParamSpec((d_model, d_ff), ("embed", "mlp"), "scaled"),
            "w_down": ParamSpec((d_ff, d_model), ("mlp", "embed"), "scaled")}


def _ln_specs(d):
    return {"g": ParamSpec((d,), ("embed",), "ones"),
            "b": ParamSpec((d,), ("embed",), "zeros")}


def _ln(p, x):
    return layer_norm(x, p["g"], p["b"])


def build_param_specs(cfg: ArchConfig) -> dict:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    enc_layer = {"ln1": _ln_specs(d), "attn": attn.gqa_specs(d, h, kv, dh),
                 "ln2": _ln_specs(d), "mlp": _mlp_gelu_specs(d, cfg.d_ff)}
    dec_layer = {"ln1": _ln_specs(d), "self_attn": attn.gqa_specs(d, h, kv, dh),
                 "ln2": _ln_specs(d), "cross_attn": attn.gqa_specs(d, h, kv, dh),
                 "ln3": _ln_specs(d), "mlp": _mlp_gelu_specs(d, cfg.d_ff)}
    return {
        "enc_pos": ParamSpec((cfg.enc_frames, d), (None, "embed")),
        "enc_layers": stack_specs(enc_layer, cfg.n_enc_layers),
        "enc_norm": _ln_specs(d),
        "embed": ParamSpec((cfg.vocab, d), ("vocab", "embed")),
        "dec_pos": ParamSpec((cfg.max_target_positions, d), (None, "embed")),
        "dec_layers": stack_specs(dec_layer, cfg.n_layers),
        "dec_norm": _ln_specs(d),
    }


def _maybe_remat(fn, remat: bool, *args):
    """``fn(*args)``, checkpointed under autograd when ``remat``."""
    if remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _encoder_layer(lp: dict, x: torch.Tensor, pos_ids: torch.Tensor) -> torch.Tensor:
    h = _ln(lp["ln1"], x)
    x = x + attn.gqa_forward(lp["attn"], h, positions=pos_ids,
                             bidirectional=True, use_rope=False)
    h = _ln(lp["ln2"], x)
    return x + _mlp_gelu(lp["mlp"], h)


def encode(params: dict, frames: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """frames: (B, T, D) stub embeddings -> encoder hidden states."""
    t = frames.shape[1]
    x = frames + params["enc_pos"][:t][None]
    pos_ids = positions(frames.shape[0], t, frames.device)
    for i in range(cfg.n_enc_layers):
        x = _maybe_remat(_encoder_layer, cfg.remat,
                         tree_index(params["enc_layers"], i), x, pos_ids)
    return _ln(params["enc_norm"], x)


def _decoder_layer(lp: dict, x: torch.Tensor, self_attn, ek, ev) -> torch.Tensor:
    """One decoder layer around ``self_attn(h) -> (B, S, D)``."""
    x = x + self_attn(_ln(lp["ln1"], x))
    x = x + attn.cross_forward(lp["cross_attn"], _ln(lp["ln2"], x), ek, ev)
    return x + _mlp_gelu(lp["mlp"], _ln(lp["ln3"], x))


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens] + params["dec_pos"][:tokens.shape[1]][None]


def _train_decoder_layer(lp: dict, x: torch.Tensor, enc_out: torch.Tensor,
                         pos_ids: torch.Tensor) -> torch.Tensor:
    ek, ev = attn.cross_encode_kv(lp["cross_attn"], enc_out)
    return _decoder_layer(
        lp, x, lambda h: attn.gqa_forward(lp["self_attn"], h, positions=pos_ids,
                                          use_rope=False), ek, ev)


def loss_fn(params: dict, batch: dict, cfg: ArchConfig):
    """Next-token cross entropy of the decoder -> (ce, metrics)."""
    tokens = batch["tokens"]
    enc_out = encode(params, batch["frames"], cfg)
    x = _embed(params, tokens)
    pos_ids = positions(*tokens.shape, tokens.device)
    for i in range(cfg.n_layers):
        x = _maybe_remat(_train_decoder_layer, cfg.remat,
                         tree_index(params["dec_layers"], i), x, enc_out, pos_ids)
    hidden = _ln(params["dec_norm"], x)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    ce = chunked_softmax_ce(hidden[:, :-1], params["embed"].T,
                            torch.clamp(labels[:, 1:], min=0), mask[:, 1:])
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


def cache_structure(cfg: ArchConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
                    abstract: bool = True, device="cuda"):
    l, kv, dh = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    dev = "meta" if abstract else device
    shapes = {"self_k": (l, batch, max_seq, kv, dh),
              "self_v": (l, batch, max_seq, kv, dh),
              "cross_k": (l, batch, cfg.enc_frames, kv, dh),
              "cross_v": (l, batch, cfg.enc_frames, kv, dh)}
    cache = {k: torch.zeros(s, dtype=dtype, device=dev) for k, s in shapes.items()}
    axes = {
        "self_k": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
        "self_v": ("layers", "batch", "cache_seq", "kv_heads", "head_dim"),
        "cross_k": ("layers", "batch", None, "kv_heads", "head_dim"),
        "cross_v": ("layers", "batch", None, "kv_heads", "head_dim"),
    }
    return cache, axes


def prefill(params: dict, batch: dict, cfg: ArchConfig, max_seq: int,
            cache_dtype=torch.bfloat16):
    """Encode frames + run the decoder prompt; emit self+cross caches."""
    enc_out = encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    x = _embed(params, tokens)
    pos_ids = positions(*tokens.shape, tokens.device)
    layers = []
    for i in range(cfg.n_layers):
        lp = tree_index(params["dec_layers"], i)
        kvs = {}

        def self_attn(h, lp=lp, kvs=kvs):
            a, c = attn.gqa_fill_cache(lp["self_attn"], h, positions=pos_ids,
                                       max_seq=max_seq, use_rope=False)
            kvs.update(c)
            return a

        ek, ev = attn.cross_encode_kv(lp["cross_attn"], enc_out)
        x = _decoder_layer(lp, x, self_attn, ek, ev)
        layers.append({"self_k": kvs["k"].to(cache_dtype),
                       "self_v": kvs["v"].to(cache_dtype),
                       "cross_k": ek.to(cache_dtype), "cross_v": ev.to(cache_dtype)})
    x = _ln(params["dec_norm"], x)
    logits = (x[:, -1:, :] @ params["embed"].T)[:, 0]
    return logits, {k: torch.stack([c[k] for c in layers]) for k in layers[0]}


def decode_step(params: dict, cache: dict, batch: dict, cfg: ArchConfig):
    """One decode step. batch: {"tokens": (B,1), "pos": int} -> (logits,
    cache); the self-attention KV is written in place."""
    tokens, pos = batch["tokens"], int(batch["pos"])
    if not 0 <= pos < cfg.max_target_positions:
        raise ValueError(f"decode position {pos} outside the "
                         f"{cfg.max_target_positions} learned positions")
    x = params["embed"][tokens] + params["dec_pos"][pos:pos + 1][None]
    for i in range(cfg.n_layers):
        lp = tree_index(params["dec_layers"], i)
        kv = {"k": cache["self_k"][i], "v": cache["self_v"][i]}
        x = _decoder_layer(
            lp, x, lambda h, lp=lp, kv=kv: attn.gqa_decode(
                lp["self_attn"], h, kv, pos, use_rope=False)[0],
            cache["cross_k"][i], cache["cross_v"][i])
    x = _ln(params["dec_norm"], x)
    return (x @ params["embed"].T)[:, 0], cache
