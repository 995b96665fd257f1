"""RWKV6 ("Finch") block: attention-free time mixing with data-dependent
decay + squared-ReLU channel mixing (port of ``repro.models.rwkv``).

Time mixing uses the five-way data-dependent token-shift interpolation
(ddlerp, low-rank) of the RWKV6 paper, per-channel decays
w_t = exp(-exp(base + lora(x))) and the current-token bonus u; the linear
recurrence itself runs through models.linear_attn in the exclusive+bonus
form.  Decode state per layer: two token-shift vectors + the (H, 64, 64)
wkv state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ParamSpec, clip, layer_norm
from .linear_attn import chunked, single_step

_MIX = ("w", "k", "v", "r", "g")


class RWKVDims(NamedTuple):
    d_model: int
    d_ff: int
    head_dim: int
    lora_mix: int
    lora_decay: int

    @staticmethod
    def make(d_model: int, d_ff: int, head_dim: int = 64, lora_mix: int = 32,
             lora_decay: int = 64) -> "RWKVDims":
        return RWKVDims(d_model, d_ff, head_dim, lora_mix, lora_decay)

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def rwkv6_time_mix_specs(dims: RWKVDims) -> dict:
    d = dims.d_model
    s = {
        "maa_x": ParamSpec((d,), ("embed",), "zeros"),
        "maa_w1": ParamSpec((d, 5 * dims.lora_mix), ("embed", None), "scaled"),
        "maa_w2": ParamSpec((5, dims.lora_mix, d), (None, None, "embed"), "scaled"),
        "decay_base": ParamSpec((d,), ("embed",), "zeros"),
        "decay_w1": ParamSpec((d, dims.lora_decay), ("embed", None), "scaled"),
        "decay_w2": ParamSpec((dims.lora_decay, d), (None, "embed"), "scaled"),
        "bonus": ParamSpec((dims.n_heads, dims.head_dim), ("heads", "head_dim"), "zeros"),
        "wr": ParamSpec((d, d), ("embed", "heads_flat"), "scaled"),
        "wk": ParamSpec((d, d), ("embed", "heads_flat"), "scaled"),
        "wv": ParamSpec((d, d), ("embed", "heads_flat"), "scaled"),
        "wg": ParamSpec((d, d), ("embed", "heads_flat"), "scaled"),
        "wo": ParamSpec((d, d), ("heads_flat", "embed"), "scaled"),
        "ln_x_g": ParamSpec((d,), ("embed",), "ones"),
        "ln_x_b": ParamSpec((d,), ("embed",), "zeros"),
    }
    for m in _MIX:
        s[f"maa_{m}"] = ParamSpec((d,), ("embed",), "zeros")
    return s


def rwkv6_channel_mix_specs(dims: RWKVDims) -> dict:
    d = dims.d_model
    return {
        "maa_k": ParamSpec((d,), ("embed",), "zeros"),
        "maa_r": ParamSpec((d,), ("embed",), "zeros"),
        "wk": ParamSpec((d, dims.d_ff), ("embed", "mlp"), "scaled"),
        "wv": ParamSpec((dims.d_ff, d), ("mlp", "embed"), "scaled"),
        "wr": ParamSpec((d, d), ("embed", "embed2"), "scaled"),
    }


def _ddlerp(p: dict, x: torch.Tensor, shifted: torch.Tensor):
    """Data-dependent 5-way token-shift interpolation -> (xw, xk, xv, xr, xg)."""
    dx = shifted - x
    base = x + dx * p["maa_x"]
    lora = torch.tanh(base @ p["maa_w1"])                      # (B,S,5*lm)
    lora = lora.reshape(*lora.shape[:-1], 5, -1)               # (B,S,5,lm)
    adj = torch.einsum("bsfl,fld->bsfd", lora, p["maa_w2"])    # (B,S,5,d)
    return [x + dx * (p[f"maa_{m}"] + adj[..., i, :]) for i, m in enumerate(_MIX)]


def _decay(p: dict, xw: torch.Tensor) -> torch.Tensor:
    """Per-channel log decay (<= 0): -exp(base + lora(xw))."""
    lora = torch.tanh(xw @ p["decay_w1"]) @ p["decay_w2"]
    # faithful RWKV range: w = exp(-exp(d)) with d <= ~1, so per-step
    # log-decay is >= -e; with chunk=16 the in-chunk span stays < 80.
    return -torch.exp(clip(p["decay_base"].float() + lora.float(), -8.0, 1.0))


def _shift(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 0))[:, :-1, :]


def _time_mix_inputs(p: dict, x: torch.Tensor, shifted: torch.Tensor, dims: RWKVDims):
    """(r, k, v, log_w) as (B, S, H, hd) and the gate g (B, S, d)."""
    b, s, _ = x.shape
    h, hd = dims.n_heads, dims.head_dim
    xw, xk, xv, xr, xg = _ddlerp(p, x, shifted)
    r = (xr @ p["wr"]).reshape(b, s, h, hd)
    k = (xk @ p["wk"]).reshape(b, s, h, hd)
    v = (xv @ p["wv"]).reshape(b, s, h, hd)
    g = F.silu(xg @ p["wg"])
    log_w = _decay(p, xw).reshape(b, s, h, hd)
    return r, k, v, log_w, g


def time_mix_prefill(p: dict, x: torch.Tensor, dims: RWKVDims, *, chunk: int = 16):
    """Full-sequence time mix -> (out (B,S,d), final wkv state)."""
    b, s, d = x.shape
    r, k, v, log_w, g = _time_mix_inputs(p, x, _shift(x), dims)
    res = chunked(r, k, v, log_w, chunk=chunk, exclusive=True, u=p["bonus"])
    o = layer_norm(res.out.reshape(b, s, d), p["ln_x_g"], p["ln_x_b"])
    return (o * g) @ p["wo"], res.state


def time_mix_forward(p: dict, x: torch.Tensor, dims: RWKVDims, *, chunk: int = 16):
    return time_mix_prefill(p, x, dims, chunk=chunk)[0]


def channel_mix_forward(p: dict, x: torch.Tensor):
    shifted = _shift(x)
    xk = x + (shifted - x) * p["maa_k"]
    xr = x + (shifted - x) * p["maa_r"]
    k = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"])


def rwkv6_init_state(n_layers: int, batch: int, dims: RWKVDims, dtype=torch.bfloat16,
                     device="cuda") -> dict:
    return {
        "wkv": torch.zeros((n_layers, batch, dims.n_heads, dims.head_dim, dims.head_dim),
                           dtype=torch.float32, device=device),
        "shift_tm": torch.zeros((n_layers, batch, dims.d_model), dtype=dtype, device=device),
        "shift_cm": torch.zeros((n_layers, batch, dims.d_model), dtype=dtype, device=device),
    }


def rwkv6_state_axes() -> dict:
    return {"wkv": ("layers", "batch", "heads", None, None),
            "shift_tm": ("layers", "batch", "embed"),
            "shift_cm": ("layers", "batch", "embed")}


def time_mix_decode(p: dict, x: torch.Tensor, wkv_state: torch.Tensor,
                    shift: torch.Tensor, dims: RWKVDims):
    """x: (B,1,d); shift: (B,d) previous token's input; wkv_state fp32."""
    b, _, d = x.shape
    h, hd = dims.n_heads, dims.head_dim
    r, k, v, log_w, g = _time_mix_inputs(p, x, shift[:, None, :], dims)
    st, o = single_step(wkv_state, r[:, 0], k[:, 0], v[:, 0], log_w[:, 0],
                        exclusive=True, u=p["bonus"])
    o = layer_norm(o.reshape(b, d), p["ln_x_g"], p["ln_x_b"])
    out = ((o * g[:, 0]) @ p["wo"])[:, None, :]
    return out, st, x[:, 0, :]


def channel_mix_decode(p: dict, x: torch.Tensor, shift: torch.Tensor):
    dx = shift[:, None, :] - x
    xk = x + dx * p["maa_k"]
    xr = x + dx * p["maa_r"]
    k = torch.square(F.relu(xk @ p["wk"]))
    return torch.sigmoid(xr @ p["wr"]) * (k @ p["wv"]), x[:, 0, :]
