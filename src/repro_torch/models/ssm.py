"""Mamba2 (SSD) block — the state-space half of zamba2 (port of
``repro.models.ssm``).

Fused in_proj -> [z | xBC | dt], causal depthwise conv1d over xBC, SSD
linear recurrence with per-head scalar decay exp(dt*A), D skip
connection, gated RMSNorm, out_proj.  The recurrence runs through
models.linear_attn.chunked_scalar (train/prefill) or single_step
(decode), with q=C, k=B, v=dt*x, log_w=dt*A.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .common import ParamSpec, rms_norm
from .linear_attn import chunked_scalar, single_step


class SSMDims(NamedTuple):
    d_model: int
    d_inner: int
    d_state: int
    head_dim: int
    n_heads: int
    conv_w: int

    @staticmethod
    def make(d_model: int, d_state: int = 64, expand: int = 2, head_dim: int = 64,
             conv_w: int = 4) -> "SSMDims":
        d_inner = expand * d_model
        return SSMDims(d_model, d_inner, d_state, head_dim, d_inner // head_dim, conv_w)

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.d_state  # xBC (n_groups = 1)

    @property
    def in_dim(self) -> int:
        return 2 * self.d_inner + 2 * self.d_state + self.n_heads  # z|xBC|dt


def mamba2_specs(dims: SSMDims) -> dict:
    return {
        "in_proj": ParamSpec((dims.d_model, dims.in_dim), ("embed", "mlp"), "scaled"),
        "conv_w": ParamSpec((dims.conv_w, dims.conv_dim), (None, "mlp"), "scaled"),
        "conv_b": ParamSpec((dims.conv_dim,), ("mlp",), "zeros"),
        "a_log": ParamSpec((dims.n_heads,), ("heads",), "zeros"),
        "d_skip": ParamSpec((dims.n_heads,), ("heads",), "ones"),
        "dt_bias": ParamSpec((dims.n_heads,), ("heads",), "zeros"),
        "norm": ParamSpec((dims.d_inner,), ("mlp",), "zeros"),
        "out_proj": ParamSpec((dims.d_inner, dims.d_model), ("mlp", "embed"), "scaled"),
    }


def _split_proj(p, x, dims: SSMDims):
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., : dims.d_inner]
    xbc = zxbcdt[..., dims.d_inner: dims.d_inner + dims.conv_dim]
    dt = zxbcdt[..., dims.d_inner + dims.conv_dim:]
    return z, xbc, dt


def _split_xbc(xbc, dims: SSMDims):
    return (xbc[..., : dims.d_inner],
            xbc[..., dims.d_inner: dims.d_inner + dims.d_state],
            xbc[..., dims.d_inner + dims.d_state:])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + exp(x)) everywhere (F.softplus turns
    linear above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssd_core(p, z, x_in, b_in, c_in, dt, dims: SSMDims, state0=None, chunk=64):
    """Shared SSD math after the conv. Shapes: x_in (B,S,d_inner); b/c (B,S,state)."""
    bsz, s, _ = x_in.shape
    h, hd, ds = dims.n_heads, dims.head_dim, dims.d_state
    dt = _softplus(dt.float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())                       # (H,) negative
    log_w = dt * a                                           # (B,S,H) scalar/head
    xh = x_in.reshape(bsz, s, h, hd)
    v = xh * dt[..., None].to(xh.dtype)                      # fold dt into v
    k = b_in[:, :, None, :].expand(bsz, s, h, ds)            # group-shared B
    q = c_in[:, :, None, :].expand(bsz, s, h, ds)
    res = chunked_scalar(q, k, v, log_w, chunk=chunk, state0=state0)
    o = res.out + p["d_skip"].to(xh.dtype)[None, None, :, None] * xh
    o = o.reshape(bsz, s, dims.d_inner)
    o = rms_norm(o * F.silu(z), p["norm"])
    return o @ p["out_proj"], res.state


def _causal_conv(p, xbc, dims: SSMDims):
    """Causal depthwise conv1d of window conv_w, then SiLU (JAX's sum of
    shifted products, in its order)."""
    s = xbc.shape[1]
    xbc_p = F.pad(xbc, (0, 0, dims.conv_w - 1, 0))
    conv = xbc_p[:, 0:s, :] * p["conv_w"][0][None, None, :]
    for i in range(1, dims.conv_w):
        conv = conv + xbc_p[:, i: i + s, :] * p["conv_w"][i][None, None, :]
    return F.silu(conv + p["conv_b"])


def mamba2_prefill(p: dict, x: torch.Tensor, dims: SSMDims, *, chunk: int = 64):
    """Full-sequence forward -> (out (B,S,d_model), ssm state, the last
    conv_w - 1 pre-conv xBC rows: the conv state)."""
    z, xbc, dt = _split_proj(p, x, dims)
    x_in, b_in, c_in = _split_xbc(_causal_conv(p, xbc, dims), dims)
    out, st = _ssd_core(p, z, x_in, b_in, c_in, dt, dims, chunk=chunk)
    return out, st, xbc[:, -(dims.conv_w - 1):, :]


def mamba2_forward(p: dict, x: torch.Tensor, dims: SSMDims, *, chunk: int = 64) -> torch.Tensor:
    """Full-sequence forward. x: (B, S, d_model)."""
    return mamba2_prefill(p, x, dims, chunk=chunk)[0]


def mamba2_init_state(n_layers: int, batch: int, dims: SSMDims, dtype=torch.float32,
                      device="cuda") -> dict:
    return {
        "ssm": torch.zeros((n_layers, batch, dims.n_heads, dims.d_state, dims.head_dim),
                           dtype=torch.float32, device=device),
        "conv": torch.zeros((n_layers, batch, dims.conv_w - 1, dims.conv_dim),
                            dtype=dtype, device=device),
    }


def mamba2_state_axes() -> dict:
    return {"ssm": ("layers", "batch", "heads", None, None),
            "conv": ("layers", "batch", None, "mlp")}


def mamba2_decode(p: dict, x: torch.Tensor, layer_state: dict, dims: SSMDims):
    """One-token step. x: (B, 1, d_model); layer_state: {ssm, conv} (unstacked)."""
    bsz = x.shape[0]
    z, xbc, dt = _split_proj(p, x, dims)                     # (B,1,*)
    hist = torch.cat([layer_state["conv"], xbc], dim=1)      # (B, conv_w, conv_dim)
    conv = torch.einsum("bwc,wc->bc", hist, p["conv_w"]) + p["conv_b"]
    xbc_t = F.silu(conv)[:, None, :]
    new_conv = hist[:, 1:, :]
    x_in, b_in, c_in = _split_xbc(xbc_t, dims)

    h, hd, ds = dims.n_heads, dims.head_dim, dims.d_state
    dtv = _softplus(dt[:, 0].float() + p["dt_bias"].float())
    a = -torch.exp(p["a_log"].float())
    log_w = (dtv * a)[..., None].expand(bsz, h, ds)
    xh = x_in[:, 0].reshape(bsz, h, hd)
    v_t = xh * dtv[..., None].to(xh.dtype)
    k_t = b_in[:, 0, None, :].expand(bsz, h, ds)
    q_t = c_in[:, 0, None, :].expand(bsz, h, ds)
    st, o = single_step(layer_state["ssm"], q_t, k_t, v_t, log_w)
    o = o + p["d_skip"].to(xh.dtype)[None, :, None] * xh
    o = o.reshape(bsz, 1, dims.d_inner)
    o = rms_norm(o * F.silu(z), p["norm"])
    return o @ p["out_proj"], {"ssm": st, "conv": new_conv}
