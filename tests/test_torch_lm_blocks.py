"""The port's LM building blocks against the JAX package's, on the CPU:
norms, RoPE and M-RoPE, masks, the chunked cross entropy, GQA attention
(plain, and the query-blocked path at S >= 2048, full and sliding), the
sliding-window ring cache filled and decoded past its window, cross
attention, MLA fill and decode, the MLPs, the MoE (overflowing capacity,
tied router logits), the linear-attention cores, and the RWKV6 and Mamba2
blocks forward and decode.

Parameters come from numpy draws over the JAX block's own specs
(``torch_lm_ref.np_params``), inputs from numpy.  Tolerances: float32
``rtol=1e-4, atol=1e-5`` (float32 sums in another order); the bfloat16
ring cache JAX's own ``rtol=2e-2, atol=2e-3``; masks and slot positions
equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import ffn as jffn
from repro.models import linear_attn as jlin
from repro.models import rwkv as jrwkv
from repro.models import ssm as jssm
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import ffn as tffn
from repro_torch.models import linear_attn as tlin
from repro_torch.models import rwkv as trwkv
from repro_torch.models import ssm as tssm
from torch_lm_ref import BF16, F32, assert_close, assert_tree_close, both, np_params

RNG = np.random.default_rng(0)


def arr(*shape, scale=1.0):
    return (scale * RNG.normal(size=shape)).astype(np.float32)


def jt(*arrays):
    """numpy arrays -> (JAX arrays, tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


# ---------------------------------------------------------------- common
def test_norms():
    x, g, b = arr(3, 5, 64, scale=3.0), arr(64, scale=0.3), arr(64)
    assert_close(tcommon.rms_norm(torch.from_numpy(x), torch.from_numpy(g)),
                 jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g)), **F32)
    assert_close(tcommon.layer_norm(*map(torch.from_numpy, (x, g, b))),
                 jcommon.layer_norm(*map(jnp.asarray, (x, g, b))), **F32)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope(theta):
    x = arr(2, 40, 3, 32)
    pos = RNG.integers(0, 3000, (2, 40)).astype(np.int32)
    assert_close(tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
                 jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta), **F32)


def test_mrope():
    x = arr(2, 10, 2, 16)
    pos = RNG.integers(0, 40, (3, 2, 10)).astype(np.int32)
    assert_close(tcommon.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), (2, 3, 3)),
                 jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos), (2, 3, 3)), **F32)


@pytest.mark.parametrize("s_q,s_k,window,off", [(5, 7, None, 2), (6, 9, 3, 1),
                                                (8, 8, 4, 0)])
def test_masks(s_q, s_k, window, off):
    if window is None:
        got, want = tcommon.causal_mask(s_q, s_k, off), jcommon.causal_mask(s_q, s_k, off)
    else:
        got = tcommon.sliding_mask(s_q, s_k, window, off)
        want = jcommon.sliding_mask(s_q, s_k, window, off)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chunked_softmax_ce():
    hidden, w = arr(2, 37, 16), arr(16, 50)
    labels = RNG.integers(0, 50, (2, 37)).astype(np.int32)
    mask = (RNG.random((2, 37)) > 0.2).astype(np.float32)
    (jh, jw, jl, jm), (th, tw, tl, tm) = jt(hidden, w, labels, mask)
    assert_close(tcommon.chunked_softmax_ce(th, tw, tl, tm, chunk=8),
                 jcommon.chunked_softmax_ce(jh, jw, jl, jm, chunk=8), **F32)
    assert_close(tcommon.softmax_cross_entropy(th @ tw, tl, tm),
                 jcommon.softmax_cross_entropy(jh @ jw, jl, jm), **F32)


# -------------------------------------------------------------- attention
GEMMA = dict(d_model=64, n_heads=2, n_kv=1, d_head=32, use_qk_norm=True)


def gqa_params(seed=0, **dims):
    dims = {**GEMMA, **dims}
    return both(np_params(jattn.gqa_specs(**dims), seed))


@pytest.mark.parametrize("s,window", [(40, None), (40, 16), (2100, None),
                                      (2100, 16), (2100, 1500)])
def test_gqa_forward(s, window):
    """Below 2048 the plain (S, S) path; at 2100 the query-blocked path:
    full, sliding with per-block KV slices (16 + 1024 < 2100), and sliding
    over the whole KV (1500 + 1024 >= 2100)."""
    jp, tp = gqa_params()
    x = arr(1, s, 64)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (1, s))
    (jx, jpos), (tx, tpos) = jt(x, np.ascontiguousarray(pos))
    want = jax.jit(functools.partial(jattn.gqa_forward, rope_theta=1e6, window=window))(
        jp, jx, positions=jpos)
    got = tattn.gqa_forward(tp, tx, positions=tpos, rope_theta=1e6, window=window)
    assert_close(got, want, **F32)


def test_gqa_bidirectional_no_rope():
    jp, tp = gqa_params(n_heads=4, n_kv=4, d_head=16, use_qk_norm=False)
    x = arr(2, 12, 64)
    pos = np.zeros((2, 12), np.int32)
    (jx, jpos), (tx, tpos) = jt(x, pos)
    assert_close(tattn.gqa_forward(tp, tx, positions=tpos, bidirectional=True,
                                   use_rope=False),
                 jattn.gqa_forward(jp, jx, positions=jpos, bidirectional=True,
                                   use_rope=False), **F32)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [16, None])
def test_gqa_fill_and_decode_past_window(window, cache_dtype):
    """Fill with 20 tokens (the ring wraps: slots 0-3 hold positions
    16-19), then 8 decode steps on each side's own cache chain, past the
    window again; every step's output and cache compared."""
    jp, tp = gqa_params()
    s, n, max_seq = 20, 8, 32
    x = arr(2, s + n, 64)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)))
    (jx, jpos), (tx, tpos) = jt(x, pos)
    jdt = getattr(jnp, cache_dtype)
    tdt = getattr(torch, cache_dtype)
    tol = F32 if cache_dtype == "float32" else BF16
    jout, jc = jax.jit(functools.partial(
        jattn.gqa_fill_cache, rope_theta=1e6, window=window, max_seq=max_seq))(
        jp, jx[:, :s], positions=jpos)
    tout, tc = tattn.gqa_fill_cache(tp, tx[:, :s], positions=tpos, rope_theta=1e6,
                                    window=window, max_seq=max_seq)
    assert_close(tout, jout, **F32)
    jc = {k: v if v.dtype == jnp.int32 else v.astype(jdt) for k, v in jc.items()}
    tc = {k: v if v.dtype == torch.int32 else v.to(tdt) for k, v in tc.items()}
    assert_tree_close(tc, jc, **tol)
    if window is not None:
        np.testing.assert_array_equal(tc["slot_pos"].numpy()[:4], [16, 17, 18, 19])
    jdecode = jax.jit(functools.partial(jattn.gqa_decode, rope_theta=1e6,
                                        window=window))
    for i in range(n):
        p = s + i
        jo, jc = jdecode(jp, jx[:, p:p + 1], jc, jnp.asarray(p, jnp.int32))
        to, tc = tattn.gqa_decode(tp, tx[:, p:p + 1], tc, p, rope_theta=1e6,
                                  window=window)
        assert_close(to, jo, **tol, what=f"step {i}")
        assert_tree_close(tc, jc, **tol)


def test_decode_past_full_cache_raises():
    _, tp = gqa_params()
    tc = {"k": torch.zeros(1, 4, 1, 32), "v": torch.zeros(1, 4, 1, 32)}
    with pytest.raises(ValueError, match="outside a cache of 4 slots"):
        tattn.gqa_decode(tp, torch.zeros(1, 1, 64), tc, 4)


def test_cross_attention():
    jp, tp = gqa_params(n_heads=4, n_kv=4, d_head=16, use_qk_norm=False)
    x, enc = arr(2, 6, 64), arr(2, 32, 64)
    (jx, je), (tx, te) = jt(x, enc)
    jk, jv = jattn.cross_encode_kv(jp, je)
    tk, tv = tattn.cross_encode_kv(tp, te)
    assert_close(tk, jk, **F32)
    assert_close(tv, jv, **F32)
    assert_close(tattn.cross_forward(tp, tx, tk, tv),
                 jattn.cross_forward(jp, jx, jk, jv), **F32)


MLA = dict(q_lora=32, kv_lora=24, qk_nope=16, qk_rope=8)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_mla_fill_and_decode(cache_dtype):
    jp, tp = both(np_params(jattn.mla_specs(64, 4, **MLA, v_dim=16), 3))
    s, n, max_seq = 12, 3, 16
    x = arr(2, s + n, 64)
    pos = np.ascontiguousarray(np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)))
    (jx, jpos), (tx, tpos) = jt(x, pos)
    kw = dict(rope_theta=10000.0, qk_nope=16, qk_rope=8)
    jout, jc = jax.jit(functools.partial(jattn.mla_fill_cache, max_seq=max_seq, **kw))(
        jp, jx[:, :s], positions=jpos)
    tout, tc = tattn.mla_fill_cache(tp, tx[:, :s], positions=tpos, max_seq=max_seq, **kw)
    assert_close(tout, jout, **F32)
    jc = {k: v.astype(getattr(jnp, cache_dtype)) for k, v in jc.items()}
    tc = {k: v.to(getattr(torch, cache_dtype)) for k, v in tc.items()}
    tol = F32 if cache_dtype == "float32" else BF16
    assert_tree_close(tc, jc, **tol)
    jdecode = jax.jit(functools.partial(jattn.mla_decode, **kw))
    for i in range(n):
        p = s + i
        jo, jc = jdecode(jp, jx[:, p:p + 1], jc, jnp.asarray(p, jnp.int32))
        to, tc = tattn.mla_decode(tp, tx[:, p:p + 1], tc, p, **kw)
        assert_close(to, jo, **tol, what=f"step {i}")
        assert_tree_close(tc, jc, **tol)


def test_mla_forward_blocked():
    jp, tp = both(np_params(jattn.mla_specs(64, 4, **MLA, v_dim=16), 4))
    s = 2100
    x = arr(1, s, 64)
    pos = np.arange(s, dtype=np.int32)[None]
    (jx, jpos), (tx, tpos) = jt(x, pos)
    kw = dict(rope_theta=10000.0, qk_nope=16, qk_rope=8)
    assert_close(tattn.mla_forward(tp, tx, positions=tpos, **kw),
                 jax.jit(functools.partial(jattn.mla_forward, **kw))(jp, jx, positions=jpos),
                 **F32)


# ---------------------------------------------------------------- FFN / MoE
@pytest.mark.parametrize("gated", [True, False])
def test_mlp(gated):
    jp, tp = both(np_params(jffn.mlp_specs(64, 96, gated=gated), 5))
    x = arr(2, 7, 64)
    assert_close(tffn.mlp_forward(tp, torch.from_numpy(x)),
                 jffn.mlp_forward(jp, jnp.asarray(x)), **F32)


@pytest.mark.parametrize("router", ["random", "tied"])
@pytest.mark.parametrize("top_k,softmax,cap", [(2, True, 0.5), (1, False, 0.5),
                                               (2, True, 8.0)])
def test_moe(top_k, softmax, cap, router):
    """Capacity 0.5 overflows every popular expert (rows dropped, JAX's
    ``mode="drop"``); tied router logits (a zero router) tie every
    expert, and top-k keeps the lowest indices, as ``lax.top_k``."""
    specs = jffn.moe_specs(64, 96, 8, n_shared=1)
    npp = np_params(specs, 6)
    if router == "tied":
        npp["router"] = np.zeros_like(npp["router"])
    jp, tp = both(npp)
    x = arr(2, 16, 64)
    kw = dict(top_k=top_k, capacity_factor=cap, router_softmax=softmax)
    tout, taux = tffn.moe_forward(tp, torch.from_numpy(x), **kw)
    jout, jaux = jax.jit(functools.partial(jffn.moe_forward, **kw))(jp, jnp.asarray(x))
    assert_close(tout, jout, **F32)
    assert_close(taux, jaux, **F32)


def test_moe_capacity_rounds_half_to_even():
    # 2 * 16 tokens, top-1, factor 1.25 over 16 experts: 2.5 -> 2
    assert tffn.moe_capacity(32, 1, 1.25, 16) == 2
    assert tffn.moe_capacity(1, 1, 0.1, 64) == 1


# --------------------------------------------------------- linear attention
def _lin_inputs(s=50, h=3, dk=8, dv=8, scalar=False):
    q, k, v = arr(2, s, h, dk), arr(2, s, h, dk), arr(2, s, h, dv)
    shape = (2, s, h) if scalar else (2, s, h, dk)
    log_w = (-RNG.uniform(0.01, 0.5 if not scalar else 4.0, size=shape)).astype(np.float32)
    return q, k, v, log_w


@pytest.mark.parametrize("exclusive", [False, True])
def test_chunked_and_recurrent(exclusive):
    q, k, v, lw = _lin_inputs()
    u = arr(3, 8) if exclusive else None
    st0 = arr(2, 3, 8, 8)
    (jq, jk, jv, jw, js), (tq, tk, tv, tw, ts) = jt(q, k, v, lw, st0)
    ju, tu = (None, None) if u is None else (jnp.asarray(u), torch.from_numpy(u))
    for fn_t, fn_j, kw in ((tlin.chunked, jlin.chunked, dict(chunk=16)),
                           (tlin.recurrent_reference, jlin.recurrent_reference, {})):
        got = fn_t(tq, tk, tv, tw, exclusive=exclusive, u=tu, state0=ts, **kw)
        want = fn_j(jq, jk, jv, jw, exclusive=exclusive, u=ju, state0=js, **kw)
        assert_close(got.out, want.out, **F32)
        assert_close(got.state, want.state, **F32)
    st, o = tlin.single_step(ts, tq[:, 0], tk[:, 0], tv[:, 0], tw[:, 0],
                             exclusive=exclusive, u=tu)
    jst, jo = jlin.single_step(js, jq[:, 0], jk[:, 0], jv[:, 0], jw[:, 0],
                               exclusive=exclusive, u=ju)
    assert_close(st, jst, **F32)
    assert_close(o, jo, **F32)


def test_chunked_scalar():
    q, k, v, lw = _lin_inputs(s=150, dk=16, dv=8, scalar=True)
    st0 = arr(2, 3, 16, 8)
    (jq, jk, jv, jw, js), (tq, tk, tv, tw, ts) = jt(q, k, v, lw, st0)
    got = tlin.chunked_scalar(tq, tk, tv, tw, chunk=64, state0=ts)
    want = jlin.chunked_scalar(jq, jk, jv, jw, chunk=64, state0=js)
    assert_close(got.out, want.out, **F32)
    assert_close(got.state, want.state, **F32)


# ------------------------------------------------------------- RWKV / Mamba
def test_rwkv6_forward_and_decode():
    dims_t = trwkv.RWKVDims.make(64, 224, 16)
    dims_j = jrwkv.RWKVDims.make(64, 224, 16)
    jtm, ttm = both(np_params(jrwkv.rwkv6_time_mix_specs(dims_j), 7))
    jcm, tcm = both(np_params(jrwkv.rwkv6_channel_mix_specs(dims_j), 8))
    x = arr(2, 40, 64)
    (jx,), (tx,) = jt(x)
    assert_close(trwkv.time_mix_forward(ttm, tx, dims_t),
                 jax.jit(jrwkv.time_mix_forward, static_argnums=2)(jtm, jx, dims_j),
                 **F32)
    assert_close(trwkv.channel_mix_forward(tcm, tx),
                 jax.jit(jrwkv.channel_mix_forward)(jcm, jx), **F32)
    wkv, shift = arr(2, 4, 16, 16), arr(2, 64)
    (jw, js), (tw, ts) = jt(wkv, shift)
    got = trwkv.time_mix_decode(ttm, tx[:, :1], tw, ts, dims_t)
    want = jax.jit(jrwkv.time_mix_decode, static_argnums=4)(jtm, jx[:, :1], jw, js,
                                                            dims_j)
    for g, w in zip(got, want):
        assert_close(g, w, **F32)
    got = trwkv.channel_mix_decode(tcm, tx[:, :1], ts)
    want = jrwkv.channel_mix_decode(jcm, jx[:, :1], js)
    for g, w in zip(got, want):
        assert_close(g, w, **F32)


def test_mamba2_forward_and_decode():
    dims_t = tssm.SSMDims.make(64, 16, 2, 16, 4)
    dims_j = jssm.SSMDims.make(64, 16, 2, 16, 4)
    jp, tp = both(np_params(jssm.mamba2_specs(dims_j), 9))
    x = arr(2, 70, 64)
    (jx,), (tx,) = jt(x)
    assert_close(tssm.mamba2_forward(tp, tx, dims_t),
                 jax.jit(jssm.mamba2_forward, static_argnums=2)(jp, jx, dims_j), **F32)
    state = {"ssm": arr(2, dims_j.n_heads, 16, 16), "conv": arr(2, 3, dims_j.conv_dim)}
    jst = jax.tree.map(jnp.asarray, state)
    tst = {k: torch.from_numpy(v) for k, v in state.items()}
    to, tnew = tssm.mamba2_decode(tp, tx[:, :1], tst, dims_t)
    jo, jnew = jax.jit(jssm.mamba2_decode, static_argnums=3)(jp, jx[:, :1], jst, dims_j)
    assert_close(to, jo, **F32)
    assert_tree_close(tnew, jnew, **F32)


def test_state_initializers_and_axes():
    """The stacked cache and state initializers: shapes, dtypes, fill and
    logical axes as JAX's."""
    dims_r = (trwkv.RWKVDims.make(64, 224, 16), jrwkv.RWKVDims.make(64, 224, 16))
    dims_s = (tssm.SSMDims.make(64, 16, 2, 16, 4), jssm.SSMDims.make(64, 16, 2, 16, 4))
    pairs = [
        (tattn.gqa_init_cache(3, 2, 40, 1, 32, window=16, device="cpu"),
         jattn.gqa_init_cache(3, 2, 40, 1, 32, window=16)),
        (tattn.gqa_init_cache(3, 2, 40, 2, 16, dtype=torch.float32, device="cpu"),
         jattn.gqa_init_cache(3, 2, 40, 2, 16, dtype=jnp.float32)),
        (tattn.mla_init_cache(2, 2, 40, 24, 8, device="cpu"),
         jattn.mla_init_cache(2, 2, 40, 24, 8)),
        (trwkv.rwkv6_init_state(3, 2, dims_r[0], device="cpu"),
         jrwkv.rwkv6_init_state(3, 2, dims_r[1])),
        (tssm.mamba2_init_state(3, 2, dims_s[0], device="cpu"),
         jssm.mamba2_init_state(3, 2, dims_s[1])),
    ]
    for got, want in pairs:
        assert_tree_close(got, want, **F32)
    assert tattn.cache_axes(16) == jattn.cache_axes(16)
    assert tattn.cache_axes() == jattn.cache_axes()
    assert tattn.mla_cache_axes() == jattn.mla_cache_axes()
    assert trwkv.rwkv6_state_axes() == jrwkv.rwkv6_state_axes()
    assert tssm.mamba2_state_axes() == jssm.mamba2_state_axes()
