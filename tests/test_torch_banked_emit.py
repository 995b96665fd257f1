"""The banked conv unit and the emit-mode threshold unit against the JAX
package: the function, and the order of adds, that their Hopper kernels
must keep.

Per membrane cell the banked conv adds input channel by input channel,
and within a channel column by column (s ascending): JAX's ``bank_vm ->
apply_banked_columns_fused`` once per input channel ``-> unbank_vm``.
float32 sums depend on that order and int8/int16 saturate after every
add, so taps that reach the rails make any other order visible.  The
port's side is ``event_conv_cuda_banked`` over the whole (C_in, Q, ...)
carrier of one time step in one call.  The emit is held against JAX's
``threshold_pool`` with ``emit_capacity`` through the Pallas kernel in
interpret mode, tile by tile, against the port's
``threshold_pool_cuda_emit`` on halo-padded tiles.  On the CPU the port's
wrappers run their plain versions; tests/test_torch_gpu.py and
chip_smoke.py hold the CUDA kernels against those on a card.  Results are
compared exactly: float by value, int bit for bit.

    PYTHONPATH=src python -m pytest -q tests/test_torch_banked_emit.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aeq as jaeq
from repro.core import event_conv as jev
from repro.core.geometry import ConvGeometry as JGeom
from repro.kernels.threshold_pool import ops as jthr_ops
from repro_torch.core.geometry import ConvGeometry as TGeom
from repro_torch.kernels.event_conv.kernel import event_conv_cuda_banked
from repro_torch.kernels.event_conv.ref import event_conv_ref_banked
from repro_torch.kernels.threshold_pool.kernel import threshold_pool_cuda_emit

DTYPES = [np.float32, np.int16, np.int8]
H, W = 8, 9          # the map; tiles are (H + 2hh, W + 2hw)
CARRIERS = ["empty", "all-events", "all-bytes", "corners", "sparse",
            "truncating"]
# (Q tiles, C_in input channels, C output channels): the conv1 block's
# width, and one sample of one input channel at conv2's block width
SHAPES = [(2, 3, 8), (1, 1, 5)]


def _t(x):
    return torch.from_numpy(np.array(x))


def _values(rng, shape, dtype, kernel=False):
    """Tiles, or taps large enough that int sums hit the rails."""
    if dtype == np.float32:
        return rng.normal(size=shape).astype(dtype)
    hi = {np.int8: (100, 90), np.int16: (30000, 20000)}[dtype][kernel]
    return rng.integers(-hi, hi, size=shape).astype(dtype)


def _corners(k):
    """(H, W) map with one event of each of the k*k interlace columns,
    column s = (a, b) at the corner s % 4 of the map."""
    fm = np.zeros((H, W), dtype=bool)
    for s in range(k * k):
        a, b = divmod(s, k)
        top, left = s % 4 in (0, 1), s % 4 in (0, 2)
        i = a if top else max(i for i in range(H) if i % k == a)
        j = b if left else max(j for j in range(W) if j % k == b)
        fm[i, j] = True
    return fm


def _carrier(rng, kind, k, q, c_in):
    """A (C_in, Q, n_banks, HBp+2, WBp+2) carrier from JAX's
    build_fused_handoff, or (all-bytes) every byte set, ring included."""
    jg = JGeom(k, k)
    cap = H * W
    if kind == "empty":
        fm = np.zeros((q, H, W, c_in), dtype=bool)
    elif kind in ("all-events", "all-bytes"):
        fm = np.ones((q, H, W, c_in), dtype=bool)
    elif kind == "corners":
        fm = np.broadcast_to(_corners(k)[None, :, :, None], (q, H, W, c_in))
    elif kind == "sparse":
        fm = rng.random((q, H, W, c_in)) < 0.05
    else:  # truncating: demand above the capacity
        fm, cap = rng.random((q, H, W, c_in)) < 0.6, 20
    masks = np.asarray(jaeq.build_fused_handoff(
        jnp.asarray(fm[:, None]), cap, jg).masks[0])
    if kind == "all-bytes":
        masks = np.ones_like(masks)
    return masks


# one compile per (window, dtype, shape), shared by the carriers
_apply_fused = jax.jit(jev.apply_banked_columns_fused, static_argnums=3)


def _jax_banked(vm, masks, taps, k):
    """JAX's composition: apply_banked_columns_fused once per input
    channel, in order, on the banked tile."""
    jg = JGeom(k, k)
    vb = jev.bank_vm(jnp.asarray(vm), jg)
    for ci in range(masks.shape[0]):
        vb = _apply_fused(vb, jnp.asarray(masks[ci]), jnp.asarray(taps[ci]),
                          jg)
    return np.asarray(jev.unbank_vm(vb, *vm.shape[1:3], jg))


@pytest.mark.parametrize("carrier", CARRIERS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3, 5])
def test_banked_conv_keeps_jax_order(k, dtype, carrier):
    """Every input channel of one time step in one call, fresh and in
    place, equals JAX's per-channel chain: Q in {1, 2}, C_in in {1, 3},
    C in {5, 8}."""
    rng = np.random.default_rng(1000 * k + 10 * DTYPES.index(dtype)
                                + CARRIERS.index(carrier))
    hh = k // 2
    tg = TGeom(k, k)
    for q, c_in, c in SHAPES:
        masks = _carrier(rng, carrier, k, q, c_in)
        vm = _values(rng, (q, H + 2 * hh, W + 2 * hh, c), dtype)
        kern = _values(rng, (k, k, c_in, c), dtype, kernel=True)
        taps = np.asarray(jnp.moveaxis(jev.tap_matrix(jnp.asarray(kern)),
                                       2, 0))
        want = _jax_banked(vm, masks, taps, k)
        tvm, tm, tt = _t(vm), _t(masks), _t(taps)
        np.testing.assert_array_equal(
            want, event_conv_cuda_banked(tvm, tm, tt, geometry=tg).numpy())
        out = tvm.clone()
        got = event_conv_cuda_banked(out, tm, tt, geometry=tg, out=out)
        assert got is out
        np.testing.assert_array_equal(want, out.numpy())
        if carrier == "empty":
            np.testing.assert_array_equal(want, vm)


@pytest.mark.parametrize("dtype", [np.int16, np.int8])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_saturating_taps_pin_the_order(k, dtype):
    """With taps at the rails the order is observable: applying column by
    column over all input channels (s outer, ci inner) gives another
    result than JAX's order, which the port's plain version reproduces."""
    rng = np.random.default_rng(2000 + k + (dtype == np.int8))
    hh, q, c_in, c = k // 2, 2, 4, 8
    tg = TGeom(k, k)
    masks = _carrier(rng, "all-events", k, q, c_in)
    vm = _values(rng, (q, H + 2 * hh, W + 2 * hh, c), dtype)
    kern = _values(rng, (k, k, c_in, c), dtype, kernel=True)
    taps = np.asarray(jnp.moveaxis(jev.tap_matrix(jnp.asarray(kern)), 2, 0))
    want = _jax_banked(vm, masks, taps, k)
    sat = np.iinfo(dtype)
    assert (want == sat.max).any() or (want == sat.min).any()
    got = event_conv_cuda_banked(_t(vm), _t(masks), _t(taps), geometry=tg)
    np.testing.assert_array_equal(want, got.numpy())
    # column outer: each pass keeps one column's centre bank
    _, _, _, col_bank = jev._interlace_tables(k, k)
    other = _t(vm)
    for s in range(k * k):
        only = np.zeros_like(masks)
        only[:, :, col_bank[s]] = masks[:, :, col_bank[s]]
        other = event_conv_ref_banked(other, _t(only), _t(taps), tg)
    if k > 1:
        assert not np.array_equal(want, other.numpy())


# (consumer window k, pool, dtype): every k, pool None and a ragged 3
EMIT_CASES = [(1, None, np.float32), (1, 3, np.int16), (3, None, np.int8),
              (3, 3, np.float32), (5, None, np.int16), (5, 3, np.int8)]


@pytest.mark.parametrize("k,pool,dtype", EMIT_CASES)
def test_emit_matches_pallas_interpret(k, pool, dtype):
    """threshold_pool_cuda_emit on Q=2 halo-padded 10x11x5 tiles against
    JAX's threshold_pool with emission (Pallas, interpret mode) tile by
    tile: capacity 1, exactly one slab's demand, and above the map; a
    ragged pool edge (10x11 -> 4x4); masks, demand counts and kept events
    per column in the carrier's (C, Q, ...) layout."""
    jg, tg = JGeom(k, k), TGeom(k, k)
    rng = np.random.default_rng(3000 + 10 * k + (pool or 0))
    q, h, w, c = 2, 10, 11, 5
    vm = _values(rng, (q, h + 2, w + 2, c), dtype)
    # ~4 % of the neurons cross v_t, so the pooled maps truncate
    if dtype == np.float32:
        bias, v_t = (0.1 * rng.normal(size=(c,))).astype(dtype), 1.75
    else:
        bias = rng.integers(-10, 10, (c,)).astype(dtype)
        v_t = 92 if dtype == np.int8 else 27600
    fired = rng.random((q, h, w, c)) < 0.02
    ph, pw = -(-h // (pool or 1)), -(-w // (pool or 1))
    spikes0 = threshold_pool_cuda_emit(
        _t(vm).clone(), _t(bias), _t(fired), v_t=v_t, pool=pool,
        halo=(1, 1), emit_capacity=1, emit_geometry=tg)
    demand = int(spikes0[3][0, 0])
    assert 1 < demand < ph * pw
    for cap in (1, demand, ph * pw + 3):
        tvm = _t(vm)
        spikes, pooled, masks, count, seg = threshold_pool_cuda_emit(
            tvm, _t(bias), _t(fired), v_t=v_t, pool=pool, halo=(1, 1),
            emit_capacity=cap, emit_geometry=tg)
        for b in range(q):
            jvm, jspk, jout, jmasks, jseg = jthr_ops.threshold_pool(
                jnp.asarray(vm[b, 1:-1, 1:-1]), jnp.asarray(bias),
                jnp.asarray(fired[b]), v_t=v_t, pool=pool, block_c=c,
                use_kernel=True, emit_capacity=cap, emit_geometry=jg)
            np.testing.assert_array_equal(np.asarray(jvm),
                                          tvm[b, 1:-1, 1:-1].numpy())
            np.testing.assert_array_equal(np.asarray(jspk),
                                          spikes[b].numpy())
            if pool is not None:
                np.testing.assert_array_equal(np.asarray(jout),
                                              pooled[b].numpy())
            np.testing.assert_array_equal(
                np.moveaxis(np.asarray(jmasks) != 0, -1, 0),
                masks[:, b].numpy())
            np.testing.assert_array_equal(np.asarray(jseg).T,
                                          seg[:, b].numpy())
            np.testing.assert_array_equal(
                np.asarray(jout).sum(axis=(0, 1)), count[:, b].numpy())
        assert (seg.sum(-1) == count.clamp(max=min(cap, ph * pw))).all()
