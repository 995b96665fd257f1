"""The fused-handoff and banked variants of batched inference: the port
against the JAX package, function by function and end to end.

Inputs come from numpy and go through both packages.  The JAX
functions run as the JAX package's tests run them on the CPU: plain jnp,
and the threshold unit's emit mode through ``threshold_pool(...,
use_kernel=True)`` in interpret mode.  Everything is compared exactly
(float membranes by value), except logits: ``LOGIT_TOL``, because the FC
product sums in another order (float64 in the port).  On the CPU the
port's kernel wrappers run their plain versions; tests/test_torch_gpu.py
holds the kernels against those on a card.

    PYTHONPATH=src python -m pytest -q tests/test_torch_fused.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aeq as jaeq
from repro.core import csnn as jc
from repro.core import event_conv as jev
from repro.core.geometry import ConvGeometry as JGeom
from repro.core.plan import plan_network as jplan
from repro.kernels.threshold_pool import ops as jthr_ops
from repro.kernels.threshold_pool import ref as jthr_ref
from repro_torch.convert import params_from_numpy
from repro_torch.core import aeq as taeq
from repro_torch.core import csnn as tc
from repro_torch.core import event_conv as tev
from repro_torch.core.geometry import ConvGeometry as TGeom
from repro_torch.core.plan import plan_network as tplan
from repro_torch.core.scheduler import (init_conv_carry,
                                        run_conv_layer_batched_chunk)
from repro_torch.kernels import runtime
from repro_torch.kernels.event_conv.kernel import event_conv_cuda_banked
from repro_torch.kernels.threshold_pool import ops as tthr_ops
from repro_torch.kernels.threshold_pool import ref as tthr_ref
from repro_torch.kernels.threshold_pool.kernel import threshold_pool_cuda_emit

LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
KS = [1, 3, 5]
DTYPES = [np.float32, np.int16, np.int8]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _t(x):
    return torch.from_numpy(np.array(x))


def _values(rng, shape, dtype, kernel=False):
    """Values that reach the int rails when summed (kernel=True)."""
    if dtype == np.float32:
        return rng.normal(size=shape).astype(dtype)
    hi = {np.int8: (100, 90), np.int16: (30000, 20000)}[dtype][kernel]
    return rng.integers(-hi, hi, size=shape).astype(dtype)


# ------------------------------------------------ queue builders
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("cap", [16, 11 * 13], ids=["truncating", "covering"])
def test_bank_masks_ranked_keep_and_fused_carrier_exact(k, cap):
    jg, tg = JGeom(k, k), TGeom(k, k)
    rng = np.random.default_rng(10 * k + cap)
    spikes = rng.random((2, 3, 11, 13, 2)) < 0.4        # (B, T, H, W, C)
    fmaps = np.transpose(spikes, (1, 4, 0, 2, 3))       # (T, C, B, H, W)
    il = np.asarray(jaeq.interlace(jnp.asarray(fmaps), jg))
    _eq(il, taeq.interlace(_t(fmaps), tg))
    _eq(jaeq.deinterlace(jnp.asarray(il), (11, 13), jg),
        taeq.deinterlace(_t(il), (11, 13), tg))
    want = jaeq.ranked_keep(jnp.asarray(il), cap, (11, 13))
    got = taeq.ranked_keep(_t(il), cap, (11, 13))
    for a, b in zip(want, got):
        _eq(a, b)
    _eq(jaeq.place_padded_banks(want[0], (11, 13), jg),
        taeq.place_padded_banks(got[0], (11, 13), tg))
    jb = jaeq.build_bank_masks(jnp.asarray(fmaps), cap, jg)
    tb = taeq.build_bank_masks(_t(fmaps), cap, tg)
    for f in taeq.BankedEvents._fields:
        _eq(getattr(jb, f), getattr(tb, f))
    jh = jaeq.build_fused_handoff(jnp.asarray(spikes), cap, jg)
    th = taeq.build_fused_handoff(_t(spikes), cap, tg)
    _eq(jh.masks, th.masks)
    _eq(jh.count, th.count)
    assert th.masks.dtype == torch.bool and th.count.dtype == torch.int32
    # the carrier is the bank masks with a zero macro cell per side
    bm = taeq.build_bank_masks(_t(np.transpose(spikes, (1, 0, 4, 2, 3))),
                               cap, tg)
    ring = torch.zeros_like(th.masks)
    ring[..., 1:-1, 1:-1] = bm.masks.transpose(1, 2)
    assert torch.equal(th.masks, ring)
    taeq.check_handoff(th, 2, (11, 13), tg)


def test_check_handoff_rejects_mismatched_carriers():
    ho = taeq.build_fused_handoff(torch.ones((1, 2, 12, 12, 3),
                                             dtype=torch.bool), 16)
    with pytest.raises(ValueError, match="columns"):
        taeq.check_handoff(ho, 3, (12, 12), TGeom(5, 5))
    with pytest.raises(ValueError, match="do not match"):
        taeq.check_handoff(ho, 3, (20, 20))
    with pytest.raises(ValueError, match="do not match"):
        taeq.check_handoff(ho, 4, (12, 12))
    with pytest.raises(ValueError, match="count"):
        taeq.check_handoff(taeq.FusedHandoff(ho.masks, ho.count.long()), 3,
                           (12, 12))


# ------------------------------------------------ banked conv unit
@pytest.mark.parametrize("k", KS)
def test_interlace_tables_bank_vm_taps_and_shifts_exact(k):
    jg, tg = JGeom(k, k), TGeom(k, k)
    for a, b in zip(jev._interlace_tables(k, k), tev._interlace_tables(k, k)):
        np.testing.assert_array_equal(a, np.array(b))
    rng = np.random.default_rng(k)
    vm = rng.normal(size=(2, 9 + 2 * (k // 2), 10 + 2 * (k // 2), 3))
    vm = vm.astype(np.float32)
    banked = np.asarray(jev.bank_vm(jnp.asarray(vm), jg))
    _eq(banked, tev.bank_vm(_t(vm), tg))
    _eq(jev.unbank_vm(jnp.asarray(banked), *vm.shape[1:3], jg),
        tev.unbank_vm(_t(banked), *vm.shape[1:3], tg))
    kern = rng.normal(size=(k, k, 2, 3)).astype(np.float32)
    _eq(jev.tap_matrix(jnp.asarray(kern)), tev.tap_matrix(_t(kern)))
    masks = rng.random((2, k * k, 4, 5)) < 0.3
    _eq(jev.shifted_bank_masks(jnp.asarray(masks), jg),
        tev.shifted_bank_masks(_t(masks), tg))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", KS)
def test_banked_applies_exact(dtype, k):
    """apply_banked_columns(_fused) and apply_events_banked(_batched) over
    truncated masks, int rails reached."""
    jg, tg = JGeom(k, k), TGeom(k, k)
    rng = np.random.default_rng(100 + k + 7 * DTYPES.index(dtype))
    h = w = 9
    hp = h + 2 * (k // 2)
    vm = _values(rng, (3, hp, hp, 4), dtype)
    kern = _values(rng, (k, k, 4), dtype, kernel=True)
    fm = rng.random((3, h, w)) < 0.6
    jb = jaeq.build_bank_masks(jnp.asarray(fm), 30, jg)
    tb = taeq.build_bank_masks(_t(fm), 30, tg)
    want = jev.apply_events_banked_batched(jnp.asarray(vm), jb.masks,
                                           jnp.asarray(kern))
    got = tev.apply_events_banked_batched(_t(vm), tb.masks, _t(kern))
    _eq(want, got)
    # the one-tile views (JAX's own tests equate them with the batch rows)
    _eq(np.asarray(want)[0],
        tev.apply_events_banked(_t(vm[0]), tb.masks[0], _t(kern)))
    _eq(np.asarray(jev.apply_events_banked_batched(
            jnp.asarray(vm[1:2, ..., :1]), jb.masks[1:2],
            jnp.asarray(kern[..., :1])))[0, ..., 0],
        tev.apply_events_banked(_t(vm[1, ..., 0]), tb.masks[1],
                                _t(kern[..., 0])))
    # the fused consumer over the padded carrier, and the banked one
    jtaps = jev.tap_matrix(jnp.asarray(kern)).astype(vm.dtype)
    ttaps = tev.tap_matrix(_t(kern)).to(_t(vm).dtype)
    tvb = tev.bank_vm(_t(vm), tg)
    padded = np.pad(np.asarray(jb.masks), [(0, 0)] * 2 + [(1, 1), (1, 1)])
    fused = jev.apply_banked_columns_fused(jev.bank_vm(jnp.asarray(vm), jg),
                                           jnp.asarray(padded), jtaps, jg)
    _eq(fused, tev.apply_banked_columns_fused(tvb, _t(padded), ttaps, tg))
    _eq(fused, tev.apply_banked_columns(
        tvb, tev.shifted_bank_masks(tb.masks, tg), ttaps))
    if dtype != np.float32:
        sat = np.iinfo(dtype)
        out = got.numpy()
        assert (out == sat.max).any() or (out == sat.min).any()


@pytest.mark.parametrize("k,dtype", [(1, np.int8), (3, np.float32),
                                     (5, np.int16)])
def test_event_conv_banked_wrapper_matches_jax_chain(k, dtype):
    """The banked kernel's function (its plain version on the CPU): every
    input channel of one time step of a truncating carrier, applied in
    order, against JAX's bank_vm -> apply_banked_columns_fused per c_in
    -> unbank_vm."""
    jg, tg = JGeom(k, k), TGeom(k, k)
    rng = np.random.default_rng(200 + k + 7 * DTYPES.index(dtype))
    b, h, w, c, c_in = 2, 10, 9, 3, 2
    hp, wp = h + 2 * (k // 2), w + 2 * (k // 2)
    spikes = rng.random((b, 1, h, w, c_in)) < 0.5
    jh = jaeq.build_fused_handoff(jnp.asarray(spikes), 24, jg)
    vm = _values(rng, (b, hp, wp, c), dtype)
    kern = _values(rng, (k, k, c_in, c), dtype, kernel=True)
    jtaps = jnp.moveaxis(jev.tap_matrix(jnp.asarray(kern)), 2, 0)
    jtaps = jtaps.astype(vm.dtype)
    vb = jev.bank_vm(jnp.asarray(vm), jg)
    for ci in range(c_in):
        vb = jev.apply_banked_columns_fused(vb, jh.masks[0, ci], jtaps[ci], jg)
    want = jev.unbank_vm(vb, hp, wp, jg)
    tvm = _t(vm)
    got = event_conv_cuda_banked(tvm, _t(jh.masks[0]), _t(jtaps),
                                 geometry=tg, out=tvm)
    assert got is tvm
    _eq(want, got)
    with pytest.raises(ValueError, match="masks must be"):
        event_conv_cuda_banked(tvm, _t(jh.masks[0])[:, :1], _t(jtaps),
                               geometry=tg)
    with pytest.raises(ValueError, match="taps must be"):
        event_conv_cuda_banked(tvm, _t(jh.masks[0]), _t(jtaps)[:1],
                               geometry=tg)


# ------------------------------------------------ threshold emission
@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("pool", [None, 3])
@pytest.mark.parametrize("k", KS)
def test_threshold_pool_emit_matches_pallas(k, pool, dtype):
    """ops.threshold_pool with emission (kernel wrapper and plain path)
    against JAX's wrapper over threshold_pool_pallas in interpret mode:
    all five outputs, truncation live, ragged pool edge."""
    jg, tg = JGeom(k, k), TGeom(k, k)
    rng = np.random.default_rng(300 + 10 * k + (pool or 0)
                                + (dtype == np.int16))
    h, w, c = 10, 11, 4
    if dtype == np.float32:
        vm = rng.normal(size=(h, w, c)).astype(dtype)
        bias = rng.normal(size=(c,)).astype(dtype)
        v_t = 0.5
    else:
        vm = rng.integers(-100, 100, (h, w, c)).astype(dtype)
        bias = rng.integers(-10, 10, (c,)).astype(dtype)
        v_t = 20
    fired = rng.random((h, w, c)) < 0.1
    cap = (h * w) // 2
    want = jthr_ops.threshold_pool(
        jnp.asarray(vm), jnp.asarray(bias), jnp.asarray(fired), v_t=v_t,
        pool=pool, block_c=c, use_kernel=True, emit_capacity=cap,
        emit_geometry=jg)
    assert len(want) == 5
    for use_kernel in (True, False):
        got = tthr_ops.threshold_pool(
            _t(vm), _t(bias), _t(fired), v_t=v_t, pool=pool,
            use_kernel=use_kernel, emit_capacity=cap, emit_geometry=tg)
        assert len(got) == 5
        for a, b in zip(want, got):
            _eq(a, b)
    # the oracle functions themselves, on the padded map JAX emits from
    sp = np.asarray(want[2])
    for a, b in zip(jthr_ref.emit_banked(jnp.asarray(sp), capacity=cap,
                                         geometry=jg),
                    tthr_ref.emit_banked(_t(sp), capacity=cap, geometry=tg)):
        _eq(a, b)


@pytest.mark.parametrize("k", KS)
def test_emit_tile_outputs_equal_fused_carrier(k):
    """The emit kernel's function on the scheduler's halo-padded tiles:
    its masks, demand counts and column counts are the carrier
    build_fused_handoff makes of the pooled output, in the carrier's
    (C, Q, ...) slab layout; the demand exceeds the kept events."""
    tg = TGeom(k, k)
    rng = np.random.default_rng(400 + k)
    q, h, w, c, hh = 2, 28, 28, 3, 1
    vm = _t(rng.normal(size=(q, h + 2, w + 2, c)).astype(np.float32))
    fired = _t(rng.random((q, h, w, c)) < 0.3)
    bias = torch.zeros(c)
    spikes, pooled, masks, count, seg = threshold_pool_cuda_emit(
        vm, bias, fired, v_t=0.2, pool=3, halo=(hh, hh), emit_capacity=16,
        emit_geometry=tg)
    ho = taeq.build_fused_handoff(pooled[:, None], 16, tg)
    assert torch.equal(masks, ho.masks[0])
    assert torch.equal(count, ho.count[0].T)
    assert (count > 16).any()
    il = taeq.interlace(pooled.permute(3, 0, 1, 2), tg)
    assert torch.equal(seg, taeq.ranked_keep(il, 16, (10, 10))[2])
    assert torch.equal(seg.sum(-1), count.clamp(max=16))
    # stale bits: every byte of a reused buffer is rewritten
    vm2 = _t(rng.normal(size=(q, h + 2, w + 2, c)).astype(np.float32))
    out = (torch.ones_like(spikes), torch.ones_like(pooled),
           torch.ones_like(masks), torch.full_like(count, 7),
           torch.full_like(seg, 7))
    fresh = threshold_pool_cuda_emit(vm2.clone(), bias, fired, v_t=0.2,
                                     pool=3, halo=(hh, hh), emit_capacity=16,
                                     emit_geometry=tg)
    reused = threshold_pool_cuda_emit(
        vm2, bias, fired, v_t=0.2, pool=3, halo=(hh, hh), emit_capacity=16,
        emit_geometry=tg, fired_out=out[0], pooled_out=out[1],
        masks_out=out[2], count_out=out[3], seg_counts_out=out[4])
    for a, b in zip(fresh, reused):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="masks_out must be"):
        threshold_pool_cuda_emit(vm2, bias, fired, v_t=0.2, pool=3,
                                 halo=(hh, hh), emit_capacity=16,
                                 emit_geometry=tg, masks_out=out[2][:1])
    with pytest.raises(ValueError, match="emit_capacity"):
        threshold_pool_cuda_emit(vm2, bias, fired, v_t=0.2, pool=3,
                                 halo=(hh, hh), emit_capacity=0)


def test_producer_emission_equals_boundary_build():
    """A producer run with ``emit`` returns the carrier build_fused_handoff
    makes of its dense output (the JAX boundary), and the same carry and
    stats; a carrier fed to an unfused layer is refused."""
    cfg = tc.CSNNConfig(input_hw=(12, 12),
                        layers=(tc.ConvSpec(4), tc.ConvSpec(4, kernel=5),
                                tc.FCSpec(3)), t_steps=3)
    plan = tplan(cfg, capacity=40, channel_block=2,
                 variant=[None, "fused-handoff"])
    params = tc.init_params(cfg, seed=2, device="cpu")
    spikes = torch.rand((2, 3, 12, 12, 1),
                        generator=torch.Generator().manual_seed(0)) < 0.4
    lp0, lp1 = plan.layers
    args = (spikes, params["conv0"]["w"], params["conv0"]["b"], cfg.v_t, lp0)
    dense, c_a, s_a = run_conv_layer_batched_chunk(
        *args, init_conv_carry(lp0, 2, device="cpu"))
    ho, c_b, s_b = run_conv_layer_batched_chunk(
        *args, init_conv_carry(lp0, 2, device="cpu"),
        emit=(lp1.capacity, lp1.geometry))
    want = taeq.build_fused_handoff(dense, lp1.capacity, lp1.geometry)
    assert torch.equal(ho.masks, want.masks)
    assert torch.equal(ho.count, want.count)
    assert torch.equal(c_a.vm, c_b.vm) and torch.equal(c_a.fired, c_b.fired)
    assert torch.equal(s_a.out_spike_counts, s_b.out_spike_counts)
    with pytest.raises(ValueError, match="only a layer pinned"):
        run_conv_layer_batched_chunk(
            ho, params["conv1"]["w"], params["conv1"]["b"], cfg.v_t,
            tplan(cfg, capacity=40, channel_block=2).layers[1],
            init_conv_carry(lp1, 2, device="cpu"))


# ------------------------------------------------ the slice
def _cfgs(k):
    def cfg(mod):
        return mod.CSNNConfig(input_hw=(12, 12),
                              layers=(mod.ConvSpec(4, kernel=k),
                                      mod.ConvSpec(4, kernel=k, pool=3),
                                      mod.FCSpec(3)),
                              t_steps=4)
    return cfg(jc), cfg(tc)


def _jax_reference(params, spikes, cfg, plan):
    """init_state -> snn_step_chunk -> snn_readout, jitted."""
    def run(p, s):
        state = jc.init_state(p, cfg, plan, s.shape[0])
        state, stats = jc.snn_step_chunk(p, state, s, cfg, plan,
                                         collect_stats=True)
        return jc.snn_readout(p, state, cfg, plan), stats, state
    return jax.jit(run)(jax.tree.map(jnp.asarray, params),
                        jnp.asarray(spikes))


@pytest.mark.parametrize("k,sat_bits", [(1, None), (3, None), (5, None),
                                        (3, 16), (3, 8)],
                         ids=["k1-f32", "k3-f32", "k5-f32", "k3-i16", "k3-i8"])
def test_fused_and_banked_slice_match_jax(k, sat_bits):
    jcfg, tcfg = _cfgs(k)
    rng = np.random.default_rng(k)
    params = jax.tree.map(np.asarray,
                          jc.init_params(jax.random.PRNGKey(k), jcfg))
    if sat_bits:
        params = jax.tree.map(
            lambda x: np.clip(np.round(x * 16), -100, 100).astype(np.float32),
            params)
    spikes = rng.random((2, 4, 12, 12, 1)) < 0.3
    # capacity 64 < 144 cells of conv0's input and output: truncation
    kw = dict(capacity=64, channel_block=4, batch_tile=2, sat_bits=sat_bits)
    jlogits, jstats, jstate = _jax_reference(
        params, spikes, jcfg, jplan(jcfg, variant=["fused-handoff"] * 2, **kw))
    tparams = params_from_numpy(params, "cpu")
    tspikes = torch.from_numpy(spikes)
    results = {}
    for variant in ("fused-handoff", "banked-cuda", None):
        plan = tplan(tcfg, variant=[variant] * 2, **kw)
        logits, stats = tc.snn_apply_batched(tparams, tspikes, tcfg, plan)
        np.testing.assert_allclose(np.asarray(jlogits), logits.numpy(),
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(np.asarray(jlogits).argmax(-1),
                                      logits.numpy().argmax(-1))
        for a, b in zip(jstats, stats):
            for f in ("in_spike_counts", "out_spike_counts"):
                _eq(getattr(a, f), getattr(b, f))
            np.testing.assert_allclose(np.asarray(a.in_sparsity),
                                       b.in_sparsity.numpy(), rtol=1e-6)
        # chunked: t_chunk=2, stepping the carry
        cplan = tplan(tcfg, variant=[variant] * 2, t_chunk=2, **kw)
        state = tc.init_state(tparams, tcfg, cplan, 2)
        for t0 in (0, 2):
            state = tc.snn_step_chunk(tparams, state, tspikes[:, t0:t0 + 2],
                                      tcfg, cplan)
        for jcarry, tcarry in zip(jstate.convs, state.convs):
            _eq(jcarry.vm, tcarry.vm)
            _eq(jcarry.fired, tcarry.fired)
        _eq(jstate.fc_drive, state.fc_drive)
        results[variant] = (logits, tc.snn_readout(tparams, state, tcfg), state)
    # within the port: fused == banked == sequential, exactly
    ref = results[None]
    for variant in ("fused-handoff", "banked-cuda"):
        got = results[variant]
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        for a, b in zip(got[2].convs, ref[2].convs):
            assert torch.equal(a.vm, b.vm) and torch.equal(a.fired, b.fired)


def test_wide_fused_edge_and_launch_free_cpu_path():
    """csnn_wide's 5x5 first layer at the network edge, fused throughout,
    equals the sequential plan; on the CPU nothing is launched."""
    from repro_torch.configs import csnn_wide
    cfg = csnn_wide.SMOKE
    params = tc.init_params(cfg, seed=4, device="cpu")
    spikes = torch.rand((2, 4, 12, 12, 1),
                        generator=torch.Generator().manual_seed(4)) < 0.4
    runtime.reset_launches()
    fused = tc.snn_apply_batched(params, spikes, cfg,
                                 tplan(cfg, capacity=64, channel_block=4,
                                       variant="fused-handoff"),
                                 collect_stats=False)
    seq = tc.snn_apply_batched(params, spikes, cfg,
                               tplan(cfg, capacity=64, channel_block=4),
                               collect_stats=False)
    assert torch.equal(fused, seq)
    assert all(v == 0 for v in runtime.LAUNCHES.values())
