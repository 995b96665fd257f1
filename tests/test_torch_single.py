"""The port's single-sample path, its oracles and the sparse FC head
against the JAX package, with the same numpy inputs and parameters.

On the CPU each kernel wrapper runs its plain version; the JAX side runs
its Pallas kernels in interpret mode (``backend="pallas"``), as its own
tests run them.  Tolerances, with their reasons:

* spikes, ``LayerStats`` counts, int tiles and float tiles: exact (float
  tiles by value: a +0.0 the Pallas kernel adds for an invalid slot
  equals a -0.0 left untouched);
* logits: ``LOGIT_TOL`` (rtol=1e-5, atol=1e-4): JAX sums the head in
  float32, the port in float64, then rounds once;
* the dense oracles run on dyadic weights (multiples of 1/8), so every
  summation order is exact and their spikes compare exactly;
  ``ann_apply`` to rtol=1e-5 (float32 convolutions in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import csnn_paper as jpaper
from repro.core import aeq as jaeq
from repro.core import csnn as jc
from repro.core import scheduler as js
from repro.core import sparse_ffn as jsf
from repro.core.event_conv import apply_events_blocked as japply_blocked
from repro.core.event_conv import dense_conv as jdense_conv
from repro.core.geometry import ConvGeometry as JGeom
from repro.core.plan import plan_conv_layer as jplan_layer
from repro.core.plan import plan_network as jplan
from repro.data.synthetic import synth_digits as jsynth
from repro.kernels.event_conv import ops as jops
from repro.kernels.event_conv.kernel import (event_conv_pallas,
                                             event_conv_pallas_interlaced)
from repro_torch.configs import csnn_paper as tpaper
from repro_torch.convert import params_from_numpy
from repro_torch.core import aeq as taeq
from repro_torch.core import csnn as tc
from repro_torch.core import scheduler as ts
from repro_torch.core import sparse_ffn as tsf
from repro_torch.core.event_conv import apply_events_blocked as tapply_blocked
from repro_torch.core.event_conv import dense_conv as tdense_conv
from repro_torch.core.geometry import ConvGeometry as TGeom
from repro_torch.core.plan import plan_conv_layer as tplan_layer
from repro_torch.core.plan import plan_network as tplan
from repro_torch.data.synthetic import synth_digits as tsynth
from repro_torch.kernels import runtime
from repro_torch.kernels.event_conv import ops as tops
from repro_torch.kernels.event_conv.kernel import (event_conv_cuda,
                                                   event_conv_cuda_interlaced)

LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
DTYPES = [np.float32, np.int16, np.int8]
# JAX variant name -> the port's (the kernels run in CUDA, not Pallas/jnp)
VARIANTS = {"sequential": "sequential", "interlaced-pallas": "interlaced-cuda",
            "banked-jax": "banked-cuda", "fused-handoff": "fused-handoff"}
# the whole-network config of the JAX package's own Pallas-backend test
# (tests/test_kernels.py::TestSchedulerPallasBackend)
NET = dict(input_hw=(12, 12), layers=(jc.ConvSpec(4), jc.ConvSpec(4, pool=3),
                                      jc.FCSpec(3)), t_steps=3)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _values(rng, shape, dtype, kernel=False):
    if dtype == np.float32:
        return rng.normal(size=shape).astype(dtype)
    if dtype == np.int8:
        return rng.integers(-90 if kernel else -100, 90 if kernel else 100,
                            size=shape).astype(dtype)
    return rng.integers(-20000 if kernel else -30000,
                        20000 if kernel else 30000, size=shape).astype(dtype)


def _net_cfgs():
    jcfg = jc.CSNNConfig(**NET)
    tcfg = tc.CSNNConfig(input_hw=NET["input_hw"], t_steps=NET["t_steps"],
                         layers=(tc.ConvSpec(4), tc.ConvSpec(4, pool=3),
                                 tc.FCSpec(3)))
    return jcfg, tcfg


def _net_case(seed, dyadic=False):
    """Numpy parameters of the NET config and one encoded image."""
    jcfg, tcfg = _net_cfgs()
    params = jax.tree.map(np.asarray,
                          jc.init_params(jax.random.PRNGKey(seed), jcfg))
    if dyadic:  # multiples of 1/8: every summation order is exact
        params = jax.tree.map(lambda x: np.round(x * 8) / 8, params)
    img = np.random.default_rng(seed).random((12, 12, 1)).astype(np.float32)
    spikes = np.array(jc.encode_input(jnp.asarray(img)[None], jcfg))[0]
    return jcfg, tcfg, params, img, spikes


def _assert_stats(jstats, tstats):
    for a, b in zip(jstats, tstats):
        for f in ("in_spike_counts", "out_spike_counts"):
            _eq(getattr(a, f), getattr(b, f))
        np.testing.assert_allclose(np.asarray(a.in_sparsity),
                                   b.in_sparsity.numpy(), rtol=1e-6)
        assert int(a.event_block) == b.event_block
        assert int(a.event_par) == b.event_par


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3, 5])
def test_event_conv_ops_matches_pallas(dtype, k):
    """ops.event_conv (halo pad, segment pad, block padding, crop) vs the
    JAX wrapper over event_conv_pallas / event_conv_pallas_interlaced, on
    a truncated queue; saturation reached on the int datapaths."""
    rng = np.random.default_rng(k + 10 * DTYPES.index(dtype))
    h, w, c = 9, 10, 3
    fm = rng.random((h, w)) < 0.6
    jq = jaeq.build_aeq(jnp.asarray(fm), 40, geometry=JGeom(k, k))
    tq = taeq.build_aeq(torch.from_numpy(fm), 40, geometry=TGeom(k, k))
    vm = _values(rng, (h, w, c), dtype)
    kern = _values(rng, (k, k, c), dtype, kernel=True)
    for event_par in (1, 4):
        want = jops.event_conv(jnp.asarray(vm), jq, jnp.asarray(kern),
                               block_e=None, event_par=event_par)
        for use_kernel in (True, False):
            got = tops.event_conv(torch.from_numpy(vm), tq,
                                  torch.from_numpy(kern), block_e=None,
                                  event_par=event_par, use_kernel=use_kernel)
            _eq(want, got)
    if dtype != np.float32:
        sat = np.iinfo(dtype)
        got = got.numpy()
        assert (got == sat.max).any() or (got == sat.min).any()
    if k == 3 and dtype == np.float32:  # the 2-D (H, W) form
        want = jops.event_conv(jnp.asarray(vm[..., 0]), jq,
                               jnp.asarray(kern[..., 0]), block_e=16)
        _eq(want, tops.event_conv(torch.from_numpy(vm[..., 0]), tq,
                                  torch.from_numpy(kern[..., 0]),
                                  block_e=16))


@pytest.mark.parametrize("dtype", DTYPES)
def test_single_wrappers_match_pallas_on_padded_tiles(dtype):
    """The wrappers the scheduler calls (one halo-padded tile, the queue as
    is) vs event_conv_pallas / event_conv_pallas_interlaced: a
    segment-padded queue, an unpadded one (mixed groups, in queue order)
    and repeated coordinates in a column-homogeneous group (land once)."""
    rng = np.random.default_rng(20 + DTYPES.index(dtype))
    fm = rng.random((8, 8)) < 0.5
    jq = jaeq.build_aeq(jnp.asarray(fm), 48)
    tq = taeq.build_aeq(torch.from_numpy(fm), 48)
    vm = _values(rng, (10, 10, 5), dtype)
    kern = _values(rng, (3, 3, 5), dtype, kernel=True)
    tvm, tk = torch.from_numpy(vm), torch.from_numpy(kern)
    want = event_conv_pallas(jnp.asarray(vm), jq.coords, jq.valid,
                             jnp.asarray(kern), block_e=48)
    _eq(want, event_conv_cuda(tvm, tq.coords, tq.valid, tk))
    # every interlaced queue padded to the segment-padded depth E (one
    # Pallas compile per dtype): the unpadded queue and a queue repeating
    # coordinates inside column-homogeneous groups
    jp_, tp_ = jaeq.segment_pad(jq, 4), taeq.segment_pad(tq, 4)
    e = tp_.capacity
    rep_c = np.zeros((e, 2), np.int32)
    rep_v = np.zeros(e, bool)
    rep_c[:8] = [[4, 4], [4, 4], [7, 4], [4, 4]] * 2
    rep_v[:8] = [1, 1, 1, 0] * 2
    pad = e - tq.capacity
    unpadded = (np.pad(np.asarray(jq.coords), ((0, pad), (0, 0))),
                np.pad(np.asarray(jq.valid), (0, pad)))
    for c, v in ((jp_.coords, jp_.valid), unpadded, (rep_c, rep_v)):
        c, v = np.array(c), np.array(v)
        want = event_conv_pallas_interlaced(
            jnp.asarray(vm), jnp.asarray(c), jnp.asarray(v),
            jnp.asarray(kern), block_e=e, event_par=4)
        out = tvm.clone()  # in place, as the scheduler calls it
        event_conv_cuda_interlaced(out, torch.from_numpy(c),
                                   torch.from_numpy(v), tk, event_par=4,
                                   out=out)
        _eq(want, out)
    np.testing.assert_array_equal(np.asarray(jp_.coords), tp_.coords.numpy())


def test_single_wrapper_validation_errors():
    vm = torch.zeros((6, 6, 4))
    coords = torch.zeros((8, 2), dtype=torch.int32)
    valid = torch.zeros(8, dtype=torch.bool)
    kern = torch.zeros((3, 3, 4))
    with pytest.raises(ValueError, match=r"\(Hp, Wp, C\)"):
        event_conv_cuda(vm[None], coords, valid, kern)
    with pytest.raises(ValueError, match=r"\(E, 2\)"):
        event_conv_cuda(vm, coords[None], valid, kern)
    with pytest.raises(ValueError, match="valid bits shape"):
        event_conv_cuda(vm, coords, valid[:4], kern)
    with pytest.raises(ValueError, match="must match vm dtype"):
        event_conv_cuda(vm, coords, valid, kern.to(torch.int16))
    with pytest.raises(ValueError, match="odd"):
        event_conv_cuda(vm, coords, valid, torch.zeros((2, 2, 4)))
    with pytest.raises(ValueError, match="multiple of event_par"):
        event_conv_cuda_interlaced(vm, coords[:6], valid[:6], kern,
                                   event_par=4)
    with pytest.raises(ValueError, match=">= 2 events"):
        event_conv_cuda_interlaced(vm, coords, valid, kern, event_par=1)
    q = taeq.build_aeq(torch.zeros((4, 4), dtype=torch.bool), 8)
    with pytest.raises(ValueError, match="multiple of event_par"):
        tops.event_conv(torch.zeros((4, 4, 4)), q, kern, block_e=6,
                        event_par=4)
    runtime.reset_launches()
    event_conv_cuda(vm, coords, valid, kern, out=vm)  # CPU: plain version
    assert all(v == 0 for v in runtime.LAUNCHES.values())


def test_apply_events_blocked_matches_jax():
    rng = np.random.default_rng(3)
    fm = rng.random((7, 9)) < 0.5
    jq = jaeq.build_aeq(jnp.asarray(fm), 30)
    tq = taeq.build_aeq(torch.from_numpy(fm), 30)
    vm = rng.normal(size=(9, 11, 2)).astype(np.float32)
    kern = rng.normal(size=(3, 3, 2)).astype(np.float32)
    for block in (4, 64):
        want = japply_blocked(jnp.asarray(vm), jq, jnp.asarray(kern),
                              block=block)
        _eq(want, tapply_blocked(torch.from_numpy(vm), tq,
                                 torch.from_numpy(kern), block=block))


@pytest.mark.parametrize("dtype", [None, 8], ids=["f32", "i8"])
@pytest.mark.parametrize("jvariant", list(VARIANTS))
def test_run_conv_layer_planned_matches_jax(jvariant, dtype):
    """Every variant, one sample, a truncating queue, pool 3: spikes and
    stats exact against JAX's run_conv_layer_planned(backend="pallas")."""
    rng = np.random.default_rng(7)
    spikes = rng.random((3, 9, 9, 3)) < 0.4
    scale = 1.0 if dtype is None else 16.0
    kern = np.round(rng.normal(size=(3, 3, 3, 4)) * scale).astype(np.float32)
    bias = np.round(rng.normal(size=(4,)) * scale * 0.1).astype(np.float32)
    kw = dict(capacity=24, pool=3, channel_block=2, sat_bits=dtype,
              event_par=1 if jvariant == "sequential" else 4)
    jlp = jplan_layer(0, "conv", (9, 9), 3, 4, variant=jvariant, **kw)
    tlp = tplan_layer(0, "conv", (9, 9), 3, 4, variant=VARIANTS[jvariant],
                      **kw)
    want, jst = js.run_conv_layer_planned(
        jnp.asarray(spikes), jnp.asarray(kern), jnp.asarray(bias), 1.0, jlp,
        backend="pallas")
    got, tst = ts.run_conv_layer_planned(
        torch.from_numpy(spikes), torch.from_numpy(kern),
        torch.from_numpy(bias), 1.0, tlp)
    _eq(want, got)
    _assert_stats([jst], [tst])
    assert tst.in_spike_counts.shape == (3, 3)
    if jvariant == "sequential":  # the kwargs shims derive the same plan
        got, _ = ts.run_conv_layer(
            torch.from_numpy(spikes), torch.from_numpy(kern),
            torch.from_numpy(bias), 1.0, capacity=24, pool=3,
            channel_block=2, sat_bits=dtype)
        _eq(want, got)
        bgot, btst = ts.run_conv_layer_batched(
            torch.from_numpy(spikes)[None], torch.from_numpy(kern),
            torch.from_numpy(bias), 1.0, capacity=24, pool=3,
            channel_block=2, sat_bits=dtype)
        _eq(np.asarray(want)[None], bgot)
        _assert_stats([jst], [btst._replace(
            in_spike_counts=btst.in_spike_counts[0],
            out_spike_counts=btst.out_spike_counts[0],
            in_sparsity=btst.in_sparsity[0])])


def test_snn_apply_matches_jax():
    """snn_apply vs the JAX per-layer Pallas composition of its own
    Pallas-backend test (run_conv_layer(backend="pallas") + run_fc_head),
    through the kwargs shim with the composition's knobs; and vs JAX's
    snn_apply under an interlaced, truncating plan."""
    jcfg, tcfg, np_params, _, spikes = _net_case(0)
    jp = jax.tree.map(jnp.asarray, np_params)
    x = jnp.asarray(spikes)
    for idx, spec in enumerate(jcfg.layers):
        if isinstance(spec, jc.ConvSpec):
            p = jp[f"conv{idx}"]
            x, _ = js.run_conv_layer(x, p["w"], p["b"], jcfg.v_t,
                                     capacity=144, pool=spec.pool,
                                     backend="pallas")
        else:
            p = jp[f"fc{idx}"]
            composed = js.run_fc_head(x, p["w"], p["b"])
    params = params_from_numpy(np_params, "cpu")
    tspikes = torch.from_numpy(spikes)
    shim = tc.snn_apply(params, tspikes, tcfg, capacity=144,
                        collect_stats=False)
    np.testing.assert_allclose(np.asarray(composed), shim.numpy(),
                               **LOGIT_TOL)
    assert int(np.argmax(composed)) == int(shim.argmax())
    kw = dict(capacity=64, channel_block=2, event_par=4)
    jlogits, jstats = jc.snn_apply(jp, jnp.asarray(spikes), jcfg,
                                   jplan(jcfg, **kw))
    logits, stats = tc.snn_apply(params, tspikes, tcfg, tplan(tcfg, **kw))
    np.testing.assert_allclose(np.asarray(jlogits), logits.numpy(),
                               **LOGIT_TOL)
    assert int(np.argmax(jlogits)) == int(logits.argmax())
    _assert_stats(jstats, stats)
    assert [lp.resolve_variant() for lp in tplan(tcfg, **kw).layers] == [
        "interlaced-cuda"] * 2


def test_dense_oracles_match_jax():
    """run_conv_layer_dense, snn_apply_dense, dense_conv and ann_apply on
    dyadic weights; the dense oracle's spikes equal the event-driven
    path's, and the process-wide cuDNN TF32 switch is left as found."""
    jcfg, tcfg, np_params, img, spikes = _net_case(1, dyadic=True)
    jp = jax.tree.map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    tspikes = torch.from_numpy(spikes)
    before = torch.backends.cudnn.allow_tf32
    want = js.run_conv_layer_dense(jnp.asarray(spikes), jp["conv0"]["w"],
                                   jp["conv0"]["b"], jcfg.v_t, pool=3)
    got = ts.run_conv_layer_dense(tspikes, params["conv0"]["w"],
                                  params["conv0"]["b"], tcfg.v_t, pool=3)
    _eq(want, got)
    event, _ = ts.run_conv_layer(tspikes, params["conv0"]["w"],
                                 params["conv0"]["b"], tcfg.v_t,
                                 capacity=144, pool=3)
    assert torch.equal(event, got)
    jlogits = jc.snn_apply_dense(jp, jnp.asarray(spikes), jcfg)
    tlogits = tc.snn_apply_dense(params, tspikes, tcfg)
    np.testing.assert_allclose(np.asarray(jlogits), tlogits.numpy(),
                               **LOGIT_TOL)
    elogits = tc.snn_apply(params, tspikes, tcfg, capacity=144,
                           collect_stats=False)
    assert torch.equal(elogits, tlogits)  # same spikes, same head product
    fm = spikes[1, :, :, 0]
    for kern in (np_params["conv0"]["w"][:, :, 0, :],
                 np_params["conv0"]["w"][:, :, 0, 0]):
        _eq(jdense_conv(jnp.asarray(fm), jnp.asarray(kern)),
            tdense_conv(torch.from_numpy(fm), torch.from_numpy(kern)))
    imgs = np.stack([img, img[::-1]])
    want = jc.ann_apply(jp, jnp.asarray(imgs), jcfg)
    got = tc.ann_apply(params, torch.from_numpy(imgs.copy()), tcfg)
    np.testing.assert_allclose(np.asarray(want), got.numpy(), rtol=1e-5)
    assert torch.backends.cudnn.allow_tf32 is before
    with pytest.raises(ValueError, match="float kernel"):
        tdense_conv(torch.from_numpy(fm), torch.ones((3, 3), dtype=torch.int8))


def test_event_readout_keeps_jax_entries_under_ties():
    """Integer drives tie everywhere: a truncating queue keeps the same
    entries as jax.lax.top_k (the lower index first).  With W = I the
    head's output is the compacted drive itself."""
    rng = np.random.default_rng(9)
    drive = rng.integers(0, 3, size=(4, 24)).astype(np.float32)
    eye = np.eye(24, dtype=np.float32)
    for cap in (1, 5, 11, 24):
        want = jsf.event_readout(jnp.asarray(drive), jnp.asarray(eye),
                                 capacity=cap)
        _eq(want, tsf.event_readout(torch.from_numpy(drive),
                                    torch.from_numpy(eye), capacity=cap))
    _eq(jsf.drive_active_counts(jnp.asarray(drive)),
        tsf.drive_active_counts(torch.from_numpy(drive)))
    with pytest.raises(ValueError, match="capacity"):
        tsf.event_readout(torch.from_numpy(drive), torch.from_numpy(eye),
                          capacity=25)
    # the one-sample head: truncating and covering queues
    spikes = rng.random((3, 2, 2, 6)) < 0.4
    w = rng.normal(size=(24, 5)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    for cap in (3, 24, None):
        want = js.run_fc_head(jnp.asarray(spikes), jnp.asarray(w),
                              jnp.asarray(b), capacity=cap)
        got = ts.run_fc_head(torch.from_numpy(spikes), torch.from_numpy(w),
                             torch.from_numpy(b), capacity=cap)
        np.testing.assert_allclose(np.asarray(want), got.numpy(),
                                   **LOGIT_TOL)


def test_snn_readout_fc_capacity_matches_jax():
    """fc_capacity through snn_apply (one sample) and snn_apply_batched
    (the readout) vs JAX, at a truncating queue and a calibrated one."""
    jcfg, tcfg, np_params, _, spikes = _net_case(2)
    jp = jax.tree.map(jnp.asarray, np_params)
    params = params_from_numpy(np_params, "cpu")
    tspikes = torch.from_numpy(spikes)
    plan = tplan(tcfg, capacity=64)
    state = tc.init_state(params, tcfg, plan, 1)
    state = tc.snn_step_chunk(params, state, tspikes[None], tcfg, plan)
    counts = tsf.drive_active_counts(state.fc_drive)
    d = state.fc_drive.shape[-1]
    covering = min(taeq.calibrate_capacity(counts), d)
    dense = tc.snn_readout(params, state, tcfg, plan)
    for cap in (3, covering):
        kw = dict(capacity=64, fc_capacity=cap)
        jlogits = jc.snn_apply(jp, jnp.asarray(spikes), jcfg,
                               jplan(jcfg, **kw), collect_stats=False)
        one = tc.snn_apply(params, tspikes, tcfg, tplan(tcfg, **kw),
                           collect_stats=False)
        batched = tc.snn_apply_batched(params, tspikes[None], tcfg,
                                       tplan(tcfg, **kw), collect_stats=False)
        np.testing.assert_allclose(np.asarray(jlogits), one.numpy(),
                                   **LOGIT_TOL)
        assert torch.equal(batched[0], one)
    assert torch.equal(batched, dense)  # the covering queue


def test_calibration_matches_jax():
    """calibrate_capacities and plan_network(stats=...) field by field."""
    rng = np.random.default_rng(4)
    per_layer = [rng.integers(0, 150, size=(3, 5, c)) for c in (1, 8)]
    kw = dict(percentile=90.0, margin=1.1)
    assert (taeq.calibrate_capacities(per_layer, **kw)
            == jaeq.calibrate_capacities(per_layer, **kw))
    assert taeq.calibrate_capacity(np.zeros((0,))) == 8
    tstats = [torch.from_numpy(x) for x in per_layer]  # tensors accepted
    jp = jplan(jpaper.SMOKE, stats=per_layer, event_par=[1, 4], **kw)
    tp = tplan(tpaper.SMOKE, stats=tstats, event_par=[1, 4], **kw)
    for jl, tl in zip(jp.layers, tp.layers):
        for f in ("capacity", "channel_block", "block_e", "event_par",
                  "vm_tile", "queue_depth"):
            assert getattr(jl, f) == getattr(tl, f), f
    with pytest.raises(ValueError, match="one stats entry"):
        tplan(tpaper.SMOKE, stats=tstats[:1])


def test_synth_digits_bit_equal():
    for n, seed, hw in ((3, 42, (28, 28)), (2, 7, (12, 12))):
        ji, jl = jsynth(n, seed=seed, hw=hw)
        ti, tl = tsynth(n, seed=seed, hw=hw)
        assert ji.dtype == ti.dtype and jl.dtype == tl.dtype
        np.testing.assert_array_equal(ji, ti)
        np.testing.assert_array_equal(jl, tl)


def test_quickstart_cli_on_cpu(capsys):
    from repro_torch.launch import quickstart
    assert quickstart.main(["--device", "cpu", "--smoke"]) == 0
    out = capsys.readouterr().out
    assert "dense-oracle match: True" in out and "AEQ at t=2" in out
    assert out.count("  layer ") == 2 and "device=cpu" in out
