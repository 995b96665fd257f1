"""The slice end to end: the port's batched CSNN inference against the
JAX package's ``backend="pallas"`` path (Pallas kernels in interpret
mode), with the same numpy parameters and inputs.

Spikes (as per-layer counts and the final-layer drive), per-layer counts
and the carried vm/fired state are exact; logits agree to
``LOGIT_TOL`` (the FC product sums in another order) with argmax equal.
The JAX reference is ``init_state`` -> ``snn_step_chunk`` ->
``snn_readout``, the body of its ``snn_apply_batched``, so the state is
observable too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import csnn_paper as jpaper
from repro.configs import csnn_wide as jwide
from repro.core import csnn as jc
from repro.core.plan import plan_network as jplan
from repro_torch.configs import csnn_paper as tpaper
from repro_torch.configs import csnn_wide as twide
from repro_torch.convert import params_from_numpy
from repro_torch.core import csnn as tc
from repro_torch.core.plan import plan_network as tplan

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
B = 2


def _case(cfgs, sat_bits, seed):
    jcfg, tcfg = cfgs
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray,
                          jc.init_params(jax.random.PRNGKey(seed), jcfg))
    if sat_bits:
        # integer-valued, in range: the int datapaths truncate the float
        # weights with astype(vm dtype) on both sides
        params = jax.tree.map(
            lambda x: np.clip(np.round(x * 16), -100, 100).astype(np.float32),
            params)
    imgs = rng.random((B,) + tuple(jcfg.input_hw) + (1,)).astype(np.float32)
    spikes = np.array(jc.encode_input(jnp.asarray(imgs), jcfg))
    tspikes = tc.encode_input(torch.from_numpy(imgs), tcfg)
    np.testing.assert_array_equal(spikes, tspikes.numpy())
    return jcfg, tcfg, params, spikes


def _jax_reference(params, spikes, cfg, plan):
    p = jax.tree.map(jnp.asarray, params)
    state = jc.init_state(p, cfg, plan, spikes.shape[0])
    state, stats = jc.snn_step_chunk(p, state, jnp.asarray(spikes), cfg, plan,
                                     backend="pallas", collect_stats=True)
    return jc.snn_readout(p, state, cfg, plan), stats, state


def _port_chunked(params, spikes, cfg, plan):
    state = tc.init_state(params, cfg, plan, spikes.shape[0])
    for k in range(0, cfg.t_steps, plan.chunk_steps):
        state = tc.snn_step_chunk(params, state,
                                  spikes[:, k:k + plan.chunk_steps], cfg, plan)
    return state


def _assert_stats(jstats, tstats):
    for a, b in zip(jstats, tstats):
        for f in ("in_spike_counts", "out_spike_counts"):
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy())
        np.testing.assert_allclose(np.asarray(a.in_sparsity),
                                   b.in_sparsity.numpy(), rtol=1e-6)
        assert int(a.event_block) == b.event_block
        assert int(a.event_par) == b.event_par


@pytest.mark.parametrize("sat_bits", [None, 16, 8], ids=["f32", "i16", "i8"])
@pytest.mark.parametrize("event_par", [1, 8])
@pytest.mark.parametrize("cfgs", [(jpaper.SMOKE, tpaper.SMOKE),
                                  (jwide.SMOKE, twide.SMOKE)],
                         ids=["paper", "wide"])
def test_snn_apply_batched_matches_jax_pallas(cfgs, event_par, sat_bits):
    jcfg, tcfg, np_params, spikes = _case(cfgs, sat_bits, seed=3)
    kw = dict(capacity=64, channel_block=4, event_par=event_par,
              sat_bits=sat_bits)  # capacity 64 < 144 cells: truncation
    jlogits, jstats, jstate = _jax_reference(np_params, spikes, jcfg,
                                             jplan(jcfg, **kw))
    params = params_from_numpy(np_params, "cpu")
    tspikes = torch.from_numpy(spikes)
    for t_chunk in (1, tcfg.t_steps):
        plan = tplan(tcfg, t_chunk=t_chunk, **kw)
        logits, stats = tc.snn_apply_batched(params, tspikes, tcfg, plan)
        np.testing.assert_allclose(np.asarray(jlogits), logits.numpy(),
                                   **LOGIT_TOL)
        np.testing.assert_array_equal(np.asarray(jlogits).argmax(-1),
                                      logits.numpy().argmax(-1))
        _assert_stats(jstats, stats)
        state = _port_chunked(params, tspikes, tcfg, plan)
        for jcarry, tcarry in zip(jstate.convs, state.convs):
            # by value: a +0.0 Pallas adds for an invalid slot == -0.0
            np.testing.assert_array_equal(np.asarray(jcarry.vm),
                                          tcarry.vm.numpy())
            np.testing.assert_array_equal(np.asarray(jcarry.fired),
                                          tcarry.fired.numpy())
        np.testing.assert_array_equal(np.asarray(jstate.fc_drive),
                                      state.fc_drive.numpy())
    if event_par > 1:
        # the sequential unit over the same segment-padded queues and the
        # banked unit over the same events agree
        for variant in ("sequential", "banked-cuda"):
            other = tc.snn_apply_batched(
                params, tspikes, tcfg, tplan(tcfg, variant=variant, **kw),
                collect_stats=False)
            assert torch.equal(other, logits)
        with pytest.raises(ValueError, match="must be one of"):
            tplan(tcfg, variant="banked-jax", **kw)


def test_csnn_module_forward_and_keys():
    cfg = tpaper.SMOKE
    model = tc.CSNN(cfg, seed=1, device="cpu")
    assert list(model.state_dict()) == ["conv0.w", "conv0.b", "conv1.w",
                                        "conv1.b", "fc2.w", "fc2.b"]
    assert not any(p.requires_grad for p in model.parameters())
    imgs = torch.rand((3, 12, 12, 1), generator=torch.Generator().manual_seed(0))
    plan = tplan(cfg, channel_block=8)
    spikes = tc.encode_input(imgs, cfg)
    logits = model(spikes, plan, collect_stats=False)
    want = tc.snn_apply_batched(tc.init_params(cfg, seed=1, device="cpu"),
                                spikes, cfg, plan, collect_stats=False)
    assert logits.shape == (3, 10) and torch.equal(logits, want)


def test_init_params_shapes_match_jax_and_seed():
    for jcfg, tcfg in ((jpaper.FULL, tpaper.FULL), (jwide.FULL, twide.FULL)):
        jp = jax.eval_shape(lambda c=jcfg: jc.init_params(jax.random.PRNGKey(0), c))
        tp = tc.init_params(tcfg, seed=0, device="cpu")
        assert jax.tree.map(lambda x: tuple(x.shape), jp) == {
            k: {n: tuple(t.shape) for n, t in v.items()} for k, v in tp.items()}
    a = tc.init_params(tpaper.SMOKE, seed=5, device="cpu")
    b = tc.init_params(tpaper.SMOKE, seed=5, device="cpu")
    assert all(torch.equal(a[k]["w"], b[k]["w"]) for k in a)


def test_unported_options_raise(tmp_path):
    """The pinned fused/banked variants run (and equal the default plan);
    fc_capacity runs, and at a covering capacity equals the dense head;
    the measured tuner's plan gives the same logits, an unknown tune mode
    raises, and so does a chunk that is neither spikes nor a
    StreamState."""
    cfg = tpaper.SMOKE
    params = tc.init_params(cfg, device="cpu")
    spikes = torch.rand((1, 4, 12, 12, 1),
                        generator=torch.Generator().manual_seed(0)) < 0.5
    want = tc.snn_apply_batched(params, spikes, cfg, tplan(cfg),
                                collect_stats=False)
    for variant in ("fused-handoff", "banked-cuda"):
        got = tc.snn_apply_batched(params, spikes, cfg,
                                   tplan(cfg, variant=variant),
                                   collect_stats=False)
        assert torch.equal(got, want)
    from repro_torch.tune import TuneConfig
    tuned = tplan(cfg, tune="measured", cache_path=tmp_path / "pc.json",
                  tune_config=TuneConfig(device="cpu", warmup=0, iters=1,
                                         batch=1))
    assert torch.equal(tc.snn_apply_batched(params, spikes, cfg, tuned,
                                            collect_stats=False), want)
    with pytest.raises(ValueError, match="must be one of"):
        tplan(cfg, tune="psychic")
    # D = 4*4*8 head inputs: a queue of D covers every nonzero drive entry
    got = tc.snn_apply_batched(params, spikes, cfg, tplan(cfg, fc_capacity=128),
                               collect_stats=False)
    assert torch.equal(got, want)
    state = tc.init_state(params, cfg, tplan(cfg), 1)
    with pytest.raises(TypeError, match="StreamState"):
        tc.snn_step_chunk(params, state, object(), cfg, tplan(cfg))


def test_serve_cli_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "csnn-wide", "--smoke", "--requests", "3",
                       "--device", "cpu", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert out.count("req ") == 3 and "samples/s" in out and "device=cpu" in out
    # the engine modes (JAX's output lines)
    base = ["--smoke", "--device", "cpu", "--requests", "3", "--iters", "1"]
    for flags, mode, line in (
            (["--engine", "--batch-tile", "4"], "engine",
             "engine: batches=1 full=0 deadline=1 padded_slots=1"),
            (["--engine", "--continuous", "--t-chunk", "1"], "continuous",
             "engine: chunks=4 admitted=3 refills=0 slot_utilization="),
            (["--stream"], "stream", "stream: events=")):
        assert serve.main(base + flags) == 0
        out = capsys.readouterr().out
        assert out.count("req ") == 3 and f"mode={mode}," in out, out
        assert line in out, out


def test_fc_head_batched_matches_jax():
    from repro.core.scheduler import run_fc_head_batched as jhead
    from repro_torch.core.scheduler import run_fc_head_batched as thead
    rng = np.random.default_rng(4)
    spikes = rng.random((3, 4, 2, 2, 5)) < 0.4
    w = rng.normal(size=(20, 10)).astype(np.float32)
    b = rng.normal(size=(10,)).astype(np.float32)
    want = jhead(jnp.asarray(spikes), jnp.asarray(w), jnp.asarray(b))
    got = thead(torch.from_numpy(spikes), torch.from_numpy(w),
                torch.from_numpy(b))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **LOGIT_TOL)
    # the sparse head: a truncating queue over tied counts, and a covering
    # one, which equals the dense head
    for cap in (4, 20):
        want = jhead(jnp.asarray(spikes), jnp.asarray(w), jnp.asarray(b),
                     capacity=cap)
        sparse = thead(torch.from_numpy(spikes), torch.from_numpy(w),
                       torch.from_numpy(b), capacity=cap)
        np.testing.assert_allclose(np.asarray(want), sparse.numpy(),
                                   **LOGIT_TOL)
    assert torch.equal(sparse, got)


def test_fc_head_leaves_global_matmul_flags():
    """The head product sums in float64, so it neither reads nor sets the
    process-wide TF32 switch."""
    from repro_torch.core.scheduler import run_fc_head_batched as thead
    rng = np.random.default_rng(5)
    spikes = torch.from_numpy(rng.random((2, 3, 4, 4, 2)) < 0.5)
    w = torch.from_numpy(rng.normal(size=(32, 10)).astype(np.float32))
    b = torch.zeros(10)
    before = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (True, False):
            torch.backends.cuda.matmul.allow_tf32 = flag
            got = thead(spikes, w, b)
            assert torch.backends.cuda.matmul.allow_tf32 is flag
            drive = spikes.reshape(2, 3, -1).sum(1).double()
            assert torch.equal(got, (drive @ w.double()).float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
