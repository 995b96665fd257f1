"""The port's serving engine (``repro_torch.serve.csnn_engine``) on the
CPU: micro-batching flush semantics, continuous slot refill, shutdown
and crash safety.

Weights come from the JAX package through numpy.  Every request's logits
equal the port's ``snn_apply_batched`` on the same unpadded requests
exactly (``torch.equal``), in both modes and with refills; the JAX
package's ``snn_apply_batched`` agrees to ``LOGIT_TOL`` with argmax
equal.  Each serving run is bounded by ``asyncio.wait_for``.

    PYTHONPATH=src python -m pytest -q tests/test_torch_engine.py
"""
import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import csnn_paper as jpaper
from repro.core import csnn as jc
from repro.core.plan import plan_network as jplan
from repro_torch.configs import csnn_paper as tpaper
from repro_torch.convert import params_from_numpy
from repro_torch.core import csnn as tc
from repro_torch.core.plan import plan_network as tplan
from repro_torch.serve.csnn_engine import CSNNEngine, CSNNServeConfig

LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)
TIMEOUT_S = 60.0
CFG = tpaper.SMOKE          # 12x12x1-8C3-8C3-P3-F10, T=4
KNOBS = dict(capacity=64, channel_block=4, batch_tile=4)


def _setup(n=4, seed=0, **serve_kwargs):
    """(numpy params, port params, plan, engine, images (n, 12, 12, 1))."""
    np_params = jax.tree.map(
        np.asarray, jc.init_params(jax.random.PRNGKey(seed), jpaper.SMOKE))
    params = params_from_numpy(np_params, "cpu")
    plan = tplan(CFG, **KNOBS)
    engine = CSNNEngine(params, CFG, plan, CSNNServeConfig(**serve_kwargs))
    imgs = torch.from_numpy(np.random.default_rng(seed)
                            .random((n, 12, 12, 1)).astype(np.float32))
    return np_params, params, plan, engine, imgs


def _direct(params, plan, imgs):
    return tc.snn_apply_batched(params, tc.encode_input(imgs, CFG), CFG, plan,
                                collect_stats=False)


def _serve(engine, imgs):
    """Submit every image inside the engine's context and gather the
    logits, bounded by ``TIMEOUT_S``."""
    async def drive():
        async with engine:
            futs = [engine.submit_nowait(img) for img in imgs]
            return await asyncio.gather(*futs)
    return torch.stack(asyncio.run(asyncio.wait_for(drive(), TIMEOUT_S)))


# ------------------------------------------------------------ micro-batching
def test_microbatch_logits_exact_and_match_jax():
    """3 requests, max_batch 4: one deadline flush padded by one row; the
    logits equal the port's snn_apply_batched on the 3 unpadded images
    exactly (the check the reference engine fails) and JAX's to the
    tolerance."""
    np_params, params, plan, engine, imgs = _setup(
        n=3, max_batch=4, max_delay_ms=20.0)
    got = engine.run_requests(list(imgs), timeout=TIMEOUT_S)
    assert got.shape == (3, 10)
    assert torch.equal(got, _direct(params, plan, imgs))
    jcfg = jpaper.SMOKE
    want = jax.jit(lambda p, x: jc.snn_apply_batched(
        p, jc.encode_input(x, jcfg), jcfg, jplan(jcfg, **KNOBS),
        collect_stats=False))(jax.tree.map(jnp.asarray, np_params),
                              jnp.asarray(imgs.numpy()))
    np.testing.assert_allclose(np.asarray(want), got.numpy(), **LOGIT_TOL)
    np.testing.assert_array_equal(np.asarray(want).argmax(-1),
                                  got.numpy().argmax(-1))
    assert engine.stats["padded_slots"] == 1
    assert engine.stats["batches"] == 1
    assert engine.stats["flushes_deadline"] == 1


def test_size_deadline_and_stop_flushes():
    _, params, plan, engine, imgs = _setup(n=4, max_batch=4)
    assert torch.equal(_serve(engine, imgs), _direct(params, plan, imgs))
    assert engine.stats["flushes_full"] == 1
    assert engine.stats["flushes_deadline"] == 0
    assert engine.stats["padded_slots"] == 0
    # one request, max_batch 8: it comes back after the deadline
    _, _, _, engine, imgs = _setup(n=1, max_batch=8, max_delay_ms=30.0)
    got = _serve(engine, imgs)
    assert got.shape == (1, 10)
    assert engine.stats["flushes_deadline"] == 1
    assert engine.stats["flushes_full"] == 0
    # a partial batch cut by the stop is a stop flush, not a deadline one
    _, params, plan, engine, imgs = _setup(n=2, max_batch=8,
                                           max_delay_ms=10_000.0)

    async def submit_then_stop():
        async with engine:
            return [engine.submit_nowait(img) for img in imgs]

    futs = asyncio.run(asyncio.wait_for(submit_then_stop(), TIMEOUT_S))
    assert torch.equal(torch.stack([f.result() for f in futs]),
                       _direct(params, plan, imgs))
    assert engine.stats["flushes_stop"] == 1
    assert engine.stats["flushes_deadline"] == 0


def test_waves_warmup_and_misuse(tmp_path):
    _, _, plan, engine, imgs = _setup(n=4, max_batch=4)
    compile_s = engine.warmup()
    assert compile_s > 0.0 and engine.stats["compile_s"] == compile_s
    first = engine.run_requests(list(imgs), timeout=TIMEOUT_S)
    second = engine.run_requests(list(imgs), timeout=TIMEOUT_S)
    assert torch.equal(first, second)
    assert engine.stats["batches"] == 2 and engine.stats["requests"] == 8
    with pytest.raises(RuntimeError, match="not running"):
        engine.submit_nowait(imgs[0])
    with pytest.raises(ValueError, match="batch_tile"):
        CSNNEngine(engine._params, CFG, plan, CSNNServeConfig(max_batch=6))
    # tune= plans at construction on the parameters' device (the CPU)
    from repro_torch.tune import measurement_runs
    n0 = measurement_runs()
    tuned = CSNNEngine(engine._params, CFG, tune="measured",
                       cache_path=tmp_path / "plan_cache.json")
    assert measurement_runs() > n0
    assert tuned.plan.batch_tile == tuned.serve_cfg.max_batch
    analytic = tplan(CFG, batch_tile=tuned.serve_cfg.max_batch)
    assert torch.equal(tuned.run_requests(list(imgs), timeout=TIMEOUT_S),
                       _direct(engine._params, analytic, imgs))
    n1 = measurement_runs()
    cached = CSNNEngine(engine._params, CFG, tune="cached",
                        cache_path=tmp_path / "plan_cache.json")
    assert measurement_runs() == n1 and cached.plan == tuned.plan
    with pytest.raises(ValueError, match="must be one of"):
        CSNNEngine(engine._params, CFG, tune="psychic")


def test_default_configs_are_not_shared_and_empty_requests():
    _, params, plan, _, _ = _setup()
    e1, e2 = CSNNEngine(params, CFG, plan), CSNNEngine(params, CFG, plan)
    assert e1.serve_cfg is not e2.serve_cfg
    e1.serve_cfg.max_batch = 64
    assert e2.serve_cfg.max_batch == 8 == CSNNServeConfig().max_batch
    for continuous in (False, True):
        engine = CSNNEngine(params, CFG, plan, CSNNServeConfig(
            max_batch=4, continuous=continuous))
        out = engine.run_requests([], timeout=TIMEOUT_S)
        assert out.shape == (0, 10) and engine.stats["requests"] == 0


# --------------------------------------------------------- continuous refill
def test_continuous_refill_exact():
    """7 requests through 2 slots, one step per chunk: the followers are
    submitted once the first chunk is in flight (the loop yields once per
    chunk), so they join mid-flight as refills and still come back exact;
    the lone first request steps at bucket 1."""
    _, params, plan, engine, imgs = _setup(
        n=7, max_batch=2, continuous=True, slots=2, t_chunk=1)
    engine.warmup()

    async def staggered():
        async with engine:
            first = engine.submit_nowait(imgs[0])
            while engine.stats["chunks"] == 0:  # first chunk in flight
                await asyncio.sleep(0)
            rest = [engine.submit_nowait(imgs[i]) for i in range(1, 7)]
            return await asyncio.gather(first, *rest)

    got = torch.stack(asyncio.run(asyncio.wait_for(staggered(), TIMEOUT_S)))
    assert torch.equal(got, _direct(params, plan, imgs))
    assert engine.stats["refills"] > 0
    assert engine.stats["admitted"] == engine.stats["retired"] == 7


def test_continuous_chunks_buckets_and_utilization():
    _, params, plan, engine, imgs = _setup(
        n=4, max_batch=4, continuous=True, slots=4, t_chunk=2)
    assert engine._buckets == [1, 2, 4]
    assert engine.warmup() > 0.0
    got = _serve(engine, imgs)
    assert torch.equal(got, _direct(params, plan, imgs))
    assert engine.stats["chunks"] == CFG.t_steps // 2
    assert 0.0 < engine.slot_utilization <= 1.0
    # micro-batching and continuous engines agree exactly
    rtc = CSNNEngine(params, CFG, plan, CSNNServeConfig(max_batch=4))
    assert torch.equal(_serve(rtc, imgs), got)


# ------------------------------------------------------ shutdown and crashes
@pytest.mark.parametrize("continuous", [False, True])
def test_submits_racing_aexit_are_served_exactly(continuous):
    _, params, plan, engine, imgs = _setup(
        n=3, max_batch=4, max_delay_ms=500.0, continuous=continuous)

    async def race():
        async with engine:
            return [engine.submit_nowait(imgs[i]) for i in range(3)]

    futs = asyncio.run(asyncio.wait_for(race(), TIMEOUT_S))
    assert all(f.done() and f.exception() is None for f in futs)
    assert torch.equal(torch.stack([f.result() for f in futs]),
                       _direct(params, plan, imgs))


@pytest.mark.parametrize("continuous", [False, True])
def test_concurrent_submits_during_shutdown_never_hang(continuous):
    """Submitters overlapping __aexit__ are served or see the
    engine-stopped error."""
    _, params, plan, engine, imgs = _setup(
        n=4, max_batch=4, max_delay_ms=1.0, continuous=continuous)
    want = _direct(params, plan, imgs)
    results = []

    async def drive():
        async def submitter(i):
            await asyncio.sleep(0.001 * i)
            try:
                results.append((i, await engine.submit(imgs[i])))
            except RuntimeError:
                results.append((i, None))

        async with engine:
            tasks = [asyncio.create_task(submitter(i)) for i in range(4)]
            await asyncio.sleep(0.02)
        await asyncio.gather(*tasks)

    asyncio.run(asyncio.wait_for(drive(), TIMEOUT_S))
    assert len(results) == 4
    for i, got in results:
        assert got is None or torch.equal(got, want[i])


@pytest.mark.parametrize("continuous", [False, True])
def test_bad_request_fails_its_future(continuous):
    """An image of the wrong geometry fails its own future at once; a
    good request submitted beside it is still served."""
    _, params, plan, engine, imgs = _setup(
        n=1, max_batch=4, max_delay_ms=5.0, continuous=continuous)

    async def drive():
        async with engine:
            bad = engine.submit_nowait(torch.zeros((10, 10, 1)))
            good = engine.submit_nowait(imgs[0])
            with pytest.raises(ValueError, match="12, 12, 1"):
                await bad
            return bad, await good

    bad, good = asyncio.run(asyncio.wait_for(drive(), TIMEOUT_S))
    assert bad.done() and isinstance(bad.exception(), ValueError)
    assert torch.equal(good, _direct(params, plan, imgs)[0])


def test_crashed_flusher_fails_inflight_futures():
    """A failure inside the scheduling loop (here: the plan's forward
    raising) fails every in-flight future instead of hanging it, and
    surfaces at the context exit."""
    _, _, _, engine, imgs = _setup(n=2, max_batch=4, max_delay_ms=5.0)

    def broken(images):
        raise RuntimeError("device lost")
    engine._infer = broken

    async def drive():
        futs = []
        with pytest.raises(RuntimeError, match="device lost"):
            async with engine:
                futs = [engine.submit_nowait(img) for img in imgs]
                await asyncio.gather(*futs, return_exceptions=True)
        return futs

    futs = asyncio.run(asyncio.wait_for(drive(), TIMEOUT_S))
    assert len(futs) == 2
    for f in futs:
        assert f.done() and "flusher died" in str(f.exception())
