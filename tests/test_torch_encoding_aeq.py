"""Parity of the port's encoding, queue builders, event replay and
threshold unit with the JAX package (exact, on the CPU).

Inputs are made with numpy from a seed and fed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aeq as jaeq
from repro.core import encoding as jenc
from repro.core import event_conv as jec
from repro.core import threshold as jthr
from repro.core.geometry import ConvGeometry as JGeom
from repro_torch.core import aeq as taeq
from repro_torch.core import encoding as tenc
from repro_torch.core import event_conv as tec
from repro_torch.core import threshold as tthr
from repro_torch.core.geometry import ConvGeometry as TGeom
from repro_torch.core.quantization import saturating_add


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("t_steps", range(2, 17))
def test_thresholds_and_encoding_exact(t_steps):
    _eq(jenc.mttfs_thresholds(t_steps), tenc.mttfs_thresholds(t_steps))
    rng = np.random.default_rng(t_steps)
    frames = rng.random((3, 7, 5)).astype(np.float32)
    # pixels sitting exactly on a threshold must not flip
    thr = np.asarray(jenc.mttfs_thresholds(t_steps))
    frames.reshape(-1)[: len(thr)] = thr
    want = jenc.multi_threshold_encode(jnp.asarray(frames),
                                       jenc.mttfs_thresholds(t_steps), t_steps)
    got = tenc.multi_threshold_encode(torch.from_numpy(frames),
                                      tenc.mttfs_thresholds(t_steps), t_steps)
    _eq(want, got)


def test_encoding_rejects_short_trains():
    with pytest.raises(ValueError, match="at least 2"):
        tenc.mttfs_thresholds(1)


def _queues_equal(jq, tq):
    for f in ("coords", "valid", "count", "seg_offsets", "seg_counts"):
        _eq(getattr(jq, f), getattr(tq, f))


@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("capacity", [7, 40, 200])
def test_build_aeq_batched_and_segment_pad_exact(k, capacity):
    """Truncation (capacity < demand), the -1 coordinates, the capacity
    padding beyond H*W and the segments, at k in {1, 3, 5}."""
    rng = np.random.default_rng(k * 1000 + capacity)
    fm = rng.random((2, 3, 11, 13)) < 0.45
    jq = jaeq.build_aeq_batched(jnp.asarray(fm), capacity, geometry=JGeom(k, k))
    tq = taeq.build_aeq_batched(torch.from_numpy(fm), capacity,
                                geometry=TGeom(k, k))
    _queues_equal(jq, tq)
    assert int(tq.count.max()) > min(capacity, 11 * 13) or capacity == 200
    for par in (2, 8):
        _queues_equal(jaeq.segment_pad(jq, par, JGeom(k, k)),
                      taeq.segment_pad(tq, par, TGeom(k, k)))


def test_raster_queue_and_single_queue_views():
    rng = np.random.default_rng(3)
    fm = rng.random((9, 10)) < 0.3
    jq = jaeq.build_aeq(jnp.asarray(fm), 16, interlaced=False)
    tq = taeq.build_aeq(torch.from_numpy(fm), 16, interlaced=False)
    for f in ("coords", "valid", "count"):
        _eq(getattr(jq, f), getattr(tq, f))
    assert tq.seg_offsets is None
    ji = jaeq.build_aeq(jnp.asarray(fm), 64)
    ti = taeq.build_aeq(torch.from_numpy(fm), 64)
    _queues_equal(ji, ti)
    _queues_equal(jaeq.segment_pad(ji, 4), taeq.segment_pad(ti, 4))
    _eq(jaeq.scatter_aeq(ji, (9, 10)), taeq.scatter_aeq(ti, (9, 10)))
    with pytest.raises(ValueError, match="interlaced queue"):
        taeq.segment_pad(tq, 4)


def test_interlaced_capacity_and_columns():
    for cap in (1, 7, 64, 256):
        for par in (1, 2, 4, 8):
            for nb in (1, 9, 25):
                assert (taeq.interlaced_capacity(cap, par, nb)
                        == jaeq.interlaced_capacity(cap, par, nb))
    ii, jj = np.meshgrid(np.arange(12), np.arange(12), indexing="ij")
    for k in (1, 3, 5):
        _eq(jaeq.column_index(jnp.asarray(ii), jnp.asarray(jj), JGeom(k, k)),
            taeq.column_index(torch.from_numpy(ii), torch.from_numpy(jj),
                              TGeom(k, k)))


def _int_kernel(rng, shape, dtype):
    hi = 90 if dtype == np.int8 else 20000
    return rng.integers(-hi, hi, size=shape).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.int8])
@pytest.mark.parametrize("k", [1, 3, 5])
def test_apply_events_batched_exact(dtype, k):
    """The torch backend's batched event loop (shared early exit, per-event
    saturation) vs JAX's."""
    rng = np.random.default_rng(k)
    h = w = 9
    fm = rng.random((3, h, w)) < 0.5
    jq = jaeq.build_aeq_batched(jnp.asarray(fm), 32, geometry=JGeom(k, k))
    tq = taeq.build_aeq_batched(torch.from_numpy(fm), 32, geometry=TGeom(k, k))
    hp = h + 2 * (k // 2)
    if dtype == np.float32:
        vm = rng.normal(size=(3, hp, hp, 4)).astype(dtype)
        kern = rng.normal(size=(k, k, 4)).astype(dtype)
    else:
        vm = _int_kernel(rng, (3, hp, hp, 4), dtype)
        kern = _int_kernel(rng, (k, k, 4), dtype)
    want = jec.apply_events_batched(jnp.asarray(vm), jq.coords, jq.valid,
                                    jq.count, jnp.asarray(kern), block=8)
    got = tec.apply_events_batched(torch.from_numpy(vm), tq.coords, tq.valid,
                                   tq.count, torch.from_numpy(kern), block=8)
    _eq(want, got)
    one = jec.apply_events(jnp.asarray(vm[0]), jq.queue_at((0,)),
                           jnp.asarray(kern))
    _eq(one, tec.apply_events(torch.from_numpy(vm[0]), tq.queue_at((0,)),
                              torch.from_numpy(kern)))


def test_pad_crop_rotate():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(5, 6, 2)).astype(np.float32)
    g = JGeom(5, 5)
    _eq(jec.pad_vm(jnp.asarray(x), g), tec.pad_vm(torch.from_numpy(x), TGeom(5, 5)))
    p = np.array(jec.pad_vm(jnp.asarray(x), g))
    _eq(jec.crop_vm(jnp.asarray(p), g), tec.crop_vm(torch.from_numpy(p), TGeom(5, 5)))
    _eq(jec.rotate_kernel(jnp.asarray(x)), tec.rotate_kernel(torch.from_numpy(x)))


@pytest.mark.parametrize("sat_bits,dtype", [(None, np.float32), (16, np.int16),
                                            (8, np.int8)])
@pytest.mark.parametrize("pool", [None, 3])
def test_threshold_unit_and_or_pool_exact(sat_bits, dtype, pool):
    rng = np.random.default_rng(7)
    if dtype == np.float32:
        vm = rng.normal(size=(7, 8)).astype(dtype)
        bias, v_t = 0.3, 0.5
    else:
        vm = _int_kernel(rng, (7, 8), dtype)
        bias, v_t = 37.9, 20.0   # truncated toward zero on int datapaths
    fired = rng.random((7, 8)) < 0.2
    want = jthr.threshold_unit(jnp.asarray(vm), bias, v_t, jnp.asarray(fired),
                               pool=pool, sat_bits=sat_bits)
    got = tthr.threshold_unit(torch.from_numpy(vm), bias, v_t,
                              torch.from_numpy(fired), pool=pool,
                              sat_bits=sat_bits)
    for a, b in zip(want, got):
        _eq(a, b)


def test_saturating_add_rails():
    a = np.array([32700, -32700, 5], np.int16)
    b = np.array([100, -100, -3], np.int16)
    from repro.core.quantization import saturating_add as jsat
    _eq(jsat(jnp.asarray(a), jnp.asarray(b), 16),
        saturating_add(torch.from_numpy(a), torch.from_numpy(b), 16))


def test_jax_stays_on_cpu():
    assert jax.default_backend() == "cpu"
