"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain version; the Pallas kernels run in
interpret mode, as the JAX package's own tests run them.  Results are
compared exactly: float membranes by value (``np.array_equal``, so a
+0.0 the Pallas kernel adds for an invalid slot equals a -0.0 left
untouched), int8/int16 bit for bit.  tests/test_torch_gpu.py holds the
CUDA kernels against the plain versions on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aeq as jaeq
from repro.core.geometry import ConvGeometry as JGeom
from repro.kernels.event_conv import ops as jops
from repro.kernels.event_conv.kernel import (
    event_conv_pallas_batched, event_conv_pallas_interlaced_batched)
from repro.kernels.threshold_pool import ops as jthr_ops
from repro.kernels.threshold_pool.kernel import threshold_pool_pallas
from repro_torch.core import aeq as taeq
from repro_torch.core.geometry import ConvGeometry as TGeom
from repro_torch.kernels import runtime
from repro_torch.kernels.event_conv import ops as tops
from repro_torch.kernels.event_conv.kernel import (
    event_conv_cuda_batched, event_conv_cuda_interlaced_batched)
from repro_torch.kernels.event_conv.ref import (event_conv_ref,
                                                event_conv_ref_batched)
from repro_torch.kernels.threshold_pool import ops as tthr_ops
from repro_torch.kernels.threshold_pool.kernel import \
    threshold_pool_cuda_batched

DTYPES = [np.float32, np.int16, np.int8]


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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3, 5])
def test_event_conv_batched_ops_matches_pallas(dtype, k):
    """ops.event_conv_batched (halo pad, segment pad, block padding, crop)
    vs the JAX wrapper over both Pallas kernels: truncated queues with
    invalid slots, saturation reached on the int datapaths."""
    rng = np.random.default_rng(k + 10 * DTYPES.index(dtype))
    h, w, c = 9, 10, 4
    fm = rng.random((3, h, w)) < 0.6
    jq = jaeq.build_aeq_batched(jnp.asarray(fm), 40, geometry=JGeom(k, k))
    tq = taeq.build_aeq_batched(torch.from_numpy(fm), 40, geometry=TGeom(k, k))
    vm = _values(rng, (3, h, w, c), dtype)
    kern = _values(rng, (k, k, c), dtype, kernel=True)
    for event_par in (1, 4):
        want = jops.event_conv_batched(jnp.asarray(vm), jq, jnp.asarray(kern),
                                       block_e=None, event_par=event_par)
        for use_kernel in (True, False):
            got = tops.event_conv_batched(torch.from_numpy(vm), tq,
                                          torch.from_numpy(kern),
                                          block_e=None, event_par=event_par,
                                          use_kernel=use_kernel)
            _eq(want, got)
    if dtype != np.float32:
        sat = np.iinfo(dtype)
        got = got.numpy()
        assert (got == sat.max).any() or (got == sat.min).any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_raw_kernels_match_pallas_on_padded_tiles(dtype):
    """The wrappers the scheduler calls (halo-padded tiles, queue given as
    is) vs event_conv_pallas_batched / _interlaced_batched, including an
    unpadded interlaced queue whose groups straddle column boundaries."""
    rng = np.random.default_rng(5 + DTYPES.index(dtype))
    fm = rng.random((4, 8, 8)) < 0.5
    jq = jaeq.build_aeq_batched(jnp.asarray(fm), 48)
    tq = taeq.build_aeq_batched(torch.from_numpy(fm), 48)
    vm = _values(rng, (4, 10, 10, 3), dtype)
    kern = _values(rng, (3, 3, 3), dtype, kernel=True)
    want = event_conv_pallas_batched(jnp.asarray(vm), jq.coords, jq.valid,
                                     jnp.asarray(kern), block_e=48)
    _eq(want, event_conv_cuda_batched(torch.from_numpy(vm), tq.coords,
                                      tq.valid, torch.from_numpy(kern)))
    _eq(np.asarray(want)[1], event_conv_ref(
        torch.from_numpy(vm[1]), tq.coords[1], tq.valid[1],
        torch.from_numpy(kern)))
    for q_j, q_t in ((jq, tq), (jaeq.segment_pad(jq, 4), taeq.segment_pad(tq, 4))):
        want = event_conv_pallas_interlaced_batched(
            jnp.asarray(vm), q_j.coords, q_j.valid, jnp.asarray(kern),
            block_e=q_j.coords.shape[1], event_par=4)
        _eq(want, event_conv_cuda_interlaced_batched(
            torch.from_numpy(vm), q_t.coords, q_t.valid,
            torch.from_numpy(kern), event_par=4))


def test_interlaced_repeated_coordinates_land_once():
    """A column-homogeneous group applies a repeated coordinate once (the
    Pallas gather->add->scatter), a mixed group applies it every time."""
    coords = np.array([[[4, 4], [4, 4], [7, 4], [4, 4],     # homogeneous
                        [1, 1], [1, 1], [2, 2], [0, 0]]],   # mixed
                      np.int32)
    valid = np.array([[1, 1, 1, 0, 1, 1, 1, 0]], bool)
    vm = np.zeros((1, 10, 10, 2), np.float32)
    kern = np.arange(18, dtype=np.float32).reshape(3, 3, 2)
    want = event_conv_pallas_interlaced_batched(
        jnp.asarray(vm), jnp.asarray(coords), jnp.asarray(valid),
        jnp.asarray(kern), block_e=8, event_par=4)
    got = event_conv_cuda_interlaced_batched(
        torch.from_numpy(vm), torch.from_numpy(coords),
        torch.from_numpy(valid), torch.from_numpy(kern), event_par=4)
    _eq(want, got)
    seq = event_conv_ref_batched(torch.from_numpy(vm), torch.from_numpy(coords),
                                 torch.from_numpy(valid), torch.from_numpy(kern))
    assert not torch.equal(seq, got)  # the sequential replay adds (4,4) twice


def test_event_conv_validation_errors():
    vm = torch.zeros((2, 6, 6, 4))
    coords = torch.zeros((2, 8, 2), dtype=torch.int32)
    valid = torch.zeros((2, 8), dtype=torch.bool)
    kern = torch.zeros((3, 3, 4))
    with pytest.raises(ValueError, match="queue count mismatch"):
        event_conv_cuda_batched(torch.zeros((3, 6, 6, 4)), coords, valid, kern)
    with pytest.raises(ValueError, match="valid bits shape"):
        event_conv_cuda_batched(vm, coords, valid[:, :4], kern)
    with pytest.raises(ValueError, match="must match vm dtype"):
        event_conv_cuda_batched(vm, coords, valid, kern.to(torch.int8))
    with pytest.raises(ValueError, match="int32"):
        event_conv_cuda_batched(vm, coords.long(), valid, kern)
    with pytest.raises(ValueError, match="multiple of event_par"):
        event_conv_cuda_interlaced_batched(vm, coords[:, :6], valid[:, :6],
                                           kern, event_par=4)
    with pytest.raises(ValueError, match=">= 2 events"):
        event_conv_cuda_interlaced_batched(vm, coords, valid, kern,
                                           event_par=1)
    q = taeq.build_aeq_batched(torch.zeros((2, 4, 4), dtype=torch.bool), 8)
    with pytest.raises(ValueError, match="multiple of event_par"):
        tops.event_conv_batched(torch.zeros((2, 4, 4, 4)), q, kern,
                                block_e=6, event_par=4)
    with pytest.raises(ValueError, match="one leading"):
        tops.event_conv_batched(torch.zeros((2, 4, 4, 4)),
                                taeq.BatchedEventQueue(*(x[None] for x in q)),
                                kern)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pool,h,w", [(None, 9, 9), (3, 9, 9), (3, 7, 8)])
def test_threshold_pool_matches_pallas(dtype, pool, h, w):
    """ops.threshold_pool (the _NEG padding, the crop) vs the JAX wrapper
    over threshold_pool_pallas; non-dividing H, W included."""
    rng = np.random.default_rng(h * w + DTYPES.index(dtype))
    c = 5
    vm = _values(rng, (h, w, c), dtype)
    bias = _values(rng, (c,), dtype, kernel=True)
    fired = rng.random((h, w, c)) < 0.1
    v_t = 0.5 if dtype == np.float32 else 20
    want = jthr_ops.threshold_pool(jnp.asarray(vm), jnp.asarray(bias),
                                   jnp.asarray(fired), v_t=v_t, pool=pool,
                                   block_c=c)
    for use_kernel in (True, False):
        got = tthr_ops.threshold_pool(torch.from_numpy(vm),
                                      torch.from_numpy(bias),
                                      torch.from_numpy(fired), v_t=v_t,
                                      pool=pool, use_kernel=use_kernel)
        for a, b in zip(want, got):
            _eq(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3, 5])
def test_threshold_kernel_on_halo_tiles_matches_pallas(dtype, k):
    """The scheduler's call: halo-padded tiles updated in place, ragged
    pool edge, vs threshold_pool_pallas per tile (padded to the pool)."""
    rng = np.random.default_rng(k * 3 + DTYPES.index(dtype))
    h = w = 8
    hh = k // 2
    vm = _values(rng, (2, h + 2 * hh, w + 2 * hh, 4), dtype)
    bias = _values(rng, (4,), dtype, kernel=True)
    fired = rng.random((2, h, w, 4)) < 0.2
    v_t = 0.5 if dtype == np.float32 else 20
    tvm = torch.from_numpy(vm.copy())
    spikes, pooled = threshold_pool_cuda_batched(
        tvm, torch.from_numpy(bias), torch.from_numpy(fired), v_t=v_t,
        pool=3, halo=(hh, hh))
    for q in range(2):
        inner = vm[q, hh:hh + h, hh:hh + w]
        neg = -3e38 if dtype == np.float32 else np.iinfo(dtype).min
        pad = np.full((9, 9, 4), neg, dtype)
        pad[:h, :w] = inner
        fpad = np.zeros((9, 9, 4), np.int8)
        fpad[:h, :w] = fired[q]
        vm_o, sp_o, po_o = threshold_pool_pallas(
            jnp.asarray(pad), jnp.asarray(bias), jnp.asarray(fpad), v_t=v_t,
            pool=3, block_c=4)
        _eq(np.asarray(vm_o)[:h, :w], tvm[q, hh:hh + h, hh:hh + w])
        _eq(np.asarray(sp_o)[:h, :w] != 0, spikes[q])
        _eq(np.asarray(po_o)[:3, :3] != 0, pooled[q])
    # the halo is neither read nor written
    _eq(vm[:, :hh], tvm[:, :hh])


def test_threshold_validation_errors():
    vm = torch.zeros((2, 6, 6, 4))
    fired = torch.zeros((2, 4, 4, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="bias must be"):
        threshold_pool_cuda_batched(vm, torch.zeros(3), fired, v_t=1.0,
                                    pool=None, halo=(1, 1))
    with pytest.raises(ValueError, match="fired must be"):
        threshold_pool_cuda_batched(vm, torch.zeros(4), fired[:, :3],
                                    v_t=1.0, pool=None, halo=(1, 1))
    with pytest.raises(ValueError, match="pool must be"):
        threshold_pool_cuda_batched(vm, torch.zeros(4), fired, v_t=1.0,
                                    pool=0, halo=(1, 1))
    with pytest.raises(ValueError, match="unsupported vm dtype"):
        tthr_ops.threshold_pool(torch.zeros((4, 4, 2), dtype=torch.float64),
                                torch.zeros(2), torch.zeros((4, 4, 2)),
                                v_t=1.0)
    with pytest.raises(ValueError, match="bias must have shape"):
        tthr_ops.threshold_pool(torch.zeros((4, 4, 2)), torch.zeros(3),
                                torch.zeros((4, 4, 2)), v_t=1.0)
    with pytest.raises(ValueError, match="fired shape"):
        tthr_ops.threshold_pool(torch.zeros((4, 4, 2)), torch.zeros(2),
                                torch.zeros((4, 3, 2)), v_t=1.0)


def test_cpu_tensors_never_launch():
    runtime.reset_launches()
    vm = torch.zeros((1, 5, 5, 2))
    q = taeq.build_aeq_batched(torch.ones((1, 3, 3), dtype=torch.bool), 9)
    event_conv_cuda_batched(vm, q.coords, q.valid, torch.ones((3, 3, 2)))
    threshold_pool_cuda_batched(vm, torch.zeros(2),
                                torch.zeros((1, 3, 3, 2), dtype=torch.bool),
                                v_t=1.0, pool=None, halo=(1, 1))
    assert all(v == 0 for v in runtime.LAUNCHES.values())
    with pytest.raises(ValueError, match="one CUDA device or all"):
        runtime.use_kernel(vm, torch.zeros(1, device="meta"))
