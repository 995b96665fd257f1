"""The base-mode threshold wrapper (``threshold_pool_cuda_batched``) on CPU
tensors, where it runs its plain version, against interpret-mode
``threshold_pool_pallas`` tile by tile: the conv2 shape, ``fired_out``
passed as ``fired`` itself, and the 32-bit size limit the CUDA kernel's
offsets set.  tests/test_torch_gpu.py holds the kernel itself against
the plain version on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.threshold_pool.kernel import threshold_pool_pallas
from repro_torch.kernels.threshold_pool.kernel import (
    threshold_pool_cuda_batched, threshold_pool_cuda_emit)

DTYPES = [np.float32, np.int16, np.int8]


def _values(rng, shape, dtype, rail):
    """Random values that reach the int rails when ``rail`` is set."""
    if dtype == np.float32:
        return rng.normal(size=shape).astype(dtype)
    lo, hi = np.iinfo(dtype).min, np.iinfo(dtype).max
    if not rail:
        return rng.integers(lo // 3, hi // 3, size=shape).astype(dtype)
    return rng.choice(np.array([lo, lo + 1, -1, 0, 1, hi - 1, hi], dtype),
                      size=shape)


def _pallas(vm, bias, fired, v_t, pool, hh):
    """threshold_pool_pallas on each tile's inner region, padded to the
    pool with cells that never fire; returns (inner vm, spikes, pooled)."""
    q, hp, wp, c = vm.shape
    h, w = hp - 2 * hh, wp - 2 * hh
    p = pool or 1
    hq, wq = -(-h // p) * p, -(-w // p) * p
    neg = -3e38 if vm.dtype == np.float32 else np.iinfo(vm.dtype).min
    outs = []
    for i in range(q):
        pad = np.full((hq, wq, c), neg, vm.dtype)
        pad[:h, :w] = vm[i, hh:hh + h, hh:hh + w]
        fpad = np.zeros((hq, wq, c), np.int8)
        fpad[:h, :w] = fired[i]
        vm_o, sp_o, po_o = threshold_pool_pallas(
            jnp.asarray(pad), jnp.asarray(bias), jnp.asarray(fpad), v_t=v_t,
            pool=pool, block_c=c)
        outs.append((np.asarray(vm_o)[:h, :w], np.asarray(sp_o)[:h, :w] != 0,
                     np.asarray(po_o) != 0))
    return tuple(np.stack(x) for x in zip(*outs))


def _run(rng, dtype, q, h, w, c, pool, alias, rail=False):
    hh = 1
    vm = _values(rng, (q, h + 2, w + 2, c), dtype, rail)
    bias = _values(rng, (c,), dtype, rail)
    fired = rng.random((q, h, w, c)) < 0.2
    v_t = 0.5 if dtype == np.float32 else 20
    want_vm, want_sp, want_po = _pallas(vm, bias, fired, v_t, pool, hh)
    tvm, tfired = torch.from_numpy(vm.copy()), torch.from_numpy(fired.copy())
    spikes, pooled = threshold_pool_cuda_batched(
        tvm, torch.from_numpy(bias), tfired, v_t=v_t, pool=pool,
        halo=(hh, hh), fired_out=tfired if alias else None)
    np.testing.assert_array_equal(want_vm, tvm[:, 1:-1, 1:-1].numpy())
    np.testing.assert_array_equal(want_sp, spikes.numpy())
    if pool is None:
        assert pooled is None
    else:
        np.testing.assert_array_equal(want_po, pooled.numpy())
    # the halo is neither read nor written
    for edge in (np.s_[:, :hh], np.s_[:, -hh:], np.s_[:, :, :hh],
                 np.s_[:, :, -hh:]):
        np.testing.assert_array_equal(vm[edge], tvm[edge].numpy())
    if alias:
        assert spikes.data_ptr() == tfired.data_ptr()
    return tvm


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q", [1, 2])
def test_conv2_shape_matches_pallas(dtype, q):
    """The FULL net's conv2 threshold: 10x10x5 tiles, no pool, halo 1
    (C = 5 takes the CUDA kernel's one-channel path)."""
    rng = np.random.default_rng(100 + 10 * q + DTYPES.index(dtype))
    _run(rng, dtype, q, 10, 10, 5, None, alias=False)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pool", [None, 3])
def test_fired_out_aliasing_fired_matches_pallas(dtype, pool):
    """``fired_out=fired``, as the scheduler never does but the contract
    allows: the latch is read and overwritten in place; int tiles and
    biases on their rails saturate."""
    rng = np.random.default_rng(200 + (pool or 0) + DTYPES.index(dtype))
    tvm = _run(rng, dtype, 2, 8, 8, 4, pool, alias=True, rail=True)
    if dtype != np.float32:
        inner = tvm[:, 1:-1, 1:-1]
        info = np.iinfo(dtype)
        assert (inner == info.max).any() and (inner == info.min).any()


def test_two_pow_31_elements_raise_on_cpu_tensors():
    """The kernels' offsets are 32-bit: both wrappers refuse 2**31 vm
    elements before they look at the device (expanded views, nothing
    allocated)."""
    vm = torch.zeros(1).expand(32768, 258, 258, 1)
    fired = torch.zeros(1, dtype=torch.bool).expand(32768, 256, 256, 1)
    assert vm.numel() >= 2**31
    with pytest.raises(ValueError, match=r"2\*\*31"):
        threshold_pool_cuda_batched(vm, torch.zeros(1), fired, v_t=1.0,
                                    pool=None, halo=(1, 1))
    with pytest.raises(ValueError, match=r"2\*\*31"):
        threshold_pool_cuda_emit(vm, torch.zeros(1), fired, v_t=1.0,
                                 pool=3, halo=(1, 1), emit_capacity=8)
