"""The sequential conv unit over every input channel at once against the
JAX package's per-channel composition.

The port's sequential wrappers (``event_conv_cuda_batched``,
``event_conv_cuda``) take coords (C_in, Q, E, 2), valid (C_in, Q, E) and
kernel (C_in, kh, kw, C) and apply channel 0's queues first, then channel
1's, and so on; their plain versions (``event_conv_ref_batched``,
``event_conv_ref``) do the same.  The JAX side is what its scheduler's
``apply_all_cins`` does: ``event_conv_pallas_batched`` (or
``event_conv_pallas`` for one tile) in interpret mode, once per input
channel in channel order.  Results are compared exactly: float membranes
by value (``np.array_equal``: the Pallas kernel adds +0.0 for an invalid
slot, the port adds nothing), int8/int16 bit for bit.  On the CPU every
wrapper runs its plain version; tests/test_torch_gpu.py holds the CUDA
kernel against it on a card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aeq as jaeq
from repro.core.geometry import ConvGeometry as JGeom
from repro.kernels.event_conv.kernel import (event_conv_pallas,
                                             event_conv_pallas_batched)
from repro_torch.kernels import runtime
from repro_torch.kernels.event_conv.kernel import (event_conv_cuda,
                                                   event_conv_cuda_batched)
from repro_torch.kernels.event_conv.ref import (event_conv_ref,
                                                event_conv_ref_batched)

DTYPES = [np.float32, np.int16, np.int8]
# per input channel: the share of the map that fires; the capacity (40)
# truncates the dense channels and leaves invalid slots in the sparse ones
DENSITY = (0.6, 0.2, 0.9, 0.4)


def _values(rng, shape, dtype, kernel=False):
    """Random tiles, or weights large enough that int adds clip mid-queue."""
    if dtype == np.float32:
        return rng.normal(size=shape).astype(dtype)
    if dtype == np.int8:
        return rng.integers(-90 if kernel else -100, 90 if kernel else 100,
                            size=shape).astype(dtype)
    return rng.integers(-20000 if kernel else -30000,
                        20000 if kernel else 30000, size=shape).astype(dtype)


def _queues(rng, c_in, q, h, w, k, capacity=40):
    """(C_in, Q, E, 2) coords and (C_in, Q, E) valid bits from JAX's queue
    builder, as numpy."""
    fm = np.stack([rng.random((q, h, w)) < DENSITY[ci % len(DENSITY)]
                   for ci in range(c_in)])
    jq = jaeq.build_aeq_batched(jnp.asarray(fm), capacity,
                                geometry=JGeom(k, k))
    return np.asarray(jq.coords), np.asarray(jq.valid)


def _jax_batched(vm, coords, valid, kern):
    """JAX's composition: one Pallas call per input channel, in order."""
    out = jnp.asarray(vm)
    for ci in range(coords.shape[0]):
        out = event_conv_pallas_batched(
            out, jnp.asarray(coords[ci]), jnp.asarray(valid[ci]),
            jnp.asarray(kern[ci]), block_e=coords.shape[-2])
    return np.asarray(out)


def _jax_single(vm, coords, valid, kern):
    out = jnp.asarray(vm)
    for ci in range(coords.shape[0]):
        out = event_conv_pallas(out, jnp.asarray(coords[ci]),
                                jnp.asarray(valid[ci]), jnp.asarray(kern[ci]),
                                block_e=coords.shape[-2])
    return np.asarray(out)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 3, 5])
def test_all_input_channels_match_pallas_per_channel(dtype, k):
    """C_in = 4 truncated queues per tile, Q = 3 tiles (batched) and one
    tile (single): the plain versions and the wrappers, fresh and in place,
    equal JAX's per-channel Pallas calls; on the int datapaths adds clip
    mid-queue, so applying the channels in another order differs."""
    rng = np.random.default_rng(k + 10 * DTYPES.index(dtype))
    h, w, c, hh = 9, 10, 4, k // 2
    coords, valid = _queues(rng, 4, 3, h, w, k)
    vm = _values(rng, (3, h + 2 * hh, w + 2 * hh, c), dtype)
    kern = _values(rng, (4, k, k, c), dtype, kernel=True)
    tvm, tc, tv, tk = _t(vm, coords, valid, kern)

    want = _jax_batched(vm, coords, valid, kern)
    np.testing.assert_array_equal(
        want, event_conv_ref_batched(tvm, tc, tv, tk).numpy())
    np.testing.assert_array_equal(
        want, event_conv_cuda_batched(tvm, tc, tv, tk).numpy())
    out = tvm.clone()
    event_conv_cuda_batched(out, tc, tv, tk, out=out)
    np.testing.assert_array_equal(want, out.numpy())

    want1 = _jax_single(vm[1], coords[:, 1], valid[:, 1], kern)
    c1, v1 = _t(coords[:, 1], valid[:, 1])
    np.testing.assert_array_equal(want1, event_conv_ref(tvm[1], c1, v1,
                                                        tk).numpy())
    out = tvm[1].clone()
    event_conv_cuda(out, c1, v1, tk, out=out)
    np.testing.assert_array_equal(want1, out.numpy())

    if dtype != np.float32:
        sat = np.iinfo(dtype)
        assert (want == sat.max).any() or (want == sat.min).any()
        flipped = event_conv_ref_batched(tvm, tc.flip(0), tv.flip(0),
                                         tk.flip(0))
        assert not np.array_equal(want, flipped.numpy())


@pytest.mark.parametrize("dtype", DTYPES)
def test_one_input_channel_and_one_tile(dtype):
    """C_in = 1: the forms without the channel axis (coords (Q, E, 2),
    kernel (kh, kw, C)) and the (1, ...) forms equal one Pallas call; a
    batch of one tile (Q = 1) equals the single-tile call."""
    rng = np.random.default_rng(30 + DTYPES.index(dtype))
    coords, valid = _queues(rng, 1, 1, 8, 8, 3)
    vm = _values(rng, (1, 10, 10, 5), dtype)
    kern = _values(rng, (1, 3, 3, 5), dtype, kernel=True)
    tvm, tc, tv, tk = _t(vm, coords, valid, kern)
    want = _jax_batched(vm, coords, valid, kern)
    np.testing.assert_array_equal(
        want[0], _jax_single(vm[0], coords[:, 0], valid[:, 0], kern))
    for got in (event_conv_cuda_batched(tvm, tc[0], tv[0], tk[0]),
                event_conv_cuda_batched(tvm, tc, tv, tk),
                event_conv_ref_batched(tvm, tc[0], tv[0], tk[0])):
        np.testing.assert_array_equal(want, got.numpy())
    for got in (event_conv_cuda(tvm[0], tc[0, 0], tv[0, 0], tk[0]),
                event_conv_cuda(tvm[0], tc[:, 0], tv[:, 0], tk),
                event_conv_ref(tvm[0], tc[0, 0], tv[0, 0], tk[0])):
        np.testing.assert_array_equal(want[0], got.numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_repeated_coordinates_apply_every_time(dtype):
    """The sequential unit applies a repeated coordinate once per slot, in
    every input channel, as the Pallas calls do."""
    rng = np.random.default_rng(40 + DTYPES.index(dtype))
    coords = np.array([[[[4, 4], [4, 4], [7, 4], [4, 4], [0, 0], [4, 4]]] * 2,
                       [[[4, 5], [4, 4], [4, 5], [4, 5], [9, 9], [0, 0]]] * 2],
                      np.int32)                          # (C_in=2, Q=2, 6, 2)
    valid = np.array([[[1, 1, 1, 0, 1, 1], [1, 1, 1, 1, 0, 1]],
                      [[1, 1, 1, 1, 1, 0], [0, 1, 1, 1, 1, 1]]], bool)
    vm = _values(rng, (2, 12, 12, 3), dtype)
    kern = _values(rng, (2, 3, 3, 3), dtype, kernel=True)
    tvm, tc, tv, tk = _t(vm, coords, valid, kern)
    want = _jax_batched(vm, coords, valid, kern)
    np.testing.assert_array_equal(
        want, event_conv_cuda_batched(tvm, tc, tv, tk).numpy())
    np.testing.assert_array_equal(
        want[1], event_conv_cuda(tvm[1], tc[:, 1], tv[:, 1], tk).numpy())
    once = valid.copy()
    once[0, 0, 1] = False  # (4, 4) of channel 0, queue 0 applied one time less
    assert not np.array_equal(
        want, event_conv_ref_batched(tvm, tc, torch.from_numpy(once),
                                     tk).numpy())


def test_input_channel_mismatch_raises():
    vm = torch.zeros((2, 10, 10, 4))
    coords = torch.zeros((4, 2, 8, 2), dtype=torch.int32)
    valid = torch.zeros((4, 2, 8), dtype=torch.bool)
    kern = torch.zeros((3, 3, 3, 4))
    with pytest.raises(ValueError, match="input-channel count mismatch"):
        event_conv_cuda_batched(vm, coords, valid, kern)
    with pytest.raises(ValueError, match="input-channel count mismatch"):
        event_conv_cuda_batched(vm, coords, valid, kern[0])  # C_in = 1
    with pytest.raises(ValueError, match="input-channel count mismatch"):
        event_conv_cuda(vm[0], coords[:, 0], valid[:, 0], kern)
    with pytest.raises(ValueError, match="valid bits shape"):
        event_conv_cuda_batched(vm, coords, valid[:3], kern[:1].expand(
            4, 3, 3, 4).contiguous())
    with pytest.raises(ValueError, match="queue count mismatch"):
        event_conv_cuda_batched(vm[:1], coords, valid,
                                torch.zeros((4, 3, 3, 4)))
    runtime.reset_launches()
    event_conv_cuda_batched(vm, coords, valid, torch.zeros((4, 3, 3, 4)),
                            out=vm)  # CPU: the plain version, no launch
    assert all(v == 0 for v in runtime.LAUNCHES.values())
