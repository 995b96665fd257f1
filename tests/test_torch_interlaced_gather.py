"""The interlaced conv unit over every input channel at once against the
JAX package's per-channel composition.

The port's interlaced wrappers (``event_conv_cuda_interlaced_batched``,
``event_conv_cuda_interlaced``) take coords (C_in, Q, E, 2), valid (C_in,
Q, E) and kernel (C_in, kh, kw, C) and apply channel 0's kept slots
first, then channel 1's, and so on; their plain versions
(``event_conv_ref_interlaced_batched``, ``event_conv_ref_interlaced``) do
the same.  The JAX side is what its scheduler's ``apply_all_cins`` does:
``event_conv_pallas_interlaced_batched`` (or
``event_conv_pallas_interlaced`` for one tile) in interpret mode, once per
input channel in channel order.  Results are compared exactly: float
membranes by value (``np.array_equal``: the Pallas kernel adds +0.0 at
invalid slots, the port adds nothing), int8/int16 bit for bit.  On the
CPU every wrapper runs its plain version; tests/test_torch_gpu.py holds
the CUDA kernel against it on a card.  Each interpret-mode shape compiles
once (~1.5 s), so the cases share shapes where they can.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aeq as jaeq
from repro.core.geometry import ConvGeometry as JGeom
from repro.kernels.event_conv.kernel import (
    event_conv_pallas_interlaced, event_conv_pallas_interlaced_batched)
from repro_torch.configs import csnn_paper as tpaper
from repro_torch.core import csnn as tc
from repro_torch.core import scheduler as ts
from repro_torch.core.plan import plan_network as tplan
from repro_torch.kernels import runtime
from repro_torch.kernels.event_conv.kernel import (
    TILE_LARGE_BYTES, TILE_MAX_BYTES, TILE_MAX_PAR,
    event_conv_cuda_interlaced, event_conv_cuda_interlaced_batched,
    event_conv_cuda_interlaced_tile, tile_path)
from repro_torch.kernels.event_conv.ref import (
    event_conv_ref_batched, event_conv_ref_interlaced,
    event_conv_ref_interlaced_batched)

C_IN, Q, SIDE, C, CAPACITY = 3, 3, 10, 4, 40
# per input channel: the share of the map that fires; the capacity
# truncates the dense channels and leaves invalid slots in the sparse one
DENSITY = (0.6, 0.2, 0.9)


def _values(rng, shape, dtype, kernel=False):
    """Random tiles, or weights large enough that int adds clip mid-queue."""
    if dtype == np.float32:
        return rng.normal(size=shape).astype(dtype)
    if dtype == np.int8:
        return rng.integers(-90 if kernel else -100, 90 if kernel else 100,
                            size=shape).astype(dtype)
    return rng.integers(-20000 if kernel else -30000,
                        20000 if kernel else 30000, size=shape).astype(dtype)


def _queues(rng, k, event_par, capacity=CAPACITY):
    """(C_in, Q, E, 2) coords and (C_in, Q, E) valid bits from JAX's
    ``build_aeq_batched``, as numpy: segment-padded for ``event_par``, or
    (``event_par`` None) unpadded, so groups straddle column boundaries."""
    fm = np.stack([rng.random((Q, SIDE, SIDE)) < DENSITY[ci]
                   for ci in range(C_IN)]).reshape(C_IN * Q, SIDE, SIDE)
    geom = JGeom(k, k)
    jq = jaeq.build_aeq_batched(jnp.asarray(fm), capacity, geometry=geom)
    if event_par is not None:
        jq = jaeq.segment_pad(jq, event_par, geom)
    coords = np.asarray(jq.coords)
    return (coords.reshape(C_IN, Q, -1, 2),
            np.asarray(jq.valid).reshape(C_IN, Q, -1))


def _jax_batched(vm, coords, valid, kern, event_par):
    """JAX's composition: one Pallas call per input channel, in order."""
    out = jnp.asarray(vm)
    for ci in range(coords.shape[0]):
        out = event_conv_pallas_interlaced_batched(
            out, jnp.asarray(coords[ci]), jnp.asarray(valid[ci]),
            jnp.asarray(kern[ci]), block_e=coords.shape[-2],
            event_par=event_par)
    return np.asarray(out)


def _jax_single(vm, coords, valid, kern, event_par):
    out = jnp.asarray(vm)
    for ci in range(coords.shape[0]):
        out = event_conv_pallas_interlaced(
            out, jnp.asarray(coords[ci]), jnp.asarray(valid[ci]),
            jnp.asarray(kern[ci]), block_e=coords.shape[-2],
            event_par=event_par)
    return np.asarray(out)


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _hold(vm, coords, valid, kern, event_par):
    """The plain versions and the wrappers, fresh and in place, against
    JAX's per-channel composition, batched and on tile 1; returns JAX's
    batched result."""
    tvm, tc_, tv, tk = _t(vm, coords, valid, kern)
    want = _jax_batched(vm, coords, valid, kern, event_par)
    np.testing.assert_array_equal(want, event_conv_ref_interlaced_batched(
        tvm, tc_, tv, tk, event_par=event_par).numpy())
    np.testing.assert_array_equal(want, event_conv_cuda_interlaced_batched(
        tvm, tc_, tv, tk, event_par=event_par).numpy())
    out = tvm.clone()
    event_conv_cuda_interlaced_batched(out, tc_, tv, tk, event_par=event_par,
                                       out=out)
    np.testing.assert_array_equal(want, out.numpy())
    want1 = _jax_single(vm[1], coords[:, 1], valid[:, 1], kern, event_par)
    c1, v1 = _t(coords[:, 1], valid[:, 1])
    np.testing.assert_array_equal(want1, event_conv_ref_interlaced(
        tvm[1], c1, v1, tk, event_par=event_par).numpy())
    out = tvm[1].clone()
    event_conv_cuda_interlaced(out, c1, v1, tk, event_par=event_par, out=out)
    np.testing.assert_array_equal(want1, out.numpy())
    return want


# (k, event_par, dtype): every k, every event_par (6 does not divide 32)
# and every dtype, each more than once
CASES = [(3, 8, np.float32), (1, 4, np.int16), (5, 2, np.int8),
         (3, 6, np.int8), (5, 6, np.float32), (1, 8, np.int16)]


@pytest.mark.parametrize("k,event_par,dtype", CASES)
def test_segment_padded_queues_match_pallas_per_channel(k, event_par, dtype):
    """C_in = 3 truncated, segment-padded queues per tile, Q = 3 tiles
    (batched) and one tile (single); on the int datapaths adds clip
    mid-queue, so applying the channels in another order differs."""
    rng = np.random.default_rng(k + 10 * event_par)
    coords, valid = _queues(rng, k, event_par)
    hp = SIDE + 2 * (k // 2)
    vm = _values(rng, (Q, hp, hp, C), dtype)
    kern = _values(rng, (C_IN, k, k, C), dtype, kernel=True)
    want = _hold(vm, coords, valid, kern, event_par)
    if dtype != np.float32:
        sat = np.iinfo(dtype)
        assert (want == sat.max).any() or (want == sat.min).any()
        tvm, tc_, tv, tk = _t(vm, coords, valid, kern)
        flipped = event_conv_ref_interlaced_batched(
            tvm, tc_.flip(0), tv.flip(0), tk.flip(0), event_par=event_par)
        assert not np.array_equal(want, flipped.numpy())


def test_unpadded_queues_mixed_groups():
    """Unpadded interlaced queues (capacity 104, the depth of the k=3,
    event_par=8 segment-padded case, so the interpret-mode kernels are
    reused): groups straddle column boundaries and run in queue order."""
    rng = np.random.default_rng(3)
    coords, valid = _queues(rng, 3, None, capacity=104)
    geom = JGeom(3, 3)
    g = coords.reshape(C_IN, Q, -1, 8, 2)
    cols = np.asarray(geom.column_of(g[..., 0], g[..., 1]))
    v = valid.reshape(C_IN, Q, -1, 8)
    mixed = [(np.unique(c[m]).size > 1) for c, m in
             zip(cols.reshape(-1, 8), v.reshape(-1, 8))]
    assert any(mixed)
    vm = _values(rng, (Q, SIDE + 2, SIDE + 2, C), np.float32)
    kern = _values(rng, (C_IN, 3, 3, C), np.float32, kernel=True)
    _hold(vm, coords, valid, kern, 8)


def _hand_made():
    """C_in = 3 queues on Q = 2 tiles, 12 slots each: repeated coordinates
    in column-homogeneous groups (dropped), in mixed groups (applied every
    time) and behind an invalid first copy (applied), differing per input
    channel."""
    hom = [[4, 4], [4, 4], [7, 4], [4, 7], [1, 1], [1, 1]]
    mix = [[1, 1], [1, 1], [2, 2], [0, 0], [2, 2], [5, 5]]
    late = [[3, 3], [3, 3], [3, 3], [6, 3], [0, 3], [3, 3]]
    coords = np.array([[hom + mix, mix + late], [late + hom, hom + hom],
                       [mix + mix, late + mix]], np.int32)
    valid = np.array([[[1, 1, 1, 1, 0, 1] + [1] * 6,
                       [1, 1, 1, 0, 1, 1] + [0, 1, 1, 1, 1, 1]],
                      [[0, 1, 1, 1, 1, 1] + [1, 1, 0, 1, 1, 1],
                       [1] * 12],
                      [[1, 0, 1, 1, 1, 1] + [1] * 6,
                       [0, 1, 1, 1, 1, 1] + [1, 1, 1, 1, 0, 1]]], bool)
    return coords, valid


@pytest.mark.parametrize("dtype", [np.float32, np.int8])
def test_repeated_coordinates_per_channel(dtype):
    """The hand-made queue set at event_par 4 (batched) and 6 (one tile):
    the Pallas kernels' result, which differs from the sequential replay
    of every valid slot."""
    rng = np.random.default_rng(40 + (dtype == np.int8))
    coords, valid = _hand_made()
    vm = _values(rng, (2, 12, 12, 3), dtype)
    kern = _values(rng, (3, 3, 3, 3), dtype, kernel=True)
    tvm, tc_, tv, tk = _t(vm, coords, valid, kern)
    want = _jax_batched(vm, coords, valid, kern, 4)
    np.testing.assert_array_equal(want, event_conv_cuda_interlaced_batched(
        tvm, tc_, tv, tk, event_par=4).numpy())
    assert not np.array_equal(
        want, event_conv_ref_batched(tvm, tc_, tv, tk).numpy())
    want1 = _jax_single(vm[0], coords[:, 0], valid[:, 0], kern, 6)
    np.testing.assert_array_equal(want1, event_conv_cuda_interlaced(
        tvm[0], tc_[:, 0], tv[:, 0], tk, event_par=6).numpy())
    assert not np.array_equal(
        want1, event_conv_ref_batched(tvm[:1], tc_[:, :1], tv[:, :1],
                                      tk)[0].numpy())


def test_one_input_channel_forms():
    """The forms without the channel axis (coords (Q, E, 2), kernel (kh,
    kw, C)) equal the (1, ...) forms and one Pallas call."""
    rng = np.random.default_rng(50)
    coords, valid = _queues(rng, 3, 8)
    coords, valid = coords[:1], valid[:1]
    vm = _values(rng, (Q, SIDE + 2, SIDE + 2, C), np.int16)
    kern = _values(rng, (1, 3, 3, C), np.int16, kernel=True)
    tvm, tc_, tv, tk = _t(vm, coords, valid, kern)
    want = _jax_batched(vm, coords, valid, kern, 8)
    for got in (event_conv_cuda_interlaced_batched(tvm, tc_[0], tv[0], tk[0],
                                                   event_par=8),
                event_conv_cuda_interlaced_batched(tvm, tc_, tv, tk,
                                                   event_par=8),
                event_conv_ref_interlaced_batched(tvm, tc_[0], tv[0], tk[0],
                                                  event_par=8)):
        np.testing.assert_array_equal(want, got.numpy())
    for got in (event_conv_cuda_interlaced(tvm[0], tc_[0, 0], tv[0, 0], tk[0],
                                           event_par=8),
                event_conv_cuda_interlaced(tvm[0], tc_[:, 0], tv[:, 0], tk,
                                           event_par=8),
                event_conv_ref_interlaced(tvm[0], tc_[0, 0], tv[0, 0], tk[0],
                                          event_par=8)):
        np.testing.assert_array_equal(want[0], got.numpy())


CONV1_TILE = 30 * 30 * 8 * 4  # the offline plan's conv1 tile, float32
CONV2_TILE = 12 * 12 * 5 * 4
# (Q, tile bytes, SMs, event_par, single) -> whether the tile path runs
PATH_RULE = [
    ((66, CONV1_TILE, 132, 8, False), True),      # half a tile per SM
    ((65, CONV1_TILE, 132, 8, False), False),
    ((1024, CONV1_TILE, 132, 8, False), True),
    ((8, CONV1_TILE, 132, 8, False), False),
    ((57, CONV1_TILE, 114, 8, False), True),
    ((56, CONV1_TILE, 114, 8, False), False),
    ((66, TILE_LARGE_BYTES, 132, 8, False), True),
    ((66, TILE_LARGE_BYTES - 1, 132, 8, False), False),
    ((132, CONV2_TILE, 132, 4, False), True),     # a tile per SM
    ((131, CONV2_TILE, 132, 4, False), False),
    ((1024, CONV2_TILE, 132, 4, False), True),
    ((1024, TILE_MAX_BYTES, 132, 8, False), True),
    ((1024, TILE_MAX_BYTES + 1, 132, 8, False), False),    # oversized tile
    ((1024, 30 * 30 * 32 * 4, 132, 8, False), False),
    ((1024, CONV1_TILE, 132, 1, False), False),            # sequential
    ((1024, CONV1_TILE, 132, 2, False), True),
    ((1024, CONV1_TILE, 132, TILE_MAX_PAR, False), True),
    ((1024, CONV1_TILE, 132, TILE_MAX_PAR + 1, False), False),
    ((1024, CONV1_TILE, 132, 8, True), False),             # single entry
    ((1, CONV1_TILE, 132, 1, True), False),
]


@pytest.mark.parametrize("args,tile", PATH_RULE,
                         ids=[f"q{a[0]}-b{a[1]}-sm{a[2]}-p{a[3]}-s{int(a[4])}"
                              for a, _ in PATH_RULE])
def test_tile_path_rule(args, tile):
    """The batched interlaced unit's path is a function of Q, the tile's
    bytes, the card's SM count, event_par and the entry alone: the tile
    path from half a tile per SM on large tiles and one per SM on small
    ones, on tiles that fit its shared memory and groups one thread
    reads; never for the sequential or the single-queue entries."""
    assert tile_path(*args) is tile


def test_tile_entry_on_cpu_is_the_plain_version():
    """The tile path's entry runs the plain version on CPU tensors, equal
    to the Pallas unit per input channel, and launches nothing."""
    rng = np.random.default_rng(51)
    coords, valid = _queues(rng, 3, 8)
    vm = _values(rng, (Q, SIDE + 2, SIDE + 2, C), np.float32)
    kern = _values(rng, (C_IN, 3, 3, C), np.float32, kernel=True)
    tvm, tc_, tv, tk = _t(vm, coords, valid, kern)
    runtime.reset_launches()
    got = event_conv_cuda_interlaced_tile(tvm, tc_, tv, tk, event_par=8)
    np.testing.assert_array_equal(_jax_batched(vm, coords, valid, kern, 8),
                                  got.numpy())
    assert all(v == 0 for v in runtime.LAUNCHES.values())


def test_input_channel_mismatch_raises():
    vm = torch.zeros((2, 10, 10, 4))
    coords = torch.zeros((4, 2, 8, 2), dtype=torch.int32)
    valid = torch.zeros((4, 2, 8), dtype=torch.bool)
    kern = torch.zeros((3, 3, 3, 4))
    with pytest.raises(ValueError, match="input-channel count mismatch"):
        event_conv_cuda_interlaced_batched(vm, coords, valid, kern,
                                           event_par=4)
    with pytest.raises(ValueError, match="input-channel count mismatch"):
        event_conv_cuda_interlaced_batched(vm, coords, valid, kern[0],
                                           event_par=4)  # C_in = 1
    with pytest.raises(ValueError, match="input-channel count mismatch"):
        event_conv_cuda_interlaced(vm[0], coords[:, 0], valid[:, 0], kern,
                                   event_par=4)
    with pytest.raises(ValueError, match="multiple of event_par"):
        event_conv_cuda_interlaced_batched(
            vm, coords[:, :, :6], valid[:, :, :6],
            torch.zeros((4, 3, 3, 4)), event_par=4)
    runtime.reset_launches()
    event_conv_cuda_interlaced_batched(vm, coords, valid,
                                       torch.zeros((4, 3, 3, 4)),
                                       event_par=4, out=vm)  # CPU: no launch
    assert all(v == 0 for v in runtime.LAUNCHES.values())


def test_scheduler_calls_interlaced_unit_once_per_block_and_step(
        monkeypatch):
    """Under an interlaced plan, snn_apply_batched and snn_apply on SMOKE
    call the interlaced unit once per (channel block, time step) of every
    conv layer, each call with every input channel's queues."""
    cfg = tpaper.SMOKE
    plan = tplan(cfg, capacity=64, channel_block=2, event_par=4)
    assert [lp.resolve_variant() for lp in plan.layers] == [
        "interlaced-cuda"] * 2
    calls = {"batched": [], "single": []}

    def counting(name, fn):
        def wrapper(vm, coords, valid, kernel, **kw):
            calls[name].append((coords.shape[0], kernel.shape[0]))
            return fn(vm, coords, valid, kernel, **kw)
        return wrapper

    monkeypatch.setattr(ts, "event_conv_cuda_interlaced_batched", counting(
        "batched", event_conv_cuda_interlaced_batched))
    monkeypatch.setattr(ts, "event_conv_cuda_interlaced", counting(
        "single", event_conv_cuda_interlaced))
    params = tc.init_params(cfg, seed=0, device="cpu")
    h, w = cfg.input_hw
    imgs = torch.from_numpy(np.random.default_rng(0).random(
        (2, h, w, cfg.input_channels)).astype(np.float32))
    spikes = tc.encode_input(imgs, cfg)
    want = [(lp.c_in, lp.c_in) for lp in plan.layers
            for _ in range(cfg.t_steps * (lp.c_out // lp.channel_block))]
    tc.snn_apply_batched(params, spikes, cfg, plan, collect_stats=False)
    assert calls == {"batched": want, "single": []}
    calls["batched"].clear()
    tc.snn_apply(params, spikes[0], cfg, plan, collect_stats=False)
    assert calls == {"batched": [], "single": want}
