"""The CUDA kernels against their plain versions on a card (marker
``gpu``; each test skips without a CUDA device).  No JAX here, so the
file also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.core import aeq as taeq
from repro_torch.core.event_conv import tap_matrix
from repro_torch.core.geometry import ConvGeometry
from repro_torch.kernels import runtime
from repro_torch.kernels.aeq_build.kernel import aeq_build_cuda
from repro_torch.kernels.aeq_build.ref import aeq_build_ref
from repro_torch.kernels.event_conv.kernel import (
    event_conv_cuda, event_conv_cuda_banked, event_conv_cuda_batched,
    event_conv_cuda_interlaced, event_conv_cuda_interlaced_batched, sm_count,
    tile_min_q)
from repro_torch.kernels.event_conv.ref import (
    event_conv_ref, event_conv_ref_banked, event_conv_ref_batched,
    event_conv_ref_interlaced, event_conv_ref_interlaced_batched)
from repro_torch.kernels.threshold_pool.kernel import (
    threshold_pool_cuda_batched, threshold_pool_cuda_emit)
from repro_torch.kernels.threshold_pool.ref import threshold_pool_tile_ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode; "
                    "python3 chip_smoke.py runs them on the card)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.int8])
def test_cuda_kernels_equal_plain_versions(cuda, dtype):
    g = torch.Generator().manual_seed(0)
    fm = torch.rand((8, 28, 28), generator=g) < 0.6
    q = taeq.build_aeq_batched(fm.to(cuda), 256)
    qp = taeq.segment_pad(q, 8)
    vm = (torch.randn((8, 30, 30, 8), generator=g) * 50).to(dtype).to(cuda)
    kern = (torch.randn((3, 3, 8), generator=g) * 40).to(dtype).to(cuda)
    got = event_conv_cuda_batched(vm, q.coords, q.valid, kern)
    assert torch.equal(got, event_conv_ref_batched(vm, q.coords, q.valid, kern))
    got = event_conv_cuda_interlaced_batched(vm, qp.coords, qp.valid, kern,
                                             event_par=8)
    assert torch.equal(got, event_conv_ref_interlaced_batched(
        vm, qp.coords, qp.valid, kern, event_par=8))
    # the interlaced unit over 32 input channels at the conv1 shape, at the
    # serve plan's event_par and at one that does not divide a warp, fresh
    # and in place
    fm32 = torch.rand((32 * 8, 28, 28), generator=g) < 0.45
    q32 = taeq.build_aeq_batched(fm32.to(cuda), 256)
    kern32 = (torch.randn((32, 3, 3, 8), generator=g) * 40).to(dtype).to(cuda)
    for ep in (8, 6):
        qp32 = taeq.segment_pad(q32, ep)
        coords = qp32.coords.reshape(32, 8, -1, 2)
        valid = qp32.valid.reshape(32, 8, -1)
        want = event_conv_ref_interlaced_batched(vm, coords, valid, kern32,
                                                 event_par=ep)
        assert torch.equal(event_conv_cuda_interlaced_batched(
            vm, coords, valid, kern32, event_par=ep), want)
        got = vm.clone()
        event_conv_cuda_interlaced_batched(got, coords, valid, kern32,
                                           event_par=ep, out=got)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    fired = (torch.rand((8, 28, 28, 8), generator=g) < 0.1).to(cuda)
    a, b = vm.clone(), vm.clone()
    sa, pa = threshold_pool_cuda_batched(a, kern[0, 0], fired, v_t=1.0,
                                         pool=3, halo=(1, 1))
    sb, pb = threshold_pool_tile_ref(b, kern[0, 0], fired, v_t=1.0, pool=3,
                                     halo=(1, 1))
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(sa, sb) and torch.equal(pa, pb)


#: the offline benchmark plan's conv layers: (C_in, map side, tile
#: channels, capacity, event_par, input events per slot)
OFFLINE_CONVS = {"conv0": (1, 28, 8, 784, 8, 0.28),
                 "conv1": (32, 28, 8, 784, 8, 0.16),
                 "conv2": (32, 10, 5, 100, 4, 0.27)}


def _offline_case(g, cuda, layer, q, dtype, *, pad=True):
    """vm (Q, side+2, side+2, C), coords (C_in, Q, E, 2), valid (C_in, Q,
    E) and kernel (C_in, 3, 3, C) of one offline conv layer on random
    maps; int weights large enough to clip mid-queue."""
    c_in, side, c, cap, ep, density = OFFLINE_CONVS[layer]
    fm = torch.rand((c_in * q, side, side), generator=g) < density
    qs = taeq.build_aeq_batched(fm.to(cuda), cap)
    if pad:
        qs = taeq.segment_pad(qs, ep)
    scale = {torch.float32: 1.0, torch.int16: 9000.0, torch.int8: 40.0}[dtype]
    vm = (torch.randn((q, side + 2, side + 2, c), generator=g)
          * scale).to(dtype).to(cuda)
    kern = (torch.randn((c_in, 3, 3, c), generator=g)
            * scale).to(dtype).to(cuda)
    return (vm, qs.coords.reshape(c_in, q, -1, 2).contiguous(),
            qs.valid.reshape(c_in, q, -1).contiguous(), kern, ep)


def _tile_launches(fn):
    """(tile path, all batched interlaced) launches of ``fn``."""
    runtime.reset_launches()
    fn()
    torch.cuda.synchronize()
    return (runtime.LAUNCHES["event_conv_interlaced_tile"],
            runtime.LAUNCHES["event_conv_interlaced"])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.int8])
def test_interlaced_tile_path_equals_plain_version(cuda, dtype):
    """The batched interlaced unit at the offline plan's shapes (conv0,
    conv1, conv2: capacities 784/784/100, event_par 8/8/4, 30x30x8,
    30x30x8 and 12x12x5 tiles) at the smallest Q the rule sends to the
    tile path (``tile_min_q``): segment-padded and unpadded (mixed-group) queues and
    repeated coordinates, fresh and in place, each launch on the tile
    path and equal to the plain version."""
    g = torch.Generator().manual_seed(28)
    size = torch.empty((), dtype=dtype).element_size()
    for layer, (_, side, c, *_) in OFFLINE_CONVS.items():
        q = tile_min_q((side + 2) ** 2 * c * size, sm_count(cuda))
        for pad in (True, False):
            vm, coords, valid, kern, ep = _offline_case(g, cuda, layer, q,
                                                        dtype, pad=pad)
            want = event_conv_ref_interlaced_batched(vm, coords, valid, kern,
                                                     event_par=ep)
            fresh, inplace = torch.empty_like(vm), vm.clone()
            assert _tile_launches(lambda: (
                event_conv_cuda_interlaced_batched(
                    vm, coords, valid, kern, event_par=ep, out=fresh),
                event_conv_cuda_interlaced_batched(
                    inplace, coords, valid, kern, event_par=ep,
                    out=inplace))) == (2, 2)
            assert torch.equal(fresh, want), (layer, pad)
            assert torch.equal(inplace, want), (layer, pad)
    # repeated coordinates: in homogeneous groups (dropped), in mixed
    # groups (applied every time), behind an invalid first copy
    hom = [[4, 4], [4, 4], [7, 4], [4, 7], [1, 1], [1, 1], [7, 7], [7, 7]]
    mix = [[1, 1], [1, 1], [2, 2], [0, 0], [2, 2], [5, 5], [1, 1], [8, 8]]
    late = [[3, 3], [3, 3], [3, 3], [6, 3], [0, 3], [3, 3], [9, 3], [3, 3]]
    rows = torch.tensor([hom + mix + late, late + hom + mix],
                        dtype=torch.int32)
    q = tile_min_q(12 * 12 * 8 * size, sm_count(cuda))
    coords = rows[:, None].expand(2, q, 24, 2).contiguous().to(cuda)
    valid = (torch.rand((2, q, 24), generator=g) < 0.8).to(cuda)
    vm = (torch.randn((q, 12, 12, 8), generator=g) * 50).to(dtype).to(cuda)
    kern = (torch.randn((2, 3, 3, 8), generator=g) * 40).to(dtype).to(cuda)
    for ep in (4, 8):
        want = event_conv_ref_interlaced_batched(vm, coords, valid, kern,
                                                 event_par=ep)
        got = vm.clone()
        assert _tile_launches(lambda: event_conv_cuda_interlaced_batched(
            got, coords, valid, kern, event_par=ep, out=got)) == (1, 1)
        assert torch.equal(got, want), ep


@pytest.mark.gpu
def test_interlaced_path_follows_the_rule(cuda):
    """Just below the crossover the batched interlaced unit takes the
    patch gather, at it the tile path; the sequential unit and the
    single-queue units never take the tile path."""
    g = torch.Generator().manual_seed(5)
    q_hi = tile_min_q(30 * 30 * 8 * 4, sm_count(cuda))
    for q, tile in ((q_hi - 1, 0), (q_hi, 1)):
        vm, coords, valid, kern, ep = _offline_case(g, cuda, "conv1", q,
                                                    torch.float32)
        want = event_conv_ref_interlaced_batched(vm, coords, valid, kern,
                                                 event_par=ep)
        assert _tile_launches(lambda: event_conv_cuda_interlaced_batched(
            vm, coords, valid, kern, event_par=ep, out=vm)) == (tile, 1)
        assert torch.equal(vm, want), q
    runtime.reset_launches()
    vm, coords, valid, kern, ep = _offline_case(g, cuda, "conv1", q_hi,
                                                torch.float32)
    event_conv_cuda_batched(vm, coords, valid, kern, out=vm)
    event_conv_cuda_interlaced(vm[0], coords[:, 0].contiguous(),
                               valid[:, 0].contiguous(), kern, event_par=ep,
                               out=vm[0])
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["event_conv_interlaced_tile"] == 0
    assert (runtime.LAUNCHES["event_conv_seq"],
            runtime.LAUNCHES["event_conv_interlaced_single"]) == (1, 1)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.int8])
def test_threshold_base_kernel_equals_plain_version(cuda, dtype, k):
    """threshold_pool_batched at the FULL forward's three shapes (conv0
    28x28x8, conv1 28x28x8 with the ragged pool 3, conv2 10x10x5: the
    four-channel and the one-channel path) for B=8 and one sample; tiles,
    biases and latches at odd offsets (the one-channel path on C=8);
    ``fired_out`` = ``fired``; int tiles and biases on their rails.  vm
    (the untouched halo included), spikes and pooled equal the plain
    version exactly, and each call is one counted launch."""
    g = torch.Generator().manual_seed(k)
    hh = k // 2
    v_t = 0.5 if dtype == torch.float32 else 20

    def values(shape, rail):
        if dtype == torch.float32:
            return torch.randn(shape, generator=g).to(cuda)
        info = torch.iinfo(dtype)
        if not rail:
            return torch.randint(info.min // 3, info.max // 3, shape,
                                 generator=g).to(dtype).to(cuda)
        vals = torch.tensor([info.min, info.min + 1, -1, 0, 1, info.max - 1,
                             info.max], dtype=dtype)
        return vals[torch.randint(0, 7, shape, generator=g)].to(cuda)

    def at_offset(t, off):
        store = torch.empty(t.numel() + off, dtype=t.dtype, device=cuda)
        return store[off:].view(t.shape).copy_(t)

    launches = 0
    for q in (8, 1):
        for side, c, pool in ((28, 8, None), (28, 8, 3), (10, 5, None)):
            for off, alias, rail in ((0, False, False), (1, False, False),
                                     (3, True, False), (0, True, True)):
                vm = values((q, side + 2 * hh, side + 2 * hh, c), rail)
                bias = values((c,), rail)
                fired = (torch.rand((q, side, side, c), generator=g)
                         < 0.1).to(cuda)
                want_vm = vm.clone()
                want = threshold_pool_tile_ref(want_vm, bias, fired.clone(),
                                               v_t=v_t, pool=pool,
                                               halo=(hh, hh))
                vm_k, b_k, f_k = (at_offset(t, off) if off else t.clone()
                                  for t in (vm, bias, fired))
                runtime.reset_launches()
                got = threshold_pool_cuda_batched(
                    vm_k, b_k, f_k, v_t=v_t, pool=pool, halo=(hh, hh),
                    fired_out=f_k if alias else None)
                launches += runtime.LAUNCHES["threshold_pool"]
                torch.cuda.synchronize()
                assert torch.equal(vm_k, want_vm)
                assert torch.equal(got[0], want[0])
                assert (got[1] is None) == (pool is None)
                if pool is not None:
                    assert torch.equal(got[1], want[1])
                if alias:
                    assert got[0].data_ptr() == f_k.data_ptr()
                if rail and dtype != torch.float32:
                    inner = vm_k[:, hh:hh + side, hh:hh + side]
                    info = torch.iinfo(dtype)
                    assert (inner == info.max).any()
                    assert (inner == info.min).any()
    assert launches == 2 * 3 * 4


@pytest.mark.gpu
def test_launch_counters_count_kernel_launches_only(cuda):
    runtime.reset_launches()
    vm = torch.zeros((2, 10, 10, 4), device=cuda)
    q = taeq.build_aeq_batched(torch.ones((2, 8, 8), dtype=torch.bool,
                                          device=cuda), 64)
    kern = torch.ones((3, 3, 4), device=cuda)
    # three input channels' queues: one launch per call
    q3 = taeq.build_aeq_batched(torch.ones((3, 2, 8, 8), dtype=torch.bool,
                                           device=cuda), 64)
    kern3 = torch.ones((3, 3, 3, 4), device=cuda)
    event_conv_ref_batched(vm, q3.coords, q3.valid, kern3)
    event_conv_cuda_batched(vm, q3.coords, q3.valid, kern3, out=vm)
    assert runtime.LAUNCHES == {"event_conv_seq": 1,
                                "event_conv_interlaced": 0,
                                "event_conv_banked": 0,
                                "threshold_pool": 0,
                                "threshold_pool_emit": 0,
                                "event_conv_seq_single": 0,
                                "event_conv_interlaced_single": 0,
                                "event_conv_interlaced_tile": 0,
                                "aeq_build": 0}
    # the banked conv and the emit kernel count only their own launches
    ho = taeq.build_fused_handoff(torch.ones((2, 1, 8, 8, 3), dtype=torch.bool,
                                             device=cuda), 64)
    taps = tap_matrix(torch.ones((3, 3, 3, 4), device=cuda)).permute(
        2, 0, 1, 3).contiguous()
    event_conv_ref_banked(vm, ho.masks[0], taps, ConvGeometry())
    event_conv_cuda_banked(vm, ho.masks[0], taps, geometry=ConvGeometry(),
                           out=vm)
    fired = torch.zeros((2, 8, 8, 4), dtype=torch.bool, device=cuda)
    threshold_pool_tile_ref(vm.clone(), kern[0, 0], fired, v_t=1.0, pool=None,
                            halo=(1, 1), emit_capacity=16)
    threshold_pool_cuda_emit(vm, kern[0, 0], fired, v_t=1.0, pool=None,
                             halo=(1, 1), emit_capacity=16)
    assert runtime.LAUNCHES == {"event_conv_seq": 1,
                                "event_conv_interlaced": 0,
                                "event_conv_banked": 1,
                                "threshold_pool": 0,
                                "threshold_pool_emit": 1,
                                "event_conv_seq_single": 0,
                                "event_conv_interlaced_single": 0,
                                "event_conv_interlaced_tile": 0,
                                "aeq_build": 0}
    # the single-queue units count only their own launches
    qp = taeq.segment_pad(q, 4)
    event_conv_ref(vm[0], q3.coords[:, 0], q3.valid[:, 0], kern3)
    event_conv_cuda(vm[0], q3.coords[:, 0].contiguous(),
                    q3.valid[:, 0].contiguous(), kern3, out=vm[0])
    event_conv_ref_interlaced(vm[1], qp.coords[1], qp.valid[1], kern,
                              event_par=4)
    event_conv_cuda_interlaced(vm[1], qp.coords[1], qp.valid[1], kern,
                               event_par=4, out=vm[1])
    assert (runtime.LAUNCHES["event_conv_seq_single"],
            runtime.LAUNCHES["event_conv_interlaced_single"],
            runtime.LAUNCHES["event_conv_seq"]) == (1, 1, 1)
    # the event-set builder counts its own launches, not its plain version
    spikes = torch.ones((2, 1, 8, 8, 3), dtype=torch.bool, device=cuda)
    aeq_build_ref(spikes, 64, 4)
    aeq_build_cuda(spikes, 64, 4)
    assert runtime.LAUNCHES["aeq_build"] == 1
    assert sum(runtime.LAUNCHES.values()) == 6


#: the cells' queue layers (H, W, C_in, input density): the paper net's
#: 28x28 with 1 and 32 channels and 10x10x32, VGG-16's 32x32x3 to 2x2x512
BUILDER_SHAPES = [(28, 28, 1, 0.28), (28, 28, 32, 0.16), (10, 10, 32, 0.27),
                  (32, 32, 3, 0.59), (32, 32, 64, 0.05), (16, 16, 128, 0.06),
                  (8, 8, 256, 0.03), (4, 4, 512, 0.02), (2, 2, 512, 0.05)]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["random", "empty", "full", "view"])
@pytest.mark.parametrize("truncate", [False, True],
                         ids=["cap=hw", "cap<demand"])
@pytest.mark.parametrize("event_par", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", BUILDER_SHAPES,
                         ids=lambda s: "x".join(map(str, s[:3])))
def test_aeq_build_kernel_equals_plain_composition(cuda, shape, event_par,
                                                   truncate, kind):
    """The builder kernel equals ``build_aeq_batched`` + ``segment_pad`` +
    the permutes (its plain version, run on the card) in every element of
    coords, valid and count; one counted launch."""
    h, w, c, density = shape
    g = torch.Generator().manual_seed(h * 7 + c + event_par)
    b, t = 4, 2
    if kind == "empty":
        spikes = torch.zeros((b, t, h, w, c), dtype=torch.bool, device=cuda)
    elif kind == "full":
        spikes = torch.ones((b, t, h, w, c), dtype=torch.bool, device=cuda)
    elif kind == "view":  # (t, C, B, H, W + 2) storage, sliced and permuted
        base = (torch.rand((t, c, b, h, w + 2), generator=g) < density)
        spikes = base.to(cuda)[..., 1:w + 1].permute(2, 0, 3, 4, 1)
    else:
        spikes = (torch.rand((b, t, h, w, c), generator=g) < density).to(cuda)
    capacity = max(1, int(density * h * w) // 2) if truncate else h * w
    runtime.reset_launches()
    got = aeq_build_cuda(spikes, capacity, event_par)
    want = aeq_build_ref(spikes, capacity, event_par)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["aeq_build"] == 1
    for a, b_ in zip(got, want):
        assert a.shape == b_.shape and a.dtype == b_.dtype
        assert torch.equal(a, b_)


@pytest.mark.gpu
@pytest.mark.parametrize("net", ["paper", "vgg16"])
def test_snn_apply_batched_on_card_equals_cpu(cuda, net):
    """The queue variants' forward (every queue built by the builder
    kernel) on the card equals the CPU plain path: the paper net under the
    offline plan and VGG-16's SMOKE under its event_par, spikes and counts
    exact, logits within the head's float64 summation order."""
    from repro_torch.configs import csnn_paper, csnn_vgg16
    from repro_torch.core.csnn import (ConvSpec, encode_input, init_params,
                                       snn_apply_batched)
    from repro_torch.core.plan import plan_network
    if net == "paper":
        cfg = csnn_paper.FULL
        plan = plan_network(cfg, capacity=[784, 784, 100],
                            channel_block=[8, 8, 5], event_par=[8, 8, 4],
                            batch_tile=8)
        n_queue_layers = 3
    else:
        cfg = csnn_vgg16.SMOKE
        convs = [s for s in cfg.layers if isinstance(s, ConvSpec)]
        plan = plan_network(cfg, capacity=[1024] * 2 + [256] * 2 + [64] * 3
                            + [16] * 3 + [4] * 3,
                            channel_block=[max(1, s.channels // 4)
                                           for s in convs],
                            event_par=csnn_vgg16.PLAN["event_par"])
        n_queue_layers = 13
    params = init_params(cfg, seed=5, device="cpu")
    h, w = cfg.input_hw
    imgs = torch.rand((8, h, w, cfg.input_channels),
                      generator=torch.Generator().manual_seed(6))
    spikes = encode_input(imgs, cfg)
    runtime.reset_launches()
    got, gstats = snn_apply_batched(
        {k: {n: t.to(cuda) for n, t in v.items()} for k, v in params.items()},
        spikes.to(cuda), cfg, plan)
    torch.cuda.synchronize()
    assert runtime.LAUNCHES["aeq_build"] == n_queue_layers
    want, wstats = snn_apply_batched(params, spikes, cfg, plan)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got.argmax(-1).cpu(), want.argmax(-1))
    for a, b in zip(gstats, wstats):
        assert torch.equal(a.in_spike_counts.cpu(), b.in_spike_counts)
        assert torch.equal(a.out_spike_counts.cpu(), b.out_spike_counts)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.int8])
def test_banked_and_emit_kernels_equal_plain_versions(cuda, dtype, k):
    """event_conv_banked over carriers of 32 input channels (int rails
    reached): truncating, empty, all set and sparse, at the conv1 tile
    (30x30x8) for B=8 and one sample and at the conv2 tile (12x12x5),
    fresh and in place; threshold_pool_emit at the FULL conv0 -> conv1
    shapes and the conv1 -> conv2 handoff (pool 3, a 10x10 map), pool
    None/3, capacities 1, 16, 256, the demand and above the map, for B=8
    and one sample and C=5, relaunched into buffers filled with stale
    bits."""
    g = torch.Generator().manual_seed(k)
    geom = ConvGeometry(k, k)
    hh = k // 2
    big = {torch.float32: 1.0, torch.int16: 9000.0, torch.int8: 40.0}[dtype]

    def banked(q, side, c, density, cap):
        vm = (torch.randn((q, side + 2 * hh, side + 2 * hh, c), generator=g)
              * big).to(dtype).to(cuda)
        spikes = (torch.rand((q, 1, side, side, 32), generator=g)
                  < density).to(cuda)
        ho = taeq.build_fused_handoff(spikes, cap, geom)
        kern = (torch.randn((k, k, 32, c), generator=g)
                * big).to(dtype).to(cuda)
        taps = tap_matrix(kern).permute(2, 0, 1, 3).contiguous()
        want = event_conv_ref_banked(vm, ho.masks[0], taps, geom)
        got = event_conv_cuda_banked(vm, ho.masks[0], taps, geometry=geom)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (q, side, c, density, cap)
        event_conv_cuda_banked(vm, ho.masks[0], taps, geometry=geom, out=vm)
        torch.cuda.synchronize()
        assert torch.equal(vm, want), (q, side, c, density, cap)

    for q in (8, 1):
        for density, cap in ((0.5, 256), (0.0, 256), (1.0, 28 * 28),
                             (0.05, 256)):
            banked(q, 28, 8, density, cap)
        banked(q, 10, 5, 0.9, 100)

    def emit(q, side, c, pool, cap):
        vm = (torch.randn((q, side + 2 * hh, side + 2 * hh, c), generator=g)
              * big).to(dtype).to(cuda)
        fired = (torch.rand((q, side, side, c), generator=g) < 0.1).to(cuda)
        bias = vm[0, 0, 0].clone()
        v_t = 0.5 if dtype == torch.float32 else 20
        args = dict(v_t=v_t, pool=pool, halo=(hh, hh), emit_geometry=geom)
        b = vm.clone()
        kb = threshold_pool_tile_ref(b, bias, fired, **args,
                                     emit_capacity=cap)
        demand = int(kb[3].max())
        caps = {1, 16, cap, max(demand, 1), side * side + 1}
        for cp in sorted(caps):
            want = threshold_pool_tile_ref(vm.clone(), bias, fired, **args,
                                           emit_capacity=cp)
            a = vm.clone()
            ka = threshold_pool_cuda_emit(a, bias, fired, **args,
                                          emit_capacity=cp)
            # a second launch into the same buffers, filled with stale bits
            for x in ka:
                if x is not None:
                    x.fill_(1)
            a2 = vm.clone()
            ka2 = threshold_pool_cuda_emit(
                a2, bias, fired, **args, emit_capacity=cp, fired_out=ka[0],
                pooled_out=ka[1], masks_out=ka[2], count_out=ka[3],
                seg_counts_out=ka[4])
            torch.cuda.synchronize()
            assert torch.equal(a, b) and torch.equal(a2, b)
            for x, y in zip(ka2, want):
                assert (x is None and y is None) or torch.equal(x, y), (
                    q, side, c, pool, cp)

    for q in (8, 1):
        for pool in (None, 3):
            emit(q, 28, 8, pool, 256)
        emit(q, 28, 5, 3, 100)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.int8])
def test_single_queue_kernels_equal_plain_versions(cuda, dtype, k):
    """event_conv_seq_single and event_conv_interlaced_single at the FULL
    single-sample tiles: truncated and segment-padded queues, an unpadded
    interlaced queue (mixed groups), and a 30x30x32 tile; the interlaced
    unit over 32 input channels at the conv1 shape (event_par 8 and 6),
    fresh and in place."""
    g = torch.Generator().manual_seed(10 + k)
    geom = ConvGeometry(k, k)
    hh = k // 2
    big = {torch.float32: 1.0, torch.int16: 9000.0, torch.int8: 40.0}[dtype]
    for c in (8, 32):
        fm = torch.rand((28, 28), generator=g) < 0.6
        q = taeq.build_aeq(fm.to(cuda), 256, geometry=geom)
        vm = (torch.randn((28 + 2 * hh, 28 + 2 * hh, c), generator=g)
              * big).to(dtype).to(cuda)
        kern = (torch.randn((k, k, c), generator=g) * big).to(dtype).to(cuda)
        got = event_conv_cuda(vm, q.coords, q.valid, kern)
        assert torch.equal(got, event_conv_ref(vm, q.coords, q.valid, kern))
        for ep, qq in ((8, taeq.segment_pad(q, 8, geom)),
                       (4, taeq.segment_pad(q, 4, geom)), (8, q)):
            got = event_conv_cuda_interlaced(vm, qq.coords, qq.valid, kern,
                                             event_par=ep)
            assert torch.equal(got, event_conv_ref_interlaced(
                vm, qq.coords, qq.valid, kern, event_par=ep))
        # in place, as the scheduler calls it
        want = event_conv_ref(vm, q.coords, q.valid, kern)
        event_conv_cuda(vm, q.coords, q.valid, kern, out=vm)
        torch.cuda.synchronize()
        assert torch.equal(vm, want)
    fm32 = torch.rand((32, 28, 28), generator=g) < 0.45
    q32 = taeq.build_aeq_batched(fm32.to(cuda), 256, geometry=geom)
    vm = (torch.randn((28 + 2 * hh, 28 + 2 * hh, 8), generator=g)
          * big).to(dtype).to(cuda)
    kern32 = (torch.randn((32, k, k, 8), generator=g) * big).to(dtype).to(cuda)
    for ep in (8, 6):
        qp32 = taeq.segment_pad(q32, ep, geom)
        want = event_conv_ref_interlaced(vm, qp32.coords, qp32.valid, kern32,
                                         event_par=ep)
        assert torch.equal(event_conv_cuda_interlaced(
            vm, qp32.coords, qp32.valid, kern32, event_par=ep), want)
        got = vm.clone()
        event_conv_cuda_interlaced(got, qp32.coords, qp32.valid, kern32,
                                   event_par=ep, out=got)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 3, 5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.int16, torch.int8])
def test_sequential_gather_equals_plain_version(cuda, dtype, k):
    """event_conv_seq_batched / event_conv_seq_single over C_in in {1, 4}
    input channels' truncated queues (int adds clipping mid-queue), Q in
    {1, 3} tiles, fresh and in place; the conv1 shape of the main path
    (32 input channels, 30x30x8 tiles, B=8 and one sample); repeated
    coordinates."""
    g = torch.Generator().manual_seed(20 + k)
    geom, hh = ConvGeometry(k, k), k // 2
    big = {torch.float32: 1.0, torch.int16: 9000.0, torch.int8: 40.0}[dtype]

    def case(c_in, q, side, c, cap):
        fm = torch.rand((c_in, q, side, side), generator=g) < 0.6
        qs = taeq.build_aeq_batched(fm.to(cuda), cap, geometry=geom)
        vm = (torch.randn((q, side + 2 * hh, side + 2 * hh, c), generator=g)
              * big).to(dtype).to(cuda)
        kern = (torch.randn((c_in, k, k, c), generator=g)
                * big).to(dtype).to(cuda)
        return vm, qs.coords, qs.valid, kern

    for c_in, q, side, c, cap in ((1, 3, 28, 8, 256), (4, 3, 28, 8, 256),
                                  (4, 1, 10, 5, 40), (32, 8, 28, 8, 256),
                                  (32, 1, 28, 8, 256)):
        vm, coords, valid, kern = case(c_in, q, side, c, cap)
        want = event_conv_ref_batched(vm, coords, valid, kern)
        assert torch.equal(event_conv_cuda_batched(vm, coords, valid, kern),
                           want)
        got = vm.clone()
        event_conv_cuda_batched(got, coords, valid, kern, out=got)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        c0, v0 = coords[:, 0].contiguous(), valid[:, 0].contiguous()
        want = event_conv_ref(vm[0], c0, v0, kern)
        assert torch.equal(event_conv_cuda(vm[0], c0, v0, kern), want)
        got = vm[0].clone()
        event_conv_cuda(got, c0, v0, kern, out=got)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    coords = torch.tensor([[[[4, 4], [4, 4], [7, 4], [4, 4]]] * 2] * 2,
                          dtype=torch.int32, device=cuda)
    valid = torch.tensor([[[1, 1, 1, 0], [1, 1, 1, 1]]] * 2,
                         dtype=torch.bool, device=cuda)
    vm = (torch.randn((2, 10 + 2 * hh, 10 + 2 * hh, 8), generator=g)
          * big).to(dtype).to(cuda)
    kern = (torch.randn((2, k, k, 8), generator=g) * big).to(dtype).to(cuda)
    assert torch.equal(event_conv_cuda_batched(vm, coords, valid, kern),
                       event_conv_ref_batched(vm, coords, valid, kern))


@pytest.mark.gpu
def test_engine_modes_equal_snn_apply_batched_on_card(cuda):
    """Micro-batching, continuous refill and streaming DVS admission on
    SMOKE: every request's logits equal the card's snn_apply_batched on
    the same inputs (streams: the binned frames of the same events)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import csnn_paper
    from repro_torch.core.csnn import (encode_input, init_params,
                                       snn_apply_batched)
    from repro_torch.core.plan import plan_network
    from repro_torch.data.dvs import dvs_moving_edges, events_to_frames
    from repro_torch.serve.csnn_engine import CSNNEngine, CSNNServeConfig

    cfg = csnn_paper.SMOKE
    params = init_params(cfg, seed=0, device=cuda)
    plan = plan_network(cfg, capacity=64, channel_block=4, batch_tile=4,
                        event_par=None)
    imgs = torch.rand((7, 12, 12, 1),
                      generator=torch.Generator().manual_seed(1))
    want = snn_apply_batched(params, encode_input(imgs.to(cuda), cfg), cfg,
                             plan, collect_stats=False).cpu()
    for serve_cfg in (CSNNServeConfig(max_batch=4, max_delay_ms=5.0),
                      CSNNServeConfig(max_batch=4, continuous=True, slots=4,
                                      t_chunk=1)):
        engine = CSNNEngine(params, cfg, plan, serve_cfg)
        engine.warmup()
        assert torch.equal(engine.run_requests(list(imgs), timeout=120.0),
                           want)
    scfg = dataclasses.replace(cfg, input_channels=2)
    sparams = init_params(scfg, seed=0, device=cuda)
    traces, _ = dvs_moving_edges(5, scfg.t_steps, scfg.input_hw, seed=1)
    frames = torch.from_numpy(np.stack([events_to_frames(
        tr, scfg.t_steps, scfg.input_hw) for tr in traces]))
    for event_par in (None, 1):  # interlaced, then sequential queues
        splan = plan_network(scfg, capacity=64, channel_block=4,
                             event_par=event_par, ingest=True)
        want = snn_apply_batched(sparams, frames.to(cuda), scfg, splan,
                                 collect_stats=False).cpu()
        engine = CSNNEngine(sparams, scfg, splan, CSNNServeConfig(
            max_batch=4, continuous=True, stream=True, t_chunk=1))
        engine.warmup()
        assert torch.equal(engine.run_requests(traces, timeout=120.0), want)


@pytest.mark.gpu
def test_measured_tune_on_card_equals_analytic_plan(cuda, tmp_path):
    """A measured tune of SMOKE on the card (the interlaced candidate
    included), a cache hit that measures nothing, and the tuned forward
    equal to the analytic plan's (stats and logits)."""
    from repro_torch.configs import csnn_paper
    from repro_torch.core.csnn import init_params, snn_apply_batched
    from repro_torch.core.plan import plan_network
    from repro_torch.tune import TuneConfig, measurement_runs

    cfg = csnn_paper.SMOKE
    knobs = dict(capacity=64, channel_block=4, batch_tile=4, event_par=None)
    config = TuneConfig(device="cuda", warmup=1, iters=3)
    path = tmp_path / "plan_cache.json"
    n0 = measurement_runs()
    tuned = plan_network(cfg, **knobs, tune="measured", tune_config=config,
                         cache_path=path)
    assert measurement_runs() > n0
    assert "interlaced-cuda" in path.read_text()
    n1 = measurement_runs()
    assert plan_network(cfg, **knobs, tune="cached", tune_config=config,
                        cache_path=path) == tuned
    assert measurement_runs() == n1
    params = init_params(cfg, seed=0, device=cuda)
    spikes = (torch.rand((4, cfg.t_steps, 12, 12, 1),
                         generator=torch.Generator().manual_seed(2))
              < 0.3).to(cuda)
    la, sa = snn_apply_batched(params, spikes, cfg, plan_network(cfg, **knobs))
    lt, st = snn_apply_batched(params, spikes, cfg, tuned)
    assert torch.equal(la, lt)
    for a, b in zip(sa, st):
        assert torch.equal(a.in_spike_counts, b.in_spike_counts)
        assert torch.equal(a.out_spike_counts, b.out_spike_counts)


@pytest.mark.gpu
def test_kernel_audit_on_card_launches_every_kernel(cuda):
    """``python -m repro_torch.analysis --only kernels`` in process: clean,
    and each kernel of ``runtime.LAUNCHES`` counted a launch."""
    from repro_torch.analysis.kernel_audit import KERNELS, run_kernel_audit
    runtime.reset_launches()
    rep = run_kernel_audit(device=cuda)
    assert rep.ok, rep.summary()
    assert all(runtime.LAUNCHES[k] > 0 for k in KERNELS), runtime.LAUNCHES


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [None, "fused-handoff"])
def test_sharded_on_card_streams_equal_snn_apply_batched(cuda, variant):
    """Two and four shards on streams of one card: logits ``torch.equal``
    and stats equal to the unsharded forward."""
    from repro_torch.configs import csnn_paper
    from repro_torch.core.csnn import (encode_input, init_params,
                                       snn_apply_batched, snn_apply_sharded)
    from repro_torch.core.plan import plan_network
    cfg = csnn_paper.SMOKE
    params = init_params(cfg, seed=3, device=cuda)
    imgs = torch.rand((8, 12, 12, 1), generator=torch.Generator().manual_seed(3))
    spikes = encode_input(imgs.to(cuda), cfg)
    plan = plan_network(cfg, capacity=64, channel_block=4, event_par=None,
                        variant=variant)
    want, wstats = snn_apply_batched(params, spikes, cfg, plan)
    for n in (2, 4):
        got, stats = snn_apply_sharded(params, spikes, cfg, plan,
                                       devices=[cuda] * n, collect_stats=True)
        assert torch.equal(got, want)
        for a, b in zip(stats, wstats):
            for f in ("in_spike_counts", "out_spike_counts", "in_sparsity"):
                assert torch.equal(getattr(a, f), getattr(b, f))


@pytest.mark.gpu
def test_sharded_copies_host_parameters_before_shards_read(cuda):
    """Host parameters and two shards on one card: each shard reads the
    parameters' card copy only once it has landed."""
    from repro_torch.configs import csnn_paper
    from repro_torch.core.csnn import (encode_input, init_params,
                                       snn_apply_batched, snn_apply_sharded)
    from repro_torch.core.plan import plan_network
    cfg = csnn_paper.SMOKE
    params = init_params(cfg, seed=4, device="cpu")
    imgs = torch.rand((8, 12, 12, 1),
                      generator=torch.Generator().manual_seed(4))
    spikes = encode_input(imgs.to(cuda), cfg)
    plan = plan_network(cfg, capacity=64, channel_block=4, event_par=None)
    want = snn_apply_batched({k: {n: t.to(cuda) for n, t in p.items()}
                              for k, p in params.items()}, spikes, cfg, plan,
                             collect_stats=False)
    for _ in range(3):
        got = snn_apply_sharded(params, spikes, cfg, plan,
                                devices=[cuda, cuda])
        assert torch.equal(got, want)


@pytest.mark.gpu
def test_training_gradients_on_card_equal_cpu_with_tf32_on(cuda):
    """One ``fit_ann`` step's gradients on the card equal the CPU's at
    rtol 1e-5 with cuDNN's TF32 switch at PyTorch's default (on): the
    step's convolutions, backward included, run in full float32."""
    from repro_torch.configs import csnn_paper
    from repro_torch.core.conversion import _loss_and_grads
    from repro_torch.core.csnn import init_params
    from repro_torch.data.synthetic import synth_digits
    cfg = csnn_paper.SMOKE
    images, labels = synth_digits(64, seed=0, hw=cfg.input_hw)
    params = init_params(cfg, seed=0, device="cpu")
    x, y = torch.from_numpy(images), torch.from_numpy(labels).long()
    _, want = _loss_and_grads(params, x, y, cfg)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        _, got = _loss_and_grads(
            {k: {n: t.to(cuda) for n, t in p.items()}
             for k, p in params.items()}, x.to(cuda), y.to(cuda), cfg)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    for k in want:
        for n in want[k]:
            w = want[k][n]
            torch.testing.assert_close(got[k][n].cpu(), w, rtol=1e-5,
                                       atol=1e-5 * float(w.abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_on_card_equals_cpu(cuda, bits):
    """The same integers on the card as on the CPU, values on .5
    boundaries of the scale included."""
    from repro_torch.core.quantization import (QuantSpec, calibrate_scale,
                                               quantize)
    g = torch.Generator().manual_seed(bits)
    x = torch.randn(100_000, generator=g) * 0.3
    scale = calibrate_scale(x, bits)
    assert calibrate_scale(x.to(cuda), bits) == scale
    spec = QuantSpec(bits, scale)
    k = torch.randint(-spec.max_int, spec.max_int, (100_000,), generator=g)
    vals = torch.cat([x, (k + 0.5) * torch.tensor(scale)])
    assert torch.equal(quantize(vals.to(cuda), spec).cpu(),
                       quantize(vals, spec))


LM_IDS = ("zamba2-1.2b", "rwkv6-1.6b", "stablelm-3b", "granite-34b",
          "phi3-medium-14b", "gemma3-1b", "qwen2-vl-7b", "whisper-medium",
          "llama4-maverick-400b-a17b", "deepseek-v2-236b")


def _chip_smoke():
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_smoke_card_equals_cpu(cuda, arch, dtype):
    """Each SMOKE LM on the card against the CPU plain path: prefill
    logits and cache, 4 decode steps (chip_smoke's LM check and
    tolerances)."""
    _chip_smoke().lm_smoke_vs_cpu(cuda, arch, dtype)


@pytest.mark.gpu
def test_lm_generate_without_host_sync(cuda):
    """``Engine.generate`` on gemma3 SMOKE (a prompt past its window)
    makes no synchronizing CUDA call and equals a manual greedy loop."""
    from repro_torch.configs import gemma3_1b
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import Engine, ServeConfig
    model = build_model(gemma3_1b.SMOKE)
    params = model.init_params(torch.Generator().manual_seed(0), cuda)
    prompts = torch.randint(0, 512, (3, 40), dtype=torch.int32,
                            generator=torch.Generator().manual_seed(1)).to(cuda)
    engine = Engine(model, params, 52, ServeConfig(max_new_tokens=12))
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = engine.generate(prompts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    logits, cache = model.prefill(params, {"tokens": prompts}, 52)
    toks = [logits.argmax(-1)]
    for i in range(11):
        logits, cache = model.decode(params, cache, {
            "tokens": toks[-1][:, None].to(torch.int32), "pos": 40 + i})
        toks.append(logits.argmax(-1))
    assert torch.equal(out[:, 40:], torch.stack(toks, 1).to(out.dtype))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", LM_IDS)
def test_lm_train_step_card_equals_cpu(cuda, arch):
    """One training step of each SMOKE LM on the card against the CPU:
    the loss and the gradient norm (chip_smoke's training check (c) and
    its tolerances)."""
    assert _chip_smoke().train_smoke_vs_cpu(cuda, arch) <= 1.0


@pytest.mark.gpu
def test_lm_train_run_resumes_on_card(cuda, tmp_path):
    """``train.loop.run`` of gemma3 SMOKE on the card: 4 steps with a
    checkpoint at step 2, then a run to 4 from that checkpoint; the two
    final states equal bit for bit, and the restored step-2 state is the
    card's own."""
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs import gemma3_1b
    from repro_torch.data.synthetic import ShardedBatcher, TokenStream
    from repro_torch.models.registry import build_model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import LoopConfig, run
    model = build_model(gemma3_1b.SMOKE)
    data = ShardedBatcher(TokenStream(model.cfg.vocab, 0), 2, 40, device=cuda)
    ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=4)
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    whole, hist = run(model, data, LoopConfig(4, 2, str(tmp_path / "a"), 1), ocfg,
                      gen(), device=cuda)
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    run(model, data, LoopConfig(2, 2, str(tmp_path / "b"), 1), ocfg, gen(),
        device=cuda)
    resumed, _ = run(model, data, LoopConfig(4, 2, str(tmp_path / "b"), 1), ocfg,
                     gen(), device=cuda)
    leaves = lambda s: opt.tree_leaves([s.params, s.mu, s.nu])  # noqa: E731
    assert resumed.step == whole.step == 4
    assert all(a.is_cuda and torch.equal(a, b)
               for a, b in zip(leaves(resumed), leaves(whole)))
    two, _ = ckpt.restore(opt.abstract_state(model.abstract_params(torch.float32),
                                             ocfg), tmp_path / "a", 2, device=cuda)
    assert two.step == 2


@pytest.fixture
def card_mesh(cuda):
    """The (1, 1) smoke mesh over NCCL with a world of one on the card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_smoke_mesh
    from repro_torch.sharding.specs import set_constraint_mesh
    if dist.is_initialized():
        pytest.skip("a process group is already running")
    init_distributed("cuda")
    try:
        yield make_smoke_mesh("cuda")
    finally:
        set_constraint_mesh(None)
        dist.destroy_process_group()


@pytest.mark.gpu
def test_mesh_collectives_on_card_equal_unsharded(card_mesh):
    from repro_torch.sharding.compression import compress_topk, decompress, sparse_psum
    from repro_torch.sharding.overlap import psum_matmul, ring_weight_gather_matmul
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(64, 256, generator=g, device="cuda")
    w = torch.randn(256, 128, generator=g, device="cuda")
    assert torch.equal(psum_matmul(x, w, card_mesh, "model").to_local(), x @ w)
    assert torch.equal(ring_weight_gather_matmul(x, w, card_mesh, "data").to_local(),
                       x @ w)
    c = compress_topk(torch.randn(4096, generator=g, device="cuda"), 64)
    assert torch.equal(sparse_psum(c, card_mesh, "data").to_local(), decompress(c))


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-3b", "deepseek-v2-236b"])
def test_mesh_train_steps_on_card_equal_no_mesh(card_mesh, arch):
    """Two SMOKE steps on the (1, 1) card mesh, the state placed by the
    rules, equal the two steps without a mesh bit for bit."""
    from repro_torch.configs import LM_ARCHS
    from repro_torch.data.synthetic import ShardedBatcher, TokenStream
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.specs import default_rules, set_constraint_mesh, shard_tree
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import make_train_step, state_shardings
    model = build_model(LM_ARCHS[arch].SMOKE)
    ocfg = opt.AdamWConfig()
    plain = opt.init_state(model.init_params(torch.Generator().manual_seed(0), "cuda"),
                           ocfg)
    sh = state_shardings(model, card_mesh, default_rules())
    meshed = shard_tree(plain, sh)
    ts = TokenStream(model.cfg.vocab, seed=0)
    step_p, step_m = make_train_step(model, ocfg), make_train_step(model, ocfg, shardings=sh)
    for s in range(2):
        plain, mp = step_p(plain, ShardedBatcher(ts, 2, 32, device="cuda")(s))
        set_constraint_mesh(card_mesh, default_rules())
        meshed, mm = step_m(meshed, ShardedBatcher(ts, 2, 32, device="cuda",
                                                   mesh=card_mesh)(s))
        set_constraint_mesh(None)
        assert torch.equal(mp["loss"], mm["loss"])
    for a, b in zip(opt.tree_leaves([plain.params, plain.mu, plain.nu]),
                    opt.tree_leaves([meshed.params, meshed.mu, meshed.nu])):
        assert torch.equal(a, b.to_local())
