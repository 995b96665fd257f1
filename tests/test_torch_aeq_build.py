"""The event-set builder (``aeq.build_launch_queues``,
``kernels/aeq_build``) on the CPU, where it runs its plain version.

The queues equal the composition the scheduler ran before the builder
(``build_aeq_batched``, ``segment_pad``, the permutes into the launch
layout) and an independent per-queue oracle written from the contract
(interlace order, tail truncation, event_par-aligned segments, -1 / False
padding, the full demand), at the benchmark cells' map shapes, event_par
1-8, capacities at and below the demand, empty and full maps and strided
views.  The wrapper refuses a wrong dtype, rank or device.  The
scheduler's queue variants call it once per conv layer and chunk, and
their logits and statistics equal those of the composition it replaced.
The CUDA kernel is held to the same plain version on the card
(``tests/test_torch_gpu.py``).

    PYTHONPATH=src python -m pytest -q tests/test_torch_aeq_build.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import csnn_paper
from repro_torch.core import aeq as taeq
from repro_torch.core import scheduler
from repro_torch.core.csnn import encode_input, init_params, snn_apply_batched
from repro_torch.core.geometry import GEOM_3X3, ConvGeometry
from repro_torch.core.plan import plan_network
from repro_torch.kernels.aeq_build.kernel import aeq_build_cuda

#: (H, W, C_in) of the cells' queue layers: the paper net's conv0-conv2
#: and VGG-16's 32x32x3 down to 2x2 (channels cut for the CPU)
SHAPES = [(28, 28, 1), (28, 28, 32), (10, 10, 32), (32, 32, 3), (8, 8, 16),
          (2, 2, 24)]


def _composition(spikes, capacity, event_par, geometry=GEOM_3X3):
    """The scheduler's queue build before the builder, written out."""
    q = taeq.build_aeq_batched(spikes.permute(1, 0, 4, 2, 3), capacity,
                               geometry=geometry)
    if event_par > 1:
        q = taeq.segment_pad(q, event_par, geometry)
    return (q.coords.permute(0, 2, 1, 3, 4).contiguous(),
            q.valid.permute(0, 2, 1, 3).contiguous(), q.count)


def _oracle(fmap: np.ndarray, capacity: int, event_par: int, kh: int,
            kw: int) -> tuple[np.ndarray, np.ndarray]:
    """One queue from the contract: active pixels in (column, i, j) order,
    the first min(capacity, H*W) kept, each column's kept events from a
    multiple of event_par, every other slot (-1, -1) / False."""
    h, w = fmap.shape
    nb = kh * kw
    cap_pad = taeq.interlaced_capacity(capacity, event_par, nb)
    events = sorted(((kw * (i % kh) + j % kw, i, j)
                     for i, j in zip(*np.nonzero(fmap))))
    kept = events[:min(capacity, h * w)]
    coords = np.full((cap_pad, 2), -1, np.int32)
    valid = np.zeros((cap_pad,), bool)
    off = 0
    for s in range(nb):
        col = [(i, j) for c, i, j in kept if c == s]
        if col:
            coords[off:off + len(col)] = col
            valid[off:off + len(col)] = True
        off += -(-len(col) // event_par) * event_par
    return coords, valid


def _spikes(kind: str, shape, g) -> torch.Tensor:
    b, t, h, w, c = shape
    if kind == "empty":
        return torch.zeros(shape, dtype=torch.bool)
    if kind == "full":
        return torch.ones(shape, dtype=torch.bool)
    if kind == "view":  # (t, C, B, H, W + 2) storage, sliced and permuted
        base = torch.rand((t, c, b, h, w + 2), generator=g) < 0.3
        return base[..., 1:w + 1].permute(2, 0, 3, 4, 1)
    return torch.rand(shape, generator=g) < 0.3


@pytest.mark.parametrize("kind", ["random", "empty", "full", "view"])
@pytest.mark.parametrize("truncate", [False, True], ids=["cap=hw", "cap<demand"])
@pytest.mark.parametrize("event_par", [1, 2, 4, 8])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_build_launch_queues_equals_composition_and_contract(shape, event_par,
                                                             truncate, kind):
    h, w, c = shape
    g = torch.Generator().manual_seed(h * 1000 + w * 10 + c + event_par)
    spikes = _spikes(kind, (2, 2, h, w, c), g)
    capacity = max(1, (h * w) // 5) if truncate else h * w
    coords, valid, count = taeq.build_launch_queues(spikes, capacity,
                                                    event_par)
    cap_pad = taeq.interlaced_capacity(capacity, event_par)
    assert coords.shape == (2, c, 2, cap_pad, 2) and coords.is_contiguous()
    assert valid.shape == (2, c, 2, cap_pad) and valid.is_contiguous()
    assert coords.dtype == count.dtype == torch.int32
    assert valid.dtype == torch.bool
    for got, want in zip((coords, valid, count),
                         _composition(spikes, capacity, event_par)):
        assert torch.equal(got, want)
    assert torch.equal(count, spikes.sum(dim=(2, 3), dtype=torch.int32)
                       .transpose(0, 1))
    for t in range(2):
        for ci in range(0, c, max(1, c // 4)):
            for b in range(2):
                want_c, want_v = _oracle(spikes[b, t, :, :, ci].numpy(),
                                         capacity, event_par, 3, 3)
                np.testing.assert_array_equal(coords[t, ci, b].numpy(), want_c)
                np.testing.assert_array_equal(valid[t, ci, b].numpy(), want_v)


@pytest.mark.parametrize("window", [(1, 1), (5, 5), (3, 5)])
def test_build_launch_queues_other_windows(window):
    geom = ConvGeometry(*window)
    g = torch.Generator().manual_seed(5)
    spikes = torch.rand((2, 3, 9, 11, 4), generator=g) < 0.4
    for capacity, event_par in ((99, 1), (30, 4), (99, 8)):
        got = taeq.build_launch_queues(spikes, capacity, event_par, geom)
        for a, b in zip(got, _composition(spikes, capacity, event_par, geom)):
            assert torch.equal(a, b)
        want_c, want_v = _oracle(spikes[1, 2, :, :, 3].numpy(), capacity,
                                 event_par, *window)
        np.testing.assert_array_equal(got[0][2, 3, 1].numpy(), want_c)
        np.testing.assert_array_equal(got[1][2, 3, 1].numpy(), want_v)


@pytest.mark.parametrize("bad, message", [
    (torch.zeros((2, 1, 8, 8, 3)), "bool"),
    (torch.zeros((2, 8, 8, 3), dtype=torch.bool), r"\(B, T, H, W, C_in\)"),
    (torch.zeros((2, 1, 8, 8, 3), dtype=torch.bool, device="meta"),
     "CUDA device or all on the CPU"),
    (np.zeros((2, 1, 8, 8, 3), bool), r"\(B, T, H, W, C_in\)"),
])
def test_builder_wrapper_refuses_wrong_operands(bad, message):
    with pytest.raises(ValueError, match=message):
        aeq_build_cuda(bad, 64, 4)


@pytest.mark.parametrize("capacity, event_par", [(-1, 4), (64, 0)])
def test_builder_wrapper_refuses_wrong_sizes(capacity, event_par):
    spikes = torch.zeros((2, 1, 8, 8, 3), dtype=torch.bool)
    with pytest.raises(ValueError, match="capacity must be"):
        aeq_build_cuda(spikes, capacity, event_par)


@pytest.mark.parametrize("knobs", [
    dict(capacity=64, event_par=1),            # sequential
    dict(capacity=64, event_par=4),            # interlaced-cuda
    dict(capacity=40, event_par=8, t_chunk=2),  # truncating, two chunks
], ids=["sequential", "interlaced", "truncating-chunked"])
def test_queue_variants_equal_the_replaced_composition(monkeypatch, knobs):
    """The queue variants on SMOKE: one builder call per conv layer and
    chunk, and logits and LayerStats equal to the runs with the old
    composition in its place."""
    cfg = csnn_paper.SMOKE
    plan = plan_network(cfg, channel_block=4, **knobs)
    params = init_params(cfg, seed=1, device="cpu")
    imgs = torch.rand((3, 12, 12, 1), generator=torch.Generator().manual_seed(2))
    spikes = encode_input(imgs, cfg)
    calls = []
    real = scheduler.build_launch_queues

    def counting(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(scheduler, "build_launch_queues", counting)
    logits, stats = snn_apply_batched(params, spikes, cfg, plan)
    chunks = -(-cfg.t_steps // plan.chunk_steps)
    assert len(calls) == chunks * len(plan.layers)
    assert {c[1] for c in calls} == {knobs["event_par"]}
    monkeypatch.setattr(scheduler, "build_launch_queues", _composition)
    want, wstats = snn_apply_batched(params, spikes, cfg, plan)
    assert torch.equal(logits, want)
    for a, b in zip(stats, wstats):
        for field in ("in_spike_counts", "out_spike_counts", "in_sparsity"):
            assert torch.equal(getattr(a, field), getattr(b, field))
