"""The benchmark's yardstick on the CPU: the plain reference against the
port's plain path, the frozen generator copies against the port's, and
the work counts against shapes worked by hand."""
import json

import numpy as np
import pytest
import torch

from harness import config
from yardstick import counts, digits, dvs, peaks, reference

from repro_torch.core import csnn
from repro_torch.data import dvs as port_dvs
from repro_torch.data.synthetic import synth_digits

csnn_builder = config.load_path("builders/csnn.py")


def _setup(cfg_name: str, net_update=None, plan_update=None):
    conf = json.loads((config.BENCH_DIR / "configs" / f"{cfg_name}.json")
                      .read_text())
    if net_update:
        conf["network"].update(net_update)
    if plan_update:
        conf["plan"].update(plan_update)
    net = conf["network"]
    cfg = csnn_builder.program_config(net)
    return conf, net, cfg, csnn_builder.program_plan(cfg, conf["plan"])


def _inputs(net, n, seed):
    hw, t = tuple(net["input_hw"]), net["t_steps"]
    if net["input_channels"] == 1:
        images, _ = digits.synth_digits(n, seed=seed, hw=hw)
        return reference.encode(torch.from_numpy(images), t)
    traces, _ = dvs.dvs_moving_edges(n, t, hw, seed=seed)
    return torch.from_numpy(np.stack([dvs.events_to_frames(tr, t, hw)
                                      for tr in traces]))


SMOKE = {"input_hw": [12, 12], "t_steps": 4, "layers": [
    {"conv": 8, "kernel": 3}, {"conv": 8, "kernel": 3, "pool": 3},
    {"fc": 10}]}
SMOKE_PLAN = {"capacity": [144, 144], "channel_block": [8, 8],
              "event_par": [8, 8]}


@pytest.mark.parametrize("cfg_name,size", [
    ("csnn_paper", "smoke"), ("csnn_paper_dvs", "smoke"),
    ("csnn_paper", "full"), ("csnn_paper_dvs", "full")])
def test_reference_equals_port_plain_path(cfg_name, size):
    """Logits bit for bit and every layer's input events per (sample, t)."""
    if size == "smoke":
        plan_update = dict(SMOKE_PLAN)
        if cfg_name == "csnn_paper_dvs":
            plan_update["variant"] = ["fused-handoff"] * 2
        conf, net, cfg, plan = _setup(cfg_name, SMOKE, plan_update)
        n = 12
    else:
        conf, net, cfg, plan = _setup(cfg_name)
        n = 2
    params = csnn_builder.weights(conf, 2**31 + 7, torch.device("cpu"))
    spikes = _inputs(net, n, seed=5)
    got, stats = csnn.snn_apply_batched(params, spikes, cfg, plan)
    ref = reference.forward(params, spikes, net)
    assert torch.equal(got, ref.logits)
    assert (ref.head_events.sum() > 0).item()
    for st, ev in zip(stats, ref.conv_events):
        assert torch.equal(st.in_spike_counts.sum(-1).to(torch.int64), ev)


def test_encode_matches_port():
    images, _ = digits.synth_digits(8, seed=3)
    x = torch.from_numpy(images)
    cfg = csnn_builder.program_config(_setup("csnn_paper")[1])
    assert torch.equal(reference.encode(x, 5), csnn.encode_input(x, cfg))


def test_bf16_reference_differs():
    """The control computes on the same grid weights in bfloat16 and moves
    logits, where float64 equals itself."""
    conf, net, _, _ = _setup("csnn_paper", SMOKE, SMOKE_PLAN)
    params = csnn_builder.weights(conf, 1, torch.device("cpu"))
    spikes = _inputs(net, 16, seed=2)
    exact = reference.forward(params, spikes, net).logits
    low = reference.forward(params, spikes, net, torch.bfloat16).logits
    assert not torch.equal(exact, low)


def test_seed_permutes_channels_only():
    """Every seed is the same network: equal logits, other channel order,
    and at FULL size the same channels in each of the plan's blocks."""
    conf, net, _, _ = _setup("csnn_paper", SMOKE, SMOKE_PLAN)
    a = csnn_builder.weights(conf, 1, torch.device("cpu"))
    b = csnn_builder.weights(conf, 2, torch.device("cpu"))
    assert not torch.equal(a["conv0"]["w"], b["conv0"]["w"])
    spikes = _inputs(net, 8, seed=2)
    assert torch.equal(reference.forward(a, spikes, net).logits,
                       reference.forward(b, spikes, net).logits)
    grid = 2.0 ** conf["init"]["grid_bits"]
    for p in a.values():
        for t in p.values():
            assert torch.equal(t * grid, torch.round(t * grid))
    full = _setup("csnn_paper")[0]
    fa, fb = (csnn_builder.weights(full, s, torch.device("cpu"))
              for s in (1, 2**31 + 5))
    for i, block in enumerate(full["plan"]["channel_block"]):
        def members(p):
            return sorted(tuple(sorted(b.tolist()))
                          for b in p[f"conv{i}"]["b"].reshape(-1, block))
        assert members(fa) == members(fb)
        assert not torch.equal(fa[f"conv{i}"]["b"], fb[f"conv{i}"]["b"])


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_frozen_generators_match_port(seed):
    images, labels = digits.synth_digits(6, seed=seed)
    want_images, want_labels = synth_digits(6, seed=seed)
    assert np.array_equal(images, want_images)
    assert np.array_equal(labels, want_labels)
    traces, labels = dvs.dvs_moving_edges(4, 5, seed=seed)
    want_traces, want_labels = port_dvs.dvs_moving_edges(4, 5, seed=seed)
    assert np.array_equal(labels, want_labels)
    for a, b in zip(traces, want_traces):
        assert np.array_equal(a, b)
        assert np.array_equal(dvs.events_to_frames(a, 5, (28, 28)),
                              port_dvs.events_to_frames(b, 5, (28, 28)))


NET = {"input_hw": [4, 4], "input_channels": 1, "t_steps": 2, "v_t": 1.0,
       "layers": [{"conv": 2, "kernel": 3}, {"conv": 3, "kernel": 3,
                                              "pool": 2}, {"fc": 5}]}


def test_sample_adds_by_hand():
    conv_events = [torch.tensor([[3, 4]]), torch.tensor([[10, 0]])]
    head_events = torch.tensor([[6, 2]])
    adds = counts.sample_adds(conv_events, head_events, NET)
    # conv0: 7 events x 9 taps x 2 outputs; conv1: 10 x 9 x 3; head 8 x 5
    assert adds.tolist() == [7 * 9 * 2 + 10 * 9 * 3 + 8 * 5]


def test_conv_least_time_by_hand():
    conv_events = [torch.tensor([[3, 4], [1, 0]]),
                   torch.tensor([[10, 0], [2, 2]])]
    b = 2
    # conv0: 4x4x2 membranes read and written (f32), 9 weights x 2, input
    # 4x4x1 and output 4x4x2 bits; conv1: 4x4x3 membranes, 54 weights,
    # input 4x4x2 and pooled output 2x2x3 bits
    bytes0 = b * (2 * 16 * 2 * 4 + (16 + 32) / 8) + 9 * 2 * 4
    bytes1 = b * (2 * 16 * 3 * 4 + (32 + 12) / 8) + 9 * 2 * 3 * 4
    adds0 = [4 * 18, 4 * 18]
    adds1 = [12 * 27, 2 * 27]
    want = sum(max(bytes0 / peaks.HBM_BYTES_PER_S, a / peaks.FP32_FLOPS)
               for a in adds0)
    want += sum(max(bytes1 / peaks.HBM_BYTES_PER_S, a / peaks.FP32_FLOPS)
                for a in adds1)
    got = counts.conv_least_time_s(conv_events, NET)
    assert got == pytest.approx(want, rel=1e-12)
