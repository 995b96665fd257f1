"""VGG-16 (CIFAR-10 form) as a 13-layer m-TTFS CSNN on the port
(``repro_torch.configs.csnn_vgg16``), on the CPU.

SMOKE (all 13 convs and 5 pools at 1/16 of the widths, 3 input channels)
runs through ``snn_apply_batched`` and equals the benchmark's plain
float64 reference (``bench/yardstick/reference.py``, loaded by path) bit
for bit, on grid weights with per-layer gains chosen by
``bench/gains.py``.  FULL appears only in plan-level checks that do not
run it: its pinned plan, each layer's membrane tile against the tile
path's limit, and the launch count of a forward.  The JAX package has no
counterpart of this network.

    PYTHONPATH=src python -m pytest -q tests/test_torch_csnn_vgg16.py
"""
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "bench"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness import config  # noqa: E402
from repro_torch.configs import CSNN_ARCHS, csnn_vgg16  # noqa: E402
from repro_torch.core import csnn  # noqa: E402
from repro_torch.core.csnn import ConvSpec  # noqa: E402
from repro_torch.core.plan import plan_network  # noqa: E402
from repro_torch.kernels.event_conv.kernel import (TILE_MAX_BYTES,  # noqa: E402
                                                   tile_path)

CONF = json.loads((BENCH / "configs" / "csnn_vgg16_cifar.json").read_text())
H100_SMS = 132
BATCH = 256  # the offline cell's


def _net(cfg) -> dict:
    """A CSNNConfig as a configuration file's ``network``."""
    layers = [{"conv": s.channels, "kernel": s.kernel,
               **({"pool": s.pool} if s.pool else {})}
              for s in cfg.layers if isinstance(s, ConvSpec)]
    return {"input_hw": list(cfg.input_hw),
            "input_channels": cfg.input_channels,
            "layers": layers + [{"fc": cfg.layers[-1].features}],
            "t_steps": cfg.t_steps, "v_t": cfg.v_t}


def _capacities(cfg) -> list:
    caps, (h, w) = [], cfg.input_hw
    for s in cfg.layers:
        if isinstance(s, ConvSpec):
            caps.append(h * w)
            h, w = csnn.conv_out_hw((h, w), s)
    return caps


def test_registered_with_all_thirteen_convs_and_five_pools():
    assert CSNN_ARCHS["csnn-vgg16"] is csnn_vgg16
    for cfg, widths in ((csnn_vgg16.FULL, csnn_vgg16.WIDTHS),
                        (csnn_vgg16.SMOKE, [c // 16 for c in
                                            csnn_vgg16.WIDTHS])):
        convs = [s for s in cfg.layers if isinstance(s, ConvSpec)]
        assert [s.channels for s in convs] == list(widths)
        assert [i for i, s in enumerate(convs) if s.pool] == [1, 3, 6, 9, 12]
        assert all(s.kernel == 3 and s.pool in (None, 2) for s in convs)
        assert (cfg.input_hw, cfg.input_channels, cfg.t_steps) == \
            ((32, 32), 3, 5)
        plan = plan_network(cfg, capacity=_capacities(cfg))
        assert plan.layers[-1].out_hw == (1, 1)
        assert cfg.layers[-1].features == 10


def test_pinned_full_plan_validates():
    cfg = csnn_vgg16.FULL
    plan = plan_network(cfg, **csnn_vgg16.PLAN)
    assert plan.validate(cfg) is plan
    assert [lp.capacity for lp in plan.layers] == _capacities(cfg)
    assert [lp.channel_block for lp in plan.layers] == \
        csnn_vgg16.PLAN["channel_block"]  # every block divides its layer
    assert all(lp.resolve_variant() == "interlaced-cuda"
               for lp in plan.layers)


def test_full_tiles_take_the_tile_path():
    """Every FULL layer's float32 membrane tile fits the tile path at the
    cell's batch; at channel block 8 the two 32x32 layers would not."""
    plan = plan_network(csnn_vgg16.FULL, **csnn_vgg16.PLAN)
    tiles = [math.prod(lp.vm_tile) * 4 for lp in plan.layers]
    assert tiles == [18496, 18496, 20736, 20736, 25600, 25600, 25600,
                     18432, 18432, 18432, 16384, 16384, 16384]
    for lp, size in zip(plan.layers, tiles):
        assert size <= TILE_MAX_BYTES
        assert tile_path(BATCH, size, H100_SMS, lp.event_par, False)
    assert 34 * 34 * 8 * 4 > TILE_MAX_BYTES


def test_full_launches_without_running():
    plan = plan_network(csnn_vgg16.FULL, **csnn_vgg16.PLAN)
    blocks = [lp.c_out // lp.channel_block for lp in plan.layers]
    assert sum(blocks) == 78
    assert plan.kernel_launches == 2 * 5 * 78 == 780
    # the default channel block of 8 would launch 2640 + 2640
    assert plan_network(csnn_vgg16.FULL, capacity=_capacities(
        csnn_vgg16.FULL), channel_block=8).kernel_launches == 5280


def test_benchmark_file_is_the_registered_network():
    builder = config.load_path("builders/csnn_gain.py")
    assert builder.check_program(CONF) is csnn_vgg16
    assert CONF["network"] == _net(csnn_vgg16.FULL)
    assert CONF["reduced"] == []
    other = json.loads(json.dumps(CONF))
    other["init"]["gain_log2"][3] += 1
    with pytest.raises(SystemExit, match="gains"):
        builder.check_program(other)


def test_cifar_generator_is_seeded_colour_images():
    from yardstick import cifar
    for seed in (1, 2**31 + 3):
        a, la = cifar.synth_cifar(6, seed=seed)
        b, lb = cifar.synth_cifar(6, seed=seed)
        assert np.array_equal(a, b) and np.array_equal(la, lb)
        assert a.shape == (6, 32, 32, 3) and la.shape == (6,)
        assert a.dtype == np.float32 and 0.0 <= a.min() and a.max() <= 1.0
        assert 0 <= la.min() and la.max() <= 9
    assert not np.array_equal(cifar.synth_cifar(6, seed=1)[0],
                              cifar.synth_cifar(6, seed=2)[0])


@pytest.fixture(scope="module")
def smoke_run():
    """SMOKE gains chosen on 8 images, the grid weights with them, and the
    port's and the reference's logits of 4 images."""
    gains_tool = config.load_path("gains.py")
    base = config.load_path("builders/csnn.py")
    builder = config.load_path("builders/csnn_gain.py")
    cfg = csnn_vgg16.SMOKE
    net = _net(cfg)
    init = {"seed": 2022, "bias_std": 0.02, "grid_bits": 14}
    blocks = [max(1, s.channels // 4) for s in cfg.layers
              if isinstance(s, ConvSpec)]
    params = base.make_weights(net, init, 2**31 + 7, torch.device("cpu"),
                               blocks)
    from yardstick import cifar
    images = torch.from_numpy(cifar.synth_cifar(8, seed=1)[0])
    walk = gains_tool.layer_walk(params, images, net, None, 14)
    gained = builder.apply_gains(params, net, walk["gains"], 14)
    plan = plan_network(cfg, capacity=_capacities(cfg), channel_block=blocks,
                        event_par=csnn_vgg16.PLAN["event_par"])
    x = images[:4]
    got = csnn.snn_apply_batched(gained, csnn.encode_input(x, cfg), cfg,
                                 plan, collect_stats=False)
    reference = config.load_path("yardstick/reference.py")
    want = reference.forward(gained, reference.encode(x, cfg.t_steps), net)
    return walk, gained, got, want


def test_smoke_equals_reference_bit_for_bit(smoke_run):
    walk, gained, got, want = smoke_run
    assert torch.equal(got, want.logits)
    # the logits differ between inputs: no layer fell silent
    assert len({tuple(r) for r in got.tolist()}) == got.shape[0]
    assert all(d >= 0.01 for d in walk["density"]), walk["density"]
    for p in gained.values():
        for t in p.values():
            assert torch.equal(t * 2**14, torch.round(t * 2**14))


def test_gains_pick_the_share_nearest_the_target(smoke_run):
    walk = smoke_run[0]
    assert len(walk["gains"]) == 13
    assert all(-4 <= k <= 8 for k in walk["gains"])
    assert all(0.05 <= f <= 0.3 for f in walk["fired"]), walk["fired"]
