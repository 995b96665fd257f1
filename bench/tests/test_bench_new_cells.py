"""The cell ``vgg16-cifar-offline-b256`` on the CPU, cut to sizes the CPU
runs in seconds: through ``harness.cell.run_cell`` it comes out correct
with its metrics, and with one answer altered where the program produces
it comes out not correct.

    python -m pytest -q bench/tests/test_bench_new_cells.py
"""
import time

import pytest
import torch

from harness import cell as cellmod
from harness import config
from harness import trace as tracemod
from harness.controls import patched

CPU = torch.device("cpu")


def tiny_vgg(monkeypatch) -> config.Cell:
    """VGG's 13 convs and 5 pools at 1/16 of the widths on 16x16 images
    (SMOKE's layers), gains chosen on the cut network by ``gains.py``;
    the port's registered network is cut the same way for the run, so the
    builder's check still holds it to the file."""
    from repro_torch.configs import csnn_vgg16
    cell = config.load_cell("vgg16-cifar-offline-b256")
    conf, net = cell.config, cell.config["network"]
    net["input_hw"] = [16, 16]
    for layer in net["layers"][:-1]:
        layer["conv"] //= 16
    blocks = [max(1, layer["conv"] // 4) for layer in net["layers"][:-1]]
    caps, hw = [], 16
    for layer in net["layers"][:-1]:
        caps.append(hw * hw)
        hw = -(-hw // layer.get("pool", 1))
    conf["plan"].update(capacity=caps, channel_block=blocks)
    cell.traffic["inputs"]["pool"] = 32
    cell.traffic["batch"] = 8
    base = config.load_path("builders/csnn.py")
    gains = config.load_path("gains.py")
    params = base.weights(conf, 0, CPU)
    pool = config.load_module("generators", "synth_cifar").generate(
        cell.traffic["inputs"], net)
    walk = gains.layer_walk(params, pool.data[:8], net, None,
                            conf["init"]["grid_bits"])
    conf["init"]["gain_log2"] = walk["gains"]
    monkeypatch.setattr(csnn_vgg16, "FULL",
                        base.program_config(net))
    monkeypatch.setattr(csnn_vgg16, "PLAN", conf["plan"])
    monkeypatch.setattr(csnn_vgg16, "GAIN_LOG2", tuple(walk["gains"]))
    return cell


@pytest.fixture
def quick(monkeypatch):
    monkeypatch.setattr(tracemod, "TRACE_S", 0.2)  # the CPU profiles slowly


def _run(cell, trace: bool, seconds: float):
    return cellmod.run_cell(cell, 2**31 + 11, seconds, trace, CPU,
                            time.perf_counter())


def test_new_files_are_found_by_name():
    vgg = config.load_cell("vgg16-cifar-offline-b256")
    assert vgg.traffic["loop"] == "offline"
    assert vgg.traffic["inputs"]["generator"] == "synth_cifar"
    assert config.load_module("loops", "offline").run
    assert config.load_module("generators", "synth_cifar").generate
    assert "samples_per_s" in {m["name"] for m in vgg.end_to_end}
    assert "idle_share" in {m["name"] for m in vgg.per_layer}
    assert config.load_path(vgg.config["builder"]).weights
    assert "patch_gather_share" in {m["name"] for m in vgg.per_layer}
    assert config.load_module("metrics", "patch_gather_share").read


def test_vgg_cell_is_correct(monkeypatch, quick):
    """Untraced: the CPU profiler takes minutes over the plain path's
    operations of 13 layers (the traced offline loop is the paper cell's,
    run traced in ``test_bench_harness``)."""
    cell = tiny_vgg(monkeypatch)
    result, _, run = _run(cell, False, 6.0)
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 8
    # samples_per_s needs a batch answered inside the window, which a
    # loaded host may not reach
    assert "setup_s" in result["metrics"]
    assert set(result["metrics"]) <= {"samples_per_s", "setup_s"}
    # the network is alive: its answers differ from row to row
    by_row = {int(r): tuple(g.tolist()) for rows, logits in run.answers
              for r, g in zip(rows, logits)}
    assert len(set(by_row.values())) > len(by_row) // 2


def test_vgg_cell_with_an_answer_altered_is_not_correct(monkeypatch, quick):
    cell = tiny_vgg(monkeypatch)
    with patched("altered", cell.config["network"]):
        result, _, _ = _run(cell, False, 0.6)
    assert result["correct"] is False
    assert result["checks"]["differ_pct"]["value"] > 0
