"""The port's cost model and dry run (``repro_torch.launch.op_cost``,
``roofline``, ``dryrun``): exact counts of products and collectives, a
reduced architecture's train step through the dry-run path on a fake 4x4
mesh, and its 1x1 FLOPs against JAX's ``HloCostModel`` of the same step
compiled on one CPU device."""
import gzip
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.op_cost import OpCost

MINI = ShapeConfig("mini", 256, 8, "train")


def test_counts_every_iteration_of_a_loop():
    a = torch.randn(32, 32)
    with OpCost() as cost:
        x = a
        for _ in range(3):
            x = torch.tanh(x @ a)
    assert cost.flops_by_dtype == {torch.float32: 3 * 2 * 32 ** 3}
    assert cost.table["mm"][0] == 3
    assert cost.bytes == 3 * 3 * 32 * 32 * 4   # two operands + the output


def test_bf16_products_and_gathers():
    w = torch.randn(64, 8, dtype=torch.bfloat16)
    idx = torch.tensor([1, 5, 7])
    with OpCost() as cost:
        y = torch.randn(4, 3, 64, dtype=torch.bfloat16) @ w   # a bmm-free matmul
        e = w[idx]
    assert cost.flops_by_dtype == {torch.bfloat16: 2 * 12 * 8 * 64}
    assert cost.table["index"][2] == 2 * e.numel() * 2
    assert y.shape == (4, 3, 8)


def test_all_reduce_wire_bytes():
    from repro_torch.launch.mesh import make_custom_mesh
    from repro_torch.sharding.collectives import psum
    with dryrun.fake_world(4):
        mesh = make_custom_mesh((4,), ("data",), "cpu")
        with OpCost() as cost:
            psum(torch.ones(16), mesh, "data")
    assert [(k, b, list(r)) for k, b, r in cost.collectives] == \
        [("all-reduce", 64, [0, 1, 2, 3])]
    stats = roofline.collective_bytes(cost.collectives, 4)
    assert stats.wire_bytes == 2 * 64 * 3 / 4
    assert stats.counts == {"all-reduce": 1}
    assert stats.seconds == stats.wire_bytes / roofline.NVLINK_BW


def test_link_rate_and_ring_multipliers():
    assert roofline.link_rate(range(8)) == roofline.NVLINK_BW
    assert roofline.link_rate(range(8, 16)) == roofline.NVLINK_BW
    assert roofline.link_rate([0, 16, 32]) == roofline.NET_BW
    assert roofline.link_rate(range(4, 12)) == roofline.NET_BW
    assert roofline.wire_bytes("all-gather", 80, 4) == 60
    assert roofline.wire_bytes("reduce-scatter", 10, 4) == 30
    assert roofline.wire_bytes("collective-permute", 10, 2) == 10
    assert roofline.wire_bytes("all-reduce", 10, 1) == 0


def test_analyze_takes_each_dtype_at_its_peak():
    cost = OpCost()
    cost.flops_by_dtype = {torch.float32: 67e12, torch.bfloat16: 989e12}
    cost.bytes = 3.35e12
    roof = roofline.analyze(cost, 2, model_flops=1e12)
    assert roof.t_compute == pytest.approx(2.0) and roof.t_memory == pytest.approx(1.0)
    assert roof.bottleneck == "compute" and roof.t_collective == 0.0
    cost.flops_by_dtype = {torch.int8: 1.0}
    with pytest.raises(ValueError, match="no H100 peak"):
        roofline.analyze(cost, 1)


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    c44 = dryrun.run_cell("stablelm-3b", "mini", "4x4", out, verbose=False,
                          mesh_override=((4, 4), ("data", "model")),
                          shape_override=MINI, smoke=True, save_hlo=True)
    c11 = dryrun.run_cell("stablelm-3b", "mini", "1x1", out, verbose=False,
                          mesh_override=((1, 1), ("data", "model")),
                          shape_override=MINI, smoke=True)
    return out, c44, c11


def test_dryrun_cell_on_a_fake_4x4_mesh(cells):
    out, c44, _ = cells
    assert c44["status"] == "ok", c44.get("traceback")
    roof = c44["roofline"]
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert roof["bottleneck"] in ("compute", "memory", "collective")
    assert roof["n_devices"] == 16 and roof["wire_bytes_per_device"] > 0
    assert set(roof["collectives"]["counts"]) <= {"all-gather", "all-reduce",
                                                  "reduce-scatter", "all-to-all"}
    # each explicit redistribution the step needed is on record
    assert c44["redistributions"] and all(
        r["rule"] in ("view", "pad", "flip", "index", "index_put") and r["count"] > 0
        for r in c44["redistributions"])
    on_disk = json.loads((out / "stablelm-3b__mini__4x4__baseline.json").read_text())
    assert on_disk == json.loads(json.dumps(c44))
    with gzip.open(out / "stablelm-3b__mini__4x4__baseline.ops.json.gz", "rt") as fh:
        rows = json.load(fh)
    assert rows[0]["flops"] + rows[0]["bytes"] >= rows[-1]["flops"] + rows[-1]["bytes"]
    assert any(r["op"] == "mm" for r in rows)


def test_dryrun_1x1_flops_against_jax_hlo_cost(cells):
    """One device, the same step (loss, gradients, AdamW): the port's counted
    products within 10 % of JAX's HLO walk.  The port counts 8.1 % fewer,
    all in the output products of the cross entropy: JAX pads the 255
    predicting positions to a chunk of 512 and runs three products over it
    (the forward, two in the backward); the port runs four over the 255 (its
    checkpointed chunk recomputes the forward)."""
    from repro.configs import ARCHS
    from repro.launch.hlo_cost import HloCostModel
    from repro.models.registry import build_model
    from repro.train import optimizer as opt
    _, _, c11 = cells
    assert c11["status"] == "ok", c11.get("traceback")
    model = build_model(ARCHS["stablelm-3b"].SMOKE)
    ocfg = opt.AdamWConfig()
    state = opt.abstract_state(model.abstract_params(jnp.float32), ocfg)
    batch = model.input_specs(MINI)

    def step(st, b):
        (loss, _), g = jax.value_and_grad(lambda p: model.loss(p, b),
                                          has_aux=True)(st.params)
        return opt.adamw_update(st, g, ocfg), loss

    hlo = jax.jit(step).lower(state, batch).compile().as_text()
    want = HloCostModel(hlo, 1).entry_cost().flops
    got = c11["roofline"]["flops_per_device"]
    assert abs(got - want) / want < 0.10, (got, want)
    assert c11["roofline"]["wire_bytes_per_device"] == 0


def test_dryrun_failing_cell_is_an_error_record(tmp_path, monkeypatch):
    with dryrun.fake_world(2):  # a running group: the cell cannot start its own
        cell = dryrun.run_cell("stablelm-3b", "mini", "1x1", tmp_path, verbose=False,
                               mesh_override=((1, 1), ("data", "model")),
                               shape_override=MINI, smoke=True)
    assert cell["status"] == "error" and "process group" in cell["error"]
    assert dryrun.run_cell("stablelm-3b", "long_500k", "single", tmp_path,
                           verbose=False)["status"] == "skipped"
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: {"status": "error"})
    assert dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k"]) == 1
    monkeypatch.setattr(dryrun, "run_cell", lambda *a, **k: {"status": "ok"})
    assert dryrun.main(["--arch", "gemma3-1b", "--shape", "train_4k"]) == 0
