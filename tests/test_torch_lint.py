"""The port's lint (``repro_torch.analysis.lint``), self-test and CLI
(``python -m repro_torch.analysis``).

Each port rule flags its seeded source and passes its clean twin; the
ignore mechanism suppresses; the port's tree (``src/repro_torch``,
``chip_smoke.py``) is clean; the self-test flags every fixture, as many
as JAX's; the CLI exits 0 on the CPU with a JSON report naming every
port rule, and non-zero on a planted finding or on ``--device cuda``
without a card.

    PYTHONPATH=src python -m pytest -q tests/test_torch_lint.py
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.analysis import selftest as jself
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import lint as tlint
from repro_torch.analysis import selftest as tself

ROOT = Path(__file__).resolve().parents[1]
PORT_RULES = (
    "plan-block-e-divides-depth", "plan-block-e-par-aligned",
    "plan-capacity-within-fmap", "plan-queue-depth-interlaced",
    "plan-channel-block-divides", "plan-vm-tile-geometry",
    "plan-out-hw-pool", "plan-t-chunk-divides", "plan-ingest-sizing",
    "plan-smem-budget", "plan-validate-agrees", "plan-variant-valid",
    "plan-fused-handoff-boundary",
    "hazard-column-disjoint", "hazard-mask-routing", "hazard-banked-masks",
    "hazard-segment-homogeneous", "hazard-segment-replay", "oob-event-patch",
    "oob-launch-bounds",
    "kernel-shape-contract", "kernel-value-parity", "kernel-checkify",
    "kernel-sat-overflow",
    "lint-mutable-default", "lint-kernel-launch-outside-kernels",
    "lint-host-sync-in-hot-path", "lint-global-rng", "lint-reference-import",
)
HAZARD_CONSTANTS = {"hazard-column-disjoint": 4200,
                    "hazard-mask-routing": 216,
                    "hazard-segment-homogeneous": 18774,
                    "hazard-segment-replay": 162, "oob-event-patch": 30}

# (rule, file, seeded source, its clean twin)
CASES = [
    ("lint-kernel-launch-outside-kernels", "serve/fastpath.py",
     "from repro_torch.kernels import runtime\n"
     "def f():\n    return runtime.load('event_conv')\n",
     "from repro_torch.kernels.event_conv.kernel import event_conv_cuda\n"
     "def f(*a):\n    return event_conv_cuda(*a)\n"),
    ("lint-kernel-launch-outside-kernels", "tune/probe.py",
     "from repro_torch.kernels.event_conv import kernel\n"
     "def f():\n    return kernel._banked_lib()\n",
     "def f():\n    return None\n"),
    ("lint-host-sync-in-hot-path", "core/scheduler.py",
     "import torch\n"
     "def run_conv_layer_batched_chunk(x):\n"
     "    torch.cuda.synchronize()\n    return x\n",
     "def run_conv_layer_batched_chunk(x):\n    return x\n"),
    ("lint-host-sync-in-hot-path", "core/csnn.py",
     "def _place(x, device):\n    return x.to(device)\n"
     "def snn_step_chunk(x, device):\n    return _place(x, device)\n",
     "def _place(x, device):\n    return x.to(device, non_blocking=True)\n"
     "def snn_step_chunk(x, device):\n    return _place(x, device)\n"),
    ("lint-host-sync-in-hot-path", "serve/csnn_engine.py",
     "class CSNNEngine:\n    def _step(self, x):\n"
     "        return self._read(x)\n"
     "    def _read(self, x):\n        return x.tolist()\n",
     "class CSNNEngine:\n    def _step(self, x):\n"
     "        return x.to(x.dtype)\n"
     "    def _read(self, x):\n        return x.tolist()\n"),
    ("lint-host-sync-in-hot-path", "serve/engine.py",
     "class Engine:\n    def generate(self, p):\n"
     "        return self._sample(p)\n"
     "    def _sample(self, logits):\n        return logits.argmax().item()\n",
     "class Engine:\n    def generate(self, p):\n"
     "        return self._sample(p)\n"
     "    def _sample(self, logits):\n        return logits.argmax()\n"),
    ("lint-host-sync-in-hot-path", "models/transformer.py",
     "def decode_step(params, cache, batch, cfg):\n"
     "    return batch['tokens'].cpu()\n",
     "def decode_step(params, cache, batch, cfg):\n"
     "    return batch['tokens']\n"),
    ("lint-global-rng", "data/noise.py",
     "import torch\ndef f(x):\n    return x.normal_()\n",
     "import torch\ndef f(x, g):\n    return x.normal_(generator=g)\n"),
    ("lint-global-rng", "data/draw.py",
     "import torch\ndef f():\n    return torch.randint(0, 9, (3,))\n",
     "import torch\ndef f(g):\n"
     "    return torch.randint(0, 9, (3,), generator=g)\n"),
    ("lint-reference-import", "core/bridge.py",
     "import jax.numpy as jnp\n", "import numpy as np\n"),
    ("lint-mutable-default", "core/util.py",
     "def f(x, acc=[]):\n    return acc\n",
     "def f(x, acc=None):\n    return acc\n"),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}:{c[1]}")
def test_rule_flags_its_fixture_and_passes_its_twin(case):
    rule, fname, bad, good = case
    rep = tlint.lint_source(bad, fname)
    assert rule in {f.rule for f in rep.findings}, rep.summary()
    rep = tlint.lint_source(good, fname)
    assert rep.ok, rep.summary()


def test_launch_inside_kernels_and_sync_outside_hot_path_are_fine():
    src = "import ctypes\ndef f():\n    return ctypes.CDLL('x.so')\n"
    assert tlint.lint_source(src, "src/repro_torch/kernels/runtime.py").ok
    # .item() in a function no hot root reaches
    src = "def summary(x):\n    return x.item()\n"
    assert tlint.lint_source(src, "core/csnn.py").ok


def test_ignore_mechanism_suppresses():
    src = ("import torch\n"
           "def f():\n"
           "    # a throwaway draw  # analysis: ignore[lint-global-rng]\n"
           "    return torch.rand(3)\n")
    rep = tlint.lint_source(src, "core/x.py")
    assert rep.ok and rep.checked["lint-global-rng"] == 1
    src = src.replace("lint-global-rng", "lint-mutable-default")
    assert not tlint.lint_source(src, "core/x.py").ok


def test_hot_units_follow_the_call_graph():
    import ast
    trees = {str(p.relative_to(ROOT)): ast.parse(p.read_text())
             for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))}
    hot = tlint.hot_units(trees)
    assert "run_conv_layer_batched_chunk" in hot[
        "src/repro_torch/core/scheduler.py"]
    assert {"event_conv_cuda_batched", "_launch"} <= hot[
        "src/repro_torch/kernels/event_conv/kernel.py"]
    assert "threshold_pool_cuda_emit" in hot[
        "src/repro_torch/kernels/threshold_pool/kernel.py"]
    assert not hot["src/repro_torch/tune/measure.py"]


def test_lm_decode_roots_reach_the_blocks():
    """The LM decode loop's roots reach every block a decode step runs."""
    import ast
    trees = {str(p.relative_to(ROOT)): ast.parse(p.read_text())
             for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))}
    hot = tlint.hot_units(trees)
    models = "src/repro_torch/models/"
    assert {"Engine.generate", "Engine._sample"} <= hot[
        "src/repro_torch/serve/engine.py"]
    assert {"decode_step", "_decode_layer", "embed_tokens", "_ffn"} <= hot[
        models + "transformer.py"]
    assert {"decode_step", "_decoder_layer"} <= hot[models + "encdec.py"]
    assert {"gqa_decode", "mla_decode", "cross_forward", "_gqa_attend"} <= hot[
        models + "attention.py"]
    assert {"moe_forward", "mlp_forward", "top_k_stable"} <= hot[models + "ffn.py"]
    assert "single_step" in hot[models + "linear_attn.py"]
    assert {"time_mix_decode", "channel_mix_decode"} <= hot[models + "rwkv.py"]
    assert "mamba2_decode" in hot[models + "ssm.py"]
    assert "prefill" not in hot[models + "transformer.py"]


def test_lm_training_roots_reach_the_step():
    """The training loop's roots reach the step, the loss, its blocks,
    the update and the checkpoint calls ``run`` makes; ``run``'s log-step
    loss read and the checkpoint's host copies are the suppressed syncs."""
    import ast
    trees = {str(p.relative_to(ROOT)): ast.parse(p.read_text())
             for p in sorted((ROOT / "src" / "repro_torch").rglob("*.py"))}
    hot = tlint.hot_units(trees)
    src = "src/repro_torch/"
    assert {"run", "make_train_step", "value_and_grad"} <= hot[src + "train/loop.py"]
    assert {"adamw_update", "clip_by_global_norm", "lr_at"} <= hot[
        src + "train/optimizer.py"]
    assert {"loss_fn", "forward", "_unit", "apply_layer"} <= hot[
        src + "models/transformer.py"]
    assert {"loss_fn", "encode", "_maybe_remat"} <= hot[src + "models/encdec.py"]
    assert {"chunked_softmax_ce", "_ce_chunk", "clip"} <= hot[
        src + "models/common.py"]
    assert {"save", "restore"} <= hot[src + "checkpoint/ckpt.py"]
    rep = tlint.run_lint([ROOT / "src" / "repro_torch" / "train",
                          ROOT / "src" / "repro_torch" / "checkpoint"])
    assert rep.ok, rep.summary()
    loop = (ROOT / "src/repro_torch/train/loop.py").read_text()
    assert "analysis: ignore[lint-host-sync-in-hot-path]" in loop
    stripped = loop.replace("# analysis: ignore[lint-host-sync-in-hot-path]", "")
    assert not tlint.lint_source(
        stripped, "src/repro_torch/train/loop.py", hot={"run"}).ok


def test_port_tree_is_clean():
    rep = tlint.run_lint()
    assert rep.ok, rep.summary()
    for rule in ("lint-mutable-default", "lint-kernel-launch-outside-kernels",
                 "lint-host-sync-in-hot-path", "lint-global-rng",
                 "lint-reference-import"):
        assert rep.checked[rule] >= 1, rule


def test_selftest_flags_every_fixture():
    rep = tself.run_selftest()
    assert rep.ok, rep.summary()
    jrep = jself.run_selftest()
    assert jrep.ok
    assert rep.checked["selftest-seeded"] == jrep.checked["selftest-seeded"]


def test_cli_cpu_report_names_every_port_rule(tmp_path):
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--device", "cpu",
         "--selftest", "--json", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(out.read_text())
    assert rep["ok"] and rep["n_findings"] == 0
    for rule in PORT_RULES:
        assert rep["obligations"].get(rule, 0) >= 1, rule
    for rule, n in HAZARD_CONSTANTS.items():
        assert rep["obligations"][rule] == n, rule
    assert rep["obligations"]["selftest-seeded"] == 30


def test_cli_planted_finding_exits_nonzero(tmp_path, monkeypatch, capsys):
    bad = tmp_path / "bad.py"
    bad.write_text("import jax\n")
    monkeypatch.setattr(tlint, "_default_paths", lambda: [bad])
    assert cli.main(["--only", "lint", "--device", "cpu"]) == 1
    assert "lint-reference-import" in capsys.readouterr().out


def test_cli_cuda_without_a_card_exits_nonzero(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--only", "lint", "--device", "cuda"]) != 0
