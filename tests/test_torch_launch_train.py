"""The port's training and LM example launchers with ``--device cpu``:
``launch.train`` (``--smoke``; ``--mesh single|multi`` refused),
``launch.lm_train`` (the counterpart of ``examples/lm_train.py``) and
``launch.lm_serve`` (of ``examples/lm_serve.py``): their lines as the JAX
scripts print them."""


def test_launch_train_smoke_cpu(capsys):
    from repro_torch.launch import train
    assert train.main(["--smoke", "--device", "cpu", "--steps", "10",
                       "--batch", "2", "--seq", "32"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "stablelm-smoke: 0.2M params"
    assert [ln.split()[1] for ln in out[1:]] == ["1", "10"]


def test_launch_train_production_mesh_exits(capsys):
    from repro_torch.launch import train
    assert train.main(["--mesh", "multi", "--device", "cpu"]) == 2
    assert "production mesh" in capsys.readouterr().err


def test_launch_lm_train(tmp_path, capsys):
    from repro_torch.launch import lm_train
    args = ["--device", "cpu", "--steps", "2", "--ckpt-dir", str(tmp_path)]
    assert lm_train.main(args) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "model: stablelm-smoke scaled to 1.6M params"
    assert [ln.split()[1] for ln in out[1:-1]] == ["1"]   # logs every 20th
    assert out[-1] == f"final step: 2; checkpoints in {tmp_path}"


def test_launch_lm_serve_cpu(capsys):
    from repro_torch.launch import lm_serve
    assert lm_serve.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("serving gemma3-smoke: 0.18M params, sliding window 16")
    assert len([ln for ln in out if ln.startswith("  request ")]) == 4
    assert out[-1] == "batched decode OK (4 requests x 16 tokens)"
