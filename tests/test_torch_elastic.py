"""Elastic failover on gloo ranks, the port's counterpart of the JAX
package's shrink-and-resume scenario, and sharded checkpoints crossing
both packages.

Tiny stablelm trains on a (4, 2) mesh of 8 ranks through ``train.loop.run``
with the fault policy; host h1 goes silent after step 2, the policy asks
for a remesh at step 3, the loop saves a sharded checkpoint, the planner
picks a (2, 2) mesh of the 4 surviving ranks, which start a new process
group, restore onto it (bit for bit) and train 3 more steps.  The losses
equal the port's unsharded run of the same 7 steps.  A checkpoint JAX
writes from a forced (4, 2) mesh restores onto the port's (2, 2) mesh,
and one the port writes from (4, 2) restores in JAX, bit for bit."""
import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from torch_lm_ref import finish, start_jax, start_ranks

TREE = """
def tree_np():
    return {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8),
            "b": np.arange(8.0, dtype=np.float32) - 3.5,
            "h": (np.arange(32.0, dtype=np.float32).reshape(8, 4) / 7)
            .astype(ml_dtypes.bfloat16),
            "step": np.int32(5)}
"""

JAX_SAVE = TREE + """
import ml_dtypes, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import ckpt
mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(4, 2), ("data", "model"))
sh = {"w": P("data", "model"), "b": P("model"), "h": P("data", None), "step": P()}
t = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, sh[k]))
     for k, v in tree_np().items()}
ckpt.save(t, OUT / "jax_ckpt.tmpdir", step=1)
(OUT / "jax_ckpt.tmpdir").rename(OUT / "jax_ckpt")
"""

JAX_RESTORE = TREE + """
import ml_dtypes, numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import ckpt
mesh = jax.sharding.Mesh(np.asarray(jax.devices()).reshape(2, 4), ("data", "model"))
want = tree_np()
sh = {"w": NamedSharding(mesh, P("model", "data")), "b": NamedSharding(mesh, P()),
      "h": NamedSharding(mesh, P(None, "model")), "step": NamedSharding(mesh, P())}
tmpl = {k: jnp.zeros(np.shape(v), np.asarray(v).dtype) for k, v in want.items()}
got, step = ckpt.restore(tmpl, OUT / "port_ckpt", shardings=sh)
assert step == 1
for k, v in want.items():
    a = np.asarray(got[k])
    assert a.dtype == np.asarray(v).dtype, (k, a.dtype)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  np.asarray(v).reshape(-1).view(np.uint8))
print("JAX_RESTORE_OK")
"""

RANKS = TREE + """
import dataclasses, time
import ml_dtypes
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint import ckpt
from repro_torch.configs import LM_ARCHS
from repro_torch.data.synthetic import ShardedBatcher, TokenStream
from repro_torch.launch.mesh import make_custom_mesh
from repro_torch.models.registry import build_model
from repro_torch.runtime.health import (ElasticPlanner, FaultPolicy,
                                        HeartbeatTracker, StragglerDetector)
from repro_torch.sharding.specs import (NamedSharding, PartitionSpec as P,
                                        default_rules, set_constraint_mesh,
                                        shard_tree)
from repro_torch.train import optimizer as opt
from repro_torch.train.loop import LoopConfig, run, state_shardings

def full(tree):
    return [(t.full_tensor() if isinstance(t, DTensor) else torch.as_tensor(t)).numpy()
            for t in opt.tree_leaves([tree.step, tree.params, tree.mu, tree.nu])]

def torch_tree(mesh, sh):
    t = {k: torch.from_numpy(v) for k, v in tree_np().items() if k in ("w", "b")}
    t["h"] = torch.from_numpy(tree_np()["h"].view(np.int16)).view(torch.bfloat16)
    t = shard_tree(t, {k: NamedSharding(mesh, s) for k, s in sh.items()})
    t["step"] = 5
    return t

cfg = dataclasses.replace(LM_ARCHS["stablelm-3b"].SMOKE, n_layers=2, d_model=64,
                          n_heads=4, n_kv_heads=4, d_ff=128, vocab=256)
model = build_model(cfg)
ts = TokenStream(vocab=256, seed=0)
ocfg = opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20)
rules = default_rules()
ck = str(OUT / "ckpt")

# phase 1: 2 hosts x 4 ranks = a (4, 2) mesh
mesh_a = make_custom_mesh((4, 2), ("data", "model"), "cpu")
set_constraint_mesh(mesh_a, rules)
ckpt.save(torch_tree(mesh_a, {"w": P("data", "model"), "b": P("model"),
                              "h": P("data", None)}), OUT / "port_ckpt", step=1)
data_a = ShardedBatcher(ts, 8, 32, device="cpu", mesh=mesh_a)
clock = [0.0]
hb = HeartbeatTracker(["h0", "h1"], timeout=1.5, clock=lambda: clock[0])
policy = FaultPolicy(hb, StragglerDetector(),
                     ElasticPlanner(model_parallel=2, pod_size=1024),
                     devices_per_host=4)

def feed(step):
    clock[0] += 1.0
    hb.beat("h0")
    hb.beat("h1" if step < 2 else "h0")   # h1 goes silent after step 2
    return data_a(step)

plans = []
state, hist = run(model, feed, LoopConfig(total_steps=20, ckpt_every=1000,
                                          log_every=1, ckpt_dir=ck),
                  ocfg, torch.Generator().manual_seed(0), policy=policy,
                  on_remesh=plans.append, device="cpu", mesh=mesh_a, rules=rules)
assert [e.kind for e in policy.events] == ["dead_host"], policy.events
assert ckpt.latest_step(ck) == 4 == state.step, (ckpt.latest_step(ck), state.step)
before = full(state)
losses = [h["loss"] for h in hist]
set_constraint_mesh(None)
dist.destroy_process_group()
if RANK >= 4:           # the silent host's ranks leave
    sys.exit(0)

# phase 2: the 4 surviving ranks form the planned mesh, restore, continue
(plan,) = plans
assert plan.devices_used == 4 and plan.shape == (2, 2), plan
init(OUT / "store_b", 4)
mesh_b = make_custom_mesh(plan.shape, plan.axes, "cpu")
set_constraint_mesh(mesh_b, rules)
template = opt.abstract_state(model.abstract_params(torch.float32), ocfg)
restored, at = ckpt.restore(template, ck, shardings=state_shardings(model, mesh_b, rules))
after = full(restored)
data_b = ShardedBatcher(ts, 8, 32, device="cpu", mesh=mesh_b)
state_b, hist_b = run(model, data_b, LoopConfig(total_steps=at + 3, ckpt_every=1000,
                                                log_every=1, ckpt_dir=ck),
                      ocfg, torch.Generator().manual_seed(0), device="cpu",
                      mesh=mesh_b, rules=rules)
losses += [h["loss"] for h in hist_b]
jax_dir = OUT.parent / "jax" / "jax_ckpt"
deadline = time.monotonic() + 90
while not jax_dir.exists() and time.monotonic() < deadline:
    time.sleep(0.2)
tmpl = {"w": torch.zeros(8, 8), "b": torch.zeros(8),
        "h": torch.zeros(8, 4, dtype=torch.bfloat16), "step": 0}
sh = {"w": P("model", "data"), "b": P(None), "h": P("data", None), "step": P()}
got, step = ckpt.restore(tmpl, jax_dir, shardings={k: NamedSharding(mesh_b, s)
                                                   for k, s in sh.items()})
xfer = {k: (v.full_tensor() if isinstance(v, DTensor) else torch.as_tensor(v))
        for k, v in got.items()}
xfer = {k: (v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy())
        for k, v in xfer.items()}
np.savez(OUT / f"r{RANK}.npz", losses=np.asarray(losses), at=at, steps=state_b.step,
         **{f"before{i}": a for i, a in enumerate(before)},
         **{f"after{i}": a for i, a in enumerate(after)},
         **{f"jax_{k}": v for k, v in xfer.items()})
"""


def _tiny():
    from repro_torch.configs import LM_ARCHS
    from repro_torch.models.registry import build_model
    return build_model(dataclasses.replace(
        LM_ARCHS["stablelm-3b"].SMOKE, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256))


@pytest.fixture(scope="module")
def elastic(tmp_path_factory):
    root = tmp_path_factory.mktemp("elastic")
    finish([start_jax(JAX_SAVE, 8, root / "jax"), start_ranks(RANKS, 8, root / "r")])
    started = start_jax(JAX_RESTORE, 8, root / "r")
    # the port's unsharded run of the same 7 steps, while JAX restores
    from repro_torch.data.synthetic import ShardedBatcher, TokenStream
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import LoopConfig, run
    _, hist = run(_tiny(), ShardedBatcher(TokenStream(vocab=256, seed=0), 8, 32,
                                          device="cpu"),
                  LoopConfig(total_steps=7, log_every=1),
                  opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=20),
                  torch.Generator().manual_seed(0), device="cpu")
    out = finish([started], timeout=60)
    ranks = [dict(np.load(root / "r" / f"r{r}.npz")) for r in range(4)]
    return {"ranks": ranks, "plain": [h["loss"] for h in hist], "jax_out": out[0]}


def test_remesh_keeps_the_state_bitwise(elastic):
    for r in elastic["ranks"]:
        assert int(r["at"]) == 4 and int(r["steps"]) == 7
        n = len([k for k in r if k.startswith("before")])
        assert n == len([k for k in r if k.startswith("after")]) > 10
        for i in range(n):
            a, b = r[f"before{i}"], r[f"after{i}"]
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8)), i


def test_sharded_losses_equal_unsharded(elastic):
    # ``run`` logs no loss for the step at which it remeshes (step 4), as
    # JAX's loop: steps 1-3 on (4, 2), then 5-7 on (2, 2)
    plain = np.asarray(elastic["plain"])[[0, 1, 2, 4, 5, 6]]
    for r in elastic["ranks"]:
        assert r["losses"].shape == (6,)
        np.testing.assert_allclose(r["losses"], plain, rtol=1e-5)
        np.testing.assert_array_equal(r["losses"], elastic["ranks"][0]["losses"])
    assert np.all(np.isfinite(plain))


def test_jax_checkpoint_restores_onto_the_port_mesh(elastic):
    want = {"w": np.arange(64.0, dtype=np.float32).reshape(8, 8),
            "b": np.arange(8.0, dtype=np.float32) - 3.5,
            "h": (np.arange(32.0, dtype=np.float32).reshape(8, 4) / 7)
            .astype(ml_dtypes.bfloat16).view(np.int16), "step": np.int32(5)}
    for r in elastic["ranks"]:
        for k, v in want.items():
            np.testing.assert_array_equal(r[f"jax_{k}"], v)
            assert r[f"jax_{k}"].dtype == np.asarray(v).dtype or k == "step"


def test_port_checkpoint_restores_in_jax(elastic):
    assert "JAX_RESTORE_OK" in elastic["jax_out"]
