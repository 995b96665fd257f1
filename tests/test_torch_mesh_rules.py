"""The port's sharding rules (``repro_torch.sharding.specs``) against
JAX's live ``resolve`` on an ``AbstractMesh``: every parameter, optimizer
state, cache and input leaf of the ten LM architectures (SMOKE and FULL),
on the (1, 1), (4, 4), (16, 16) and (2, 16, 16) meshes, under the train,
decode and long-context rules; the DTensor placements of the shardings
on fake process groups; ``constrain`` and ``MeshMode``'s view rule."""
import contextlib

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import ARCHS as JARCHS
from repro.models.common import is_spec
from repro.models.registry import build_model as jbuild
from repro.sharding import specs as jspecs
from repro.train import optimizer as jopt
from repro_torch.configs import LM_ARCHS, SHAPES
from repro_torch.models import common as tcommon
from repro_torch.models.registry import build_model as tbuild
from repro_torch.sharding import mesh_mode, specs
from repro_torch.train import optimizer as topt

MESHES = {(1, 1): ("data", "model"), (4, 4): ("data", "model"),
          (16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model")}
RULES = {"train": {}, "decode": {"phase": "decode"},
         "long": {"phase": "decode", "long_context": True}}


def _jax_leaves(tree):
    return jax.tree_util.tree_leaves(tree, is_leaf=lambda x: is_spec(x) or (
        isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)))


def _cases(arch: str, size: str):
    """[(what, logical axes, shape)] of one model on both sides, checked
    to agree leaf by leaf."""
    jm = jbuild(getattr(JARCHS[arch], size))
    tm = tbuild(getattr(LM_ARCHS[arch], size))
    js = _jax_leaves(jm.specs)
    ts = tcommon.tree_leaves(tm.specs)
    assert [(s.shape, s.axes) for s in ts] == [(s.shape, s.axes) for s in js]
    out = [("param", s.axes, s.shape) for s in ts]
    # the optimizer state shards as the parameters (both packages)
    jst = jopt.state_logical_axes(jm.logical_axes())
    tst = topt.state_logical_axes(tm.logical_axes())
    assert tst.step == jst.step == ()
    for f in ("params", "mu", "nu"):
        assert tcommon.tree_leaves(getattr(tst, f), is_leaf=specs._is_axes) == \
            _jax_leaves(getattr(jst, f))
    shape = SHAPES["decode_32k"]
    cache, cache_axes = tm.cache_structure(shape.global_batch, 4096, abstract=True)
    jcache, jcache_axes = jm.cache_structure(shape.global_batch, 4096, abstract=True)
    t_leaves = tcommon.tree_leaves(cache, is_leaf=torch.is_tensor)
    ta_leaves = tcommon.tree_leaves(cache_axes, is_leaf=specs._is_axes)
    assert [tuple(t.shape) for t in t_leaves] == \
        [tuple(s.shape) for s in jax.tree_util.tree_leaves(jcache)]
    assert ta_leaves == _jax_leaves(jcache_axes)
    out += [("cache", a, tuple(t.shape)) for a, t in zip(ta_leaves, t_leaves)]
    for name in ("train_4k", "decode_32k"):
        sh = SHAPES[name]
        axes = tm.input_axes(sh)
        assert axes == jm.input_axes(sh)
        for k, (s, _) in tm.input_specs(sh).items():
            out.append(("input", axes[k], s))
    return out


@pytest.mark.parametrize("size", ["SMOKE", "FULL"])
@pytest.mark.parametrize("arch", sorted(LM_ARCHS))
def test_resolve_is_jax_on_every_leaf(arch, size):
    cases = _cases(arch, size)
    for mesh_shape, names in MESHES.items():
        amesh = AbstractMesh(mesh_shape, names)
        sizes = dict(zip(names, mesh_shape))
        for kw in RULES.values():
            rules, jrules = specs.default_rules(**kw), jspecs.default_rules(**kw)
            assert rules == jrules
            for what, axes, shape in cases:
                got = specs.resolve(axes, shape, rules, sizes)
                want = jspecs.resolve(axes, shape, jrules, amesh)
                assert tuple(got) == tuple(want), (what, axes, shape, mesh_shape)


def test_resolve_edge_cases():
    sizes = {"data": 4, "model": 4}
    rules = specs.default_rules()
    assert specs.resolve(None, (8,), rules, sizes) == specs.PartitionSpec()
    # 6 heads do not split 4 ways; "pod" is absent; "model" is not reused
    assert specs.resolve(("heads", "embed"), (6, 8), rules, sizes) == (None, "data")
    assert specs.resolve(("vocab", "mlp"), (8, 8), rules, sizes) == ("model", None)
    assert specs.resolve(("batch", None), (8, 3),
                         rules, {"pod": 2, "data": 4}) == (("pod", "data"), None)
    assert repr(specs.PartitionSpec("data", None)) == "PartitionSpec('data', None)"


@contextlib.contextmanager
def fake_mesh(shape, names):
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_custom_mesh
    with fake_world(int(np.prod(shape))):
        yield make_custom_mesh(shape, names, "cpu")


@pytest.mark.parametrize("mesh_shape", [(4, 4), (2, 16, 16)])
def test_tree_shardings_placements(mesh_shape):
    """A TrainState of shardings over every FULL architecture's state: each
    mesh dim shards the tensor dim the spec names it on, or replicates."""
    from torch.distributed.tensor import Replicate, Shard
    names = MESHES[mesh_shape]
    rules = specs.default_rules()
    with fake_mesh(mesh_shape, names) as mesh:
        for arch in sorted(LM_ARCHS):
            m = tbuild(LM_ARCHS[arch].FULL)
            state = topt.abstract_state(m.abstract_params(torch.float32),
                                        topt.AdamWConfig())
            sh = specs.tree_shardings(
                mesh, topt.state_logical_axes(m.logical_axes()), state, rules)
            assert isinstance(sh, topt.TrainState)
            assert sh.step.placements == (Replicate(),) * len(names)
            axes = tcommon.tree_leaves(m.logical_axes(), is_leaf=specs._is_axes)
            for f in ("params", "mu", "nu"):
                leaves = tcommon.tree_leaves(getattr(sh, f),
                                             is_leaf=lambda x: isinstance(
                                                 x, specs.NamedSharding))
                tensors = tcommon.tree_leaves(getattr(state, f),
                                              is_leaf=torch.is_tensor)
                for s, a, t in zip(leaves, axes, tensors, strict=True):
                    want = jspecs.resolve(a, tuple(t.shape), rules,
                                          AbstractMesh(mesh_shape, names))
                    assert tuple(s.spec) == tuple(want)
                    for i, ax in enumerate(names):
                        dims = [d for d, e in enumerate(want) if e == ax or
                                (isinstance(e, tuple) and ax in e)]
                        assert s.placements[i] == (Shard(dims[0]) if dims
                                                   else Replicate())


def test_shard_tree_and_constrain():
    """shard_tree keeps each rank's block (rank 0 here), constrain is a
    no-op without a mesh, redistributes a DTensor with one and refuses a
    plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = torch.arange(64.0).reshape(8, 8)
    assert specs.constrain(x, ("batch", None)) is x
    with fake_mesh((4, 4), ("data", "model")) as mesh:
        sh = specs.NamedSharding(mesh, specs.resolve(("batch", "vocab"), (8, 8),
                                                     specs.default_rules(), mesh))
        d = specs.put(x, sh)
        assert isinstance(d, DTensor) and d.placements == (Shard(0), Shard(1))
        assert torch.equal(d.to_local(), x[:2, :2])
        tree = specs.shard_tree({"a": x, "n": 3}, {"a": sh, "n": specs.replicated(mesh)})
        assert tree["n"] == 3 and torch.equal(tree["a"].to_local(), x[:2, :2])
        specs.set_constraint_mesh(mesh, specs.default_rules())
        try:
            with pytest.raises(TypeError, match="plain tensor"):
                specs.constrain(x, ("batch", None))
            c = specs.constrain(d, ("batch", None))
            assert c.placements == (Shard(0), Replicate())
            assert specs.constrain(c, ("batch", None)) is c
        finally:
            specs.set_constraint_mesh(None)
        with pytest.raises(ValueError, match="mesh order"):
            specs.NamedSharding(mesh, specs.PartitionSpec(("model", "data"))).placements


def test_mesh_mode_gathers_an_uneven_view():
    from torch.distributed.tensor import Replicate, Shard
    sizes = (4, 4)
    S, R = Shard, Replicate
    # (B*S, 4 heads * 8) with the columns over 4: 2 heads do not split
    assert mesh_mode.uneven_view_dims((16, 64), (S(0), S(1)), sizes, [16, 2, 32]) == [1]
    assert mesh_mode.uneven_view_dims((16, 64), (S(0), S(1)), sizes, [4, 4, 64]) == []
    assert mesh_mode.uneven_view_dims((16, 64), (S(0), R()), sizes, [1024]) == []
    assert mesh_mode.uneven_view_dims((16, 64), (R(), S(1)), sizes, [1024]) == [1]
    assert mesh_mode.uneven_view_dims((16, 64), (S(1), S(1)), sizes, [16, 4, 16]) == [1]
    with fake_mesh((4, 4), ("data", "model")) as mesh:
        d = specs.put(torch.empty(16, 64, device="meta"),
                      specs.NamedSharding(mesh, specs.PartitionSpec("data", "model")))
        with mesh_mode.MeshMode() as mm:
            v = d.view(16, 2, 32)
            w = d.view(4, 4, 64)
        assert v.placements == (Shard(0), Replicate())
        assert w.placements == (Shard(0), Shard(2))
        assert list(mm.sites.values()) == [1]


@pytest.mark.parametrize("arch", ["gemma3-1b", "deepseek-v2-236b"])
def test_smoke_mesh_steps_equal_no_mesh(arch):
    """Two SMOKE training steps on the (1, 1) mesh (gloo, a world of one),
    the state placed by the rules, equal the two steps without a mesh bit
    for bit: the loss and every state leaf."""
    import torch.distributed as dist

    from repro_torch.data.synthetic import ShardedBatcher, TokenStream
    from repro_torch.launch.mesh import init_distributed, make_smoke_mesh
    from repro_torch.train.loop import make_train_step, state_shardings
    init_distributed("cpu")
    try:
        mesh = make_smoke_mesh("cpu")
        model = tbuild(LM_ARCHS[arch].SMOKE)
        ocfg = topt.AdamWConfig()
        plain = topt.init_state(model.init_params(torch.Generator().manual_seed(0), "cpu"),
                                ocfg)
        sh = state_shardings(model, mesh, specs.default_rules())
        meshed = specs.shard_tree(plain, sh)
        ts = TokenStream(model.cfg.vocab, seed=0)
        step_p = make_train_step(model, ocfg)
        step_m = make_train_step(model, ocfg, shardings=sh)
        for s in range(2):
            plain, mp = step_p(plain, ShardedBatcher(ts, 2, 32, device="cpu")(s))
            specs.set_constraint_mesh(mesh, specs.default_rules())
            try:
                meshed, mm = step_m(meshed, ShardedBatcher(ts, 2, 32, device="cpu",
                                                           mesh=mesh)(s))
            finally:
                specs.set_constraint_mesh(None)
            assert torch.equal(mp["loss"], mm["loss"])
        assert meshed.step == plain.step == 2
        for a, b in zip(topt.tree_leaves([plain.params, plain.mu, plain.nu]),
                        topt.tree_leaves([meshed.params, meshed.mu, meshed.nu]),
                        strict=True):
            assert torch.equal(a, b.to_local())
    finally:
        dist.destroy_process_group()
