"""The port's per-rank collectives (``repro_torch.sharding``: ``shard_map``
bodies, ``overlap``, ``pipeline``, the collective half of ``compression``,
``moe_forward_sharded``, ``ShardedBatcher(mesh=)``) on gloo ranks, held
against JAX's functions on forced CPU devices and against unsharded
results.

One JAX process (8 forced devices) and two groups of gloo ranks (8 and 4)
run side by side once per module; each rank saves its results and the
tests read them."""
from pathlib import Path

import numpy as np
import pytest

from torch_lm_ref import finish, start_jax, start_ranks

RTOL = 1e-5

JAX_CODE = """
import numpy as np, jax, jax.numpy as jnp
from repro.sharding.overlap import psum_matmul, ring_weight_gather_matmul
from repro.sharding.pipeline import pipeline_apply
from repro.sharding.compression import quantize_grad
from repro.models import ffn
out = {}
rng = np.random.default_rng(0)
x = rng.normal(size=(16, 64)).astype(np.float32)
w = rng.normal(size=(64, 24)).astype(np.float32)
mesh8 = jax.make_mesh((8,), ("data",))
out["psum_mm"] = np.asarray(psum_matmul(jnp.asarray(x), jnp.asarray(w), mesh8, "data"))
out["ring_mm"] = np.asarray(ring_weight_gather_matmul(jnp.asarray(x), jnp.asarray(w), mesh8, "data"))
ws = (rng.normal(size=(4, 16, 16)) * 0.3).astype(np.float32)
xp = rng.normal(size=(8, 16)).astype(np.float32)
mesh4 = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("pp",))
out["pipe"] = np.asarray(pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"]),
                                        {"w": jnp.asarray(ws)}, jnp.asarray(xp),
                                        mesh=mesh4, axis="pp", n_microbatches=4))
g = (rng.normal(size=(40, 24)) * 3.0).astype(np.float32)
key = jax.random.PRNGKey(7)
out["qg_u"] = np.asarray(jax.random.uniform(key, g.shape))
t = jax.jit(quantize_grad)(jnp.asarray(g), key)
out["qg_q"], out["qg_scale"] = np.asarray(t.q), np.asarray(t.scale)
p = {"router": rng.normal(size=(16, 4)).astype(np.float32),
     "we_gate": (rng.normal(size=(4, 16, 32)) * 0.25).astype(np.float32),
     "we_up": (rng.normal(size=(4, 16, 32)) * 0.25).astype(np.float32),
     "we_down": (rng.normal(size=(4, 32, 16)) * 0.18).astype(np.float32)}
xm = rng.normal(size=(4, 8, 16)).astype(np.float32)
mesh22 = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
try:
    o, a = ffn.moe_forward_sharded({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(xm), top_k=2, n_experts=4,
                                   mesh=mesh22)
    out["moe_out"], out["moe_aux"] = np.asarray(o), np.asarray(a)
except Exception as e:
    print("moe_forward_sharded raised", type(e).__name__, e)
np.savez(OUT / "jax.npz", x=x, w=w, ws=ws, xp=xp, g=g, xm=xm,
         **{"p_" + k: v for k, v in p.items()}, **out)
"""

# 8 ranks: the matmuls over an 8-way data axis, sparse_psum and
# quantized_pmean over it, the batcher on a (4, 2) mesh
RANKS8 = """
from torch.distributed.tensor import DTensor
from repro_torch.data.synthetic import ShardedBatcher, TokenStream
from repro_torch.launch.mesh import make_custom_mesh
from repro_torch.sharding.collectives import all_gather, axis_index, psum, shard_map
from repro_torch.sharding.compression import compress_topk, quantized_pmean, sparse_psum
from repro_torch.sharding.overlap import psum_matmul, ring_weight_gather_matmul
from repro_torch.sharding.specs import PartitionSpec as P
res = {}
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.normal(size=(16, 64)).astype(np.float32))
w = torch.from_numpy(rng.normal(size=(64, 24)).astype(np.float32))
mesh = make_custom_mesh((8,), ("data",), "cpu")
res["psum_mm"] = psum_matmul(x, w, mesh, "data").to_local().numpy()
y = ring_weight_gather_matmul(x, w, mesh, "data")
res["ring_local"] = y.to_local().numpy()
res["ring_mm"] = y.full_tensor().numpy()
idx = axis_index(mesh, "data")
res["gathered"] = all_gather(torch.tensor([float(idx), 10.0 + idx]), mesh, "data").numpy()
g = torch.zeros(32)
g[(idx * 3) % 32] = 1.0 + idx
res["sparse"] = sparse_psum(compress_topk(g, 4), mesh, "data").to_local().numpy()
res["dense_mean"] = (psum(g, mesh, "data") / 8).numpy()
errs = []
for s in range(5):
    gq = torch.randn(64, generator=torch.Generator().manual_seed(100 + idx))
    ref = psum(gq, mesh, "data") / 8
    got = quantized_pmean(gq, torch.Generator().manual_seed(1000 * s + idx), mesh, "data")
    errs.append(float((got - ref).abs().max() / ref.abs().max()))
    res[f"qpmean_{s}"] = got.numpy()
res["qpmean_errs"] = np.asarray(errs)
mesh42 = make_custom_mesh((4, 2), ("data", "model"), "cpu")
b = ShardedBatcher(TokenStream(vocab=64, seed=0), 8, 16, device="cpu", mesh=mesh42,
                   batch_axes=("data",))(3)
tok = b["tokens"]
res["batch_local"] = tok.to_local().numpy()
res["batch_placements"] = np.asarray([str(p) for p in tok.placements])
res["batch_full"] = tok.full_tensor().numpy()
np.savez(OUT / f"r{RANK}.npz", **res)
"""

# 4 ranks: the pipeline over 4 stages, the expert-parallel MoE on (2, 2)
RANKS4 = """
from repro_torch.launch.mesh import make_custom_mesh
from repro_torch.models.ffn import moe_forward, moe_forward_sharded
from repro_torch.sharding.pipeline import pipeline_apply
from repro_torch.sharding.specs import NamedSharding, PartitionSpec as P, shard_tree
from torch.distributed.tensor import Replicate, Shard
ref = np.load(OUT.parent / "jax" / "inputs.npz")
res = {}
mesh = make_custom_mesh((4,), ("pp",), "cpu")
ws, xp = torch.from_numpy(ref["ws"]), torch.from_numpy(ref["xp"])
res["pipe"] = pipeline_apply(lambda p, h: torch.tanh(h @ p["w"]), {"w": ws}, xp,
                             mesh=mesh, axis="pp", n_microbatches=4).to_local().numpy()
mesh22 = make_custom_mesh((2, 2), ("data", "model"), "cpu")
p = {k: torch.from_numpy(ref["p_" + k]) for k in ("router", "we_gate", "we_up", "we_down")}
xm = torch.from_numpy(ref["xm"])
# plain (global) inputs give plain results; DTensor inputs DTensors
o, a = moe_forward_sharded(p, xm, top_k=2, n_experts=4, mesh=mesh22)
res["moe_out"], res["moe_aux"] = o.numpy(), a.numpy()
xd = shard_tree(xm, NamedSharding(mesh22, P("data", None, None)))
o, a = moe_forward_sharded(p, xd, top_k=2, n_experts=4, capacity_factor=4.0, mesh=mesh22)
assert tuple(o.placements) == (Shard(0), Replicate())
res["moe_nodrop"] = o.full_tensor().numpy()
np.savez(OUT / f"r{RANK}.npz", **res)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("collectives")
    # the 4-rank group reads the pipeline and MoE inputs the JAX side draws;
    # the same numpy draws, written here first
    rng = np.random.default_rng(0)
    rng.normal(size=(16, 64)), rng.normal(size=(64, 24))
    ws = (rng.normal(size=(4, 16, 16)) * 0.3).astype(np.float32)
    xp = rng.normal(size=(8, 16)).astype(np.float32)
    rng.normal(size=(40, 24))
    p = {"router": rng.normal(size=(16, 4)).astype(np.float32),
         "we_gate": (rng.normal(size=(4, 16, 32)) * 0.25).astype(np.float32),
         "we_up": (rng.normal(size=(4, 16, 32)) * 0.25).astype(np.float32),
         "we_down": (rng.normal(size=(4, 32, 16)) * 0.18).astype(np.float32)}
    xm = rng.normal(size=(4, 8, 16)).astype(np.float32)
    (root / "jax").mkdir()
    np.savez(root / "jax" / "inputs.npz", ws=ws, xp=xp, xm=xm,
             **{"p_" + k: v for k, v in p.items()})
    out = finish([start_jax(JAX_CODE, 8, root / "jax"),
                  start_ranks(RANKS8, 8, root / "r8"),
                  start_ranks(RANKS4, 4, root / "r4")])
    jax_ref = dict(np.load(root / "jax" / "jax.npz"))
    for k in ("ws", "xp", "xm"):  # both sides drew the same inputs
        np.testing.assert_array_equal(jax_ref[k], np.load(root / "jax" / "inputs.npz")[k])
    r8 = [dict(np.load(root / "r8" / f"r{r}.npz")) for r in range(8)]
    r4 = [dict(np.load(root / "r4" / f"r{r}.npz")) for r in range(4)]
    return {"jax": jax_ref, "r8": r8, "r4": r4, "jax_out": out[0]}


def test_psum_matmul(runs):
    j = runs["jax"]
    want = j["x"].astype(np.float64) @ j["w"].astype(np.float64)
    for r in runs["r8"]:  # replicated: every rank holds the whole product
        np.testing.assert_allclose(r["psum_mm"], j["psum_mm"], rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(r["psum_mm"], want, rtol=RTOL, atol=1e-4)


def test_ring_weight_gather_matmul(runs):
    j = runs["jax"]
    want = j["x"].astype(np.float64) @ j["w"].astype(np.float64)
    for i, r in enumerate(runs["r8"]):
        np.testing.assert_array_equal(r["ring_local"], r["ring_mm"][2 * i:2 * i + 2])
        np.testing.assert_allclose(r["ring_mm"], j["ring_mm"], rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(r["ring_mm"], want, rtol=RTOL, atol=1e-4)


def test_all_gather_stacks_in_axis_order(runs):
    for r in runs["r8"]:
        np.testing.assert_array_equal(
            r["gathered"], [[i, 10.0 + i] for i in range(8)])


def test_pipeline_apply_matches_sequential(runs):
    from repro_torch.sharding.pipeline import bubble_fraction
    j = runs["jax"]
    want = j["xp"].astype(np.float64)
    for s in range(4):
        want = np.tanh(want @ j["ws"][s].astype(np.float64))
    for r in runs["r4"]:
        np.testing.assert_allclose(r["pipe"], want, rtol=RTOL, atol=RTOL)
        np.testing.assert_allclose(r["pipe"], j["pipe"], rtol=RTOL, atol=RTOL)
    assert abs(bubble_fraction(4, 4) - 3 / 7) < 1e-12


def test_sparse_psum_matches_dense_mean(runs):
    for r in runs["r8"]:
        assert np.abs(r["sparse"] - r["dense_mean"]).max() < 1e-6
        np.testing.assert_array_equal(r["sparse"], runs["r8"][0]["sparse"])


def test_quantize_grad_given_jax_draw_is_jax(runs):
    import torch

    from repro_torch.sharding.compression import _quantize, dequantize_grad
    j = runs["jax"]
    t = _quantize(torch.from_numpy(j["g"]), torch.from_numpy(j["qg_u"]))
    np.testing.assert_array_equal(t.q.numpy(), j["qg_q"])
    np.testing.assert_array_equal(t.scale.numpy(), j["qg_scale"])
    assert t.q.dtype == torch.int8
    np.testing.assert_array_equal(dequantize_grad(t).numpy(),
                                  j["qg_q"].astype(np.float32) * j["qg_scale"])


def test_quantized_pmean_unbiased(runs):
    errs = runs["r8"][0]["qpmean_errs"]
    assert np.mean(errs) < 0.2, errs   # int8 noise, not bias
    for r in runs["r8"]:  # every rank averages the same gathered payloads
        for s in range(5):
            np.testing.assert_array_equal(r[f"qpmean_{s}"], runs["r8"][0][f"qpmean_{s}"])


def test_moe_forward_sharded(runs):
    import torch

    from repro_torch.models.ffn import moe_forward
    j = runs["jax"]
    p = {k: torch.from_numpy(j["p_" + k]) for k in ("router", "we_gate", "we_up", "we_down")}
    xm = torch.from_numpy(j["xm"])
    nodrop, _ = moe_forward(p, xm, top_k=2, capacity_factor=4.0)
    for r in runs["r4"]:
        if "moe_out" in j:
            np.testing.assert_allclose(r["moe_out"], j["moe_out"], rtol=RTOL, atol=RTOL)
            np.testing.assert_allclose(r["moe_aux"], j["moe_aux"], rtol=RTOL, atol=RTOL)
        else:  # JAX's shard_map refused this mesh: its message is printed
            assert "moe_forward_sharded raised" in runs["jax_out"]
        # at a capacity that drops nothing the expert-parallel form is the
        # dense dispatch
        np.testing.assert_allclose(r["moe_nodrop"], nodrop.numpy(), rtol=RTOL, atol=RTOL)


def test_moe_forward_sharded_without_mesh_is_moe_forward():
    import torch

    from repro_torch.models.ffn import moe_forward, moe_forward_sharded
    g = torch.Generator().manual_seed(0)
    p = {"router": torch.randn(16, 4, generator=g),
         "we_gate": torch.randn(4, 16, 32, generator=g) * 0.25,
         "we_up": torch.randn(4, 16, 32, generator=g) * 0.25,
         "we_down": torch.randn(4, 32, 16, generator=g) * 0.18}
    x = torch.randn(2, 8, 16, generator=g)
    got = moe_forward_sharded(p, x, top_k=2, n_experts=4)
    want = moe_forward(p, x, top_k=2)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_sharded_batcher_on_a_mesh(runs):
    from repro_torch.data.synthetic import TokenStream
    host = TokenStream(vocab=64, seed=0).batch(3, 8, 16)["tokens"]
    for i, r in enumerate(runs["r8"]):
        np.testing.assert_array_equal(r["batch_full"], host)
        row = i // 2  # (data, model) coordinate: rows split over data only
        np.testing.assert_array_equal(r["batch_local"], host[2 * row:2 * row + 2])
        assert list(r["batch_placements"]) == ["S(0)", "R"]
