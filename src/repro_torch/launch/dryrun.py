"""Multi-pod dry run on one host (port of ``repro.launch.dryrun``).

For one (arch x shape x mesh) cell:
  1. start a *fake* process group of the mesh's size (``torch.testing``'s
     ``FakeStore``: collectives return at once and move nothing) and build
     the production mesh on it (16x16 or 2x16x16);
  2. build the model and its state, cache and batch on the ``meta``
     device (shapes only, nothing allocated), placed on the mesh by the
     logical-axis rules as DTensors (``sharding.specs``);
  3. run one step of rank 0 under the cost model (``launch/op_cost.py``):
     a train step (loss, gradients, AdamW), a prefill, or a decode step
     with its cache;
  4. write the roofline terms (``launch/roofline.py``) and each explicit
     redistribution ``MeshMode`` made (its rule, op, shape and count) to
     a JSON cell.

Success proves the distribution config is coherent: every op on the path
has a sharding (DTensor raises where it has none), every collective is
counted.  The cell's ``seconds_lower`` is the time to build and place
the abstract state, ``seconds_compile`` the time of the counted step (JAX's
lowering and compile times; the port compiles nothing).  ``--save-hlo``
writes the per-op cost table instead of HLO text.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k --mesh single --out results/
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi

Exit code 0 = every requested cell ran (or was a documented skip).  The
dry run needs no device: the fake group and the meta tensors live on the
host, whatever ``torch.cuda`` offers.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gzip
import json
import math
import sys
import time
import traceback
from pathlib import Path


@contextlib.contextmanager
def fake_world(size: int):
    """A fake default process group of ``size`` ranks, this process rank
    0, destroyed on exit.  Refuses to replace a running group."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is running; the dry run needs "
                           "a fake one of its own")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _meta_inputs(model, shape, act_dtype) -> dict:
    import torch
    out = {}
    for name, (s, dt) in model.input_specs(shape, act_dtype).items():
        out[name] = (shape.seq_len - 1 if name == "pos" else
                     torch.empty(s, dtype=dt, device="meta"))
    return out


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.ckpt import _walk
    n = 0
    for _, leaf in _walk(tree):
        if isinstance(leaf, DTensor):
            leaf = leaf.to_local()
        if hasattr(leaf, "element_size"):
            n += leaf.numel() * leaf.element_size()
    return n


def _build_step(model, shape, mesh, rules, opt_cfg, compute_dtype=None):
    """Returns (run: () -> None, per-device argument bytes); ``run`` runs
    inside the caller's ``MeshMode``."""
    import torch

    from repro_torch.sharding.specs import shard_tree, tree_shardings
    from repro_torch.train import optimizer as opt
    from repro_torch.train.loop import value_and_grad

    cfg = model.cfg
    batch = _meta_inputs(model, shape, torch.bfloat16)
    batch_axes = model.input_axes(shape)
    batch = {k: v if k == "pos" else shard_tree(v, tree_shardings(
        mesh, batch_axes[k], v, rules)) for k, v in batch.items()}
    if shape.phase == "train":
        # float32 master parameters and moments; with --compute-dtype bf16
        # the products run in bfloat16 (cast inside the loss, as JAX's
        # mixed-precision step); the step is train.loop's sharded step
        state = opt.abstract_state(model.abstract_params(torch.float32), opt_cfg)
        shardings = tree_shardings(
            mesh, opt.state_logical_axes(model.logical_axes()), state, rules)
        state = shard_tree(state, shardings)

        def run():
            _, grads = value_and_grad(model, state.params, batch, compute_dtype)
            grads = shard_tree(grads, shardings.params)
            shard_tree(opt.adamw_update(state, grads, opt_cfg), shardings)
        return run, _local_bytes((state, batch))

    params = model.abstract_params(torch.bfloat16)
    params = shard_tree(params, tree_shardings(mesh, model.logical_axes(),
                                               params, rules))
    max_seq = shape.seq_len + (cfg.n_vision_tokens if cfg.family == "vlm" else 0)
    if shape.phase == "prefill":
        return (lambda: model.prefill(params, batch, max_seq=max_seq)), \
            _local_bytes((params, batch))
    cache, cache_axes = model.cache_structure(shape.global_batch, max_seq,
                                              abstract=True)
    cache = shard_tree(cache, tree_shardings(mesh, cache_axes, cache, rules))
    return (lambda: model.decode(params, cache, batch)), \
        _local_bytes((params, cache, batch))


def run_cell(arch_id: str, shape_name: str, mesh_kind: str, out_dir: Path,
             rules_override=None, opt_cfg=None, tag: str = "baseline",
             verbose: bool = True, save_hlo: bool = False,
             compute_dtype=None, moe_impl: str = "gather",
             mesh_override=None, naive_decode: bool = False,
             shape_override=None, smoke: bool = False) -> dict:
    """One cell; ``mesh_override`` = (shape, axes), ``shape_override`` a
    ``ShapeConfig`` in place of ``SHAPES[shape_name]`` and ``smoke`` the
    reduced config (tests)."""
    from repro_torch.configs import LM_ARCHS, SHAPES, skip_reason
    from repro_torch.launch import roofline as rl
    from repro_torch.launch.mesh import make_custom_mesh, make_production_mesh
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.models.registry import build_model
    from repro_torch.sharding.mesh_mode import MeshMode
    from repro_torch.sharding.specs import default_rules, set_constraint_mesh
    from repro_torch.train.optimizer import AdamWConfig

    shape = shape_override or SHAPES[shape_name]
    cell = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind, "tag": tag}
    reason = skip_reason(arch_id, shape_name)
    if reason:
        cell.update(status="skipped", reason=reason)
        return cell
    if mesh_override is not None:
        mesh_shape, mesh_axes = mesh_override
    elif mesh_kind == "multi":
        mesh_shape, mesh_axes = (2, 16, 16), ("pod", "data", "model")
    else:
        mesh_shape, mesh_axes = (16, 16), ("data", "model")
    n_dev = math.prod(mesh_shape)
    t0 = time.time()
    try:
        with fake_world(n_dev):
            mesh = (make_custom_mesh(mesh_shape, mesh_axes, "cpu")
                    if mesh_override is not None else
                    make_production_mesh(multi_pod=mesh_kind == "multi",
                                         device_type="cpu"))
            mod = LM_ARCHS[arch_id]
            fcfg = mod.SMOKE if smoke else mod.FULL
            if moe_impl != "gather" and fcfg.n_experts:
                fcfg = dataclasses.replace(fcfg, moe_impl=moe_impl)
            model = build_model(fcfg)
            long_ctx = shape_name == "long_500k"
            rules = rules_override or default_rules(phase=shape.phase,
                                                    long_context=long_ctx)
            if naive_decode:  # pre-optimization serving layout
                rules = default_rules(phase="train", long_context=long_ctx)
            set_constraint_mesh(mesh, rules)
            try:
                run, arg_bytes = _build_step(model, shape, mesh, rules,
                                             opt_cfg or AdamWConfig(),
                                             compute_dtype)
                t_lower = time.time() - t0
                with OpCost() as cost, MeshMode() as mode:
                    run()
                t_compile = time.time() - t0 - t_lower
            finally:
                set_constraint_mesh(None)
        n_active = _active_params(model)
        tokens = shape.global_batch * (shape.seq_len if shape.phase != "decode" else 1)
        mf = rl.model_flops_estimate(n_active, tokens, shape.phase)
        roof = rl.analyze(cost, n_dev, model_flops=mf, memory_analysis=(
            f"argument bytes per device (state or parameters, cache, batch): "
            f"{arg_bytes}"))
        if save_hlo:
            out_dir.mkdir(parents=True, exist_ok=True)
            with gzip.open(out_dir / f"{arch_id}__{shape_name}__{mesh_kind}__"
                           f"{tag}.ops.json.gz", "wt") as fh:
                json.dump(cost.rows(), fh, indent=1)
        cell.update(status="ok", seconds_lower=round(t_lower, 1),
                    seconds_compile=round(t_compile, 1),
                    n_params=model.n_params(), n_params_active=n_active,
                    roofline=roof.to_dict(),
                    redistributions=[{"rule": k[0], "op": k[1], "shape": k[2],
                                      "detail": [str(d) for d in k[3:-1]],
                                      "placements": k[-1], "count": n}
                                     for k, n in mode.sites.items()])
        if verbose:
            print(f"[{arch_id} x {shape_name} x {mesh_kind}] OK "
                  f"lower {t_lower:.0f}s compile {t_compile:.0f}s "
                  f"bottleneck={roof.bottleneck} "
                  f"t=(c {roof.t_compute*1e3:.1f} | m {roof.t_memory*1e3:.1f} "
                  f"| x {roof.t_collective*1e3:.1f}) ms; "
                  f"{sum(mode.sites.values())} explicit redistributions at "
                  f"{len(mode.sites)} sites")
            print("  memory_analysis:", roof.memory_analysis)
    except Exception as e:  # a cell's failure is its record, not the run's end
        cell.update(status="error", error=f"{type(e).__name__}: {e}",
                    traceback=traceback.format_exc()[-2000:])
        if verbose:
            print(f"[{arch_id} x {shape_name} x {mesh_kind}] FAILED: {e}")
    out_dir.mkdir(parents=True, exist_ok=True)
    fname = f"{arch_id}__{shape_name}__{mesh_kind}__{tag}.json"
    (out_dir / fname).write_text(json.dumps(cell, indent=1))
    return cell


def _spec_paths(tree, prefix=()):
    from repro_torch.models.common import is_spec
    if is_spec(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _spec_paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _spec_paths(t, prefix + (i,))


def _active_params(model) -> float:
    """Active parameter count (MoE: routed top-k + shared + non-expert)."""
    cfg = model.cfg
    total = 0.0
    for path, spec in _spec_paths(model.specs):
        n = math.prod(spec.shape)
        if "we_" in "/".join(map(str, path)) and cfg.n_experts:  # routed experts
            n = n * cfg.top_k / cfg.n_experts
        total += n
    return total


def main(argv=None):
    import torch

    from repro_torch.configs import LM_ARCHS, SHAPES

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=tuple(LM_ARCHS))
    ap.add_argument("--shape", default=None, choices=tuple(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every (arch x shape)")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's per-op cost table")
    ap.add_argument("--compute-dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--moe-impl", choices=["gather", "sharded"], default="gather")
    ap.add_argument("--naive-decode", action="store_true",
                    help="pre-optimization decode layout (FSDP weights)")
    ap.add_argument("--mesh-shape", default=None,
                    help="axis refactor of the same chip count, e.g. "
                         "'data=16,model=8,seq=2'")
    args = ap.parse_args(argv)

    archs = list(LM_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    mo = None
    if args.mesh_shape:
        pairs = [kv.split("=") for kv in args.mesh_shape.split(",")]
        mo = (tuple(int(v) for _, v in pairs), tuple(k for k, _ in pairs))
    cdt = torch.bfloat16 if args.compute_dtype == "bf16" else None
    out_dir = Path(args.out)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_kind in meshes:
                cell = run_cell(arch, shape, mesh_kind, out_dir, tag=args.tag,
                                save_hlo=args.save_hlo, compute_dtype=cdt,
                                moe_impl=args.moe_impl, mesh_override=mo,
                                naive_decode=args.naive_decode)
                failures += cell["status"] == "error"
    print(f"dry-run finished: {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
