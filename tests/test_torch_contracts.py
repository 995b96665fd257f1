"""The port's plan contract auditor (``repro_torch.analysis``) against the
JAX package's (``repro.analysis.contracts``).

Over JAX's geometry sweep the two auditors flag the same (rule, where)
findings and discharge the same obligations, the budget rule apart: JAX
models ``batch_tile`` resident tiles against a TPU core's VMEM
(``plan-vmem-budget``), the port one CTA tile against a block's shared
memory (``plan-smem-budget``).  Seeded violations are flagged under the
same id in both packages.

    PYTHONPATH=src python -m pytest -q tests/test_torch_contracts.py
"""
import dataclasses

import pytest

from repro.analysis import contracts as jcon
from repro.core import csnn as jcsnn
from repro.core import plan as jplan
from repro_torch.analysis import (CONTRACTS, Finding, Report, audit_plan,
                                  merge, run_contracts, sweep_cases)
from repro_torch.analysis import contracts as tcon
from repro_torch.core import csnn as tcsnn
from repro_torch.core import plan as tplan
from repro_torch.kernels.event_conv.kernel import SMEM_PER_BLOCK

JAX_VARIANT_NAMES = {"interlaced-pallas": "interlaced-cuda",
                     "banked-jax": "banked-cuda"}
BUDGET_RULES = {"plan-vmem-budget", "plan-smem-budget"}
JAX_CASES = jcon.sweep_cases()


def _port_cfg(jcfg):
    """The port's CSNNConfig with the JAX config's fields."""
    layers = tuple(tcsnn.ConvSpec(s.channels, kernel=s.kernel, pool=s.pool)
                   if isinstance(s, jcsnn.ConvSpec)
                   else tcsnn.FCSpec(s.features) for s in jcfg.layers)
    return tcsnn.CSNNConfig(
        input_hw=tuple(jcfg.input_hw), input_channels=jcfg.input_channels,
        layers=layers, t_steps=jcfg.t_steps, v_t=jcfg.v_t,
        relu_clamp=jcfg.relu_clamp)


def _port_kwargs(kwargs):
    """JAX's plan kwargs under the port's variant names; JAX's
    ``stream_finalize`` pin drops (the port has one streamed route)."""
    out = dict(kwargs)
    out.pop("stream_finalize", None)
    v = out.get("variant")
    if isinstance(v, (list, tuple)):
        out["variant"] = [JAX_VARIANT_NAMES.get(x, x) for x in v]
    elif v is not None:
        out["variant"] = JAX_VARIANT_NAMES.get(v, v)
    return out


def _flagged(rep, drop=BUDGET_RULES):
    return sorted((f.rule, f.where) for f in rep.findings
                  if f.rule not in drop)


def test_sweep_cases_are_jax_cases_with_port_names():
    ours = sweep_cases()
    assert [c[0] for c in ours] == [c[0] for c in JAX_CASES]
    for (name, tcfg, tkw), (_, jcfg, jkw) in zip(ours, JAX_CASES):
        assert tcfg == _port_cfg(jcfg), name
        assert tkw == _port_kwargs(jkw), name


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_audit_flags_what_jax_flags_over_the_sweep(case):
    name, jcfg, kwargs = case
    tcfg = _port_cfg(jcfg)
    jrep = jcon.audit_plan(jplan.plan_network(jcfg, **kwargs), jcfg,
                           case=name)
    trep = audit_plan(tplan.plan_network(tcfg, **_port_kwargs(kwargs)),
                      tcfg, case=name)
    assert _flagged(trep) == _flagged(jrep)
    same = {r: n for r, n in jrep.checked.items() if r not in BUDGET_RULES}
    assert {r: n for r, n in trep.checked.items()
            if r not in BUDGET_RULES} == same
    assert trep.checked["plan-smem-budget"] == jrep.checked[
        "plan-vmem-budget"]


def test_every_rule_discharges_an_obligation():
    rep = run_contracts()
    assert rep.ok, rep.summary()
    assert set(rep.checked) == set(CONTRACTS)
    assert all(rep.checked[r] >= 1 for r in CONTRACTS), dict(rep.checked)
    assert set(CONTRACTS) - {"plan-smem-budget"} == (
        set(jcon.CONTRACTS) - {"plan-vmem-budget"})
    assert "analysis: 0 finding(s)" in rep.summary()


def _seeded(mod_plan, cfg, which, variant_name):
    """(plan, cfg) with one violation planted, built by ``mod_plan``."""
    if which == "block-e":
        p = mod_plan.plan_network(cfg, capacity=64, channel_block=4)
        bad = dataclasses.replace(p.layers[0],
                                  block_e=p.layers[0].queue_depth + 1)
    elif which == "vm-tile":
        p = mod_plan.plan_network(cfg, capacity=64, channel_block=4,
                                  variant="fused-handoff")
        bad = dataclasses.replace(p.layers[0], vm_tile=(5, 5, 4))
    elif which == "interlaced-ep1":
        p = mod_plan.plan_network(cfg, capacity=64, channel_block=4)
        bad = dataclasses.replace(p.layers[0], variant=variant_name)
    else:  # a variant no kernel implements, pinned on layer 1
        p = mod_plan.plan_network(cfg, capacity=64, channel_block=4)
        bad = dataclasses.replace(p.layers[1], variant="fused-marvel")
        return dataclasses.replace(p, layers=(p.layers[0], bad))
    return dataclasses.replace(p, layers=(bad,) + p.layers[1:])


@pytest.mark.parametrize("which,rule", [
    ("block-e", "plan-block-e-divides-depth"),
    ("vm-tile", "plan-vm-tile-geometry"),
    ("interlaced-ep1", "plan-variant-valid"),
    ("variant-bogus-layer1", "plan-variant-valid"),
])
def test_seeded_violations_flagged_as_jax_flags_them(which, rule):
    from repro.configs import csnn_paper as jpaper
    from repro_torch.configs import csnn_paper as tpaper
    jp = _seeded(jplan, jpaper.SMOKE, which, "interlaced-pallas")
    tp = _seeded(tplan, tpaper.SMOKE, which, "interlaced-cuda")
    jrep = jcon.audit_plan(jp, jpaper.SMOKE, case=which)
    trep = audit_plan(tp, tpaper.SMOKE, case=which)
    assert rule in {f.rule for f in trep.findings}
    assert _flagged(trep) == _flagged(jrep)


def test_smem_budget_rule_bounds_one_cta_tile():
    from repro_torch.configs import csnn_paper as tpaper
    p = tplan.plan_network(tpaper.FULL, capacity=256, channel_block=8)
    assert audit_plan(p, tpaper.FULL).ok
    lp = p.layers[0]
    vm_bytes = 4
    want = (2 * 30 * 30 * 8 * vm_bytes + 2 * lp.block_e * 9
            + 9 * 8 * vm_bytes)
    assert tcon.smem_model_bytes(lp) == want < SMEM_PER_BLOCK
    # 32 float32 channels of a 30x30 tile, twice, no longer fit one block
    wide = tplan.plan_network(tpaper.FULL, capacity=256, channel_block=32)
    rep = audit_plan(wide, tpaper.FULL, case="wide")
    assert {(f.rule, f.where) for f in rep.findings} == {
        ("plan-smem-budget", "plan[wide].conv0"),
        ("plan-smem-budget", "plan[wide].conv1")}
    # JAX's VMEM model accepts the same plan
    from repro.configs import csnn_paper as jpaper
    assert jcon.audit_plan(jplan.plan_network(
        jpaper.FULL, capacity=256, channel_block=32), jpaper.FULL).ok


def test_report_plumbing_matches_jax():
    from repro.analysis import report as jrep
    a, b = Report(), Report()
    a.flag("contracts", "r1", "w", "m")
    b.proved("r1", 3)
    m = merge([a, b])
    ja, jb = jrep.Report(), jrep.Report()
    ja.flag("contracts", "r1", "w", "m")
    jb.proved("r1", 3)
    jm = jrep.merge([ja, jb])
    assert m.to_dict() == jm.to_dict()
    assert m.summary() == jm.summary()
    assert str(Finding("t", "r", "w", "m")) == str(jrep.Finding("t", "r",
                                                                "w", "m"))
    assert not m.ok and m.by_rule() == {"r1": [Finding("contracts", "r1",
                                                       "w", "m")]}
