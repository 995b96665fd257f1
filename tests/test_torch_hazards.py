"""The port's hazard proofs (``repro_torch.analysis.hazards``) against the
JAX package's (``repro.analysis.hazards``).

The port builds its layouts with its own code (``aeq.interlace``,
``event_conv.shifted_bank_masks``, ``aeq.build_aeq`` / ``segment_pad``)
and must discharge exactly the obligations JAX's ``run_hazards``
discharges for the rules it carries.  Those counts are constants here,
measured once on the frozen reference (``run_hazards()`` of
``src/repro``, 34.9 s on one core): running it live would cost that much
per test run.  The live comparison runs at k = 3 only, on reduced grids
where JAX's checks are slow.

    PYTHONPATH=src python -m pytest -q tests/test_torch_hazards.py
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import hazards as jh
from repro.core import aeq as jaeq
from repro.core import event_conv as jev
from repro.core.geometry import GEOM_3X3 as J3
from repro.core.geometry import ConvGeometry as JGeom
from repro_torch.analysis import Report
from repro_torch.analysis import hazards as th
from repro_torch.analysis import selftest as tself
from repro_torch.core.geometry import GEOM_3X3 as T3
from repro_torch.core.geometry import ConvGeometry as TGeom
from repro_torch.core.plan import plan_network

#: obligations of JAX's run_hazards() on the frozen reference, per rule the
#: port carries (its BlockSpec rule has no counterpart)
JAX_OBLIGATIONS = {
    "hazard-column-disjoint": 4200,
    "hazard-mask-routing": 216,
    "hazard-segment-homogeneous": 18774,
    "hazard-segment-replay": 162,
    "oob-event-patch": 30,
}


def _findings(rep):
    return sorted((f.rule, f.where) for f in rep.findings)


def test_run_hazards_discharges_jax_obligations():
    rep = th.run_hazards()
    assert rep.ok, rep.summary()
    for rule, n in JAX_OBLIGATIONS.items():
        assert rep.checked[rule] == n, rule
    assert rep.checked["hazard-banked-masks"] >= 1
    assert rep.checked["oob-launch-bounds"] >= 1


def test_launch_bounds_cover_every_plan_and_sweep_case():
    from repro_torch.analysis.contracts import sweep_cases
    from repro_torch.analysis.kernel_audit import _sweep
    for case, cfg, kwargs in sweep_cases():
        rep = th.check_launch_bounds(
            th.plan_launches(plan_network(cfg, **kwargs), case))
        assert rep.ok and rep.checked["oob-launch-bounds"] >= 1, case
    by_case = {}
    for where, check in th.sweep_launches():
        by_case.setdefault(where.split("]")[0], []).append((where, check))
    assert len(by_case) == len(_sweep())
    for case, launches in by_case.items():
        rep = th.check_launch_bounds(launches)
        assert rep.ok and rep.checked["oob-launch-bounds"] == 7, case


def test_launch_bounds_call_the_wrappers_own_checks():
    """The rule's verdicts are the wrappers' own: the gather's packed key,
    the threshold unit's 2**31 elements, the banked conv's staging."""
    f32 = torch.float32
    cases = [
        (th.conv_launch("gather", 8, 30, 30, 8, 1024, 320, T3, f32), True),
        (th.conv_launch("gather", 8, 30, 30, 8, 1025, 320, T3, f32), False),
        (th.conv_launch("gather", 1, 2049, 30, 8, 1, 64, T3, f32), False),
        (th.conv_launch("gather", 2, 30, 30, 8, 1, 66, T3, f32, 4), False),
        (th.threshold_launch(1, 4096, 4096, 128, (1, 1), 3, f32), False),
        (th.threshold_launch(8, 28, 28, 8, (1, 1), 3, f32), True),
        (th.conv_launch("banked", 8, 30, 30, 8, 32, 0, T3, f32), True),
        (th.conv_launch("banked", 1, 600, 600, 8, 1, 0, T3, f32), False),
    ]
    for check, ok in cases:
        assert th.check_launch_bounds([("case", check)]).ok is ok


@pytest.fixture(scope="module")
def jax_routing():
    """JAX's shifted_bank_masks of every one-hot event of the (8, 9) map at
    k = 3, in one batched call."""
    h, w = 8, 9
    pad = np.zeros((h * w, h + 2, w + 2), bool)
    for n in range(h * w):
        pad[n, n // w + 1, n % w + 1] = True
    got = np.asarray(jev.shifted_bank_masks(
        jaeq.interlace(jnp.asarray(pad), J3), J3))
    return got.reshape(h, w, *got.shape[1:])


def test_shifted_bank_masks_of_every_one_hot_event_equal_jax(jax_routing):
    for i in range(8):
        for j in range(9):
            np.testing.assert_array_equal(
                th.one_hot_routing(i, j, (8, 9), T3), jax_routing[i, j])


@pytest.mark.parametrize("cap,par", [(16, 2), (64, 4), (1024, 8)])
def test_segment_pad_of_adversarial_maps_equals_jax(cap, par):
    names, fmaps = zip(*th._adversarial_fmaps(11, 13, T3))
    jnames, jfmaps = zip(*jh._adversarial_fmaps(11, 13, J3))
    assert names == jnames
    np.testing.assert_array_equal(np.stack(fmaps), np.stack(jfmaps))
    # jitted: JAX's eager builder takes seconds
    jq = jax.jit(lambda f: jaeq.segment_pad(jaeq.build_aeq_batched(
        f, cap, geometry=J3), par, J3))(jnp.asarray(np.stack(fmaps)))
    for n, fmap in enumerate(fmaps):
        _, _, coords, valid = th.padded_layout(fmap, cap, par, T3)
        np.testing.assert_array_equal(coords, np.asarray(jq.coords[n]))
        np.testing.assert_array_equal(valid, np.asarray(jq.valid[n]))


def _live_pairs():
    """(name, port check, JAX check) at k = 3; the slow JAX checks on
    reduced grids."""
    return [
        ("column-disjoint", lambda r: th.check_column_disjointness(
            geometry=T3, report=r),
         lambda: jh.check_column_disjointness(geometry=J3)),
        ("mask-routing", lambda r: th.check_mask_routing(
            (4, 5), geometry=T3, report=r),
         lambda: jh.check_mask_routing((4, 5), geometry=J3)),
        ("segment-layout", lambda r: th.check_segment_layout(
            capacities=(64,), event_pars=(4,), geometry=T3, report=r),
         lambda: jh.check_segment_layout(capacities=(64,), event_pars=(4,),
                                         geometry=J3)),
        ("patch-bounds", lambda r: [th.check_patch_bounds(
            h, w, geometry=T3, report=r) for h, w in th.PATCH_HW],
         lambda: _merged([jh.check_patch_bounds(h, w, geometry=J3)
                          for h, w in th.PATCH_HW])),
    ]


def _merged(reps):
    from repro.analysis.report import merge
    return merge(reps)


@pytest.mark.parametrize("pair", _live_pairs(), ids=lambda p: p[0])
def test_checks_give_jax_counts_and_findings_at_k3(pair):
    _, port, ref = pair
    rep = Report()
    port(rep)
    jrep = ref()
    assert dict(rep.checked) == dict(jrep.checked)
    assert _findings(rep) == _findings(jrep)


HAZARD_FIXTURES = [
    ("collider-column-map", "hazard-column-disjoint",
     lambda m, g: m.check_column_disjointness(
         column_of=lambda i, j: (i % 2) * 2 + (j % 2))),
    ("collider-column-map-k5", "hazard-column-disjoint",
     lambda m, g: m.check_column_disjointness(
         geometry=g(5, 5), column_of=lambda i, j: (i % 3) * 5 + (j % 5))),
    ("malformed-bank-masks", "hazard-banked-masks",
     lambda m, g: m.check_banked_masks(np.ones((4, 3, 3), bool))),
    ("wrong-bank-count-k5", "hazard-banked-masks",
     lambda m, g: m.check_banked_masks(np.ones((9, 2, 2), bool),
                                       geometry=g(5, 5))),
    ("duplicate-in-group", "hazard-segment-homogeneous",
     lambda m, g: m.check_padded_queue(
         np.array([[2, 2], [2, 2], [0, 0], [0, 1]], np.int32),
         np.array([1, 1, 0, 0], bool), 2)),
    ("mixed-column-group", "hazard-segment-homogeneous",
     lambda m, g: m.check_padded_queue(
         np.array([[0, 0], [0, 1], [3, 3], [3, 3]], np.int32),
         np.array([1, 1, 1, 0], bool), 2)),
    ("oob-event-patch", "oob-event-patch",
     lambda m, g: m.check_patch_bounds(10, 10, coord_hi=(10, 9))),
]


@pytest.mark.parametrize("fixture", HAZARD_FIXTURES, ids=lambda f: f[0])
def test_hazard_fixture_flagged_under_jax_id(fixture):
    _, rule, build = fixture
    rep, jrep = build(th, TGeom), build(jh, JGeom)
    assert rule in {f.rule for f in rep.findings}
    assert sorted(f.rule for f in rep.findings) == sorted(
        f.rule for f in jrep.findings)


def test_selftest_hazards_flags_every_fixture():
    rep = Report()
    tself.selftest_hazards(rep)
    assert rep.ok, rep.summary()
    assert rep.checked["selftest-seeded"] == len(HAZARD_FIXTURES) + 1


def test_window_clamp_is_the_identity_only_inside_the_halo():
    # 28x28 at k=5: padded 32, starts 0..27 stay; 28 would be moved to 27
    assert [th.window_clamp(x, 32, 5) for x in (0, 27)] == [0, 27]
    assert th.window_clamp(28, 32, 5) == 27
    assert th.window_clamp(-1, 32, 5) == 0
    rep = th.check_patch_bounds(28, 28, geometry=TGeom(5, 5),
                                coord_hi=(28, 27))
    assert [f.rule for f in rep.findings] == ["oob-event-patch"]
    assert rep.checked["oob-event-patch"] == 1
