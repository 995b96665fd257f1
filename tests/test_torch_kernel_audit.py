"""The port's kernel audit (``repro_torch.analysis.kernel_audit``) against
the JAX package's oracles.

On the CPU the audit runs every wrapper's plain version, so it must be
clean; its fixtures (``_sweep``, ``_adversarial_queue``) are copies of
JAX's.  Per sweep case the port's plain datapaths equal JAX's oracles on
the same numpy inputs, by value; one case is also held against JAX's
interpret-mode ``event_conv_pallas``.  The saturation rail is reached and
clamped by every conv unit, the self-test's wrapping adder is flagged,
and the red zones catch a write past an operand.  The CUDA pass (every
launch counter) is the ``gpu`` test
``tests/test_torch_gpu.py::test_kernel_audit_on_card_launches_every_kernel``,
in the file that runs on a card without JAX.

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernel_audit.py
"""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import kernel_audit as jka
from repro.core import aeq as jaeq
from repro.core import event_conv as jev
from repro.core.geometry import ConvGeometry as JGeom
from repro.kernels.event_conv.kernel import event_conv_pallas
from repro.kernels.event_conv.ref import event_conv_ref as jevent_conv_ref
from repro.kernels.threshold_pool.ref import (
    threshold_pool_ref as jthreshold_pool_ref)
from repro_torch.analysis import Report
from repro_torch.analysis import kernel_audit as tka
from repro_torch.analysis import selftest as tself
from repro_torch.core import aeq as taeq
from repro_torch.core.event_conv import apply_events, pad_vm
from repro_torch.core.geometry import ConvGeometry as TGeom
from repro_torch.kernels.event_conv.kernel import event_conv_cuda
from repro_torch.kernels.event_conv.ref import event_conv_ref
from repro_torch.kernels.threshold_pool.ref import threshold_pool_ref

CASES = tka._sweep()
RULES = ("kernel-shape-contract", "kernel-value-parity", "kernel-checkify",
         "kernel-sat-overflow", "oob-launch-bounds")


def _j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def test_fixtures_are_copies_of_jax():
    assert tka._sweep() == jka._sweep()
    for _, h, w, _, block_e, _, _, kk in CASES:
        got = tka._adversarial_queue(h, w, 4 * block_e,
                                     np.random.default_rng(5), TGeom(kk, kk))
        want = jka._adversarial_queue(h, w, 4 * block_e,
                                      np.random.default_rng(5), JGeom(kk, kk))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_cpu_audit_is_clean():
    rep = tka.run_kernel_audit(device="cpu")
    assert rep.ok, rep.summary()
    for rule in RULES:
        assert rep.checked[rule] >= 1, rule
    # a wrapper's shapes per case: four gathers, the tile path, the banked
    # conv, the threshold unit base and emit at two pools, the event-set
    # builder
    assert rep.checked["kernel-shape-contract"] == 11 * len(CASES)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_versions_equal_jax_oracles(case):
    _, h, w, c, block_e, _, dt, kk = case
    tg, jg = TGeom(kk, kk), JGeom(kk, kk)
    rng = np.random.default_rng(17)
    e = 4 * block_e
    vm0, kern = tka._tile_and_kernel(rng, h, w, c, kk, dt, 2)
    coords, valid = tka._adversarial_queue(h, w, e, rng, tg)
    vm_p = pad_vm(vm0, tg)
    got = event_conv_ref(vm_p, torch.from_numpy(coords),
                         torch.from_numpy(valid), kern)
    want = jevent_conv_ref(_j(vm_p), jnp.asarray(coords),
                           jnp.asarray(valid.astype(np.int8)), _j(kern))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    fmap = rng.random((h, w)) < 0.4
    got = apply_events(vm_p, taeq.build_aeq(torch.from_numpy(fmap), e,
                                            geometry=tg), kern)
    # jitted: JAX's eager builder takes seconds a case
    want = jax.jit(lambda f, v, k_: jev.apply_events(
        v, jaeq.build_aeq(f, e, geometry=jg), k_))(
            jnp.asarray(fmap), _j(vm_p), _j(kern))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the threshold unit with emission, on the pool-padded map
    th, tw = h + (-h % 3), w + (-w % 3)
    vm = tka._tile_and_kernel(rng, th, tw, c, kk, dt, 2)[0]
    bias = rng.standard_normal((c,)).astype(np.float32).astype(dt)
    fired = (rng.random((th, tw, c)) < 0.3).astype(np.int8)
    args = dict(v_t=0.0, pool=3, emit_capacity=max(1, h * w // 2))
    got = threshold_pool_ref(vm, torch.from_numpy(bias),
                             torch.from_numpy(fired), emit_geometry=tg,
                             **args)
    want = jax.jit(partial(jthreshold_pool_ref, emit_geometry=jg, **args))(
        _j(vm), jnp.asarray(bias), jnp.asarray(fired))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sequential_wrapper_equals_interpret_mode_pallas():
    _, h, w, c, block_e, _, dt, kk = next(x for x in CASES
                                          if x[0] == "small-int8")
    rng = np.random.default_rng(7)
    vm0, kern = tka._tile_and_kernel(rng, h, w, c, kk, dt, 2)
    coords, valid = tka._adversarial_queue(h, w, 4 * block_e, rng,
                                           TGeom(kk, kk))
    vm_p = pad_vm(vm0, TGeom(kk, kk))
    got = event_conv_cuda(vm_p, torch.from_numpy(coords),
                          torch.from_numpy(valid), kern)
    want = event_conv_pallas(_j(vm_p), jnp.asarray(coords),
                             jnp.asarray(valid), _j(kern), block_e=block_e,
                             interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [1, 3, 5])
def test_saturation_rail_reached_and_clamped_by_every_unit(k):
    geom = TGeom(k, k)
    rep = tka.check_saturation(geometry=geom, device="cpu")
    assert rep.ok, rep.summary()
    # six units, two widths, the clamp and the widening headroom each
    assert rep.checked["kernel-sat-overflow"] == 6 * 2 * 2
    units = tka.conv_units(tka.RedZones("cpu", Report()))
    h = 2 * k + 1
    events = torch.tensor([(h // 2 + a, h // 2 + b)
                           for a in range(-(k // 2), k // 2 + 1)
                           for b in range(-(k // 2), k // 2 + 1)],
                          dtype=torch.int32)
    valid = torch.ones((len(events),), dtype=torch.bool)
    tap = 127 // (k * k + 1) + 1
    vm_p = pad_vm(torch.full((h, h, 4), 127 - tap, dtype=torch.int8), geom)
    kern = torch.full((k, k, 4), tap, dtype=torch.int8)
    for name, fn in units.items():
        got = fn(vm_p, events, valid, kern)
        assert got.dtype == torch.int8, name
        assert int(got.max()) == 127 and int(got.min()) >= -128, name


def test_wrapping_adder_is_flagged():
    rep = Report()
    tself.selftest_kernel_audit(rep)
    assert rep.ok and rep.checked["selftest-seeded"] == 1, rep.summary()


def test_red_zones_catch_a_write_past_an_operand():
    rep = Report()
    zones = tka.RedZones("cpu", rep)
    t = zones.empty((4, 3), torch.float32)
    t.fill_(1.0)
    zones.verify("clean")
    assert rep.ok and rep.checked["oob-launch-bounds"] == 1
    t = zones.put(torch.arange(12, dtype=torch.int16))
    t.as_strided((13,), (1,))[12] = 7          # one element past the end
    zones.verify("kernel:planted")
    assert [(f.rule, f.where) for f in rep.findings] == [
        ("oob-launch-bounds", "kernel:planted")]
