"""Static verification layer of the port (counterpart of
``repro.analysis``): plan contracts, hazard proofs, the kernel audit, the
lint and a self-test.

    python -m repro_torch.analysis [--json [PATH]] [--only PASS] [--selftest]
                                   [--device cuda|cpu]

It exits non-zero on any finding (and on ``--device cuda`` without a
card) and ``--json`` writes ``ANALYSIS_report.json``: findings plus the
proof obligations each rule discharged, so a clean run is told apart from
one that checked nothing.  Passes and rules, with their JAX counterparts:

``contracts`` (:mod:`.contracts`) — JAX's plan rules with the port's
variant names; ``plan-smem-budget`` (one CTA tile against a block's
shared memory) replaces ``plan-vmem-budget``.  The measured tuner loads
every cached plan through :func:`audit_plan`.

``hazards`` (:mod:`.hazards`) — JAX's ids over k in {1, 3, 5}:
``hazard-column-disjoint``, ``hazard-mask-routing``,
``hazard-banked-masks``, ``hazard-segment-homogeneous``,
``hazard-segment-replay`` on the port's own layouts; ``oob-event-patch``
proves the CUDA gather's window clamp is the identity on valid
coordinates (JAX: the ``pl.dslice`` bounds); ``oob-launch-bounds``
replaces ``oob-blockspec-bounds``: the operands every sweep plan and
kernel-sweep shape hands each wrapper pass that wrapper's own checks.

``kernels`` (:mod:`.kernel_audit`) — JAX's four ids with the wrappers on
the audit device (``cuda``: the seven conv and threshold kernels, the
tile path of the batched interlaced unit and the event-set builder, each
of which must count a launch; ``cpu``:
their plain versions): ``kernel-shape-contract``,
``kernel-value-parity``, ``kernel-checkify`` (explicit index and NaN
checks, as torch has no ``checkify``), ``kernel-sat-overflow``.  Every
operand sits in red zones, checked under ``oob-launch-bounds``.

``lint`` (:mod:`.lint`) — ``lint-mutable-default`` (JAX's),
``lint-kernel-launch-outside-kernels`` (JAX:
``lint-pallas-call-outside-kernels``), ``lint-host-sync-in-hot-path``
(JAX: ``lint-tracer-cast`` and ``lint-host-call-in-jit``),
``lint-global-rng`` (the random half of ``lint-host-call-in-jit``) and
``lint-reference-import``; ``lint-missing-donate`` has no counterpart, as
the port updates its state in place.  ``# analysis: ignore[rule]`` on the
flagged line or the line above suppresses a lint finding; the semantic
passes have no escape.

``--selftest`` (:mod:`.selftest`) — every seeded violation (JAX's
fixtures that have a port rule, plus one per new rule) must be flagged,
or ``selftest-missed`` fails the run.
"""
from .contracts import CONTRACTS, audit_plan, run_contracts, sweep_cases
from .report import Finding, Report, merge

__all__ = ["CONTRACTS", "Finding", "Report", "audit_plan", "merge",
           "run_contracts", "sweep_cases"]
