"""Plan contract auditor of the port (the part of ``repro.analysis`` the
measured tuner loads plans through).

* :mod:`.report` — ``Finding``, ``Report``, ``merge``: findings plus the
  proof obligations each rule discharged, so a clean audit is told apart
  from one that checked nothing.
* :mod:`.contracts` — ``CONTRACTS``, ``audit_plan``, ``sweep_cases``,
  ``run_contracts``: the plan-time sizing invariants, re-proven over one
  plan or over a geometry sweep grid.

The hazard proofs, the kernel audit and the lint rules of
``repro.analysis`` are not ported yet.
"""
from .contracts import CONTRACTS, audit_plan, run_contracts, sweep_cases
from .report import Finding, Report, merge

__all__ = ["CONTRACTS", "Finding", "Report", "audit_plan", "merge",
           "run_contracts", "sweep_cases"]
