"""The comparison that decides ``correct``: the program's answers against
the reference's, on the same inputs and weights.

The weights lie on a grid on which every membrane sum is exact in
float32 (``builders/csnn.make_weights``), and the head sums exact spike
counts in float64 on both sides, so a float32 program gives the
reference's logits bit for bit.  Two numbers, each with its limit from
the configuration file:

* ``missing``: answers due that never came, or came non-finite;
* ``differ_pct``: the share of the answers that came, in %, whose logits
  are not bit for bit the reference's: one spike that differs anywhere in
  the network, one answer altered or lost, or a lower precision shows.
"""
from __future__ import annotations

import torch


def numbers(got: torch.Tensor, want: torch.Tensor, due: int) -> dict:
    """``got`` (M, n_out) program logits of the answers that came, ``want``
    the reference's logits of the same inputs, ``due`` the answers due."""
    finite = torch.isfinite(got).all(dim=1)
    missing = due - int(finite.sum())
    if got.shape[0] == 0:
        return {"missing": missing, "differ_pct": 100.0}
    differ = (got != want).any(dim=1) | ~finite
    return {"missing": missing,
            "differ_pct": 100.0 * float(differ.double().mean())}


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; ``missing`` must be 0."""
    checks = {"missing": {"value": nums["missing"], "limit": 0},
              "differ_pct": {"value": nums["differ_pct"],
                             "limit": limits["differ_pct"]}}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
