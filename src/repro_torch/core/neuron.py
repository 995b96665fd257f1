"""Integrate-and-fire neuron models (paper Eqs. 1-7; port of
``repro.core.neuron``).

The paper uses the time-discrete IF model with the m-TTFS neural code of
Han & Roy: once a neuron's membrane potential has crossed the firing
threshold ``v_t`` it emits a spike on every later algorithmic time step
until the network is reset.  The "has fired" property is stored as a
spike-indicator bit beside the membrane potential (paper Sec. VI-C).

Every function is shape-polymorphic: ``v_m`` may be any tensor and the
spike map has its shape.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .threshold import as_vm_scalar


class IFState(NamedTuple):
    """State of a population of IF neurons.

    v_m:   membrane potentials (float or quantized int).
    fired: m-TTFS spike-indicator bit, True once the neuron has spiked.
    """

    v_m: torch.Tensor
    fired: torch.Tensor

    @staticmethod
    def zeros(shape, dtype=torch.float32, device="cuda") -> "IFState":
        return IFState(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=torch.bool, device=device))


def if_reset_step(v_m: torch.Tensor, current: torch.Tensor,
                  v_t) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain IF step with reset to zero (paper Eqs. 1-2), the rate-coding
    baseline.  Returns ``(new_v_m, spikes)``; the reset happens on the
    step after the threshold crossing, as Eq. (1) writes it."""
    spikes = v_m > v_t
    v_m = torch.where(spikes, torch.zeros_like(v_m), v_m) + current
    return v_m, spikes


def mttfs_step(state: IFState, current: torch.Tensor,
               v_t) -> tuple[IFState, torch.Tensor]:
    """m-TTFS IF step (paper Eqs. 3-4 and the Sec. VI-C indicator): the
    potential keeps integrating (no reset); the neuron spikes when
    ``v_m > v_t`` or when it has fired before.  ``v_t`` is cast to the
    potentials' dtype (truncated for an int datapath).  Returns
    ``(new_state, spikes)``."""
    v_m = state.v_m + current
    spikes = (v_m > as_vm_scalar(v_t, v_m.dtype)) | state.fired
    return IFState(v_m, spikes), spikes


def ttfs_slope_step(mu_m: torch.Tensor, v_m: torch.Tensor,
                    fired: torch.Tensor, current: torch.Tensor, v_t
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Slope-based TTFS neuron of Rueckauer et al. (paper Eqs. 5-7), the
    baseline: the potential grows by the slope ``mu_m`` every step, the
    slope integrates the weighted input spikes, and each neuron fires at
    most once.  Returns ``(mu_m, v_m, fired, spikes)``."""
    v_m = v_m + mu_m                 # Eq. (6): the slope drives the potential
    mu_m = mu_m + current            # Eq. (5): inputs move the slope
    spikes = (v_m > as_vm_scalar(v_t, v_m.dtype)) & ~fired  # Eq. (7)
    return mu_m, v_m, fired | spikes, spikes
