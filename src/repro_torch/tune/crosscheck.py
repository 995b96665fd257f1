"""Roofline cross-check of measured winners (port of
``repro.tune.crosscheck``).

JAX costs each candidate's compiled HLO; the port has no HLO, so a
candidate's model time is a Hopper roofline of its conv-unit launches:
the larger of the bytes they must move at the card's memory rate and the
adds they must do at its float32 rate (:func:`roofline_seconds`).  Per
(channel block, time step) a launch reads and writes its membrane tile
once, reads its event input once (queue slots, or the banked carrier)
and reads its taps (:func:`conv_launch_cost`); it adds each kept event
into every tap.  ``chip_smoke.py`` bounds its kernel timings with the
same two functions.

When the measured winner is not the model's pick, or the two times
disagree by more than ``deviation_factor`` either way, the tuner logs it
on the ``repro_torch.tune`` logger (:func:`log_deviation`).
"""
from __future__ import annotations

import logging
import math

from repro_torch.core.aeq import handoff_shape
from repro_torch.kernels.event_conv.ops import EVENT_BYTES
from repro_torch.launch.roofline import PEAK_BYTES, PEAK_F32

log = logging.getLogger("repro_torch.tune")


_BANKED = ("banked-cuda", "fused-handoff")


def roofline_seconds(nbytes: float, adds: float) -> tuple[float, str]:
    """Least time for ``nbytes`` of memory traffic and ``adds`` float32
    operations, and which of the two bounds it ("bytes" or
    "operations")."""
    tb, to = nbytes / PEAK_BYTES, adds / PEAK_F32
    return max(tb, to), ("bytes" if tb >= to else "operations")


def conv_launch_cost(*, tile_elems: int, vm_bytes: int, event_bytes: int,
                     kernel_elems: int, kept: int, taps: int
                     ) -> tuple[int, int]:
    """(bytes, adds) of one conv-unit launch: the tile read and written
    once, ``event_bytes`` of event input and the taps read once; one add
    per kept event and tap."""
    return (2 * tile_elems * vm_bytes + event_bytes
            + kernel_elems * vm_bytes, kept * taps)


def model_microseconds(layers, counts) -> float:
    """Roofline time of the conv launches of ``layers`` (one layer
    candidate, or every layer of a network candidate) on the propagated
    input ``counts`` ((B, T, C_in) spike demand per layer), each queue's
    kept events the demand clipped at the layer's capacity."""
    nbytes = adds = 0
    for lp, cnt in zip(layers, counts):
        batch = cnt.shape[0]
        kh, kw = lp.geometry.kh, lp.geometry.kw
        cb = lp.channel_block
        vm_bytes = {None: 4, 8: 1, 16: 2}[lp.sat_bits]
        if lp.resolve_variant() in _BANKED:
            event_bytes = math.prod(handoff_shape(1, lp.c_in, batch,
                                                  lp.in_hw, lp.geometry))
        else:
            event_bytes = lp.c_in * batch * lp.queue_depth * EVENT_BYTES
        n_blocks = lp.c_out // cb
        for kept in cnt.clamp(max=lp.capacity).sum(dim=(0, 2)).tolist():
            b, a = conv_launch_cost(
                tile_elems=batch * math.prod(lp.vm_tile), vm_bytes=vm_bytes,
                event_bytes=event_bytes, kernel_elems=lp.c_in * kh * kw * cb,
                kept=int(kept), taps=kh * kw * cb)
            nbytes += n_blocks * b
            adds += n_blocks * a
    return roofline_seconds(nbytes, adds)[0] * 1e6


def log_deviation(where: str, ranked: list, *,
                  deviation_factor: float = 4.0) -> None:
    """``ranked``: [(label, measured_us, model_us), ...] sorted by
    measured time; element 0 is the winner.  Logs when measurement and
    model disagree on the ranking or on the winner's magnitude."""
    if not ranked:
        return
    label, us, model_us = ranked[0]
    by_model = min(ranked, key=lambda r: r[2])
    if by_model[0] != label:
        log.info(
            "tune[%s]: measured winner %s (%.1f us) != model pick %s "
            "(model %.1f us vs %.1f us) — analytic prior mis-ranks this "
            "backend", where, label, us, by_model[0], model_us, by_model[2])
    if model_us > 0 and not (1 / deviation_factor
                             <= us / model_us <= deviation_factor):
        log.info(
            "tune[%s]: winner %s measured %.1f us vs %.1f us modelled "
            "(x%.2f) — outside the %.0fx roofline envelope for this "
            "device", where, label, us, model_us, us / model_us,
            deviation_factor)
