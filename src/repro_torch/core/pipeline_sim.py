"""Cycle-level model of the 4-stage convolution-unit pipeline (paper Sec. VI-B).

A numpy-only copy of ``repro.core.pipeline_sim``: the port imports
nothing of the JAX package, and importing that module goes through
``repro.core``, which imports JAX.  Same functions, same numbers.

The FPGA convolution unit is pipelined S1..S4 (address calc, MemPot read,
update, write-back).  Its throughput is 1 event/cycle except for:

* wind-up: 4 cycles until the pipeline is full (per queue start);
* empty queue columns: 1 wasted cycle each (invalid event read, paper
  Sec. VI-A);
* S2-S3 RAW hazards: a 1-cycle stall when two *immediately successive*
  events touch overlapping 3x3 neighbourhoods.  The interlaced AEQ
  ordering guarantees same-column events never overlap, so hazards can
  only occur at column switches.

The thresholding unit then sweeps ceil(H/3)*ceil(W/3) windows per
(c_out, t) with its own 5-stage wind-up.

This simulator reproduces the paper's "PE utilization" metric (Table III):
utilization = cycles in which the PEs process a valid event / total
cycles.  It has no kernel counterpart: it exists to validate the
reproduction against the paper's own numbers and to quantify how much of
the FPGA's stall overhead an accelerator port removes (a kernel that
applies each cell's events in program order has no such hazards).  Pure
numpy on purpose: it models hardware, not math.

P-parallel extension (``parallelism`` > 1): models the event-parallel
design the interlaced kernels implement (PULSE/ExSpike-style): up to P
*same-column* events issue together each cycle — hazard-free because the
interlacing guarantees their neighbourhoods are disjoint — so a column
with c events costs ceil(c/P) issue cycles.  Hazard checks move to group
boundaries at column switches (any cross-group neighbourhood overlap
stalls one cycle, as in the serial design).  ``pe_utilization`` then
counts event-lane occupancy: events / (P * conv cycles) — partial final
groups of a column leave lanes idle, which is exactly the utilization
cost of the parallel design that Table III's extension quantifies.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

WINDUP_CONV = 4     # S1..S4
WINDUP_THRESH = 5   # S1..S5


@dataclass
class CycleReport:
    event_cycles: int       # cycles carrying >=1 valid event (issue cycles)
    hazard_stalls: int      # S2-S3 stalls
    empty_queue_cycles: int # wasted reads of empty columns
    windup_cycles: int      # pipeline fill
    threshold_cycles: int   # dense thresholding sweeps
    total_cycles: int
    parallelism: int = 1    # event lanes per issue cycle (P-parallel PEs)
    events: Optional[int] = None  # valid events processed (= event_cycles at P=1)

    @property
    def pe_utilization(self) -> float:
        """Event-lane occupancy / all conv-unit cycles (paper Table III;
        lanes = parallelism, so the serial design reduces to valid-event
        cycles over total)."""
        conv_total = (self.event_cycles + self.hazard_stalls
                      + self.empty_queue_cycles + self.windup_cycles)
        ev = self.event_cycles if self.events is None else self.events
        return ev / max(self.parallelism * conv_total, 1)


def _columns_of(events: np.ndarray) -> np.ndarray:
    return (events[:, 0] % 3) * 3 + (events[:, 1] % 3)


def _overlap(a: np.ndarray, b: np.ndarray) -> bool:
    """Do the 3x3 neighbourhoods of two events overlap?"""
    return bool(abs(int(a[0]) - int(b[0])) <= 2 and abs(int(a[1]) - int(b[1])) <= 2)


def _groups_of(events: np.ndarray, parallelism: int) -> list[np.ndarray]:
    """Chop an interlace-ordered queue into per-cycle issue groups: runs of
    same-column events, each run split into ceil(len/P) groups of <= P."""
    n = len(events)
    if n == 0:
        return []
    cols = _columns_of(events)
    groups = []
    start = 0
    for a in range(1, n + 1):
        if a == n or cols[a] != cols[start]:
            for g in range(start, a, parallelism):
                groups.append(events[g:min(g + parallelism, a)])
            start = a
    return groups


def simulate_conv_queue(events: np.ndarray,
                        parallelism: int = 1) -> tuple[int, int, int, int]:
    """Simulate one (c_in, t) queue pass through the conv unit.

    events: (N, 2) int array of (i, j), already in interlaced column order
    (aeq.build_aeq order).  Returns (event_cycles, hazard_stalls,
    empty_queue_cycles, windup_cycles); ``event_cycles`` is issue cycles —
    with ``parallelism`` P each cycle retires up to P same-column events,
    so a column of c events needs ceil(c/P) cycles.  Hazards can only
    occur between groups at a column switch (same-column groups are
    disjoint by the interlacing invariant); the serial P=1 case reduces to
    the paper's consecutive-event check.
    """
    events = np.asarray(events).reshape(-1, 2)
    n = len(events)
    cols_present = set(_columns_of(events).tolist()) if n else set()
    empty = 9 - len(cols_present)
    groups = _groups_of(events, parallelism)
    hazards = 0
    for a in range(1, len(groups)):
        prev, cur = groups[a - 1], groups[a]
        if _columns_of(prev[-1:])[0] != _columns_of(cur[:1])[0]:
            if any(_overlap(p, c) for p in prev for c in cur):
                hazards += 1
    windup = WINDUP_CONV if n else 0
    return len(groups), hazards, empty, windup


def simulate_layer(
    per_cin_t_events: list[list[np.ndarray]],
    c_out: int,
    fmap_hw: tuple[int, int],
    parallelism: int = 1,
) -> CycleReport:
    """Cycle model of Algorithm 1 for one layer.

    per_cin_t_events[t][c_in] = (N,2) events of the input AEQ.
    The conv unit runs for every (c_out, t, c_in) queue; the thresholding
    unit sweeps once per (c_out, t).  ``parallelism`` P models the
    interlaced event-parallel conv unit (P hazard-free events per cycle).
    """
    ev = st = em = wu = n_events = 0
    for t_events in per_cin_t_events:
        for q in t_events:
            q = np.asarray(q).reshape(-1, 2)
            e, h, m, w = simulate_conv_queue(q, parallelism)
            ev, st, em, wu = ev + e, st + h, em + m, wu + w
            n_events += len(q)
    # every output channel replays all input queues (Algorithm 1)
    ev, st, em, wu = ev * c_out, st * c_out, em * c_out, wu * c_out
    n_events *= c_out
    h, w = fmap_hw
    sweeps = (-(-h // 3)) * (-(-w // 3)) + WINDUP_THRESH
    thresh = sweeps * c_out * len(per_cin_t_events)
    total = ev + st + em + wu + thresh
    return CycleReport(ev, st, em, wu, thresh, total,
                       parallelism=parallelism, events=n_events)


def throughput_fps(report: CycleReport, clock_hz: float = 333e6, parallelism: int = 1) -> float:
    """Frames/s at the paper's 333 MHz clock with xP parallel units."""
    return clock_hz * parallelism / max(report.total_cycles, 1)
