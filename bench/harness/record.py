"""What the harness hands a cell's loop, and the record of a run that the
metric readers read.  Shared by every loop in ``loops/``."""
from __future__ import annotations

import gc
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from .trace import Trace


@dataclass
class Program:
    """The program under test as a configuration's builder sets it up."""
    cfg: Any               # the program's own configuration object
    plan: Any              # the plan pinned in the configuration file
    params: dict           # the weights, as the benchmark made them
    entry: Callable        # the entry the loop drives, looked up at set-up
    encode: Optional[Callable] = None  # the program's encode of raw inputs


@dataclass
class Pool:
    """The inputs a cell's traffic draws from, rows in the run's order.

    ``data`` is what the loop feeds the program (a tensor or a list, one
    row per input), ``kind`` says what a row is (``"images"``,
    ``"spikes"``, ...).  ``reference`` is the same rows as the reference
    reads them, as a (data, kind) pair, where that differs."""
    data: Any
    kind: str
    reference: Optional[tuple] = None

    def __len__(self) -> int:
        return len(self.data)

    @property
    def for_reference(self) -> tuple:
        return self.reference or (self.data, self.kind)


@dataclass
class Setup:
    device: torch.device
    program: Program
    net: dict              # the configuration file's network
    traffic: dict          # the traffic file
    pool: Pool
    seed: int
    seconds: float
    trace: bool


@dataclass
class Run:
    window_s: float
    due: int = 0                       # answers due (window and after)
    answers: list = field(default_factory=list)  # (pool rows, logits)
    window_rows: list = field(default_factory=list)  # rows answered in it
    span_s: float = 0.0                # window start to its last answer
    enqueue_s: list = field(default_factory=list)  # host s per forward call
    traced_rows: list = field(default_factory=list)  # rows per traced fwd
    latencies_s: list = field(default_factory=list)  # per request due
    trace: Optional[Trace] = None
    engine: Optional[dict] = None      # engine counters over the window
    max_batch: int = 0
    lateness_s: float = 0.0
    setup_s: float = 0.0
    # filled from the reference after the window
    adds: float = 0.0                  # synaptic adds answered in the window
    traced_least_s: float = 0.0        # least conv time of traced forwards

    @property
    def samples(self) -> int:
        return sum(len(r) for r in self.window_rows)


def settle_gc() -> None:
    """Collect, then move every object made so far out of the collector's
    reach, so that its pauses in the window scale with the window's own
    garbage and not with the set-up's."""
    gc.collect()
    gc.freeze()
