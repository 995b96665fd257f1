"""Fault-tolerance runtime: heartbeats, straggler detection, elastic remesh
(the port's own copy of ``repro.runtime.health``: pure Python, the same
decisions).

Hardware-independent control-plane logic, designed for 1000+-node jobs
and unit-tested with injectable clocks (no real cluster needed to verify
the policies):

* ``HeartbeatTracker`` — hosts report per-step heartbeats; silence beyond
  ``timeout`` marks a host dead (the signal a real deployment gets from
  the coordinator / GCP maintenance events).
* ``StragglerDetector`` — per-step durations per host; hosts slower than
  ``factor`` x running median for ``patience`` consecutive steps are
  flagged.  Policy hooks: log, exclude at next remesh, or
  trigger the backup-replica step (documented; needs real collectives).
* ``ElasticPlanner`` — given the healthy-host count and the model's
  parallelism constraints (model axis is fixed by tensor-parallel
  divisibility; data/pod axes are elastic), pick the largest valid
  (pod, data, model) factorization <= healthy devices.  The training
  loop then: checkpoint -> rebuild mesh (the mesh layer)
  -> restore (checkpoints are mesh-agnostic, ``checkpoint.ckpt``) ->
  continue.  This is the shrink/expand protocol (``train.loop.run``'s
  ``on_remesh`` hook).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable, Optional


@dataclasses.dataclass
class HostState:
    last_seen: float
    step_times: list = dataclasses.field(default_factory=list)
    slow_streak: int = 0


class HeartbeatTracker:
    def __init__(self, hosts: list[str], timeout: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.clock = clock
        self.timeout = timeout
        now = clock()
        self.hosts = {h: HostState(last_seen=now) for h in hosts}

    def beat(self, host: str):
        self.hosts[host].last_seen = self.clock()

    def dead_hosts(self) -> list[str]:
        now = self.clock()
        return [h for h, st in self.hosts.items()
                if now - st.last_seen > self.timeout]

    def alive_hosts(self) -> list[str]:
        dead = set(self.dead_hosts())
        return [h for h in self.hosts if h not in dead]


class StragglerDetector:
    """Flags hosts persistently slower than the fleet median."""

    def __init__(self, factor: float = 1.5, patience: int = 3, window: int = 20):
        self.factor = factor
        self.patience = patience
        self.window = window
        self.hosts: dict[str, HostState] = {}

    def record(self, host: str, step_seconds: float):
        st = self.hosts.setdefault(host, HostState(last_seen=0.0))
        st.step_times.append(step_seconds)
        if len(st.step_times) > self.window:
            st.step_times.pop(0)

    def stragglers(self) -> list[str]:
        latest = {h: st.step_times[-1] for h, st in self.hosts.items()
                  if st.step_times}
        if len(latest) < 3:
            return []
        med = statistics.median(latest.values())
        out = []
        for h, t in latest.items():
            st = self.hosts[h]
            if t > self.factor * med:
                st.slow_streak += 1
            else:
                st.slow_streak = 0
            if st.slow_streak >= self.patience:
                out.append(h)
        return out


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axes: tuple[str, ...]
    devices_used: int
    dropped: int


class ElasticPlanner:
    """Largest valid mesh under the current healthy-device count.

    model_parallel is fixed (tensor shapes constrain it); the data axis
    absorbs elasticity; a pod axis is re-introduced whenever the healthy
    count spans multiples of ``pod_size``.
    """

    def __init__(self, model_parallel: int = 16, pod_size: int = 256,
                 min_data: int = 1):
        self.mp = model_parallel
        self.pod_size = pod_size
        self.min_data = min_data

    def plan(self, healthy_devices: int) -> MeshPlan:
        if healthy_devices < self.mp * self.min_data:
            raise RuntimeError(
                f"{healthy_devices} healthy devices cannot host model_parallel="
                f"{self.mp} x min_data={self.min_data}")
        usable = (healthy_devices // self.mp) * self.mp
        data = usable // self.mp
        pods = max(1, usable // self.pod_size)
        if pods > 1 and data % pods == 0:
            shape = (pods, data // pods, self.mp)
            axes = ("pod", "data", "model")
            used = pods * (data // pods) * self.mp
        else:
            shape = (data, self.mp)
            axes = ("data", "model")
            used = data * self.mp
        return MeshPlan(shape=shape, axes=axes, devices_used=used,
                        dropped=healthy_devices - used)


@dataclasses.dataclass
class FailureEvent:
    step: int
    kind: str           # "dead_host" | "straggler" | "preemption"
    hosts: list


class FaultPolicy:
    """Orchestration policy consumed by ``train.loop.run``.

    decide() returns one of: "continue", "checkpoint_now", "remesh".
    """

    def __init__(self, tracker: HeartbeatTracker, detector: StragglerDetector,
                 planner: ElasticPlanner, devices_per_host: int = 4):
        self.tracker = tracker
        self.detector = detector
        self.planner = planner
        self.devices_per_host = devices_per_host
        self.events: list[FailureEvent] = []

    def decide(self, step: int, preempted: bool = False) -> str:
        if preempted:
            self.events.append(FailureEvent(step, "preemption", []))
            return "checkpoint_now"
        dead = self.tracker.dead_hosts()
        if dead:
            self.events.append(FailureEvent(step, "dead_host", dead))
            return "remesh"
        slow = self.detector.stragglers()
        if slow:
            self.events.append(FailureEvent(step, "straggler", slow))
            # policy: tolerate stragglers until they die or a remesh is due;
            # a real deployment would also divert their shards (backup steps)
            return "continue"
        return "continue"

    def replan(self) -> MeshPlan:
        healthy = len(self.tracker.alive_hosts()) * self.devices_per_host
        return self.planner.plan(healthy)
