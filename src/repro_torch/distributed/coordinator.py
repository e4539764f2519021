"""Fault-tolerance coordinator: heartbeats, failure detection, straggler
mitigation, and restart orchestration.

At datacenter scale (1000+ hosts) the coordinator is the control-plane
counterpart of LithOS's device scheduler: it watches per-host liveness and
per-step timing, and drives the recovery state machine:

    HEALTHY -> (missed heartbeats) -> SUSPECT -> (timeout) -> FAILED
      -> shrink the data axis (elastic.py) -> restore latest checkpoint
      -> resume

Straggler mitigation mirrors the paper's TPC-stealing philosophy at the
pod level: hosts whose step times exceed ``straggler_factor`` x the fleet
median get their best-effort colocated work throttled first (hook), and are
excluded from the critical path by rebalancing if they persist.

The coordinator is deliberately transport-agnostic: ``heartbeat()`` /
``report_step()`` are called by the training loop (launch/train.py); in a
real deployment they arrive over RPC, in tests they are called directly
with a simulated clock.

Pure Python, the same state machine as the JAX package's: the same inputs
on the same clock give the same ``events`` and states.
"""
from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, Optional


class HostState(Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    FAILED = "failed"
    STRAGGLER = "straggler"


@dataclass
class CoordinatorConfig:
    heartbeat_interval: float = 5.0
    suspect_after: float = 15.0          # missed-heartbeat window
    fail_after: float = 45.0
    straggler_factor: float = 1.5
    straggler_window: int = 8            # steps of history per host
    min_hosts: int = 1


@dataclass
class _Host:
    hid: int
    last_beat: float = 0.0
    state: HostState = HostState.HEALTHY
    step_times: list[float] = field(default_factory=list)


class Coordinator:
    def __init__(self, n_hosts: int, config: CoordinatorConfig = CoordinatorConfig(),
                 clock: Optional[Callable[[], float]] = None):
        self.cfg = config
        self.clock = clock or time.monotonic
        now = self.clock()
        self.hosts = {h: _Host(h, last_beat=now) for h in range(n_hosts)}
        self.events: list[tuple[float, str, int]] = []
        # callbacks wired by the training loop
        self.on_fail: Optional[Callable[[list[int]], None]] = None
        self.on_straggler: Optional[Callable[[int], None]] = None

    # -- inputs ----------------------------------------------------------------

    def heartbeat(self, hid: int):
        h = self.hosts[hid]
        h.last_beat = self.clock()
        if h.state == HostState.SUSPECT:
            h.state = HostState.HEALTHY
            self.events.append((h.last_beat, "recovered", hid))

    def report_step(self, hid: int, step_seconds: float):
        h = self.hosts[hid]
        h.step_times.append(step_seconds)
        if len(h.step_times) > self.cfg.straggler_window:
            h.step_times.pop(0)
        self.heartbeat(hid)

    # -- evaluation --------------------------------------------------------------

    def alive(self) -> list[int]:
        return [h.hid for h in self.hosts.values()
                if h.state != HostState.FAILED]

    def check(self) -> dict[int, HostState]:
        """Advance the liveness/straggler state machine; fire callbacks."""
        now = self.clock()
        newly_failed = []
        for h in self.hosts.values():
            if h.state == HostState.FAILED:
                continue
            silent = now - h.last_beat
            if silent > self.cfg.fail_after:
                h.state = HostState.FAILED
                newly_failed.append(h.hid)
                self.events.append((now, "failed", h.hid))
            elif silent > self.cfg.suspect_after:
                if h.state != HostState.SUSPECT:
                    self.events.append((now, "suspect", h.hid))
                h.state = HostState.SUSPECT
        if newly_failed and self.on_fail:
            self.on_fail(newly_failed)
        self._check_stragglers(now)
        return {h.hid: h.state for h in self.hosts.values()}

    def _check_stragglers(self, now: float):
        samples = {h.hid: statistics.median(h.step_times)
                   for h in self.hosts.values()
                   if h.state in (HostState.HEALTHY, HostState.STRAGGLER)
                   and len(h.step_times) >= 3}
        if len(samples) < 2:
            return
        med = statistics.median(samples.values())
        for hid, t in samples.items():
            h = self.hosts[hid]
            if t > self.cfg.straggler_factor * med:
                if h.state != HostState.STRAGGLER:
                    h.state = HostState.STRAGGLER
                    self.events.append((now, "straggler", hid))
                    if self.on_straggler:
                        self.on_straggler(hid)
            elif h.state == HostState.STRAGGLER:
                h.state = HostState.HEALTHY
                self.events.append((now, "destraggled", hid))

    def fleet_ok(self) -> bool:
        return len(self.alive()) >= self.cfg.min_hosts
