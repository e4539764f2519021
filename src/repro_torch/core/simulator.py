"""Calibrated discrete-event device simulator (the timing plane).

Executes :class:`KernelTask`s on a :class:`DeviceSpec` under a pluggable
scheduling :class:`Policy`.  Ground-truth latencies come from the roofline
cost model; the OS components observe only :class:`CompletionRecord`s — they
never see flops/bytes — so predictor / right-sizer / DVFS learn online
exactly as on real hardware.

Execution model (fluid DES): an in-flight kernel has a fixed *overhead*
phase (launch/tail, wall time) followed by a *divisible* phase that drains at
a rate set by its current slice allocation and the device frequency.  The
policy's ``allocations()`` is re-evaluated at every event, so policies may
space-partition (LithOS, MIG), processor-share (MPS), prioritize (Priority),
gate (REEF/TGS/Orion), or time-slice.  Preemption support: ``kill()``
requeues a kernel with all progress lost (REEF reset semantics).

Energy: device power P = static + n*idle + busy*dyn*(f/fmax)^3 integrated
between events.
"""
from __future__ import annotations

import heapq
import itertools
import math
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from repro_torch.core.costmodel import CostModel, WorkPhases
from repro_torch.core.queues import Client
from repro_torch.core.types import (CompletionRecord, DeviceSpec, KernelTask,
                                    Priority)
from repro_torch.core.workloads import AppSpec


@dataclass
class ExecKernel:
    """An in-flight kernel/atom."""

    task: KernelTask
    client: Client
    phases: WorkPhases
    t_submit: float
    t_start: float
    overhead_left: float
    div_left: float = 1.0               # fraction of divisible phase left
    slices: int = 0
    slice_set: tuple[int, ...] = ()
    stolen: bool = False
    gen: int = 0                        # event-invalidation counter

    interference: float = 1.0           # speed factor (set by simulator)

    def speed(self, f: float, occupancy: int) -> float:
        """d(div_left)/dt at allocation ``slices`` and rel. frequency f."""
        if self.slices <= 0:
            return 0.0
        t_div = self.phases.divisible_time(self.slices, f, occupancy)
        return (self.interference / t_div) if t_div > 0 else float("inf")

    def eta(self, f: float, occupancy: int) -> float:
        if self.slices <= 0:
            return float("inf")
        sp = self.speed(f, occupancy)
        div_t = self.div_left / sp if sp != float("inf") else 0.0
        return self.overhead_left + div_t


class Policy:
    """Scheduling policy interface (subclassed by LithOS and baselines).

    Slice allocations follow GPU block semantics: granted at dispatch, may
    GROW mid-flight (remaining blocks spread onto freed slices) but never
    shrink — running thread blocks are non-preemptible.  Policies that model
    hardware context switching (TimeSlice) set ``allow_shrink``; REEF-style
    reset preemption uses ``Simulator.kill`` instead.
    """

    name = "base"
    tick_interval: float = 0.0          # >0: periodic on_tick callbacks
    allow_shrink: bool = False
    # Cross-tenant interference when kernels from multiple clients are
    # co-resident (L2/HBM/scheduler contention — the cost of MPS-style
    # stacking the paper's §2.2 describes).  Spatially isolating policies
    # (LithOS, MIG) keep 0; MPS/Priority/TGS pay it.
    interference_penalty: float = 0.0
    # Cross-device migration protocol (node-level lending).  A policy that
    # opts in implements hold/drain/export/import below; the coordinator
    # never migrates between policies that do not.
    supports_migration: bool = False

    def attach(self, sim: "Simulator"):
        self.sim = sim

    def step(self, now: float):
        """Called after every event: examine queues, dispatch kernels."""
        raise NotImplementedError

    def allocations(self, now: float) -> dict[int, int]:
        """kid -> slices for all in-flight kernels, re-evaluated per event.
        Default: keep each kernel's current allocation."""
        return {ek.task.kid: ek.slices for ek in self.sim.in_flight.values()}

    def alloc_changes(self, now: float) -> Optional[dict[int, int]]:
        """Allocation *deltas* for the vectorized engine (engine_vec).

        Return a (possibly empty) dict of kid -> slices covering every
        in-flight kernel whose allocation MAY differ from its current one;
        kernels absent from the dict are promised unchanged, so the engine
        can skip the per-kernel compare-and-reschedule scan entirely when
        the dict is empty.  Return None (the default) to make the engine
        fall back to a full ``allocations()`` comparison — always correct,
        never fast.  The reference engine never calls this; results must be
        identical either way (the parity suite runs both)."""
        return None

    def on_complete(self, ek: ExecKernel, rec: CompletionRecord):
        pass

    def on_tick(self, now: float):
        pass

    def on_fault(self, f, now: float):
        """React to an injected :class:`~repro_torch.core.types.FaultEvent` on
        this device (simulator callback; never called on fault-free runs).

        ``device_dead`` contract: when this returns, nothing may remain in
        flight — the generic implementation REEF-kills every in-flight
        kernel and puts its task back at the owning client's queue head,
        so the tier above can evacuate intact launch queues.
        ``slice_retired`` is a no-op here (policies without slice
        ownership see the shrink through ``sim.free_slices``);
        ownership-aware policies override (LithOSScheduler retires the
        slice in its SliceMap and shrinks the owner's quota)."""
        if f.kind != "device_dead":
            return
        for kid in list(self.sim.in_flight):
            ek = self.sim.in_flight[kid]
            task = self.sim.kill(kid)
            if task is not None and not task.is_atom:
                ek.client.requeue(task)

    # -- migration protocol (node-level lending; no-ops by default) ---------

    def hold_client(self, cid: int):
        """Stop planning new kernels for ``cid`` (drain toward a kernel
        boundary).  In-flight work still completes."""

    def release_hold(self, cid: int):
        """Resume dispatching for ``cid`` (migration landed or aborted)."""

    def client_drained(self, cid: int) -> bool:
        """True when ``cid`` sits at a kernel boundary: nothing in flight
        and nothing planned — safe to move its launch queue."""
        c = self.sim.client_by_id.get(cid)
        return c is not None and c.outstanding == 0

    def export_client_state(self, cid: int) -> dict:
        """Forget a migrating client; return warm state for the target
        policy (predictor observations etc.).

        Contract: for any policy P with learned per-client state, running
        ``target.import_client_state(cid, prio, src.export_client_state(cid))``
        must reproduce that state *exactly* on the target — same predictor
        nodes, same quota — and remove it from the source (no double
        residency).  The base class carries no per-client state, so it
        returns ``{}`` and ``import_client_state`` is a no-op; a policy that
        learns per-client state MUST override both sides or migration
        silently discards its warm state (test_policy_state asserts the
        round-trip for LithOSScheduler)."""
        return {}

    def import_client_state(self, cid: int, priority, state: dict):
        """Admit a migrated client, warming from the source's state."""


class Simulator:
    #: engine discriminator — VecSimulator (engine_vec) sets True; policies
    #: branch on ``getattr(sim, "vec", False)`` to pick their fast paths
    vec = False

    def __init__(self, device: DeviceSpec, apps: list[AppSpec],
                 policy: Policy, *, horizon: float = 30.0, seed: int = 0,
                 cids: Optional[list[int]] = None,
                 collect_records: bool = True,
                 faults=()):
        """``cids`` gives each app an explicit client id (default 0..n-1).
        The node layer passes node-global ids so a tenant keeps the same id
        (and hence the same workload random stream) under any placement.

        ``collect_records=False`` is the lean-memory mode for throughput
        benchmarks on million-request traces: per-kernel CompletionRecords
        are not retained and completed jobs drop their batch/task objects.
        Timing, energy and client metrics are unaffected; it applies
        identically to both engines so comparisons stay fair."""
        self.device = device
        self.cost = CostModel(device)
        self.policy = policy
        self.horizon = horizon
        self.now = 0.0
        self.freq = 1.0
        self._pending_freq: Optional[float] = None
        self.in_flight: dict[int, ExecKernel] = {}
        self._heap: list[tuple[float, int, str, object]] = []
        self._counter = itertools.count()
        self.energy = 0.0
        self.busy_slice_seconds = 0.0
        self.events = 0             # events processed (throughput metric)
        self.records: list[CompletionRecord] = []
        self.collect_records = collect_records
        self.done = False
        # Injected hardware faults (FaultEvents targeting this device).
        # Empty on fault-free runs: zero extra heap events, so behavior is
        # bit-for-bit identical to a build without fault support.
        self._fault_events = tuple(faults or ())
        self.dead = False               # device_dead fired
        self.n_retired = 0              # slices lost to slice_retired
        self.fault_log: list = []       # (t, FaultEvent) as applied
        # arrival-stream generation per client: bumped on detach so stale
        # arrival events left in the heap are ignored if the client returns
        self._arr_gen: dict[int, int] = {}
        if cids is None:
            cids = list(range(len(apps)))
        assert len(cids) == len(apps) and len(set(cids)) == len(cids)
        self.clients = [Client(cid, a, horizon, seed=seed)
                        for cid, a in zip(cids, apps)]
        # Per-simulator kernel-id stream: kid assignment depends only on
        # this simulator's own event order, so interleaving several
        # simulators (node/cluster tiers) is unobservable in the records —
        # sequential and interleaved runs stay bit-for-bit identical.
        self.kernel_ids = itertools.count()
        for c in self.clients:
            c.kids = self.kernel_ids
        if not collect_records:
            for c in self.clients:
                c._drop_batches = True
        self.client_by_id = {c.cid: c for c in self.clients}
        policy.attach(self)

    # -- event plumbing ---------------------------------------------------------

    def _push(self, t: float, kind: str, payload: object = None):
        heapq.heappush(self._heap, (t, next(self._counter), kind, payload))

    def set_frequency(self, f: float):
        """Request a frequency switch (takes f_switch_latency)."""
        if abs(f - self.freq) < 1e-9 or self._pending_freq is not None:
            return
        self._pending_freq = f
        self._push(self.now + self.device.f_switch_latency, "fswitch", f)

    # -- dispatch interface (called by policies) ---------------------------------

    def start_kernel(self, client: Client, task: KernelTask, slices: int,
                     *, slice_set: tuple[int, ...] = (),
                     stolen: bool = False, t_submit: Optional[float] = None
                     ) -> ExecKernel:
        phases = self.cost.phases(task.work)
        ek = ExecKernel(task=task, client=client, phases=phases,
                        t_submit=self.now if t_submit is None else t_submit,
                        t_start=self.now,
                        overhead_left=phases.overhead,
                        slices=max(0, slices), slice_set=slice_set,
                        stolen=stolen)
        self.in_flight[task.kid] = ek
        self._schedule_completion(ek)
        return ek

    def kill(self, kid: int) -> Optional[KernelTask]:
        """REEF-style reset: drop an in-flight kernel, losing progress."""
        ek = self.in_flight.pop(kid, None)
        if ek is None:
            return None
        ek.gen += 1
        return ek.task

    def _schedule_completion(self, ek: ExecKernel):
        ek.gen += 1
        eta = ek.eta(self.freq, self.device.occupancy)
        if eta != float("inf"):
            self._push(self.now + eta, "complete", (ek.task.kid, ek.gen))

    # -- state advance ------------------------------------------------------------

    def _advance(self, t_new: float):
        dt = t_new - self.now
        if dt <= 0:
            self.now = max(self.now, t_new)
            return
        busy = min(sum(min(ek.slices, ek.phases.max_useful_slices)
                       for ek in self.in_flight.values()),
                   self.device.n_slices)
        self.energy += dt * self.device.power(busy, self.freq)
        self.busy_slice_seconds += dt * busy
        for ek in self.in_flight.values():
            used = dt
            if ek.overhead_left > 0:
                o = min(ek.overhead_left, used)
                ek.overhead_left -= o
                used -= o
            if used > 0 and ek.div_left > 0:
                ek.div_left = max(
                    0.0, ek.div_left - used * ek.speed(self.freq,
                                                       self.device.occupancy))
            # capacity accounting: slices HELD (denied to other tenants),
            # not just usefully busy — right-sizing savings live here
            ek.client.slice_seconds += dt * ek.slices
        self.now = t_new

    def _apply_allocations(self):
        alloc = self.policy.allocations(self.now)
        # interference: multiple tenants co-resident slow everyone down
        pen = self.policy.interference_penalty
        n_tenants = len({ek.client.cid for ek in self.in_flight.values()})
        factor = max(0.3, 1.0 - pen * (n_tenants - 1)) if pen else 1.0
        changed = []
        for kid, ek in self.in_flight.items():
            s = max(0, alloc.get(kid, ek.slices))
            if not self.policy.allow_shrink:
                s = max(s, ek.slices)      # blocks are non-preemptible
            if s != ek.slices or abs(factor - ek.interference) > 1e-9:
                ek.slices = s
                ek.interference = factor
                changed.append(ek)
        for ek in changed:
            self._schedule_completion(ek)
        return changed

    def held_slices(self) -> int:
        return sum(ek.slices for ek in self.in_flight.values())

    def free_slices(self) -> int:
        return max(0, self.device.n_slices - self.n_retired
                   - self.held_slices())

    # -- fault injection ---------------------------------------------------------

    def _apply_fault(self, f) -> bool:
        """Apply one injected FaultEvent.  Returns True when the fault
        permanently kills the device (the caller ends the event stream)."""
        self.fault_log.append((self.now, f))
        if f.kind == "transient_stall":
            # SXid-style hiccup: every in-flight kernel stalls for
            # ``duration`` wall seconds (modeled as extra overhead phase)
            for ek in self.in_flight.values():
                ek.overhead_left += f.duration
                self._schedule_completion(ek)
            return False
        if f.kind == "slice_retired":
            self.n_retired += 1
            self.policy.on_fault(f, self.now)
            return False
        # device_dead: the policy resets in-flight work back onto the
        # clients' launch queues (REEF kill semantics) so the tier above
        # can evacuate intact queues; then the device stops for good.
        self.policy.on_fault(f, self.now)
        assert not self.in_flight, \
            "policy.on_fault(device_dead) must clear all in-flight work"
        self.dead = True
        return True

    def _complete(self, ek: ExecKernel):
        del self.in_flight[ek.task.kid]
        rec = CompletionRecord(task=ek.task, t_submit=ek.t_submit,
                               t_start=ek.t_start, t_end=self.now,
                               slices=ek.slices, freq=self.freq)
        if self.collect_records:
            self.records.append(rec)
        self.policy.on_complete(ek, rec)

    # -- client migration (node-level lending protocol) --------------------------

    def detach_client(self, cid: int) -> "Client":
        """Remove a *drained* client so its launch queue can move to another
        device.  Future arrival events it left in the heap are invalidated
        via the per-client arrival generation."""
        c = self.client_by_id.pop(cid)
        assert c.outstanding == 0, "detach requires a drained launch queue"
        self.clients.remove(c)
        self._arr_gen[cid] = self._arr_gen.get(cid, 0) + 1
        return c

    def admit_client(self, client: "Client", after: float):
        """Add a migrated-in client immediately (it appears in this
        simulator's result even if the horizon ends before it runs).  The
        caller gates dispatch via the policy's hold until the migration
        cost has been paid (:meth:`schedule_release`).

        ``after`` is the migration instant on the *source* clock: arrivals
        at or before it already fired there (their jobs travel in the
        client's pending queue), so only strictly later ones are re-seeded
        here — this simulator's own clock may still lag behind."""
        assert client.cid not in self.client_by_id
        # Re-key the client into this simulator's kernel-id stream: its
        # undispatched queue still carries source-simulator kids, which
        # could collide with ids already dealt here (in_flight and the
        # SliceMap are kid-keyed).  Dispatched tasks are left alone —
        # their completion records live in the source simulator.
        client.kids = self.kernel_ids
        for task in client.undispatched_tasks():
            task.kid = next(self.kernel_ids)
        self.clients.append(client)
        self.client_by_id[client.cid] = client
        gen = self._arr_gen.get(client.cid, 0)
        for t in client.arrivals():          # open-loop: future arrivals
            if t > after:
                self._push(t, "arrival", (client.cid, gen))

    def schedule_release(self, cid: int, at: float):
        """Schedule the end of a migrated client's hold (migration cost)."""
        self._push(max(at, self.now), "unhold", cid)

    # -- main loop ------------------------------------------------------------------

    def start(self):
        """Seed the event heap; call once before stepping."""
        for c in self.clients:
            for t in c.arrivals():
                self._push(t, "arrival", (c.cid, 0))
            if c.closed_loop:
                self._push(0.0, "arrival", (c.cid, 0))
        if self.policy.tick_interval > 0:
            self._push(self.policy.tick_interval, "tick", None)
        self._push(self.horizon, "end", None)
        for f in self._fault_events:
            self._push(f.t, "fault", f)

    def peek_time(self) -> Optional[float]:
        """Timestamp of the next pending event (None when finished)."""
        if self.done or not self._heap:
            return None
        return self._heap[0][0]

    def step_event(self) -> bool:
        """Process exactly one event (one iteration of the historical run
        loop).  Returns False once the run is over."""
        if self.done or not self._heap:
            self.done = True
            return False
        t, _, kind, payload = heapq.heappop(self._heap)
        self.events += 1
        if t > self.horizon and kind != "end":
            return True                     # post-horizon stragglers: skip
        self._advance(t)
        if kind == "end":
            self.done = True
            return False
        if kind == "arrival":
            cid, gen = payload
            c = self.client_by_id.get(cid)
            if c is None or gen != self._arr_gen.get(cid, 0):
                return True                 # migrated away: stale arrival
            c.on_arrival(self.now)
        elif kind == "complete":
            kid, gen = payload
            ek = self.in_flight.get(kid)
            if ek is None or ek.gen != gen:
                return True
            if ek.overhead_left > 1e-12 or ek.div_left > 1e-9:
                # stale estimate: refresh it, unless what is left takes less
                # than the clock resolves at this time (now + eta == now),
                # where the refresh would fire at this instant forever
                if self.now + ek.eta(self.freq,
                                     self.device.occupancy) > self.now:
                    self._schedule_completion(ek)
                    return True
            self._complete(ek)
        elif kind == "fswitch":
            self.freq = payload
            self._pending_freq = None
            for ek in self.in_flight.values():
                self._schedule_completion(ek)
        elif kind == "tick":
            self.policy.on_tick(self.now)
            self._push(self.now + self.policy.tick_interval, "tick", None)
        elif kind == "unhold":
            self.policy.release_hold(payload)
        elif kind == "fault":
            if self._apply_fault(payload):
                self.done = True        # device dead: event stream ends
                return False
        # policy reacts to the new state (apply first so context
        # switches / grows take effect before dispatch decisions)
        self._apply_allocations()
        self.policy.step(self.now)
        for c in self.clients:
            c.start_next_job(self.now)
        self.policy.step(self.now)
        self._apply_allocations()
        return True

    def run(self) -> "SimResult":
        self.start()
        while self.step_event():
            pass
        return SimResult(self)


@dataclass
class ClientMetrics:
    name: str
    priority: Priority
    n_completed: int
    throughput: float
    latencies: list[float]
    slice_seconds: float
    arrivals: list[float] = None
    horizon: float = 0.0
    cid: int = -1                       # node-global client id
    kernels_per_job: float = 0.0        # mean kernels of the jobs issued
    # Continuous-batching tenants: request-level latencies (arrival ->
    # last token; latencies above are per-iteration TBT there) and the
    # peak KV-cache footprint the tenant reached.
    req_latencies: list[float] = None
    kv_peak_bytes: float = 0.0

    def _lat(self, warmup: float = 0.0) -> list[float]:
        if warmup <= 0 or not self.arrivals:
            return self.latencies
        t0 = warmup * self.horizon
        out = [l for a, l in zip(self.arrivals, self.latencies) if a >= t0]
        return out or self.latencies

    def p(self, q: float, warmup: float = 0.0) -> float:
        lat = self._lat(warmup)
        if not lat:
            return float("nan")
        return float(np.percentile(lat, q))

    @property
    def p50(self):
        return self.p(50)

    @property
    def p95(self):
        return self.p(95)

    @property
    def p99(self):
        return self.p(99)

    def slo_attainment(self, slo: float) -> float:
        if not self.latencies or slo <= 0:
            return float("nan")
        return float(np.mean([l <= slo for l in self.latencies]))

    def goodput(self, slo: float, horizon: float) -> float:
        if slo <= 0:
            return self.throughput
        return sum(l <= slo for l in self.latencies) / horizon


class SimResult:
    def __init__(self, sim: Simulator):
        self.device = sim.device
        self.horizon = sim.horizon
        self.energy = sim.energy
        self.busy_slice_seconds = sim.busy_slice_seconds
        self.records = sim.records
        self.policy_name = sim.policy.name
        self.clients = [ClientMetrics(
            name=c.spec.name, priority=c.spec.priority,
            n_completed=len(c.completed),
            throughput=c.throughput(sim.horizon),
            latencies=c.latencies(), slice_seconds=c.slice_seconds,
            arrivals=[j.arrival for j in c.completed], horizon=sim.horizon,
            cid=c.cid,
            kernels_per_job=(sum(c.job_kernel_counts)
                             / len(c.job_kernel_counts)
                             if c.job_kernel_counts else 0.0),
            req_latencies=c.req_latencies(),
            kv_peak_bytes=c.kv_peak_bytes())
            for c in sim.clients]

    @property
    def utilization(self) -> float:
        return self.busy_slice_seconds / (self.horizon * self.device.n_slices)

    def client(self, name: str) -> ClientMetrics:
        return next(c for c in self.clients if c.name == name)


ENGINES = ("ref", "vec")


def make_simulator(device: DeviceSpec, apps: list[AppSpec], policy: Policy,
                   *, engine: str = "ref", **kw) -> Simulator:
    """Engine-selecting constructor.  ``ref`` is the scalar oracle defined
    in this module; ``vec`` is the vectorized core (engine_vec) with a
    bit-for-bit parity contract against it."""
    if engine == "vec":
        from repro_torch.core.engine_vec import VecSimulator
        return VecSimulator(device, apps, policy, **kw)
    if engine == "ref":
        return Simulator(device, apps, policy, **kw)
    raise ValueError(f"unknown engine {engine!r} (choose from {ENGINES})")


def run_sim(device: DeviceSpec, apps: list[AppSpec], policy: Policy, *,
            horizon: float = 30.0, seed: int = 0,
            engine: str = "ref") -> SimResult:
    return make_simulator(device, apps, policy, engine=engine,
                          horizon=horizon, seed=seed).run()
