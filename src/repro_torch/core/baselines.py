"""Baseline scheduling policies over the same simulator (§6 Baselines).

NVIDIA-native mechanisms — TimeSlice, MPS, stream Priority, MIG — plus the
SotA research systems the paper compares against: TGS (transparent adaptive
rate control), REEF (reset-based preemption), Orion (interference-aware
kernel gating, with its offline-profiling advantage granted as oracle access
to kernel boundedness).

"MPS" here means unrestricted concurrent execution with processor-sharing
of slices (TPCs on the H100): the simulator models no sharing inside an SM,
so MPS's intra-SM stacking is modelled at slice granularity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.core.costmodel import CostModel
from repro_torch.core.queues import Client
from repro_torch.core.simulator import ExecKernel, Policy
from repro_torch.core.slices import SliceMap, VecSliceMap
from repro_torch.core.types import CompletionRecord, Priority


def equal_share(items: list[tuple[int, int]], capacity: int) -> dict[int, int]:
    """Waterfill ``capacity`` slices over (kid, cap) items, equal shares with
    redistribution of unused headroom."""
    alloc = {kid: 0 for kid, _ in items}
    caps = dict(items)
    active = [kid for kid, _ in items]
    left = capacity
    while left > 0 and active:
        share = max(1, left // len(active))
        progressed = False
        for kid in list(active):
            give = min(share, caps[kid] - alloc[kid], left)
            if give > 0:
                alloc[kid] += give
                left -= give
                progressed = True
            if alloc[kid] >= caps[kid]:
                active.remove(kid)
            if left <= 0:
                break
        if not progressed:
            break
    return alloc


class FIFOPolicyBase(Policy):
    """Shared plumbing: strict per-queue FIFO, one kernel in flight per
    client; subclasses decide admission + allocation.

    Block semantics: a dispatched kernel grabs ``min(max_useful, free)``
    slices and holds them to completion; freed slices are re-granted in
    dispatch order (priority first), so a long low-priority kernel blocks
    later arrivals — the head-of-line effect LithOS's atomization removes.
    """

    # whether admit() is side-effect free.  The vec engine's candidate loop
    # skips admission probes when no slices are free ONLY for pure policies;
    # impure admission (TGS consumes a token per probe) must still be called
    # for every ready candidate, exactly like the reference loop does.
    pure_admit = True

    def admit(self, c: Client, now: float) -> bool:
        return True

    def _order(self):
        return sorted(self.sim.clients, key=lambda c: -int(c.spec.priority))

    def _order_vec(self):
        # ready clients only, in the same stable priority order as
        # ``sorted(clients, key=-priority)`` restricted to them.  Clients
        # without a dispatchable kernel are strict no-ops in the reference
        # loop (peek() is None -> continue), so skipping them is exact.
        return self.sim.ready_by_priority()

    def step(self, now: float):
        sim = self.sim
        if getattr(sim, "vec", False):
            if self.pure_admit and sim.free_slices() <= 0:
                return             # no dispatch possible, no probe effects
            for c in self._order_vec():
                task = c.peek()
                if task is None or not self.admit(c, now):
                    continue
                free = sim.free_slices()
                if free <= 0:
                    if self.pure_admit:
                        break      # remaining iterations are no-ops
                    continue       # HoL: wait for running blocks
                c.pop()
                cap = sim.cost.phases(task.work).max_useful_slices
                sim.start_kernel(c, task, min(cap, free))
            return
        for c in self._order():
            task = c.peek()
            if task is None or not self.admit(c, now):
                continue
            free = self.sim.free_slices()
            if free <= 0:
                continue               # HoL: wait for running blocks
            c.pop()
            cap = self.sim.cost.phases(task.work).max_useful_slices
            self.sim.start_kernel(c, task, min(cap, free))

    def on_complete(self, ek: ExecKernel, rec: CompletionRecord):
        ek.client.kernel_done(rec.t_end)

    # grow-on-free: spread free slices over in-flight kernels, HP first
    def allocations(self, now: float) -> dict[int, int]:
        out = {ek.task.kid: ek.slices for ek in self.sim.in_flight.values()}
        free = self.sim.free_slices()
        eks = sorted(self.sim.in_flight.values(),
                     key=lambda e: (-int(e.client.spec.priority), e.t_start))
        for ek in eks:
            if free <= 0:
                break
            grow = min(ek.phases.max_useful_slices - ek.slices, free)
            if grow > 0:
                out[ek.task.kid] = ek.slices + grow
                free -= grow
        return out

    def alloc_changes(self, now: float) -> dict[int, int]:
        # grown kernels only; everything else keeps its allocation, and the
        # engine re-checks the interference factor itself
        free = self.sim.free_slices()
        if free <= 0:
            return {}
        out: dict[int, int] = {}
        eks = sorted(self.sim.in_flight.values(),
                     key=lambda e: (-int(e.client.spec.priority), e.t_start))
        for ek in eks:
            if free <= 0:
                break
            grow = min(ek.phases.max_useful_slices - ek.slices, free)
            if grow > 0:
                out[ek.task.kid] = ek.slices + grow
                free -= grow
        return out


class MPSPolicy(FIFOPolicyBase):
    """Unrestricted concurrency with no prioritization (MPS has none):
    freed slices spread equally over in-flight kernels' headroom.
    Co-resident tenants pay cross-tenant interference (§2.2)."""

    name = "mps"
    interference_penalty = 0.18

    def _order(self):
        # FIFO, not priority: MPS is oblivious to tenant priorities
        return self.sim.clients

    def _order_vec(self):
        return self.sim.ready_clients()     # client-list order, ready only

    def allocations(self, now: float) -> dict[int, int]:
        out = {ek.task.kid: ek.slices for ek in self.sim.in_flight.values()}
        free = self.sim.free_slices()
        if free <= 0:
            return out
        headroom = [(ek.task.kid, ek.phases.max_useful_slices - ek.slices)
                    for ek in self.sim.in_flight.values()
                    if ek.phases.max_useful_slices > ek.slices]
        extra = equal_share(headroom, free)
        for kid, g in extra.items():
            out[kid] += g
        return out

    def alloc_changes(self, now: float) -> dict[int, int]:
        free = self.sim.free_slices()
        if free <= 0:
            return {}
        inf = self.sim.in_flight
        headroom = [(ek.task.kid, ek.phases.max_useful_slices - ek.slices)
                    for ek in inf.values()
                    if ek.phases.max_useful_slices > ek.slices]
        extra = equal_share(headroom, free)
        return {kid: inf[kid].slices + g for kid, g in extra.items() if g > 0}


class MIGPolicy(FIFOPolicyBase):
    """Static spatial partitions; clients without a partition never run and
    idle partition capacity cannot be donated (the MIG waste the paper
    quantifies).

    Runs on the same :class:`SliceMap` subsystem as LithOS but only ever
    acquires from its own partition — stealing is structurally impossible,
    so the subsystem's conservation checks double as a no-donation proof.
    """

    name = "mig"

    def __init__(self, partitions: dict[int, int]):
        self.partitions = partitions
        self.slices: SliceMap = None

    def attach(self, sim):
        super().attach(sim)
        cls = (VecSliceMap if getattr(sim, "vec", False) else SliceMap)
        self.slices = cls.from_partitions(sim.device.n_slices,
                                          self.partitions)

    def admit(self, c: Client, now: float) -> bool:
        return self.partitions.get(c.cid, 0) > 0

    def step(self, now: float):
        sim = self.sim
        vec = getattr(sim, "vec", False)
        if vec and self.slices.n_owned_idle_total() == 0:
            return                  # every partition busy: all no-ops
        for c in (self._order_vec() if vec else self._order()):
            task = c.peek()
            if task is None or not self.admit(c, now):
                continue
            own = self.slices.idle_owned(c.cid)
            if not own:
                continue
            cap = self.sim.cost.phases(task.work).max_useful_slices
            c.pop()
            chosen = tuple(own[:cap])
            self.slices.acquire(chosen, task.kid, c.cid, now)
            self.sim.start_kernel(c, task, len(chosen), slice_set=chosen)

    def on_complete(self, ek: ExecKernel, rec: CompletionRecord):
        self.slices.release(ek.task.kid, rec.t_end)
        super().on_complete(ek, rec)

    def allocations(self, now: float) -> dict[int, int]:
        return {ek.task.kid: ek.slices
                for ek in self.sim.in_flight.values()}

    def alloc_changes(self, now: float) -> dict[int, int]:
        return {}                   # partitions are static: never grows


class LimitsPolicy(MIGPolicy):
    """Thread-percentage limits (MPS active-thread quotas): like MIG but
    partitions are arbitrary slice counts (no GPC rounding)."""

    name = "limits"


class TimeSlicePolicy(FIFOPolicyBase):
    """Round-robin whole-device quanta (NVIDIA default time slicing).
    Out-of-turn kernels are context-switched out (allocation 0, progress
    frozen) — the one hardware mechanism that may shrink allocations."""

    name = "timeslice"
    allow_shrink = True

    def __init__(self, quantum: float = 5e-3):
        self.quantum = quantum
        self.tick_interval = quantum
        self.turn = 0
        self._applied_turn: Optional[int] = None   # last turn pushed to engine

    def _turn_cid(self) -> int:
        # ``turn`` indexes the client list; compare by cid (client ids are
        # node-global and need not be 0..n-1)
        clients = self.sim.clients
        return clients[self.turn % len(clients)].cid if clients else -1

    def step(self, now: float):
        # dispatch without a global free check: frozen kernels hold nothing
        turn_cid = self._turn_cid()
        vec = getattr(self.sim, "vec", False)
        for c in (self._order_vec() if vec else self._order()):
            task = c.peek()
            if task is None:
                continue
            c.pop()
            cap = self.sim.cost.phases(task.work).max_useful_slices
            s = min(cap, self.sim.device.n_slices) if c.cid == turn_cid else 0
            self.sim.start_kernel(c, task, s)

    def on_tick(self, now: float):
        n = len(self.sim.clients)
        for _ in range(n):
            self.turn = (self.turn + 1) % n
            c = self.sim.clients[self.turn]
            if c.peek() is not None or any(
                    ek.client.cid == c.cid
                    for ek in self.sim.in_flight.values()):
                break

    def allocations(self, now: float) -> dict[int, int]:
        turn_cid = self._turn_cid()
        return {ek.task.kid:
                (min(self.sim.device.n_slices, ek.phases.max_useful_slices)
                 if ek.client.cid == turn_cid else 0)
                for ek in self.sim.in_flight.values()}

    def alloc_changes(self, now: float) -> dict[int, int]:
        # targets depend only on whose turn it is; dispatches already start
        # at their target, so between turn rotations nothing can differ
        tc = self._turn_cid()
        if tc == self._applied_turn:
            return {}
        self._applied_turn = tc
        return self.allocations(now)


class PriorityPolicy(FIFOPolicyBase):
    """CUDA stream priority: HP kernels take slices first, BE gets leftovers
    (no gating — BE long kernels still launch and block resources).
    Co-residency pays MPS-style interference."""

    name = "priority"
    interference_penalty = 0.18


class REEFPolicy(FIFOPolicyBase):
    """REEF as re-implemented by the paper (§6): BE kernels are not launched
    while *any* HP app is active.  Launch gating only — an already-running
    BE kernel is not preempted, so HP arrivals can still wait out one whole
    BE kernel (the HoL effect Fig 20 quantifies).  Set ``reset=True`` for
    the original paper's reset-based preemption (kills BE, losing progress).
    """

    name = "reef"

    def __init__(self, reset: bool = False):
        self.reset = reset
        self._hp_memo: Optional[bool] = None

    def _hp_active(self) -> bool:
        # memoized for the duration of one step() call: within it an HP
        # client can only pop (peek None but outstanding > 0 — still
        # active) and the reset branch kills BE kernels only, so the value
        # cannot flip mid-step
        if self._hp_memo is None:
            self._hp_memo = any(
                c.spec.priority == Priority.HIGH and (
                    c.peek() is not None or c.outstanding > 0 or c.pending)
                for c in self.sim.clients)
        return self._hp_memo

    def admit(self, c: Client, now: float) -> bool:
        if c.spec.priority == Priority.HIGH:
            return True
        return not self._hp_active()

    def step(self, now: float):
        self._hp_memo = None
        if self.reset and self._hp_active():
            for ek in list(self.sim.in_flight.values()):
                if ek.client.spec.priority == Priority.BEST_EFFORT:
                    task = self.sim.kill(ek.task.kid)
                    if task is not None:
                        ek.client.requeue(task)
        super().step(now)


class TGSPolicy(FIFOPolicyBase):
    """Transparent GPU sharing: adaptive rate control on BE kernel launches.

    A token rate for BE work adapts to HP progress: when HP requests see
    queueing, the BE rate collapses; when HP is idle it ramps up.  The
    paper's critique — the controller assumes steady arrivals and reacts
    slowly to bursts — emerges from the ramp dynamics."""

    name = "tgs"
    tick_interval = 10e-3
    interference_penalty = 0.18          # co-runs on MPS-style stacking
    pure_admit = False                   # admit() consumes a token

    def __init__(self, ramp: float = 1.15, collapse: float = 0.25):
        self.rate = 0.5                  # BE duty fraction [0,1]
        self.tokens = 0.0
        self.ramp = ramp
        self.collapse = collapse
        self._last_hp_wait = 0.0

    def on_tick(self, now: float):
        hp_waiting = any(
            c.spec.priority == Priority.HIGH and
            (c.peek() is not None or c.pending)
            for c in self.sim.clients)
        if hp_waiting:
            self.rate = max(0.02, self.rate * self.collapse)
        else:
            self.rate = min(1.0, self.rate * self.ramp)
        self.tokens = min(2.0, self.tokens + self.rate)

    def admit(self, c: Client, now: float) -> bool:
        if c.spec.priority == Priority.HIGH:
            return True
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class OrionPolicy(FIFOPolicyBase):
    """Interference-aware gating: a BE kernel launches only if it does not
    contend with ANY in-flight HP kernel.  Contention = same roofline
    boundedness class; Orion knows each kernel's class from offline
    profiling, granted here as oracle access to the cost model."""

    name = "orion"

    def _bound_class(self, ek_or_task) -> bool:
        task = ek_or_task.task if isinstance(ek_or_task, ExecKernel) else ek_or_task
        # sim.cost is the same device's model; is_compute_bound is pure
        return self.sim.cost.is_compute_bound(task.work)

    def admit(self, c: Client, now: float) -> bool:
        if c.spec.priority == Priority.HIGH:
            return True
        hp_classes = {self._bound_class(ek)
                      for ek in self.sim.in_flight.values()
                      if ek.client.spec.priority == Priority.HIGH}
        hp_queued = any(cc.spec.priority == Priority.HIGH and
                        (cc.peek() is not None or cc.pending)
                        for cc in self.sim.clients)
        if hp_queued:
            return False
        task = c.peek()
        return self._bound_class(task) not in hp_classes


def make_baseline(name: str, **kw) -> Policy:
    table = {"mps": MPSPolicy, "mig": MIGPolicy, "limits": LimitsPolicy,
             "timeslice": TimeSlicePolicy, "priority": PriorityPolicy,
             "reef": REEFPolicy, "tgs": TGSPolicy, "orion": OrionPolicy}
    return table[name](**kw)
