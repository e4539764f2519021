"""§4.3 TPC (core-slice) Scheduler — the LithOS policy.

Manages the device's slices like an OS manages CPU cores:

* **Quotas** (§4.2): each client is guaranteed its quota slices whenever it
  has work.  Unowned slices form a shared pool.
* **TPC Stealing**: slices owned by clients with *no pending work* are lent
  out; per-slice timers (predicted completion of the holding atom, from the
  §4.7 predictor) record when borrowed slices return.  The moment an owner
  has work queued, its slices stop being re-lent — in-flight atoms finish
  (bounded by atom_duration) and return.
* **Kernel Atomization** (§4.4): long kernels are split so every atom
  boundary is a reallocation/preemption point; head-of-line blocking is
  bounded by one atom, not one kernel.
* **Right-sizing** (§4.5) and **DVFS** (§4.6) hook in per-atom, inheriting
  the parent kernel's decisions.

Dispatch discipline: HP clients first; one atom in flight per queue (maximum
scheduling flexibility — the sync-queue backlog threshold of the paper, set
to its minimum); HP dispatches eagerly on whatever slices are free, BE only
when it can get a meaningful allocation.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.atomizer import AtomizerConfig, KernelAtomizer
from repro_torch.core.dvfs import DVFSGovernor
from repro_torch.core.predictor import LatencyPredictor
from repro_torch.core.queues import Client
from repro_torch.core.rightsizer import RightSizer
from repro_torch.core.simulator import ExecKernel, Policy
from repro_torch.core.slices import SliceMap, VecSliceMap
from repro_torch.core.workloads import kv_floor_slices
from repro_torch.core.types import (CompletionRecord, DeviceSpec, KernelTask,
                                    Priority, Quota)

UNSEEN_DEFAULT_LATENCY = 2e-3     # conservative guess for never-seen kernels


@dataclass
class LithOSConfig:
    atomize: bool = True
    steal: bool = True
    rightsize: bool = False
    dvfs: bool = False
    occupancy_filter: bool = True   # §4.5 filtering heuristic (always-on in
                                    # LithOS; off = status-quo full alloc)
    slip: float = 1.1               # latency-slip parameter k (§4.5/4.6)
    probe_low: bool = True          # schedule the low-point calibration run
    # 1-slice probes are the paper's protocol; for latency-critical (HP)
    # kernels the low point is raised so one probe never exceeds this bound.
    # BE kernels always probe at 1 slice (they have no deadline).
    probe_latency_cap: float = 25e-3
    be_min_fraction: float = 0.05   # BE dispatches only if it can get this
    atomizer: AtomizerConfig = field(default_factory=AtomizerConfig)


@dataclass
class _QueueState:
    parent: Optional[KernelTask] = None
    atoms: deque = field(default_factory=deque)
    in_flight_kid: Optional[int] = None
    parent_slices: int = 0          # allocation decided for the kernel
    predicted: Optional[float] = None


class LithOSScheduler(Policy):
    name = "lithos"
    supports_migration = True

    def __init__(self, device: DeviceSpec, quotas: dict[int, Quota],
                 config: Optional[LithOSConfig] = None):
        self.device = device
        self.quotas = quotas
        self.cfg = config or LithOSConfig()
        self.predictor = LatencyPredictor(device.launch_overhead)
        self.atomizer = KernelAtomizer(self.cfg.atomizer)
        self.rightsizer = RightSizer(device.n_slices, device.occupancy,
                                     self.cfg.slip)
        self.governor = DVFSGovernor(device, self.cfg.slip)
        # slice state: ownership, holding, lending live in the SliceMap
        # subsystem (slices.py) — the scheduler is policy, not bookkeeping
        self.slices = SliceMap.from_quotas(device.n_slices, quotas)
        self.qstate: dict[int, _QueueState] = {}
        self.pred_log: list[tuple[float, float, int]] = []  # (pred, act, prio)
        self._grown: dict[int, int] = {}
        # clients with a planned kernel whose next atom is dispatchable
        # (atoms queued, nothing in flight) — the vec engine's step iterates
        # these plus the ready set instead of scanning every client
        self._disp: set[int] = set()
        # draining / paying migration cost.  Counted, not boolean: a stale
        # scheduled unhold (e.g. the migration-cost release of an earlier
        # move) must not cancel a newer drain-hold on the same client.
        self._held: dict[int, int] = {}
        # elastic re-own debt: evacuated owners whose guarantee could not
        # be fully re-granted at admit (destination pool busy) — fulfilled
        # from pool slices as they free up at completions
        self._pending_reown: dict[int, int] = {}

    def attach(self, sim):
        super().attach(sim)
        self.atomizer.kids = sim.kernel_ids
        if getattr(sim, "vec", False):
            # same layout/ordering contract, bitmask free-lists; built
            # fresh from the (unchanged) quotas
            self.slices = VecSliceMap.from_quotas(self.device.n_slices,
                                                  self.quotas)

    @property
    def stolen_slice_seconds(self) -> float:
        return self.slices.stolen_slice_seconds

    # -- helpers ------------------------------------------------------------------

    def _qs(self, cid: int) -> _QueueState:
        return self.qstate.setdefault(cid, _QueueState())

    def _has_work(self, c: Client) -> bool:
        """A workload is idle (its slices lendable) only between jobs —
        a client mid-request keeps its guarantee even while one of its
        kernels is executing (otherwise every kernel boundary leaks the
        quota to thieves and per-request latency compounds)."""
        qs = self._qs(c.cid)
        return (bool(qs.atoms) or c.peek() is not None or bool(c.pending)
                or c.current is not None or c.outstanding > 0)

    def _free_slices(self, for_cid: int, now: float) -> list[int]:
        """Slice ids this client may use right now.

        Lendability is priority-tiered (Fig 14's design point):
        * HP borrowers take any idle slice — HP apps steal unused
          resources from one another (an active owner's spare quota is
          still covered by its guarantee: it reclaims at atom boundaries).
        * BE borrowers only take slices of clients with NO in-flight job —
          otherwise repeated 1-atom borrows shave every kernel of an
          active HP request and the slowdown compounds through queueing.
        """
        lenders: list[int] = []
        if self.cfg.steal:
            hp_borrower = (self.quotas.get(for_cid, Quota(0)).priority
                           == Priority.HIGH)
            # owners with nothing idle contribute nothing to the stealable
            # set regardless of lendability, so only idle owners are probed
            # (free_for sorts the stealable union by slice id — lender
            # *membership*, not order, decides the outcome)
            for o in self.slices.idle_owners():
                if o == for_cid:
                    continue
                if hp_borrower or not self._has_work(self.sim.client_by_id[o]):
                    lenders.append(o)
        return self.slices.free_for(for_cid, lenders=lenders)

    def _n_own_idle(self, cid: int) -> int:
        return self.slices.n_own_idle(cid)

    # -- planning -------------------------------------------------------------------

    def _plan_kernel(self, c: Client, task: KernelTask, now: float):
        qs = self._qs(c.cid)
        # quota is a GUARANTEE (enforced via slice ownership + lendability),
        # not a cap: any client may use the whole device when others idle
        desired = self.device.n_slices
        # KV-cache memory floor: a serving tenant's live KV footprint pins
        # a minimum slice count (its memory share) — the right-sizer must
        # never shrink it below that, or live cache would be evicted.
        # Refreshed per kernel; relaxes as requests complete (kv_bytes
        # shrinks).  0 for tenants without a KV cache -> floor 1 -> no-op.
        floor = kv_floor_slices(c.spec.cfg, self.device,
                                getattr(c, "kv_bytes", 0.0))
        self.rightsizer.set_memory_floor(c.cid, floor)
        pred = self.predictor.predict(task, desired)
        # right-sizing (with the occupancy filter always applied)
        if self.cfg.rightsize:
            prio = self.quotas.get(c.cid, Quota(0)).priority
            cap = (self.cfg.probe_latency_cap
                   if prio == Priority.HIGH else 1.0)
            probe = (self.rightsizer.probe_allocation(
                task, desired, predicted_full=pred, probe_latency_cap=cap)
                if self.cfg.probe_low else None)
            if probe is not None:
                desired = probe        # calibration run (full, then 1 slice)
            else:
                desired = self.rightsizer.decide(task, desired)
        elif self.cfg.occupancy_filter:
            desired = min(desired, self.rightsizer.occupancy_bound(task))
        # the memory floor binds every shrink path (decide, probe low
        # point, occupancy filter alike)
        desired = max(desired, min(floor, self.device.n_slices))
        # atomization; unseen BE kernels split by grid size (an unknown
        # best-effort kernel must never monopolize stolen slices)
        prio = self.quotas.get(c.cid, Quota(0)).priority
        n_atoms = (self.atomizer.plan(
            task, pred,
            unseen_conservative=(prio == Priority.BEST_EFFORT))
            if self.cfg.atomize else 1)
        qs.parent = task
        qs.parent_slices = max(1, desired)
        qs.predicted = pred
        qs.atoms = deque(self.atomizer.split(task, n_atoms))

    # -- dispatch ---------------------------------------------------------------------

    def _sync_disp(self, cid: int, qs: _QueueState):
        if qs.atoms and qs.in_flight_kid is None:
            self._disp.add(cid)
        else:
            self._disp.discard(cid)

    def _dispatch_atom(self, c: Client, now: float,
                       qs: Optional[_QueueState] = None) -> bool:
        if qs is None:
            qs = self._qs(c.cid)
        if not qs.atoms or qs.in_flight_kid is not None:
            return False
        if self.slices.total_idle() == 0:
            return False        # free_for is empty for every client
        prio = self.quotas.get(c.cid, Quota(0)).priority
        if getattr(self.sim, "vec", False):
            # mask fast path: same chosen set and order as the reference
            # free_for[:want] (own idle asc, pool asc, stealable asc),
            # without materializing the full free-id list
            sm = self.slices
            steal = 0
            if self.cfg.steal:
                if prio == Priority.HIGH:
                    steal = (sm.idle_owned_union()
                             & ~sm.own_mask(c.cid))
                else:
                    cb = self.sim.client_by_id
                    for o in sm.idle_owners():
                        if o != c.cid and not self._has_work(cb[o]):
                            steal |= sm.idle_own_mask(o)
            picked, n_free = sm.take_free(c.cid, qs.parent_slices, steal)
            if not n_free:
                return False
            want = min(qs.parent_slices, n_free)
            if prio == Priority.BEST_EFFORT:
                floor = max(1, int(qs.parent_slices
                                   * self.cfg.be_min_fraction))
                if n_free < floor:
                    return False
            chosen = tuple(picked)
        else:
            free = self._free_slices(c.cid, now)
            if not free:
                return False
            want = min(qs.parent_slices, len(free))
            if prio == Priority.BEST_EFFORT:
                floor = max(1, int(qs.parent_slices
                                   * self.cfg.be_min_fraction))
                if len(free) < floor:
                    return False
            chosen = tuple(free[:want])
        atom = qs.atoms.popleft()
        n_atoms = atom.atom_of[2] if atom.atom_of else 1
        pred = self.predictor.predict(atom, want, self.governor.current_f,
                                      n_atoms=n_atoms)
        eta = pred if pred is not None else UNSEEN_DEFAULT_LATENCY
        stolen = self.slices.acquire(chosen, atom.kid, c.cid, now, eta=eta)
        ek = self.sim.start_kernel(c, atom, len(chosen), slice_set=chosen,
                                   stolen=stolen)
        qs.in_flight_kid = atom.kid
        ek._predicted = pred          # for §7.4 accuracy accounting
        return True

    # -- policy hooks --------------------------------------------------------------------

    def step(self, now: float):
        # DVFS: conservative — only below f_max when nothing in flight is unseen
        if self.cfg.dvfs:
            unseen = any(self.governor.unseen(ek.task)
                         for ek in self.sim.in_flight.values())
            if unseen:
                # full speed for the conservative-learning phase — but the
                # cluster power manager's cap still binds
                self.sim.set_frequency(self.governor._clamp(1.0))
                self.governor.current_f = self.sim.freq
            else:
                f = self.governor.maybe_switch(now)
                if f is not None:
                    self.sim.set_frequency(f)
        if getattr(self.sim, "vec", False):
            # candidate-set scan: clients that could plan (ready, not
            # draining) or dispatch a queued atom (_disp).  Everyone else
            # is a strict no-op in the reference loop below; the sort key
            # replicates its stable priority order (ties by client-list
            # position).
            sim = self.sim
            cands = [c for c in sim.ready_clients()
                     if c.cid not in self._held]
            # slices only free up via release (never during this loop), so
            # a zero-idle device stays zero-idle: every dispatch attempt is
            # a guaranteed no-op and _disp clients (planned, waiting on
            # capacity) can be skipped wholesale.  Ready clients still must
            # plan (pop + atomize) exactly as the reference loop does.
            idle = self.slices.total_idle() > 0
            if idle and self._disp:
                cb = sim.client_by_id
                for cid in self._disp:
                    c = cb.get(cid)
                    if c is not None:
                        cands.append(c)
            if cands:
                cands.sort(key=lambda c: (
                    -int(self.quotas.get(c.cid, Quota(0)).priority),
                    sim.client_pos(c.cid)))
                for c in cands:
                    qs = self._qs(c.cid)
                    if qs.parent is None:
                        task = c.peek()
                        if task is None:
                            continue
                        c.pop()
                        self._plan_kernel(c, task, now)
                    if idle:
                        if self._dispatch_atom(c, now, qs):
                            idle = self.slices.total_idle() > 0
                    self._sync_disp(c.cid, qs)
            self._grow_inflight(now)
            return
        order = sorted(
            self.sim.clients,
            key=lambda c: -int(self.quotas.get(c.cid, Quota(0)).priority))
        for c in order:
            qs = self._qs(c.cid)
            if qs.parent is None:
                # held clients drain at the current kernel boundary: the
                # in-flight kernel's atoms finish, nothing new is planned
                if c.cid in self._held:
                    continue
                task = c.peek()
                if task is not None:
                    c.pop()
                    self._plan_kernel(c, task, now)
            self._dispatch_atom(c, now)
            self._sync_disp(c.cid, qs)
        self._grow_inflight(now)

    def _grow_inflight(self, now: float):
        """Spread freed slices onto running atoms (remaining thread blocks
        flow onto freed cores — hardware-real growth, never shrink).
        Priority order; each atom grows at most to its planned allocation."""
        if not self.sim.in_flight or self.slices.total_idle() == 0:
            return              # nothing to spread / nothing to spread onto
        eks = sorted(self.sim.in_flight.values(),
                     key=lambda e: (-int(self.quotas.get(
                         e.client.cid, Quota(0)).priority), e.t_start))
        for ek in eks:
            qs = self._qs(ek.client.cid)
            want = qs.parent_slices
            if ek.slices >= want:
                continue
            free = self._free_slices(ek.client.cid, now)
            take = tuple(free[:want - ek.slices])
            if not take:
                continue
            self.slices.acquire(take, ek.task.kid, ek.client.cid, now)
            ek.slice_set = tuple(ek.slice_set) + take
            self._grown[ek.task.kid] = ek.slices + len(take)

    def allocations(self, now: float) -> dict[int, int]:
        out = {ek.task.kid: ek.slices for ek in self.sim.in_flight.values()}
        out.update(self._grown)
        self._grown = {}
        return out

    def alloc_changes(self, now: float) -> dict[int, int]:
        # only grown atoms ever differ from their current allocation
        # (interference_penalty is 0: the factor never moves)
        g = self._grown
        self._grown = {}
        return g

    def on_complete(self, ek: ExecKernel, rec: CompletionRecord):
        now = rec.t_end
        self._grown.pop(ek.task.kid, None)
        self.slices.release(ek.task.kid, now)
        if ek.stolen:
            self.slices.note_stolen_completion(rec.latency, rec.slices)
        self.predictor.observe(rec)
        self.rightsizer.observe(rec)
        self.governor.observe(rec)
        pred = getattr(ek, "_predicted", None)
        if pred is not None:
            prio = self.quotas.get(ek.client.cid, Quota(0)).priority
            self.pred_log.append((pred, rec.latency, int(prio)))
            self.predictor.record_outcome(pred, rec.latency)
        qs = self._qs(ek.client.cid)
        if qs.in_flight_kid == ek.task.kid:
            qs.in_flight_kid = None
        if not qs.atoms and qs.in_flight_kid is None:
            qs.parent = None
            ek.client.kernel_done(now)
        self._sync_disp(ek.client.cid, qs)
        if self._pending_reown:
            self._fulfill_reowns()

    # -- fault handling ------------------------------------------------------

    def on_fault(self, f, now: float):
        if f.kind == "slice_retired":
            self._retire_slice(f.slice_id, now)
            return
        if f.kind != "device_dead":
            return
        # device dead: REEF-reset every in-flight atom, put each planned
        # parent kernel back at its queue head — the tier above evacuates
        # intact queues, nothing is silently lost.  Atom kids are discarded
        # (the destination re-plans and re-atomizes with fresh ids).
        for kid in list(self.sim.in_flight):
            self._grown.pop(kid, None)
            self.slices.release(kid, now)
            self.sim.kill(kid)
        for cid, qs in self.qstate.items():
            if qs.parent is None:
                continue
            c = self.sim.client_by_id.get(cid)
            if c is not None:
                c.requeue(qs.parent)
            qs.parent = None
            qs.atoms.clear()
            qs.in_flight_kid = None
            qs.parent_slices = 0
            qs.predicted = None
            self._sync_disp(cid, qs)
        self._grown = {}

    def _retire_slice(self, sid: int, now: float):
        """ECC-style loss of one slice: out of the free-lists forever (lazily
        if held — blocks are non-preemptible), and the owner's quota shrinks
        by one so the guarantee tracks the hardware that still exists.  The
        KV memory floor is unaffected: it binds the right-sizer's *shrink*
        paths, and dispatch clamps to whatever capacity survives."""
        owner = self.slices.owner[sid]
        self.slices.retire(sid)
        if owner is not None:
            q = self.quotas.get(owner)
            if q is not None and q.slices > 0:
                self.quotas[owner] = Quota(q.slices - 1, q.priority)

    def _fair_hp_share(self) -> int:
        """Per-HP-owner fair share of the surviving capacity — the quota
        re-derivation target when an evacuee's guarantee must squeeze into
        an already-partitioned destination."""
        alive = self.device.n_slices - len(self.slices.retired)
        n_hp = sum(1 for q in self.quotas.values()
                   if q.priority == Priority.HIGH)
        return alive // max(1, n_hp)

    def _grant_reown(self, cid: int, want: int) -> int:
        """Re-grant up to ``want`` slices of ownership to an evacuee: idle
        pool slices first (free capacity), then — up to the fair HP share —
        idle slices reclaimed from HP owners holding more than that share.
        Grows ``cid``'s quota by what was actually granted."""
        granted = 0
        for sid in self.slices.idle_pool()[:want]:
            self.slices.assign_owner(sid, cid)
            granted += 1
        if granted < want:
            fair = self._fair_hp_share()
            have = self.quotas.get(cid, Quota(0)).slices + granted
            room = min(want - granted, max(0, fair - have))
            if room:
                granted += self._reclaim_from_rich(cid, room, fair)
        if granted:
            q = self.quotas.get(cid, Quota(0))
            self.quotas[cid] = Quota(q.slices + granted, q.priority)
        return granted

    def _reclaim_from_rich(self, cid: int, want: int, fair: int) -> int:
        """Transfer idle slices from HP owners above the fair share to the
        re-owning evacuee (held slices transfer later, as they free)."""
        got = 0
        for o in sorted(self.quotas):
            if o == cid or got >= want:
                continue
            q = self.quotas[o]
            if q.priority != Priority.HIGH or q.slices <= fair:
                continue
            take = min(q.slices - fair, want - got)
            ids = self.slices.idle_owned(o)[:take]
            for sid in ids:
                self.slices.assign_owner(sid, cid)
            if ids:
                self.quotas[o] = Quota(q.slices - len(ids), q.priority)
                got += len(ids)
        return got

    def _fulfill_reowns(self):
        for cid in sorted(self._pending_reown):
            want = self._pending_reown[cid]
            got = self._grant_reown(cid, want)
            if got >= want:
                del self._pending_reown[cid]
            else:
                self._pending_reown[cid] = want - got

    # -- cross-device migration protocol (node-level lending, §4.3 scaled
    # -- out: the NodeCoordinator drives hold -> drain -> export / import) --

    def hold_client(self, cid: int):
        self._held[cid] = self._held.get(cid, 0) + 1

    def release_hold(self, cid: int):
        n = self._held.get(cid, 0) - 1      # stale release: no-op
        if n > 0:
            self._held[cid] = n
        else:
            self._held.pop(cid, None)

    def client_drained(self, cid: int) -> bool:
        c = self.sim.client_by_id.get(cid)
        qs = self.qstate.get(cid)
        return (c is not None and c.outstanding == 0
                and (qs is None or (qs.parent is None and not qs.atoms
                                    and qs.in_flight_kid is None)))

    def export_client_state(self, cid: int) -> dict:
        """Drop a drained client from this device's control plane and hand
        its learned predictor state to the target (the queue keeps its
        node-global id, so (queue, ordinal) keys stay valid there)."""
        assert self.client_drained(cid), "export requires a drained client"
        self.qstate.pop(cid, None)
        self._held.pop(cid, None)       # all holds die with the residency
        self._disp.discard(cid)
        quota = self.quotas.pop(cid, Quota(0))
        # elastic re-own (HP migration): a drained owner's slices are all
        # idle — return them to this device's pool and record how many, so
        # the destination re-derives an equivalent grant from its own pool
        reown = self._pending_reown.pop(cid, 0)
        for sid in self.slices.idle_owned(cid):
            self.slices.disown(sid)
            reown += 1
        assert self.slices.owned_by(cid) == 0, \
            "cannot export an owner while borrowers hold its slices"
        keys = [k for k in self.predictor.nodes if k[0] == cid]
        nodes = {k: self.predictor.nodes.pop(k) for k in keys}
        return {"quota": quota, "predictor_nodes": nodes, "reown": reown}

    def import_client_state(self, cid: int, priority, state: dict):
        """Admit a migrated client: its quota re-derived against this
        device's idle pool (elastic re-own — an HP tenant re-acquires up to
        its exported ownership, a BE tenant stays quota-less on stolen
        capacity), plus the source predictor's observations so the first
        kernels on the new device dispatch with warm latency estimates."""
        quota = state.get("quota") or Quota(0, priority)
        reown = int(state.get("reown", 0) or 0)
        if reown:
            self.quotas[cid] = Quota(0, quota.priority)
            granted = self._grant_reown(cid, reown)
            if granted < reown:
                # outstanding debt is capped at the fair share: the
                # evacuee is entitled to free capacity without limit but
                # squeezes other guarantees only down to parity
                debt = min(reown - granted,
                           max(0, self._fair_hp_share() - granted))
                if debt:
                    self._pending_reown[cid] = debt
        else:
            self.quotas[cid] = quota
        for k, v in state.get("predictor_nodes", {}).items():
            self.predictor.nodes[k] = v

