"""Level-agnostic scheduling hierarchy: the machinery shared by every tier.

The paper's control plane manages one GPU; the node tier scales it to N
devices, and the same concepts recur one level up (node -> cluster) — so the
machinery lives here, parameterized over *members*, and each tier
instantiates it:

    tier      coordinator                 member
    node      core.node.NodeCoordinator        one device (sim + policy)
    cluster   core.cluster.ClusterCoordinator  one node (NodeCoordinator)

What a tier reuses:

* **Pressure sampling** — every member reports a :class:`Pressure` sample
  (HP queue depth, free-list occupancy, active tenants) at a fixed epoch;
  the saturated/lender thresholds are level-independent knobs.
* **Placement routing** — :func:`route` implements the four routers
  (round_robin / least_loaded / quota_aware / affinity) over plain member
  capacities, so the same policies place tenants on devices within a node
  or on nodes within a cluster.
* **Lending protocol** — :class:`HierarchyCoordinator` interleaves member
  event streams in global time order, samples pressure per epoch, and
  migrates one best-effort client's launch queue from a saturated member to
  an idle one through the drain -> export -> admit pipeline the members
  implement.  Every move lands in a
  :class:`~repro_torch.core.slices.MemberLedger`, extending the SliceMap
  conservation story to the coordinator's level.
* **Fragmentation** — :func:`fragmentation` scores a free-list snapshot
  against a tenant demand distribution (the FRAG-style objective of
  "Power- and Fragmentation-aware Online Scheduling for GPU Datacenters"):
  the expected fraction of free capacity stranded in fragments too small to
  host a random tenant's guarantee.

Adding a future level (cluster -> region, region -> fleet) means writing
one :class:`Member` adapter over the lower tier's coordinator — the
coordinator below already exposes the event-stream interface
(``start``/``peek_time``/``step_event``) this tier consumes, exactly as a
:class:`~repro_torch.core.simulator.Simulator` does (DESIGN.md §7).
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass
from typing import Optional, Sequence

ROUTERS = ("round_robin", "least_loaded", "quota_aware", "affinity")


# ---------------------------------------------------------------------------
# Pressure (the lending protocol's signal, any level)
# ---------------------------------------------------------------------------

@dataclass
class Pressure:
    """One member's pressure sample."""

    hp_depth: int                   # HP jobs pending or in progress
    free_frac: float                # free-list occupancy (idle fraction)
    active: int                     # clients with work
    # Latency-critical decode backlog (HP serving tenants: waiting
    # requests + the in-flight iteration).  Counted *on top of* hp_depth,
    # so decode pressure weighs double in the saturation threshold —
    # a token behind in a decode queue is user-visible TBT, not just
    # queueing.  0 for every pre-LLM workload (legacy behavior intact).
    decode_depth: int = 0


# ---------------------------------------------------------------------------
# Placement routing (level-agnostic: members are capacities)
# ---------------------------------------------------------------------------

def _argmin_load(loads: list[float], caps: Sequence[int]) -> int:
    """Member with the lowest capacity-normalized load (ties: lowest id)."""
    base = caps[0]
    return min(range(len(caps)),
               key=lambda d: (loads[d] * base / caps[d], d))


def _effective_quota(app, caps: Sequence[int], n_hp: int, d: int = 0,
                     headroom: Optional[int] = None) -> int:
    """A-priori estimate of the guarantee ``app`` would need on member
    ``d`` (capacity ``caps[d]``).  Explicit quotas are exact (clamped to
    the member); derived HP shares split the unreserved headroom by the
    hierarchy-wide HP count — conservative, mirroring the
    reserve-explicit-first structure of ``quotas_from_apps``."""
    if app.quota_slices > 0:
        return min(app.quota_slices, caps[d])
    from repro_torch.core.types import Priority
    if app.priority == Priority.HIGH:
        cap = caps[d] if headroom is None else max(0, headroom)
        return cap // max(1, n_hp)
    return 0


def route(caps: Sequence[int], apps: list,
          router: str = "least_loaded",
          demands: Optional[list[float]] = None) -> list[int]:
    """Return the member index for each app.  Deterministic.

    ``caps`` are member capacities in slices (devices of a node, or nodes
    of a cluster); ``demands`` are per-app load estimates in member-0
    capacity units (required by least_loaded / affinity — the caller
    prices them, typically via ``node.demand_estimate``)."""
    from repro_torch.core.types import Priority

    if router not in ROUTERS:
        raise ValueError(f"unknown router {router!r} (choose from {ROUTERS})")
    n = len(caps)
    if n == 1:
        return [0] * len(apps)
    if router == "round_robin":
        return [i % n for i in range(len(apps))]

    placement = [0] * len(apps)
    if router == "least_loaded":
        assert demands is not None, "least_loaded needs demand estimates"
        loads = [0.0] * n
        for i in sorted(range(len(apps)), key=lambda i: (-demands[i], i)):
            d = _argmin_load(loads, caps)
            placement[i] = d
            loads[d] += demands[i]
        return placement

    if router == "quota_aware":
        n_hp = sum(1 for a in apps if a.priority == Priority.HIGH)
        # quota demand is sized per target member (capacities may differ),
        # derived shares against the headroom left after reservations
        headroom = list(caps)
        quota_on = lambda i, d: _effective_quota(apps[i], caps, n_hp, d,
                                                 headroom=headroom[d])
        be_count = [0] * n
        hp_order = sorted((i for i, a in enumerate(apps)
                           if a.priority == Priority.HIGH),
                          key=lambda i: (-max(_effective_quota(
                              apps[i], caps, n_hp, d) for d in range(n)), i))
        for i in hp_order:
            # member where the guarantee still fits; else most headroom
            fits = [d for d in range(n) if headroom[d] >= quota_on(i, d)]
            cands = fits or range(n)
            d = min(cands, key=lambda d: (-headroom[d], d))
            placement[i] = d
            headroom[d] -= quota_on(i, d)
        for i, a in enumerate(apps):
            if a.priority == Priority.HIGH:
                continue
            d = min(range(n), key=lambda d: (be_count[d], -headroom[d], d))
            placement[i] = d
            be_count[d] += 1
        return placement

    if router == "affinity":
        assert demands is not None, "affinity needs demand estimates"
        groups: dict[str, list[int]] = {}
        for i, a in enumerate(apps):
            groups.setdefault(a.cfg.name, []).append(i)
        gload = {g: sum(demands[i] for i in ids) for g, ids in groups.items()}
        loads = [0.0] * n
        for g in sorted(groups, key=lambda g: (-gload[g], g)):
            d = _argmin_load(loads, caps)
            for i in groups[g]:
                placement[i] = d
            loads[d] += gload[g]
        return placement

    raise AssertionError(f"unhandled router {router!r}")  # ROUTERS is closed


# ---------------------------------------------------------------------------
# Fragmentation (FRAG-style free-list score, any level)
# ---------------------------------------------------------------------------

def fragmentation(free: Sequence[int], demands: Sequence[int]) -> float:
    """Expected fraction of free capacity stranded w.r.t. a demand
    distribution.

    ``free`` is a free-list snapshot — idle slices per leaf member (each
    device of a node; each device of each node of a cluster).  ``demands``
    are representative per-tenant slice requests (the placement-time
    guarantee estimates).  A member's free slices are *stranded* for a
    demand it cannot host whole, so

        F = sum_d free_d * P(demand > free_d) / sum_d free_d

    F = 0 when every fragment fits every request, 1 when no request fits
    anywhere — the FRAG objective of arXiv 2412.17484 evaluated against
    the tenant population instead of a fixed task mix."""
    total = sum(free)
    if total <= 0 or not demands:
        return 0.0
    ds = sorted(demands)
    n = len(ds)
    stranded = sum(f * (n - bisect_right(ds, f)) / n for f in free)
    return stranded / total


# ---------------------------------------------------------------------------
# Member port (what a tier's coordinator needs from each member)
# ---------------------------------------------------------------------------

class Member:
    """One schedulable member of a hierarchy tier.

    A member is an event-stream (the
    :class:`~repro_torch.core.simulator.Simulator` stepping interface) plus
    the lending-protocol hooks the coordinator drives.
    ``repro_torch.core.node.SimMember`` adapts one device (simulator +
    policy); ``repro_torch.core.cluster.NodeMember`` adapts one node (a
    whole :class:`~repro_torch.core.node.NodeCoordinator`) — the recursion
    that makes the hierarchy level-agnostic."""

    capacity: int = 0               # total slices
    horizon: float = 0.0

    # -- event stream -------------------------------------------------------

    def start(self):
        raise NotImplementedError

    def peek_time(self) -> Optional[float]:
        raise NotImplementedError

    def step_event(self) -> bool:
        raise NotImplementedError

    @property
    def done(self) -> bool:
        raise NotImplementedError

    def invalidate_peeks(self):
        """Drop any internally cached next-event times — the coordinator
        calls this after mutating the member from outside its own event
        loop (power capping, migration export/admit).  Leaf members keep
        no cache; a nested coordinator must drop its own."""

    # -- fault domain --------------------------------------------------------

    def failed(self) -> bool:
        """True once the member is permanently dead (``device_dead`` at the
        leaf; a nested tier is dead when every leaf below it is)."""
        return False

    def has_faults(self) -> bool:
        """True when a fault plan targets this member (forces the
        coordinator's interleaved loop — detection needs global time)."""
        return False

    def can_host(self, client) -> bool:
        """Placement filter for evacuees: False when the client's memory
        floor (KV cache) cannot fit on this member's surviving capacity."""
        return True

    # -- pressure / placement ----------------------------------------------

    def pressure(self) -> Pressure:
        raise NotImplementedError

    def free_snapshot(self) -> list[int]:
        """Idle slices per leaf member (len 1 for a device; one entry per
        device for a node) — the fragmentation metric's input."""
        raise NotImplementedError

    # -- migration protocol -------------------------------------------------

    def supports_migration(self) -> bool:
        return False

    def migration_candidates(self) -> list[int]:
        """Eligible BE client ids, ascending (no cooldown filter — the
        coordinator owns move history)."""
        return []

    def begin_drain(self, cid: int):
        raise NotImplementedError

    def abort_drain(self, cid: int):
        raise NotImplementedError

    def drain_dead(self, cid: int) -> bool:
        """True when the member hosting ``cid`` can no longer complete the
        drain (its horizon beat the kernel boundary)."""
        raise NotImplementedError

    def drained(self, cid: int) -> bool:
        raise NotImplementedError

    def clock(self, cid: int) -> float:
        """Clock of the leaf hosting ``cid`` (the arrival cutoff and the
        migration anchor are stamped with it)."""
        raise NotImplementedError

    def export_client(self, cid: int):
        """Remove a drained client; returns (client, priority, state)."""
        raise NotImplementedError

    def admit_client(self, client, priority, state, *, after: float,
                     release_at: float):
        """Admit a migrated client: warm-start from ``state``, re-seed
        arrivals strictly after ``after``, hold dispatch until
        ``release_at`` (the migration cost)."""
        raise NotImplementedError

    # -- invariants ---------------------------------------------------------

    def hosted_cids(self) -> list[int]:
        raise NotImplementedError

    def check(self):
        return True


@dataclass
class _PendingMigration:
    cid: int
    src: int
    dst: int
    t_decided: float


class HierarchyCoordinator:
    """Runs members as interleaved event streams and drives one tier of the
    lending protocol.

    The loop always steps the member with the globally earliest pending
    event, so member clocks stay within one event of each other — the
    precondition for sampling a coherent tier-wide pressure snapshot every
    ``config.epoch`` seconds and for moving a launch queue between members
    without time travel.

    Migration of a chosen best-effort client proceeds in three phases:

    1. **hold** — the source stops planning new kernels for the client;
       its in-flight kernel drains at the atom boundary;
    2. **drain / export** — once drained (observed after a source event),
       the client object moves with its launch queue, pending jobs and RNG
       stream intact, together with its warm policy state;
    3. **admit / warm** — the target admits the client immediately (so it
       is never unaccounted for), imports the warm state, and holds
       dispatch for ``migration_cost`` seconds.

    Every move is recorded in a
    :class:`~repro_torch.core.slices.MemberLedger`; ``config.validate``
    re-checks tier-wide conservation at every epoch.

    Epoch *hooks* (fragmentation sampling, power capping) run before the
    migration decision at each epoch.  When the tier needs no cross-member
    coupling at all — migration off and no mutating hooks — ``run_loop``
    takes a sequential fast path: each member runs to completion
    independently (bit-for-bit identical, since uncoupled members share no
    state), with read-only per-member hooks still fired at epoch
    boundaries.
    """

    def __init__(self, members: list[Member], config, ledger):
        self.members = members
        self.config = config
        self.ledger = ledger
        self._pending: Optional[_PendingMigration] = None
        self._last_move: dict[int, float] = {}
        self.migration_log: list[tuple[float, int, int, int]] = []
        #: cids a higher tier is draining — excluded from this tier's
        #: migration candidates (no two coordinators move one client)
        self.frozen: set[int] = set()
        #: called at every epoch, before migration decisions, with the
        #: epoch timestamp — may mutate members (forces interleaving)
        self.epoch_hooks: list = []
        #: read-only per-member hooks: f(member_index, t) — safe in the
        #: sequential fast path because uncoupled members evolve
        #: independently, so member-local state at time t is identical
        #: whether sampled globally or during the member's own run
        self.member_hooks: list = []
        #: fault domain: evacuate a dead member's tenants automatically
        #: (the ctl daemon turns this off and drives recovery through its
        #: own PREEMPT -> REQUEUE job machinery instead)
        self.auto_evacuate = True
        self.failed_members: set[int] = set()
        self.fault_log: list[tuple[float, int]] = []    # (t, member)
        #: cids left on a dead member because no live destination existed
        self.stranded: set[int] = set()
        self._started = False
        self._done = False

    # -- thresholds ----------------------------------------------------------

    def _saturated(self, p: Pressure) -> bool:
        cfg = self.config
        return (p.hp_depth + p.decode_depth >= cfg.hp_depth_hi
                or (p.free_frac <= cfg.free_lo and p.active >= 2))

    def _lender(self, p: Pressure) -> bool:
        cfg = self.config
        return (p.hp_depth == 0 and p.decode_depth == 0
                and p.free_frac >= cfg.free_hi)

    # -- migration decisions -------------------------------------------------

    def _candidates(self, m: Member, now: float) -> list[int]:
        cool = self.config.cooldown
        return [cid for cid in m.migration_candidates()
                if cid not in self.frozen
                and now >= self._last_move.get(cid, -1e18) + cool]

    def _epoch(self, now: float):
        cfg = self.config
        for hook in self.epoch_hooks:
            hook(now)
        if self.epoch_hooks:
            self.invalidate_peeks()     # mutating hooks may push events
        for hook in self.member_hooks:
            for mi in range(len(self.members)):
                hook(mi, now)
        if not self._migrate:
            return
        if cfg.validate:
            self.check()
        if self._pending is not None:
            return                          # one drain in progress at a time
        if cfg.max_migrations and \
                self.ledger.n_migrations >= cfg.max_migrations:
            return
        if not all(m.supports_migration() for m in self.members):
            return
        press = [m.pressure() for m in self.members]
        lenders = [d for d in range(len(self.members))
                   if self._lender(press[d])]
        if not lenders:
            return
        # most-pressured saturated member with an eligible BE tenant first
        sat = sorted((d for d in range(len(self.members))
                      if self._saturated(press[d])),
                     key=lambda d: (-press[d].hp_depth, press[d].free_frac,
                                    d))
        for src in sat:
            cands = self._candidates(self.members[src], now)
            if not cands:
                continue
            dst = max((d for d in lenders if d != src),
                      key=lambda d: (press[d].free_frac, -d), default=None)
            if dst is None:
                continue
            cid = cands[0]
            self._pending = _PendingMigration(cid, src, dst, now)
            self.members[src].begin_drain(cid)    # begin draining
            self._maybe_execute(src)              # may already be drained
            return

    def _maybe_execute(self, d: int):
        """Execute the pending migration once its client has drained (called
        after every event on the source member)."""
        pm = self._pending
        if pm is None or pm.src != d:
            return
        src, dst = self.members[pm.src], self.members[pm.dst]
        if src.drain_dead(pm.cid):              # horizon beat the drain
            src.abort_drain(pm.cid)
            self._pending = None
            return
        if not src.drained(pm.cid):
            return
        # The migration is anchored at the *decision-or-later* instant: a
        # saturated member's clock (its last processed event) can lag the
        # epoch that decided the move, and stamping the ledger / cooldown /
        # cost with the stale clock would erode the cooldown window and
        # over-count donated seconds.  The arrival cutoff, by contrast, is
        # exactly what the source actually processed (its own clock).
        src_now = src.clock(pm.cid)
        t_mig = max(src_now, pm.t_decided)
        client, priority, state = src.export_client(pm.cid)
        dst.admit_client(client, priority, state, after=src_now,
                         release_at=t_mig + self.config.migration_cost)
        self.ledger.migrate(pm.cid, pm.dst, t_mig)
        self._last_move[pm.cid] = t_mig
        self.migration_log.append((t_mig, pm.cid, pm.src, pm.dst))
        self._dirty_deep(pm.src)        # export/admit mutated both heaps
        self._dirty_deep(pm.dst)
        self._pending = None

    # -- fault handling ------------------------------------------------------

    def _on_member_failed(self, d: int, now: float):
        """A member just died: take it out of the interleaved loop, cancel
        any migration touching it, and (unless the tier above owns
        recovery) evacuate its tenants to surviving members."""
        self.failed_members.add(d)
        self._active.discard(d)
        self._peek_dirty.add(d)
        self.fault_log.append((now, d))
        pm = self._pending
        if pm is not None and (pm.src == d or pm.dst == d):
            if pm.src != d and not self.members[pm.src].failed():
                self.members[pm.src].abort_drain(pm.cid)
            self._pending = None
        if self.auto_evacuate:
            self._evacuate(d, now)

    def _evacuate(self, d: int, now: float):
        """Move every tenant off dead member ``d``.

        The device_dead fault already REEF-reset in-flight work back onto
        the launch queues, so every hosted client is drained — export is
        immediate, no hold/drain phase.  HP evacuees move first (their
        guarantees re-derive against the fullest destination pools) and
        each lands on the most-free survivor whose capacity can hold its
        KV memory floor (``can_host``)."""
        m = self.members[d]
        cids = list(m.hosted_cids())
        if not cids:
            return
        dsts = sorted(i for i in self._active
                      if i != d and i not in self.failed_members
                      and self.members[i].supports_migration())
        if not dsts or not m.supports_migration():
            self.stranded.update(cids)
            return
        exports = []
        for cid in cids:
            src_now = m.clock(cid)
            client, priority, state = m.export_client(cid)
            self.frozen.discard(cid)
            exports.append((cid, src_now, client, priority, state))
        exports.sort(key=lambda e: (-int(e[3]), e[0]))   # HP first
        for cid, src_now, client, priority, state in exports:
            fit = [i for i in dsts if self.members[i].can_host(client)]
            cands = fit or dsts
            dst = max(cands, key=lambda i: (
                self.members[i].pressure().free_frac, -i))
            self.members[dst].admit_client(
                client, priority, state, after=src_now,
                release_at=now + self.config.migration_cost)
            self.ledger.migrate(cid, dst, now)
            self._last_move[cid] = now
            self.migration_log.append((now, cid, d, dst))
            self._dirty_deep(dst)
        self._dirty_deep(d)

    # -- invariants ----------------------------------------------------------

    def check(self) -> bool:
        """Tier-wide conservation: every client hosted exactly once, the
        ledger agrees with the live hosting map, and each member's own
        invariants hold."""
        hosted: dict[int, int] = {}
        for d, m in enumerate(self.members):
            for cid in m.hosted_cids():
                assert cid not in hosted, f"client {cid} hosted twice"
                hosted[cid] = d
        self.ledger.check(hosted)
        for m in self.members:
            m.check()
        return True

    # -- interleaved run loop ------------------------------------------------

    @property
    def done(self) -> bool:
        return self._done

    def start(self):
        cfg = self.config
        for m in self.members:
            m.start()
        self._migrate = cfg.migration and len(self.members) > 1
        self._epochs_on = bool(self._migrate or self.epoch_hooks
                               or self.member_hooks)
        self._next_epoch = cfg.epoch if self._epochs_on else float("inf")
        self.horizon = self.members[0].horizon
        self._active = set(range(len(self.members)))
        # next-event-time cache: recomputed only for members that were
        # stepped or externally mutated, so the interleaved loop's
        # globally-earliest scan costs O(members) comparisons instead of
        # O(members) nested peeks per event
        self._peek_cache: list = [None] * len(self.members)
        self._peek_dirty = set(self._active)
        self._started = True

    def _member_peek(self, i: int):
        if i in self._peek_dirty:
            self._peek_cache[i] = self.members[i].peek_time()
            self._peek_dirty.discard(i)
        return self._peek_cache[i]

    def _dirty_deep(self, i: int):
        """Mark member ``i``'s next-event time stale after an *external*
        mutation (the member's own internal caches are stale too)."""
        self._peek_dirty.add(i)
        self.members[i].invalidate_peeks()

    def invalidate_peeks(self):
        if self._started:
            for i in range(len(self.members)):
                self._dirty_deep(i)

    def peek_time(self) -> Optional[float]:
        if self._done:
            return None
        times = [t for i in self._active
                 if (t := self._member_peek(i)) is not None]
        return min(times) if times else None

    def step_event(self) -> bool:
        """Process exactly one member event (one iteration of the
        interleaved loop).  Returns False once the run is over."""
        if self._done:
            return False
        if not self._started:
            self.start()
        d = min((i for i in self._active
                 if self._member_peek(i) is not None),
                key=lambda i: (self._member_peek(i), i), default=None)
        if d is None:
            self._finish()
            return False
        t = self._member_peek(d)
        while t >= self._next_epoch and self._next_epoch <= self.horizon:
            self._epoch(self._next_epoch)
            self._next_epoch += self.config.epoch
        if not self.members[d].step_event():
            self._active.discard(d)
        self._peek_dirty.add(d)         # own step: internal caches are fine
        if d not in self.failed_members and self.members[d].failed():
            self._on_member_failed(d, t)
        if self._migrate:
            self._maybe_execute(d)
        if not self._active:
            self._finish()
        return True

    def _finish(self):
        if self._done:
            return
        self._done = True
        if self.config.validate:
            self.check()

    def _needs_interleave(self) -> bool:
        cfg = self.config
        return bool((cfg.migration and len(self.members) > 1)
                    or self.epoch_hooks
                    or any(m.has_faults() for m in self.members))

    def run_loop(self):
        """Run every member to completion.  Uncoupled tiers (migration off,
        no mutating epoch hooks) take the sequential fast path."""
        if self._needs_interleave():
            if not self._started:
                self.start()
            while self.step_event():
                pass
            return
        # sequential fast path: members share no state, so running them to
        # completion one by one is bit-for-bit the interleaved run (the
        # parity property the node tier's tests establish); read-only
        # member hooks still fire at the epoch grid, seeing exactly the
        # state a global sample at that instant would have seen
        if not self._started:
            self.start()
        cfg = self.config
        for mi, m in enumerate(self.members):
            next_epoch = cfg.epoch if self.member_hooks else float("inf")
            while True:
                t = m.peek_time()
                if t is None:
                    break
                while t >= next_epoch and next_epoch <= self.horizon:
                    for hook in self.member_hooks:
                        hook(mi, next_epoch)
                    next_epoch += cfg.epoch
                if not m.step_event():
                    break
            self._active.discard(mi)
        self._finish()
