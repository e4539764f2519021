"""SliceMap — the first-class slice-resource subsystem (§4.2–4.3).

The TPC Scheduler's ground truth about the device's core-slices lives here:

* **Ownership** (§4.2): each slice is owned by one client (its quota) or by
  the shared pool.  Ownership is static for a simulation; re-partitioning is
  a future elastic-migration concern.
* **Holding**: a slice is *held* by at most one in-flight kernel/atom (kid).
  Acquire/release keep incremental idle free-lists per owner plus a pool
  free-list, so free-slice queries cost O(idle slices of the queried owners)
  instead of the O(n_slices) full scans the scheduler used to run on every
  event.
* **Lending / steal ledger** (§4.3 TPC Stealing): every acquisition of a
  slice owned by *another* client opens a :class:`LendRecord`; release closes
  it.  The ledger is the audit trail for conservation tests and the precise
  per-slice-second accounting (``lent_slice_seconds``).  The paper-facing
  ``stolen_slice_seconds`` metric keeps its historical semantics (kernel
  latency × total slices for kernels that dispatched on stolen slices) and is
  credited by the scheduler via :meth:`note_stolen_completion`.
* **Per-slice timers**: ``busy_until`` records the predicted completion of
  the holding atom (from the §4.7 predictor) — when a borrowed slice is due
  back.  Forward-looking state: no scheduling decision reads the timers yet
  (the seed scheduler kept them write-only too); cross-device stealing and
  lend-deadline policies (ROADMAP) are the intended consumers.
* **Conservation invariants**: :meth:`check` asserts, at any instant, that
  owned-idle + pool-idle + held partitions the device exactly and that no
  slice is held by two kernels.

Policies own a SliceMap instance; the simulator never sees it.  MIG/Limits
use the same subsystem with stealing disabled structurally (they only ever
acquire from their own partition).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence

from repro_torch.core.types import Quota


@dataclass
class LendRecord:
    """One slice lent across an ownership boundary for one kernel/atom."""

    slice_id: int
    owner: int                      # lending client
    borrower: int                   # borrowing client
    kid: int                        # holding kernel/atom
    t_start: float
    t_end: Optional[float] = None   # None while the lend is open

    @property
    def open(self) -> bool:
        return self.t_end is None

    @property
    def duration(self) -> float:
        return 0.0 if self.t_end is None else self.t_end - self.t_start


class SliceMap:
    """Slice ownership + holding state with incremental free-lists."""

    def __init__(self, n_slices: int):
        self.n_slices = n_slices
        self.owner: list[Optional[int]] = [None] * n_slices
        self.holder: list[Optional[int]] = [None] * n_slices   # holding kid
        self.busy_until: list[float] = [0.0] * n_slices
        # incremental free-lists (idle == not held)
        self._idle_own: dict[int, set[int]] = {}
        self._idle_pool: set[int] = set(range(n_slices))
        self._held_by_kid: dict[int, list[int]] = {}
        # ECC-retired slices: permanently out of every free-list (fault
        # injection).  A held slice retires lazily at its release — blocks
        # are non-preemptible, so the in-flight kernel finishes first.
        self.retired: set[int] = set()
        self._pending_retire: set[int] = set()
        # steal/lend accounting
        self.ledger: list[LendRecord] = []
        self._open_lends: dict[tuple[int, int], LendRecord] = {}  # (kid, sid)
        self.lent_slice_seconds = 0.0       # precise, per-slice, from ledger
        self.stolen_slice_seconds = 0.0     # legacy kernel-level metric

    # -- construction --------------------------------------------------------

    @classmethod
    def from_quotas(cls, n_slices: int, quotas: dict[int, Quota]) -> "SliceMap":
        """Assign each client its quota slices in ascending cid order (the
        historical LithOSScheduler layout), remainder to the pool."""
        sm = cls(n_slices)
        nxt = 0
        for cid, q in sorted(quotas.items()):
            for _ in range(q.slices):
                if nxt < n_slices:
                    sm.assign_owner(nxt, cid)
                    nxt += 1
        return sm

    @classmethod
    def from_partitions(cls, n_slices: int,
                        partitions: dict[int, int]) -> "SliceMap":
        """MIG-style: contiguous partitions in ascending cid order; slices
        beyond the partitioned range stay pool-owned but MIG policies never
        touch them (the stranded capacity the paper quantifies)."""
        sm = cls(n_slices)
        nxt = 0
        for cid, n in sorted(partitions.items()):
            for _ in range(n):
                if nxt < n_slices:
                    sm.assign_owner(nxt, cid)
                    nxt += 1
        return sm

    def assign_owner(self, sid: int, cid: int):
        assert self.holder[sid] is None, "cannot re-own a held slice"
        old = self.owner[sid]
        if old is None:
            self._idle_pool.discard(sid)
        else:
            self._idle_own[old].discard(sid)
        self.owner[sid] = cid
        self._idle_own.setdefault(cid, set()).add(sid)

    def disown(self, sid: int):
        """Return an idle owned slice to the shared pool — the elastic half
        of ownership: the control plane grants a quota at admission
        (:meth:`assign_owner` on pool slices) and returns it when the
        tenant exits.  A held slice cannot be disowned (blocks are
        non-preemptible); callers retry once the holder releases."""
        assert self.holder[sid] is None, "cannot disown a held slice"
        old = self.owner[sid]
        if old is None:
            return
        self.owner[sid] = None
        s = self._idle_own[old]
        s.discard(sid)
        if not s and self.owned_by(old) == 0:
            del self._idle_own[old]
        self._idle_pool.add(sid)

    def retire(self, sid: int) -> bool:
        """Permanently remove a slice from service (ECC-style fault).

        An idle slice retires immediately; a held one is marked and
        retires when its holding kernel releases it (non-preemptible
        blocks finish first).  Returns True once the slice is out of
        service, False while the retire is pending on a release."""
        if sid in self.retired:
            return True
        if self.holder[sid] is not None:
            self._pending_retire.add(sid)
            return False
        self._do_retire(sid)
        return True

    def _do_retire(self, sid: int):
        o = self.owner[sid]
        if o is None:
            self._idle_pool.discard(sid)
        else:
            s = self._idle_own[o]
            s.discard(sid)
            self.owner[sid] = None
            if not s and self.owned_by(o) == 0:
                del self._idle_own[o]
        self.owner[sid] = None
        self.retired.add(sid)

    # -- queries (incremental free-lists) ------------------------------------

    def owners(self) -> list[int]:
        """Clients owning at least one slice, ascending."""
        return sorted(self._idle_own.keys())

    def owned_by(self, cid: int) -> int:
        return sum(1 for o in self.owner if o == cid)

    def idle_owned(self, cid: int) -> list[int]:
        return sorted(self._idle_own.get(cid, ()))

    def n_own_idle(self, cid: int) -> int:
        return len(self._idle_own.get(cid, ()))

    def idle_pool(self) -> list[int]:
        return sorted(self._idle_pool)

    def total_idle(self) -> int:
        """Idle slices of any kind (owned + pool)."""
        return len(self._idle_pool) + sum(
            len(s) for s in self._idle_own.values())

    def n_owned_idle_total(self) -> int:
        """Idle slices with an owner (pool excluded)."""
        return sum(len(s) for s in self._idle_own.values())

    def idle_owners(self) -> list[int]:
        """Owners with at least one idle slice, ascending — exactly
        ``[o for o in owners() if n_own_idle(o) > 0]``."""
        return [o for o in sorted(self._idle_own) if self._idle_own[o]]

    def idle_stealable(self, borrower: int,
                       lenders: Iterable[int]) -> list[int]:
        """Idle slices owned by the given (willing) lenders, ascending —
        matching the historical whole-device-scan ordering."""
        out: set[int] = set()
        for o in lenders:
            if o == borrower:
                continue
            out |= self._idle_own.get(o, set())
        return sorted(out)

    def free_for(self, borrower: int, *, lenders: Iterable[int] = (),
                 include_pool: bool = True) -> list[int]:
        """Slice ids the borrower may use right now: its own idle slices,
        then the idle pool, then idle slices of willing lenders — each group
        in ascending slice-id order (dispatch preference: own > pool >
        stolen, so steals are the last resort and return soonest)."""
        free = self.idle_owned(borrower)
        if include_pool:
            free += self.idle_pool()
        free += self.idle_stealable(borrower, lenders)
        return free

    def held_by(self, kid: int) -> tuple[int, ...]:
        return tuple(self._held_by_kid.get(kid, ()))

    # -- transitions ---------------------------------------------------------

    def acquire(self, slice_ids: Sequence[int], kid: int, borrower: int,
                now: float, eta: Optional[float] = None) -> bool:
        """Mark slices held by ``kid`` on behalf of ``borrower``.

        ``eta`` (predicted completion latency) sets the per-slice return
        timer; growth acquisitions pass ``eta=None`` and keep the timer
        monotone.  Returns True iff any acquired slice is *stolen* (owned by
        a different client — pool slices are free capacity, not steals).
        Opens a ledger record per stolen slice.
        """
        stolen = False
        for sid in slice_ids:
            assert self.holder[sid] is None, (sid, self.holder[sid], kid)
            o = self.owner[sid]
            self.holder[sid] = kid
            self.busy_until[sid] = (now + eta if eta is not None
                                    else max(self.busy_until[sid], now))
            if o is None:
                self._idle_pool.discard(sid)
            else:
                self._idle_own[o].discard(sid)
            self._held_by_kid.setdefault(kid, []).append(sid)
            if o is not None and o != borrower:
                stolen = True
                rec = LendRecord(sid, o, borrower, kid, now)
                self.ledger.append(rec)
                self._open_lends[(kid, sid)] = rec
        return stolen

    def release(self, kid: int, now: float) -> tuple[int, ...]:
        """Free every slice held by ``kid``; closes its lend records."""
        freed = self._held_by_kid.pop(kid, [])
        for sid in freed:
            assert self.holder[sid] == kid
            self.holder[sid] = None
            self.busy_until[sid] = now
            o = self.owner[sid]
            if o is None:
                self._idle_pool.add(sid)
            else:
                self._idle_own[o].add(sid)
            rec = self._open_lends.pop((kid, sid), None)
            if rec is not None:
                rec.t_end = now
                self.lent_slice_seconds += rec.duration
            if sid in self._pending_retire:
                self._pending_retire.discard(sid)
                self._do_retire(sid)
        return tuple(freed)

    def note_stolen_completion(self, latency: float, slices: int):
        """Credit the paper-facing steal metric (kernel latency × slices for
        kernels dispatched on stolen capacity — §7 accounting)."""
        self.stolen_slice_seconds += latency * slices

    # -- invariants ----------------------------------------------------------

    def counts(self) -> dict[str, int]:
        held = sum(len(v) for v in self._held_by_kid.values())
        owned_idle = sum(len(v) for v in self._idle_own.values())
        return {"owned_idle": owned_idle, "pool_idle": len(self._idle_pool),
                "held": held,
                "lent": sum(1 for r in self.ledger if r.open),
                "retired": len(self.retired)}

    def check(self):
        """Conservation: idle ∪ held ∪ retired partitions [0, n_slices); no
        slice is held twice; free-lists agree with the holder array; open
        ledger entries match currently-held stolen slices."""
        held: set[int] = set()
        for kid, ids in self._held_by_kid.items():
            for sid in ids:
                assert sid not in held, f"slice {sid} held twice"
                assert self.holder[sid] == kid, (sid, kid, self.holder[sid])
                held.add(sid)
        idle: set[int] = set()
        for cid, ids in self._idle_own.items():
            for sid in ids:
                assert self.owner[sid] == cid
                assert sid not in idle
                idle.add(sid)
        for sid in self._idle_pool:
            assert self.owner[sid] is None
            assert sid not in idle
            idle.add(sid)
        assert not (held & idle), held & idle
        for sid in self.retired:
            assert self.holder[sid] is None and self.owner[sid] is None, sid
            assert sid not in held and sid not in idle, sid
        assert self._pending_retire <= held, (self._pending_retire, held)
        assert len(held) + len(idle) + len(self.retired) == self.n_slices, (
            len(held), len(idle), len(self.retired), self.n_slices)
        for sid in idle:
            assert self.holder[sid] is None, sid
        open_lends = {(r.kid, r.slice_id) for r in self.ledger if r.open}
        assert open_lends == set(self._open_lends)
        for kid, sid in open_lends:
            assert self.holder[sid] == kid
            assert self.owner[sid] is not None
        closed = sum(r.duration for r in self.ledger if not r.open)
        assert abs(closed - self.lent_slice_seconds) < 1e-9
        return True


def _mask_bits(m: int) -> list[int]:
    """Set-bit indices of a mask, ascending."""
    out = []
    while m:
        b = m & -m
        out.append(b.bit_length() - 1)
        m ^= b
    return out


class VecSliceMap:
    """Bit-packed SliceMap for the vectorized engine (engine_vec).

    Same interface, ordering and accounting semantics as :class:`SliceMap`
    — free-lists are integer bitmasks (one bit per slice), so free-slice
    queries, acquire and release are word ops instead of set/sort churn
    (``SliceMap.acquire`` alone was ~360 µs/call in the reference profile).
    Differences, all invisible to scheduling decisions:

    * no per-lend :class:`LendRecord` objects — ``lent_slice_seconds`` is
      accumulated from per-slice open-lend start times in release order,
      which is exactly the order the reference ledger closes records in,
      so the float sum is bit-identical; ``ledger`` is not provided (the
      ledger-inspecting tests run the reference engine).
    * ``check()`` verifies the same partition/holder/open-lend invariants
      directly on the masks.

    Python bigints make this width-agnostic (n_slices > 64 still works).
    """

    def __init__(self, n_slices: int):
        self.n_slices = n_slices
        self.owner: list[Optional[int]] = [None] * n_slices
        self.holder: list[Optional[int]] = [None] * n_slices
        self.busy_until: list[float] = [0.0] * n_slices
        self._idle_own: dict[int, int] = {}          # cid -> idle mask
        self._own_mask: dict[int, int] = {}          # cid -> owned mask
        self._idle_owned_union: int = 0              # union of _idle_own
        self._idle_pool: int = (1 << n_slices) - 1 if n_slices else 0
        self._n_idle = n_slices
        self._held_by_kid: dict[int, list[int]] = {}
        self.retired: set[int] = set()
        self._pending_retire: set[int] = set()
        self._open_lends: dict[tuple[int, int], tuple[int, int, float]] = {}
        # (kid, sid) -> (owner, borrower, t_start)
        self.lent_slice_seconds = 0.0
        self.stolen_slice_seconds = 0.0
        self.n_lends = 0                             # lends ever opened
        self._owners_sorted: Optional[list[int]] = None

    # -- construction (same layout rules as SliceMap) ------------------------

    @classmethod
    def from_quotas(cls, n_slices: int,
                    quotas: dict[int, "Quota"]) -> "VecSliceMap":
        sm = cls(n_slices)
        nxt = 0
        for cid, q in sorted(quotas.items()):
            for _ in range(q.slices):
                if nxt < n_slices:
                    sm.assign_owner(nxt, cid)
                    nxt += 1
        return sm

    @classmethod
    def from_partitions(cls, n_slices: int,
                        partitions: dict[int, int]) -> "VecSliceMap":
        sm = cls(n_slices)
        nxt = 0
        for cid, n in sorted(partitions.items()):
            for _ in range(n):
                if nxt < n_slices:
                    sm.assign_owner(nxt, cid)
                    nxt += 1
        return sm

    def assign_owner(self, sid: int, cid: int):
        assert self.holder[sid] is None, "cannot re-own a held slice"
        bit = 1 << sid
        old = self.owner[sid]
        if old is None:
            self._idle_pool &= ~bit
        else:
            self._idle_own[old] &= ~bit
            self._own_mask[old] &= ~bit
        self.owner[sid] = cid
        self._idle_own[cid] = self._idle_own.get(cid, 0) | bit
        self._own_mask[cid] = self._own_mask.get(cid, 0) | bit
        self._idle_owned_union |= bit
        self._owners_sorted = None

    def disown(self, sid: int):
        """See :meth:`SliceMap.disown` — same elastic-release semantics on
        the bitmask free-lists."""
        assert self.holder[sid] is None, "cannot disown a held slice"
        old = self.owner[sid]
        if old is None:
            return
        bit = 1 << sid
        self.owner[sid] = None
        self._idle_own[old] &= ~bit
        self._own_mask[old] &= ~bit
        if not self._own_mask[old]:
            del self._idle_own[old]
            del self._own_mask[old]
        self._idle_owned_union &= ~bit
        self._idle_pool |= bit
        self._owners_sorted = None

    def retire(self, sid: int) -> bool:
        """See :meth:`SliceMap.retire` — same lazy-on-held semantics on the
        bitmask free-lists."""
        if sid in self.retired:
            return True
        if self.holder[sid] is not None:
            self._pending_retire.add(sid)
            return False
        self._do_retire(sid)
        return True

    def _do_retire(self, sid: int):
        bit = 1 << sid
        o = self.owner[sid]
        if o is None:
            self._idle_pool &= ~bit
        else:
            self._idle_own[o] &= ~bit
            self._own_mask[o] &= ~bit
            if not self._own_mask[o]:
                del self._idle_own[o]
                del self._own_mask[o]
            self._idle_owned_union &= ~bit
            self._owners_sorted = None
        self.owner[sid] = None
        self._n_idle -= 1
        self.retired.add(sid)

    # -- queries -------------------------------------------------------------

    def owners(self) -> list[int]:
        if self._owners_sorted is None:
            self._owners_sorted = sorted(self._idle_own.keys())
        return self._owners_sorted

    def owned_by(self, cid: int) -> int:
        return self._own_mask.get(cid, 0).bit_count()

    def idle_owned(self, cid: int) -> list[int]:
        return _mask_bits(self._idle_own.get(cid, 0))

    def n_own_idle(self, cid: int) -> int:
        return self._idle_own.get(cid, 0).bit_count()

    def idle_pool(self) -> list[int]:
        return _mask_bits(self._idle_pool)

    def total_idle(self) -> int:
        return self._n_idle

    def n_owned_idle_total(self) -> int:
        return self._n_idle - self._idle_pool.bit_count()

    def idle_owners(self) -> list[int]:
        return [o for o in self.owners() if self._idle_own[o]]

    def idle_stealable(self, borrower: int,
                       lenders: Iterable[int]) -> list[int]:
        m = 0
        for o in lenders:
            if o == borrower:
                continue
            m |= self._idle_own.get(o, 0)
        return _mask_bits(m)

    def free_for(self, borrower: int, *, lenders: Iterable[int] = (),
                 include_pool: bool = True) -> list[int]:
        free = self.idle_owned(borrower)
        if include_pool:
            free += self.idle_pool()
        free += self.idle_stealable(borrower, lenders)
        return free

    # -- mask fast path (vectorized dispatch) --------------------------------

    def idle_own_mask(self, cid: int) -> int:
        return self._idle_own.get(cid, 0)

    def own_mask(self, cid: int) -> int:
        return self._own_mask.get(cid, 0)

    def idle_owned_union(self) -> int:
        """Union of every owner's idle mask (excludes the unowned pool)."""
        return self._idle_owned_union

    def take_free(self, borrower: int, want: int, steal_mask: int,
                  include_pool: bool = True) -> tuple[list[int], int]:
        """First-``want`` free slice ids in the reference ``free_for``
        order — own idle ascending, then pool ascending, then the
        stealable union ascending — plus the total free count.  The
        mask-only equivalent of ``free_for(...)[:want]`` without
        materializing the full id list."""
        own = self._idle_own.get(borrower, 0)
        pool = self._idle_pool if include_pool else 0
        n = own.bit_count() + pool.bit_count() + steal_mask.bit_count()
        if want > n:
            want = n
        out: list[int] = []
        for m in (own, pool, steal_mask):
            while m and len(out) < want:
                b = m & -m
                out.append(b.bit_length() - 1)
                m ^= b
            if len(out) >= want:
                break
        return out, n

    def held_by(self, kid: int) -> tuple[int, ...]:
        return tuple(self._held_by_kid.get(kid, ()))

    # -- transitions ---------------------------------------------------------

    def acquire(self, slice_ids: Sequence[int], kid: int, borrower: int,
                now: float, eta: Optional[float] = None) -> bool:
        stolen = False
        held = self._held_by_kid.get(kid)
        if held is None:
            held = self._held_by_kid[kid] = []
        holder, busy, owner = self.holder, self.busy_until, self.owner
        idle_own = self._idle_own
        pool = self._idle_pool
        union = self._idle_owned_union
        idle_before = pool | union
        bu = now + eta if eta is not None else None
        m = 0
        for sid in slice_ids:
            bit = 1 << sid
            m |= bit
            o = owner[sid]
            holder[sid] = kid
            busy[sid] = bu if bu is not None else max(busy[sid], now)
            if o is None:
                pool &= ~bit
            else:
                idle_own[o] &= ~bit
                union &= ~bit
                if o != borrower:
                    stolen = True
                    self._open_lends[(kid, sid)] = (o, borrower, now)
                    self.n_lends += 1
            held.append(sid)
        # every acquired slice must have been idle (the per-sid holder
        # check of the reference map, done as one mask comparison)
        assert m & idle_before == m, (kid, slice_ids)
        self._idle_pool = pool
        self._idle_owned_union = union
        self._n_idle -= len(slice_ids)
        return stolen

    def release(self, kid: int, now: float) -> tuple[int, ...]:
        freed = self._held_by_kid.pop(kid, [])
        holder, busy, owner = self.holder, self.busy_until, self.owner
        idle_own = self._idle_own
        pool = self._idle_pool
        union = self._idle_owned_union
        lends = self._open_lends
        lent = self.lent_slice_seconds
        for sid in freed:
            bit = 1 << sid
            holder[sid] = None
            busy[sid] = now
            o = owner[sid]
            if o is None:
                pool |= bit
            else:
                idle_own[o] |= bit
                union |= bit
                if lends:
                    lend = lends.pop((kid, sid), None)
                    if lend is not None:
                        lent += now - lend[2]
        self._idle_pool = pool
        self._idle_owned_union = union
        self.lent_slice_seconds = lent
        self._n_idle += len(freed)
        if self._pending_retire:
            for sid in freed:
                if sid in self._pending_retire:
                    self._pending_retire.discard(sid)
                    self._do_retire(sid)
        return tuple(freed)

    def note_stolen_completion(self, latency: float, slices: int):
        self.stolen_slice_seconds += latency * slices

    # -- invariants ----------------------------------------------------------

    def counts(self) -> dict[str, int]:
        owned_idle = sum(m.bit_count() for m in self._idle_own.values())
        pool_idle = self._idle_pool.bit_count()
        return {"owned_idle": owned_idle, "pool_idle": pool_idle,
                "held": (self.n_slices - owned_idle - pool_idle
                         - len(self.retired)),
                "lent": len(self._open_lends),
                "retired": len(self.retired)}

    def check(self):
        held: set[int] = set()
        for kid, ids in self._held_by_kid.items():
            for sid in ids:
                assert sid not in held, f"slice {sid} held twice"
                assert self.holder[sid] == kid, (sid, kid, self.holder[sid])
                held.add(sid)
        idle: set[int] = set()
        for cid, m in self._idle_own.items():
            for sid in _mask_bits(m):
                assert self.owner[sid] == cid
                assert sid not in idle
                idle.add(sid)
        for sid in _mask_bits(self._idle_pool):
            assert self.owner[sid] is None
            assert sid not in idle
            idle.add(sid)
        assert not (held & idle), held & idle
        for sid in self.retired:
            assert self.holder[sid] is None and self.owner[sid] is None, sid
            assert sid not in held and sid not in idle, sid
        assert self._pending_retire <= held, (self._pending_retire, held)
        assert len(held) + len(idle) + len(self.retired) == self.n_slices, (
            len(held), len(idle), len(self.retired), self.n_slices)
        assert len(idle) == self._n_idle, (len(idle), self._n_idle)
        for sid in idle:
            assert self.holder[sid] is None, sid
        for kid, sid in self._open_lends:
            assert self.holder[sid] == kid
            assert self.owner[sid] is not None
        return True


# ---------------------------------------------------------------------------
# Member-level lending ledger (cross-member stealing, any hierarchy tier)
# ---------------------------------------------------------------------------

@dataclass
class MemberLendRecord:
    """One client queue hosted away from its home member.

    The hierarchy-scale mirror of :class:`LendRecord`: instead of one slice
    lent across an ownership boundary for one kernel, this is one *member's
    worth of stealable capacity* lent across a member boundary for one
    migration interval — a device boundary for the node tier, a node
    boundary for the cluster tier.  ``home`` is the member the router placed
    the client on (the saturated borrower of help); ``host`` is the idle
    member donating its capacity by hosting the queue."""

    cid: int
    home: int
    host: int
    t_start: float
    t_end: Optional[float] = None   # None while the client is away

    @property
    def open(self) -> bool:
        return self.t_end is None

    @property
    def duration(self) -> float:
        return 0.0 if self.t_end is None else self.t_end - self.t_start


class MemberLedger:
    """Cross-member donation bookkeeping for one hierarchy tier's
    coordinator (devices of a node; nodes of a cluster).

    Tracks each client's home (router placement) and current member, records
    a :class:`MemberLendRecord` per away interval, and extends the SliceMap
    conservation story across the tier: at any instant every client is
    hosted by exactly one member, and the open records are exactly the
    clients hosted off their home member.

    ``placement`` maps cid -> member: either a dict, or a sequence indexed
    by cid (the node tier's app-ordered placement list)."""

    def __init__(self, n_members: int, placement):
        self.n_members = n_members
        base = (dict(placement) if isinstance(placement, dict)
                else dict(enumerate(placement)))
        self.home: dict[int, int] = dict(base)
        self.current: dict[int, int] = dict(base)
        self.ledger: list[MemberLendRecord] = []
        self._open: dict[int, MemberLendRecord] = {}
        self.lent_client_seconds = 0.0  # closed away-intervals, from ledger
        self.n_migrations = 0

    @property
    def n_devices(self) -> int:     # node-tier alias
        return self.n_members

    def migrate(self, cid: int, dst: int, now: float):
        """Record that ``cid``'s launch queue moved to member ``dst``."""
        assert 0 <= dst < self.n_members
        src = self.current[cid]
        assert dst != src, (cid, dst)
        rec = self._open.pop(cid, None)
        if rec is not None:             # returning home or re-lending
            assert now >= rec.t_start, (cid, now, rec.t_start)
            rec.t_end = now
            self.lent_client_seconds += rec.duration
        if dst != self.home[cid]:
            nr = MemberLendRecord(cid, self.home[cid], dst, now)
            self.ledger.append(nr)
            self._open[cid] = nr
        self.current[cid] = dst
        self.n_migrations += 1

    def drop(self, cid: int, now: float):
        """Forget ``cid`` — a higher tier migrated it out of this tier's
        scope.  Any open away-interval is closed (the donation ended when
        the client left the tier)."""
        rec = self._open.pop(cid, None)
        if rec is not None:
            assert now >= rec.t_start, (cid, now, rec.t_start)
            rec.t_end = now
            self.lent_client_seconds += rec.duration
        del self.current[cid]
        del self.home[cid]

    def adopt(self, cid: int, member: int):
        """Register ``cid`` as newly hosted in this tier's scope — a higher
        tier migrated it in.  The landing member becomes its home (the
        client was freshly placed there, not lent within this tier)."""
        assert cid not in self.current, cid
        assert 0 <= member < self.n_members
        self.home[cid] = member
        self.current[cid] = member

    def donated_seconds(self, now: float) -> float:
        """Total away time including still-open intervals."""
        return self.lent_client_seconds + sum(
            now - r.t_start for r in self._open.values())

    def check(self, hosted: Optional[dict[int, int]] = None):
        """Conservation across members: the hosted map (cid -> member, from
        the live simulators) matches ``current``; open records are exactly
        the off-home clients; closed durations sum to the counter."""
        if hosted is not None:
            assert hosted == self.current, (hosted, self.current)
        off_home = {cid for cid, d in self.current.items()
                    if d != self.home[cid]}
        assert set(self._open) == off_home, (set(self._open), off_home)
        for cid, rec in self._open.items():
            assert rec.open and rec.host == self.current[cid]
            assert rec.home == self.home[cid]
        closed = sum(r.duration for r in self.ledger if not r.open)
        assert abs(closed - self.lent_client_seconds) < 1e-9
        return True


# Node-tier names, kept for callers that predate the hierarchy refactor.
NodeLendRecord = MemberLendRecord
NodeLedger = MemberLedger
