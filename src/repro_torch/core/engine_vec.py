"""Vectorized simulator core — slot-indexed arrays, bit-for-bit parity.

Drop-in engine for :class:`~repro_torch.core.simulator.Simulator` built for raw
events/sec on large traces (the ROADMAP's cluster tier and million-request
open-loop runs).  The public API, semantics and float results are the
reference engine's, exactly:

* **Slot arrays** — every in-flight kernel occupies one slot in a set of
  parallel numpy arrays (overhead left, divisible fraction left, work
  terms, slices, interference, per-client slice-second accumulator).
  ``_advance`` becomes whole-array arithmetic instead of a Python loop over
  ``in_flight``; held-slice and tenant counts are maintained incrementally
  so ``free_slices()`` is O(1).
* **Batched completion times** — dispatches inside one event are queued and
  their ETAs computed as one vectorized evaluation of the roofline formula,
  flushed (in dispatch order, preserving heap tie-breaking) before any
  other heap push can interleave.
* **Pre-generated arrival streams** — per-client arrival lists are merged
  into one time-sorted array at ``start()`` instead of being pushed through
  the heap one event each.  The merge replicates the reference counter
  order (per-client blocks in client order, stable sort by time), and the
  stream competes with the heap under the reference tie rule: arrivals were
  pushed first in ``start()``, so an arrival wins every time tie against
  tick/end/runtime events.  ``_arr_gen`` detach/admit semantics are kept:
  stream entries carry generation 0, re-seeded arrivals from
  ``admit_client`` go through the heap with the current generation.
* **Incremental client sets** — clients notify the engine (via the
  ``Client._watch`` hook) whenever queue state changes; the engine keeps
  ready (dispatchable-kernel) and startable (can-begin-next-job) sets so
  policies and the job-start loop iterate candidates, not all clients.
  Policies opt in via ``getattr(sim, "vec", False)``; unknown policies fall
  back to reference-identical full scans.
* **Changes-only allocation protocol** — ``Policy.alloc_changes`` lets a
  policy promise which kernels may have changed allocation; the engine
  skips the per-kernel compare/reschedule scan when nothing could have.

Parity contract (asserted by tests/test_engine_vec.py on every tier-1
scenario): identical CompletionRecord streams (same kids, same floats),
identical energy integral, busy_slice_seconds and per-client slice_seconds.
All float accumulations keep the reference's per-event add order — numpy
elementwise double ops are IEEE-identical to the scalar ones, and no
pairwise-summed reduction is used where the reference accumulates
sequentially.

Engine constraint: at most one in-flight kernel per client (true of every
shipped policy — strict per-queue FIFO).  The per-client slice-second
accumulator relies on it; violations raise immediately.
"""
from __future__ import annotations

import heapq
import math
from bisect import bisect_left, insort
from typing import Optional

import numpy as np

from repro_torch.core.queues import Client
from repro_torch.core.simulator import ExecKernel, Simulator
from repro_torch.core.types import CompletionRecord

_INF = float("inf")

_F_ARRAYS = ("_s_ov", "_s_div", "_s_cw", "_s_mw", "_s_nbf", "_s_muf",
             "_s_slf", "_s_int", "_s_css")
_I_ARRAYS = ("_s_sl", "_s_mu")


class VecSimulator(Simulator):
    vec = True

    def __init__(self, device, apps, policy, *, horizon: float = 30.0,
                 seed: int = 0, cids: Optional[list[int]] = None,
                 collect_records: bool = True, faults=()):
        # incremental aggregates mirroring the reference's per-event scans;
        # set before super().__init__ so policy.attach (called there) can
        # already use free_slices()/held_slices()
        self._held_total = 0                 # sum of in-flight ek.slices
        self._tenant_count: dict[int, int] = {}
        # deferred dispatch ETAs: (slot, kid), flushed in dispatch order
        self._eta_pending: list[tuple[int, int]] = []
        super().__init__(device, apps, policy, horizon=horizon, seed=seed,
                         cids=cids, collect_records=collect_records,
                         faults=faults)
        # slot capacity: most policies dispatch at most one kernel per
        # client AND one slice per kernel bounds in-flight by n_slices;
        # MPS-style policies can exceed this (0-slice kernels), which
        # _grow_slots absorbs on demand
        self._init_slots(max(1, min(len(self.clients),
                                    self.device.n_slices)))
        # merged arrival stream (built in start())
        self._arr_t_list: list[float] = []
        self._arr_cid_list: list[int] = []
        self._arr_ptr = 0
        self._arr_n = 0
        # incremental client sets
        for c in self.clients:
            c._watch = self
        self._reindex_clients()

    # -- slot management ------------------------------------------------------

    def _init_slots(self, cap: int):
        self._cap = cap
        z = np.zeros
        self._s_ov = z(cap)       # overhead_left
        self._s_div = z(cap)      # div_left
        self._s_cw = z(cap)       # c_work
        self._s_mw = z(cap)       # m_work
        self._s_nbf = np.ones(cap)   # n_blocks (float; benign 1 when free)
        self._s_muf = np.ones(cap)   # max_useful_slices (float mirror)
        self._s_slf = z(cap)      # slices (float mirror)
        self._s_int = np.ones(cap)   # interference factor
        self._s_css = z(cap)      # client slice_seconds accumulator
        self._s_sl = z(cap, dtype=np.int64)    # slices (exact busy sums)
        self._s_mu = z(cap, dtype=np.int64)    # max_useful (exact busy sums)
        self._s_act = z(cap, dtype=bool)       # slot occupied
        # cached drain rate d(div_left)/dt — a pure function of the slot's
        # work terms, slices, interference and the device frequency, so it
        # only moves on dispatch / allocation change / fswitch, not per
        # event.  0 for free slots and 0-slice kernels (ref speed() rule).
        self._s_speed = z(cap)
        self._tmp = z(cap)                     # masked-op scratch
        self._ek_of_slot: list[Optional[ExecKernel]] = [None] * cap
        self._slot_of_kid: dict[int, int] = {}
        self._free_slots = list(range(cap - 1, -1, -1))   # pop() -> slot 0 first

    def _grow_slots(self):
        old = self._cap
        new = max(4, old * 2)
        for name in _F_ARRAYS + ("_s_speed",):
            arr = np.zeros(new)
            arr[:old] = getattr(self, name)
            setattr(self, name, arr)
        self._tmp = np.zeros(new)
        for name in _I_ARRAYS:
            arr = np.zeros(new, dtype=np.int64)
            arr[:old] = getattr(self, name)
            setattr(self, name, arr)
        act = np.zeros(new, dtype=bool)
        act[:old] = self._s_act
        self._s_act = act
        self._s_nbf[old:] = 1.0
        self._s_muf[old:] = 1.0
        self._s_int[old:] = 1.0
        self._ek_of_slot.extend([None] * (new - old))
        self._free_slots.extend(range(new - 1, old - 1, -1))
        self._cap = new

    # -- incremental ready/startable sets -------------------------------------

    def _reindex_clients(self):
        self._pos = {c.cid: i for i, c in enumerate(self.clients)}
        self._ready_in: set[int] = set()
        self._ready_pos: list[tuple[int, int]] = []       # (pos, cid)
        self._ready_pri: list[tuple[int, int, int]] = []  # (-prio, pos, cid)
        self._startable: set[int] = set()
        for c in self.clients:
            self._client_refresh(c)

    def _client_refresh(self, c: Client):
        """Exact recompute of one client's set memberships (the Client
        ``_watch`` hook; called after every queue-state mutation)."""
        cid = c.cid
        pos = self._pos.get(cid)
        if pos is None:
            return                       # detached
        ready = c.peek() is not None
        if ready != (cid in self._ready_in):
            pk = (pos, cid)
            rk = (-int(c.spec.priority), pos, cid)
            if ready:
                self._ready_in.add(cid)
                insort(self._ready_pos, pk)
                insort(self._ready_pri, rk)
            else:
                self._ready_in.discard(cid)
                del self._ready_pos[bisect_left(self._ready_pos, pk)]
                del self._ready_pri[bisect_left(self._ready_pri, rk)]
        if c._startable_now():
            self._startable.add(cid)
        else:
            self._startable.discard(cid)

    def client_pos(self, cid: int) -> int:
        """Index of a client in the client list (the reference iteration
        order — stable-sort tiebreaker for policy candidate ordering)."""
        return self._pos[cid]

    def ready_clients(self) -> list[Client]:
        """Clients with a dispatchable kernel, in client-list order."""
        cb = self.client_by_id
        return [cb[cid] for _, cid in self._ready_pos]

    def ready_by_priority(self) -> list[Client]:
        """Ready clients ordered like ``sorted(clients, key=-priority)``
        (stable: priority desc, client-list position asc)."""
        cb = self.client_by_id
        return [cb[cid] for _, _, cid in self._ready_pri]

    # -- O(1) capacity queries -------------------------------------------------

    def held_slices(self) -> int:
        return self._held_total

    def free_slices(self) -> int:
        return max(0, self.device.n_slices - self.n_retired
                   - self._held_total)

    # -- dispatch interface ----------------------------------------------------

    def start_kernel(self, client, task, slices, *, slice_set=(),
                     stolen=False, t_submit=None) -> ExecKernel:
        phases = self.cost.phases(task.work)
        ek = ExecKernel(task=task, client=client, phases=phases,
                        t_submit=self.now if t_submit is None else t_submit,
                        t_start=self.now,
                        overhead_left=phases.overhead,
                        slices=max(0, slices), slice_set=slice_set,
                        stolen=stolen)
        self.in_flight[task.kid] = ek
        cid = client.cid
        if self._tenant_count.get(cid, 0):
            raise RuntimeError(
                "engine='vec' requires at most one in-flight kernel per "
                "client (strict per-queue FIFO); use engine='ref' for "
                "policies that dispatch deeper")
        self._tenant_count[cid] = 1
        self._held_total += ek.slices
        if not self._free_slots:
            self._grow_slots()
        slot = self._free_slots.pop()
        self._slot_of_kid[task.kid] = slot
        self._ek_of_slot[slot] = ek
        self._s_ov[slot] = phases.overhead
        self._s_div[slot] = 1.0
        self._s_cw[slot] = phases.c_work
        self._s_mw[slot] = phases.m_work
        self._s_nbf[slot] = float(phases.n_blocks)
        self._s_muf[slot] = float(phases.max_useful_slices)
        self._s_slf[slot] = float(ek.slices)
        self._s_int[slot] = 1.0
        self._s_css[slot] = client.slice_seconds
        self._s_sl[slot] = ek.slices
        self._s_mu[slot] = phases.max_useful_slices
        self._s_act[slot] = True
        self._s_speed[slot] = self._speed_scalar(slot)
        # completion time deferred: computed vectorized with the rest of
        # this event's dispatch batch, pushed before any later heap insert
        self._eta_pending.append((slot, task.kid))
        return ek

    def kill(self, kid: int):
        ek = self.in_flight.pop(kid, None)
        if ek is None:
            return None
        ek.gen += 1
        self._release_slot(kid, ek)
        return ek.task

    def _release_slot(self, kid: int, ek: ExecKernel):
        slot = self._slot_of_kid.pop(kid)
        # write back the per-client slice-second accumulator (same add
        # sequence as the reference's direct per-event accumulation)
        ek.client.slice_seconds = float(self._s_css[slot])
        self._ek_of_slot[slot] = None
        self._held_total -= ek.slices
        del self._tenant_count[ek.client.cid]
        self._s_ov[slot] = 0.0
        self._s_div[slot] = 0.0
        self._s_cw[slot] = 0.0
        self._s_mw[slot] = 0.0
        self._s_nbf[slot] = 1.0
        self._s_muf[slot] = 1.0
        self._s_slf[slot] = 0.0
        self._s_int[slot] = 1.0
        self._s_sl[slot] = 0
        self._s_mu[slot] = 0
        self._s_act[slot] = False
        self._s_speed[slot] = 0.0
        self._free_slots.append(slot)

    # -- completion-time computation -------------------------------------------

    def _speed_scalar(self, slot: int) -> float:
        """Drain rate of one slot — ``ExecKernel.speed``'s exact operation
        sequence (scalar IEEE doubles == numpy elementwise doubles), so the
        cached array is interchangeable with on-the-fly evaluation."""
        sl = float(self._s_slf[slot])
        if sl <= 0.0:
            return 0.0
        t_eff = max(min(sl, float(self._s_muf[slot])), 1.0)
        per_wave = t_eff * float(self.device.occupancy)
        ideal = float(self._s_nbf[slot]) / per_wave
        quant = math.ceil(ideal) / ideal
        t_div = max(float(self._s_cw[slot]) / self.freq,
                    float(self._s_mw[slot])) / t_eff * quant
        if t_div <= 0.0:
            return _INF
        return float(self._s_int[slot]) / t_div

    def _recompute_speeds(self):
        """Re-derive every slot's cached drain rate (frequency switched)."""
        t_eff = np.maximum(np.minimum(self._s_slf, self._s_muf), 1.0)
        per_wave = t_eff * float(self.device.occupancy)
        ideal = self._s_nbf / per_wave
        quant = np.ceil(ideal) / ideal
        t_div = np.maximum(self._s_cw / self.freq,
                           self._s_mw) / t_eff * quant
        sp = np.divide(self._s_int, t_div,
                       out=np.full(self._cap, np.inf), where=(t_div > 0.0))
        sp[self._s_sl <= 0] = 0.0
        sp[~self._s_act] = 0.0
        self._s_speed = sp

    def _etas_for(self, slots) -> np.ndarray:
        """Vectorized ``ExecKernel.eta`` over the cached drain rates."""
        idx = np.asarray(slots, dtype=np.intp)
        sp = self._s_speed[idx]
        div_t = np.divide(self._s_div[idx], sp,
                          out=np.zeros(len(idx)), where=(sp > 0.0))
        eta = self._s_ov[idx] + div_t      # div/inf == 0.0: overhead only
        eta[sp == 0.0] = np.inf            # slices <= 0: never completes
        return eta

    def _eta_scalar(self, slot: int) -> float:
        """Single-slot ``_etas_for`` without array round-trips.  Scalar
        IEEE double ops are the same correctly-rounded operations numpy
        applies elementwise, so results are bit-identical (div/inf == 0.0
        covers the overhead-only lane the masked divide produces)."""
        sp = float(self._s_speed[slot])
        if sp == 0.0:
            return _INF
        return float(self._s_ov[slot]) + float(self._s_div[slot]) / sp

    def _flush_etas(self):
        """Push completion events for the pending dispatch batch, in
        dispatch order (heap counters must match the reference's
        push-at-dispatch sequence)."""
        pend = self._eta_pending
        if not pend:
            return
        self._eta_pending = []
        live = [(slot, kid) for slot, kid in pend
                if self._slot_of_kid.get(kid) == slot]
        if not live:
            return
        if len(live) == 1:
            etas = [self._eta_scalar(live[0][0])]
        else:
            etas = self._etas_for([s for s, _ in live]).tolist()
        now = self.now
        for (slot, kid), eta in zip(live, etas):
            ek = self._ek_of_slot[slot]
            ek.gen += 1
            if eta != _INF:
                self._push(now + eta, "complete", (kid, ek.gen))

    def _schedule_completion(self, ek: ExecKernel):
        # flush first: any deferred dispatch pushes precede this one in the
        # reference's counter order
        if self._eta_pending:
            self._flush_etas()
        ek.gen += 1
        eta = self._eta_scalar(self._slot_of_kid[ek.task.kid])
        if eta != _INF:
            self._push(self.now + eta, "complete", (ek.task.kid, ek.gen))

    # -- state advance ---------------------------------------------------------

    def _advance(self, t_new: float):
        dt = t_new - self.now
        if dt <= 0:
            self.now = max(self.now, t_new)
            return
        if not self.in_flight:
            # busy == 0; adding dt*0 to the busy/css accumulators is the
            # identity, so only the energy integral needs the event
            self.energy += dt * self.device.power(0, self.freq)
            self.now = t_new
            return
        busy = int(np.minimum(self._s_sl, self._s_mu).sum())
        ns = self.device.n_slices
        if busy > ns:
            busy = ns
        self.energy += dt * self.device.power(busy, self.freq)
        self.busy_slice_seconds += dt * busy
        ov = self._s_ov
        o = np.minimum(ov, dt)
        ov -= o
        used = dt - o
        div = self._s_div
        # div[upd] = max(0, div - used*speed), masked so untouched lanes
        # never compute (0 * inf on an overhead-only free lane would warn)
        upd = (used > 0.0) & (div > 0.0)
        tmp = self._tmp
        np.multiply(used, self._s_speed, out=tmp, where=upd)
        np.subtract(div, tmp, out=tmp, where=upd)
        np.maximum(tmp, 0.0, out=tmp, where=upd)
        np.copyto(div, tmp, where=upd)
        self._s_css += dt * self._s_slf
        self.now = t_new

    # -- allocation application -------------------------------------------------

    def _apply_allocations(self):
        if self._eta_pending:
            self._flush_etas()
        pol = self.policy
        if not self.in_flight:
            return []
        alloc = pol.alloc_changes(self.now)
        if alloc is None:
            alloc = pol.allocations(self.now)     # unknown policy: full scan
        pen = pol.interference_penalty
        if pen:
            factor = max(0.3, 1.0 - pen * (len(self._tenant_count) - 1))
        else:
            factor = 1.0
        scan = bool(alloc)
        if not scan and pen:
            # factor changed for some co-resident kernel?  (vector test over
            # occupied slots — exactly the reference's per-kernel compare)
            d = np.abs(self._s_int - factor) > 1e-9
            scan = bool(np.any(d & self._s_act))
        if not scan:
            return []
        changed = []
        shrink = pol.allow_shrink
        for kid, ek in self.in_flight.items():
            s = alloc.get(kid, ek.slices)
            if s < 0:
                s = 0
            if not shrink and s < ek.slices:
                s = ek.slices              # blocks are non-preemptible
            if s != ek.slices or abs(factor - ek.interference) > 1e-9:
                slot = self._slot_of_kid[kid]
                self._held_total += s - ek.slices
                ek.slices = s
                ek.interference = factor
                self._s_sl[slot] = s
                self._s_slf[slot] = float(s)
                self._s_int[slot] = factor
                self._s_speed[slot] = self._speed_scalar(slot)
                changed.append(ek)
        for ek in changed:
            self._schedule_completion(ek)
        return changed

    def _complete(self, ek: ExecKernel):
        kid = ek.task.kid
        del self.in_flight[kid]
        self._release_slot(kid, ek)
        rec = CompletionRecord(task=ek.task, t_submit=ek.t_submit,
                               t_start=ek.t_start, t_end=self.now,
                               slices=ek.slices, freq=self.freq)
        if self.collect_records:
            self.records.append(rec)
        self.policy.on_complete(ek, rec)

    # -- fault injection ---------------------------------------------------------

    def _apply_fault(self, f) -> bool:
        """Vectorized transient_stall (the stall lands in the slot arrays,
        mirrored into the ExecKernel for any scalar reads); slice_retired
        and device_dead delegate to the reference implementation — kill()
        already releases slots and writes back client accumulators."""
        if f.kind != "transient_stall":
            return super()._apply_fault(f)
        self.fault_log.append((self.now, f))
        self._flush_etas()
        for ek in self.in_flight.values():
            slot = self._slot_of_kid[ek.task.kid]
            self._s_ov[slot] += f.duration
            ek.overhead_left = float(self._s_ov[slot])
            self._schedule_completion(ek)
        return False

    # -- frequency / migration plumbing (flush-before-push discipline) ----------

    def set_frequency(self, f: float):
        self._flush_etas()
        super().set_frequency(f)

    def schedule_release(self, cid: int, at: float):
        self._flush_etas()
        super().schedule_release(cid, at)

    def detach_client(self, cid: int):
        c = super().detach_client(cid)
        c._watch = None
        self._reindex_clients()       # positions shifted by list removal
        return c

    def admit_client(self, client, after: float):
        self._flush_etas()
        super().admit_client(client, after)
        client._watch = self
        self._pos[client.cid] = len(self.clients) - 1
        self._client_refresh(client)

    # -- main loop ---------------------------------------------------------------

    def start(self):
        """Seed tick/end events and build the merged arrival stream.

        The merge replicates the reference heap-counter order: per-client
        arrival blocks concatenated in client order (closed-loop t=0.0
        entry after the client's own list, as in the reference ``start``),
        then a stable sort by time — equal times keep push order, exactly
        the reference counter tie-break."""
        ts, cs = [], []
        for c in self.clients:
            a = c.arrivals()
            if a:
                ts.append(np.asarray(a, dtype=np.float64))
                cs.append(np.full(len(a), c.cid, dtype=np.int64))
            if c.closed_loop:
                ts.append(np.zeros(1))
                cs.append(np.full(1, c.cid, dtype=np.int64))
        if ts:
            t = np.concatenate(ts)
            cid = np.concatenate(cs)
            order = np.argsort(t, kind="stable")
            self._arr_t_list = t[order].tolist()
            self._arr_cid_list = cid[order].tolist()
        else:
            self._arr_t_list = []
            self._arr_cid_list = []
        self._arr_ptr = 0
        self._arr_n = len(self._arr_t_list)
        if self.policy.tick_interval > 0:
            self._push(self.policy.tick_interval, "tick", None)
        self._push(self.horizon, "end", None)
        # fault events after end, matching the reference push order: at
        # equal timestamps faults yield to stream arrivals (arrivals win
        # heap ties) and beat runtime-pushed ticks/completions (larger
        # counters) — identical ordering in both engines
        for f in self._fault_events:
            self._push(f.t, "fault", f)

    def peek_time(self) -> Optional[float]:
        if self.done:
            return None
        self._flush_etas()
        ht = self._heap[0][0] if self._heap else None
        at = (self._arr_t_list[self._arr_ptr]
              if self._arr_ptr < self._arr_n else None)
        if ht is None:
            return at
        if at is None:
            return ht
        return at if at <= ht else ht

    def step_event(self) -> bool:
        if self.done:
            return False
        heap = self._heap
        ai = self._arr_ptr
        # pick the next event: stream arrival vs heap top.  Arrivals win
        # every time tie — in the reference they were pushed first in
        # start(), so their counters are lower than any tick/end/runtime
        # push at the same timestamp.
        if ai < self._arr_n and (not heap
                                 or self._arr_t_list[ai] <= heap[0][0]):
            t = self._arr_t_list[ai]
            self._arr_ptr = ai + 1
            kind = "arrival"
            payload = (self._arr_cid_list[ai], 0)
        elif heap:
            t, _, kind, payload = heapq.heappop(heap)
        else:
            self.done = True
            return False
        self.events += 1
        if t > self.horizon and kind != "end":
            return True                     # post-horizon stragglers: skip
        self._advance(t)
        if kind == "end":
            # final write-back of in-flight kernels' client accumulators
            for ek in self.in_flight.values():
                slot = self._slot_of_kid[ek.task.kid]
                ek.client.slice_seconds = float(self._s_css[slot])
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
            slot = self._slot_of_kid[kid]
            if self._s_ov[slot] > 1e-12 or self._s_div[slot] > 1e-9:
                # stale estimate: refresh it unless it is below the clock's
                # resolution at this time (as the scalar engine does)
                if self.now + self._eta_scalar(slot) > self.now:
                    self._schedule_completion(ek)
                    return True
            self._complete(ek)
        elif kind == "fswitch":
            self.freq = payload
            self._pending_freq = None
            self._recompute_speeds()
            for ek in self.in_flight.values():
                self._schedule_completion(ek)
        elif kind == "tick":
            self.policy.on_tick(self.now)
            self._flush_etas()      # on_tick pushes precede the re-push
            self._push(self.now + self.policy.tick_interval, "tick", None)
        elif kind == "unhold":
            self.policy.release_hold(payload)
        elif kind == "fault":
            if self._apply_fault(payload):
                self.done = True        # device dead: event stream ends
                return False
        self._apply_allocations()
        self.policy.step(self.now)
        if self._startable:
            cb = self.client_by_id
            pos = self._pos
            for c in sorted((cb[cid] for cid in tuple(self._startable)
                             if cid in cb), key=lambda c: pos[c.cid]):
                c.start_next_job(self.now)
        self.policy.step(self.now)
        self._apply_allocations()
        if self._eta_pending:
            self._flush_etas()
        return True
