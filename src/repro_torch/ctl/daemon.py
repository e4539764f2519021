"""The always-on scheduler daemon: live admissions into the stepping API.

The batch world (``evaluate*``) builds every tenant before the clock
starts.  The daemon inverts that: it owns a :class:`NodeCoordinator` over
an (initially empty) multi-device node and *drives it event by event*
through the stepping API (``start / peek_time / step_event``), so jobs are
admitted, preempted, migrated and finished **while the clock advances**:

* **submit** (spool) -> journal ``SUBMIT`` -> ``QUEUED``;
* **admission control** reserves quota headroom on a device, then attaches
  the tenant live: grant pool slices (``SliceMap.assign_owner``), warm the
  policy (``import_client_state``), hand the simulator the client with its
  arrival stream re-based to the current sim clock (``admit_client``), and
  kick dispatch via the migration plumbing's ``hold``/``schedule_release``
  pair — ``QUEUED -> ADMITTED -> RUNNING``;
* **progress** is bounded stepping: the daemon only steps events up to the
  earliest active-job milestone, so simulated time never runs ahead of the
  control plane's decisions (and freezes entirely when the node is idle);
* **migration**: the coordinator's own lending protocol keeps working —
  the daemon observes ``_pending``/``migration_log`` and journals
  ``RUNNING -> MIGRATING -> RUNNING``;
* **finish/cancel/preempt** tear down through the drain half-protocol
  (hold -> drained -> disown granted slices -> export -> detach), then
  journal the terminal transition.

Every transition is journaled *before* the daemon acts on it (WAL), so
``kill -9`` at any instant is recoverable: on restart the journal replays,
non-terminal jobs are re-queued (``REQUEUE``) and re-admitted with fresh
data-plane bindings — no job lost, none duplicated.  Simulator state is
deliberately *not* checkpointed: the control plane is durable, the data
plane restarts (the job re-runs its remaining window), exactly the
contract an OS-level GPU control plane can honor.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.core.node import build_node
from repro_torch.core.queues import Client
from repro_torch.core.types import (DeviceSpec, FaultPlan, NodeConfig,
                                    NodeSpec, Priority, Quota)
from repro_torch.core.workloads import AppSpec
from repro_torch.ctl import store
from repro_torch.ctl.state import Job, JobEvent, JobState
from repro_torch.ctl.store import Journal, replay

_INF = float("inf")


class JobSpecError(ValueError):
    """Submission payload that can never be admitted (``FAILED``)."""


DEVICE_PROFILES = {
    "a100": DeviceSpec.a100_like,
    "l4": DeviceSpec.l4_like,
    "h100": DeviceSpec.h100_like,
}


@dataclass(frozen=True)
class DaemonConfig:
    n_devices: int = 2
    device: str = "h100"            # DEVICE_PROFILES key
    n_slices: int = 0               # override slices per device (0 = profile)
    system: str = "lithos"
    engine: Optional[str] = None    # None -> core.lithos.default_engine
    horizon: float = 1e9            # sim end event; never reached in practice
    seed: int = 0
    poll_interval: float = 0.02     # idle wall sleep between ticks
    max_steps_per_tick: int = 512   # stepping budget per tick (stays live)
    admit_cost: float = 0.0         # dispatch blackout charged at admission
    migration: bool = True          # node-level lending protocol on?
    epoch: float = 0.25             # pressure-sampling period
    validate: bool = False          # cross-device conservation checks
    heartbeat_interval: float = 0.2
    fault_plan: Optional[FaultPlan] = None  # injected device/slice failures
    compact_threshold_bytes: int = 512 * 1024   # journal size trigger (0=off)

    def node(self) -> NodeSpec:
        if self.device not in DEVICE_PROFILES:
            raise ValueError(f"unknown device profile {self.device!r} "
                             f"(choose from {sorted(DEVICE_PROFILES)})")
        dev = DEVICE_PROFILES[self.device]()
        if self.n_slices > 0:
            dev = dataclasses.replace(dev, n_slices=self.n_slices)
        return NodeSpec.uniform(self.n_devices, dev)


def app_from_spec(spec: dict, *, fallback_name: str) -> tuple[AppSpec, float]:
    """Submission payload -> (tenant AppSpec, work-window duration).

    ``kind == "serve"`` is the SlotServer client (``launch/serve.py
    --submit``): it becomes an open-loop ``llm_infer`` tenant carrying its
    SLO class and quota — the serving engine's request stream expressed in
    the simulator's workload vocabulary."""
    from repro_torch.configs.registry import ARCH_IDS, get_config

    kind = spec.get("kind", "train")
    sim_kind = {"serve": "llm_infer"}.get(kind, kind)
    if sim_kind not in ("train", "llm_infer", "fwd_infer"):
        raise JobSpecError(f"unknown job kind {kind!r}")
    arch = spec.get("arch", "olmo-1b")
    if arch not in ARCH_IDS:
        raise JobSpecError(f"unknown arch {arch!r}")
    cfg = get_config(arch)
    if spec.get("reduced", True):
        cfg = cfg.reduced()
    prio = str(spec.get("priority", "be")).lower()
    if prio in ("high", "hp"):
        priority = Priority.HIGH
    elif prio in ("be", "best_effort", "low"):
        priority = Priority.BEST_EFFORT
    else:
        raise JobSpecError(f"unknown priority {prio!r}")
    duration = float(spec.get("duration", 5.0))
    if not duration > 0:
        raise JobSpecError(f"duration must be > 0, got {duration}")
    quota = int(spec.get("quota_slices", 0))
    if quota < 0:
        raise JobSpecError(f"quota_slices must be >= 0, got {quota}")
    rps = float(spec.get("rps", 0.0))
    if sim_kind != "train" and rps <= 0:
        raise JobSpecError(f"open-loop kind {kind!r} needs rps > 0")
    kw = {}
    if "prompt_mix" in spec:
        kw["prompt_mix"] = tuple((int(l), float(w))
                                 for l, w in spec["prompt_mix"])
    app = AppSpec(
        name=spec.get("name", fallback_name), cfg=cfg, kind=sim_kind,
        priority=priority, quota_slices=quota,
        rps=rps if sim_kind != "train" else 0.0,
        slo_latency=float(spec.get("slo_latency", 0.0)),
        batch=int(spec.get("batch", 1)),
        decode_tokens=int(spec.get("decode_tokens", 16)),
        train_batch=int(spec.get("train_batch", 2)),
        train_seq=int(spec.get("train_seq", 256)),
        fusion=int(spec.get("fusion", 6)),
        seed=int(spec.get("seed", 0)), **kw)
    return app, duration


@dataclass
class _Runtime:
    """Data-plane bindings of one live job (one daemon incarnation)."""

    job: Job
    cid: int
    want_quota: int
    t0: float                       # sim clock at admission
    t_end: float                    # t0 + duration
    last_arrival: float             # sim time of the final seeded arrival
    closed_loop: bool
    granted: list[int] = field(default_factory=list)   # sids, home device
    teardown: Optional[JobEvent] = None     # FINISH/CANCEL/PREEMPT pending
    result: dict = field(default_factory=dict)

    @property
    def milestone(self) -> float:
        """Sim time up to which this job still wants the clock to advance
        (the stepping bound).  Draining jobs and open-loop tails are
        unbounded — their remaining events are finite."""
        if self.teardown is not None or not self.closed_loop:
            return _INF
        return self.t_end


class ControlPlane:
    """One daemon incarnation: journal + job table + live node."""

    def __init__(self, state_dir: str, config: Optional[DaemonConfig] = None):
        from repro_torch.core.lithos import default_engine

        self.state_dir = state_dir
        self.cfg = config or DaemonConfig()
        self.journal = Journal(state_dir)
        self.jobs: dict[str, Job] = replay(state_dir)
        self.node = self.cfg.node()
        engine = self.cfg.engine or default_engine()
        self.coord = build_node(
            self.cfg.system, self.node, [], [], horizon=self.cfg.horizon,
            seed=self.cfg.seed, engine=engine,
            node_config=NodeConfig(migration=self.cfg.migration,
                                   epoch=self.cfg.epoch,
                                   validate=self.cfg.validate),
            faults=self.cfg.fault_plan)
        # the daemon owns fault handling: jobs on a dead device take the
        # journaled PREEMPT -> REQUEUE path and re-admit onto surviving
        # capacity, instead of the coordinator's in-sim evacuation
        self.coord.auto_evacuate = False
        self._dead: set[int] = set()
        self.coord.start()
        self._rt: dict[str, _Runtime] = {}
        self._by_cid: dict[int, str] = {}
        self._reserved: list[dict[str, int]] = [
            {} for _ in range(self.node.n_devices)]   # device -> job -> want
        self._mig_seen = 0
        self._draining = False
        self._stop = False
        self._last_hb = 0.0
        self.started_wall = time.time()
        # fresh incarnation: old data-plane bindings are void
        self.next_cid = 1 + max((j.cid for j in self.jobs.values()
                                 if j.cid is not None), default=-1)
        self._recover()
        store.clear_drain(state_dir)
        # announce liveness before any admission can hit the journal —
        # `status` must never see RUNNING jobs with no heartbeat on disk
        self._heartbeat(force=True)

    # -- recovery ------------------------------------------------------------

    def _recover(self):
        """Re-queue every job the previous incarnation left non-terminal.
        QUEUED jobs are already where they belong; ADMITTED/RUNNING/
        MIGRATING lost their simulator with the crash, PREEMPTED is the
        graceful-drain parking state — all four resume via REQUEUE."""
        for job in sorted(self.jobs.values(), key=lambda j: j.submitted_wall):
            if job.state in (JobState.ADMITTED, JobState.RUNNING,
                             JobState.MIGRATING, JobState.PREEMPTED):
                self._event(job, JobEvent.REQUEUE)

    # -- journal-backed transitions ------------------------------------------

    def _event(self, job: Job, ev: JobEvent, **extra):
        """WAL discipline: validate, journal durably, then mutate."""
        from repro_torch.ctl.state import transition
        to = transition(job.state, ev)          # raises on an illegal pair
        self.journal.append(job.job_id, ev.value, to=to.value, **extra)
        job.apply(ev)
        for k in ("cid", "device", "admitted_sim", "ends_sim"):
            if k in extra:
                setattr(job, k, extra[k])
        if "granted" in extra:
            job.granted_slices = extra["granted"]
        if "error" in extra:
            job.error = extra["error"]
        if "result" in extra:
            job.result = extra["result"]

    # -- clock ---------------------------------------------------------------

    def sim_now(self) -> float:
        return max(s.now for s in self.coord.sims)

    # -- inbox ---------------------------------------------------------------

    def _ingest(self):
        submits, cancels, drain, rejected = store.scan_inbox(self.state_dir)
        for r in rejected:
            # the file is already quarantined in inbox/rejected/; if the
            # filename still identifies a submit's job id, record the loss
            # so the submitter sees FAILED instead of a job that vanished
            jid = r.get("job_id")
            if jid and r["kind"] == "submit" and jid not in self.jobs:
                self.journal.append(jid, store.SUBMIT, spec={},
                                    to=JobState.QUEUED.value)
                job = Job(job_id=jid, spec={})
                self.jobs[jid] = job
                self._event(job, JobEvent.FAIL,
                            error=f"rejected spool file: {r['reason']}")
        for s in submits:
            jid = s["job_id"]
            if jid not in self.jobs:        # crash between journal+unlink:
                self.journal.append(jid, store.SUBMIT, spec=s["spec"],
                                    to=JobState.QUEUED.value)
                self.jobs[jid] = Job(job_id=jid, spec=s["spec"])
            store.consume(s)
        for c in cancels:
            job = self.jobs.get(c["job_id"])
            if job is None:
                continue                    # not ingested yet: retry later
            if not job.terminal:
                self._cancel(job)
            store.consume(c)
        if drain and not self._draining:
            self._draining = True
            for job in list(self.jobs.values()):
                rt = self._rt.get(job.job_id)
                if rt is not None and rt.teardown is None:
                    self._begin_teardown(rt, JobEvent.PREEMPT)
                elif job.state == JobState.ADMITTED and rt is None:
                    self._event(job, JobEvent.PREEMPT)

    def _cancel(self, job: Job):
        rt = self._rt.get(job.job_id)
        if rt is None:
            # not attached: pure control-plane transition
            self._event(job, JobEvent.CANCEL)
            self._unreserve(job.job_id)
        elif rt.teardown is None:
            self._begin_teardown(rt, JobEvent.CANCEL)

    # -- admission -----------------------------------------------------------

    def _headroom(self, d: int) -> int:
        return (self.node.devices[d].n_slices
                - getattr(self.coord.sims[d], "n_retired", 0)
                - sum(self._reserved[d].values()))

    def _pick_device(self, want: int) -> Optional[int]:
        fits = [d for d in range(self.node.n_devices)
                if d not in self._dead and self._headroom(d) >= want]
        if not fits:
            return None
        # fewest live jobs first, then most headroom — deterministic
        return min(fits, key=lambda d: (len(self._reserved[d]),
                                        -self._headroom(d), d))

    def _unreserve(self, job_id: str):
        for res in self._reserved:
            res.pop(job_id, None)

    def _admit_queued(self):
        if self._draining:
            return
        queued = [j for j in self.jobs.values()
                  if j.state == JobState.QUEUED]
        for job in sorted(queued, key=lambda j: (j.submitted_wall, j.job_id)):
            try:
                app, duration = app_from_spec(job.spec,
                                              fallback_name=job.job_id)
            except JobSpecError as e:
                self._event(job, JobEvent.FAIL, error=str(e))
                continue
            if app.kind == "train" and not getattr(
                    self.coord.policies[0], "supports_migration", False):
                # closed-loop tenants never drain on their own; without the
                # hold/drain half-protocol the daemon could not stop them
                self._event(job, JobEvent.FAIL,
                            error=f"system {self.cfg.system!r} cannot "
                                  "preempt closed-loop (train) jobs")
                continue
            want = min(app.quota_slices,
                       max(d.n_slices for d in self.node.devices))
            if want < app.quota_slices and job.spec.get("strict_quota"):
                self._event(job, JobEvent.FAIL,
                            error=f"quota {app.quota_slices} exceeds every "
                                  f"device ({want} max)")
                continue
            d = self._pick_device(want)
            if d is None:
                continue                    # wait for headroom
            cid = self.next_cid
            self.next_cid += 1
            self._reserved[d][job.job_id] = want
            self._event(job, JobEvent.ADMIT, cid=cid, device=d)
            self._attach(job, app, duration, cid, d, want)

    def _attach(self, job: Job, app: AppSpec, duration: float, cid: int,
                d: int, want: int):
        sim = self.coord.sims[d]
        policy = self.coord.policies[d]
        t0 = self.sim_now()
        granted = self._grant(policy, cid, want)
        policy.import_client_state(cid, app.priority,
                                   {"quota": Quota(len(granted),
                                                   app.priority)})
        client = Client(cid, app, horizon=duration, seed=self.cfg.seed)
        client._arrivals = [t0 + a for a in client._arrivals]
        last_arrival = client._arrivals[-1] if client._arrivals else -_INF
        policy.hold_client(cid)
        sim.admit_client(client, after=t0)
        sim.schedule_release(cid, t0 + self.cfg.admit_cost)
        self.coord.ledger.adopt(cid, d)
        self.coord._dirty_deep(d)
        rt = _Runtime(job=job, cid=cid, want_quota=want, t0=t0,
                      t_end=t0 + duration, last_arrival=last_arrival,
                      closed_loop=client.closed_loop, granted=granted)
        self._rt[job.job_id] = rt
        self._by_cid[cid] = job.job_id
        self._event(job, JobEvent.START, granted=len(granted),
                    admitted_sim=t0, ends_sim=rt.t_end)

    def _grant(self, policy, cid: int, want: int) -> list[int]:
        sm = getattr(policy, "slices", None)
        if sm is None or want <= 0:
            return []
        sids = sm.idle_pool()[:want]
        for sid in sids:
            sm.assign_owner(sid, cid)
        return list(sids)

    def _topup(self, rt: _Runtime):
        """Admission reserved the full quota; the instant of the grant may
        have found part of the pool held by in-flight kernels.  Top the
        grant up as pool slices free."""
        if rt.teardown is not None or len(rt.granted) >= rt.want_quota:
            return
        job = rt.job
        d = self.coord.ledger.current.get(rt.cid, job.device)
        policy = self.coord.policies[d]
        more = self._grant(policy, rt.cid,
                           rt.want_quota - len(rt.granted))
        if more:
            rt.granted += more
            quotas = getattr(policy, "quotas", None)
            q = quotas.get(rt.cid) if quotas is not None else None
            if q is not None:
                quotas[rt.cid] = Quota(len(rt.granted), q.priority)
            job.granted_slices = len(rt.granted)

    # -- stepping ------------------------------------------------------------

    def _bound(self) -> float:
        if not self._rt:
            return -_INF
        return min(rt.milestone for rt in self._rt.values())

    def _step(self) -> int:
        # never step the end-of-horizon sentinel events: with an unbounded
        # milestone (open-loop tails, teardown drains) they would yank the
        # clock to ``horizon`` and the coordinator's epoch catch-up loop
        # would grind through billions of empty epochs
        bound = min(self._bound(), self.cfg.horizon * (1 - 1e-9))
        steps = 0
        while steps < self.cfg.max_steps_per_tick:
            t = self.coord.peek_time()
            if t is None or t > bound:
                break
            if not self.coord.step_event():
                break
            steps += 1
        return steps

    # -- migration observation ----------------------------------------------

    def _observe_migrations(self):
        log = self.coord.migration_log
        while self._mig_seen < len(log):
            _, cid, _, dst = log[self._mig_seen]
            self._mig_seen += 1
            jid = self._by_cid.get(cid)
            job = self.jobs.get(jid) if jid else None
            if job is None:
                continue
            if job.state == JobState.RUNNING:    # missed the pending window
                self._event(job, JobEvent.MIGRATE)
            if job.state == JobState.MIGRATING:
                self._event(job, JobEvent.LAND, device=dst)
        pending = self.coord._pending
        if pending is not None:
            jid = self._by_cid.get(pending.cid)
            job = self.jobs.get(jid) if jid else None
            if job is not None and job.state == JobState.RUNNING:
                self._event(job, JobEvent.MIGRATE)
        for jid, rt in self._rt.items():
            job = rt.job
            if job.state == JobState.MIGRATING and (
                    pending is None or pending.cid != rt.cid):
                # drain aborted (e.g. horizon/dead) — land back in place
                self._event(job, JobEvent.LAND, device=job.device)

    # -- fault observation ---------------------------------------------------

    def _observe_faults(self):
        """Map device loss onto the job state machine: every job bound to a
        newly failed device is detached from the dead data plane, journaled
        ``PREEMPT`` (with a fault record naming the device) then
        ``REQUEUE``, and re-admitted onto surviving capacity by the normal
        admission pass — never silently lost.  A cancel already in flight
        wins over the requeue."""
        for d in sorted(self.coord.failed_members - self._dead):
            self._dead.add(d)
            lost = sorted(
                jid for jid, rt in self._rt.items()
                if self.coord.ledger.current.get(rt.cid, rt.job.device) == d)
            # standalone fault record: replay/compact pass it through (its
            # job id never matches a real job), so the loss stays on the
            # permanent record even after the jobs finish elsewhere
            self.journal.append(f"device-{d}", "fault", device=d,
                                sim_now=self.sim_now(), jobs=lost)
            for jid in lost:
                rt = self._rt.pop(jid)
                job, cid = rt.job, rt.cid
                sim = self.coord.sims[d]
                # the device's own scheduler already killed its in-flight
                # work (Policy.on_fault); here we retire the control-plane
                # bindings.  Ownership may be spread across devices after a
                # migration, so sweep every live slice map.
                for p in self.coord.policies:
                    sm = getattr(p, "slices", None)
                    if sm is None:
                        continue
                    for sid in rt.granted:
                        if (sid < sm.n_slices and sm.owner[sid] == cid
                                and sm.holder[sid] is None):
                            sm.disown(sid)
                policy = self.coord.policies[d]
                if cid in getattr(policy, "quotas", ()):
                    policy.export_client_state(cid)     # discard: dead plane
                sim.detach_client(cid)
                self.coord.ledger.drop(cid, sim.now)
                self.coord._dirty_deep(d)
                self.coord.frozen.discard(cid)
                self._by_cid.pop(cid, None)
                self._unreserve(jid)
                if rt.teardown == JobEvent.CANCEL:
                    self._event(job, JobEvent.CANCEL,
                                fault={"device": d, "sim_now": sim.now})
                    continue
                self._event(job, JobEvent.PREEMPT,
                            fault={"device": d, "sim_now": sim.now})
                self._event(job, JobEvent.REQUEUE)

    # -- teardown / reaping --------------------------------------------------

    def _begin_teardown(self, rt: _Runtime, reason: JobEvent):
        rt.teardown = reason
        self.coord.frozen.add(rt.cid)       # keep the lender's hands off
        d = self.coord.ledger.current.get(rt.cid, rt.job.device)
        self.coord.policies[d].hold_client(rt.cid)

    def _reap(self):
        for jid, rt in list(self._rt.items()):
            job = rt.job
            if job.state == JobState.MIGRATING:
                continue                    # finish the move first
            d = self.coord.ledger.current.get(rt.cid, job.device)
            sim = self.coord.sims[d]
            policy = self.coord.policies[d]
            if rt.teardown is None and self._window_over(rt, sim):
                self._begin_teardown(rt, JobEvent.FINISH)
            if rt.teardown is None:
                self._topup(rt)
                continue
            if not policy.client_drained(rt.cid):
                continue
            sm = getattr(policy, "slices", None)
            if sm is not None and any(sm.holder[s] is not None
                                      for s in rt.granted):
                continue                    # a thief still holds a grant
            self._detach(rt, d, sim, policy, sm)

    def _window_over(self, rt: _Runtime, sim) -> bool:
        """Nothing left inside this job's work window: for closed loops the
        clock (or the next event) passed ``t_end``; for open loops every
        seeded arrival fired and the launch queue drained."""
        peek = sim.peek_time()
        if rt.closed_loop:
            return sim.now >= rt.t_end or peek is None or peek > rt.t_end
        arrivals_done = (sim.now >= rt.last_arrival or peek is None
                         or peek > rt.last_arrival)
        c = sim.client_by_id.get(rt.cid)
        drained = (c is not None and c.outstanding == 0
                   and c.current is None and not c.pending)
        return arrivals_done and drained and sim.now >= rt.t0

    def _detach(self, rt: _Runtime, d: int, sim, policy, sm):
        cid, job = rt.cid, rt.job
        for sid in rt.granted:
            sm.disown(sid)
        policy.export_client_state(cid)     # discard: the job is over
        client = sim.detach_client(cid)
        self.coord.ledger.drop(cid, sim.now)
        self.coord._dirty_deep(d)
        self.coord.frozen.discard(cid)
        self._rt.pop(job.job_id)
        self._by_cid.pop(cid, None)
        self._unreserve(job.job_id)
        lats = client.latencies()
        result = {
            "n_completed": len(client.completed),
            "sim_seconds": round(sim.now - rt.t0, 6),
            "slice_seconds": round(client.slice_seconds, 6),
            "p50_ms": round(1e3 * float(np.median(lats)), 3) if lats else None,
            "p95_ms": (round(1e3 * float(np.percentile(lats, 95)), 3)
                       if lats else None),
        }
        rt.result = result
        self._event(job, rt.teardown, result=result)

    # -- heartbeat / status --------------------------------------------------

    def _heartbeat(self, force: bool = False):
        now = time.time()
        if not force and now - self._last_hb < self.cfg.heartbeat_interval:
            return
        self._last_hb = now
        counts: dict[str, int] = {}
        for j in self.jobs.values():
            counts[j.state.value] = counts.get(j.state.value, 0) + 1
        store.write_heartbeat(self.state_dir, {
            "sim_now": self.sim_now(),
            "events": sum(s.events for s in self.coord.sims),
            "jobs": counts,
            "live": len(self._rt),
            "draining": self._draining,
            "started_wall": self.started_wall,
            "migrations": self.coord.ledger.n_migrations,
        })

    # -- main loop -----------------------------------------------------------

    def tick(self) -> int:
        """One control-plane iteration; returns events stepped (progress
        indicator for the caller's sleep decision)."""
        self._ingest()
        self._admit_queued()
        stepped = self._step()
        self._observe_migrations()
        self._observe_faults()
        self._reap()
        self._heartbeat()
        self._maybe_compact()
        return stepped

    def _maybe_compact(self):
        """Bound journal growth: when the file crosses the size threshold,
        collapse terminal jobs' histories to snapshots (atomic rewrite) and
        reopen the journal at the renumbered tail."""
        if self.cfg.compact_threshold_bytes <= 0:
            return
        try:
            size = os.path.getsize(self.journal.path)
        except OSError:
            return
        if size < self.cfg.compact_threshold_bytes:
            return
        self.journal.close()
        store.compact(self.state_dir)
        self.journal = Journal(self.state_dir)

    def idle(self) -> bool:
        """True when there is nothing to do but wait for the spool."""
        return not self._rt and not any(
            j.state == JobState.QUEUED for j in self.jobs.values())

    def stop(self):
        self._stop = True

    def install_signal_handlers(self):
        signal.signal(signal.SIGTERM, lambda *_: self.stop())
        signal.signal(signal.SIGINT, lambda *_: self.stop())

    def run(self, max_wall: Optional[float] = None,
            exit_when_idle: bool = False):
        t0 = time.time()
        try:
            while not self._stop:
                stepped = self.tick()
                if self._draining and not self._rt:
                    break                   # drained: graceful exit
                if max_wall is not None and time.time() - t0 > max_wall:
                    break
                if exit_when_idle and self.idle():
                    submits, cancels, _, _ = store.scan_inbox(self.state_dir)
                    if not submits and not cancels:
                        break
                if stepped == 0:
                    time.sleep(self.cfg.poll_interval)
        finally:
            self.shutdown()

    def shutdown(self):
        """Graceful exit: park still-live jobs as PREEMPTED (resumable on
        the next incarnation); queued jobs just stay queued."""
        for jid, rt in list(self._rt.items()):
            job = rt.job
            if job.state == JobState.MIGRATING:
                self._event(job, JobEvent.PREEMPT)
            elif job.state in (JobState.RUNNING, JobState.ADMITTED):
                self._event(job, JobEvent.PREEMPT)
        self._rt.clear()
        self._by_cid.clear()
        self._heartbeat(force=True)
        self.journal.close()
