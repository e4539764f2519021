"""Job state machine for the serving control plane.

States follow the OS-style lifecycle::

                       +-----------------------------------------+
                       v                                         | requeue
    (submit) --> QUEUED --admit--> ADMITTED --start--> RUNNING --+
       |            |                  |                |  ^  \\
       |            |cancel            |cancel          |  |   \\--finish--> DONE
       |            v                  |preempt  migrate|  |land
       +--fail--> FAILED/CANCELLED <---+                v  |
                       ^                            MIGRATING
                       |  cancel/preempt/fail           |
                       +--------------------------------+

``DONE`` / ``FAILED`` / ``CANCELLED`` are terminal (absorbing).
``PREEMPTED`` is *not* terminal: a preempted job (daemon drain, or a crash
discovered at recovery) re-enters the queue via ``requeue`` and runs again.
Every valid transition is a row in :data:`TRANSITIONS`; everything else
raises the typed :class:`InvalidTransition` — the exhaustiveness the tests
assert pair by pair.

The machine is pure data (no I/O): the journal (:mod:`repro_torch.ctl.store`)
persists each applied transition, and replaying the journal through
:func:`transition` rebuilds the job table bit-for-bit.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Optional


class JobState(str, Enum):
    QUEUED = "queued"           # durable, waiting for admission
    ADMITTED = "admitted"       # admission control accepted; tenant built
    RUNNING = "running"         # attached to a device simulator
    MIGRATING = "migrating"     # launch queue draining toward another device
    DONE = "done"               # finished its work window (terminal)
    PREEMPTED = "preempted"     # evicted (drain/crash); resumable
    FAILED = "failed"           # malformed spec / runtime error (terminal)
    CANCELLED = "cancelled"     # user cancel (terminal)


class JobEvent(str, Enum):
    ADMIT = "admit"             # admission control accepts the job
    START = "start"             # client admitted into a simulator
    MIGRATE = "migrate"         # coordinator began draining the client
    LAND = "land"               # migration landed (or drain aborted)
    FINISH = "finish"           # work window complete, client detached
    PREEMPT = "preempt"         # evicted with intent to resume
    FAIL = "fail"               # unrecoverable error
    CANCEL = "cancel"           # user asked for the job to stop
    REQUEUE = "requeue"         # recovery/resume: back to the queue


#: Every legal ``(state, event) -> state`` row.  Anything absent raises.
TRANSITIONS: dict[tuple[JobState, JobEvent], JobState] = {
    (JobState.QUEUED, JobEvent.ADMIT): JobState.ADMITTED,
    (JobState.QUEUED, JobEvent.CANCEL): JobState.CANCELLED,
    (JobState.QUEUED, JobEvent.FAIL): JobState.FAILED,

    (JobState.ADMITTED, JobEvent.START): JobState.RUNNING,
    (JobState.ADMITTED, JobEvent.CANCEL): JobState.CANCELLED,
    (JobState.ADMITTED, JobEvent.PREEMPT): JobState.PREEMPTED,
    (JobState.ADMITTED, JobEvent.FAIL): JobState.FAILED,
    (JobState.ADMITTED, JobEvent.REQUEUE): JobState.QUEUED,

    (JobState.RUNNING, JobEvent.MIGRATE): JobState.MIGRATING,
    (JobState.RUNNING, JobEvent.FINISH): JobState.DONE,
    (JobState.RUNNING, JobEvent.CANCEL): JobState.CANCELLED,
    (JobState.RUNNING, JobEvent.PREEMPT): JobState.PREEMPTED,
    (JobState.RUNNING, JobEvent.FAIL): JobState.FAILED,
    (JobState.RUNNING, JobEvent.REQUEUE): JobState.QUEUED,

    (JobState.MIGRATING, JobEvent.LAND): JobState.RUNNING,
    (JobState.MIGRATING, JobEvent.FINISH): JobState.DONE,
    (JobState.MIGRATING, JobEvent.CANCEL): JobState.CANCELLED,
    (JobState.MIGRATING, JobEvent.PREEMPT): JobState.PREEMPTED,
    (JobState.MIGRATING, JobEvent.FAIL): JobState.FAILED,
    (JobState.MIGRATING, JobEvent.REQUEUE): JobState.QUEUED,

    (JobState.PREEMPTED, JobEvent.REQUEUE): JobState.QUEUED,
    (JobState.PREEMPTED, JobEvent.CANCEL): JobState.CANCELLED,
}

#: Absorbing states: no outgoing transitions, recovery leaves them alone.
TERMINAL = frozenset({JobState.DONE, JobState.FAILED, JobState.CANCELLED})


class InvalidTransition(Exception):
    """Raised for any (state, event) pair not in :data:`TRANSITIONS`."""

    def __init__(self, state: JobState, event: JobEvent):
        self.state = state
        self.event = event
        super().__init__(f"no transition for event {event.value!r} "
                         f"in state {state.value!r}")


def transition(state: JobState, event: JobEvent) -> JobState:
    """The next state, or raise :class:`InvalidTransition`."""
    try:
        return TRANSITIONS[(state, event)]
    except KeyError:
        raise InvalidTransition(state, event) from None


@dataclass
class Job:
    """Control-plane record of one submitted job.

    ``spec`` is the submission payload (workload description; see
    :func:`repro_torch.ctl.daemon.app_from_spec`).  Data-plane bindings
    (``cid``, ``device``) are scoped to one daemon incarnation — a crash
    invalidates them and recovery re-admits the job with fresh ones."""

    job_id: str
    spec: dict
    state: JobState = JobState.QUEUED
    submitted_wall: float = field(default_factory=time.time)
    updated_wall: float = field(default_factory=time.time)
    # data-plane bindings (valid for the current daemon incarnation only)
    cid: Optional[int] = None
    device: Optional[int] = None
    granted_slices: int = 0
    admitted_sim: Optional[float] = None    # sim clock at START
    ends_sim: Optional[float] = None        # sim clock of the work window end
    # bookkeeping
    recoveries: int = 0                     # times re-queued by recovery
    migrations: int = 0
    error: str = ""
    result: dict = field(default_factory=dict)  # metrics stamped at FINISH

    def apply(self, event: JobEvent, wall: Optional[float] = None) -> JobState:
        """Apply one event through the state machine (raises
        :class:`InvalidTransition` on an illegal pair)."""
        self.state = transition(self.state, event)
        self.updated_wall = time.time() if wall is None else wall
        if event is JobEvent.REQUEUE:
            self.recoveries += 1
            self.cid = self.device = None
            self.granted_slices = 0
            self.admitted_sim = self.ends_sim = None
        if event is JobEvent.MIGRATE:
            self.migrations += 1
        return self.state

    @property
    def terminal(self) -> bool:
        return self.state in TERMINAL

    def public(self) -> dict:
        """The ``status`` view of this job (JSON-safe)."""
        return {
            "job_id": self.job_id,
            "name": self.spec.get("name", self.job_id),
            "state": self.state.value,
            "kind": self.spec.get("kind", "?"),
            "priority": self.spec.get("priority", "be"),
            "quota": self.spec.get("quota_slices", 0),
            "granted": self.granted_slices,
            "device": self.device,
            "cid": self.cid,
            "submitted_wall": self.submitted_wall,
            "updated_wall": self.updated_wall,
            "recoveries": self.recoveries,
            "migrations": self.migrations,
            "error": self.error,
            "result": self.result,
        }
