"""ctl — the online serving control plane (daemon + CLI + crash recovery).

Everything before this subsystem was a *batch* world: ``evaluate()`` builds
every tenant up front, runs the clock to a horizon, and returns.  ``ctl``
puts an always-on scheduler daemon in front of the same simulator/cluster
stack so jobs arrive, run, migrate, and finish while the clock advances:

* :mod:`repro_torch.ctl.state`  — the job state machine
  (``queued -> admitted -> running -> migrating -> done|preempted|failed``)
  with explicit, unit-testable transitions;
* :mod:`repro_torch.ctl.store`  — the append-only JSONL journal plus the
  file-spool IPC (submissions / cancels / drain) under a ``--state-dir``,
  so every transition is durable and the daemon recovers after ``kill -9``;
* :mod:`repro_torch.ctl.daemon` — the admission/progress loop draining the
  queue into a :class:`~repro_torch.core.node.NodeCoordinator` via the
  stepping API;
* :mod:`repro_torch.ctl.cli`    — ``submit / status / cancel / drain /
  daemon`` verbs (``python -m repro_torch.ctl ...``).
"""
from repro_torch.ctl.state import (InvalidTransition, Job, JobEvent,
                                   JobState, TERMINAL, TRANSITIONS,
                                   transition)
from repro_torch.ctl.store import (Journal, read_heartbeat, replay,
                                   request_cancel, request_drain,
                                   request_submit)
from repro_torch.ctl.daemon import ControlPlane, DaemonConfig

__all__ = [
    "InvalidTransition", "Job", "JobEvent", "JobState", "TERMINAL",
    "TRANSITIONS", "transition", "Journal", "replay", "request_submit",
    "request_cancel", "request_drain", "read_heartbeat", "ControlPlane",
    "DaemonConfig",
]
