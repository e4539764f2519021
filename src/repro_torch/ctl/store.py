"""Durable store + file-spool IPC for the control plane.

Everything lives under one ``--state-dir``::

    state-dir/
      journal.jsonl     append-only transition journal (the truth)
      heartbeat.json    daemon liveness (pid, sim clock, counts)
      inbox/            CLI -> daemon spool (submit / cancel / drain files)

**Journal.**  Every state-machine transition is one JSON line, appended,
flushed and fsynced before the daemon acts on it — write-ahead logging, so
a ``kill -9`` at any instant loses at most work the control plane had not
yet acknowledged.  :func:`replay` folds the journal back through
:func:`repro_torch.ctl.state.transition` to rebuild the job table; a torn final
line (crash mid-write) is detected and ignored.

**Spool.**  CLI verbs never talk to the daemon directly: ``submit`` writes
``<t_ns>-<job>.submit.json`` into ``inbox/`` via the atomic
write-to-temp-then-rename idiom, ``cancel`` writes a ``.cancel.json``
marker, ``drain`` a flag file.  The daemon ingests inbox files in filename
order (the nanosecond prefix makes that arrival order), journals the
resulting transition, then unlinks the file — so a crash between journal
and unlink re-ingests an already-known job id, which ingestion detects and
drops (no duplication).  ``status`` needs no IPC at all: it replays the
journal read-only.
"""
from __future__ import annotations

import json
import os
import time
import uuid
from typing import Optional

from repro_torch.ctl.state import (TERMINAL, InvalidTransition, Job, JobEvent,
                             JobState)

JOURNAL = "journal.jsonl"
HEARTBEAT = "heartbeat.json"
INBOX = "inbox"
REJECTED = "rejected"           # inbox/rejected/ — quarantined spool files
DRAIN_FLAG = "drain.flag"

#: journal record kind for job creation (not a state-machine event: it
#: creates the QUEUED job the machine then evolves)
SUBMIT = "submit"


def _ensure_dirs(state_dir: str) -> str:
    os.makedirs(os.path.join(state_dir, INBOX), exist_ok=True)
    return state_dir


def _atomic_write(path: str, payload: dict):
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:6]}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# ---------------------------------------------------------------------------
# Journal
# ---------------------------------------------------------------------------

class Journal:
    """Append-only JSONL transition journal (the daemon's write side)."""

    def __init__(self, state_dir: str):
        _ensure_dirs(state_dir)
        self.path = os.path.join(state_dir, JOURNAL)
        self._f = open(self.path, "a")
        self.seq = _last_seq(self.path) + 1

    def append(self, job_id: str, kind: str, **extra) -> dict:
        """Durably append one record; returns it.  ``kind`` is either
        :data:`SUBMIT` or a :class:`JobEvent` value."""
        rec = {"seq": self.seq, "wall": time.time(), "job": job_id,
               "event": kind, **extra}
        self.seq += 1
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())
        return rec

    def close(self):
        self._f.close()


def _read_records(path: str) -> list[dict]:
    """All intact journal records; a torn trailing line is dropped."""
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except json.JSONDecodeError:
                break                   # torn tail from a crash mid-write
    return out


def _last_seq(path: str) -> int:
    recs = _read_records(path)
    return recs[-1]["seq"] if recs else -1


def replay(state_dir: str) -> dict[str, Job]:
    """Rebuild the job table by folding the journal through the state
    machine.  Pure read — ``status`` uses this with no daemon running."""
    jobs: dict[str, Job] = {}
    for rec in _read_records(os.path.join(state_dir, JOURNAL)):
        jid = rec["job"]
        if rec["event"] == SUBMIT:
            if jid in jobs:             # crash between journal and unlink
                continue
            jobs[jid] = Job(job_id=jid, spec=rec.get("spec", {}),
                            submitted_wall=rec["wall"])
            jobs[jid].updated_wall = rec["wall"]
            if "state" in rec:          # compacted snapshot record
                job = jobs[jid]
                try:
                    job.state = JobState(rec["state"])
                except ValueError:
                    pass                # defensive: never brick recovery
                job.recoveries = int(rec.get("recoveries", 0))
                job.migrations = int(rec.get("migrations", 0))
                job.updated_wall = rec.get("updated", rec["wall"])
                for k in ("cid", "device", "granted",
                          "admitted_sim", "ends_sim"):
                    if k in rec:
                        setattr(job, {"granted": "granted_slices"}.get(k, k),
                                rec[k])
                if "error" in rec:
                    job.error = rec["error"]
                if "result" in rec:
                    job.result = rec["result"]
            continue
        job = jobs.get(jid)
        if job is None:
            continue                    # journal truncated before SUBMIT
        try:
            job.apply(JobEvent(rec["event"]), wall=rec["wall"])
        except (ValueError, InvalidTransition):
            continue                    # defensive: never brick recovery
        # fold in the transition's data-plane payload
        for k in ("cid", "device", "granted", "admitted_sim", "ends_sim"):
            if k in rec:
                setattr(job, {"granted": "granted_slices"}.get(k, k), rec[k])
        if "error" in rec:
            job.error = rec["error"]
        if "result" in rec:
            job.result = rec["result"]
    return jobs


def compact(state_dir: str) -> int:
    """Bound journal growth: collapse every *terminal* job's history to one
    snapshot record while keeping live jobs' full histories verbatim.

    The snapshot is a SUBMIT record carrying the job's final folded state
    (``state``/``recoveries``/``migrations``/payload fields, marked
    ``compacted``), placed where the job's *last* record was so relative
    ordering against live jobs and non-job records (e.g. fault records) is
    preserved.  Replaying the compacted journal yields the same job table
    as replaying the original.  The rewrite is atomic (tmp + fsync +
    rename); callers must not hold the journal open across the call.
    Returns the number of records dropped."""
    path = os.path.join(state_dir, JOURNAL)
    recs = _read_records(path)
    if not recs:
        return 0
    jobs = replay(state_dir)
    terminal = {jid for jid, j in jobs.items() if j.state in TERMINAL}
    last_idx: dict[str, int] = {}
    for i, rec in enumerate(recs):
        if rec["job"] in terminal:
            last_idx[rec["job"]] = i
    out: list[dict] = []
    for i, rec in enumerate(recs):
        jid = rec["job"]
        if jid not in terminal:
            out.append(dict(rec))
            continue
        if last_idx[jid] != i:
            continue
        job = jobs[jid]
        snap = {"seq": 0, "wall": job.submitted_wall, "job": jid,
                "event": SUBMIT, "spec": job.spec,
                "state": job.state.value, "recoveries": job.recoveries,
                "migrations": job.migrations, "updated": job.updated_wall,
                "compacted": True}
        for key, attr in (("cid", "cid"), ("device", "device"),
                          ("granted", "granted_slices"),
                          ("admitted_sim", "admitted_sim"),
                          ("ends_sim", "ends_sim"), ("error", "error"),
                          ("result", "result")):
            val = getattr(job, attr)
            if val is not None:
                snap[key] = val
        out.append(snap)
    for seq, rec in enumerate(out):
        rec["seq"] = seq
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:6]}"
    with open(tmp, "w") as f:
        for rec in out:
            f.write(json.dumps(rec) + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(recs) - len(out)


# ---------------------------------------------------------------------------
# Spool (CLI -> daemon)
# ---------------------------------------------------------------------------

def request_submit(state_dir: str, spec: dict,
                   job_id: Optional[str] = None) -> str:
    """Queue a submission; returns the job id (caller-visible immediately,
    durable once the daemon journals it)."""
    _ensure_dirs(state_dir)
    jid = job_id or f"job-{uuid.uuid4().hex[:10]}"
    path = os.path.join(state_dir, INBOX,
                        f"{time.time_ns():020d}-{jid}.submit.json")
    _atomic_write(path, {"job_id": jid, "spec": spec, "wall": time.time()})
    return jid


def request_cancel(state_dir: str, job_id: str):
    _ensure_dirs(state_dir)
    path = os.path.join(state_dir, INBOX,
                        f"{time.time_ns():020d}-{job_id}.cancel.json")
    _atomic_write(path, {"job_id": job_id, "wall": time.time()})


def request_drain(state_dir: str):
    _ensure_dirs(state_dir)
    _atomic_write(os.path.join(state_dir, INBOX, DRAIN_FLAG),
                  {"wall": time.time()})


def _jid_from_name(name: str) -> Optional[str]:
    """Best-effort job id from a spool filename ``<t_ns>-<jid>.<verb>.json``.
    Lets the daemon journal a FAIL for a corrupt-but-identifiable submit."""
    stem = name
    for suffix in (".submit.json", ".cancel.json"):
        if stem.endswith(suffix):
            stem = stem[:-len(suffix)]
            break
    else:
        return None
    if "-" not in stem:
        return None
    prefix, jid = stem.split("-", 1)
    if not prefix.isdigit() or not jid:
        return None
    return jid


def _quarantine(inbox: str, path: str, name: str, reason: str) -> dict:
    """Move a malformed spool file to ``inbox/rejected/`` so it can never
    wedge ingestion again, and report it."""
    rejdir = os.path.join(inbox, REJECTED)
    os.makedirs(rejdir, exist_ok=True)
    dst = os.path.join(rejdir, name)
    try:
        os.replace(path, dst)
    except OSError:
        dst = path                      # raced away / unwritable: report only
    return {"name": name, "path": dst, "reason": reason,
            "job_id": _jid_from_name(name),
            "kind": ("submit" if name.endswith(".submit.json")
                     else "cancel" if name.endswith(".cancel.json")
                     else "unknown")}


def _spool_schema_error(name: str, payload) -> Optional[str]:
    """Why a decoded spool payload is unusable, or None if well-formed."""
    if not isinstance(payload, dict):
        return f"payload is {type(payload).__name__}, expected object"
    if not isinstance(payload.get("job_id"), str) or not payload["job_id"]:
        return "missing or non-string job_id"
    if name.endswith(".submit.json") and not isinstance(payload.get("spec"),
                                                        dict):
        return "missing or non-object spec"
    return None


def scan_inbox(state_dir: str) -> tuple[list[dict], list[dict], bool,
                                        list[dict]]:
    """Daemon side: (submits, cancels, drain?, rejected) in arrival order.
    Each entry carries its ``_path`` for post-ingestion unlink.

    Unreadable files (OSError) are skipped and retried next scan — they may
    be mid-rename.  Files that *decode wrongly* (truncated JSON, or a wrong
    shape: non-object payload, missing job id, submit without a spec) are
    permanent poison: they are moved to ``inbox/rejected/`` and reported in
    the fourth element so the daemon can journal a FAIL for any job id it
    can still identify from the filename."""
    inbox = os.path.join(state_dir, INBOX)
    if not os.path.isdir(inbox):
        return [], [], False, []
    submits, cancels, drain, rejected = [], [], False, []
    for name in sorted(os.listdir(inbox)):
        path = os.path.join(inbox, name)
        if name == DRAIN_FLAG:
            drain = True
            continue
        if name.endswith(".tmp") or ".tmp." in name or name == REJECTED:
            continue
        try:
            with open(path) as f:
                payload = json.load(f)
        except OSError:
            continue                    # transient: retry next scan
        except ValueError as e:         # bad JSON or not even valid UTF-8
            rejected.append(_quarantine(inbox, path, name,
                                        f"invalid JSON: {e}"))
            continue
        err = _spool_schema_error(name, payload)
        if err is not None:
            rejected.append(_quarantine(inbox, path, name, err))
            continue
        payload["_path"] = path
        if name.endswith(".submit.json"):
            submits.append(payload)
        elif name.endswith(".cancel.json"):
            cancels.append(payload)
    return submits, cancels, drain, rejected


def clear_drain(state_dir: str):
    try:
        os.unlink(os.path.join(state_dir, INBOX, DRAIN_FLAG))
    except FileNotFoundError:
        pass


def consume(entry: dict):
    """Unlink an ingested inbox file (idempotent)."""
    try:
        os.unlink(entry["_path"])
    except FileNotFoundError:
        pass


# ---------------------------------------------------------------------------
# Heartbeat
# ---------------------------------------------------------------------------

def write_heartbeat(state_dir: str, payload: dict):
    payload = {"wall": time.time(), "pid": os.getpid(), **payload}
    _atomic_write(os.path.join(state_dir, HEARTBEAT), payload)


def read_heartbeat(state_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(state_dir, HEARTBEAT)) as f:
            hb = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    pid = hb.get("pid")
    alive = False
    if isinstance(pid, int):
        try:
            os.kill(pid, 0)
            alive = True
        except (OSError, ProcessLookupError):
            alive = False
    hb["alive"] = alive
    return hb
