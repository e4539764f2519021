"""The port's control-plane daemon (``repro_torch.ctl.daemon.ControlPlane``)
against the reference's, on the CPU.

The two daemons are driven tick by tick in lockstep, on the same
submissions with fixed job ids, and their journals must be equal record for
record once the wall-clock fields are dropped (``wall``; ``updated`` in a
compacted snapshot).  Each package replays and recovers a state dir that the
other's daemon wrote.  ``python -m repro_torch.ctl`` survives ``kill -9``.
Each reference check of ``tests/test_ctl.py`` and of the control-plane half
of ``tests/test_fault_domains.py`` is made on the port."""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import pytest

from repro.core import types as r_types
from repro.ctl import daemon as r_daemon
from repro.ctl import store as r_store
from repro_torch.core import types as p_types
from repro_torch.ctl import daemon as p_daemon
from repro_torch.ctl import store as p_store
from repro_torch.ctl.state import JobState

pytestmark = pytest.mark.ctl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WALL = ("wall", "updated")
CTL = {"ref": (r_daemon, r_store, r_types), "port": (p_daemon, p_store,
                                                    p_types)}


@pytest.fixture
def ref_h100(monkeypatch):
    """The reference's profile map with an ``h100`` entry: a reference
    ``DeviceSpec`` with ``h100_like``'s field values (the reference has no
    such profile, and stays as it is)."""
    values = dataclasses.asdict(p_types.DeviceSpec.h100_like())
    monkeypatch.setitem(r_daemon.DEVICE_PROFILES, "h100",
                        lambda: r_types.DeviceSpec(**values))


def journal(d):
    """The journal's records without their wall-clock fields."""
    return [{k: v for k, v in rec.items() if k not in WALL}
            for rec in p_store._read_records(os.path.join(d, p_store.JOURNAL))]


def job_table(jobs):
    """Replayed jobs without their wall-clock fields."""
    return {jid: {k: v for k, v in j.public().items()
                  if k not in ("submitted_wall", "updated_wall")}
            for jid, j in jobs.items()}


def submit(d, store, subs):
    for jid, spec in subs:
        store.request_submit(d, spec, job_id=jid)


def lockstep(tmp_path, subs, cfg_kw, until=None, max_ticks=20000,
             engine=None):
    """Both daemons, one tick each in turn, until every job of both is
    terminal (or ``until(cp)`` holds for both).  Returns the two state dirs
    and control planes (reference first); asserts at every tick that the two
    job tables agree."""
    dirs, cps = [], []
    for name in ("ref", "port"):
        daemon, store, _ = CTL[name]
        d = str(tmp_path / name)
        submit(d, store, subs)
        cps.append(daemon.ControlPlane(d, daemon.DaemonConfig(
            poll_interval=0.0, engine=engine, **cfg_kw)))
        dirs.append(d)
    done = until or (lambda cp: all(j.terminal for j in cp.jobs.values()))
    for _ in range(max_ticks):
        steps = [cp.tick() for cp in cps]
        assert steps[0] == steps[1]
        assert job_table(cps[0].jobs) == job_table(cps[1].jobs)
        if all([done(cp) for cp in cps]):
            return dirs, cps
    raise AssertionError("the daemons did not converge")


LIFECYCLE = [("a-hp", {"kind": "serve", "rps": 30.0, "duration": 0.6,
                       "priority": "hp", "quota_slices": 6}),
             ("b-be", {"kind": "train", "duration": 0.4}),
             ("c-bad", {"kind": "bogus"})]


@pytest.mark.parametrize("device", ["a100", "h100"])
@pytest.mark.parametrize("engine", ["ref", "vec"])
def test_daemon_journal_equals_reference(tmp_path, ref_h100, engine, device):
    dirs, cps = lockstep(tmp_path, LIFECYCLE,
                         dict(n_devices=2, device=device), engine=engine)
    for cp in cps:
        cp.shutdown()
    assert journal(dirs[1]) == journal(dirs[0])
    jobs = cps[1].jobs
    assert jobs["a-hp"].state is JobState.DONE
    assert jobs["a-hp"].granted_slices == 6
    assert jobs["a-hp"].result["n_completed"] > 0
    assert jobs["b-be"].state is JobState.DONE
    assert jobs["b-be"].result["n_completed"] > 0
    assert jobs["c-bad"].state is JobState.FAILED
    assert "bogus" in jobs["c-bad"].error
    assert jobs["a-hp"].device != jobs["b-be"].device
    for sim, pol in zip(cps[1].coord.sims, cps[1].coord.policies):
        assert not sim.client_by_id
        sm = getattr(pol, "slices", None)
        if sm is not None:
            assert all(o is None for o in sm.owner)
    assert not cps[1].coord.ledger.current
    # each package replays the other's state dir to the same job table
    for d in dirs:
        assert job_table(p_store.replay(d)) == job_table(r_store.replay(d))
        assert job_table(p_store.replay(d)) == job_table(jobs)


def run_until(cp, done, max_ticks=20000):
    """Tick ``cp`` until ``done(cp)`` holds after a tick."""
    for _ in range(max_ticks):
        cp.tick()
        if done(cp):
            return cp
    raise AssertionError("the daemon did not converge")


def all_in(state):
    return lambda cp: cp.jobs and all(j.state.value == state
                                      for j in cp.jobs.values())


def crash_and_recover(d, crashed, recovers):
    """``crashed``'s daemon dies with both jobs running (no shutdown hook
    runs); ``recovers``'s daemon takes over the state dir and runs them to
    the end.  Returns the job states the survivor found on disk."""
    subs = [("a-svc", {"kind": "serve", "rps": 25.0, "duration": 0.6,
                       "priority": "hp", "quota_slices": 6, "name": "svc"}),
            ("b-trn", {"kind": "train", "duration": 0.5, "name": "trn"})]
    cfg = dict(n_devices=2, device="h100", poll_interval=0.0)
    daemon, store, _ = CTL[crashed]
    submit(d, store, subs)
    cp = run_until(daemon.ControlPlane(d, daemon.DaemonConfig(**cfg)),
                   all_in("running"))
    cp.journal.close()
    daemon, store, _ = CTL[recovers]
    found = {jid: j.state.value for jid, j in store.replay(d).items()}
    cp = run_until(daemon.ControlPlane(d, daemon.DaemonConfig(**cfg)),
                   all_in("done"))
    cp.shutdown()
    return found


def test_recovery_of_the_other_packages_state_dir(tmp_path, ref_h100):
    """Each package's daemon recovers a state dir the other's daemon left
    behind when it died: both jobs re-queued once, run to the end, and the
    two journals are equal."""
    dirs = {}
    for crashed, recovers in (("ref", "port"), ("port", "ref")):
        d = dirs[crashed] = str(tmp_path / f"{crashed}-crashed")
        found = crash_and_recover(d, crashed, recovers)
        assert found == {"a-svc": "running", "b-trn": "running"}
        for reader in (p_store, r_store):
            jobs = reader.replay(d)
            assert set(jobs) == {"a-svc", "b-trn"}
            for j in jobs.values():
                assert j.state.value == "done" and j.recoveries == 1
                assert j.result["n_completed"] > 0
    assert journal(dirs["ref"]) == journal(dirs["port"])


def test_cancel_running_job_equals_reference(tmp_path):
    subs = [("a-trn", {"kind": "train", "duration": 50.0})]
    dirs, cps = lockstep(
        tmp_path, subs, dict(n_devices=1, device="a100"),
        until=all_in("running"))
    for d, (name, cp) in zip(dirs, zip(("ref", "port"), cps)):
        CTL[name][1].request_cancel(d, "a-trn")
    for _ in range(20000):
        for cp in cps:
            cp.tick()
        if all(cp.jobs["a-trn"].terminal for cp in cps):
            break
    assert cps[1].jobs["a-trn"].state is JobState.CANCELLED
    assert cps[1].jobs["a-trn"].result["n_completed"] >= 0
    for cp in cps:
        cp.shutdown()
    assert journal(dirs[1]) == journal(dirs[0])
    assert not cps[1].coord.sims[0].client_by_id


def test_quota_admission_control_equals_reference(tmp_path, ref_h100):
    """One ``h100`` device (66 slices): two 40-slice tenants cannot coexist;
    the second waits in QUEUED until the first finishes."""
    subs = [(f"{c}-svc", {"kind": "serve", "rps": 20.0, "duration": 0.4,
                          "priority": "hp", "quota_slices": 40})
            for c in "ab"]
    saw = []

    def waiting(cp):
        if (cp.jobs["a-svc"].state.value == "running"
                and cp.jobs["b-svc"].state.value == "queued"):
            saw.append(cp)
        return all(j.terminal for j in cp.jobs.values())
    dirs, cps = lockstep(tmp_path, subs, dict(n_devices=1, device="h100"),
                         until=waiting)
    for cp in cps:
        cp.shutdown()
    assert journal(dirs[1]) == journal(dirs[0])
    assert cps[1] in saw
    assert all(j.state is JobState.DONE for j in cps[1].jobs.values())


def test_drain_preempts_and_recovers(tmp_path):
    d = str(tmp_path)
    jid = p_store.request_submit(d, {"kind": "train", "duration": 30.0})
    cfg = p_daemon.DaemonConfig(n_devices=1, poll_interval=0.0)
    cp = run_until(p_daemon.ControlPlane(d, cfg), all_in("running"))
    p_store.request_drain(d)
    cp.run(max_wall=30.0)
    assert cp.jobs[jid].state is JobState.PREEMPTED
    cp2 = p_daemon.ControlPlane(d, cfg)
    assert cp2.jobs[jid].state is JobState.QUEUED
    assert cp2.jobs[jid].recoveries == 1
    cp2.shutdown()
    assert job_table(r_store.replay(d)) == job_table(p_store.replay(d))


# -- device loss, spool hygiene and compaction (the fault-domain half) ------

def test_device_loss_requeues_and_recovers_equals_reference(tmp_path):
    subs = [(f"svc{i}", {"kind": "serve", "rps": 40.0, "duration": 1.0,
                         "priority": "hp", "quota_slices": 8,
                         "name": f"svc{i}"}) for i in range(3)]
    dirs, cps = [], []
    for name in ("ref", "port"):
        daemon, store, types = CTL[name]
        d = str(tmp_path / name)
        submit(d, store, subs)
        plan = types.FaultPlan(events=(types.FaultEvent(
            t=0.5, kind="device_dead", member=0),))
        cps.append(daemon.ControlPlane(d, daemon.DaemonConfig(
            n_devices=2, device="a100", fault_plan=plan, validate=True,
            poll_interval=0.0)))
        dirs.append(d)
    for _ in range(20000):
        for cp in cps:
            cp.tick()
        if all(all_in("done")(cp) for cp in cps):
            break
    for cp in cps:
        cp.shutdown()
    assert journal(dirs[1]) == journal(dirs[0])
    jobs = p_store.replay(dirs[1])
    recs = journal(dirs[1])
    for jid, _ in subs:
        assert jobs[jid].state is JobState.DONE, (jid, jobs[jid].error)
        assert sum(1 for r in recs
                   if r["job"] == jid and r["event"] == "finish") == 1
    faults = [r for r in recs if r["event"] == "fault"]
    assert len(faults) == 1 and faults[0]["device"] == 0
    hit = [jid for jid, _ in subs if jobs[jid].recoveries >= 1]
    assert hit and set(faults[0]["jobs"]) == set(hit)
    for jid in hit:
        pre = [r for r in recs if r["job"] == jid and r["event"] == "preempt"]
        assert any(r.get("fault", {}).get("device") == 0 for r in pre)
        assert jobs[jid].device == 1


def test_quarantines_corrupt_spool_files(tmp_path):
    d = str(tmp_path)
    good = p_store.request_submit(d, {"kind": "serve", "rps": 20.0,
                                      "duration": 0.2, "priority": "be"})
    inbox = os.path.join(d, "inbox")
    with open(os.path.join(inbox, f"{time.time_ns():020d}-trunc.submit.json"),
              "w") as f:
        f.write('{"job_id": "trunc", "spe')
    with open(os.path.join(inbox, f"{time.time_ns():020d}-noise.submit.json"),
              "wb") as f:
        f.write(b"\x00\xff\xfe not json at all")
    cp = p_daemon.ControlPlane(d, p_daemon.DaemonConfig(n_devices=1,
                                                        poll_interval=0.0))
    cp.run(max_wall=60.0, exit_when_idle=True)
    jobs = p_store.replay(d)
    assert jobs[good].state is JobState.DONE
    assert len(os.listdir(os.path.join(inbox, "rejected"))) == 2
    assert not any(n.endswith(".submit.json") for n in os.listdir(inbox))
    for jid in ("trunc", "noise"):
        assert jobs[jid].state is JobState.FAILED
        assert "rejected spool file" in jobs[jid].error


def test_daemon_compacts_over_threshold_equals_reference(tmp_path):
    subs = [(f"tiny{i}", {"kind": "serve", "rps": 20.0, "duration": 0.2,
                          "priority": "be", "name": f"tiny{i}"})
            for i in range(6)]
    dirs, cps = lockstep(tmp_path, subs, dict(n_devices=1, device="a100",
                                              compact_threshold_bytes=1))
    for cp in cps:
        cp.shutdown()
    assert journal(dirs[1]) == journal(dirs[0])
    recs = journal(dirs[1])
    assert all(j.state is JobState.DONE for j in cps[1].jobs.values())
    per_job = {}
    for r in recs:
        per_job[r["job"]] = per_job.get(r["job"], 0) + 1
    assert all(n == 1 for n in per_job.values()) and len(per_job) == 6
    assert all(r.get("compacted") for r in recs)


# -- the CLI: kill -9, restart, no loss --------------------------------------

def _env():
    return {**os.environ, "PYTHONPATH": os.path.join(REPO, "src")}


def _ctl(args, **kw):
    return subprocess.run([sys.executable, "-m", "repro_torch.ctl", *args],
                          env=_env(), capture_output=True, text=True, **kw)


def test_kill9_recovery_subprocess(tmp_path):
    """``python -m repro_torch.ctl daemon`` on the default ``h100`` profile:
    ``SIGKILL`` with both jobs running, restart, both finish once each;
    then ``status --json`` reads the dead daemon's state dir."""
    d = str(tmp_path)
    a = p_store.request_submit(d, {"kind": "serve", "rps": 25.0,
                                   "duration": 3.0, "priority": "hp",
                                   "quota_slices": 6, "name": "svc"})
    b = p_store.request_submit(d, {"kind": "train", "duration": 2.5,
                                   "name": "trn"})
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.ctl", "daemon", "--state-dir", d,
         "--devices", "2"], env=_env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            st = {j: s.state for j, s in p_store.replay(d).items()}
            if st.get(a) is JobState.RUNNING and st.get(b) is JobState.RUNNING:
                break
            time.sleep(0.2)
        else:
            raise AssertionError("jobs never both RUNNING")
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    hb = p_store.read_heartbeat(d)
    assert hb is not None and not hb["alive"]
    assert {j: s.state for j, s in p_store.replay(d).items()} == {
        a: JobState.RUNNING, b: JobState.RUNNING}
    r = _ctl(["daemon", "--state-dir", d, "--devices", "2",
              "--exit-when-idle", "--max-wall", "120"], timeout=180)
    assert r.returncode == 0, r.stderr
    assert "recovered=2" in r.stdout
    jobs = p_store.replay(d)
    assert set(jobs) == {a, b}
    for jid in (a, b):
        assert jobs[jid].state is JobState.DONE
        assert jobs[jid].recoveries == 1
        assert jobs[jid].result["n_completed"] > 0
    assert job_table(r_store.replay(d)) == job_table(jobs)
    out = _ctl(["status", "--state-dir", d, "--json"], timeout=60)
    assert out.returncode == 0, out.stderr
    doc = json.loads(out.stdout)
    assert [row["state"] for row in doc["jobs"]] == ["done", "done"]
    assert doc["daemon"]["alive"] is False


def test_serve_submission_runs_through_the_daemon(tmp_path):
    """``launch.serve --ctl-state-dir`` submits; the port's daemon admits the
    serve tenant and a best-effort trainer beside it, and runs both to the
    end (``chip_smoke.py``'s ``ctl`` phase at full size)."""
    from repro_torch.launch.serve import main as serve_main
    d = str(tmp_path)
    serve_main(["--arch", "olmo-1b", "--reduced", "--max-slots", "4",
                "--max-new", "8", "--priority", "hp", "--rps", "30",
                "--duration", "0.5", "--ctl-state-dir", d])
    p_store.request_submit(d, {"kind": "train", "arch": "olmo-1b",
                               "priority": "be", "duration": 0.4})
    cp = p_daemon.ControlPlane(d, p_daemon.DaemonConfig(poll_interval=0.0))
    cp.run(max_wall=60.0, exit_when_idle=True)
    jobs = p_store.replay(d)
    assert len(jobs) == 2
    serve_job = next(j for j in jobs.values() if j.spec["kind"] == "serve")
    assert serve_job.spec["name"] == "serve-olmo-1b"
    assert serve_job.spec["batch"] == 4 and serve_job.spec["decode_tokens"] == 8
    for j in jobs.values():
        assert j.state is JobState.DONE and j.result["n_completed"] > 0
