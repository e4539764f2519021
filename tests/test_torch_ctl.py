"""The port's control-plane state machine and store (``repro_torch.ctl.state``,
``repro_torch.ctl.store``) against the reference's, on the CPU: the same
transition table; journals, spool files and compacted journals that either
package writes and the other reads to the same job table; the same tenant
from the same submission (``daemon.app_from_spec``).

Each reference check of ``tests/test_ctl.py`` on this side of the daemon is
made on the port.  The daemon itself is in ``test_torch_ctl_daemon.py``."""
import dataclasses
import os
import shutil

import pytest

from repro.ctl import daemon as r_daemon
from repro.ctl import state as r_state
from repro.ctl import store as r_store
from repro_torch.ctl import cli as p_cli
from repro_torch.ctl import daemon as p_daemon
from repro_torch.ctl import store as p_store
from repro_torch.ctl.state import (TERMINAL, TRANSITIONS, InvalidTransition,
                                   Job, JobEvent, JobState, transition)

pytestmark = pytest.mark.ctl

STORES = {"ref": r_store, "port": p_store}
PAIRS = [(w, r) for w in STORES for r in STORES]

JOB_FIELDS = ("job_id", "spec", "state", "submitted_wall", "updated_wall",
              "cid", "device", "granted_slices", "admitted_sim", "ends_sim",
              "recoveries", "migrations", "error", "result")


def table(jobs):
    """A replayed job table as plain values (states by their names)."""
    return {jid: tuple(getattr(j, f).value if f == "state" else getattr(j, f)
                       for f in JOB_FIELDS) for jid, j in jobs.items()}


# -- state machine -----------------------------------------------------------

def test_transition_table_equals_reference():
    assert [s.value for s in JobState] == [s.value for s in r_state.JobState]
    assert [e.value for e in JobEvent] == [e.value for e in r_state.JobEvent]
    assert ({(s.value, e.value): d.value for (s, e), d in TRANSITIONS.items()}
            == {(s.value, e.value): d.value
                for (s, e), d in r_state.TRANSITIONS.items()})
    assert ({s.value for s in TERMINAL}
            == {s.value for s in r_state.TERMINAL})
    assert [f.name for f in dataclasses.fields(Job)] == [
        f.name for f in dataclasses.fields(r_state.Job)]


def test_transitions_exhaustive():
    for state in JobState:
        for event in JobEvent:
            if (state, event) in TRANSITIONS:
                assert isinstance(transition(state, event), JobState)
            else:
                with pytest.raises(InvalidTransition) as ei:
                    transition(state, event)
                assert ei.value.state is state and ei.value.event is event


def test_terminal_states_absorbing_and_reachable():
    for state in TERMINAL:
        assert [e for (s, e) in TRANSITIONS if s is state] == []
    reaches = set(TERMINAL)
    changed = True
    while changed:
        changed = False
        for (s, _), dst in TRANSITIONS.items():
            if dst in reaches and s not in reaches:
                reaches.add(s)
                changed = True
    assert reaches == set(JobState)


def test_lifecycle_and_requeue():
    job = Job(job_id="j", spec={})
    for ev, want in [(JobEvent.ADMIT, JobState.ADMITTED),
                     (JobEvent.START, JobState.RUNNING),
                     (JobEvent.MIGRATE, JobState.MIGRATING),
                     (JobEvent.LAND, JobState.RUNNING),
                     (JobEvent.FINISH, JobState.DONE)]:
        assert job.apply(ev) is want
    assert job.terminal and job.migrations == 1
    with pytest.raises(InvalidTransition):
        job.apply(JobEvent.CANCEL)
    job = Job(job_id="j", spec={})
    job.apply(JobEvent.ADMIT)
    job.cid, job.device, job.granted_slices = 7, 1, 8
    job.apply(JobEvent.START)
    job.apply(JobEvent.PREEMPT)
    job.apply(JobEvent.REQUEUE)
    assert job.state is JobState.QUEUED and job.recoveries == 1
    assert job.cid is None and job.device is None and job.granted_slices == 0


# -- journal + spool, written by one package and read by the other ----------

def _write_journal(store, d):
    j = store.Journal(d)
    j.append("a", store.SUBMIT, spec={"kind": "train"}, to="queued")
    j.append("a", "admit", cid=0, device=1)
    j.append("a", "start", granted=4, admitted_sim=0.0, ends_sim=2.0)
    j.append("a", "finish", result={"n_completed": 10})
    j.append("b", store.SUBMIT, spec={"kind": "serve"})
    j.append("b", "admit", cid=1, device=0)
    j.append("b", "start", granted=0, admitted_sim=0.0, ends_sim=1.0)
    j.append("b", "bogus-event")
    j.append("c", "admit", cid=2, device=0)     # no SUBMIT: ignored
    j.close()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_journal_replay_across_packages(tmp_path, writer, reader):
    d = str(tmp_path)
    _write_journal(STORES[writer], d)
    jobs = STORES[reader].replay(d)
    assert table(jobs) == table(STORES[writer].replay(d))
    assert jobs["a"].state.value == "done"
    assert jobs["a"].result == {"n_completed": 10}
    assert jobs["a"].granted_slices == 4 and jobs["a"].device == 1
    assert jobs["b"].state.value == "running" and jobs["b"].cid == 1
    assert set(jobs) == {"a", "b"}


def test_journal_records_have_the_reference_keys(tmp_path):
    for name, store in STORES.items():
        _write_journal(store, str(tmp_path / name))
    recs = [r_store._read_records(str(tmp_path / n / r_store.JOURNAL))
            for n in STORES]
    strip = [[{k: v for k, v in r.items() if k != "wall"} for r in rs]
             for rs in recs]
    assert strip[0] == strip[1]
    assert [list(r) for r in recs[0]] == [list(r) for r in recs[1]]
    assert p_store.JOURNAL == r_store.JOURNAL
    assert p_store.HEARTBEAT == r_store.HEARTBEAT
    assert p_store.INBOX == r_store.INBOX


def test_journal_torn_tail_ignored(tmp_path):
    d = str(tmp_path)
    j = p_store.Journal(d)
    j.append("a", p_store.SUBMIT, spec={})
    j.append("a", "admit", cid=0, device=0)
    j.close()
    with open(os.path.join(d, p_store.JOURNAL), "a") as f:
        f.write('{"seq": 2, "job": "a", "eve')
    assert p_store.replay(d)["a"].state is JobState.ADMITTED
    p_store.Journal(d).append("a", "start", granted=0, admitted_sim=0.0,
                              ends_sim=1.0)
    assert p_store.replay(d)["a"].state is JobState.ADMITTED
    assert table(r_store.replay(d)) == table(p_store.replay(d))


def test_duplicate_submit_ignored(tmp_path):
    d = str(tmp_path)
    j = p_store.Journal(d)
    j.append("a", p_store.SUBMIT, spec={"name": "first"})
    j.append("a", p_store.SUBMIT, spec={"name": "dup"})
    j.close()
    jobs = p_store.replay(d)
    assert len(jobs) == 1 and jobs["a"].spec == {"name": "first"}


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_spool_across_packages(tmp_path, writer, reader):
    d = str(tmp_path)
    w, r = STORES[writer], STORES[reader]
    ids = [w.request_submit(d, {"i": i}) for i in range(3)]
    ids.append(w.request_submit(d, {"i": 3}, job_id="fixed-id"))
    w.request_cancel(d, ids[1])
    submits, cancels, drain, rejected = r.scan_inbox(d)
    assert [s["job_id"] for s in submits] == ids
    assert [s["spec"] for s in submits] == [{"i": i} for i in range(4)]
    assert cancels[0]["job_id"] == ids[1] and not drain and not rejected
    for e in submits + cancels:
        r.consume(e)
    assert r.scan_inbox(d) == ([], [], False, [])
    w.request_drain(d)
    assert r.scan_inbox(d)[2] is True
    r.clear_drain(d)
    assert r.scan_inbox(d)[2] is False


def test_job_ids_have_the_reference_shape(tmp_path):
    jid = p_store.request_submit(str(tmp_path), {})
    rid = r_store.request_submit(str(tmp_path), {})
    assert jid.startswith("job-") and len(jid) == len(rid)


def _history(store, d):
    j = store.Journal(d)
    for i in range(20):
        jid = f"job-{i:03d}"
        j.append(jid, store.SUBMIT, spec={"kind": "train", "i": i},
                 to="queued")
        j.append(jid, "admit", cid=i, device=i % 2)
        j.append(jid, "start", granted=4, admitted_sim=float(i),
                 ends_sim=float(i) + 1.0)
        if i % 3 == 0:
            j.append(jid, "preempt")
            j.append(jid, "requeue")
            j.append(jid, "admit", cid=100 + i, device=(i + 1) % 2)
            j.append(jid, "start", granted=4, admitted_sim=float(i) + 2.0,
                     ends_sim=float(i) + 3.0)
        if i < 15:
            j.append(jid, "finish", result={"n_completed": i})
    j.append("device-1", "fault", device=1, sim_now=9.0, jobs=[])
    j.close()


def test_compact_equals_reference_and_preserves_replay(tmp_path):
    """One journal, compacted by each package: the same file, read back to
    the journal's own job table by either package."""
    src = str(tmp_path / "src")
    _history(p_store, src)
    before = table(p_store.replay(src))
    n_before = len(p_store._read_records(os.path.join(src, p_store.JOURNAL)))
    out = {}
    for name, store in STORES.items():
        d = str(tmp_path / name)
        shutil.copytree(src, d)
        dropped = store.compact(d)
        with open(os.path.join(d, store.JOURNAL)) as f:
            out[name] = (dropped, f.read())
        for reader in STORES.values():
            assert table(reader.replay(d)) == before
    assert out["port"] == out["ref"]
    d = str(tmp_path / "port")
    recs = p_store._read_records(os.path.join(d, p_store.JOURNAL))
    assert out["port"][0] > 0 and len(recs) == n_before - out["port"][0]
    assert [r["seq"] for r in recs] == list(range(len(recs)))
    per_job = {}
    for r in recs:
        per_job[r["job"]] = per_job.get(r["job"], 0) + 1
    assert all(per_job[f"job-{i:03d}"] == 1 for i in range(15))
    assert all(per_job[f"job-{i:03d}"] >= 3 for i in range(15, 20))
    assert any(r["event"] == "fault" for r in recs)
    assert p_store.compact(d) == 0
    j2 = p_store.Journal(d)
    assert j2.seq == len(recs)
    j2.close()


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_heartbeat_across_packages(tmp_path, writer, reader):
    d = str(tmp_path)
    STORES[writer]._ensure_dirs(d)
    STORES[writer].write_heartbeat(d, {"sim_now": 1.5, "live": 2})
    hb = STORES[reader].read_heartbeat(d)
    assert hb["alive"] is True and hb["pid"] == os.getpid()
    assert hb["sim_now"] == 1.5 and hb["live"] == 2


# -- spec -> tenant ----------------------------------------------------------

SPECS = [
    {"kind": "serve", "rps": 25.0, "duration": 3.0, "priority": "hp",
     "quota_slices": 6, "slo_latency": 0.2},
    {"kind": "serve", "arch": "llama3-8b", "reduced": False, "name": "s",
     "priority": "hp", "quota_slices": 0, "rps": 20.0, "duration": 5.0,
     "slo_latency": 0.25, "batch": 4, "decode_tokens": 16, "seed": 0},
    {"kind": "train", "arch": "olmo-1b", "reduced": False, "priority": "be",
     "duration": 5.0, "train_seq": 512, "fusion": 8},
    {"kind": "fwd_infer", "arch": "whisper-small", "rps": 10.0,
     "prompt_mix": [[128, 0.5], [512, 0.5]], "priority": "low"},
    {"kind": "llm_infer", "arch": "qwen2-moe-a2.7b", "rps": 5.0,
     "priority": "high", "seed": 3},
]


def _app_values(app):
    out = {f.name: getattr(app, f.name) for f in dataclasses.fields(app)}
    out["cfg"] = dataclasses.asdict(app.cfg)
    out["priority"] = int(app.priority)
    return out


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s["kind"])
def test_app_from_spec_equals_reference(spec):
    p_app, p_dur = p_daemon.app_from_spec(spec, fallback_name="x")
    r_app, r_dur = r_daemon.app_from_spec(spec, fallback_name="x")
    assert p_dur == r_dur
    assert _app_values(p_app) == _app_values(r_app)


def test_app_from_spec_serve_maps_to_llm_infer():
    app, dur = p_daemon.app_from_spec(SPECS[0], fallback_name="x")
    assert app.kind == "llm_infer" and app.rps == 25.0
    assert app.quota_slices == 6 and dur == 3.0


@pytest.mark.parametrize("spec", [
    {"kind": "nope"},
    {"kind": "train", "arch": "not-an-arch"},
    {"kind": "train", "duration": -1},
    {"kind": "serve", "rps": 0.0},
    {"kind": "train", "priority": "urgent"},
    {"kind": "train", "quota_slices": -2},
])
def test_app_from_spec_rejects(spec):
    with pytest.raises(p_daemon.JobSpecError) as ei:
        p_daemon.app_from_spec(spec, fallback_name="x")
    with pytest.raises(r_daemon.JobSpecError) as ri:
        r_daemon.app_from_spec(spec, fallback_name="x")
    assert str(ei.value) == str(ri.value)


# -- device profiles and the CLI ---------------------------------------------

def test_device_profiles_default_to_h100():
    """The port's one deliberate difference: ``h100`` in place of the
    reference's ``tpu_v5e``, and the default."""
    assert sorted(p_daemon.DEVICE_PROFILES) == ["a100", "h100", "l4"]
    assert p_daemon.DaemonConfig().device == "h100"
    assert r_daemon.DaemonConfig().device == "a100"
    for name in ("a100", "l4"):
        assert (dataclasses.asdict(p_daemon.DEVICE_PROFILES[name]())
                == dataclasses.asdict(r_daemon.DEVICE_PROFILES[name]()))
    h100 = p_daemon.DaemonConfig(n_devices=3).node()
    assert h100.n_devices == 3 and h100.devices[0].n_slices == 66
    small = p_daemon.DaemonConfig(n_slices=8).node()
    assert small.devices[0].n_slices == 8
    with pytest.raises(ValueError):
        p_daemon.DaemonConfig(device="tpu_v5e").node()
    args = p_cli.build_parser().parse_args(["daemon", "--state-dir", "x"])
    assert args.device == "h100" and args.devices == 2
    for field in ("n_devices", "n_slices", "system", "engine", "horizon",
                  "seed", "poll_interval", "max_steps_per_tick", "admit_cost",
                  "migration", "epoch", "validate", "heartbeat_interval",
                  "fault_plan", "compact_threshold_bytes"):
        assert (getattr(p_daemon.DaemonConfig(), field)
                == getattr(r_daemon.DaemonConfig(), field)), field


def test_cli_submit_writes_the_reference_spec(tmp_path):
    argv = ["submit", "--state-dir", str(tmp_path), "--kind", "serve",
            "--arch", "llama3-8b", "--priority", "hp", "--quota", "6",
            "--rps", "12.5", "--duration", "2", "--name", "svc",
            "--full-size"]
    assert p_cli.main(argv) == 0
    from repro.ctl import cli as r_cli
    assert r_cli.main(argv) == 0
    submits = p_store.scan_inbox(str(tmp_path))[0]
    assert len(submits) == 2 and submits[0]["spec"] == submits[1]["spec"]
    assert submits[0]["spec"]["reduced"] is False
