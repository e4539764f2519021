"""``python -m repro_torch.ctl`` — submit / status / cancel / drain / daemon.

The CLI never imports the simulator stack except for the ``daemon`` verb:
``submit``/``cancel``/``drain`` only touch the spool, and ``status`` only
replays the journal, so they work (fast, without the simulator) whether or
not a daemon is running — and against the state dir of a *crashed* daemon, which is how
operators inspect what recovery will do before restarting.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from repro_torch.ctl import store
from repro_torch.ctl.state import TERMINAL, JobState


def _add_state_dir(p: argparse.ArgumentParser):
    p.add_argument("--state-dir", required=True,
                   help="control-plane state directory (journal + inbox)")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.ctl",
        description="online serving control plane")
    sub = ap.add_subparsers(dest="verb", required=True)

    d = sub.add_parser("daemon", help="run the scheduler daemon")
    _add_state_dir(d)
    d.add_argument("--devices", type=int, default=2)
    d.add_argument("--device", default="h100",
                   help="device profile: a100 | l4 | h100")
    d.add_argument("--slices", type=int, default=0,
                   help="override slices per device (0 = profile default)")
    d.add_argument("--system", default="lithos")
    d.add_argument("--engine", default=None, help="ref | vec")
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--poll", type=float, default=0.02)
    d.add_argument("--no-migration", action="store_true")
    d.add_argument("--validate", action="store_true")
    d.add_argument("--max-wall", type=float, default=None,
                   help="exit after this many wall seconds")
    d.add_argument("--exit-when-idle", action="store_true",
                   help="exit once no queued or live jobs remain")

    s = sub.add_parser("submit", help="queue a job")
    _add_state_dir(s)
    s.add_argument("--kind", default="train",
                   choices=["train", "serve", "llm_infer", "fwd_infer"])
    s.add_argument("--arch", default="olmo-1b")
    s.add_argument("--name", default=None)
    s.add_argument("--priority", default="be", choices=["be", "hp", "high"])
    s.add_argument("--quota", type=int, default=0,
                   help="pinned TPC slices (admission-controlled)")
    s.add_argument("--rps", type=float, default=0.0)
    s.add_argument("--duration", type=float, default=5.0,
                   help="work window in simulated seconds")
    s.add_argument("--slo", type=float, default=0.0,
                   help="SLO latency (seconds) for serve jobs")
    s.add_argument("--batch", type=int, default=1)
    s.add_argument("--decode-tokens", type=int, default=16)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--full-size", action="store_true",
                   help="use the full (non-reduced) model config")
    s.add_argument("--spec-json", default=None,
                   help="raw spec JSON; overrides the flags above")
    s.add_argument("--wait", action="store_true",
                   help="block until the job reaches a terminal state")
    s.add_argument("--timeout", type=float, default=120.0,
                   help="--wait timeout (wall seconds)")

    st = sub.add_parser("status", help="show job table (journal replay)")
    _add_state_dir(st)
    st.add_argument("job_id", nargs="?", default=None)
    st.add_argument("--json", action="store_true")

    c = sub.add_parser("cancel", help="cancel a job")
    _add_state_dir(c)
    c.add_argument("job_id")

    dr = sub.add_parser("drain", help="preempt live jobs and stop the daemon")
    _add_state_dir(dr)
    return ap


def _verb_daemon(args) -> int:
    from repro_torch.ctl.daemon import ControlPlane, DaemonConfig
    cp = ControlPlane(args.state_dir, DaemonConfig(
        n_devices=args.devices, device=args.device, n_slices=args.slices,
        system=args.system, engine=args.engine, seed=args.seed,
        poll_interval=args.poll, migration=not args.no_migration,
        validate=args.validate))
    cp.install_signal_handlers()
    print(f"ctl daemon pid={__import__('os').getpid()} "
          f"state_dir={cp.state_dir} devices={cp.node.n_devices} "
          f"recovered={sum(1 for j in cp.jobs.values() if j.recoveries)}",
          flush=True)
    cp.run(max_wall=args.max_wall, exit_when_idle=args.exit_when_idle)
    return 0


def _verb_submit(args) -> int:
    if args.spec_json:
        spec = json.loads(args.spec_json)
    else:
        spec = {"kind": args.kind, "arch": args.arch,
                "priority": args.priority, "quota_slices": args.quota,
                "rps": args.rps, "duration": args.duration,
                "slo_latency": args.slo, "batch": args.batch,
                "decode_tokens": args.decode_tokens, "seed": args.seed,
                "reduced": not args.full_size}
        if args.name:
            spec["name"] = args.name
    jid = store.request_submit(args.state_dir, spec)
    print(jid, flush=True)
    if not args.wait:
        return 0
    deadline = time.time() + args.timeout
    while time.time() < deadline:
        job = store.replay(args.state_dir).get(jid)
        if job is not None and job.state in TERMINAL:
            print(json.dumps(job.public(), indent=2))
            return 0 if job.state is JobState.DONE else 1
        time.sleep(0.1)
    print(f"timeout: {jid} not terminal after {args.timeout}s",
          file=sys.stderr)
    return 2


def _verb_status(args) -> int:
    jobs = store.replay(args.state_dir)
    hb = store.read_heartbeat(args.state_dir)
    if args.job_id is not None:
        job = jobs.get(args.job_id)
        if job is None:
            print(f"no such job: {args.job_id}", file=sys.stderr)
            return 1
        print(json.dumps(job.public(), indent=2))
        return 0
    table = [j.public() for j in
             sorted(jobs.values(), key=lambda j: j.submitted_wall)]
    if args.json:
        print(json.dumps({"daemon": hb, "jobs": table}, indent=2))
        return 0
    if hb is None:
        print("daemon: never ran here")
    else:
        state = "alive" if hb.get("alive") else "down"
        print(f"daemon: {state} pid={hb.get('pid')} "
              f"sim_now={hb.get('sim_now', 0):.3f} "
              f"events={hb.get('events', 0)}")
    fmt = "{:<18} {:<10} {:>4} {:>6}/{:<6} {:>6} {:>4} {:>4}  {}"
    print(fmt.format("JOB", "STATE", "DEV", "GRANT", "QUOTA",
                     "DONE", "RQ", "MIG", "NAME"))
    for row in table:
        res = row["result"] or {}
        print(fmt.format(
            row["job_id"][:18], row["state"],
            "-" if row["device"] is None else row["device"],
            row["granted"], row["quota"],
            res.get("n_completed", "-"), row["recoveries"],
            row["migrations"], row["name"]))
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.verb == "daemon":
        return _verb_daemon(args)
    if args.verb == "submit":
        return _verb_submit(args)
    if args.verb == "status":
        return _verb_status(args)
    if args.verb == "cancel":
        store.request_cancel(args.state_dir, args.job_id)
        print(f"cancel requested: {args.job_id}")
        return 0
    if args.verb == "drain":
        store.request_drain(args.state_dir)
        print("drain requested")
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
