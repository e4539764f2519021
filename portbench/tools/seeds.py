"""Runs of one cell on several seeds in one process, for setting limits:
the program's numbers on every seed, the fp8 control's on the first
``--control-seeds``, a planted fault's on the first ``--fault-seeds``.

    python3 portbench/tools/seeds.py --workload W --seeds 11,12,13
        --seconds 15 [--control-seeds 3] [--fault half_batch
        --fault-seeds 3]

Prints a ``seeds`` line per run and a summary: each number's largest
reading over the sound runs, the smallest of the control's and the
fault's, and whether the harness judged every sound run correct and every
control and fault run not correct.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src"), str(ROOT)]

import run  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control-seeds", type=int, default=0)
    p.add_argument("--fault", default=None)
    p.add_argument("--fault-seeds", type=int, default=0)
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    sound, control, fault, verdicts = [], [], [], []
    for i, seed in enumerate(seeds):
        args = ["--workload", a.workload, "--seed", str(seed),
                "--seconds", str(a.seconds), "--trace", "0"]
        if i < a.control_seeds:
            args += ["--control", "fp8"]
        res = run.main(args, t_start=time.perf_counter())
        prog = res.get("program", res)
        sound.append({k: v["value"] for k, v in prog["checks"].items()})
        line = {"seeds": "sound", "seed": seed, "correct": prog["correct"],
                **sound[-1]}
        if "program" in res:
            control.append({k: v["value"] for k, v in res["checks"].items()})
            line["control"] = {"correct": res["correct"], **control[-1]}
        verdicts.append(prog["correct"])
        if "program" in res:
            verdicts.append(not res["correct"])
        print(json.dumps(line), flush=True)
        if a.fault and i < a.fault_seeds:
            res = run.main(args[:8] + ["--fault", a.fault],
                           t_start=time.perf_counter())
            fault.append({k: v["value"] for k, v in res["checks"].items()})
            verdicts.append(not res["correct"])
            print(json.dumps({"seeds": a.fault, "seed": seed,
                              "correct": res["correct"], **fault[-1]}),
                  flush=True)
    summary = {"workload": a.workload, "runs": len(sound),
               "verdicts_as_expected": all(verdicts)}
    for name in sound[0]:
        summary[name] = {
            "lower": max(s[name] for s in sound),
            "control_min": min((c[name] for c in control), default=None),
            "fault_min": min((f[name] for f in fault), default=None)}
    print(json.dumps({"seeds": "summary", **summary}), flush=True)


if __name__ == "__main__":
    main()
