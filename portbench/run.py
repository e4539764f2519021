"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  Earlier lines of standard output are JSON
objects tagged ``"pb"`` (set-up parts, the window, nvidia-smi samples, the
check); the last is the result.  The numbers compared with their limits
are also the last lines of standard error.  ``--control fp8`` puts the
fp8 reference in the program's place: its numbers are judged against the
cell's limits and give ``correct`` (the program's own verdict of the same
run under ``program``); ``--fault`` plants a fault in the timed path.
Both are tools for setting limits, which the benchmark's own runs never
pass.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    one CPU thread for the host's own operators (the load comes from one
    process with few threads)."""
    os.environ["OMP_NUM_THREADS"] = "1"
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "kernels")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("fp8",), default=None)
    p.add_argument("--fault", choices=("half_batch", "unchanged"),
                   default=None, help="training cells: a fault planted in "
                   "the timed step")
    return p.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None, *, t_start: float = T_START, require_cuda: bool = True):
    args = parse(argv)
    cache_env(ROOT)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench import harness
    bench = harness.Bench(ROOT)
    cell = bench.cell(args.workload)
    conf = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    limits = bench.limits(cell["name"])
    driver = bench.driver(mix["kind"])
    import torch
    torch.set_num_threads(1)
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        fail(f"needs {cell['chips']} CUDA device(s); found "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cfg = harness.arch_config(conf["arch"])
    ctx = harness.Context(t_start=t_start, seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          cfg=cfg, arch=conf["arch"], mix=mix,
                          control=args.control, fault=args.fault,
                          device="cuda" if require_cuda else "cpu")
    if require_cuda:
        ctx.emit("device", name=torch.cuda.get_device_name(0),
                 count=torch.cuda.device_count(), torch=torch.__version__,
                 cuda=torch.version.cuda)
    res = driver.run(ctx)
    result = compose(bench, cell, ctx, res, limits, torch, require_cuda)
    found = harness.forbidden_modules()
    if found:
        fail(f"modules loaded that the port must not load: {found}", 3)
    for name, c in result.get("program", {}).get("checks", {}).items():
        print(f"program {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return result


def compose(bench, cell, ctx, res, limits, torch, on_card: bool) -> dict:
    from portbench import harness
    correct, checks = harness.judge(res["checks"], limits)
    correct = correct and res["failed"] == 0
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "count": cell["chips"],
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    out = {"correct": bool(correct), "attempted": res["attempted"],
           "failed": res["failed"], "metrics": {}, "device": device}
    if ctx.trace:
        trace = ctx.profiled.read()
        reading = harness.Reading(trace, res["records"], ctx.arch, ctx.mix,
                                  host=res.get("host"))
        ctx.emit("trace", device_events=len(trace.device),
                 ranges=len(trace.ranges), markers=len(trace.markers),
                 records=len(res["records"]),
                 records_in_window=len(reading.records))
        device["busy_s"] = reading.busy_s
        device["window_s"] = reading.window_s
        for m in bench.per_layer(cell["name"]):
            value = bench.reader(m["name"]).read(reading)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        out["breakdown"] = reading.breakdown()
    else:
        for m in bench.end_to_end(cell["name"]):
            out["metrics"][m["name"]] = {"value": res["metrics"][m["name"]],
                                         "unit": m["unit"]}
    if ctx.control:
        out["program"] = {"correct": bool(correct), "checks": checks}
        control_ok, checks = harness.judge(res["control"], limits)
        out["correct"] = bool(control_ok and res["failed"] == 0)
    out["checks"] = checks
    return out


if __name__ == "__main__":
    main()
