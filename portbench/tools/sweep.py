"""One sweep of a serving cell's arrival rate, to find its knee: the
cell's mix at each rate of ``--rates`` for ``--seconds``, in one process,
with no check of the outputs.

    python3 portbench/tools/sweep.py --workload W --rates 2,3,4 --seconds 30

A ``window`` line per rate: requests, the largest queue, TTFT and ITL
percentiles, and how long past the close the last request finished.
"""
import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT / "portbench"), str(ROOT / "src"), str(ROOT)]

import run  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seed", type=int, default=1)
    a = p.parse_args(argv)
    run.cache_env(ROOT)
    from portbench import harness
    bench = harness.Bench(ROOT)
    cell = bench.cell(a.workload)
    conf = bench.config(cell["config"])
    driver = bench.driver("serve")
    for rate in (float(r) for r in a.rates.split(",")):
        mix = dict(bench.traffic(cell["traffic"]), rate_per_s=rate)
        ctx = harness.Context(t_start=time.perf_counter(), seed=a.seed,
                              seconds=a.seconds, trace=False,
                              cfg=harness.arch_config(conf["arch"]),
                              arch=conf["arch"], mix=mix)
        ctx.check = False
        driver.run(ctx)


if __name__ == "__main__":
    main()
