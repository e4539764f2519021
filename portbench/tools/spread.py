"""Spreads of a set of runs: for each metric of the result lines in the
given logs, the median and the distance between the first and third
quartiles (``statistics.quantiles(values, n=4)``) as a share of it.

    python3 portbench/tools/spread.py set1.log [more logs]
"""
import json
import statistics
import sys


def results(path: str) -> list[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{") and '"correct"' in line:
                out.append(json.loads(line))
    return out


def spread(values: list[float]) -> tuple[float, float]:
    q1, med, q3 = statistics.quantiles(values, n=4)
    return statistics.median(values), (q3 - q1) / statistics.median(values)


def main(paths):
    for path in paths:
        rs = results(path)
        print(path, "runs", len(rs), "correct", sum(r["correct"] for r in rs))
        names = sorted({k for r in rs for k in r["metrics"]})
        for n in names:
            vals = [r["metrics"][n]["value"] for r in rs if n in r["metrics"]]
            if len(vals) >= 2:
                med, sp = spread(vals)
                print(f"  {n}: median {med!r} spread {sp!r} values {vals!r}")


if __name__ == "__main__":
    main(sys.argv[1:])
