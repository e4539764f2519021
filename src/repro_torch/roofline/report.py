"""Roofline report: reads the port's dry-run cells
(``reports/dryrun_torch/<mesh>/``, written by ``launch/dryrun.py``) and
prints the roofline table and a summary, as the JAX package's report does
for its own cells.

    PYTHONPATH=src python -m repro_torch.roofline.report [--mesh pod16x16]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

REPORT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                          "reports", "dryrun_torch")


def load_cells(mesh: str) -> list[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(REPORT_DIR, mesh, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.1f}ms"
    return f"{x*1e6:.0f}us"


def fmt_b(x) -> str:
    if x is None:
        return "-"
    for unit, div in (("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def roofline_table(mesh: str, markdown: bool = True) -> str:
    cells = load_cells(mesh)
    lines = []
    hdr = ("| arch | shape | dom | t_comp | t_mem | t_coll | useful | "
           "frac | HBM/dev | status |")
    sep = "|" + "---|" * 10
    lines.append(hdr)
    lines.append(sep)
    for c in cells:
        if c["status"] == "skipped":
            lines.append(f"| {c['arch']} | {c['shape']} | - | - | - | - | "
                         f"- | - | - | skip: {c['reason'][:40]} |")
            continue
        if c["status"] != "ok":
            lines.append(f"| {c['arch']} | {c['shape']} | - | - | - | - | "
                         f"- | - | - | ERROR |")
            continue
        r = c["roofline"]
        mem = c["memory"].get("temp_bytes")
        lines.append(
            f"| {c['arch']} | {c['shape']} | {r['dominant'][:4]} | "
            f"{fmt_s(r['t_compute_s'])} | {fmt_s(r['t_memory_s'])} | "
            f"{fmt_s(r['t_collective_s'])} | {r['useful_ratio']:.2f} | "
            f"{r['roofline_fraction']:.3f} | {fmt_b(mem)} | ok |")
    return "\n".join(lines)


def summary(mesh: str) -> dict:
    cells = [c for c in load_cells(mesh) if c["status"] == "ok"]
    doms = {}
    for c in cells:
        doms[c["roofline"]["dominant"]] = doms.get(
            c["roofline"]["dominant"], 0) + 1
    worst = sorted(cells, key=lambda c: c["roofline"]["roofline_fraction"])
    most_coll = sorted(cells, key=lambda c: -c["roofline"]["t_collective_s"])
    return {
        "n_ok": len(cells),
        "dominant_counts": doms,
        "worst_fraction": [(c["arch"], c["shape"],
                            round(c["roofline"]["roofline_fraction"], 4))
                           for c in worst[:5]],
        "most_collective_bound": [(c["arch"], c["shape"],
                                   round(c["roofline"]["t_collective_s"], 3))
                                  for c in most_coll[:5]],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod16x16")
    args = ap.parse_args()
    print(f"## Roofline — {args.mesh}\n")
    print(roofline_table(args.mesh))
    print("\n## Summary\n")
    print(json.dumps(summary(args.mesh), indent=1))


if __name__ == "__main__":
    main()
