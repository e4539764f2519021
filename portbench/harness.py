"""What every run shares: finding a cell's files by name, the run's
context, the result line, the readers of per-layer metrics, and the check
that neither JAX nor the JAX package was loaded."""
from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

from portbench import counts

PB = Path(__file__).resolve().parent
ROOT = PB.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SMI_EVERY_MS = 2000     # nvidia-smi's samples beside the window


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` and the files it names."""

    def __init__(self, root: Path = ROOT):
        self.root = root
        self.pb = root / "portbench"
        self.spec = load_json(root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return load_json(self.root / c["file"])
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return load_json(self.pb / "traffic" / f"{name}.json")

    def limits(self, workload: str) -> dict:
        return load_json(self.pb / "limits" / f"{workload}.json")

    def driver(self, kind: str):
        return load_module(self.pb / "drivers" / f"{kind}.py",
                           f"portbench_driver_{kind}")

    def end_to_end(self, workload: str) -> list[dict]:
        return [m for m in self.spec["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        mine = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.spec["per_layer"]
                if workload in m.get("workloads", [workload])
                and m["moves"] in mine]

    def reader(self, metric: str):
        return load_module(self.pb / "metrics" / f"{metric}.py",
                           f"portbench_metric_{metric.replace('.', '_')}")


def arch_config(arch: dict):
    """The port's ``ArchConfig`` of a configuration file's ``arch``."""
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**arch)


def forbidden_modules() -> list[str]:
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


class Context:
    """One run: its arguments, cell files, set-up clock and earlier lines."""

    def __init__(self, *, t_start: float, seed: int, seconds: float,
                 trace: bool, cfg, arch: dict, mix: dict, control=None,
                 fault=None, device="cuda", out=print):
        import torch
        self.torch = torch
        self.device = device
        self.on_card = device == "cuda"
        self.t_start = t_start
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.cfg, self.arch, self.mix = cfg, arch, mix
        self.control, self.fault = control, fault
        self.check = True
        self.out = out
        self.parts: dict = {}
        self._mark = t_start
        self.profiled = None
        self.spans = None
        self._smi = None
        self.smi: dict = {}

    def sync(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize()

    def reset_peak(self) -> None:
        if self.on_card:
            self.torch.cuda.reset_peak_memory_stats()

    def peak(self) -> int:
        return self.torch.cuda.max_memory_allocated() if self.on_card else 0

    def empty_cache(self) -> None:
        if self.on_card:
            self.torch.cuda.empty_cache()

    def event(self):
        """A mark on the device's stream (the host clock off the card)."""
        if not self.on_card:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def elapsed_ms(a, b) -> float:
        return (b - a) * 1e3 if isinstance(a, float) else a.elapsed_time(b)

    def emit(self, tag: str, **kw) -> None:
        self.out(json.dumps({"pb": tag, **kw}, default=float))

    def part(self, name: str) -> None:
        now = time.perf_counter()
        self.parts[name] = now - self._mark
        self._mark = now

    def setup_done(self) -> float:
        """End of set-up: what it made is moved out of the collector's
        reach (``gc.freeze``), so no collection in the window walks it."""
        gc.collect()
        gc.freeze()
        setup_s = time.perf_counter() - self.t_start
        self.emit("setup", setup_s=setup_s, parts=self.parts)
        return setup_s

    def open_spans(self, torch):
        """The spans and the profiler of a ``--trace 1`` run; else None."""
        if not self.trace:
            return None
        from portbench import tracing
        tracing.warm_profiler(torch, self.on_card)
        self.spans = tracing.Spans(torch)
        start = self.mix.get("trace_start_s", 0.0)
        self.profiled = tracing.Profiled(torch, self.spans, start,
                                         self.mix.get("trace_s", math.inf),
                                         sync=self.sync, on_card=self.on_card)
        return self.spans

    def smi_start(self) -> None:
        if not self.on_card:
            return
        try:
            self._smi = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,"
                 "temperature.gpu,power.limit", "--format=csv,noheader,"
                 "nounits", "-lms", str(SMI_EVERY_MS)],
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self._smi = None

    def smi_stop(self) -> None:
        proc, self._smi = self._smi, None
        if proc is None:
            return
        proc.terminate()
        try:
            text, _ = proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            text, _ = proc.communicate()
        rows = []
        for line in text.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        names = ("clocks_sm_mhz", "power_draw_w", "temperature_c",
                 "power_limit_w")
        self.smi = {"samples": len(rows)}
        for i, n in enumerate(names):
            col = [r[i] for r in rows if len(r) > i]
            if col:
                self.smi[n] = {"min": min(col),
                               "median": statistics.median(col),
                               "max": max(col)}
        self.emit("nvidia_smi", **self.smi)


class Reading:
    """What a per-layer metric's reader gets: the traced window, the spans'
    records joined with the trace, the configuration, the mix, and what the
    driver timed on the host's clock (``host``)."""

    def __init__(self, trace, records: list, arch: dict, mix: dict,
                 host: dict | None = None):
        self.trace, self.arch, self.mix = trace, arch, mix
        self.host = host or {}
        self.w0, self.w1 = trace.window()
        self.window_s = (self.w1 - self.w0) * 1e-6
        self.busy_s = trace.busy_us(self.w0, self.w1) * 1e-6
        self.records = [r for r in records
                        if trace.present(f"{r['kind']}#{r['id']}")]

    def of(self, kind: str) -> list[dict]:
        return [r for r in self.records if r["kind"] == kind]

    def device_s(self, rec: dict) -> float:
        evs = self.trace.span_events(f"{rec['kind']}#{rec['id']}")
        return sum(e[1] - e[0] for e in evs) * 1e-6

    def end_to_end_s(self, rec: dict) -> float:
        """From the range's start on the host to the end of the last device
        event it launched."""
        t0, t1, _ = self.trace.ranges[f"{rec['kind']}#{rec['id']}"]
        evs = self.trace.span_events(f"{rec['kind']}#{rec['id']}")
        return (max([t1] + [e[1] for e in evs]) - t0) * 1e-6

    def roofline(self, kind: str):
        """Percent of the chip's roofline over every call of ``kind``: the
        sum of their bounds over the sum of their device times."""
        bound = dev = 0.0
        for r in self.of(kind):
            d = self.device_s(r)
            if d > 0:
                bound += counts.bound_s(r["flops"], r["bytes"])
                dev += d
        return 100.0 * bound / dev if dev > 0 else None

    def mfu(self, flops: float):
        if flops <= 0 or self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * flops / (self.window_s * counts.PEAK_BF16_FLOPS)

    def idle_share(self):
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        return {"device_ops": self.trace.top_ops(self.w0, self.w1),
                "idle_gaps": self.trace.idle_gaps(self.w0, self.w1)}


def judge(checks: dict, limits: dict) -> tuple[bool, dict]:
    """Every number compared against its limit: correct when each is
    finite and at most its limit, and every limit has its number."""
    out, ok = {}, True
    for name, limit in limits.items():
        value = checks.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        out[name] = {"value": value, "limit": limit}
    return ok, out
