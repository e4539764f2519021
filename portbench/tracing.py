"""Spans recorded from the benchmark's side, and the reading of a
profiler trace: kineto's record of the device and of the runtime calls
that launched its work, and on the host the benchmark's ranges alone.

``Spans`` wraps the module attributes the port calls (only in a
``--trace 1`` run): ``transformer.prefill`` and ``.decode_step``, the
attention entries ``flash_attention.ops.flash_attention`` and
``decode_attention.ops.decode_attention``, ``train.step.loss_and_grads``
and ``.adamw_update``, and the attention call under autograd
(``flash_attention.ops.FlashAttention``), whose backward is bracketed by
identity functions on its inputs and output.  Each call gets a record
(kind, id, and what the benchmark knows of its work: tokens, flops,
bytes) and a ``record_function`` range named ``pb.<kind>#<id>``; the
backward's range is two markers, ``pb.<kind>_begin#<id>`` and
``pb.<kind>_end#<id>``, on the autograd thread.

``read_trace`` takes the profiler's Chrome trace: device events (kernels,
copies, fills) are given to a range when the host call that launched them
lies inside its interval, on any thread: the autograd engine launches the
backward from a thread of its own while the range's thread waits in it.
"""
from __future__ import annotations

import bisect
import gzip
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

from portbench import counts

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
    """Installs the wrappers; ``records`` holds one dict per call."""

    def __init__(self, torch):
        self.torch = torch
        self.records: list[dict] = []
        self._undo: list = []
        self.decode_lens = None      # host lengths of the decode step under way

    def add(self, kind: str, **kw) -> int:
        self.records.append({"kind": kind, "id": len(self.records), **kw})
        return len(self.records) - 1

    def range(self, kind: str, **kw):
        rid = self.add(kind, **kw)
        return self.torch.profiler.record_function(f"pb.{kind}#{rid}")

    def marker(self, name: str):
        with self.torch.profiler.record_function(name):
            pass

    def patch(self, obj, attr: str, wrapper) -> None:
        orig = getattr(obj, attr)
        self._undo.append((obj, attr, orig))
        setattr(obj, attr, wrapper(orig))

    def close(self) -> None:
        for obj, attr, orig in reversed(self._undo):
            setattr(obj, attr, orig)
        self._undo.clear()

    # -- the port's layers -------------------------------------------------

    def serving(self, server) -> None:
        from repro_torch.kernels.decode_attention import ops as dops
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.models import transformer
        import numpy as np
        spans = self

        def prefill(orig):
            def call(params, cfg, tokens, **kw):
                with spans.range("prefill", tokens=int(tokens.numel()),
                                 S=int(tokens.shape[-1])):
                    return orig(params, cfg, tokens, **kw)
            return call

        def decode(orig):
            def call(params, cfg, token, pos, caches, **kw):
                lens = np.minimum(server.pos, server.sc.max_len - 1) + 1
                active = [int(n) for n, a in zip(lens, server.active) if a]
                spans.decode_lens = [int(n) for n in lens]
                try:
                    with spans.range("decode", rows=len(lens),
                                     active_lens=active):
                        return orig(params, cfg, token, pos, caches, **kw)
                finally:
                    spans.decode_lens = None
            return call

        self.patch(transformer, "prefill", prefill)
        self.patch(transformer, "decode_step", decode)
        self._flash_forward(fops)

        def k1(orig):
            def call(q, k_cache, v_cache, lens, **kw):
                host = spans.decode_lens or []
                fl, nb = counts.k1_counts(host, q.shape[1], k_cache.shape[2],
                                          q.shape[2], elem=q.element_size())
                with spans.range("k1", flops=fl, bytes=nb):
                    return orig(q, k_cache, v_cache, lens, **kw)
            return call

        self.patch(dops, "decode_attention", k1)

    def _flash_forward(self, fops) -> None:
        spans = self

        def k2(orig):
            def call(q, k, v, *, causal=True, window=0, return_lse=False,
                     **kw):
                B, Sq, Hq, D = q.shape
                fl, nb = counts.k2_counts(B, Sq, k.shape[1], Hq, k.shape[2],
                                          D, causal=causal, window=window,
                                          elem=q.element_size(),
                                          lse=return_lse)
                with spans.range("k2", flops=fl, bytes=nb):
                    return orig(q, k, v, causal=causal, window=window,
                                return_lse=return_lse, **kw)
            return call

        self.patch(fops, "flash_attention", k2)

    def training(self) -> None:
        from repro_torch.kernels.flash_attention import ops as fops
        from repro_torch.train import step
        torch = self.torch
        spans = self

        def fwdbwd(orig):
            def call(cfg, tc, params, batch):
                tok = batch["labels"]
                with spans.range("fwdbwd", tokens=int(tok.numel())):
                    return orig(cfg, tc, params, batch)
            return call

        def optimizer(orig):
            def call(*a, **kw):
                with spans.range("optimizer"):
                    return orig(*a, **kw)
            return call

        self.patch(step, "loss_and_grads", fwdbwd)
        self.patch(step, "adamw_update", optimizer)
        self._flash_forward(fops)

        class Enter(torch.autograd.Function):
            @staticmethod
            def forward(ctx, rid, q, k, v):
                ctx.rid = rid
                return q.view_as(q), k.view_as(k), v.view_as(v)

            @staticmethod
            def backward(ctx, dq, dk, dv):
                spans.marker(f"pb.k2bwd_end#{ctx.rid}")
                return None, dq, dk, dv

        class Leave(torch.autograd.Function):
            @staticmethod
            def forward(ctx, rid, o):
                ctx.rid = rid
                return o.view_as(o)

            @staticmethod
            def backward(ctx, do):
                spans.marker(f"pb.k2bwd_begin#{ctx.rid}")
                return None, do

        def bracket(orig):
            class Bracketed:
                @staticmethod
                def apply(q, k, v, causal=True, window=0):
                    B, S, Hq, D = q.shape
                    fl, nb = counts.k2bwd_counts(
                        B, S, Hq, k.shape[2], D, causal=causal,
                        window=window, elem=q.element_size())
                    rid = spans.add("k2bwd", flops=fl, bytes=nb)
                    q, k, v = Enter.apply(rid, q, k, v)
                    return Leave.apply(rid, orig.apply(q, k, v, causal,
                                                       window))
            return Bracketed

        self.patch(fops, "FlashAttention", bracket)


def _activities(torch, on_card: bool) -> set:
    from torch._C._profiler import ProfilerActivity
    return {ProfilerActivity.CPU} | (
        {ProfilerActivity.CUDA} if on_card else set())


def start_profiler(torch, on_card: bool) -> None:
    """Kineto with the CUDA activity (kernels, copies and the runtime calls
    that launched them) and, on the host, the benchmark's own ranges alone:
    no event for each of the port's operators, whose recording would
    double a host-bound decode step."""
    from torch._C._profiler import (ProfilerConfig, ProfilerState,
                                    RecordScope, _ExperimentalConfig)
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False,
                            False, False, _ExperimentalConfig())
    acts = _activities(torch, on_card)
    torch.autograd._prepare_profiler(config, acts)
    torch.autograd._enable_profiler(config, acts, {RecordScope.USER_SCOPE})


def stop_profiler(torch):
    """The profiler's result (``.save(path)`` writes the Chrome trace)."""
    return torch.autograd._disable_profiler()


def warm_profiler(torch, on_card: bool) -> None:
    """Open and close the profiler once over one small operation, so that
    its first start (CUPTI's set-up, seconds) falls before the window."""
    start_profiler(torch, on_card)
    x = torch.ones(8, device="cuda" if on_card else "cpu")
    (x + 1).sum().item()
    stop_profiler(torch)


class Profiled:
    """The profiler (``start_profiler``) opened by ``begin`` and closed by
    ``end``, with a ``pb.window`` range around what it sees; ``read`` gives
    its ``Trace`` after the window.  ``tick(elapsed)`` opens it at
    ``start_s`` and closes it ``length_s`` later (a loop calls it between
    its steps)."""

    def __init__(self, torch, spans: Spans, start_s: float = 0.0,
                 length_s: float = float("inf"), sync=None, on_card=True):
        self.torch, self.spans, self.on_card = torch, spans, on_card
        self.sync = sync or torch.cuda.synchronize
        self.start_s, self.length_s = start_s, length_s
        self.range = self.result = self.trace = None
        self.open = self.done = False

    def begin(self) -> None:
        self.sync()
        start_profiler(self.torch, self.on_card)
        self.open = True
        self.range = self.spans.range("window")
        self.range.__enter__()

    def end(self) -> None:
        if not self.open:
            return
        self.sync()
        self.range.__exit__(None, None, None)
        self.result = stop_profiler(self.torch)
        self.open, self.done = False, True

    def read(self):
        """The ``Trace`` of what the profiler saw, read once the window has
        closed (the export takes seconds, so never inside it)."""
        self.end()
        if self.trace is None and self.result is not None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.result.save(path)
                self.trace = read_trace(path)
            finally:
                os.unlink(path)
            self.result = None
        return self.trace

    def tick(self, elapsed: float) -> None:
        if not (self.open or self.done) and elapsed >= self.start_s:
            self.begin()
        elif self.open and elapsed >= self.start_s + self.length_s:
            self.end()


@dataclass
class Trace:
    device: list            # (start_us, end_us, name, launch_us, tid)
    ranges: dict            # "kind#id" -> (start_us, end_us, tid)
    markers: dict           # "kind_begin#id" / "kind_end#id" -> (us, tid)
    ops: dict               # tid -> sorted [(start_us, end_us, name)]
    annotations: dict = field(default_factory=dict)  # tid -> sorted ranges

    def __post_init__(self):
        evs = sorted(self.device, key=lambda e: e[3])
        self._by_launch = ([e[3] for e in evs], evs)
        self._spans = sorted(s for v in self.annotations.values() for s in v
                             if not s[2].startswith("window#"))

    def launched(self, t0: float, t1: float) -> list:
        """Device events launched, on any thread, in [t0, t1]."""
        keys, evs = self._by_launch
        return evs[bisect.bisect_left(keys, t0):bisect.bisect_right(keys, t1)]

    def span_events(self, key: str) -> list:
        """Device events of range ``kind#id``, or of the pair of markers
        ``kind_begin#id`` .. ``kind_end#id``."""
        if key in self.ranges:
            t0, t1, _ = self.ranges[key]
            return self.launched(t0, t1)
        kind, rid = key.split("#")
        b = self.markers.get(f"{kind}_begin#{rid}")
        e = self.markers.get(f"{kind}_end#{rid}")
        if b is None or e is None:
            return []
        return self.launched(b[0], e[0])

    def present(self, key: str) -> bool:
        kind, rid = key.split("#")
        return key in self.ranges or f"{kind}_begin#{rid}" in self.markers

    def window(self) -> tuple[float, float]:
        wins = [v for k, v in self.ranges.items() if k.startswith("window#")]
        if not wins:
            raise ValueError("the trace holds no window range")
        return wins[0][0], wins[0][1]

    def busy_us(self, t0: float, t1: float) -> float:
        """Union of device activity within [t0, t1]."""
        total, end = 0.0, t0
        for s, e, *_ in sorted(self.device):
            s, e = max(s, end), min(e, t1)
            if e > s:
                total += e - s
                end = e
        return total

    def top_ops(self, t0: float, t1: float, n: int = 10) -> list:
        by = defaultdict(float)
        for s, e, name, *_ in self.device:
            if s >= t0 and e <= t1:
                by[name[:64]] += (e - s) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda r: -r[1])[:n]

    def idle_gaps(self, t0: float, t1: float, n: int = 10) -> list:
        """Idle gaps of the device in [t0, t1], summed by what the host
        was doing when it launched the work that ended each gap: the
        innermost ``pb.`` range around that launch (on any thread), and the
        innermost operator around it on the launching thread where the
        trace records operators, else the device operation launched."""
        evs = sorted(e for e in self.device if e[0] >= t0 and e[1] <= t1)
        by = defaultdict(float)
        end = t0
        for s, e, name, launch, tid in evs:
            if s > end:
                by[self._label(tid, launch, name)] += (s - end) * 1e-6
            end = max(end, e)
        if t1 > end:
            by["(after the last launch)"] += (t1 - end) * 1e-6
        return sorted(([k, v] for k, v in by.items()),
                      key=lambda r: -r[1])[:n]

    def _label(self, tid, t: float, launched: str) -> str:
        def innermost(items):
            i = bisect.bisect_right(items, (t, float("inf"), ""))
            for s, e, name in reversed(items[max(0, i - 4000):i]):
                if e >= t:
                    return name
            return None

        span = innermost(self._spans)
        op = innermost(self.ops.get(tid, []))
        span = span.split("#")[0] if span else "(no span)"
        return f"{span}___{op or launched[:48]}"


def read_trace(path: str) -> Trace:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    launches = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(ev["ts"]), ev.get("tid"))
    device, ranges, markers = [], {}, {}
    ops, ann = defaultdict(list), defaultdict(list)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat"), ev.get("name", "")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat in DEVICE_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            launch = launches.get(corr)
            if launch is not None:
                device.append((ts, ts + dur, name, launch[0], launch[1]))
        elif cat == "user_annotation" and name.startswith("pb."):
            key = name[3:]
            kind = key.split("#")[0]
            if kind.endswith("_begin") or kind.endswith("_end"):
                markers[key] = (ts, ev.get("tid"))
            else:
                ranges[key] = (ts, ts + dur, ev.get("tid"))
                ann[ev.get("tid")].append((ts, ts + dur, name[3:]))
        elif cat == "cpu_op":
            ops[ev.get("tid")].append((ts, ts + dur, name))
    for d in (ops, ann):
        for v in d.values():
            v.sort()
    return Trace(device, ranges, markers, dict(ops), dict(ann))
