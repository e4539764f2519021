"""Spans at the boundaries of the serving engine and the trainer, recorded
only while a profiler records.

``span(name, **attrs)`` is a context manager.  Its first act is to ask
whether a profiler is on (one C call); while none is, it returns a shared
null context that records nothing, reads no clock and allocates nothing.
While one is, the span opens a ``torch.profiler.record_function(name)``
range, so it lands in the profiler's trace (category ``user_annotation``)
on the clock of the device's events, and it appends a record to an
in-memory ring that keeps the newest ``CAPACITY`` records:

    name, id, parent (the id of the enclosing span on this thread),
    rid (the request the span serves, or None), t0_ns / t1_ns
    (``time.perf_counter_ns``), attrs (the counts at that boundary),
    device_ms (spans opened with ``device=True``, on a card only)

``device_ms`` comes from two CUDA events recorded on the current stream at
the span's open and close, taken from a pool; they are resolved only by
``records()``, never inside the traced work.

How an operator sees them: open a profiler around the server or the
trainer, export its Chrome trace, and read the records::

    with torch.profiler.profile() as prof:
        server.run_until_drained()          # or train_step(state, batch)
    prof.export_chrome_trace("trace.json")  # engine.* / train.* ranges
    for rec in spans.records():
        ...

The program's spans: ``serve/engine.py`` (``engine.step``, ``.queue``,
``.admit``, ``.prefill``, ``.decode``, ``.readback``, ``.bookkeep``) and
``train/step.py`` (``train.forward``, ``.backward``, ``.optimizer``).
"""
from __future__ import annotations

import collections
import itertools
import threading
import time

import torch

CAPACITY = 1 << 17

_profiling = torch._C._autograd._profiler_enabled
_ring: collections.deque = collections.deque(maxlen=CAPACITY)
_ids = itertools.count()
_open = threading.local()       # .stack: ids of the spans open on a thread
_events: list = []              # CUDA events free for the next device span


class _Null:
    """What a span is while no profiler records: false, and does nothing."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


NULL = _Null()


def _stack() -> list:
    stack = getattr(_open, "stack", None)
    if stack is None:
        stack = _open.stack = []
    return stack


def _record(name: str, rid, attrs: dict) -> dict:
    stack = _stack()
    return {"name": name, "id": next(_ids),
            "parent": stack[-1] if stack else None, "rid": rid,
            "t0_ns": None, "t1_ns": None, "attrs": attrs, "device_ms": None}


def _event():
    return _events.pop() if _events else torch.cuda.Event(enable_timing=True)


class Span:
    """An open span (``span`` gives one while a profiler records); true,
    unlike ``NULL``.  ``set(**attrs)`` adds counts known only inside it."""
    __slots__ = ("rec", "_range", "_marks")

    def __init__(self, name: str, rid, device: bool, attrs: dict):
        self.rec = _record(name, rid, attrs)
        self._range = torch.profiler.record_function(name)
        self._marks = [] if device and torch.cuda.is_initialized() else None

    def set(self, **attrs) -> None:
        self.rec["attrs"].update(attrs)

    def __enter__(self):
        self._range.__enter__()
        _stack().append(self.rec["id"])
        if self._marks is not None:
            self._marks.append(_event())
            self._marks[0].record()
        self.rec["t0_ns"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.rec["t1_ns"] = time.perf_counter_ns()
        if self._marks is not None:
            self._marks.append(_event())
            self._marks[1].record()
            self.rec["_marks"] = self._marks
        _stack().pop()
        _ring.append(self.rec)
        self._range.__exit__(*exc)
        return False


def span(name: str, *, rid=None, device: bool = False, **attrs):
    """A span named ``name`` while a profiler records, else ``NULL``.
    ``device=True`` also times the span's work on the current CUDA stream."""
    if not _profiling():
        return NULL
    return Span(name, rid, device, attrs)


def record(name: str, t0_ns: int, *, rid=None, **attrs) -> None:
    """A span that began at ``t0_ns`` (stamped earlier on
    ``time.perf_counter_ns``) and ends now, under the span open on this
    thread.  Its range in the profiler's trace can only begin now, so
    there it is a mark at its end; the record holds the whole interval."""
    if not _profiling():
        return
    rec = _record(name, rid, attrs)
    with torch.profiler.record_function(name):
        rec["t0_ns"], rec["t1_ns"] = t0_ns, time.perf_counter_ns()
    _ring.append(rec)


def records() -> list[dict]:
    """Every record in the ring, oldest first, as new dicts.  Synchronizes
    once if a device span is still unresolved; clears nothing."""
    pending = [r for r in _ring if "_marks" in r]
    if pending:
        torch.cuda.synchronize()
    for r in pending:
        start, end = r.pop("_marks")
        r["device_ms"] = start.elapsed_time(end)
        _events.extend((start, end))
    return [dict(r, attrs=dict(r["attrs"])) for r in _ring]


def clear() -> None:
    """Empty the ring."""
    _ring.clear()
