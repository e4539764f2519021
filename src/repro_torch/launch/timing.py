"""Device time of a piece of GPU work, with no host gap inside it.

PyTorch returns before the device has run what it enqueued, so a host clock
measures the enqueue.  ``device_ms`` puts CUDA events around the work and,
before the first event, keeps the stream busy with a spinning kernel for
longer than the host takes to enqueue the work: the device then finds all of
it queued and never waits for Python between the events.  The spin is scaled
to the work's own enqueue time (at least 1 ms, 1.5x that time), because a
schedule of many atoms takes milliseconds to enqueue.
"""
from __future__ import annotations

import time

import torch

SPIN_MIN_MS = 1.0
SPIN_OVER_HOST = 1.5


def enqueue_ms(fn, *, iters: int = 20) -> float:
    """Host time to enqueue one call of ``fn`` (no wait for the device)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def spin_cycles_per_ms() -> float:
    """Cycles of ``torch.cuda._sleep`` the device spins through in 1 ms."""
    cycles = 1_000_000
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)                  # warm up
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    torch.cuda.synchronize()
    return cycles / a.elapsed_time(b)


def device_ms(fn, *, iters: int, flush=None) -> float:
    """Median device time of one call of ``fn`` over ``iters`` calls, each
    between its own pair of CUDA events, with the stream kept busy before
    the first event for ``max(SPIN_MIN_MS, SPIN_OVER_HOST x enqueue time)``.
    ``flush`` (a buffer larger than the L2 cache) is overwritten before each
    call so that it finds the cache cold; without it the inputs stay in the
    cache from the call before."""
    for _ in range(3):
        fn()
    host = enqueue_ms(fn, iters=3)
    cycles = int(max(SPIN_MIN_MS, SPIN_OVER_HOST * host)
                 * spin_cycles_per_ms())
    times = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]
