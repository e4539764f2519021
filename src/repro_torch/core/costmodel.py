"""Ground-truth latency model for the discrete-event simulator.

The simulator executes :class:`KernelTask`s on a :class:`DeviceSpec` whose
latencies come from a first-principles roofline model — *not* from fitting
the paper's curves — so the OS policies (which only observe completions)
face the same learning problem as on real hardware.

Latency of a kernel on ``t`` slices at relative frequency ``f``::

    t_eff  = min(t, ceil(n_blocks / occupancy))        # parallelism bound
    waves  = ceil(n_blocks / (t_eff * occupancy))      # wave quantization
    c_time = flops / (t_eff*occ_waves ... )            -- expressed per-wave:
    per-block compute = flops/n_blocks / (peak/occupancy) / f
    per-block memory  = bytes/n_blocks / (bw/occupancy)
    block_time = max(per-block compute, per-block memory)
    latency = waves * occupancy * block_time ... simplified to:
    latency = max(flops/(f*peak), bytes/bw) / t_eff * quant(t_eff) + overhead

where ``quant`` is the wave-quantization factor (ceil effects) and compute
scales with frequency while HBM bandwidth does not.  This reproduces the
qualitative behaviours the paper's mechanisms exploit:

* Amdahl-style TPC scaling ``l = m/t + b`` (§4.5) with per-kernel m, b;
* frequency-insensitivity of memory-bound kernels (§4.6);
* an occupancy-derived upper bound on useful slices (the filtering
  heuristic's ground truth);
* tail/wave effects that make tiny kernels hard to model (the outliers the
  filtering heuristic exists for).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.types import DeviceSpec, KernelWork


@dataclass(frozen=True)
class WorkPhases:
    """A kernel reduced to simulator drain terms.

    ``c_work``  compute term in slice-seconds at f_max
    ``m_work``  memory term in slice-seconds
    ``overhead``fixed, allocation-independent launch/tail seconds
    ``max_useful_slices`` parallelism bound from the grid
    """

    c_work: float
    m_work: float
    overhead: float
    n_blocks: int
    max_useful_slices: int

    def divisible_time(self, t: int, f: float, occupancy: int) -> float:
        """Time for the divisible phase on ``t`` slices at rel. freq ``f``."""
        t_eff = max(1, min(t, self.max_useful_slices))
        quant = self.quantization(t_eff, occupancy)
        return max(self.c_work / f, self.m_work) / t_eff * quant

    def quantization(self, t_eff: int, occupancy: int) -> float:
        """Wave-quantization factor >= 1 (ceil of blocks into waves)."""
        per_wave = t_eff * occupancy
        waves = math.ceil(self.n_blocks / per_wave)
        ideal_waves = self.n_blocks / per_wave
        return waves / ideal_waves if ideal_waves > 0 else 1.0

    def latency(self, t: int, f: float, occupancy: int) -> float:
        return self.overhead + self.divisible_time(t, f, occupancy)


class CostModel:
    """Maps :class:`KernelWork` onto :class:`WorkPhases` for a device."""

    def __init__(self, device: DeviceSpec):
        self.device = device
        # phases() is on the per-dispatch hot path; KernelWork is an
        # unhashable dataclass but (flops, bytes, n_blocks) is its full
        # identity for this map.  WorkPhases is frozen, so sharing one
        # instance across dispatches is safe.  Op diversity per trace is
        # small and bounded, so the cache never grows past a few hundred
        # entries even on million-request runs.
        self._phase_cache: dict[tuple, WorkPhases] = {}

    def phases(self, work: KernelWork) -> WorkPhases:
        key = (work.flops, work.bytes, work.n_blocks)
        ph = self._phase_cache.get(key)
        if ph is not None:
            return ph
        d = self.device
        c_work = work.flops / d.peak_flops          # slice-seconds at f_max
        m_work = work.bytes / d.hbm_bw              # slice-seconds
        max_useful = max(1, math.ceil(work.n_blocks / d.occupancy))
        ph = WorkPhases(
            c_work=c_work,
            m_work=m_work,
            overhead=d.launch_overhead,
            n_blocks=max(1, work.n_blocks),
            max_useful_slices=max_useful,
        )
        self._phase_cache[key] = ph
        return ph

    def latency(self, work: KernelWork, t: int, f: float = 1.0) -> float:
        return self.phases(work).latency(t, f, self.device.occupancy)

    def energy(self, work: KernelWork, t: int, f: float = 1.0) -> float:
        """Energy attributable to this kernel alone (active-slice dynamic
        power over its duration) — used for per-kernel reporting; the
        simulator integrates true device power over time."""
        lat = self.latency(work, t, f)
        t_eff = min(t, self.phases(work).max_useful_slices)
        return lat * t_eff * self.device.p_dyn * f ** 3

    # Convenience ground-truth inspectors (benchmarks/tests only — the OS
    # never calls these).
    def is_compute_bound(self, work: KernelWork, f: float = 1.0) -> bool:
        return work.flops / (self.device.peak_flops * f) >= work.bytes / self.device.hbm_bw

    def arithmetic_intensity(self, work: KernelWork) -> float:
        return work.flops / max(1.0, work.bytes)
