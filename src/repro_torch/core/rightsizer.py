"""§4.5 Hardware right-sizing.

Per operator node, fit the Amdahl curve ``l(t) = m/t + b`` from two online
observations — latency with the full allocation and with one slice — then
pick the minimal ``t`` whose predicted slowdown vs. the full allocation stays
within the *latency slip* factor ``k`` (e.g. 1.1 = 10%).

Outlier filtering: before the model is consulted, an occupancy bound caps
useful slices at ``ceil(n_blocks / occupancy)`` — tiny grids cannot use a
large allocation no matter what the curve says.  The atomizer's block counts
provide n_blocks; occupancy comes from the device spec (thread blocks
resident per slice, as the CUDA occupancy API reports them).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.types import CompletionRecord, KernelTask


@dataclass
class ScalingFit:
    m: float = 0.0
    b: float = 0.0
    # raw two-point observations: slices -> latency
    points: dict[int, float] = field(default_factory=dict)
    fitted: bool = False

    def latency(self, t: int) -> float:
        return self.m / max(1, t) + self.b

    def r_squared(self, obs: dict[int, float]) -> float:
        if len(obs) < 2:
            return 1.0
        ys = list(obs.values())
        mean = sum(ys) / len(ys)
        ss_tot = sum((y - mean) ** 2 for y in ys) or 1e-24
        ss_res = sum((y - self.latency(t)) ** 2 for t, y in obs.items())
        return 1.0 - ss_res / ss_tot


class RightSizer:
    """Online per-node Amdahl fitting + slip-bounded allocation shrinking."""

    def __init__(self, full_slices: int, occupancy: int, slip: float = 1.1):
        self.full = full_slices
        self.occupancy = occupancy
        self.slip = slip
        self.fits: dict[tuple[int, int], ScalingFit] = {}
        self.extra_obs: dict[tuple[int, int], dict[int, float]] = {}
        # KV-cache memory floor per client (cid -> min slices): a tenant
        # whose KV footprint needs N slices' worth of HBM can never be
        # right-sized below N — shrinking its compute share below its
        # memory share would evict live cache.  Maintained by the
        # scheduler from Client.kv_bytes; relaxes as requests complete.
        self.memory_floor: dict[int, int] = {}

    def set_memory_floor(self, cid: int, floor: int):
        if floor > 1:
            self.memory_floor[cid] = floor
        else:
            self.memory_floor.pop(cid, None)

    # -- learning -------------------------------------------------------------

    def observe(self, rec: CompletionRecord):
        task = rec.task
        lat = rec.latency
        if task.atom_of is not None:
            _, _, n = task.atom_of
            lat = lat * n                      # full-kernel equivalent
        if rec.freq < 0.999:
            return                             # fit at f_max only
        fit = self.fits.setdefault(task.key(), ScalingFit())
        fit.points[rec.slices] = lat
        self.extra_obs.setdefault(task.key(), {})[rec.slices] = lat
        if len(fit.points) >= 2 and not fit.fitted:
            self._fit(fit)

    def _fit(self, fit: ScalingFit):
        # two-point fit per the paper: prefer (max slices, min slices)
        ts = sorted(fit.points)
        t_lo, t_hi = ts[0], ts[-1]
        if t_lo == t_hi:
            return
        l_lo, l_hi = fit.points[t_lo], fit.points[t_hi]
        m = (l_lo - l_hi) / (1.0 / t_lo - 1.0 / t_hi)
        b = l_hi - m / t_hi
        fit.m, fit.b = max(m, 0.0), max(b, 0.0)
        fit.fitted = True

    # -- probing protocol -------------------------------------------------------

    def probe_allocation(self, task: KernelTask, default: int,
                         predicted_full: Optional[float] = None,
                         probe_latency_cap: float = 25e-3) -> Optional[int]:
        """If this node still needs a calibration point, return the slice
        count to run it at (full first, then the low point); else None.

        The low point is 1 slice per the paper; for kernels whose 1-slice
        run would exceed ``probe_latency_cap`` (long kernels on short
        serving deadlines) the low point is raised so the probe stays
        bounded — the two-point fit works from any two distinct points."""
        fit = self.fits.get(task.key())
        if fit is None or not fit.points:
            return min(default, self.occupancy_bound(task), self.full)
        if not fit.fitted:
            have = set(fit.points)
            low = 1
            if predicted_full is not None:
                t_hi = max(have)
                est_1 = predicted_full * t_hi
                if est_1 > probe_latency_cap:
                    low = max(1, math.ceil(est_1 / probe_latency_cap))
                    if low > t_hi // 2:
                        # a bounded probe would land too close to t_hi for
                        # a usable two-point fit (wave-quantization noise
                        # dominates adjacent points) — leave this kernel
                        # unfitted; the occupancy filter still applies
                        fit.m, fit.b = 0.0, fit.points[t_hi]
                        fit.fitted = True
                        return None
            if low not in have:
                return low
        return None

    # -- allocation decision ----------------------------------------------------

    def occupancy_bound(self, task: KernelTask) -> int:
        """Filtering heuristic: max slices a grid can use (§4.5)."""
        return max(1, math.ceil(task.work.n_blocks / self.occupancy))

    def decide(self, task: KernelTask, allocated: int) -> int:
        """Minimal slice count within the latency-slip budget, clamped to
        the owning tenant's KV-cache memory floor."""
        floor = self.memory_floor.get(task.client_id, 1)
        clamp = lambda t: min(allocated, max(t, floor))  # noqa: E731
        bound = self.occupancy_bound(task)
        if bound < allocated:
            return clamp(bound)
        fit = self.fits.get(task.key())
        if fit is None or not fit.fitted:
            return allocated
        l_full = fit.latency(allocated)
        if l_full <= 0 or fit.m <= 0:
            return clamp(min(allocated, bound))
        budget = self.slip * l_full
        if budget <= fit.b:
            return allocated
        t_min = fit.m / (budget - fit.b)
        return clamp(max(1, math.ceil(t_min)))

    # -- reporting ---------------------------------------------------------------

    def weighted_r2(self) -> float:
        """Kernel-runtime-weighted mean R^2 of the fits (§7.2 accuracy)."""
        tot_w = tot = 0.0
        for key, fit in self.fits.items():
            if not fit.fitted or fit.m <= 0:
                continue
            obs = self.extra_obs.get(key, {})
            if len(obs) < 3:
                continue
            w = sum(obs.values())
            tot += w * fit.r_squared(obs)
            tot_w += w
        return tot / tot_w if tot_w else float("nan")
