"""§4.6 Transparent power management (DVFS governor).

Model: a kernel's relative slowdown at frequency f is approximated first-order
as ``k_obs = s * (f_max/f - 1)`` with per-kernel *sensitivity* s (1 = fully
compute-bound, 0 = fully memory-bound).  Aggregating over a stream with
runtime weights w gives ``S = Σ w·s``; bounding total slowdown by the latency
slip ``k`` yields the target ``f_final = f_max / (1 + k/S)``.

Conservative learning protocol (the paper's): unseen kernels run at f_max;
on first sight a kernel is *assumed linear* (s=1) which biases the target
high; observed slowdowns then refine s and allow lower frequencies.  Because
frequency switching is slow (~50 ms), the governor rate-limits transitions
and quantizes to the device's supported f-states.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.types import CompletionRecord, DeviceSpec, KernelTask


@dataclass
class SensitivityStats:
    s: float = 1.0                     # assumed linear until measured
    measured: bool = False
    runtime: float = 0.0               # cumulated runtime (weight numerator)
    base_lat: Optional[float] = None   # latency at f_max (per launch-unit)


class DVFSGovernor:
    def __init__(self, device: DeviceSpec, slip: float = 1.1,
                 switch_interval: float = 0.25):
        self.device = device
        self.k = max(slip - 1.0, 0.0)
        self.switch_interval = switch_interval
        self.stats: dict[tuple[int, int], SensitivityStats] = {}
        self.current_f = 1.0
        self.last_switch = -1e9
        self.switches = 0
        #: external frequency ceiling (cluster power manager).  1.0 = no cap
        #: — the governor behaves exactly as before the cluster tier existed.
        self.f_cap = 1.0

    # -- learning -----------------------------------------------------------

    def observe(self, rec: CompletionRecord):
        st = self.stats.setdefault(rec.task.key(), SensitivityStats())
        lat = rec.latency
        if rec.task.atom_of is not None:
            lat *= rec.task.atom_of[2]
        st.runtime += lat
        if rec.freq >= 0.999:
            # EWMA base latency at f_max
            st.base_lat = lat if st.base_lat is None else 0.7 * st.base_lat + 0.3 * lat
        elif st.base_lat:
            k_obs = lat / st.base_lat - 1.0
            denom = 1.0 / rec.freq - 1.0
            if denom > 1e-6:
                s = min(max(k_obs / denom, 0.0), 1.5)
                st.s = s if not st.measured else 0.7 * st.s + 0.3 * s
                st.measured = True

    # -- policy ---------------------------------------------------------------

    def aggregate_sensitivity(self, queue_id: Optional[int] = None) -> float:
        items = [(key, st) for key, st in self.stats.items()
                 if queue_id is None or key[0] == queue_id]
        total = sum(st.runtime for _, st in items)
        if total <= 0:
            return 1.0
        return sum(st.runtime / total * st.s for _, st in items)

    def _clamp(self, f: float) -> float:
        """Apply the external cap: highest supported state <= ``f_cap``."""
        if f <= self.f_cap + 1e-9:
            return f
        best = None
        for s in self.device.f_states:
            if s <= self.f_cap + 1e-9:
                best = s
        return best if best is not None else self.device.f_states[0]

    def target_frequency(self, queue_id: Optional[int] = None) -> float:
        """f_final = f_max / (1 + k/S), quantized down to a supported state,
        never above the cluster power manager's ``f_cap``."""
        if self.k <= 0:
            return self._clamp(1.0)
        S = self.aggregate_sensitivity(queue_id)
        if S <= 1e-6:
            raw = self.device.f_states[0]
        else:
            raw = 1.0 / (1.0 + self.k / S)
        # highest supported state <= is wrong direction: choose the lowest
        # state >= raw (conservative: never exceed the slip budget)
        for f in self.device.f_states:
            if f >= raw - 1e-9:
                return self._clamp(f)
        return self._clamp(1.0)

    def maybe_switch(self, now: float,
                     queue_id: Optional[int] = None) -> Optional[float]:
        """Returns the new frequency if the governor decides to switch."""
        if now - self.last_switch < self.switch_interval:
            return None
        f = self.target_frequency(queue_id)
        if abs(f - self.current_f) < 1e-9:
            return None
        self.current_f = f
        self.last_switch = now
        self.switches += 1
        return f

    def unseen(self, task: KernelTask) -> bool:
        return task.key() not in self.stats


def plan_power_budget(devices: list[DeviceSpec], active: list[int],
                      hp: list[bool], cap: float,
                      hp_floor: float = 0.75) -> list[float]:
    """Choose per-device frequency caps so the projected fleet power fits
    ``cap`` watts.  The cluster tier's planning half of §4.6: the per-device
    governor optimizes latency-vs-power locally, this allocates the global
    budget that bounds it.

    ``active`` is each device's busy-slice count and ``hp`` whether it
    currently runs HIGH-priority work.  Deterministic greedy waterfill: all
    devices start at f_max; repeatedly step down the frequency of the
    device with the largest marginal power saving (``active * p_dyn *
    (f^3 - f_next^3)``), considering best-effort-only devices first and
    never dropping a device with HP work below ``hp_floor``.  Stops when
    the projection fits or no step can save anything — static + idle floor
    power is not reducible by DVFS, so an infeasible cap degrades to
    every-knob-at-minimum rather than failing."""
    n = len(devices)
    idx = [len(d.f_states) - 1 for d in devices]    # start at f_max

    def freq(d):
        return devices[d].f_states[idx[d]]

    def floor_idx(d):
        if not hp[d]:
            return 0
        states = devices[d].f_states
        for i, s in enumerate(states):
            if s >= hp_floor - 1e-9:
                return i
        return len(states) - 1

    total = sum(devices[d].power(active[d], freq(d)) for d in range(n))
    while total > cap + 1e-9:
        best, best_save = None, 0.0
        for be_pass in (True, False):
            for d in range(n):
                if hp[d] == be_pass:        # BE devices on the first pass
                    continue
                if idx[d] <= floor_idx(d):
                    continue
                f0, f1 = freq(d), devices[d].f_states[idx[d] - 1]
                save = active[d] * devices[d].p_dyn * (f0 ** 3 - f1 ** 3)
                if save > best_save + 1e-12:
                    best, best_save = d, save
            if best is not None:
                break
        if best is None:
            break                           # cap below the static floor
        idx[best] -= 1
        total -= best_save
    return [freq(d) for d in range(n)]
