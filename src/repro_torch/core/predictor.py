"""§4.7 Online latency prediction.

Keyed by *operator node* — (launch queue, ordinal index within a batch) —
not by kernel function name: one kernel function serves layers with
different tensor sizes, so identity-by-name mispredicts (§4.7).  Sync events
reset the ordinal counter, delimiting batches.

Per node the predictor records observations conditioned on (slices,
frequency, atom fraction) and answers queries for unseen conditions with the
paper's conservative fallback: optimal linear scaling from the nearest
observed condition (e.g. seen at 100% TPCs -> assume half the slices takes
2x as long).
"""
from __future__ import annotations

import math
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Optional

from repro_torch.core.types import CompletionRecord, KernelTask

EWMA = 0.3              # new-observation weight


def _fkey(f: float) -> int:
    return round(f * 100)


@dataclass
class NodeStats:
    """Observations for one operator node."""

    # (slices, f%) -> EWMA of *full-kernel-equivalent* latency minus overhead
    lat: dict[tuple[int, int], float] = field(default_factory=dict)
    count: int = 0
    total_runtime: float = 0.0          # for DVFS weights

    def observe(self, slices: int, f: float, unit_latency: float):
        k = (slices, _fkey(f))
        old = self.lat.get(k)
        self.lat[k] = (unit_latency if old is None
                       else (1 - EWMA) * old + EWMA * unit_latency)
        self.count += 1
        self.total_runtime += unit_latency


class LatencyPredictor:
    """Online, per-queue kernel latency predictor."""

    def __init__(self, launch_overhead: float = 4e-6):
        self.nodes: dict[tuple[int, int], NodeStats] = defaultdict(NodeStats)
        self.overhead = launch_overhead
        self.mispredictions = 0
        self.predictions = 0
        self.errors: list[float] = []

    # -- observation --------------------------------------------------------

    def observe(self, rec: CompletionRecord):
        task = rec.task
        frac = 1.0
        if task.atom_of is not None:
            _, _, n_atoms = task.atom_of
            frac = task.work.n_blocks and 1.0  # atoms carry scaled work
        # normalize to full-kernel-equivalent divisible latency
        div = max(rec.latency - self.overhead, 1e-9)
        if task.atom_of is not None:
            _, _, n = task.atom_of
            div *= n          # approx: atoms are ~equal slices of the kernel
        self.nodes[task.key()].observe(rec.slices, rec.freq, div)

    def seed_node(self, queue_id: int, ordinal: int, slices: int, f: float,
                  latency: float):
        """Warm-start one operator node with a synthetic observation (e.g.
        a roofline-calibrated decode latency) so a serving tenant's first
        iterations aren't scheduled under the conservative unseen-kernel
        default.  ``latency`` is a whole-launch latency; the launch
        overhead is stripped exactly as observe() does."""
        self.nodes[(queue_id, ordinal)].observe(
            slices, f, max(latency - self.overhead, 1e-9))

    # -- queries ------------------------------------------------------------

    def known(self, task: KernelTask) -> bool:
        return self.nodes[task.key()].count > 0

    def predict(self, task: KernelTask, slices: int, f: float = 1.0,
                n_atoms: int = 1) -> Optional[float]:
        """Predicted latency of one launch (kernel, or one of n_atoms atoms).

        Returns None for never-seen nodes (callers apply their own
        conservative default).
        """
        node = self.nodes.get(task.key())
        if not node or not node.lat:
            return None
        k = (slices, _fkey(f))
        if k in node.lat:
            div = node.lat[k]
        else:
            # conservative fallback: pick nearest condition, assume optimal
            # linear scaling in slices and frequency (§4.7)
            (s0, f0), div0 = min(
                node.lat.items(),
                key=lambda kv: (abs(math.log(kv[0][0] / slices)),
                                abs(kv[0][1] - _fkey(f))))
            div = div0 * (s0 / slices) * (f0 / 100.0) / f
        return div / n_atoms + self.overhead

    def record_outcome(self, predicted: Optional[float], actual: float,
                       threshold: float = 50e-6):
        """Bench/eval hook: track misprediction rate (|err| > 50 us, §7.4)."""
        if predicted is None:
            return
        self.predictions += 1
        err = abs(predicted - actual)
        self.errors.append(err)
        if err > threshold:
            self.mispredictions += 1

    # -- DVFS support --------------------------------------------------------

    def runtime_weight(self, task: KernelTask) -> float:
        """Share of this node's runtime within its queue (the w in S=Σw·s)."""
        node = self.nodes.get(task.key())
        if node is None or node.total_runtime == 0:
            return 0.0
        qtotal = sum(n.total_runtime for (q, _), n in self.nodes.items()
                     if q == task.key()[0])
        return node.total_runtime / max(qtotal, 1e-12)
