"""Decode and prefill cost entries derived from the port's Hopper kernels.

The sim's decode trace op (:func:`workloads.decode_attention_op`) is a
hand-written work model; the port's CUDA kernels under
``repro_torch/kernels/decode_attention`` and ``kernels/flash_attention`` have
concrete geometry.  This module derives :class:`KernelWork` terms from that
geometry — the same padding, the same grid — and ties them to
``roofline/analysis.py``'s three-term model, so:

* the predictor can be warm-started with roofline-derived decode
  latencies (``seed_decode_predictor``) instead of paying the
  conservative unseen-kernel default on the first serving iterations;
* a regression test can assert the sim's decode cost entries stay within
  tolerance of the kernel-derived roofline numbers — a kernel or
  analyzer change cannot silently skew decode timings
  (tests/test_torch_llm_costs.py);
* ``chip_smoke.py``'s ``lithos_decode`` / ``lithos_prefill`` lines can hold
  the cost model's latency against the kernels' measured times on the
  card.

The geometry:

* decode attention, bf16 split-KV kernel: ``R = B*n_kv`` rows, each run by
  a cluster of ``nsplit`` thread blocks (``ops.kv_split`` of the whole call
  and the card's cluster occupancy), keys in blocks of ``ops.KEY_BLOCK``;
* flash attention, bf16 ``wgmma`` kernel: ``B*n_q*ceil(Sq/ops.BLOCK_Q)``
  q tiles, one thread block each, visiting keys in blocks of
  ``ops.KEY_BLOCK``; the full square (non-causal), as the reference counts.

Nothing here runs on any scheduling path: no module, bench or script of
the port calls ``decode_cost_table`` or ``seed_decode_predictor``; only the
tests and ``chip_smoke.py`` do.  The simulator, the node and cluster tiers
and the control-plane daemon charge from ``core/workloads.py``'s ops, so
every scenario is bit-for-bit the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.costmodel import CostModel
from repro_torch.core.types import DeviceSpec, KernelWork
from repro_torch.core.workloads import DSIZE, OpDesc
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.roofline.analysis import HW, RooflineTerms

# ``decode_ops.cluster_fit(dev, 128)`` on an NVIDIA H100 80GB HBM3 (clusters
# of 1, 2, 4, 8 thread blocks of the split decode kernel the card runs at
# once), so that work terms need no card; chip_smoke.py's ``lithos_device``
# line fails if the card reads otherwise.
H100_CLUSTER_FIT = (264, 132, 62, 30)


def _pad_to(x: int, block: int) -> int:
    return ((x + block - 1) // block) * block


def decode_attention_work(B: int, S: int, n_q: int, n_kv: int, hd: int,
                          *, fit: Sequence[int] = H100_CLUSTER_FIT
                          ) -> KernelWork:
    """Work terms of ``kernels/decode_attention``'s split kernel at its
    geometry: q [B,Hq,D] against caches [B,S,Hk,D], rows R=B*Hk, G=Hq//Hk
    query heads a row, S padded to whole ``KEY_BLOCK``-key blocks, one
    thread block per (row, split)."""
    Sp = _pad_to(max(S, 1), decode_ops.KEY_BLOCK)
    R = B * n_kv
    G = max(1, n_q // n_kv)
    nsplit, _ = decode_ops.kv_split(R, S, fit)
    # QK^T + AV over the padded keys, per query head
    flops = 2.0 * 2.0 * R * G * Sp * hd
    # K and V stream the padded cache once; q and o are R*G*hd each
    byts = DSIZE * (R * Sp * hd * 2.0 + R * G * hd * 2.0)
    return KernelWork(flops, byts, max(1, R * nsplit))


def flash_attention_work(B: int, Sq: int, Skv: int, n_q: int, n_kv: int,
                         hd: int) -> KernelWork:
    """Work terms of ``kernels/flash_attention``'s bf16 kernel at its tiling
    (Sq padded to whole ``BLOCK_Q``-row q tiles, Skv to whole
    ``KEY_BLOCK``-key blocks; grid = one thread block a q tile), over the
    full square."""
    Sqp = _pad_to(max(Sq, 1), flash_ops.BLOCK_Q)
    Skp = _pad_to(max(Skv, 1), flash_ops.KEY_BLOCK)
    flops = 2.0 * 2.0 * B * n_q * Sqp * Skp * hd
    byts = DSIZE * B * (Sqp * n_q * hd * 2.0 + Skp * n_kv * hd * 2.0)
    n_blocks = B * n_q * (Sqp // flash_ops.BLOCK_Q)
    return KernelWork(flops, byts, max(1, n_blocks))


def device_hw(device: DeviceSpec) -> HW:
    """The roofline analyzer's HW record for a sim device (chips =
    slices; DeviceSpec rates are already per slice).  Passed to every
    ``RooflineTerms`` explicitly: the port's default record is the whole
    H100."""
    return HW(f"sim-{device.n_slices}sl", device.peak_flops, device.hbm_bw,
              link_bw=device.hbm_bw)


def roofline_terms(work: KernelWork, device: DeviceSpec,
                   *, label: str = "decode") -> RooflineTerms:
    """Three-term roofline for one kernel on the device (no collective
    traffic: single-device kernels).  ``chips`` is the kernel's effective
    parallelism — decode grids are small, so the analyzer must see the
    same occupancy-capped slice count the cost model's parallelism bound
    enforces, not the whole device."""
    chips = min(device.n_slices,
                max(1, math.ceil(work.n_blocks / device.occupancy)))
    return RooflineTerms(
        arch=label, shape=label, mesh="device", chips=chips,
        hlo_flops=work.flops, hlo_bytes=work.bytes,
        collective_bytes_per_chip=0.0, model_flops=work.flops,
        hw=device_hw(device))


@dataclass(frozen=True)
class DecodeCostEntry:
    """One calibrated decode cost-table row."""

    batch: int
    kv_len: int
    work: KernelWork
    roofline_s: float           # analysis.py bound_time on the full device
    latency_s: float            # CostModel ground truth on the full device

    @property
    def rel_err(self) -> float:
        model = self.latency_s
        return abs(model - self.roofline_s) / max(self.roofline_s, 1e-12)


def decode_cost_table(cfg, device: DeviceSpec,
                      batches: tuple[int, ...] = (1, 2, 4, 8),
                      kv_lens: tuple[int, ...] = (512, 2048, 8192),
                      ) -> list[DecodeCostEntry]:
    """Kernel-geometry decode attention costed two ways: the roofline
    analyzer's bound_time and the sim CostModel's full-device latency.
    The regression test pins these against each other (launch overhead
    and wave quantization explain the residual)."""
    cost = CostModel(device)
    out = []
    for B in batches:
        for S in kv_lens:
            w = decode_attention_work(B, S, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim)
            terms = roofline_terms(w, device)
            lat = cost.latency(w, device.n_slices)
            out.append(DecodeCostEntry(B, S, w, terms.bound_time, lat))
    return out


def seed_decode_predictor(predictor, queue_id: int, trace: list[OpDesc],
                          device: DeviceSpec, slices: int) -> int:
    """Warm-start one launch queue's predictor nodes from the ground-truth
    cost model: one observation per (queue, ordinal) at ``slices`` and
    f_max, as if the kernels had already run once.  Returns the number of
    nodes seeded.  Opt-in — callers that want cold-start behavior simply
    don't call it."""
    cost = CostModel(device)
    for ordinal, op in enumerate(trace):
        lat = cost.latency(op.work(), slices)
        predictor.seed_node(queue_id, ordinal, slices, 1.0, lat)
    return len(trace)
