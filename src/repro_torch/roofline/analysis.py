"""Three-term roofline: the least time a piece of work can take on a device.

Per (arch x shape x mesh):

    compute term    = FLOPs / (chips x peak_FLOP/s)
    memory term     = bytes / (chips x HBM_bw)
    collective term = collective_bytes / (chips x link_bw)

The FLOPs and bytes are fleet totals of the work; collective bytes are per
chip.  Also reported: MODEL_FLOPS = 6·N·D (dense train; 2·N·D inference
forward, per token for decode) and the usefulness ratio MODEL_FLOPS / FLOPs,
which catches recomputation and redundancy.

Hardware record: ``H100``, NVIDIA's data-sheet values for one H100 SXM at its
700 W limit (dense rates, no sparsity).  They are published peaks, not
measurements; a card set below 700 W runs slower under load.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclass(frozen=True)
class HW:
    name: str
    peak_flops: float         # per chip, the matrix units' bf16 rate
    hbm_bw: float             # per chip, bytes/s
    link_bw: float            # per chip per link, bytes/s each way
    # per chip, f32 outside the matrix units; None where the record has none
    peak_flops_f32: Optional[float] = None


# data sheet: 989 TFLOP/s dense bf16, 67 TFLOP/s f32 (CUDA cores), 3.35 TB/s
# HBM3, NVLink 900 GB/s = 450 GB/s each way
H100 = HW("h100-sxm", 989e12, 3.35e12, 450e9, peak_flops_f32=67e12)


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    # fleet totals
    hlo_flops: float
    hlo_bytes: float
    collective_bytes_per_chip: float
    model_flops: float
    # seconds
    t_compute: float = field(init=False)
    t_memory: float = field(init=False)
    t_collective: float = field(init=False)
    hw: HW = H100

    def __post_init__(self):
        self.t_compute = self.hlo_flops / (self.chips * self.hw.peak_flops)
        self.t_memory = self.hlo_bytes / (self.chips * self.hw.hbm_bw)
        self.t_collective = self.collective_bytes_per_chip / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-at-peak time / bound time: how close the program is
        to the ideal all-compute roofline."""
        ideal = self.model_flops / (self.chips * self.hw.peak_flops)
        return ideal / self.bound_time if self.bound_time else 0.0

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective, "dominant": self.dominant,
            "model_flops": self.model_flops, "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6·N·D train / 2·N·D prefill / 2·N_active per decoded token."""
    n = cfg.active_param_count()
    seq = cfg.effective_seq(shape)
    tokens = shape.global_batch * seq
    if shape.kind == "train":
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        return 2.0 * n * tokens
    # decode: one token per sequence in the batch
    return 2.0 * n * shape.global_batch


def derive_terms(cfg: ArchConfig, shape: ShapeConfig, mesh_name: str,
                 chips: int, hlo_flops: float, hlo_bytes: float,
                 collective_bytes_per_chip: float) -> RooflineTerms:
    return RooflineTerms(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes,
        collective_bytes_per_chip=collective_bytes_per_chip,
        model_flops=model_flops(cfg, shape))
