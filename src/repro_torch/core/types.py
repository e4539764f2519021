"""Core types for the LithOS control plane.

The control plane schedules *kernels* — opaque units of device work described
by the quantities a driver-level interposer can observe (grid size, launch
config) plus the ground-truth work terms (flops / HBM bytes) that only the
simulator's cost model sees.  The OS never reads ``flops``/``bytes`` directly;
it learns latencies online through the observation interface (§4.7).

The schedulable spatial unit is a *slice*.  On the H100 a slice is the
paper's own unit, one TPC (two SMs): ``DeviceSpec.h100_like`` has 66 of
them.  All scheduler math is granularity-agnostic.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from enum import IntEnum
from typing import Optional

from repro_torch.roofline.analysis import H100 as _H100_SHEET


# One NVIDIA H100 SXM 80GB: 132 SMs, two a TPC; a slice of ``h100_like`` is
# one TPC.
H100_SMS = 132
H100_SLICES = H100_SMS // 2
# Measured on an NVIDIA H100 80GB HBM3 at 700.00 W by chip_smoke.py's
# ``lithos_device`` line, which prints each reading beside its constant:
H100_MEMORY = 85_017_493_504        # bytes, the card's ``total_memory``
H100_DECODE_CTAS_PER_SM = 2         # split decode kernel, head_dim 128
H100_K1_FIXED_S = 9.088e-6          # decode attention, every length 0
H100_IDLE_W = 123.96                # median of power.draw, idle
H100_LOADED_W = 692.19              # median of power.draw, atom matmuls


class Priority(IntEnum):
    BEST_EFFORT = 0
    HIGH = 1


@dataclass(frozen=True)
class DeviceSpec:
    """A schedulable device of ``n_slices`` slices.

    The field defaults are the reference package's own, kept so that a
    simulation on ``DeviceSpec()`` equals the reference's bit for bit; they
    describe none of the cards below.  ``f_states`` are the supported
    frequency steps as fractions of f_max, mirroring a discrete DVFS ladder;
    ``f_switch_latency`` models the ~50 ms transition cost the paper measures
    on current hardware (§4.6).
    """

    n_slices: int = 64
    peak_flops: float = 197e12          # per slice, bf16
    hbm_bw: float = 819e9               # per slice, bytes/s
    hbm_capacity: float = 16e9          # per slice, bytes
    occupancy: int = 8                  # blocks resident per slice
    launch_overhead: float = 4e-6       # per kernel/atom dispatch, seconds
    # dense DVFS ladder (real GPUs step ~15 MHz; 2.5% of f_max here)
    f_states: tuple[float, ...] = tuple(
        round(0.40 + 0.025 * i, 3) for i in range(25))
    f_switch_latency: float = 50e-3
    # Power model per slice (watts): P = idle + dyn * (f/fmax)^3 * active
    p_idle: float = 60.0
    p_dyn: float = 140.0
    p_static_host: float = 120.0        # host/uncore, per device

    def power(self, active_slices: int, f: float) -> float:
        """Instantaneous device power draw (W)."""
        return (self.p_static_host
                + self.n_slices * self.p_idle
                + active_slices * self.p_dyn * (f ** 3))

    @classmethod
    def a100_like(cls) -> "DeviceSpec":
        """Paper-testbed-calibrated profile: one A100 (SXM4, 108 SMs = 54
        TPCs, 312 TFLOP/s bf16, 1.94 TB/s HBM, ~400 W TDP).  Used by the
        scheduling benchmarks so Table 1/2 batch sizes and Fig 10 kernel
        latencies land in the paper's regimes."""
        # power: ~60 W idle -> ~400 W loaded, 85% dynamic (A100 SXM4)
        return cls(n_slices=54,
                   peak_flops=312e12 / 54,
                   hbm_bw=1.94e12 / 54,
                   hbm_capacity=80e9 / 54,
                   occupancy=8,
                   launch_overhead=4e-6,
                   p_idle=0.4, p_dyn=6.3, p_static_host=40.0)

    @classmethod
    def l4_like(cls) -> "DeviceSpec":
        """Inference-tier profile: one L4 (Ada, 58 SMs = 29 TPCs, 121
        TFLOP/s dense fp16, 300 GB/s GDDR6, 72 W TDP).  Roughly half an
        A100's TPC count at a quarter of the power — the asymmetric-capacity
        member of heterogeneous nodes/clusters, where the fragmentation
        metric starts to bite (a guarantee that fits any A100 may fit no
        L4)."""
        # power: ~22 W idle -> ~72 W loaded (inference-tier card)
        return cls(n_slices=29,
                   peak_flops=121e12 / 29,
                   hbm_bw=300e9 / 29,
                   hbm_capacity=24e9 / 29,
                   occupancy=8,
                   launch_overhead=4e-6,
                   p_idle=0.25, p_dyn=1.7, p_static_host=15.0)

    @classmethod
    def h100_like(cls) -> "DeviceSpec":
        """The port's card: one NVIDIA H100 SXM 80GB, 132 SMs = 66 TPCs, one
        slice a TPC.  Each constant and its source (the measured ones are
        the ``H100_*`` values of this module, read by ``chip_smoke.py``'s
        ``lithos_device`` line on an NVIDIA H100 80GB HBM3 at 700.00 W,
        which prints each reading beside the constant it calibrates):

        * ``peak_flops``, ``hbm_bw``: data sheet, 989 TFLOP/s dense bf16 and
          3.35 TB/s (``repro_torch.roofline.analysis.H100``), over 66.
        * ``hbm_capacity``: measured, the card's ``total_memory`` over 66.
        * ``occupancy``: measured, 2 SMs x the thread blocks an SM holds of
          the split decode kernel at head_dim 128 (``decode_attention.ops.
          max_active_clusters(128, 1)`` over 132 SMs): ``llm_costs`` models
          that kernel.
        * ``launch_overhead``: measured, decode attention's fixed cost, its
          headline shape (4 slots of llama3-8b at 2048 keys) with every
          length 0, median device time.
        * power: measured; ``p_static_host + 66 p_idle`` is the idle draw,
          split between host and slices as ``a100_like`` splits its own,
          and ``66 p_dyn`` the draw under back-to-back atom matmuls less the
          idle draw.
        * ``f_states``, ``f_switch_latency``: the default ladder; the card's
          clocks are not read.
        """
        n = H100_SLICES
        a100 = cls.a100_like()
        p_host = H100_IDLE_W * a100.p_static_host / a100.power(0, 1.0)
        return cls(n_slices=n,
                   peak_flops=_H100_SHEET.peak_flops / n,
                   hbm_bw=_H100_SHEET.hbm_bw / n,
                   hbm_capacity=H100_MEMORY / n,
                   occupancy=2 * H100_DECODE_CTAS_PER_SM,
                   launch_overhead=H100_K1_FIXED_S,
                   p_idle=(H100_IDLE_W - p_host) / n,
                   p_dyn=(H100_LOADED_W - H100_IDLE_W) / n,
                   p_static_host=p_host)


@dataclass(frozen=True)
class NodeSpec:
    """A multi-device node: N :class:`DeviceSpec`s behind one control plane.

    Each device runs its own policy instance (per-device quotas, slice maps,
    predictors); the node-level router (``repro_torch.core.node``) places tenants
    across devices.  A 1-device node is exactly equivalent to scheduling the
    bare :class:`DeviceSpec` — the parity contract the node layer's tests
    enforce."""

    devices: tuple[DeviceSpec, ...]
    name: str = "node"

    def __post_init__(self):
        assert len(self.devices) >= 1, "a node needs at least one device"

    @property
    def n_devices(self) -> int:
        return len(self.devices)

    @property
    def total_slices(self) -> int:
        return sum(d.n_slices for d in self.devices)

    @classmethod
    def uniform(cls, n_devices: int,
                device: Optional[DeviceSpec] = None) -> "NodeSpec":
        dev = device if device is not None else DeviceSpec()
        return cls(devices=tuple(dev for _ in range(n_devices)),
                   name=f"{n_devices}x-node")


@dataclass(frozen=True)
class NodeConfig:
    """Node-level lending protocol knobs (cross-device TPC stealing).

    The NodeCoordinator samples per-device pressure every ``epoch`` seconds
    and, when one device is saturated while another is idle, migrates one
    best-effort client's launch queue from the saturated device to the idle
    one (drained at a kernel boundary, charged ``migration_cost`` of
    dispatch blackout on arrival).

    Pressure signal, per device:
      * HP queue depth — jobs pending or in progress across HIGH-priority
        clients (saturated when >= ``hp_depth_hi``), and
      * SliceMap free-list occupancy — idle-slice fraction (saturated when
        <= ``free_lo`` with 2+ active tenants contending; a lender when
        >= ``free_hi`` with no HP backlog).

    ``migration=False`` (the default) is the exact-parity contract: the
    coordinator never intervenes and the node behaves bit-for-bit like
    independent per-device runs."""

    migration: bool = False
    epoch: float = 0.25             # pressure sampling period, seconds
    hp_depth_hi: int = 2            # HP backlog >= this => saturated
    free_lo: float = 0.125          # idle fraction <= this (contended) => saturated
    free_hi: float = 0.5            # idle fraction >= this + no HP backlog => lender
    migration_cost: float = 0.05    # seconds of dispatch blackout per move
    cooldown: float = 1.0           # per-client quiet period between moves
    max_migrations: int = 0         # total cap; 0 = unbounded
    validate: bool = False          # run cross-device conservation checks
                                    # at every epoch (tests)


@dataclass(frozen=True)
class ClusterSpec:
    """A cluster: N :class:`NodeSpec`s behind one placement/power plane.

    Each node runs its own :class:`~repro_torch.core.node.NodeCoordinator` (own
    routers, lending protocol, per-device policies); the cluster tier
    places tenants onto nodes, optionally migrates best-effort tenants
    between nodes, and coordinates per-device DVFS f-states under a
    cluster-wide power cap.  A 1-node cluster is exactly equivalent to
    evaluating the bare :class:`NodeSpec` — the parity contract the cluster
    layer's tests enforce, one level up from the node<->device one."""

    nodes: tuple[NodeSpec, ...]
    name: str = "cluster"

    def __post_init__(self):
        assert len(self.nodes) >= 1, "a cluster needs at least one node"

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def n_devices(self) -> int:
        return sum(n.n_devices for n in self.nodes)

    @property
    def total_slices(self) -> int:
        return sum(n.total_slices for n in self.nodes)

    @classmethod
    def uniform(cls, n_nodes: int,
                node: Optional[NodeSpec] = None) -> "ClusterSpec":
        nd = node if node is not None else NodeSpec.uniform(2)
        return cls(nodes=tuple(nd for _ in range(n_nodes)),
                   name=f"{n_nodes}x-cluster")


@dataclass(frozen=True)
class ClusterConfig:
    """Cluster-tier knobs: the same lending-protocol field names as
    :class:`NodeConfig` (the level-agnostic coordinator reads either), at
    node granularity, plus the cluster power budget.

    Pressure is aggregated per node (summed HP backlog, pooled free-list
    occupancy), epochs are coarser and migrations costlier than the node
    tier's — cross-node moves ship a replica's working state over the
    fabric, not NVLink.  ``power_cap`` (watts; 0 = uncapped) bounds the
    projected cluster draw: at every epoch the power manager lowers
    per-device DVFS f-states — best-effort-only devices first, HP devices
    never below ``power_hp_floor`` — until the projection fits the cap.

    ``node_config`` is applied to every member node's own coordinator
    (intra-node stealing composes with cluster-level migration: the frozen
    set keeps the two tiers off the same client)."""

    migration: bool = False
    epoch: float = 0.5              # pressure sampling period, seconds
    hp_depth_hi: int = 4            # node-aggregate HP backlog => saturated
    free_lo: float = 0.125          # pooled idle fraction <= this => saturated
    free_hi: float = 0.5            # pooled idle fraction >= this => lender
    migration_cost: float = 0.25    # seconds of dispatch blackout per move
    cooldown: float = 2.0           # per-client quiet period between moves
    max_migrations: int = 0         # total cap; 0 = unbounded
    validate: bool = False          # run cluster-wide conservation checks
                                    # at every epoch (tests)
    power_cap: float = 0.0          # cluster power budget, watts; 0 = off
    power_hp_floor: float = 0.75    # min f-state for devices with HP work
    node_config: Optional[NodeConfig] = None  # per-node coordinator knobs


#: fault kinds a :class:`FaultPlan` may schedule
FAULT_KINDS = ("device_dead", "slice_retired", "transient_stall")


@dataclass(frozen=True)
class FaultEvent:
    """One injected hardware fault, scheduled at simulated time ``t``.

    ``member`` is a flat leaf-device index at whatever scope the plan is
    handed to (device 0 for a bare :class:`DeviceSpec` run, the node's
    device index for a :class:`NodeSpec`, the cluster-flat device index for
    a :class:`ClusterSpec`).

    Kinds:
      * ``device_dead``     — the whole device fails permanently; its
        tenants must be evacuated by the tier above.
      * ``slice_retired``   — ECC-style loss of one TPC slice
        (``slice_id``); the device keeps running at reduced capacity.
      * ``transient_stall`` — every in-flight kernel on the device is
        delayed by ``duration`` seconds (SXid-style recoverable hiccup).
    """

    t: float
    kind: str
    member: int = 0
    slice_id: int = -1              # slice_retired only
    duration: float = 0.0           # transient_stall only

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(choose from {FAULT_KINDS})")
        if self.t < 0.0:
            raise ValueError(f"fault time must be >= 0, got {self.t}")
        if self.kind == "slice_retired" and self.slice_id < 0:
            raise ValueError("slice_retired needs a slice_id")
        if self.kind == "transient_stall" and not self.duration > 0.0:
            raise ValueError("transient_stall needs a duration > 0")


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of :class:`FaultEvent`s.

    The plan is the single source of failure truth for a run: the same
    plan replayed against either simulator engine injects byte-identical
    event streams.  An empty plan is the no-fault contract — zero extra
    heap events, bit-for-bit identical to a run with no plan at all."""

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    def events_for(self, member: int) -> tuple[FaultEvent, ...]:
        """This plan's events targeting one flat device index, time-sorted
        (ties kept in plan order — deterministic)."""
        return tuple(sorted((e for e in self.events if e.member == member),
                            key=lambda e: e.t))

    @property
    def dead_members(self) -> tuple[int, ...]:
        return tuple(sorted({e.member for e in self.events
                             if e.kind == "device_dead"}))


_kernel_ids = itertools.count()


def reset_kernel_ids():
    """Restart the global kernel-id counter (parity tests only).

    Kernel ids are drawn from one process-global counter, so two runs of
    the same scenario in one process get different ``kid`` values.  The
    engine-parity tests reset the counter before each run so the reference
    and vectorized engines produce byte-identical CompletionRecord streams,
    kids included."""
    global _kernel_ids
    _kernel_ids = itertools.count()


@dataclass
class KernelWork:
    """Ground-truth work terms (cost-model facts, hidden from the OS).

    ``flops``     total floating-point work
    ``bytes``     total HBM traffic
    ``n_blocks``  grid size (schedulable tiles — the atomizer's unit)
    """

    flops: float
    bytes: float
    n_blocks: int

    def scaled(self, frac: float) -> "KernelWork":
        nb = max(1, round(self.n_blocks * frac))
        return KernelWork(self.flops * frac, self.bytes * frac, nb)


@dataclass
class KernelTask:
    """One kernel launch as seen at the interposition boundary.

    ``op_name``/``ordinal`` identify the operator node in the model's DFG:
    the predictor keys on (queue, ordinal) because a single kernel function
    serves layers with different tensor sizes (§4.7).
    """

    op_name: str
    work: KernelWork
    client_id: int = 0
    queue_id: int = 0
    ordinal: int = -1                   # k-th kernel since last sync event
    kid: int = field(default_factory=lambda: next(_kernel_ids))
    # Set by the atomizer: (parent kid, atom index, n_atoms).
    atom_of: Optional[tuple[int, int, int]] = None
    # LLM serving phase: "prefill" (compute-bound, atomize like training) |
    # "decode" (memory-bound, already sub-quantum — never atomized) | ""
    # (phase-agnostic legacy kernel).  Carried from the workload trace.
    phase: str = ""

    @property
    def is_atom(self) -> bool:
        return self.atom_of is not None

    def key(self) -> tuple[int, int]:
        """Predictor identity: operator node = (queue, ordinal)."""
        return (self.queue_id, self.ordinal)


@dataclass
class SyncEvent:
    """Explicit synchronization (cuStreamSynchronize analogue).

    Delimits batches for the predictor's ordinal indexing and is the point
    where the client blocks until its outstanding work completes.
    """

    client_id: int
    queue_id: int


@dataclass
class Quota:
    """Per-client compute quota: guaranteed core-slices when work is
    available (§4.2), plus scheduling priority."""

    slices: int
    priority: Priority = Priority.BEST_EFFORT


@dataclass
class CompletionRecord:
    """What the OS observes when a kernel/atom completes — the only channel
    through which predictor / right-sizer / DVFS learn."""

    task: KernelTask
    t_submit: float
    t_start: float
    t_end: float
    slices: int
    freq: float                         # fraction of f_max during execution

    @property
    def latency(self) -> float:
        return self.t_end - self.t_start

    @property
    def queueing(self) -> float:
        return self.t_start - self.t_submit
