"""Arch-config -> kernel-trace compiler + workload (client) specifications.

LithOS schedules opaque kernels; this module produces the kernel sequences a
driver-level interposer would observe when one of the assigned architectures
runs a training step / inference request.  Per-op FLOPs and HBM bytes are
derived analytically from the *real* architecture configs (the same ones the
port's models run), so the simulator's ground truth is parameterized
from first principles rather than fitted to the paper's curves.

Granularity: ``fusion`` controls how many consecutive ops share one kernel,
mirroring the difference between eager per-op launches (PyTorch) and fused
runtimes (TensorRT-LLM).  Fig-10-style long kernels arise naturally from big
batches / long prompts.
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass, field, replace
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core.types import FaultEvent, FaultPlan, KernelWork, Priority

DSIZE = 2               # bf16
TILE_M = TILE_N = 128   # matmul output tile per thread block
EW_TILE = 8192          # elements per elementwise block


@dataclass(frozen=True)
class OpDesc:
    """One operator-level kernel: name + ground-truth work terms.

    ``phase`` tags LLM serving phases ("prefill" | "decode" | "") so the
    control plane can treat compute-bound prefill and latency-critical
    memory-bound decode differently (atomization, pressure sampling).  Only
    the disaggregated LLM kinds tag it; legacy traces stay phase-less."""

    name: str
    flops: float
    bytes: float
    n_blocks: int
    phase: str = ""

    def work(self) -> KernelWork:
        return KernelWork(self.flops, self.bytes, self.n_blocks)


def tag_phase(ops: list[OpDesc], phase: str) -> list[OpDesc]:
    """Return a copy of ``ops`` with every op tagged as ``phase``."""
    return [replace(op, phase=phase) for op in ops]


def matmul_op(name: str, M: int, N: int, K: int, dsize: int = DSIZE) -> OpDesc:
    flops = 2.0 * M * N * K
    byts = float(dsize) * (M * K + K * N + M * N)
    blocks = math.ceil(M / TILE_M) * math.ceil(N / TILE_N)
    return OpDesc(name, flops, byts, max(1, blocks))


def ew_op(name: str, elems: float, *, streams: float = 3.0,
          flops_per_elem: float = 4.0, dsize: int = DSIZE) -> OpDesc:
    """Elementwise/normalization kernel: ``streams`` HBM passes over elems."""
    return OpDesc(name, flops_per_elem * elems, streams * elems * dsize,
                  max(1, math.ceil(elems / EW_TILE)))


def attention_op(name: str, B: int, Sq: int, Skv: int, n_q: int, n_kv: int,
                 hd: int, *, causal: bool, window: int = 0,
                 block_q: int = 512) -> OpDesc:
    if window:
        Skv_eff = min(Skv, window)
        causal_frac = 1.0
    else:
        Skv_eff = Skv
        causal_frac = 0.5 if (causal and Sq == Skv) else 1.0
    flops = 2.0 * 2.0 * B * n_q * Sq * Skv_eff * hd * causal_frac
    byts = DSIZE * B * (Sq * n_q * hd * 2 + Skv_eff * n_kv * hd * 2)
    blocks = B * n_q * math.ceil(Sq / block_q)
    return OpDesc(name, flops, byts, max(1, blocks))


def decode_attention_op(name: str, B: int, kv_len: int, n_q: int, n_kv: int,
                        hd: int, window: int = 0) -> OpDesc:
    """One-token attention against a KV cache — memory-bound by design."""
    kv_eff = min(kv_len, window) if window else kv_len
    flops = 2.0 * 2.0 * B * n_q * kv_eff * hd
    byts = DSIZE * B * kv_eff * n_kv * hd * 2 + DSIZE * B * n_q * hd * 2
    blocks = B * n_kv * max(1, math.ceil(kv_eff / 2048))
    return OpDesc(name, flops, byts, max(1, blocks))


# ---------------------------------------------------------------------------
# Per-block op sequences (forward)
# ---------------------------------------------------------------------------

def _mlp_ops(cfg: ArchConfig, T: int, tag: str) -> list[OpDesc]:
    d = cfg.d_model
    if cfg.moe is not None:
        m = cfg.moe
        ops = [matmul_op(f"{tag}.router", T, m.n_experts, d),
               ew_op(f"{tag}.dispatch", T * d, streams=4.0, flops_per_elem=1.0)]
        # routed experts as one grouped matmul over T*top_k tokens
        Tk = T * m.top_k
        ops += [matmul_op(f"{tag}.exp_wi", Tk, m.expert_d_ff, d),
                matmul_op(f"{tag}.exp_wg", Tk, m.expert_d_ff, d),
                ew_op(f"{tag}.exp_act", Tk * m.expert_d_ff, streams=3.0),
                matmul_op(f"{tag}.exp_wo", Tk, d, m.expert_d_ff),
                ew_op(f"{tag}.combine", T * d * m.top_k, streams=3.0,
                      flops_per_elem=2.0)]
        if m.n_shared_experts:
            ff = m.shared_d_ff * m.n_shared_experts
            ops += [matmul_op(f"{tag}.shared_wi", T, ff, d),
                    matmul_op(f"{tag}.shared_wg", T, ff, d),
                    matmul_op(f"{tag}.shared_wo", T, d, ff)]
        return ops
    glu = cfg.activation in ("swiglu", "geglu")
    ops = [matmul_op(f"{tag}.mlp_wi", T, cfg.d_ff, d)]
    if glu:
        ops.append(matmul_op(f"{tag}.mlp_wg", T, cfg.d_ff, d))
    ops.append(ew_op(f"{tag}.mlp_act", T * cfg.d_ff, streams=3.0 if glu else 2.0))
    ops.append(matmul_op(f"{tag}.mlp_wo", T, d, cfg.d_ff))
    return ops


def _attn_block_ops(cfg: ArchConfig, B: int, S: int, tag: str, *,
                    window: int = 0, kv_len: Optional[int] = None,
                    decode: bool = False) -> list[OpDesc]:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    T = B * S
    ops = [ew_op(f"{tag}.ln1", T * d),
           matmul_op(f"{tag}.qkv", T, (nq + 2 * nkv) * hd, d),
           ew_op(f"{tag}.rope", T * (nq + nkv) * hd, streams=2.0)]
    if decode:
        ops.append(decode_attention_op(
            f"{tag}.attn_dec", B, kv_len or S, nq, nkv, hd, window))
    else:
        ops.append(attention_op(f"{tag}.attn", B, S, kv_len or S, nq, nkv, hd,
                                causal=True, window=window))
    ops.append(matmul_op(f"{tag}.wo", T, d, nq * hd))
    ops.append(ew_op(f"{tag}.ln2", T * d))
    ops += _mlp_ops(cfg, T, tag)
    return ops


def _rec_block_ops(cfg: ArchConfig, B: int, S: int, tag: str,
                   decode: bool = False) -> list[OpDesc]:
    """RG-LRU block (RecurrentGemma): projections + conv + linear scan."""
    d = cfg.d_model
    w = cfg.hybrid.lru_width or d
    T = B * S
    ops = [ew_op(f"{tag}.ln1", T * d),
           matmul_op(f"{tag}.rec_in", T, 2 * w, d),
           ew_op(f"{tag}.conv1d", T * w, streams=3.0,
                 flops_per_elem=2.0 * cfg.hybrid.conv_width),
           # the recurrence: memory-bound scan over the sequence
           ew_op(f"{tag}.lru_scan", T * w, streams=4.0, flops_per_elem=8.0),
           matmul_op(f"{tag}.rec_out", T, d, w),
           ew_op(f"{tag}.ln2", T * d)]
    ops += _mlp_ops(cfg, T, tag)
    return ops


def _mlstm_block_ops(cfg: ArchConfig, B: int, S: int, tag: str,
                     decode: bool = False) -> list[OpDesc]:
    d = cfg.d_model
    di = 2 * d                      # expansion
    hd = di // cfg.n_heads
    T = B * S
    chunk = 256 if not decode else 1
    ops = [ew_op(f"{tag}.ln1", T * d),
           matmul_op(f"{tag}.up", T, 2 * di, d),
           ew_op(f"{tag}.conv1d", T * di, streams=3.0, flops_per_elem=8.0),
           matmul_op(f"{tag}.qkv", T, 3 * di, di)]
    if decode:
        # recurrent state update: read/write C [B,H,hd,hd]
        state = B * cfg.n_heads * hd * hd
        ops.append(ew_op(f"{tag}.mlstm_step", state, streams=3.0,
                         flops_per_elem=6.0))
    else:
        # chunked parallel form: intra-chunk attention + inter-chunk state
        nchunk = math.ceil(S / chunk)
        intra = 2.0 * 2.0 * B * cfg.n_heads * nchunk * chunk * chunk * hd * 0.5
        inter = 4.0 * B * cfg.n_heads * nchunk * hd * hd * chunk
        byts = DSIZE * (3 * T * di + B * cfg.n_heads * nchunk * hd * hd * 2)
        blocks = B * cfg.n_heads * nchunk
        ops.append(OpDesc(f"{tag}.mlstm_chunk", intra + inter, byts,
                          max(1, blocks)))
    ops.append(matmul_op(f"{tag}.down", T, d, di))
    return ops


def _slstm_block_ops(cfg: ArchConfig, B: int, S: int, tag: str,
                     decode: bool = False) -> list[OpDesc]:
    d = cfg.d_model
    T = B * S
    ops = [ew_op(f"{tag}.ln1", T * d),
           matmul_op(f"{tag}.gates", T, 4 * d, d),
           # strictly sequential recurrence: S serial steps of B*d work;
           # expressed as a low-parallelism kernel (few blocks)
           OpDesc(f"{tag}.slstm_scan", 10.0 * T * d, 6.0 * T * d * DSIZE,
                  max(1, B * cfg.n_heads // 4)),
           matmul_op(f"{tag}.ffn_wi", T, cfg.d_ff or 4 * d, d),
           matmul_op(f"{tag}.ffn_wo", T, d, cfg.d_ff or 4 * d)]
    return ops


_BLOCK_OPS = {"attn": _attn_block_ops, "rec": _rec_block_ops,
              "mlstm": _mlstm_block_ops, "slstm": _slstm_block_ops}


def _pattern(cfg: ArchConfig) -> tuple[str, ...]:
    return cfg.hybrid.pattern if cfg.hybrid is not None else ("attn",)


def _block_ops(cfg, kind, B, S, tag, **kw):
    if kind == "attn":
        window = cfg.hybrid.window if cfg.hybrid is not None else 0
        return _attn_block_ops(cfg, B, S, tag, window=window, **kw)
    kw.pop("kv_len", None)
    return _BLOCK_OPS[kind](cfg, B, S, tag, decode=kw.get("decode", False))


# ---------------------------------------------------------------------------
# Whole-step traces
# ---------------------------------------------------------------------------

def forward_trace(cfg: ArchConfig, B: int, S: int, *,
                  with_head: bool = True) -> list[OpDesc]:
    T = B * S
    d = cfg.d_model
    ops = [ew_op("embed", T * d, streams=2.0, flops_per_elem=0.0)]
    pat = _pattern(cfg)
    for li in range(cfg.n_layers):
        kind = pat[li % len(pat)]
        ops += _block_ops(cfg, kind, B, S, f"L{li}.{kind}")
    ops.append(ew_op("final_norm", T * d))
    if with_head:
        ops.append(matmul_op("lm_head", T, cfg.vocab_size, d))
        ops.append(ew_op("softmax_xent", T * 8, streams=2.0, flops_per_elem=8.0))
    if cfg.is_encoder_decoder:
        # encoder stack over source frames + per-layer cross-attention
        Se = cfg.max_source_positions
        Te = B * Se
        for li in range(cfg.n_encoder_layers):
            ops += _attn_block_ops(cfg, B, Se, f"E{li}.attn")
        for li in range(cfg.n_layers):
            ops.append(attention_op(f"L{li}.xattn", B, S, Se, cfg.n_heads,
                                    cfg.n_heads, cfg.head_dim, causal=False))
    return ops


def train_step_trace(cfg: ArchConfig, B: int, S: int) -> list[OpDesc]:
    """fwd + bwd (2x matmul work as dgrad+wgrad) + optimizer update."""
    fwd = forward_trace(cfg, B, S)
    ops = list(fwd)
    for op in reversed(fwd):
        if ".attn" in op.name and "dec" not in op.name:
            ops.append(replace(op, name=op.name + ".bwd", flops=op.flops * 2.5,
                               bytes=op.bytes * 2.0))
        elif op.flops >= op.bytes:  # matmul-like: dgrad + wgrad
            ops.append(replace(op, name=op.name + ".dgrad"))
            ops.append(replace(op, name=op.name + ".wgrad"))
        else:
            ops.append(replace(op, name=op.name + ".bwd"))
    n_params = cfg.param_count()
    # grad reduce + AdamW update: read p,g,m,v write p,m,v
    ops.append(ew_op("optimizer", float(n_params), streams=6.0,
                     flops_per_elem=12.0))
    return ops


def prefill_trace(cfg: ArchConfig, B: int, S: int) -> list[OpDesc]:
    ops = forward_trace(cfg, B, S, with_head=False)
    ops.append(matmul_op("lm_head_last", B, cfg.vocab_size, cfg.d_model))
    return ops


def decode_step_trace(cfg: ArchConfig, B: int, kv_len: int) -> list[OpDesc]:
    d = cfg.d_model
    ops = [ew_op("embed", B * d, streams=2.0, flops_per_elem=0.0)]
    pat = _pattern(cfg)
    for li in range(cfg.n_layers):
        kind = pat[li % len(pat)]
        ops += _block_ops(cfg, kind, B, 1, f"L{li}.{kind}",
                          kv_len=kv_len, decode=True)
    ops.append(ew_op("final_norm", B * d))
    ops.append(matmul_op("lm_head", B, cfg.vocab_size, d))
    return ops


def fuse_trace(ops: list[OpDesc], group: int) -> list[OpDesc]:
    """Fuse consecutive ops ``group`` at a time (runtime-fused kernels)."""
    if group <= 1:
        return ops
    out = []
    for i in range(0, len(ops), group):
        g = ops[i:i + group]
        out.append(OpDesc(
            g[0].name + f"+f{len(g)}",
            sum(o.flops for o in g), sum(o.bytes for o in g),
            max(o.n_blocks for o in g), phase=g[0].phase))
    return out


# ---------------------------------------------------------------------------
# KV-cache footprint model (per-tenant memory the SliceMap/right-sizer
# must respect — LithOS-era tenants are compute-only; LLM decode holds HBM)
# ---------------------------------------------------------------------------

def kv_bytes_per_token(cfg: ArchConfig) -> float:
    """KV-cache bytes one cached token costs: K and V, every layer, at the
    KV-head width (GQA caches n_kv_heads, not n_heads)."""
    return 2.0 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * DSIZE


def kv_bytes(cfg: ArchConfig, batch: int, kv_len: int) -> float:
    """Total KV-cache footprint of ``batch`` requests each holding a
    ``kv_len``-token cache — the per-tenant memory term the right-sizer's
    floor clamp is derived from."""
    return float(batch) * float(kv_len) * kv_bytes_per_token(cfg)


def kv_floor_slices(cfg: ArchConfig, device, total_kv_bytes: float) -> int:
    """Minimum slice count whose pooled HBM capacity holds the footprint.

    A tenant right-sized below this would have nowhere to keep its cache:
    the clamp guarantees residency (weights/activations are out of scope —
    tenants are opaque kernel streams; DESIGN.md §10)."""
    if total_kv_bytes <= 0.0:
        return 1
    cap = getattr(device, "hbm_capacity", 0.0)
    if cap <= 0.0:
        return 1
    return min(device.n_slices, max(1, math.ceil(total_kv_bytes / cap)))


# ---------------------------------------------------------------------------
# Fault schedules (deterministic, seeded — the injection input to the
# fault-domain layer; see DESIGN.md §11)
# ---------------------------------------------------------------------------

def fault_schedule(n_devices: int, horizon: float, *, seed: int = 0,
                   n_device_dead: int = 0, n_slice_retired: int = 0,
                   n_transient: int = 0, slices_per_device: int = 1,
                   t_min_frac: float = 0.2, t_max_frac: float = 0.8,
                   stall_lo: float = 5e-3, stall_hi: float = 50e-3
                   ) -> FaultPlan:
    """Seeded random :class:`FaultPlan` over ``n_devices`` flat device
    positions — the generator benchmarks and property tests share.

    Fault times are uniform in ``[t_min_frac, t_max_frac] * horizon`` (the
    middle of the run, so there is work to disrupt and time to recover).
    Device deaths pick distinct devices; ``slice_retired`` and
    ``transient_stall`` events land on the *surviving* devices when any
    exist (faulting a device that is already scheduled to die tests
    nothing).  Deterministic in all arguments."""
    assert n_devices >= 1 and horizon > 0.0
    rng = np.random.default_rng((int(seed), n_devices, n_device_dead,
                                 n_slice_retired, n_transient))
    t = lambda: float(rng.uniform(t_min_frac, t_max_frac) * horizon)
    events: list[FaultEvent] = []
    n_dead = min(n_device_dead, n_devices)
    dead = sorted(rng.choice(n_devices, size=n_dead, replace=False).tolist()) \
        if n_dead else []
    for d in dead:
        events.append(FaultEvent(t=t(), kind="device_dead", member=int(d)))
    survivors = [d for d in range(n_devices) if d not in set(dead)]
    targets = survivors or list(range(n_devices))
    for _ in range(n_slice_retired):
        d = int(targets[rng.integers(len(targets))])
        sid = int(rng.integers(slices_per_device))
        events.append(FaultEvent(t=t(), kind="slice_retired", member=d,
                                 slice_id=sid))
    for _ in range(n_transient):
        d = int(targets[rng.integers(len(targets))])
        events.append(FaultEvent(t=t(), kind="transient_stall", member=d,
                                 duration=float(rng.uniform(stall_lo,
                                                            stall_hi))))
    return FaultPlan(tuple(sorted(events, key=lambda e: (e.t, e.member))))


# ---------------------------------------------------------------------------
# Client workload specs (what the simulator's clients replay)
# ---------------------------------------------------------------------------

#: memoized fused traces: (id(cfg), kind, shape...) -> (cfg, trace) — see
#: AppSpec.job_trace.  The entry pins the config object, so an id() can
#: never be recycled onto a different config while its trace is cached.
_trace_cache: dict = {}

#: normalized prompt-mix arrays keyed by the (hashable) mix tuple — the
#: np.array + normalize per draw showed up on million-request traces
_mix_cache: dict = {}


def sample_prompt_len(mix: tuple[tuple[int, float], ...],
                      rng: np.random.Generator) -> int:
    """One prompt-length draw from a mix — the single shared code path for
    every kind that samples ``prompt_mix`` (job_trace and the continuous
    client's arrival-time draw), so RNG streams stay identical no matter
    which engine or phase split consumes the request."""
    lp = _mix_cache.get(mix)
    if lp is None:
        lens, probs = zip(*mix)
        lp = _mix_cache[mix] = (lens, np.array(probs) / sum(probs))
    return int(rng.choice(lp[0], p=lp[1]))


# ---------------------------------------------------------------------------
# Continuous batching (llm_continuous): per-iteration batch recomposition
# ---------------------------------------------------------------------------

#: decode kv_len quantization for the shared iteration traces — keeps the
#: memoized trace population bounded while kv advances every token
KV_BUCKET = 64


def bucket_kv(kv_len: int) -> int:
    """Round a kv length up to the trace-memoization bucket."""
    return max(KV_BUCKET,
               ((int(kv_len) + KV_BUCKET - 1) // KV_BUCKET) * KV_BUCKET)


def continuous_prefill_trace(cfg: ArchConfig, S: int,
                             fusion: int) -> list[OpDesc]:
    """One joining request's prefill segment (B=1), phase-tagged, memoized.
    Shared across jobs — treat as read-only (the job_trace contract)."""
    key = (id(cfg), "cont_prefill", S, fusion)
    hit = _trace_cache.get(key)
    if hit is None:
        t = tag_phase(fuse_trace(prefill_trace(cfg, 1, S), fusion),
                      "prefill")
        _trace_cache[key] = (cfg, t)
        return t
    return hit[1]


def continuous_decode_trace(cfg: ArchConfig, B: int, kv_len: int,
                            fusion: int) -> list[OpDesc]:
    """One decode iteration over the running batch (``kv_len`` already
    bucketed by the caller), phase-tagged, memoized."""
    key = (id(cfg), "cont_decode", B, kv_len, fusion)
    hit = _trace_cache.get(key)
    if hit is None:
        t = tag_phase(fuse_trace(decode_step_trace(cfg, B, kv_len), fusion),
                      "decode")
        _trace_cache[key] = (cfg, t)
        return t
    return hit[1]


@dataclass
class Request:
    """One autoregressive request inside a continuous-batching tenant."""

    rid: int
    prompt_len: int
    decode_budget: int              # tokens to emit before leaving (>= 1)
    arrival: float
    kv_len: int = 0                 # cached tokens (0 until admitted)
    emitted: int = 0


class ContinuousBatchState:
    """Batch-composition state machine for one ``llm_continuous`` tenant.

    Requests arrive into ``waiting``; every iteration re-computes the
    running batch (waiting requests join up to ``max_batch``, exhausted
    requests leave), and each surviving request's ``kv_len`` advances by
    one emitted token.  All stochastic draws happen at arrival time (in
    the client's RNG stream — engine-parity safe); iteration transitions
    are purely deterministic functions of this state.

    Invariants (property-tested in tests/test_llm_workloads.py):
      * ``len(running) <= max_batch`` always;
      * per request, ``kv_len`` is monotone non-decreasing until eviction;
      * ``total_kv_bytes`` == sum of the running requests' kv footprints
        (KV bytes conservation across join/leave events).
    """

    def __init__(self, cfg: ArchConfig, max_batch: int):
        self.cfg = cfg
        self.max_batch = max(1, int(max_batch))
        self.per_token = kv_bytes_per_token(cfg)
        self.waiting: deque[Request] = deque()
        self.running: list[Request] = []
        self.iteration = 0
        self.total_kv_bytes = 0.0
        self.kv_peak_bytes = 0.0
        self.req_latencies: list[float] = []
        self.n_requests = 0
        self.n_completed = 0
        self._joiners: list[Request] = []
        self._decoders: list[Request] = []

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def in_iteration(self) -> bool:
        return bool(self._joiners or self._decoders)

    def add_request(self, prompt_len: int, decode_budget: int,
                    arrival: float) -> Request:
        r = Request(self.n_requests, int(prompt_len),
                    max(1, int(decode_budget)), arrival)
        self.n_requests += 1
        self.waiting.append(r)
        return r

    def begin_iteration(self) -> tuple[list[Request], list[Request]]:
        """Recompute the batch composition for the next iteration.

        Returns ``(joiners, decoders)``: requests admitted this iteration
        (they prefill, writing their prompt into the KV cache) and requests
        already resident (they decode one token against their cache)."""
        assert not self.in_iteration, "iteration already open"
        self._decoders = list(self.running)
        while self.waiting and len(self.running) < self.max_batch:
            r = self.waiting.popleft()
            r.kv_len = r.prompt_len          # cache written during prefill
            self.total_kv_bytes += r.kv_len * self.per_token
            self.running.append(r)
            self._joiners.append(r)
        if self.total_kv_bytes > self.kv_peak_bytes:
            self.kv_peak_bytes = self.total_kv_bytes
        self.iteration += 1
        return list(self._joiners), list(self._decoders)

    def finish_iteration(self, now: float) -> list[Request]:
        """One token emitted per resident request: kv advances, exhausted
        requests leave (their KV bytes are reclaimed).  Returns leavers."""
        for r in self._decoders:
            r.kv_len += 1
            r.emitted += 1
            self.total_kv_bytes += self.per_token
        for r in self._joiners:
            r.kv_len += 1                    # prefill emits the first token
            r.emitted = 1
            self.total_kv_bytes += self.per_token
        self._joiners = []
        self._decoders = []
        done = [r for r in self.running if r.emitted >= r.decode_budget]
        if done:
            gone = set(id(r) for r in done)
            self.running = [r for r in self.running if id(r) not in gone]
            for r in done:
                self.total_kv_bytes -= r.kv_len * self.per_token
                self.req_latencies.append(now - r.arrival)
                self.n_completed += 1
        if self.total_kv_bytes > self.kv_peak_bytes:
            self.kv_peak_bytes = self.total_kv_bytes
        return done


@dataclass
class AppSpec:
    """One tenant: a model + load pattern + SLO + quota/priority."""

    name: str
    cfg: ArchConfig
    # "llm_infer" | "fwd_infer" | "train" | "llm_prefill" | "llm_decode"
    # | "llm_continuous" (disaggregated serving phases + continuous batching)
    kind: str
    priority: Priority = Priority.BEST_EFFORT
    quota_slices: int = 0
    # open-loop inference load
    rps: float = 0.0
    slo_latency: float = 0.0        # seconds; 0 => throughput-oriented
    batch: int = 1
    prompt_mix: tuple[tuple[int, float], ...] = ((512, 0.6), (2048, 0.3),
                                                 (8192, 0.1))
    decode_tokens: int = 32
    max_batch: int = 8              # llm_continuous: running-batch cap
    # train load (closed loop)
    train_batch: int = 8
    train_seq: int = 2048
    fusion: int = 6                 # ops fused per kernel in the trace
    seed: int = 0

    def job_trace(self, rng: np.random.Generator) -> list[OpDesc]:
        """One request (inference) or one step (training) as fused kernels.

        Trace construction is memoized on the deterministic shape key (the
        stochastic draws — prompt length, decode count — are taken from
        ``rng`` exactly as before, so random streams are unchanged).  On
        million-request traces every arrival used to rebuild an identical
        op list; now it is built once per distinct shape.  The returned
        list is shared across jobs and must be treated as read-only."""
        if self.kind == "train":
            key = (id(self.cfg), "train", self.train_batch, self.train_seq,
                   self.fusion)
            hit = _trace_cache.get(key)
            if hit is None:
                t = fuse_trace(train_step_trace(self.cfg, self.train_batch,
                                                self.train_seq), self.fusion)
                _trace_cache[key] = (self.cfg, t)
                return t
            return hit[1]
        S = sample_prompt_len(self.prompt_mix, rng)
        if self.kind == "fwd_infer":
            key = (id(self.cfg), "fwd", self.batch, S, self.fusion)
            hit = _trace_cache.get(key)
            if hit is None:
                t = fuse_trace(prefill_trace(self.cfg, self.batch, S),
                               self.fusion)
                _trace_cache[key] = (self.cfg, t)
                return t
            return hit[1]
        if self.kind == "llm_prefill":
            # disaggregated prefill tenant: one compute-bound prompt pass
            key = (id(self.cfg), "llm_prefill", self.batch, S, self.fusion)
            hit = _trace_cache.get(key)
            if hit is None:
                t = tag_phase(fuse_trace(prefill_trace(self.cfg, self.batch,
                                                       S), self.fusion),
                              "prefill")
                _trace_cache[key] = (self.cfg, t)
                return t
            return hit[1]
        n_out = max(1, int(rng.geometric(1.0 / self.decode_tokens)))
        n_out = min(n_out, 4 * self.decode_tokens)
        if self.kind == "llm_decode":
            # disaggregated decode tenant: the prompt is already cached
            # (prefill ran elsewhere); n_out memory-bound token steps.
            key = (id(self.cfg), "llm_decode", self.batch, S, n_out,
                   self.fusion)
            hit = _trace_cache.get(key)
            if hit is None:
                step = decode_step_trace(self.cfg, self.batch,
                                         S + n_out // 2)
                ops: list[OpDesc] = []
                for _ in range(n_out):
                    ops += step
                t = tag_phase(fuse_trace(ops, self.fusion), "decode")
                _trace_cache[key] = (self.cfg, t)
                return t
            return hit[1]
        if self.kind == "llm_continuous":
            # Demand-estimation proxy ONLY (mean_demand / routers): one
            # request's worth of work at B=1.  Real jobs are built per
            # iteration by the client from ContinuousBatchState — never
            # from this trace.
            key = (id(self.cfg), "llm_cont_proxy", S, n_out, self.fusion)
            hit = _trace_cache.get(key)
            if hit is None:
                ops = tag_phase(prefill_trace(self.cfg, 1, S), "prefill")
                step = tag_phase(decode_step_trace(self.cfg, 1,
                                                   S + n_out // 2), "decode")
                for _ in range(n_out):
                    ops += step
                t = fuse_trace(ops, self.fusion)
                _trace_cache[key] = (self.cfg, t)
                return t
            return hit[1]
        key = (id(self.cfg), "llm", self.batch, S, n_out, self.fusion)
        hit = _trace_cache.get(key)
        if hit is None:
            ops = prefill_trace(self.cfg, self.batch, S)
            step = decode_step_trace(self.cfg, self.batch, S + n_out // 2)
            for _ in range(n_out):
                ops += step
            t = fuse_trace(ops, self.fusion)
            _trace_cache[key] = (self.cfg, t)
            return t
        return hit[1]

    def arrivals(self, horizon: float, rng: np.random.Generator) -> list[float]:
        """Whole arrival stream for one client, generated in one batch:
        Poisson count, then sorted uniform order statistics.  np.sort keeps
        the historical ``sorted(...)`` result bit-for-bit (same draws, same
        total order on floats) while scaling to million-request traces."""
        if self.kind == "train" or self.rps <= 0:
            return []               # closed loop
        n = rng.poisson(self.rps * horizon)
        return np.sort(rng.uniform(0.0, horizon, n)).tolist()


def mean_demand(spec: AppSpec, device, n_samples: int = 5,
                seed: int = 0) -> float:
    """Mean full-device service seconds per job — used to calibrate Poisson
    loads to a target utilization (the paper tunes loads for ~80% HP util)."""
    from repro_torch.core.costmodel import CostModel
    cost = CostModel(device)
    rng = np.random.default_rng((seed, spec.seed))
    tot = 0.0
    for _ in range(n_samples):
        for op in spec.job_trace(rng):
            tot += cost.latency(op.work(), device.n_slices)
    return tot / n_samples


def cluster_trace_apps(cfg: ArchConfig, device, *, n_services: int,
                       total_requests: int, target_util: float = 0.85,
                       n_devices: int = 1, be_per_device: int = 0,
                       be_cfg: Optional[ArchConfig] = None,
                       be_train_batch: int = 2, be_train_seq: int = 512,
                       quota_slices: int = 0,
                       name_prefix: str = "svc") -> tuple[list[AppSpec], float]:
    """Cluster-scale tenant population for the vectorized engine.

    ``n_services`` identical open-loop HIGH-priority inference tenants
    (``cfg`` fwd_infer, fusion=64 -> few kernels/request) whose aggregate
    offered load is calibrated to ``target_util * n_devices`` device-seconds
    per second on ``device`` — the same cost-model calibration the
    single-device throughput bench uses, scaled to a fleet — plus
    ``be_per_device * n_devices`` closed-loop best-effort trainers (they
    soak leftover capacity, giving the stealing tiers something to move).
    The horizon is sized so the services offer ``total_requests`` requests
    in aggregate.  Returns ``(apps, horizon)``; apps are ordered services
    first, trainers last, each with a distinct workload seed."""
    proto = AppSpec("proto", cfg, "fwd_infer", priority=Priority.HIGH,
                    batch=2, fusion=64, prompt_mix=((128, 1.0),))
    demand = mean_demand(proto, device)      # device-seconds per request
    total_rps = target_util * n_devices / demand
    horizon = total_requests / total_rps
    rps = total_rps / n_services
    apps = [replace(proto, name=f"{name_prefix}{i}", rps=rps, seed=i,
                    quota_slices=quota_slices)
            for i in range(n_services)]
    bcfg = be_cfg if be_cfg is not None else cfg
    apps += [AppSpec(f"bet{j}", bcfg, "train",
                     priority=Priority.BEST_EFFORT,
                     train_batch=be_train_batch, train_seq=be_train_seq,
                     seed=n_services + j)
             for j in range(be_per_device * n_devices)]
    return apps, horizon
