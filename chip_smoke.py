#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version on the card (values, atom order-freedom,
rows / tiles outside an atom untouched, the route each case took: for decode
attention every split count of the split-KV kernel; key pitches it cannot
take are refused; head_dim 256 and sliding windows), times them beside their
bound (decode attention at three shapes, flash attention at two), then
drives the paths, each with the kernels' launch counts set to 0 just before
and read just after: it serves full-size ``llama3-8b``, ``olmo-1b``,
``qwen2-moe-a2.7b`` (MoE), ``recurrentgemma-9b`` (RG-LRU and local attention
with a window of 2048, prompts past it) and ``xlstm-1.3b`` (no attention)
with random weights from a seed through ``repro_torch.launch.serve.serve``
(decode and flash attention, as many launches as the config has attention
layers), whisper-small and llava-next-34b, trains full-size ``olmo-1b``
for 6 steps through ``repro_torch.launch.train.train`` (flash attention's
forward and its backward kernel once per layer and microbatch; a 2-layer
step held against plain attention forward and backward, with planted
backward faults), checkpoints that run's final state through
``repro_torch.checkpoint`` (save, restore onto the card, every leaf and a
resumed step bit-equal to the live state's, and a resume through
``launch.train.train``), and runs the atom-count sweep
``repro_torch.launch.atoms.sweep`` (the atomized matmul at the full-width
``llama3-8b`` projections, and flash attention), and holds the LithOS
simulator's cost model on ``repro_torch.core``'s ``DeviceSpec.h100_like``
against the card (``lithos`` lines: the SM count, cluster occupancy, decode
attention's fixed cost and the idle and loaded power draw beside the
profile's constants; decode attention at every entry of llama3-8b's
``decode_cost_table``, flash attention at four prefill lengths and the
sweep's matmul atom counts, each measured beside the model's latency and
the roofline, and beside the latency of the op the simulator itself
issues at that shape; ``evaluate`` of two mixes under both engines,
bit-equal), drives the node and cluster tiers on ``h100_like``
(``lithos_node``: the two mixes on a node of two devices under each router
and on a cluster of two such nodes, both engines bit-equal) and the online
control plane (``ctl``: the served llama3-8b deployment submitted through
``launch.serve --ctl-state-dir`` beside a best-effort olmo-1b trainer,
``python -m repro_torch.ctl daemon`` killed with SIGKILL and restarted until
both finish).  Every phase prints one
JSON line; any failure ends the run with a non-zero exit code.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--profile`` adds a ``profile`` line for each of ``llama3-8b``,
``qwen2-moe-a2.7b``, ``recurrentgemma-9b``, ``xlstm-1.3b``, whisper-small
and llava-next-34b (device time by kernel over a prefill and a few decode
steps) and for ``olmo-1b``'s train step and its AdamW update alone.

``--rehearse`` walks the same phases on the CPU at toy sizes with the plain
versions, to find faults in this script without a card.  It measures nothing
of the device, prints no result line and always exits non-zero.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM data-sheet rates (dense, 700 W power limit)
from repro_torch.roofline.analysis import H100  # noqa: E402
# atom matmul against its plain version, as max abs error over the largest
# |output| (the tolerance's reasoning is in that module)
from repro_torch.launch.atoms import MM_TOL  # noqa: E402
# decode attention's timed shapes and the limit they are held to there (the
# tolerance's reasoning is in that module)
from repro_torch.launch.decode_compare import (  # noqa: E402
    BWD_REL_TOL, DECODE_REL_TOL, DECODE_SHAPES, bwd_row_err,
    dropped_split_err, headline_limit)

# kernel against its plain version on the same inputs, max abs error.
# float32: both sides do f32 math and differ only in summation order and in
# the last bits of exp.  bfloat16: both sides round an f32 result to bf16
# once, and the flash kernel also rounds P to bf16 for the tensor-core
# product, so results differ by one bf16 step (2^-8 relative: 0.0156 for an
# output between 2 and 4, which short rows reach).
TOL = {("decode", "float32"): 2e-5, ("decode", "bfloat16"): 3e-2,
       ("flash", "float32"): 2e-3, ("flash", "bfloat16"): 3e-2}
# bf16 flash attention against its plain version, query row by query row:
# the max abs error over a row's heads and head dims, over that row's largest
# |output|.  Both sides round an f32 result to bf16 once and the kernel
# rounds P to bf16, so a row differs by about one bf16 step at its largest
# output (2^-8 to 2^-7 of it); the limit is two steps.  The absolute limit
# above cannot see a fault in a long row: over a window of 2048 keys the
# outputs are about N(0, e/2048), a row's largest ~0.15, and leaving 64 of
# its keys out moves them by less than 3e-2.  ``flash_headline`` plants such
# faults and fails unless they read above this limit.
FLASH_REL_TOL = 2.0 ** -6
# keys of a KV block on flash attention's bf16 path (``TBK`` in
# csrc/flash_attention.cu): the planted fault drops one at a window's start
from repro_torch.kernels.flash_attention.ops import (  # noqa: E402
    KEY_BLOCK as KV_BLOCK)
# full-depth bf16 model, kernels against plain attention: the attention
# outputs differ by single bf16 roundings, which the layers above carry on;
# logits are O(1), and the limit is a tenth of that.  An MoE model's plain
# pass replays the kernel pass's routing (a rounding can flip a top-k
# choice, which is no fault of a kernel).
LOGIT_TOL = 0.1
# llava-next-34b's logits against plain attention, on the same pass: at
# d_model 7168 one bf16 rounding of the attention output that falls the
# other way moves the logits by about 0.1 at any depth, so the kernels read
# 0.135 / 0.139 (prefill / decode) and 0.149 / 0.138 (input_embeds) at 60
# layers and 0.125-0.163 at 4 to 30 (``tools/logit_spread.py``; PERF.md),
# above LOGIT_TOL with no fault.  Its limit sits above the largest of those
# readings; ``planted_faults`` runs the same pass with one launch of each
# kernel leaving out a KV block and fails unless the logits read above it.
LOGIT_TOL_OF = {"llava-next-34b": 0.2}
# flash attention's backward (bf16) is held row by row to ``BWD_REL_TOL``
# (the reasoning is in ``launch/decode_compare.py``).  The lse the forward
# saves: f32 sums of exp in another order, 1e-4 absolute.
LSE_TOL = 1e-4
# the backward's checked shapes (B, Sq, Sk, Hq, Hk, D, causal, window): the
# olmo-1b training shape (the headline), llama3-8b's GQA at 1000 tokens,
# whisper-small's encoder (non-causal, 1500 frames, head_dim 64) and its
# cross-attention (Sq != Sk), a sliding window at head_dim 128
BWD_SHAPES = {
    "olmo_train": ((2, 2048, 2048, 16, 16, 128, True, 0),
                   (1, 70, 70, 4, 4, 16, True, 0)),
    "llama3_gqa": ((1, 1000, 1000, 32, 8, 128, True, 0),
                   (1, 40, 40, 4, 2, 16, True, 0)),
    "whisper_encoder": ((2, 1500, 1500, 12, 12, 64, False, 0),
                        (1, 45, 45, 4, 4, 16, False, 0)),
    "whisper_cross": ((4, 64, 1500, 12, 12, 64, False, 0),
                      (2, 8, 45, 4, 4, 16, False, 0)),
    "window": ((1, 1000, 1000, 16, 4, 128, True, 256),
               (1, 70, 70, 4, 2, 16, True, 32)),
}
# the train phase's kernel-vs-plain step (full-width olmo-1b, 2 layers, the
# same params and batch): the loss, and every layer's slice of every
# gradient leaf as its relative L2 error ||g_kernel - g_plain|| / ||g_plain||.
# Both passes are bf16; the attention outputs and gradients differ by single
# bf16 roundings, which the layers carry on, so a sound slice reads well
# under a percent and the limit is 5 % (loss: 0.02 on a loss of ~11).  Two
# planted faults (the first dK/dV tile's dK zeroed in every backward launch; dQ
# taken without delta) must read above it.
TRAIN_GRAD_TOL = 0.05
TRAIN_LOSS_TOL = 0.02
# timed shapes beside ``DECODE_SHAPES`` (full size, then the rehearsal's
# toy): two slots of recurrentgemma-9b on its ring of 2048 keys, one full
# and one not (MQA: 16 query heads on one KV head, head_dim 256); a
# whisper-small decode step's cross-attention, 4 requests over 1500 frames
# (MHA, G = 1, head_dim 64, every length 1500); the llama3-8b headline with
# llava-next-34b's grouping (56 query heads on 8 KV heads, G = 7)
MODEL_DECODE_SHAPES = {
    "recurrentgemma": ((2, 16, 1, 256, 2048, [2048, 1500]),
                       (2, 4, 1, 16, 64, [64, 30])),
    "whisper_cross": ((4, 12, 12, 64, 1500, [1500] * 4),
                      (2, 4, 4, 16, 45, [45, 45])),
    "llava": ((4, 56, 8, 128, 2048, [300, 700, 1000, 1040]),
              (2, 7, 1, 16, 64, [30, 64])),
}
# flash attention's timed shapes (B, S, Hq, Hk, D, window, causal): a
# llama3-8b prompt of 1000 tokens; a recurrentgemma-9b prompt of 4096
# within its window of 2048; a whisper-small encoder layer over 1500 frames
# (non-causal, MHA, head_dim 64)
FLASH_SHAPES = {
    "serving": ((1, 1000, 32, 8, 128, 0, True), (1, 40, 4, 2, 16, 0, True)),
    "recurrentgemma": ((1, 4096, 16, 1, 256, 2048, True),
                       (1, 70, 4, 1, 16, 32, True)),
    "whisper_encoder": ((1, 1500, 12, 12, 64, 0, False),
                        (1, 70, 4, 4, 16, 0, False)),
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def card_uuid(torch, dev) -> str:
    """The card in use as ``nvidia-smi -i`` names it (``nvidia-smi`` does
    not read ``CUDA_VISIBLE_DEVICES``)."""
    return f"GPU-{torch.cuda.get_device_properties(dev).uuid}"


def nvidia_smi_line(uuid: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", "-i", uuid, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, *, iters: int, flush=None) -> float:
    """Median device time of one call of ``fn``, with no host gap inside it
    (``repro_torch.launch.timing.device_ms``); NaN in a rehearsal."""
    if not torch.cuda.is_available():          # rehearsal: no device time
        fn()
        return float("nan")
    from repro_torch.launch.timing import device_ms
    return device_ms(fn, iters=iters, flush=flush)


def enqueue_ms(torch, fn, *, iters: int = 200) -> float:
    """Host time to enqueue one call of ``fn`` (no wait for the device)."""
    if not torch.cuda.is_available():
        return float("nan")
    from repro_torch.launch import timing
    return timing.enqueue_ms(fn, iters=iters)


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def _randn(torch, gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device,
                       dtype=torch.float32).to(dtype)


def _same(torch, a, b) -> bool:
    """Bit equality on the card, where a row's arithmetic does not depend on
    the atom that runs it; the CPU's plain version batches rows differently
    from atom to atom, so the rehearsal compares values."""
    if a.device.type == "cuda":
        return torch.equal(a, b)
    return torch.allclose(a.float(), b.float(), rtol=1e-5, atol=1e-5)


def decode_plan(torch, ops, q, kc, vc):
    """The kernel route a decode call takes (decided in the wrapper before
    the launch) and its split schedule; the plain version on the CPU."""
    if q.device.type != "cuda":
        return {"route": "plain", "nsplit": 1, "chunk": kc.shape[1]}
    return ops.plan(q, kc, vc)


def check_decode(torch, dev, gen, *, B, Hq, Hk, D, S, dtype, lens,
                 strided=False, route=None, nsplit=None):
    """One decode-attention case: the route and split count it takes (where
    given), values, atoms in permuted order bit-equal, rows outside an atom
    untouched.  Returns the max abs error and the plan."""
    from repro_torch.kernels.decode_attention import ops, ref
    dt = getattr(torch, dtype)
    q = _randn(torch, gen, (B, Hq, D), dt, dev)
    if strided:     # a slot range of a stacked cache, as the server holds it
        full_k = _randn(torch, gen, (2, B + 2, S, Hk, D), dt, dev)
        full_v = _randn(torch, gen, (2, B + 2, S, Hk, D), dt, dev)
        kc, vc = full_k[1, 1:B + 1], full_v[1, 1:B + 1]
    else:
        kc = _randn(torch, gen, (B, S, Hk, D), dt, dev)
        vc = _randn(torch, gen, (B, S, Hk, D), dt, dev)
    what = f"decode_attention {dtype} B={B} Hq={Hq} Hk={Hk} D={D} S={S}"
    plan = decode_plan(torch, ops, q, kc, vc)
    if dev.type == "cuda" and ((route and plan["route"] != route)
                               or (nsplit and plan["nsplit"] != nsplit)):
        fail(f"{what}: took {plan}, not route {route} nsplit {nsplit}")
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = ref.decode_attention_ref(q, kc, vc, lens_t)
    got = ops.decode_attention(q, kc, vc, lens_t)
    err = (got.float() - want.float()).abs().max().item()
    if not math.isfinite(err) or err > TOL[("decode", dtype)]:
        fail(f"{what}: max abs err {err} > {TOL[('decode', dtype)]}")
    for b, n in enumerate(lens):
        if n == 0 and got[b].abs().max().item() != 0.0:
            fail("decode_attention: a row of length 0 must give zeros")
    R = B * Hk
    a3 = ops.decode_attention(q, kc, vc, lens_t, n_atoms=3)
    p3 = ops.decode_attention(q, kc, vc, lens_t, n_atoms=3,
                              order=tuple(range(1, min(3, R))) + (0,))
    pR = ops.decode_attention(q, kc, vc, lens_t, n_atoms=R,
                              order=tuple(reversed(range(R))))
    if not (torch.equal(a3, p3) and _same(torch, a3, got)
            and _same(torch, pR, got)):
        fail(f"{what}: atoms do not compose bit for bit")
    start, num = R // 3, max(1, R // 3)
    o = torch.full_like(q, 7.0)
    ops.decode_attention_atom(q, kc, vc, lens_t, o, start=start, num_rows=num)
    og, gg = o.view(R, Hq // Hk, D), got.view(R, Hq // Hk, D)
    inside = torch.zeros(R, dtype=torch.bool, device=dev)
    inside[start:start + num] = True
    if not (torch.equal(og[inside], gg[inside])
            and bool((og[~inside] == 7.0).all())):
        fail("decode_attention_atom wrote outside its rows")
    return err, plan


def check_decode_refuses(torch, dev, gen, *, B, Hq, Hk, D, S, lens):
    """A bf16 cache with a key pitch of Hk*D + 3 elements, which neither TMA
    nor 16-byte loads can address: on the card the wrapper raises before any
    launch (the plain version runs on the CPU).  Returns what it raised."""
    from repro_torch.kernels.decode_attention import ops
    dt = torch.bfloat16
    q = _randn(torch, gen, (B, Hq, D), dt, dev)
    kc, vc = (_randn(torch, gen, (B, S, Hk * D + 3), dt, dev)[
        :, :, 1:1 + Hk * D].unflatten(-1, (Hk, D)) for _ in range(2))
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    before = ops.launches
    try:
        ops.decode_attention(q, kc, vc, lens_t)
    except ValueError as e:
        if ops.launches != before:
            fail("decode_attention launched on a cache it refuses")
        return str(e)
    if dev.type == "cuda":
        fail(f"decode_attention took a key pitch of {Hk * D + 3} elements")
    return None


def row_rel_err(got, want):
    """[B,Sq]: for each query row, the max abs difference over its heads and
    head dims over the row's largest |want| (0 where both are all zeros)."""
    d = (got.float() - want.float()).abs().amax(dim=(2, 3))
    return d / want.float().abs().amax(dim=(2, 3)).clamp_min(1e-30)


def flash_misses(got, want, dtype) -> tuple:
    """(what ``got`` reads against ``want``, its limit): bf16 by
    ``row_rel_err``, f32 by max abs error."""
    if dtype == "bfloat16":
        return row_rel_err(got, want).max().item(), FLASH_REL_TOL
    return (got.float() - want.float()).abs().max().item(), TOL[("flash", dtype)]


def check_flash(torch, dev, gen, *, B, Sq, Sk, Hq, Hk, D, dtype, causal=True,
                window=0):
    from repro_torch.kernels.flash_attention import ops, ref
    dt = getattr(torch, dtype)
    q = _randn(torch, gen, (B, Sq, Hq, D), dt, dev)
    k = _randn(torch, gen, (B, Sk, Hk, D), dt, dev)
    v = _randn(torch, gen, (B, Sk, Hk, D), dt, dev)
    want = ref.attention_ref(q, k, v, causal=causal, window=window)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    err = (got.float() - want.float()).abs().max().item()
    rel, rel_limit = flash_misses(got, want, dtype)
    what = (f"flash_attention {dtype} B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hk={Hk} "
            f"D={D} causal={causal} window={window}")
    if not math.isfinite(err) or err > TOL[("flash", dtype)]:
        fail(f"{what}: max abs err {err} > {TOL[('flash', dtype)]}")
    if not rel <= rel_limit:
        fail(f"{what}: reads {rel} against its plain version, > {rel_limit}")
    unwindowed = None
    if window:      # the kernel run without its window must miss the limit
        unwindowed, _ = flash_misses(
            ops.flash_attention(q, k, v, causal=causal), want, dtype)
        if not unwindowed > rel_limit:
            fail(f"{what}: the kernel without its window reads {unwindowed}, "
                 f"within the limit {rel_limit}")
    a3 = ops.flash_attention(q, k, v, causal=causal, n_atoms=3, window=window)
    p3 = ops.flash_attention(q, k, v, causal=causal, n_atoms=3,
                             order=(1, 2, 0), window=window)
    if not (torch.equal(a3, p3) and _same(torch, a3, got)):
        fail("flash_attention: atoms do not compose bit for bit")
    bq = ops.BLOCK_Q
    nqb = -(-Sq // bq)
    total = B * Hq * nqb
    start, num = total // 3, max(1, total // 3)
    o = torch.full_like(q, 7.0)
    ops.flash_attention_atom(q, k, v, o, start=start, num_tiles=num,
                             causal=causal, window=window)
    # tile t covers rows [qi*bq, (qi+1)*bq) of head bh = t // nqb
    tile_of = (torch.arange(B * Hq, device=dev)[:, None] * nqb
               + torch.arange(Sq, device=dev)[None, :] // bq)    # [B*Hq, Sq]
    inside = ((tile_of >= start) & (tile_of < start + num))
    inside = inside.view(B, Hq, Sq).permute(0, 2, 1)              # [B,Sq,Hq]
    if not (torch.equal(o[inside], got[inside])
            and bool((o[~inside] == 7.0).all())):
        fail("flash_attention_atom wrote outside its tiles")
    return {"max_abs_err": err, "err_limit": TOL[("flash", dtype)],
            "row_err": rel, "row_err_limit": rel_limit,
            "unwindowed_row_err": unwindowed}


def _mm_err(torch, got, want, dtype):
    """(max abs error, its limit) of a matmul result against the plain one."""
    err = (got.float() - want.float()).abs().max().item()
    return err, MM_TOL[dtype] * want.float().abs().max().item()


def matmul_route(torch, ops, a, b, c, bn):
    """The kernel path an atom takes (decided in the wrapper before the
    launch) and its CTA tile."""
    vec = ops.vec16(a, b, c)
    route = ("wgmma+tma" if a.dtype == torch.bfloat16 and vec
             else "cp.async" if vec else "guarded")
    return route, ops.cta_shape(a.dtype, bn, vec)


def check_matmul(torch, dev, gen, *, M, N, K, dtype, bm=128, bn=None,
                 strided=False, route=None):
    """One atom-matmul case: the path it takes (``route``, where given),
    values, atoms in permuted order bit-equal to n=1, tiles outside an atom
    untouched and those inside equal to the plain atom's.  Returns the max
    abs error, the path and its CTA tile."""
    from repro_torch.kernels.atom_matmul import ops, ref
    from repro_torch.kernels.atoms import tile_count
    dt = getattr(torch, dtype)
    bn = bn or bm
    if strided:     # operands that are column ranges of wider matrices
        a = _randn(torch, gen, (M, K + 24), dt, dev)[:, 16:16 + K]
        b = _randn(torch, gen, (K, N + 8), dt, dev)[:, :N]
    else:
        a = _randn(torch, gen, (M, K), dt, dev)
        b = _randn(torch, gen, (K, N), dt, dev)
    what = f"atom_matmul {dtype} M={M} N={N} K={K} block=({bm},{bn})"
    want = ref.matmul_ref(a, b)
    got = ops.atom_matmul(a, b, block_m=bm, block_n=bn)
    took, cta = matmul_route(torch, ops, a, b, got, bn)
    if route is not None and took != route:
        fail(f"{what}: took the {took} path, not {route}")
    err, limit = _mm_err(torch, got, want, dtype)
    if not (math.isfinite(err) and err <= limit):
        fail(f"{what}: max abs err {err} > {limit}")
    total = tile_count(M, N, bm, bn)
    n = min(3, total)
    a3 = ops.atom_matmul(a, b, n_atoms=3, block_m=bm, block_n=bn)
    p3 = ops.atom_matmul(a, b, n_atoms=3, block_m=bm, block_n=bn,
                         order=tuple(range(1, n)) + (0,))
    if not (torch.equal(a3, p3) and _same(torch, a3, got)):
        fail(f"{what}: atoms do not compose bit for bit")
    start, num = total // 3, max(1, total // 3)
    o = torch.full_like(got, 7.0)
    ops.matmul_atom(a, b, o, start=start, num_tiles=num, block_m=bm,
                    block_n=bn)
    r = ref.matmul_atom_ref(a, b, torch.full_like(got, 7.0), start=start,
                            num_tiles=num, block_m=bm, block_n=bn)
    nn = -(-N // bn)
    tile_of = (torch.arange(M, device=dev)[:, None] // bm * nn
               + torch.arange(N, device=dev)[None, :] // bn)
    inside = (tile_of >= start) & (tile_of < start + num)
    if not (_same(torch, o[inside], got[inside])
            and bool((o[~inside] == 7.0).all())
            and _mm_err(torch, o[inside], r[inside], dtype)[0] <= limit):
        fail(f"{what}: matmul_atom wrote outside its tiles or differs from "
             f"the plain atom")
    return err, took, cta


def matmul_headline(torch, dev, gen, flush, iters, real):
    """The atomized matmul at the widest llama3-8b projection of a
    1000-token prefill (w_i / w_g: 4096 -> 14336), one atom."""
    from repro_torch.kernels.atom_matmul import ops, ref
    from repro_torch.kernels.atoms import tile_count
    M, K, N = (1000, 4096, 14336) if real else (40, 64, 300)
    dt = torch.bfloat16
    a = _randn(torch, gen, (M, K), dt, dev)
    b = _randn(torch, gen, (K, N), dt, dev)
    want = ref.matmul_ref(a, b)
    err, limit = _mm_err(torch, ops.atom_matmul(a, b), want, "bfloat16")
    if not err <= limit:
        fail(f"atom_matmul at the projection shape: err {err} > {limit}")
    # the kernel alone: one atom of every tile into an output made once, so
    # the memset of a fresh output is not timed
    c = torch.empty((M, N), dtype=dt, device=dev)
    one = lambda: ops.matmul_atom(a, b, c, start=0,
                                  num_tiles=tile_count(M, N, 256, 256))
    ms = time_ms(torch, one, iters=iters, flush=flush)
    host_ms = enqueue_ms(torch, one)
    err_c = _mm_err(torch, c, want, "bfloat16")[0]
    if not err_c <= limit:
        fail(f"matmul_atom at the projection shape: err {err_c} > {limit}")
    plain_ms = time_ms(torch, lambda: ref.matmul_ref(a, b), iters=iters,
                       flush=flush)
    lib = lambda: torch.matmul(a, b)
    lib_err = _mm_err(torch, lib(), want, "bfloat16")[0]
    if not lib_err <= limit:
        fail(f"library yardstick disagrees with the plain version: {lib_err}")
    library_ms = time_ms(torch, lib, iters=iters, flush=flush)
    n_bytes = (M * K + K * N + M * N) * a.element_size()
    flops = 2 * M * N * K
    t_bytes = n_bytes / H100.hbm_bw * 1e3
    t_ops = flops / H100.peak_flops * 1e3
    return {"shape": {"M": M, "K": K, "N": N, "block_m": 256,
                      "block_n": 256},
            "dtype": "bfloat16", "max_abs_err": err, "err_limit": limit,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "enqueue_ms": host_ms,
            "bytes": n_bytes, "flops": flops,
            "l2": "cold (flushed before every launch)"}


def decode_headline(torch, dev, gen, flush, iters, shape="serving"):
    """Decode attention at one of ``DECODE_SHAPES``, bf16, one atom over
    every row, L2 flushed before each launch.  Held to ``headline_limit``,
    which must lie below what a kernel that dropped one split would read."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    B, Hq, Hk, D, S, lens = {**DECODE_SHAPES, **MODEL_DECODE_SHAPES}[
        shape][flush is None]
    dt = torch.bfloat16
    q = _randn(torch, gen, (B, Hq, D), dt, dev)
    kc = _randn(torch, gen, (B, S, Hk, D), dt, dev)
    vc = _randn(torch, gen, (B, S, Hk, D), dt, dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = ref.decode_attention_ref(q, kc, vc, lens_t)
    got = ops.decode_attention(q, kc, vc, lens_t)
    err = (got.float() - want.float()).abs().max().item()
    limit = headline_limit(want)
    if not err <= limit:
        fail(f"decode_attention at the {shape} shape: err {err} > {limit}")
    plan = decode_plan(torch, ops, q, kc, vc)
    dropped = dropped_split_err(q, kc, vc, lens_t, plan["chunk"])
    if not dropped > limit:
        fail(f"decode_attention at the {shape} shape: a dropped split reads "
             f"{dropped}, within the limit {limit}")
    clusters = (ops.max_active_clusters(D, plan["nsplit"])
                if plan["route"] == "split" else None)
    # the kernel alone: one atom of every row into an output made once, so
    # the memset of a fresh output is not timed
    o = torch.empty_like(q)
    one = lambda: ops.decode_attention_atom(q, kc, vc, lens_t, o, start=0,
                                            num_rows=B * Hk)
    ms = time_ms(torch, one, iters=iters, flush=flush)
    host_ms = enqueue_ms(torch, one)
    if not _same(torch, o, got):
        fail(f"decode_attention_atom at the {shape} shape differs from the "
             f"entry point")
    plain_ms = time_ms(torch, lambda: ref.decode_attention_ref(q, kc, vc, lens_t),
                       iters=iters, flush=flush)
    mask = (torch.arange(S, device=dev)[None, :] < lens_t[:, None])[:, None, None, :]
    q4, k4, v4 = q[:, :, None], kc.transpose(1, 2), vc.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask,
                                                 enable_gqa=True)
    lib_err = (lib()[:, :, 0].float() - want.float()).abs().max().item()
    if not lib_err <= 3e-2:
        fail(f"library yardstick disagrees with the plain version: {lib_err}")
    library_ms = time_ms(torch, lib, iters=iters, flush=flush)
    esz = q.element_size()
    n_bytes = (2 * sum(lens) * Hk * D + 2 * B * Hq * D) * esz + 4 * B
    flops = 4 * sum(lens) * Hq * D
    t_bytes = n_bytes / H100.hbm_bw * 1e3
    t_ops = flops / H100.peak_flops * 1e3
    return {"shape": {"B": B, "Hq": Hq, "Hk": Hk, "D": D, "S": S, "lens": lens},
            "took": plan, "max_active_clusters": clusters,
            "dtype": "bfloat16", "max_abs_err": err, "err_limit": limit,
            "dropped_split_err": dropped, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "enqueue_ms": host_ms,
            "bytes": n_bytes, "flops": flops,
            "l2": "cold (flushed before every launch)"}


def causal_pairs(S: int, window: int = 0) -> int:
    """Unmasked (query, key) pairs of causal self-attention over S tokens,
    each query seeing at most its last ``window`` keys (0: all)."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def flash_headline(torch, dev, gen, iters, real, dtype="bfloat16",
                   shape="serving"):
    """Flash attention at a serving path's shape (``FLASH_SHAPES``), causal
    or not, within the shape's window.  bf16 is held row by row to
    ``FLASH_REL_TOL``; with a window, two planted faults must read above
    that limit: the kernel run without the window, and the plain version
    with the window's first KV block left out of every row whose window is
    whole (the least such row counts)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    B, S, Hq, Hk, D, W, causal = FLASH_SHAPES[shape][0 if real else 1]
    dt = getattr(torch, dtype)
    q = _randn(torch, gen, (B, S, Hq, D), dt, dev)
    k = _randn(torch, gen, (B, S, Hk, D), dt, dev)
    v = _randn(torch, gen, (B, S, Hk, D), dt, dev)
    want = ref.attention_ref(q, k, v, causal=causal, window=W)
    got = ops.flash_attention(q, k, v, causal=causal, window=W)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= TOL[("flash", dtype)]:
        fail(f"flash_attention {dtype} at the {shape} shape: err {err}")
    rel, rel_limit = flash_misses(got, want, dtype)
    if not rel <= rel_limit:
        fail(f"flash_attention {dtype} at the {shape} shape: reads {rel} "
             f"against its plain version, > {rel_limit}")
    faults = None
    if not causal and S % KV_BLOCK and S > KV_BLOCK:
        # a kernel that left out the keys of the last, partial KV block
        whole = S - S % KV_BLOCK
        short = ref.attention_ref(q, k[:, :whole], v[:, :whole],
                                  causal=False)
        faults = {f"last_{S - whole}_keys_dropped":
                  row_rel_err(short, want).min().item()}
    if W:
        drop = min(KV_BLOCK, W // 2)
        late = ref.attention_ref(q, k, v, causal=True, window=W - drop)
        whole = torch.arange(S, device=dev) >= W - 1   # Sq == Sk
        faults = {"no_window": flash_misses(
                      ops.flash_attention(q, k, v, causal=True), want,
                      dtype)[0],
                  f"first_{drop}_keys_of_window_dropped":
                      row_rel_err(late, want)[:, whole].min().item()}
    if faults and not min(faults.values()) > rel_limit:
        fail(f"flash_attention at the {shape} shape: a planted fault "
             f"reads within the limit {rel_limit}: {faults}")
    # the kernel alone: one atom of every tile into an output made once, so
    # the memset of a fresh output is not timed
    o = torch.empty_like(q)
    one = lambda: ops.flash_attention_atom(q, k, v, o, start=0,
                                           num_tiles=ops.tile_space(q),
                                           causal=causal, window=W)
    ms = time_ms(torch, one, iters=iters)
    host_ms = enqueue_ms(torch, one)
    if not _same(torch, o, got):
        fail(f"flash_attention_atom {dtype} at the {shape} shape differs "
             f"from the entry point")
    plain_ms = time_ms(torch, lambda: ref.attention_ref(
        q, k, v, causal=causal, window=W), iters=iters)
    q4, k4, v4 = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if W:       # the band as a boolean mask (True: attend)
        i = torch.arange(S, device=dev)
        band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - W)
        lib = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=band, enable_gqa=True)
    else:
        lib = lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=True)
    lib_err = (lib().transpose(1, 2).float() - want.float()).abs().max().item()
    if not lib_err <= 3e-2:
        fail(f"library yardstick disagrees with the plain version: {lib_err}")
    library_ms = time_ms(torch, lib, iters=iters)
    esz = q.element_size()
    # unmasked (query, key) pairs
    pairs = causal_pairs(S, W) if causal else S * S
    flops = 4 * B * Hq * D * pairs
    n_bytes = (2 * B * S * Hq * D + 2 * B * S * Hk * D) * esz
    t_bytes = n_bytes / H100.hbm_bw * 1e3
    t_ops = flops / (H100.peak_flops if dtype == "bfloat16"
                     else H100.peak_flops_f32) * 1e3
    return {"shape": {"B": B, "Sq": S, "Sk": S, "Hq": Hq, "Hk": Hk, "D": D,
                      "causal": causal, "window": W},
            "dtype": dtype, "max_abs_err": err,
            "err_limit": TOL[("flash", dtype)], "row_err": rel,
            "row_err_limit": rel_limit, "planted_faults": faults, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "enqueue_ms": host_ms,
            "bytes": n_bytes, "flops": flops,
            "ctas_per_sm": (ops.ctas_per_sm(D, dt) if real else None),
            "l2": "warm (the projections have just written q, k, v)"}


def _bwd_inputs(torch, gen, dev, B, Sq, Sk, Hq, Hk, D):
    dt = torch.bfloat16
    return (_randn(torch, gen, (B, Sq, Hq, D), dt, dev),
            _randn(torch, gen, (B, Sk, Hk, D), dt, dev),
            _randn(torch, gen, (B, Sk, Hk, D), dt, dev),
            _randn(torch, gen, (B, Sq, Hq, D), dt, dev))


def _bwd_readings(torch, got, want) -> dict:
    """Row-by-row readings of (dq, dk, dv) against the plain gradients."""
    return {name: bwd_row_err(g, w).max().item()
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}


def check_flash_bwd(torch, dev, gen, *, B, Sq, Sk, Hq, Hk, D, causal,
                    window, with_timing=False, iters=1):
    """The backward kernel (bf16) against autograd of the plain version (f32
    on the same inputs): dQ, dK, dV row by row within ``BWD_REL_TOL``; the
    forward's lse against the plain logsumexp within ``LSE_TOL`` (+inf for
    rows that see no key); atoms (n = 5, permuted) bit-equal to one.  With
    ``with_timing`` also the headline's numbers and two planted faults."""
    from repro_torch.kernels.flash_attention import ops, ref
    q, k, v, do = _bwd_inputs(torch, gen, dev, B, Sq, Sk, Hq, Hk, D)
    kw = dict(causal=causal, window=window)
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    _, lse_plain = ref.attention_ref(q, k, v, return_lse=True, **kw)
    fin = torch.isfinite(lse_plain)
    lse_err = ((lse[fin] - lse_plain[fin]).abs().max().item()
               if bool(fin.any()) else 0.0)
    what = (f"flash_attention_bwd B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hk={Hk} "
            f"D={D} causal={causal} window={window}")
    if not (lse_err <= LSE_TOL and torch.equal(torch.isinf(lse), ~fin)):
        fail(f"{what}: the forward's lse reads {lse_err} against the plain "
             f"logsumexp (limit {LSE_TOL}) or its empty rows differ")
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    out = ref.attention_ref(*leaves, **kw)
    want = torch.autograd.grad(out, leaves, do.float(), retain_graph=True)
    got = ops.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    rows = _bwd_readings(torch, got, want)
    if not max(rows.values()) <= BWD_REL_TOL:
        fail(f"{what}: reads {rows} against autograd of the plain version "
             f"(limit {BWD_REL_TOL})")
    five = ops.flash_attention_bwd(q, k, v, o, do, lse, n_atoms=5,
                                   order=(3, 0, 4, 2, 1), **kw)
    if not all(_same(torch, a, b) for a, b in zip(got, five)):
        fail(f"{what}: atoms do not compose bit for bit")
    res = {"row_err": rows, "row_err_limit": BWD_REL_TOL, "lse_err": lse_err,
           "lse_err_limit": LSE_TOL,
           "max_abs_err": max((g.float() - w).abs().max().item()
                              for g, w in zip(got, want))}
    if not with_timing:
        return res
    # planted faults: dQ without delta; the first dK/dV tile's dK zeroed
    delta = ops.attention_delta(o, do)
    n_dq = ref.bwd_tile_space(q, k, ops.BWD_BLOCK_Q, ops.BWD_BLOCK_K)[0]
    total = ops.bwd_tile_space(q, k)
    dq0, dk0, dv0 = (torch.zeros_like(t) for t in (q, k, v))
    ops.flash_attention_bwd_atom(q, k, v, do, lse, torch.zeros_like(delta),
                                 dq0, dk0, dv0, start=0, num_tiles=n_dq, **kw)
    dk_hole = got[1].clone()
    _, b0, hk0, c0, c1 = ops.bwd_tile(n_dq, q, k)
    dk_hole[b0, c0:c1, hk0] = 0
    faults = {"dq_without_delta": bwd_row_err(dq0, want[0]).max().item(),
              "one_dk_tile_zeroed": bwd_row_err(dk_hole, want[1]).max()
              .item()}
    if not min(faults.values()) > BWD_REL_TOL:
        fail(f"{what}: a planted fault reads within {BWD_REL_TOL}: {faults}")
    # the kernels alone: the delta pass and one atom of every tile into
    # outputs made once
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))

    def one():
        d = ops.attention_delta(o, do)
        ops.flash_attention_bwd_atom(q, k, v, do, lse, d, dq, dk, dv,
                                     start=0, num_tiles=total, **kw)

    ms = time_ms(torch, one, iters=iters)
    if not all(_same(torch, a, b) for a, b in zip((dq, dk, dv), got)):
        fail(f"{what}: the timed atom differs from the entry point")
    plain_ms = time_ms(torch, lambda: torch.autograd.grad(
        out, leaves, do.float(), retain_graph=True), iters=iters)
    # the forward with and without the lse, one atom of every tile; its
    # plain version and the library's forward on the same inputs
    import torch.nn.functional as F
    o1 = torch.empty_like(q)
    fwd = {name: time_ms(torch, lambda extra=extra: ops.flash_attention_atom(
        q, k, v, o1, start=0, num_tiles=ops.tile_space(q), **kw, **extra),
        iters=iters) for name, extra in (("fwd_ms", {}),
                                         ("fwd_lse_ms", {"lse": lse}))}
    fwd["fwd_plain_ms"] = time_ms(
        torch, lambda: ref.attention_ref(q, k, v, **kw), iters=iters)
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    fwd["fwd_library_ms"] = time_ms(
        torch, lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=causal, enable_gqa=True), iters=iters)
    lib_in = [t.transpose(1, 2).detach().requires_grad_(True)
              for t in (q, k, v)]
    lib_out = F.scaled_dot_product_attention(*lib_in, is_causal=causal,
                                             enable_gqa=True)
    do4 = do.transpose(1, 2)
    lib_g = torch.autograd.grad(lib_out, lib_in, do4, retain_graph=True)
    lib_err = max(bwd_row_err(g.transpose(1, 2), w).max().item()
                  for g, w in zip(lib_g, want))
    if not lib_err <= 4 * BWD_REL_TOL:
        fail(f"library yardstick's gradients disagree with the plain "
             f"version: {lib_err}")
    library_ms = time_ms(torch, lambda: torch.autograd.grad(
        lib_out, lib_in, do4, retain_graph=True), iters=iters)
    pairs = causal_pairs(Sq, window) if causal and Sq == Sk else Sq * Sk
    flops = 10 * B * Hq * D * pairs
    # the design's own floor: S and dP are computed in both roles, seven
    # products of 2 D flops a pair
    floor_ms = 14 * B * Hq * D * pairs / H100.peak_flops * 1e3
    esz = q.element_size()
    n_bytes = ((4 * B * Sq * Hq * D + 4 * B * Sk * Hk * D) * esz
               + 2 * B * Hq * Sq * 4)        # q,o,do,dq; k,v,dk,dv; lse,delta
    t_bytes = n_bytes / H100.hbm_bw * 1e3
    t_ops = flops / H100.peak_flops * 1e3
    return {**res, "planted_faults": faults, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "library_row_err": lib_err,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "design_floor_ms": floor_ms, "flops": flops, "bytes": n_bytes,
            **fwd,
            "timed": "the delta pass and one atom of every tile"}


def flash_bwd_cases(torch, dev, gen, real: bool, iters: int) -> dict:
    out = {}
    for name, shapes in BWD_SHAPES.items():
        B, Sq, Sk, Hq, Hk, D, causal, W = shapes[0 if real else 1]
        out[name] = {"shape": {"B": B, "Sq": Sq, "Sk": Sk, "Hq": Hq, "Hk": Hk,
                               "D": D, "causal": causal, "window": W},
                     **check_flash_bwd(torch, dev, gen, B=B, Sq=Sq, Sk=Sk,
                                       Hq=Hq, Hk=Hk, D=D, causal=causal,
                                       window=W, iters=iters,
                                       with_timing=name == "olmo_train")}
    return out


def kernels_phase(torch, dev, real: bool):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    if real:
        dec = [dict(B=4, Hq=32, Hk=8, D=128, S=2048, dtype="bfloat16", lens=[1, 37, 1000, 2048],
                    route="split"),
               dict(B=4, Hq=32, Hk=8, D=128, S=2048, dtype="float32", lens=[2048, 513, 0, 64],
                    route="f32"),
               dict(B=8, Hq=32, Hk=8, D=128, S=2048, dtype="bfloat16",
                    lens=[5, 2048, 31, 32, 33, 999, 1500, 257], strided=True,
                    route="split"),
               dict(B=4, Hq=16, Hk=16, D=128, S=2048, dtype="bfloat16", lens=[100, 2000, 3, 640],
                    route="split"),
               dict(B=2, Hq=8, Hk=2, D=64, S=300, dtype="float32", lens=[300, 17], route="f32"),
               dict(B=2, Hq=24, Hk=2, D=64, S=130, dtype="bfloat16", lens=[130, 64],
                    route="split", nsplit=2),
               dict(B=3, Hq=6, Hk=2, D=128, S=96, dtype="float32", lens=[96, 1, 50], route="f32")]
        # the split kernel at every split count (set by the key blocks of S
        # where the rows are few), lens on the split boundaries (chunk - 1,
        # chunk, chunk + 1, 0, S), two passes of 16 heads (G = 20), enough
        # rows for no split
        dec += [dict(B=3, Hq=32, Hk=8, D=128, S=64, dtype="bfloat16", lens=[0, 63, 64],
                     route="split", nsplit=1),
                dict(B=40, Hq=32, Hk=8, D=128, S=512, dtype="bfloat16",
                     lens=[(37 * i) % 513 for i in range(40)], route="split", nsplit=1),
                dict(B=4, Hq=32, Hk=8, D=128, S=150, dtype="bfloat16", lens=[127, 128, 129, 150],
                     route="split", nsplit=2),
                dict(B=4, Hq=8, Hk=2, D=64, S=300, dtype="bfloat16", lens=[0, 127, 129, 300],
                     route="split", nsplit=4),
                dict(B=2, Hq=40, Hk=2, D=128, S=1000, dtype="bfloat16", lens=[128, 1000],
                     route="split", nsplit=8)]
        # head_dim 256, MQA (recurrentgemma-9b): its ring of 2048 keys full
        # and not, a split count set by a short cache, f32
        dec += [dict(B=2, Hq=16, Hk=1, D=256, S=2048, dtype="bfloat16",
                     lens=[2048, 700], route="split"),
                dict(B=4, Hq=16, Hk=1, D=256, S=300, dtype="bfloat16",
                     lens=[0, 127, 129, 300], route="split", nsplit=4),
                dict(B=3, Hq=16, Hk=1, D=256, S=2048, dtype="float32",
                     lens=[2048, 1, 0], route="f32")]
        # the grouping of llava-next-34b (G = 7: seven of 16 MMA rows in
        # bf16; a pass of 4 heads and one of 3 in f32) and whisper-small's
        # MHA at head_dim 64 (G = 1): the cross K/V of 1500 frames, every
        # length equal, and the self-attention cache of 448 rows
        dec += [dict(B=4, Hq=56, Hk=8, D=128, S=2048, dtype="bfloat16",
                     lens=[1, 300, 1040, 2048], route="split"),
                dict(B=4, Hq=56, Hk=8, D=128, S=2048, dtype="float32",
                     lens=[2048, 700, 0, 65], route="f32"),
                dict(B=4, Hq=12, Hk=12, D=64, S=1500, dtype="bfloat16",
                     lens=[1500] * 4, route="split"),
                dict(B=4, Hq=12, Hk=12, D=64, S=448, dtype="bfloat16",
                     lens=[33] * 4, route="split"),
                dict(B=4, Hq=12, Hk=12, D=64, S=1500, dtype="float32",
                     lens=[1500] * 4, route="f32")]
        refused = [dict(B=3, Hq=16, Hk=4, D=128, S=500, lens=[500, 0, 257]),
                   dict(B=2, Hq=8, Hk=2, D=64, S=333, lens=[65, 333])]
        fl = [dict(B=1, Sq=37, Sk=37, Hq=32, Hk=8, D=128, dtype="bfloat16"),
              dict(B=1, Sq=512, Sk=512, Hq=32, Hk=8, D=128, dtype="bfloat16"),
              dict(B=1, Sq=1000, Sk=1000, Hq=32, Hk=8, D=128, dtype="bfloat16"),
              dict(B=1, Sq=37, Sk=37, Hq=32, Hk=8, D=128, dtype="float32"),
              dict(B=1, Sq=512, Sk=512, Hq=32, Hk=8, D=128, dtype="float32"),
              dict(B=1, Sq=100, Sk=612, Hq=32, Hk=8, D=128, dtype="bfloat16"),
              dict(B=1, Sq=300, Sk=1000, Hq=32, Hk=8, D=128, dtype="float32", causal=False),
              dict(B=1, Sq=255, Sk=255, Hq=16, Hk=16, D=128, dtype="bfloat16"),
              dict(B=2, Sq=130, Sk=130, Hq=4, Hk=4, D=64, dtype="float32"),
              dict(B=2, Sq=90, Sk=50, Hq=6, Hk=2, D=64, dtype="float32")]
        # the bf16 wgmma path at both head dims, causal and not, and chunked
        # prefill (Sq < Sk) with Sk not a multiple of the 64-key block
        fl += [dict(B=1, Sq=1000, Sk=1000, Hq=32, Hk=8, D=128, dtype="bfloat16",
                    causal=False),
               dict(B=2, Sq=200, Sk=200, Hq=8, Hk=2, D=64, dtype="bfloat16"),
               dict(B=2, Sq=200, Sk=200, Hq=8, Hk=2, D=64, dtype="bfloat16",
                    causal=False),
               dict(B=2, Sq=77, Sk=333, Hq=8, Hk=8, D=64, dtype="bfloat16"),
               dict(B=2, Sq=77, Sk=333, Hq=12, Hk=4, D=128, dtype="bfloat16",
                    causal=False),
               dict(B=1, Sq=130, Sk=70, Hq=4, Hk=2, D=128, dtype="bfloat16")]
        # sliding windows (the KV loop starts at the window's first block)
        # and head_dim 256 (recurrentgemma-9b: MQA, window 2048)
        fl += [dict(B=1, Sq=1000, Sk=1000, Hq=32, Hk=8, D=128,
                    dtype="bfloat16", window=256),
               dict(B=2, Sq=500, Sk=500, Hq=8, Hk=2, D=64, dtype="float32",
                    window=100),
               dict(B=1, Sq=4096, Sk=4096, Hq=16, Hk=1, D=256,
                    dtype="bfloat16", window=2048),
               dict(B=1, Sq=100, Sk=612, Hq=16, Hk=1, D=256, dtype="bfloat16",
                    window=128),
               dict(B=2, Sq=300, Sk=300, Hq=16, Hk=1, D=256, dtype="bfloat16"),
               dict(B=1, Sq=77, Sk=333, Hq=16, Hk=1, D=256, dtype="bfloat16",
                    causal=False),
               dict(B=1, Sq=200, Sk=200, Hq=4, Hk=1, D=256, dtype="float32")]
        # whisper-small (MHA, head_dim 64): the encoder over 1500 frames for
        # 4 requests; a 64-token target's cross-attention (Sq != Sk) and
        # causal self-attention; llava-next-34b's prefill (G = 7)
        fl += [dict(B=4, Sq=1500, Sk=1500, Hq=12, Hk=12, D=64,
                    dtype="bfloat16", causal=False),
               dict(B=4, Sq=64, Sk=1500, Hq=12, Hk=12, D=64,
                    dtype="bfloat16", causal=False),
               dict(B=4, Sq=64, Sk=64, Hq=12, Hk=12, D=64, dtype="bfloat16"),
               dict(B=2, Sq=100, Sk=1500, Hq=12, Hk=12, D=64,
                    dtype="float32", causal=False),
               dict(B=1, Sq=1000, Sk=1000, Hq=56, Hk=8, D=128,
                    dtype="bfloat16"),
               dict(B=1, Sq=300, Sk=300, Hq=56, Hk=8, D=128, dtype="float32")]
        # the reference's test shapes (tests/test_kernels.py) at block 128;
        # the llama3-8b projections of a 1000-token prefill and of a
        # 4-slot decode step at the default block 256
        mm = [dict(M=M, N=N, K=K, dtype=dt)
              for M, N, K in ((128, 128, 128), (300, 260, 200),
                              (64, 512, 96), (257, 129, 65))
              for dt in ("float32", "bfloat16")]
        mm += [dict(M=1000, K=K, N=N, dtype="bfloat16", bm=256)
               for K, N in ((4096, 4096), (4096, 1024), (4096, 14336),
                            (14336, 4096))]
        mm += [dict(M=4, K=4096, N=14336, dtype="bfloat16", bm=256),
               dict(M=1024, N=1024, K=1024, dtype="float32", bm=256),
               dict(M=300, N=700, K=70, dtype="bfloat16", bm=128, bn=384),
               dict(M=200, N=260, K=96, dtype="float32", bm=256, bn=128,
                    strided=True)]
        # the bf16 paths: wgmma+TMA with 128 x 256 and 128 x 128 CTA tiles at
        # ragged M, N, K; a column-range view (row pitch wider than its
        # width); K = 65, whose rows TMA cannot address
        mm += [dict(M=1000, N=1000, K=200, dtype="bfloat16", bm=256,
                    route="wgmma+tma"),
               dict(M=1000, N=1000, K=200, dtype="bfloat16", bm=128,
                    route="wgmma+tma"),
               dict(M=300, N=512, K=256, dtype="bfloat16", bm=128, bn=256,
                    strided=True, route="wgmma+tma"),
               dict(M=1000, N=1024, K=65, dtype="bfloat16", bm=256,
                    route="guarded")]
    else:
        dec = [dict(B=3, Hq=4, Hk=2, D=16, S=40, dtype="float32", lens=[40, 0, 7]),
               dict(B=2, Hq=4, Hk=4, D=16, S=33, dtype="bfloat16", lens=[1, 33], strided=True),
               dict(B=2, Hq=7, Hk=1, D=16, S=45, dtype="bfloat16", lens=[45, 45])]
        refused = [dict(B=2, Hq=4, Hk=2, D=16, S=70, lens=[0, 70])]
        fl = [dict(B=2, Sq=70, Sk=70, Hq=4, Hk=2, D=16, dtype="float32"),
              dict(B=1, Sq=20, Sk=90, Hq=4, Hk=1, D=16, dtype="bfloat16"),
              dict(B=1, Sq=90, Sk=50, Hq=2, Hk=2, D=16, dtype="float32"),
              dict(B=1, Sq=70, Sk=70, Hq=4, Hk=1, D=16, dtype="bfloat16",
                   window=32),
              dict(B=2, Sq=45, Sk=45, Hq=4, Hk=4, D=16, dtype="bfloat16",
                   causal=False)]
        mm = [dict(M=257, N=129, K=65, dtype="float32"),
              dict(M=40, N=300, K=64, dtype="bfloat16", bm=256,
                   route="guarded"),
              dict(M=40, N=264, K=72, dtype="bfloat16", bm=128, bn=256,
                   route="wgmma+tma"),
              dict(M=70, N=300, K=24, dtype="bfloat16", bm=128, bn=256,
                   strided=True)]
    for c in dec:
        err, plan = check_decode(torch, dev, gen, **c)
        cases.append({"kernel": "decode_attention", **c, "took": plan,
                      "max_abs_err": err,
                      "err_limit": TOL[("decode", c["dtype"])]})
    took = {(c["took"]["route"], c["took"]["nsplit"]) for c in cases}
    if real and not ({("split", n) for n in (1, 2, 4, 8)}
                     | {("f32", 1)}) <= took:
        fail(f"decode_attention cases reached only {sorted(took)}")
    for c in refused:
        cases.append({"kernel": "decode_attention", **c, "dtype": "bfloat16",
                      "key_pitch": c["Hk"] * c["D"] + 3,
                      "raised": check_decode_refuses(torch, dev, gen, **c)})
    for c in fl:
        cases.append({"kernel": "flash_attention", **c,
                      **check_flash(torch, dev, gen, **c)})
    for c in mm:
        err, took, cta = check_matmul(torch, dev, gen, **c)
        cases.append({"kernel": "atom_matmul", **c, "path": took,
                      "cta_tile": cta, "max_abs_err": err,
                      "err_limit": f"{MM_TOL[c['dtype']]} x max|output|"})
    flush = (torch.empty(256 << 20, dtype=torch.uint8, device=dev)
             if real else None)
    k1 = decode_headline(torch, dev, gen, flush, iters=30 if real else 1)
    k1_long = decode_headline(torch, dev, gen, flush, iters=30 if real else 1,
                              shape="long_context")
    k1_ring = decode_headline(torch, dev, gen, flush,
                              iters=30 if real else 1, shape="recurrentgemma")
    k1_cross = decode_headline(torch, dev, gen, flush,
                               iters=30 if real else 1, shape="whisper_cross")
    k1_llava = decode_headline(torch, dev, gen, flush,
                               iters=30 if real else 1, shape="llava")
    k2 = flash_headline(torch, dev, gen, iters=20 if real else 1, real=real)
    k2_window = flash_headline(torch, dev, gen, iters=10 if real else 1,
                               real=real, shape="recurrentgemma")
    k2_f32 = flash_headline(torch, dev, gen, iters=10 if real else 1,
                            real=real, dtype="float32")
    k2_encoder = flash_headline(torch, dev, gen, iters=20 if real else 1,
                                real=real, shape="whisper_encoder")
    k3 = matmul_headline(torch, dev, gen, flush, iters=20 if real else 1,
                         real=real)
    bwd = flash_bwd_cases(torch, dev, gen, real, iters=10 if real else 1)
    del flush
    if real:
        torch.cuda.synchronize()
    emit("kernels", cases=cases, decode_attention=k1,
         decode_attention_long_context=k1_long,
         decode_attention_ring_d256=k1_ring,
         decode_attention_whisper_cross=k1_cross,
         decode_attention_llava_g7=k1_llava, flash_attention=k2,
         flash_attention_window_d256=k2_window,
         flash_attention_float32=k2_f32,
         flash_attention_whisper_encoder=k2_encoder, atom_matmul=k3,
         flash_attention_bwd=bwd,
         checked=["values", "atoms (n=3) in permuted order bit-equal to n=1",
                  "decode: atoms (n=R) in reversed order bit-equal to n=1",
                  "rows / tiles outside an atom untouched",
                  "the route (and decode's split count) each case took",
                  "decode: key pitches the kernels cannot address raise",
                  "flash bf16: each query row within 2^-6 of its max|output|"
                  " (f32: max abs error)",
                  "flash: with a window, the kernel without it reads above "
                  "that limit",
                  "flash windowed headline: a window started one KV block "
                  "late reads above that limit in every whole-window row",
                  "flash whisper-encoder headline: the last, partial KV "
                  "block left out reads above that limit in every row",
                  "decode headlines: max abs error within 2^-6 of max|output|,"
                  " below what one dropped split reads",
                  "flash backward: dQ, dK, dV row by row within 2^-5 of "
                  "autograd of the plain version; the forward's lse against "
                  "the plain logsumexp; atoms (n=5) in permuted order "
                  "bit-equal to n=1; at the olmo-1b shape, dQ without delta "
                  "and one dK tile zeroed read above that limit"])
    return k1, k2, k3, bwd["olmo_train"]


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def _wrappers():
    """Each kernel's launch counter: (module, attribute)."""
    from repro_torch.kernels.atom_matmul import ops as m_ops
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.flash_attention import ops as f_ops
    return {"decode_attention": (d_ops, "launches"),
            "flash_attention": (f_ops, "launches"),
            "atom_matmul": (m_ops, "launches"),
            "flash_attention_bwd": (f_ops, "bwd_launches"),
            "attention_delta": (f_ops, "delta_launches")}


NO_TRAINING = {"flash_attention_bwd": 0, "attention_delta": 0}


def reset_counts():
    for ops, attr in _wrappers().values():
        setattr(ops, attr, 0)


def read_counts():
    return {name: getattr(ops, attr)
            for name, (ops, attr) in _wrappers().items()}


@contextlib.contextmanager
def count_calls(module, names):
    """Count the calls the engine makes to ``module.<name>``."""
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(module, n) for n in names}

    def wrap(n):
        def f(*a, **kw):
            counts[n] += 1
            return saved[n](*a, **kw)
        return f

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield counts
    finally:
        for n in names:
            setattr(module, n, saved[n])


@contextlib.contextmanager
def plain_attention():
    """Harness-only: route the wrappers' atoms (decode, flash forward, flash
    backward and its delta pass) to their plain versions, for holding the
    model path with kernels against the same path without."""
    from repro_torch.kernels.decode_attention import ops as d_ops, ref as d_ref
    from repro_torch.kernels.flash_attention import ops as f_ops, ref as f_ref
    saved = (d_ops.decode_attention_atom, f_ops.flash_attention_atom,
             f_ops.flash_attention_bwd_atom, f_ops.attention_delta)
    d_ops.decode_attention_atom = d_ref.decode_attention_atom_ref
    f_ops.flash_attention_atom = f_ref.flash_attention_atom_ref
    f_ops.flash_attention_bwd_atom = f_ref.flash_attention_bwd_atom_ref
    f_ops.attention_delta = f_ref.attention_delta_ref
    try:
        yield
    finally:
        (d_ops.decode_attention_atom, f_ops.flash_attention_atom,
         f_ops.flash_attention_bwd_atom, f_ops.attention_delta) = saved


@contextlib.contextmanager
def backward_fault(torch, kind: str):
    """Harness-only: every backward launch of the pass with a planted
    fault: ``dk_tile`` zeroes the dK of the first dK/dV tile (as
    ``ops.bwd_tile`` maps it: batch row 0, KV head 0, the first
    ``BWD_BLOCK_K`` keys); ``no_delta`` takes dQ without delta (dS =
    P dP)."""
    from repro_torch.kernels.flash_attention import ops as f_ops, ref as f_ref
    saved = f_ops.flash_attention_bwd_atom
    hits = [0]

    def atom(q, k, v, do, lse, delta, dq, dk, dv, *, start, num_tiles,
             **kw):
        saved(q, k, v, do, lse, delta, dq, dk, dv, start=start,
              num_tiles=num_tiles, **kw)
        n_dq = f_ref.bwd_tile_space(q, k, f_ops.BWD_BLOCK_Q,
                                    f_ops.BWD_BLOCK_K)[0]
        if kind == "dk_tile" and start <= n_dq < start + num_tiles:
            _, b, hk, c0, c1 = f_ops.bwd_tile(n_dq, q, k)
            dk[b, c0:c1, hk] = 0
            hits[0] += 1
        if kind == "no_delta" and start < n_dq:
            scratch = [torch.empty_like(t) for t in (dk, dv)]
            saved(q, k, v, do, lse, torch.zeros_like(delta), dq, *scratch,
                  start=start, num_tiles=min(num_tiles, n_dq - start), **kw)
            hits[0] += 1
        return dq, dk, dv

    f_ops.flash_attention_bwd_atom = atom
    try:
        yield hits
    finally:
        f_ops.flash_attention_bwd_atom = saved


@contextlib.contextmanager
def planted_faults(torch, kernel: str):
    """Harness-only: the first launch of ``kernel`` in the pass leaves its
    first KV block (``KV_BLOCK`` keys) out, as a kernel that dropped one
    block or one decode split would: flash attention recomputes the query
    rows past the block over the keys past it (causal, so each row keeps its
    own keys after the block); decode attention runs over the cache past
    the block, each row's length cut by as much."""
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.flash_attention import ops as f_ops
    saved = d_ops.decode_attention_atom, f_ops.flash_attention_atom
    left = [1]

    def hit(keys) -> bool:
        if left[0] and keys > KV_BLOCK:
            left[0] -= 1
            return True
        return False

    def decode(q, kc, vc, lens, o, *, start, num_rows):
        if not hit(kc.shape[1]):
            return saved[0](q, kc, vc, lens, o, start=start,
                            num_rows=num_rows)
        cut = (lens - KV_BLOCK).clamp_min(1).to(torch.int32).contiguous()
        return saved[0](q, kc[:, KV_BLOCK:].contiguous(),
                        vc[:, KV_BLOCK:].contiguous(), cut, o, start=start,
                        num_rows=num_rows)

    def flash(q, k, v, o, *, start, num_tiles, causal=True,
              block_q=f_ops.BLOCK_Q, window=0):
        saved[1](q, k, v, o, start=start, num_tiles=num_tiles, causal=causal,
                 block_q=block_q, window=window)
        if (causal and q.shape[1] == k.shape[1] and start == 0
                and num_tiles == f_ops.tile_space(q, block_q)
                and hit(k.shape[1])):
            qs, ks, vs = (t[:, KV_BLOCK:].contiguous() for t in (q, k, v))
            part = torch.empty_like(qs)
            saved[1](qs, ks, vs, part, start=0,
                     num_tiles=f_ops.tile_space(qs, block_q), causal=True,
                     block_q=block_q, window=window)
            o[:, KV_BLOCK:] = part
        return o

    if kernel == "decode_attention":
        d_ops.decode_attention_atom = decode
    else:
        f_ops.flash_attention_atom = flash
    try:
        yield left
    finally:
        d_ops.decode_attention_atom, f_ops.flash_attention_atom = saved


def fault_readings(torch, run, kernel_out, limit) -> dict:
    """``run()`` (a pass's logits as a tuple) once with a planted fault in
    each kernel; fails unless each fault reached the pass and its logits
    read above ``limit`` against the sound kernel pass."""
    out = {}
    for kernel in ("flash_attention", "decode_attention"):
        with planted_faults(torch, kernel) as left:
            got = run()
        if left[0]:
            fail(f"planted {kernel} fault never reached the pass")
        out[kernel] = max((a.float() - b.float()).abs().max().item()
                          for a, b in zip(got, kernel_out))
        if not out[kernel] > limit:
            fail(f"a {kernel} launch that leaves a KV block out moves the "
                 f"logits by {out[kernel]}, not above the limit {limit}")
    return out


@contextlib.contextmanager
def launch_checks(torch, worst):
    """Harness-only: after each attention launch that writes its whole
    output (every launch of the serving path), hold the output to the plain
    version on the same inputs: bf16 flash attention row by row
    (``FLASH_REL_TOL``), f32 by ``TOL``; bf16 decode attention by its max
    abs error over its max|output| (``DECODE_REL_TOL``), f32 by ``TOL``.
    Records the worst reading of each kernel in ``worst`` and fails at the
    first launch above its limit."""
    from repro_torch.kernels.decode_attention import ops as d_ops, ref as d_ref
    from repro_torch.kernels.flash_attention import ops as f_ops, ref as f_ref
    saved = d_ops.decode_attention_atom, f_ops.flash_attention_atom

    def note(kernel, err, limit):
        worst[kernel] = max(worst.get(kernel, 0.0), err)
        worst[f"{kernel}_launches_checked"] = worst.get(
            f"{kernel}_launches_checked", 0) + 1
        if not err <= limit:
            fail(f"{kernel} on the path reads {err} against its plain "
                 f"version on the same inputs (limit {limit})")

    def decode(q, kc, vc, lens, o, *, start, num_rows):
        saved[0](q, kc, vc, lens, o, start=start, num_rows=num_rows)
        if start == 0 and num_rows == q.shape[0] * kc.shape[2]:
            want = d_ref.decode_attention_ref(q, kc, vc, lens).float()
            err = (o.float() - want).abs().max().item()
            if q.dtype == torch.bfloat16:
                note("decode_attention",
                     err / max(want.abs().max().item(), 1e-30),
                     DECODE_REL_TOL)
            else:
                note("decode_attention", err, TOL[("decode", "float32")])
        return o

    def flash(q, k, v, o, *, start, num_tiles, causal=True,
              block_q=f_ops.BLOCK_Q, window=0):
        saved[1](q, k, v, o, start=start, num_tiles=num_tiles,
                 causal=causal, block_q=block_q, window=window)
        if start == 0 and num_tiles == f_ops.tile_space(q, block_q):
            want = f_ref.attention_ref(q, k, v, causal=causal, window=window)
            note("flash_attention", *flash_misses(
                o, want, str(q.dtype).split(".")[-1]))
        return o

    d_ops.decode_attention_atom, f_ops.flash_attention_atom = decode, flash
    try:
        yield worst
    finally:
        d_ops.decode_attention_atom, f_ops.flash_attention_atom = saved


@contextlib.contextmanager
def moe_routing(log, replay: bool):
    """Harness-only: record every MoE layer's expert choices into ``log`` in
    call order, or replay them in that order (``replay``), so that a plain
    pass routes its tokens as the kernel pass did."""
    from repro_torch.models import moe
    saved = moe.apply_moe
    it = iter(list(log)) if replay else None

    def apply_moe(params, x, cfg, **kw):
        if replay:
            return saved(params, x, cfg, expert_ids=next(it))
        out, aux, ids = saved(params, x, cfg, return_ids=True)
        log.append(ids)
        return out, aux

    moe.apply_moe = apply_moe
    try:
        yield log
    finally:
        moe.apply_moe = saved


def routing_flips(torch, a, b) -> int:
    """Expert choices (token, slot of top-k) that differ between two
    recorded routings, as sets per token."""
    return sum(int((x.sort(-1).values != y.sort(-1).values).sum())
               for x, y in zip(a, b))


# kernel kinds of a profile, by words of the kernel's name (first match)
KERNEL_KINDS = (
    ("flash_attention_bwd", ("flash_attn_bwd", "delta_kernel")),
    ("flash_attention", ("flash_attn",)),
    ("decode_attention", ("decode_",)),
    ("gemm", ("gemm", "xmma", "cutlass", "nvjet", "cublas", "matmul")),
    ("elementwise_and_reductions", ("elementwise", "reduce", "vectorized",
                                    "unrolled", "softmax", "norm", "cat",
                                    "index", "scatter", "gather", "copy")))


def _by_kind(rows) -> dict:
    """Device ms of a profile's rows (name, ms, calls) summed by kind."""
    out = {k: 0.0 for k, _ in KERNEL_KINDS}
    out["other"] = 0.0
    for name, ms, _ in rows:
        low = name.lower()
        kind = next((k for k, words in KERNEL_KINDS
                     if any(w in low for w in words)), "other")
        out[kind] += ms
    return out


def profile_windows(torch, windows: dict) -> dict:
    """Each window (a function that ends in a synchronise) once to warm up,
    once timed on the host clock, once under ``torch.profiler``: wall ms,
    device busy ms (the device-side rows), idle share, top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for kind, window in windows.items():
        window()                                      # warm up
        t0 = time.perf_counter()
        window()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            window()
        # device-side rows only: an operator's row repeats its kernels' time
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        out[kind] = {"wall_ms_unprofiled": wall_ms, "device_busy_ms": busy,
                     "device_idle_share": max(0.0, 1 - busy / wall_ms),
                     "by_kind_ms": _by_kind(rows),
                     "top": [{"kernel": k[:60], "ms": ms, "calls": n}
                             for k, ms, n in rows[:10]]}
    return out


def profile_phase(torch, dev, cfg, params, arch: str) -> None:
    """``--profile``: device time by kernel over one 1000-token prefill and
    eight decode steps of 4 slots, from ``torch.profiler``; a model with a
    sliding window takes a prompt of 2100 tokens and positions past it."""
    from repro_torch.models import transformer
    windowed = cfg.hybrid is not None and cfg.hybrid.window > 0
    B, L, plen = (4, 4608, 2100) if windowed else (4, 2048, 1000)
    caches = transformer.init_caches(cfg, B, L, device=dev)
    toks = torch.randint(2, cfg.vocab_size, (1, plen), device=dev)
    last = torch.randint(2, cfg.vocab_size, (B,), device=dev)
    pos = torch.tensor([300, 700, 1000, 1040], device=dev) + (plen - 1000)

    def prefill():
        transformer.prefill(params, cfg, toks, caches=caches, slot=2)
        torch.cuda.synchronize()

    def decode():
        for i in range(8):
            transformer.decode_step(params, cfg, last, pos + i, caches)
        torch.cuda.synchronize()

    out = profile_windows(torch, {"prefill": prefill, "decode": decode})
    emit("profile", arch=arch, window={"prefill": f"1 prompt of {plen} tokens",
                                       "decode": "8 steps, 4 slots"}, **out)


def embeds_vs_plain(torch, dev, cfg, params, plen: int) -> dict:
    """A VLM's ``input_embeds`` path (through ``vlm_proj``): a prompt of
    ``plen`` embedding rows through ``prefill`` and one embedding row
    through ``decode_step``, with the kernels and with plain attention."""
    from repro_torch.models import transformer
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    dt = getattr(torch, cfg.dtype)
    emb = _randn(torch, gen, (2, plen + 1, cfg.d_model), dt, dev)

    def run():
        lp, caches = transformer.prefill(params, cfg, None,
                                         input_embeds=emb[:, :plen],
                                         max_len=plen + 8)
        ld, _ = transformer.decode_step(params, cfg, None, plen, caches,
                                        input_embeds=emb[:, plen:])
        return lp, ld

    checked = {}
    before = read_counts()
    with launch_checks(torch, checked):
        lp_k, ld_k = run()
    after = read_counts()
    with plain_attention():
        lp_p, ld_p = run()
    n_attn = transformer.attention_layers(cfg)
    if dev.type == "cuda" and (
            after["flash_attention"] - before["flash_attention"] != n_attn
            or after["decode_attention"] - before["decode_attention"]
            != n_attn):
        fail(f"{cfg.name}: the input_embeds path launched "
             f"{after} - {before}, not {n_attn} of each attention kernel")
    for a in (lp_k, ld_k):
        if a.shape != (2, cfg.vocab_size) or not bool(torch.isfinite(a).all()):
            fail(f"{cfg.name}: input_embeds logits not finite or of shape "
                 f"{tuple(a.shape)}")
    errs = {"prefill": (lp_k - lp_p).abs().max().item(),
            "decode": (ld_k - ld_p).abs().max().item()}
    limit = LOGIT_TOL_OF.get(cfg.name, LOGIT_TOL)
    if dev.type == "cuda" and max(errs.values()) > limit:
        fail(f"{cfg.name}: input_embeds, kernels vs plain attention: {errs} "
             f"(limit {limit})")
    return {**errs, "limit": limit,
            "embedding_rows": plen, "logit_abs_max": lp_p.abs().max().item(),
            "launches_vs_plain": checked}


def serve_phase(torch, dev, arch: str, *, real: bool, n_requests, max_slots,
                max_len, max_new, with_profile: bool = False,
                min_prompt: int = 4, check_len: int = 200):
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    from repro_torch.models.registry import init_model

    cfg = get_config(arch)
    if not real:
        cfg = cfg.reduced()
    if real:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_model(cfg, seed=0, device=dev)
    if real:
        torch.cuda.synchronize()
    init_s = time.time() - t0
    init_peak = torch.cuda.max_memory_allocated() if real else None
    if real:        # the serving path's own peak, without init's f32 draws
        torch.cuda.reset_peak_memory_stats()

    # the main path, through the launcher's entry point, counts set to 0 first
    reset_counts()
    with count_calls(transformer, ("prefill", "decode_step")) as calls:
        t0 = time.time()
        done, lats = serve(cfg, n_requests=n_requests, max_slots=max_slots,
                           max_len=max_len, max_new=max_new, seed=0,
                           verbose=False, device=dev, params=params,
                           min_prompt=min_prompt)
        if real:
            torch.cuda.synchronize()
        serve_s = time.time() - t0
    launches = read_counts()
    serve_peak = torch.cuda.max_memory_allocated() if real else None

    if len(done) != n_requests:
        fail(f"{arch}: {len(done)} of {n_requests} requests finished")
    for r in done:
        out = r.output
        if not (len(out) == max_new or (out and out[-1] == 1)):
            fail(f"{arch}: request {r.rid} ended with {len(out)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in out):
            fail(f"{arch}: token out of range in request {r.rid}")
        if r.t_first_token is None or r.t_finish is None:
            fail(f"{arch}: request {r.rid} has no timestamps")
    # one launch of each attention kernel per attention layer a prefill /
    # decode step (none in a model without attention)
    n_attn = transformer.attention_layers(cfg)
    want = {"flash_attention": calls["prefill"] * n_attn,
            "decode_attention": calls["decode_step"] * n_attn,
            "atom_matmul": 0,           # not on the serving path
            **NO_TRAINING}
    if real and (launches != want or (n_attn and (
            launches["flash_attention"] == 0
            or launches["decode_attention"] == 0))):
        fail(f"{arch}: launch counts {launches} but the path implies {want}")
    if calls["prefill"] != n_requests or calls["decode_step"] == 0:
        fail(f"{arch}: {calls} engine calls for {n_requests} requests")

    # the path against itself: kernels vs plain attention, same params/prompt
    # (an MoE model's plain pass on the kernel pass's routing)
    rng = np.random.default_rng(1)
    plen = min(check_len, max_len // 2)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, (2, plen)),
                           device=dev)
    nxt = torch.as_tensor(rng.integers(2, cfg.vocab_size, (2,)), device=dev)
    pos = torch.tensor([plen, plen], device=dev)

    def run():
        lp, caches = transformer.prefill(params, cfg, toks, max_len=plen + 8)
        ld, _ = transformer.decode_step(params, cfg, nxt, pos, caches)
        return lp.float(), ld.float()

    routing = None
    checked = {}
    if cfg.moe is None:
        with launch_checks(torch, checked):
            lp_k, ld_k = run()
        with plain_attention():
            lp_p, ld_p = run()
    else:
        with moe_routing([], replay=False) as kernel_ids, \
                launch_checks(torch, checked):
            lp_k, ld_k = run()
        with plain_attention(), moe_routing(kernel_ids, replay=True):
            lp_p, ld_p = run()
        with plain_attention(), moe_routing([], replay=False) as own_ids:
            lp_o, ld_o = run()
        routing = {"replayed": True, "choices": sum(int(x.numel())
                                                    for x in kernel_ids),
                   "flips_unreplayed": routing_flips(torch, kernel_ids,
                                                     own_ids),
                   "logit_err_unreplayed": max(
                       (lp_k - lp_o).abs().max().item(),
                       (ld_k - ld_o).abs().max().item())}
    for name, a, b in (("prefill", lp_k, lp_p), ("decode", ld_k, ld_p)):
        if a.shape != (2, cfg.vocab_size) or not bool(torch.isfinite(a).all()):
            fail(f"{arch}: {name} logits not finite or of shape {tuple(a.shape)}")
    err_p = (lp_k - lp_p).abs().max().item()
    err_d = (ld_k - ld_p).abs().max().item()
    limit = LOGIT_TOL_OF.get(arch, LOGIT_TOL)
    if real and max(err_p, err_d) > limit:
        fail(f"{arch}: kernels vs plain attention: prefill logits differ by "
             f"{err_p}, decode logits by {err_d} (limit {limit})")
    # a limit of its own must still see a kernel that leaves a block out
    faults = (fault_readings(torch, run, (lp_k, ld_k), limit)
              if real and arch in LOGIT_TOL_OF else None)

    vlm = (embeds_vs_plain(torch, dev, cfg, params, plen)
           if cfg.frontend == "patch_stub" else None)

    tokens = sum(len(r.output) for r in done)
    emit("serve", arch=arch, full_size=real, n_layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, requests=len(done),
         max_slots=max_slots, max_len=max_len, tokens=tokens,
         prompt_tokens=int(sum(len(r.tokens) for r in done)),
         longest_prompt=int(max(len(r.tokens) for r in done)),
         init_seconds=init_s, seconds=serve_s, tokens_per_s=tokens / serve_s,
         p50_latency_s=float(np.percentile(lats, 50)),
         prefills=calls["prefill"], decode_steps=calls["decode_step"],
         attention_layers=n_attn, launches=launches,
         logit_err_vs_plain={"prefill": err_p, "decode": err_d,
                             "limit": limit, "planted_faults": faults,
                             "prompt_tokens": plen,
                             "logit_abs_max": lp_p.abs().max().item(),
                             "moe_routing": routing},
         launches_vs_plain=checked,
         input_embeds_vs_plain=vlm,
         peak_memory_bytes=serve_peak, init_peak_memory_bytes=init_peak)
    if with_profile and real:
        profile_phase(torch, dev, cfg, params, arch)
    del params
    if real:
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the encoder-decoder path
# ---------------------------------------------------------------------------

def encdec_phase(torch, dev, *, real: bool, batch: int, new_tokens: int,
                 max_len: int, prompt: int = 4, target: int = 64,
                 with_profile: bool = False):
    """whisper-small through ``repro_torch.models.registry``: ``batch``
    requests of random frames (1500 at full size) and a ``prompt``-token
    prompt, ``serve_prefill`` (encode, the cross K/V, the first token at
    position 0), then ``new_tokens`` greedy ``serve_decode`` steps at
    positions 1, 2, ...  Counts set to 0 just before, read just after: flash
    attention once per encoder layer, decode attention twice per decoder
    layer a step (the prefill is one).  Then the path against itself with
    plain attention: ``serve_prefill``, three decode steps and ``forward``
    at a ``target``-token target.  ``with_profile`` adds a ``profile``
    line: ``serve_prefill`` of the batch, then eight decode steps."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import encdec
    from repro_torch.models.registry import (init_model, serve_decode,
                                             serve_prefill)
    cfg = get_config("whisper-small")
    if not real:
        cfg = cfg.reduced()
    S_src = cfg.max_source_positions if real else 45
    if real:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = init_model(cfg, seed=0, device=dev)
    if real:
        torch.cuda.synchronize()
    init_s = time.time() - t0
    init_peak = torch.cuda.max_memory_allocated() if real else None
    if real:
        torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    dt = getattr(torch, cfg.dtype)
    frames = _randn(torch, gen, (batch, S_src, cfg.d_model), dt, dev)
    toks = torch.randint(2, cfg.vocab_size, (batch, prompt), generator=gen,
                         device=dev)
    inputs = {"frames": frames, "tokens": toks}

    # the main path, counts set to 0 first
    reset_counts()
    with count_calls(encdec, ("encode", "decode_step")) as calls:
        t0 = time.time()
        logits, caches = serve_prefill(params, cfg, inputs, max_len=max_len)
        out = [logits.argmax(-1)]
        if real:
            torch.cuda.synchronize()
        prefill_s = time.time() - t0
        for pos in range(1, new_tokens + 1):
            logits, caches = serve_decode(params, cfg, out[-1], pos, caches)
            out.append(logits.argmax(-1))
        streams = torch.stack(out, 1).cpu()
        seconds = time.time() - t0
    launches = read_counts()
    serve_peak = torch.cuda.max_memory_allocated() if real else None
    want = {"flash_attention": calls["encode"] * cfg.n_encoder_layers,
            "decode_attention": calls["decode_step"] * 2 * cfg.n_layers,
            "atom_matmul": 0, **NO_TRAINING}
    if (calls["encode"], calls["decode_step"]) != (1, new_tokens + 1):
        fail(f"whisper-small: {calls} calls for one prefill and "
             f"{new_tokens} decode steps")
    if real and launches != want:
        fail(f"whisper-small: launch counts {launches} but the path implies "
             f"{want}")
    if not (bool(torch.isfinite(logits).all())
            and tuple(logits.shape) == (batch, cfg.vocab_size)
            and tuple(streams.shape) == (batch, new_tokens + 1)
            and bool(((streams >= 0) & (streams < cfg.vocab_size)).all())):
        fail(f"whisper-small: logits {tuple(logits.shape)} or tokens "
             f"{tuple(streams.shape)} out of shape or range")

    # the path against itself: kernels vs plain attention
    tgt = torch.randint(2, cfg.vocab_size, (batch, target), generator=gen,
                        device=dev)

    def run():
        lp, c = serve_prefill(params, cfg, inputs, max_len=max_len)
        res = {"prefill": lp}
        for i in range(3):
            res[f"decode_{i + 1}"], c = serve_decode(params, cfg, tgt[:, i],
                                                     1 + i, c)
        h = encdec.forward(params, cfg, frames, tgt)
        res["forward"] = encdec.lm_logits(params, cfg, h)
        return res

    checked = {}
    with launch_checks(torch, checked):
        kern = run()
    with plain_attention():
        plain = run()
    errs = {}
    for name, a in kern.items():
        if not bool(torch.isfinite(a).all()):
            fail(f"whisper-small: {name} logits not finite")
        errs[name] = (a - plain[name]).abs().max().item()
    if real and max(errs.values()) > LOGIT_TOL:
        fail(f"whisper-small: kernels vs plain attention: {errs} "
             f"(limit {LOGIT_TOL})")
    tokens = batch * (new_tokens + 1)
    emit("encdec", arch=cfg.name, full_size=real,
         encoder_layers=cfg.n_encoder_layers, decoder_layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, requests=batch,
         source_frames=S_src, prompt_tokens=prompt, max_len=max_len,
         tokens=tokens, init_seconds=init_s, prefill_seconds=prefill_s,
         seconds=seconds, tokens_per_s=tokens / seconds,
         decode_tokens_per_s=batch * new_tokens / (seconds - prefill_s),
         encodes=calls["encode"], decode_steps=calls["decode_step"],
         launches=launches,
         logit_err_vs_plain={**errs, "limit": LOGIT_TOL,
                             "target_tokens": target,
                             "logit_abs_max": plain["forward"].abs().max()
                             .item()},
         launches_vs_plain=checked, first_tokens=streams[:, :8].tolist(),
         peak_memory_bytes=serve_peak, init_peak_memory_bytes=init_peak)
    if with_profile and real:
        def prefill():
            serve_prefill(params, cfg, inputs, max_len=max_len)
            torch.cuda.synchronize()

        def decode():
            for pos in range(1, 9):
                serve_decode(params, cfg, tgt[:, pos], pos, caches)
            torch.cuda.synchronize()

        emit("profile", arch=cfg.name, window={
            "prefill": f"serve_prefill of {batch} requests of {S_src} frames",
            "decode": f"8 steps, {batch} requests"},
             **profile_windows(torch, {"prefill": prefill,
                                       "decode": decode}))
    del params, caches, kern, plain
    if real:
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the training path
# ---------------------------------------------------------------------------

def _rel_l2(torch, a, b) -> float:
    d = (a.float() - b.float()).norm().item()
    return d / max(b.float().norm().item(), 1e-30)


def _grad_readings(torch, params, got, want) -> dict:
    """Each leaf's relative L2 error against the plain pass, layer slice by
    layer slice for the stacked leaves (``blocks/...`` [G, ...])."""
    from repro_torch.models.common import tree_leaves, tree_paths
    out = {}
    for (path, _), a, b in zip(tree_paths(params), tree_leaves(got),
                               tree_leaves(want)):
        if path.startswith("blocks/"):
            out[path] = max(_rel_l2(torch, a[g], b[g])
                            for g in range(a.shape[0]))
        else:
            out[path] = _rel_l2(torch, a, b)
    return out


def train_vs_plain(torch, dev, real: bool) -> dict:
    """One gradient of the train step at full width and 2 layers, the same
    params and batch with the kernels and with plain attention (forward and
    backward): the loss and every layer slice of every gradient leaf within
    ``TRAIN_LOSS_TOL`` / ``TRAIN_GRAD_TOL``; two planted backward faults
    must read above that limit."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.train import to_device
    from repro_torch.models.registry import init_model
    from repro_torch.train.step import TrainConfig, loss_and_grads
    cfg = get_config("olmo-1b")
    cfg = dataclasses.replace(cfg if real else cfg.reduced(), n_layers=2)
    params = init_model(cfg, seed=1, device=dev)
    B, S = (2, 2048) if real else (2, 32)
    batch = to_device(next(SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
        seed=1)).batches()), dev)
    tc = TrainConfig()

    def run():
        loss, _, g = loss_and_grads(cfg, tc, params, batch)
        return loss.item(), g

    before = read_counts()
    loss_k, g_k = run()
    after = read_counts()
    if dev.type == "cuda" and (
            after["flash_attention_bwd"] - before["flash_attention_bwd"]
            != cfg.n_layers):
        fail(f"train_vs_plain: {after} - {before}: not one backward launch "
             f"a layer")
    with plain_attention():
        loss_p, g_p = run()
    sound = _grad_readings(torch, params, g_k, g_p)
    res = {"layers": cfg.n_layers, "batch": B, "seq": S,
           "loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_err": abs(loss_k - loss_p), "loss_limit": TRAIN_LOSS_TOL,
           "grad_rel_l2": sound, "grad_limit": TRAIN_GRAD_TOL,
           "planted_faults": {}}
    if dev.type == "cuda" and not (res["loss_err"] <= TRAIN_LOSS_TOL and
                                   max(sound.values()) <= TRAIN_GRAD_TOL):
        fail(f"train step, kernels vs plain attention: loss {loss_k} vs "
             f"{loss_p}, gradients {sound}")
    for kind in ("dk_tile", "no_delta"):
        with backward_fault(torch, kind) as hits:
            loss_f, g_f = run()
        reading = max(_grad_readings(torch, params, g_f, g_p).values())
        res["planted_faults"][kind] = reading
        if hits[0] != cfg.n_layers:
            fail(f"planted backward fault {kind} reached {hits[0]} launches")
        if dev.type == "cuda" and not reading > TRAIN_GRAD_TOL:
            fail(f"planted backward fault {kind} reads {reading}, not above "
                 f"the limit {TRAIN_GRAD_TOL}")
    del params, g_k, g_p, g_f
    return res


def train_phase(torch, dev, *, real: bool, with_profile: bool = False):
    """Full-size olmo-1b through ``repro_torch.launch.train.train``: 6 steps
    of batch 4 x 2048 tokens in 2 microbatches, remat none, f32 moments,
    random weights from a seed, counts set to 0 just before and read just
    after: the forward and backward kernels once per attention layer a
    microbatch.  Then ``train_vs_plain``.  ``with_profile`` adds a
    ``profile`` line of one train step.  Returns the launch counts and the
    run (its final state, config, ``TrainConfig``, batch and sequence) for
    ``checkpoint_phase``."""
    import statistics
    from repro_torch.configs.registry import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import transformer
    from repro_torch.models.common import count_params
    from repro_torch.train.step import TrainConfig
    cfg = get_config("olmo-1b")
    if not real:
        cfg = cfg.reduced()
    steps, batch, seq, n_micro = (6, 4, 2048, 2) if real else (3, 4, 32, 2)
    tc = TrainConfig(remat="none", n_micro=n_micro, moment_dtype="float32",
                     total_steps=steps, warmup_steps=1)
    step_s, last = [], [0.0]

    def on_step(step, metrics):
        if real:
            torch.cuda.synchronize()
        now = time.perf_counter()
        step_s.append(now - last[0])
        last[0] = now

    if real:
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    last[0] = t0 = time.perf_counter()
    state, losses = train(cfg, steps=steps, batch=batch, seq=seq, tc=tc,
                          seed=0, device=dev, verbose=False, on_step=on_step)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated() if real else None
    n_attn = transformer.attention_layers(cfg)
    per = steps * n_micro * n_attn
    want = {"flash_attention": per, "flash_attention_bwd": per,
            "attention_delta": per, "decode_attention": 0, "atom_matmul": 0}
    if real and launches != want:
        fail(f"train: launch counts {launches} but the path implies {want}")
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0] + 0.1):
        fail(f"train: losses {losses} not finite or rising")
    n_params = count_params(state.params)
    tokens = batch * seq
    attn_flops = (n_attn * batch * cfg.n_heads * 14 * cfg.head_dim
                  * causal_pairs(seq))
    step_flops = 6 * n_params * tokens + attn_flops
    med = statistics.median(step_s[1:]) if len(step_s) > 1 else step_s[0]
    compare = train_vs_plain(torch, dev, real)
    emit("train", arch=cfg.name, full_size=real, n_layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, params=n_params,
         steps=steps, batch=batch, seq=seq, n_micro=n_micro,
         remat=tc.remat, moment_dtype=tc.moment_dtype, losses=losses,
         seconds=seconds, step_ms=[x * 1e3 for x in step_s],
         median_step_ms=med * 1e3, tokens_per_step=tokens,
         tokens_per_s=tokens / med,
         step_bound_ms=step_flops / H100.peak_flops * 1e3,
         step_flops=step_flops, attention_flops=attn_flops,
         launches=launches, expected_launches=want,
         peak_memory_bytes=peak, kernels_vs_plain=compare)
    if with_profile and real:
        from repro_torch.data.pipeline import DataConfig, SyntheticLM
        from repro_torch.launch.train import to_device
        from repro_torch.train.step import make_train_step
        from repro_torch.models.common import tree_map
        from repro_torch.optim.optimizers import AdamWConfig, adamw_update
        _, step_fn = make_train_step(cfg, tc, device=dev)
        b = to_device(next(SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq,
            global_batch=batch)).batches()), dev)
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                               device=dev), state.params)

        def one_step():
            step_fn(state, b)
            torch.cuda.synchronize()

        def optimizer():        # the step's AdamW update alone
            adamw_update(state.params, grads, state.opt, AdamWConfig())
            torch.cuda.synchronize()

        out = profile_windows(torch, {"train_step": one_step,
                                      "optimizer": optimizer})
        emit("profile", arch=cfg.name, window={
            "train_step": f"one step: batch {batch} x {seq} in {n_micro} "
                          f"microbatches, AdamW f32 moments",
            "optimizer": "its AdamW update alone (f32 gradients)"}, **out)
        del grads
    if real:
        torch.cuda.empty_cache()
    return launches, dict(state=state, cfg=cfg, tc=tc, batch=batch, seq=seq)


# ---------------------------------------------------------------------------
# the checkpoint path
# ---------------------------------------------------------------------------

# free disk the checkpoint phase needs, in state sizes: one checkpoint and
# the entry point's next (keep-last-k holds both), with room to spare
CKPT_DISK_FACTOR = 2.2


def _states_equal(torch, a, b) -> bool:
    from repro_torch.checkpoint.sharded import _flatten
    fa, fb = _flatten(a), _flatten(b)
    return list(fa) == list(fb) and all(
        fa[k].dtype == fb[k].dtype and fa[k].device == fb[k].device
        and torch.equal(fa[k], fb[k]) for k in fa)


def checkpoint_phase(torch, dev, run: dict, *, real: bool):
    """The train phase's final olmo-1b state through the port's
    checkpointing, in a fresh temporary directory outside the repository
    (removed at the end, whatever happens): an async save through
    ``CheckpointManager`` (the stall until ``save`` returns: every leaf
    fetched to the host; the write until ``wait_all``), a restore onto the
    card from a template on the ``meta`` device (every leaf ``torch.equal``
    to the live state; the files' read alone timed apart), one ``train_step`` from the live and one from the
    restored state on batch 0 (losses and every new param bit-equal), then
    ``launch.train.train`` one step past the checkpoint, which restores it,
    trains on batch 0 again (the reference's data replay) and saves: its
    loss bit-equal to the resumed step's.  Counts set to 0 before the three
    steps and read after: K2, K2-bwd and delta once per attention layer a
    microbatch a step."""
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager, latest_step
    from repro_torch.checkpoint.sharded import _flatten
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.distributed import Coordinator, CoordinatorConfig
    from repro_torch.launch.train import state_template, to_device, train
    from repro_torch.models import transformer
    from repro_torch.train.step import make_train_step
    state, cfg, tc = run["state"], run["cfg"], run["tc"]
    batch, seq = run["batch"], run["seq"]
    leaves = _flatten(state)
    state_bytes = sum(t.numel() * t.element_size() for t in leaves.values())
    step = int(state.opt.step)

    def sync():
        if real:
            torch.cuda.synchronize()

    d = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(d).free
        need = int(CKPT_DISK_FACTOR * state_bytes)
        if free < need:
            fail(f"checkpoint: {free} bytes free under {d}, {need} needed "
                 f"({CKPT_DISK_FACTOR} x the state's {state_bytes})")
        mgr = CheckpointManager(d)
        sync()
        t0 = time.perf_counter()
        mgr.save(state, step)
        t1 = time.perf_counter()
        mgr.wait_all()
        t2 = time.perf_counter()
        stepdir = os.path.join(d, f"step_{step}")
        shard_bytes = {f: os.path.getsize(os.path.join(stepdir, f))
                       for f in sorted(os.listdir(stepdir))
                       if f.endswith(".npz")}
        manifest_bytes = os.path.getsize(os.path.join(stepdir,
                                                      "manifest.json"))

        template = state_template(cfg, tc)
        t3 = time.perf_counter()
        restored = mgr.restore(template, device=dev)
        sync()
        restore_s = time.perf_counter() - t3
        # the restore's read alone: every member of the same files again,
        # into host memory
        t5 = time.perf_counter()
        for f in shard_bytes:
            with np.load(os.path.join(stepdir, f)) as z:
                for k in z.files:
                    z[k]
        read_s = time.perf_counter() - t5
        restored_equal = _states_equal(torch, restored, state)
        if not restored_equal:
            fail("checkpoint: the restored state is not bit-equal to the "
                 "live state")

        _, step_fn = make_train_step(cfg, tc, device=dev)
        batch0 = to_device(next(SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch,
            seed=0)).batches()), dev)
        reset_counts()
        live, live_m = step_fn(state, batch0)
        live_params = live.params
        del live
        resumed, resumed_m = step_fn(restored, batch0)
        del restored
        step_equal = bool(torch.equal(live_m["loss"], resumed_m["loss"])) \
            and all(torch.equal(a, b) for a, b in zip(
                _flatten(live_params).values(),
                _flatten(resumed.params).values()))
        resumed_loss = resumed_m["loss"].item()
        del live_params, resumed
        if not step_equal:
            fail(f"checkpoint: the step from the restored state (loss "
                 f"{resumed_loss}) is not bit-equal to the step from the "
                 f"live state (loss {live_m['loss'].item()})")

        coord = Coordinator(1, CoordinatorConfig())
        t4 = time.perf_counter()
        last, losses = train(cfg, steps=step + 1, batch=batch, seq=seq,
                             tc=tc, seed=0, device=dev, ckpt_dir=d,
                             coordinator=coord, verbose=False)
        sync()
        entry_s = time.perf_counter() - t4
        launches = read_counts()
        entry_equal = losses == [resumed_loss]
        if not (entry_equal and int(last.opt.step) == step + 1
                and latest_step(d) == step + 1):
            fail(f"checkpoint: train(steps={step + 1}) from the step-{step} "
                 f"checkpoint gave losses {losses} (want [{resumed_loss}]), "
                 f"step {int(last.opt.step)}, latest {latest_step(d)}")
        del last
        per = 3 * tc.n_micro * transformer.attention_layers(cfg)
        want = {"flash_attention": per, "flash_attention_bwd": per,
                "attention_delta": per, "decode_attention": 0,
                "atom_matmul": 0}
        if real and launches != want:
            fail(f"checkpoint: launch counts {launches} but the path implies "
                 f"{want}")
        write_s = t2 - t1
        emit("checkpoint", arch=cfg.name, full_size=real, step=step,
             leaves=len(leaves), state_bytes=state_bytes,
             disk_free_bytes=free, shard_bytes=shard_bytes,
             manifest_bytes=manifest_bytes,
             save_stall_ms=(t1 - t0) * 1e3, write_s=write_s,
             write_GBps=state_bytes / write_s / 1e9, restore_s=restore_s,
             restore_GBps=state_bytes / restore_s / 1e9, read_s=read_s,
             read_GBps=state_bytes / read_s / 1e9,
             bit_equal={"restored_state": restored_equal,
                        "resumed_step": step_equal,
                        "entry_point_loss": entry_equal},
             resumed_loss=resumed_loss, entry_point_s=entry_s,
             coordinator_events=coord.events, launches=launches,
             expected_launches=want)
    finally:
        shutil.rmtree(d)
    if real:
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# the atomization path
# ---------------------------------------------------------------------------

def atoms_phase(torch, dev, real: bool):
    """The atom-count sweep through its entry point, counts set to 0
    first: every atomized result bit-equal to one atom."""
    from repro_torch.launch import atoms
    reset_counts()
    t0 = time.time()
    records = atoms.sweep(device=dev, quick=not real)
    if real:
        torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = read_counts()
    if real and (launches["atom_matmul"] == 0
                 or launches["flash_attention"] == 0):
        fail(f"atoms: launch counts {launches}: the sweep did not go through "
             f"the kernels")
    if any(r["max_abs_err"] != 0 for r in records):
        fail("atoms: an atomized result differs from one atom")
    if not all(r["plain_err"] <= r["plain_limit"] for r in records):
        fail("atoms: one atom differs from the plain version")
    emit("atoms", seconds=seconds, launches=launches, rows=atoms.rows(records),
         records=records)
    return launches, records


# ---------------------------------------------------------------------------
# the control plane's cost model against the card
# ---------------------------------------------------------------------------

# the prefill lengths at which flash attention is held against
# ``llm_costs.flash_attention_work`` (llama3-8b's heads, one sequence,
# non-causal): two of them not multiples of 512, where the Hopper kernel's
# 64-row tiles and the reference's 512-row blocks pad differently
LITHOS_PREFILL = ((512, 1000, 2048, 4096), (64, 100))
# power draw: ``nvidia-smi`` sampled every 100 ms for 1 s, after 2 s idle
# and over the last second of 3 s of back-to-back atom matmuls
POWER_PERIOD_S = 0.1
POWER_WINDOW_S = 1.0
POWER_IDLE_S = 2.0
POWER_LOAD_S = 3.0


def power_sampler(uuid: str):
    """Start one ``nvidia-smi`` sampling the card's power.draw every
    ``POWER_PERIOD_S``; the function returned stops it and returns the
    readings (W), failing the run if a line does not parse."""
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", uuid, "--query-gpu=power.draw",
         "--format=csv,noheader,nounits", "-lms",
         str(round(POWER_PERIOD_S * 1e3))],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def stop() -> list:
        proc.terminate()
        out = proc.communicate(timeout=30)[0]
        try:
            readings = [float(line) for line in out.split()]
        except ValueError:
            readings = []
        if not readings:
            fail(f"lithos_device: power.draw could not be read: {out!r}")
        return readings
    return stop


def _median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def whole_card_ms(flops, n_bytes) -> float:
    """The least time the whole card takes for this work (data sheet, bf16
    rate: a lower bound for any route)."""
    return max(flops / H100.peak_flops, n_bytes / H100.hbm_bw) * 1e3


def guard_roofline(what, ms, flops, n_bytes):
    """A measured time below the whole card's roofline means the work terms
    count bytes or flops the kernel does not do."""
    floor = whole_card_ms(flops, n_bytes)
    if math.isfinite(ms) and ms < floor:
        fail(f"{what}: measured {ms} ms is below the whole card's roofline "
             f"{floor} ms: the work terms count work the kernel does not do")
    return floor


def lithos_device(torch, dev, real: bool, smi: str, uuid, flush) -> dict:
    """The card's readings behind ``DeviceSpec.h100_like``'s measured
    constants, each beside the constant."""
    from repro_torch.core import types as T
    from repro_torch.core.llm_costs import H100_CLUSTER_FIT
    from repro_torch.kernels.atom_matmul import ops as m_ops
    from repro_torch.kernels.atoms import tile_count
    from repro_torch.kernels.decode_attention import ops as d_ops
    spec = T.DeviceSpec.h100_like()
    out = {"nvidia_smi": smi, "uuid": uuid}
    if real:
        props = torch.cuda.get_device_properties(dev)
        if props.multi_processor_count != T.H100_SMS:
            fail(f"lithos_device: {props.multi_processor_count} SMs, not "
                 f"{T.H100_SMS}: h100_like's 66 slices are not this card's")
        fit = d_ops.cluster_fit(dev, 128)
        if tuple(fit) != tuple(H100_CLUSTER_FIT):
            fail(f"lithos_device: cluster_fit(dev, 128) = {fit}, not "
                 f"llm_costs.H100_CLUSTER_FIT = {H100_CLUSTER_FIT}")
        sms = props.multi_processor_count
        out.update(sms=sms, tpcs=sms // 2, total_memory=props.total_memory,
                   total_memory_constant=T.H100_MEMORY,
                   cluster_fit=list(fit),
                   cluster_fit_constant=list(H100_CLUSTER_FIT),
                   decode_ctas_per_sm=fit[0] / sms,
                   decode_ctas_per_sm_constant=T.H100_DECODE_CTAS_PER_SM,
                   occupancy_constant=spec.occupancy)
    else:
        out["skipped"] = ("the SM count, total_memory, cluster_fit and the "
                          "power draw need the card; not read in a "
                          "rehearsal")
    # decode attention's fixed cost: its headline shape, every length 0
    B, Hq, Hk, D, S, _ = DECODE_SHAPES["serving"][not real]
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    q = _randn(torch, gen, (B, Hq, D), torch.bfloat16, dev)
    kc = _randn(torch, gen, (B, S, Hk, D), torch.bfloat16, dev)
    vc = _randn(torch, gen, (B, S, Hk, D), torch.bfloat16, dev)
    lens = torch.zeros(B, dtype=torch.int32, device=dev)
    o = torch.empty_like(q)
    k1 = lambda: d_ops.decode_attention_atom(q, kc, vc, lens, o, start=0,
                                             num_rows=B * Hk)
    k1()
    if o.abs().max().item() != 0.0:
        fail("lithos_device: decode attention at length 0 gave non-zeros")
    out.update(k1_zero_lens_ms=time_ms(torch, k1, iters=50 if real else 1,
                                       flush=flush),
               launch_overhead_ms_constant=spec.launch_overhead * 1e3,
               k1_shape={"B": B, "Hq": Hq, "Hk": Hk, "D": D, "S": S,
                         "lens": 0})
    del q, kc, vc
    if not real:
        return out
    # power: idle, then under back-to-back atom matmuls at llama3-8b's
    # widest prefill projection (the atoms phase's llama3-8b_wi_wg)
    M, K, N = 1000, 4096, 14336
    a = _randn(torch, gen, (M, K), torch.bfloat16, dev)
    b = _randn(torch, gen, (K, N), torch.bfloat16, dev)
    c = torch.empty((M, N), dtype=torch.bfloat16, device=dev)
    tiles = tile_count(M, N, 256, 256)
    torch.cuda.synchronize()
    time.sleep(POWER_IDLE_S)
    stop = power_sampler(uuid)
    time.sleep(POWER_WINDOW_S)
    idle = stop()
    t0 = time.time()
    stop, batches = None, []
    while time.time() - t0 < POWER_LOAD_S:
        # at most two batches of launches in flight: the card never idles
        # and the host clock stays within a batch of the device
        for _ in range(20):
            m_ops.matmul_atom(a, b, c, start=0, num_tiles=tiles)
        ev = torch.cuda.Event()
        ev.record()
        batches.append(ev)
        if len(batches) > 2:
            batches.pop(0).synchronize()
        if stop is None and time.time() - t0 >= POWER_LOAD_S - POWER_WINDOW_S:
            stop = power_sampler(uuid)
    loaded = stop()
    torch.cuda.synchronize()
    out.update(idle_w=_median(idle), idle_w_readings=idle,
               idle_w_constant=T.H100_IDLE_W,
               loaded_w=_median(loaded), loaded_w_readings=loaded,
               loaded_w_constant=T.H100_LOADED_W,
               load={"kernel": "atom_matmul", "M": M, "K": K, "N": N,
                     "dtype": "bfloat16", "seconds": POWER_LOAD_S})
    return out


def lithos_decode(torch, dev, real: bool, flush, spec):
    """Decode attention at every entry of llama3-8b's ``decode_cost_table``
    on ``h100_like``: measured against the cost model and the roofline.
    Returns the rows and the timed runs' launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.llm_costs import decode_cost_table
    from repro_torch.core.workloads import decode_attention_op
    from repro_torch.kernels.decode_attention import ops
    cfg = get_config("llama3-8b")
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cost = CostModel(spec)
    table = (decode_cost_table(cfg, spec) if real else
             decode_cost_table(cfg, spec, batches=(1, 2), kv_lens=(64, 130)))
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows, launches = [], 0
    for e in table:
        B, S = e.batch, e.kv_len
        err, plan = check_decode(torch, dev, gen, B=B, Hq=Hq, Hk=Hk, D=D,
                                 S=S, dtype="bfloat16", lens=[S] * B)
        if real and B * Hk * plan["nsplit"] != e.work.n_blocks:
            fail(f"lithos_decode B={B} S={S}: the kernel runs "
                 f"{B * Hk} x {plan['nsplit']} thread blocks, the cost model "
                 f"{e.work.n_blocks}")
        q = _randn(torch, gen, (B, Hq, D), torch.bfloat16, dev)
        kc = _randn(torch, gen, (B, S, Hk, D), torch.bfloat16, dev)
        vc = _randn(torch, gen, (B, S, Hk, D), torch.bfloat16, dev)
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        o = torch.empty_like(q)
        before = ops.launches
        ms = time_ms(torch, lambda: ops.decode_attention_atom(
            q, kc, vc, lens, o, start=0, num_rows=B * Hk),
            iters=30 if real else 1, flush=flush)
        launches += ops.launches - before
        floor = guard_roofline(f"lithos_decode B={B} S={S}", ms,
                               e.work.flops, e.work.bytes)
        model_ms = e.latency_s * 1e3
        # the op the simulator itself issues for this decode step
        op = decode_attention_op("attn", B, S, Hq, Hk, D)
        sim_op_ms = cost.latency(op.work(), spec.n_slices) * 1e3
        rows.append({"B": B, "S": S, "nsplit": plan["nsplit"],
                     "n_blocks": e.work.n_blocks, "ms": ms,
                     "model_ms": model_ms, "roofline_ms": e.roofline_s * 1e3,
                     "whole_card_ms": floor, "measured_over_model":
                     ms / model_ms, "sim_op_blocks": op.n_blocks,
                     "sim_op_ms": sim_op_ms,
                     "measured_over_sim_op": ms / sim_op_ms,
                     "max_abs_err": err})
        del q, kc, vc
    return rows, launches


def lithos_prefill(torch, dev, real: bool, spec):
    """Flash attention, non-causal bf16, at llama3-8b's heads against
    ``flash_attention_work`` on ``h100_like``.  Returns the rows and the
    timed runs' launches."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.llm_costs import (flash_attention_work,
                                            roofline_terms)
    from repro_torch.core.workloads import attention_op
    from repro_torch.kernels.flash_attention import ops
    cfg = get_config("llama3-8b")
    Hq, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cost = CostModel(spec)
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rows, launches = [], 0
    for S in LITHOS_PREFILL[not real]:
        chk = check_flash(torch, dev, gen, B=1, Sq=S, Sk=S, Hq=Hq, Hk=Hk,
                          D=D, dtype="bfloat16", causal=False)
        w = flash_attention_work(1, S, S, Hq, Hk, D)
        q = _randn(torch, gen, (1, S, Hq, D), torch.bfloat16, dev)
        k = _randn(torch, gen, (1, S, Hk, D), torch.bfloat16, dev)
        v = _randn(torch, gen, (1, S, Hk, D), torch.bfloat16, dev)
        tiles = ops.tile_space(q)
        if tiles != w.n_blocks:
            fail(f"lithos_prefill S={S}: {tiles} tiles, the cost model "
                 f"{w.n_blocks}")
        o = torch.empty_like(q)
        before = ops.launches
        ms = time_ms(torch, lambda: ops.flash_attention_atom(
            q, k, v, o, start=0, num_tiles=tiles, causal=False),
            iters=20 if real else 1)
        launches += ops.launches - before
        floor = guard_roofline(f"lithos_prefill S={S}", ms, w.flops, w.bytes)
        model_ms = cost.latency(w, spec.n_slices) * 1e3
        # the op the simulator itself issues for this prefill
        op = attention_op("attn", 1, S, S, Hq, Hk, D, causal=False)
        sim_op_ms = cost.latency(op.work(), spec.n_slices) * 1e3
        rows.append({"B": 1, "Sq": S, "Skv": S, "tiles": tiles, "ms": ms,
                     "model_ms": model_ms,
                     "roofline_ms": roofline_terms(w, spec).bound_time * 1e3,
                     "whole_card_ms": floor,
                     "measured_over_model": ms / model_ms,
                     "sim_op_blocks": op.n_blocks, "sim_op_ms": sim_op_ms,
                     "measured_over_sim_op": ms / sim_op_ms,
                     "row_err": chk["row_err"]})
    return rows, launches


def lithos_atoms(records, spec) -> list:
    """The atom sweep's matmul cases against the simulator: each atom count
    split by ``KernelAtomizer.split`` and each atom's ``CostModel`` latency
    on every slice summed (the sweep runs atoms back to back on one
    stream), for the kernel's own tiles (``model_ms``) and for the op the
    simulator issues, ``workloads.matmul_op`` (``sim_op_ms``)."""
    from repro_torch.core import types as T
    from repro_torch.core.atomizer import KernelAtomizer
    from repro_torch.core.costmodel import CostModel
    from repro_torch.core.workloads import matmul_op
    from repro_torch.kernels.atoms import tile_count
    cost = CostModel(spec)
    rows, base = [], {}
    for r in records:
        if r["kernel"] != "atom_matmul":
            continue
        s = r["shape"]
        M, N, K, bm = s["M"], s["N"], s["K"], s["block"]
        esz = 4 if r["dtype"] == "float32" else 2
        work = T.KernelWork(2.0 * M * N * K, float((M * K + K * N + M * N)
                                                   * esz),
                            tile_count(M, N, bm, bm))
        task = T.KernelTask(r["case"], work)
        atoms = KernelAtomizer().split(task, r["n_atoms"])
        if len(atoms) != r["atoms"]:
            fail(f"lithos_atoms {r['case']}: the atomizer splits "
                 f"{r['n_atoms']} into {len(atoms)} atoms, the sweep ran "
                 f"{r['atoms']}")
        model_ms = sum(cost.latency(a.work, spec.n_slices)
                       for a in atoms) * 1e3
        op = matmul_op(r["case"], M, N, K, dsize=esz)
        sim_atoms = KernelAtomizer().split(T.KernelTask(r["case"], op.work()),
                                           r["n_atoms"])
        sim_op_ms = sum(cost.latency(a.work, spec.n_slices)
                        for a in sim_atoms) * 1e3
        ms = r["device_ms"] if r["device_ms"] is not None else float("nan")
        guard_roofline(f"lithos_atoms {r['case']} n={r['n_atoms']}", ms,
                       work.flops, work.bytes)
        if r["n_atoms"] == 1:
            base[r["case"]] = (ms, model_ms)
        ms1, model1 = base[r["case"]]
        extra = max(1, len(atoms) - 1)
        rows.append({"case": r["case"], "dtype": r["dtype"],
                     "n_atoms": r["n_atoms"], "atoms": len(atoms), "ms": ms,
                     "model_ms": model_ms,
                     "measured_over_model": ms / model_ms,
                     "sim_op_blocks": op.n_blocks,
                     "sim_op_atoms": len(sim_atoms), "sim_op_ms": sim_op_ms,
                     "measured_over_sim_op": ms / sim_op_ms,
                     "extra_ms_per_atom": (ms - ms1) / extra
                     if len(atoms) > 1 else 0.0,
                     "model_extra_ms_per_atom": (model_ms - model1) / extra
                     if len(atoms) > 1 else 0.0})
    return rows


def _sim_mixes():
    """The two mixes of ``scripts/parity_check.py``: a high-priority
    olmo-1b ``fwd_infer`` (or continuous-batching) tenant with a best-effort
    llama3-8b trainer, full-size configs."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import workloads
    from repro_torch.core.types import Priority as P
    olmo, llama = get_config("olmo-1b"), get_config("llama3-8b")
    be = workloads.AppSpec("be", llama, "train", priority=P.BEST_EFFORT,
                           train_batch=2, train_seq=2048, fusion=8)
    hp = workloads.AppSpec("hp", olmo, "fwd_infer", priority=P.HIGH,
                           rps=20.0, prompt_mix=((128, 1.0),), batch=4,
                           fusion=8)
    cont = workloads.AppSpec("hp", olmo, "llm_continuous", priority=P.HIGH,
                             rps=40.0, max_batch=4, decode_tokens=8,
                             fusion=8, prompt_mix=((256, 0.7), (1024, 0.3)),
                             seed=5)
    return {"fwd_infer+train": [hp, be], "llm_continuous+train": [cont, be]}


def _sim_signature(res) -> tuple:
    """A simulation's records, energy and clients, compared with ``==``
    between the two engines."""
    return ([(r.task.kid, r.task.queue_id, r.task.ordinal, r.t_submit,
              r.t_start, r.t_end, r.slices, r.freq) for r in res.records],
            res.energy, [(c.cid, c.latencies, c.req_latencies,
                          c.slice_seconds) for c in res.clients])


def lithos_sim(real: bool, spec) -> list:
    """``evaluate`` on ``h100_like`` under both engines, records bit-equal."""
    from repro_torch.core import types as T
    from repro_torch.core.lithos import evaluate
    horizon = 2.0 if real else 0.2
    rows = []
    for mix, apps in _sim_mixes().items():
        for system in ("lithos", "mps"):
            runs, secs = [], []
            for engine in ("ref", "vec"):
                T.reset_kernel_ids()
                t0 = time.time()
                runs.append(evaluate(system, spec, apps, horizon=horizon,
                                     seed=0, engine=engine))
                secs.append(time.time() - t0)
            if _sim_signature(runs[0]) != _sim_signature(runs[1]):
                fail(f"lithos_sim {system} {mix}: the two engines differ")
            res = runs[0]
            hp, be = res.client("hp"), res.client("be")
            rows.append({"system": system, "mix": mix, "horizon": horizon,
                         "records": len(res.records), "hp_p50_ms":
                         hp.p(50) * 1e3, "hp_p99_ms": hp.p(99) * 1e3,
                         "hp_completed": hp.n_completed,
                         "be_completed": be.n_completed,
                         "energy_j": res.energy,
                         "engines_bit_equal": True,
                         "host_s": {"ref": secs[0], "vec": secs[1]}})
    return rows


def lithos_phase(torch, dev, real: bool, smi: str, uuid,
                 atom_records) -> None:
    """The simulator's cost model (``DeviceSpec.h100_like``) held against
    decode attention, flash attention and the atom matmul as measured on
    the card, and the card's readings behind the profile's measured
    constants.  Model against measured is a finding, not a gate; a time
    below the whole card's roofline fails.  Each shape is held against the
    plain version first; the launches printed are those of the timed runs."""
    from repro_torch.core.types import DeviceSpec
    spec = DeviceSpec.h100_like()
    flush = (torch.empty(256 << 20, dtype=torch.uint8, device=dev)
             if real else None)
    device = lithos_device(torch, dev, real, smi, uuid, flush)
    emit("lithos_device", **device)
    decode, k1 = lithos_decode(torch, dev, real, flush, spec)
    prefill, k2 = lithos_prefill(torch, dev, real, spec)
    del flush
    if real and (k1 == 0 or k2 == 0):
        fail(f"lithos: {k1} decode and {k2} flash attention launches: the "
             f"timed runs did not go through the kernels")
    emit("lithos_decode", nvidia_smi=smi, profile="h100_like",
         arch="llama3-8b", dtype="bfloat16", l2="cold (flushed before every "
         "launch)", launches=k1, rows=decode)
    emit("lithos_prefill", nvidia_smi=smi, profile="h100_like",
         arch="llama3-8b", dtype="bfloat16", causal=False, l2="warm",
         launches=k2, rows=prefill)
    emit("lithos_atoms", nvidia_smi=smi, profile="h100_like",
         rows=lithos_atoms(atom_records, spec))
    emit("lithos_sim", nvidia_smi=smi, profile="h100_like",
         rows=lithos_sim(real, spec))


def lithos_node(real: bool) -> list:
    """The node and cluster tiers on ``h100_like``: ``evaluate`` of the two
    mixes on a node of two devices under each router, migration on, and on
    a cluster of two such nodes (its own ``frag_aware`` router, migration on
    in both tiers); both engines, bit-equal, or the phase fails.  Host code
    only: no kernel runs."""
    from repro_torch.core import types as T
    from repro_torch.core.hierarchy import ROUTERS
    from repro_torch.core.lithos import evaluate
    spec = T.DeviceSpec.h100_like()
    node = T.NodeSpec.uniform(2, spec)
    migrate = T.NodeConfig(migration=True)
    runs = [("node", node, r, {"node_config": migrate}) for r in ROUTERS]
    runs.append(("cluster", T.ClusterSpec.uniform(2, node), "frag_aware",
                 {"cluster_config": T.ClusterConfig(migration=True,
                                                    node_config=migrate)}))
    horizon = 2.0 if real else 0.2
    rows = []
    for mix, apps in _sim_mixes().items():
        for tier, device, router, kw in runs:
            res, secs = [], {}
            for engine in ("ref", "vec"):
                T.reset_kernel_ids()
                t0 = time.time()
                res.append(evaluate("lithos", device, apps, horizon=horizon,
                                    seed=0, engine=engine, router=router,
                                    **kw))
                secs[engine] = time.time() - t0
            if (_sim_signature(res[0]) != _sim_signature(res[1])
                    or res[0].migrations != res[1].migrations):
                fail(f"lithos_node {tier} {router} {mix}: the two engines "
                     f"differ")
            r = res[0]
            hp, be = r.client("hp"), r.client("be")
            rows.append({"tier": tier, "router": router, "mix": mix,
                         "devices": device.n_devices, "horizon": horizon,
                         "placement": r.placement,
                         "records": len(r.records),
                         "hp_p50_ms": hp.p(50) * 1e3,
                         "hp_p99_ms": hp.p(99) * 1e3,
                         "hp_completed": hp.n_completed,
                         "be_completed": be.n_completed,
                         "energy_j": r.energy, "migrations": r.migrations,
                         "engines_bit_equal": True, "host_s": secs})
    return rows


# each wait of the ``ctl`` phase: the daemon's first admission, and its
# restart's run to idle (full-size llama3-8b and olmo-1b tenants take ~20 s
# of host time on one core)
CTL_WAIT_S = 180


def ctl_phase(real: bool) -> dict:
    """The online control plane through its entry points: the serve phase's
    full-size llama3-8b deployment (4 slots, 16 new tokens) submitted by
    ``launch.serve --ctl-state-dir`` as a high-priority tenant, a
    best-effort olmo-1b trainer beside it, ``python -m repro_torch.ctl
    daemon --device h100`` killed with SIGKILL while both run, and restarted
    until idle.  Fails if a job ends ``failed`` or is not terminal, if the
    restart recovers nothing, or if any wait runs out.  Host code only."""
    import io
    import shutil
    import tempfile
    from repro_torch.ctl import store
    from repro_torch.ctl.state import JobState
    from repro_torch.launch.serve import main as serve_main
    d = tempfile.mkdtemp(prefix="ctl-")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    daemon = [sys.executable, "-m", "repro_torch.ctl", "daemon",
              "--state-dir", d, "--device", "h100"]
    try:
        argv = ["--arch", "llama3-8b", "--max-slots", "4", "--max-new", "16",
                "--priority", "hp", "--ctl-state-dir", d]
        if not real:
            argv += ["--reduced", "--duration", "0.5"]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve_main(argv)
        serve_id = out.getvalue().strip()
        train_id = store.request_submit(d, {
            "kind": "train", "arch": "olmo-1b", "reduced": not real,
            "priority": "be", "duration": 5.0 if real else 0.4,
            "name": "olmo-1b-train"})
        ids = {serve_id: "llama3-8b-serve", train_id: "olmo-1b-train"}
        t0 = time.time()
        proc = subprocess.Popen(daemon, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.DEVNULL)
        try:
            while True:
                states = {j: s.state for j, s in store.replay(d).items()}
                if (set(states) == set(ids) and all(
                        s is JobState.RUNNING for s in states.values())):
                    break
                if time.time() - t0 > CTL_WAIT_S or proc.poll() is not None:
                    fail(f"ctl: the daemon did not run both jobs within "
                         f"{CTL_WAIT_S} s: {states}")
                time.sleep(0.1)
        finally:
            proc.kill()
            proc.wait(timeout=30)
        killed_after_s = time.time() - t0
        hb = store.read_heartbeat(d)
        if hb is None or hb["alive"]:
            fail(f"ctl: after SIGKILL the heartbeat reads {hb}")
        t1 = time.time()
        try:
            r = subprocess.run(daemon + ["--exit-when-idle", "--max-wall",
                                         str(CTL_WAIT_S)],
                               env=env, capture_output=True, text=True,
                               timeout=CTL_WAIT_S + 60)
        except subprocess.TimeoutExpired:
            fail(f"ctl: the restarted daemon ran past {CTL_WAIT_S + 60} s")
        if r.returncode != 0:
            fail(f"ctl: the restarted daemon exited {r.returncode}: "
                 f"{r.stderr[-2000:]}")
        restart_s = time.time() - t1
        jobs = store.replay(d)
        rows = {}
        for jid, name in ids.items():
            j = jobs.get(jid)
            if j is None or not j.terminal:
                fail(f"ctl: {name} is not terminal after the restart "
                     f"(the wait ran out): {j and j.state}")
            if j.state is JobState.FAILED:
                fail(f"ctl: {name} failed: {j.error}")
            if j.recoveries < 1:
                fail(f"ctl: {name} was running at the SIGKILL but was not "
                     f"recovered")
            res = j.result
            rows[name] = {"job_id": jid, "state": j.state.value,
                          "recoveries": j.recoveries,
                          "device": j.device, "granted": j.granted_slices,
                          "n_completed": res.get("n_completed"),
                          "p50_ms": res.get("p50_ms"),
                          "p95_ms": res.get("p95_ms"),
                          "slice_seconds": res.get("slice_seconds"),
                          "sim_seconds": res.get("sim_seconds")}
        n_records = len(store._read_records(os.path.join(d, store.JOURNAL)))
        return {"jobs": rows, "journal_records": n_records,
                "killed_after_s": killed_after_s, "restart_s": restart_s,
                "restart_stdout": r.stdout.strip()}
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------

def main(argv) -> int:
    rehearse = "--rehearse" in argv
    import torch
    if not rehearse and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script needs one GPU",
              file=sys.stderr)
        return 1
    real = not rehearse
    dev = torch.device("cuda" if real else "cpu")
    # f32 comparisons are made in full f32 on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.kernels import build

    uuid = card_uuid(torch, dev) if real else None
    smi = nvidia_smi_line(uuid) if real else "rehearsal on the CPU"
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.time()
    if real:
        paths = build.build_all()
        for name in build.KERNELS:
            build.load(name)
        emit("build", seconds=time.time() - t0,
             libraries={n: os.path.relpath(p, ROOT) for n, p in paths.items()},
             flags=" ".join(build.NVCC_FLAGS),
             ptxas={n: build.ptxas_report(n) for n in build.KERNELS})

    k1, k2, k3, kb = kernels_phase(torch, dev, real)

    sizes = (dict(n_requests=8, max_slots=4, max_len=2048, max_new=16) if real
             else dict(n_requests=3, max_slots=2, max_len=32, max_new=4))
    prof = "--profile" in argv
    runs = [serve_phase(torch, dev, "llama3-8b", real=real,
                        with_profile=prof, **sizes)]
    sizes = (dict(n_requests=4, max_slots=2, max_len=512, max_new=8) if real
             else dict(n_requests=2, max_slots=1, max_len=32, max_new=3))
    runs.append(serve_phase(torch, dev, "olmo-1b", real=real, **sizes))
    # the MoE, hybrid and recurrent decoders: 2 slots, 8 new tokens;
    # recurrentgemma's prompts run past its window of 2048, so the windowed
    # flash kernel and the ring buffer's wrap run, and its kernel-vs-plain
    # check uses such a prompt too
    sizes = (dict(n_requests=4, max_slots=2, max_len=512, max_new=8) if real
             else dict(n_requests=3, max_slots=2, max_len=32, max_new=3))
    runs.append(serve_phase(torch, dev, "qwen2-moe-a2.7b", real=real,
                            with_profile=prof, **sizes))
    sizes = (dict(n_requests=3, max_slots=2, max_len=4608, max_new=8,
                  min_prompt=2100, check_len=2100) if real
             else dict(n_requests=3, max_slots=2, max_len=80, max_new=3,
                       min_prompt=34, check_len=36))
    runs.append(serve_phase(torch, dev, "recurrentgemma-9b", real=real,
                            with_profile=prof, **sizes))
    sizes = (dict(n_requests=3, max_slots=2, max_len=512, max_new=8) if real
             else dict(n_requests=3, max_slots=2, max_len=32, max_new=3))
    runs.append(serve_phase(torch, dev, "xlstm-1.3b", real=real,
                            with_profile=prof, **sizes))
    # the encoder-decoder (whisper-small: 4 requests of 1500 frames, 32 new
    # tokens) and the VLM backbone (llava-next-34b, 34.4 B params: 2 slots,
    # 8 new tokens, and the input_embeds path at a 200-row prompt)
    sizes = (dict(batch=4, new_tokens=32, max_len=448) if real
             else dict(batch=2, new_tokens=3, max_len=16, target=8))
    runs.append(encdec_phase(torch, dev, real=real, with_profile=prof,
                             **sizes))
    sizes = (dict(n_requests=4, max_slots=2, max_len=2048, max_new=8) if real
             else dict(n_requests=3, max_slots=2, max_len=32, max_new=3))
    runs.append(serve_phase(torch, dev, "llava-next-34b", real=real,
                            with_profile=prof, **sizes))
    # the training path: full-size olmo-1b, 6 steps
    counts, train_run = train_phase(torch, dev, real=real, with_profile=prof)
    runs.append(counts)
    # its final state checkpointed, restored and resumed
    runs.append(checkpoint_phase(torch, dev, train_run, real=real))
    del train_run
    launches = {k: sum(r[k] for r in runs) for k in runs[0]}
    atom_launches, atom_records = atoms_phase(torch, dev, real)
    launches["atom_matmul"] = atom_launches["atom_matmul"]
    # the control plane's cost model against the kernels' times on the card
    lithos_phase(torch, dev, real, smi, uuid, atom_records)
    # the node, cluster and online tiers: host code that schedules
    # descriptions of kernels, so they launch none
    reset_counts()
    emit("lithos_node", nvidia_smi=smi, profile="h100_like",
         rows=lithos_node(real))
    emit("ctl", nvidia_smi=smi, profile="h100", **ctl_phase(real))
    if any(read_counts().values()):
        fail(f"lithos_node / ctl launched kernels: {read_counts()}")

    if rehearse:
        print("chip_smoke: rehearsal finished; nothing was measured",
              file=sys.stderr)
        return 2

    def entry(name, replaces, k):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                "bound_by": k["bound_by"], "library_ms": k["library_ms"]}

    print(json.dumps({"kernels": [
        entry("decode_attention",
              "src/repro/kernels/decode_attention/kernel.py:75", k1),
        entry("flash_attention",
              "src/repro/kernels/flash_attention/kernel.py:84", k2),
        entry("atom_matmul",
              "src/repro/kernels/atom_matmul/kernel.py:57", k3),
        entry("flash_attention_bwd",
              "jax.grad of src/repro/models/attention.py:141 "
              "blocked_attention (XLA autodiff, no Pallas kernel)", kb)]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
