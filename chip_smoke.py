#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``src/repro_torch/kernels/csrc``, holds each
against its plain PyTorch version on the card (values, atom order-freedom,
rows / tiles outside an atom untouched), times them beside their bound, then
drives two paths, each with the kernels' launch counts set to 0 just before
and read just after: it serves full-size ``llama3-8b`` and ``olmo-1b``
(random weights from a seed) through ``repro_torch.launch.serve.serve``
(decode and flash attention), and runs the atom-count sweep
``repro_torch.launch.atoms.sweep`` (the atomized matmul at the full-width
``llama3-8b`` projections, and flash attention).  Every phase prints one JSON
line; any failure ends the run with a non-zero exit code.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

``--profile`` adds a ``profile`` line: device time by kernel over a prefill
and a few decode steps of ``llama3-8b``.

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

# kernel against its plain version on the same inputs, max abs error.
# float32: both sides do f32 math and differ only in summation order and in
# the last bits of exp.  bfloat16: both sides round an f32 result to bf16
# once, and the flash kernel also rounds P to bf16 for the tensor-core
# product, so results differ by one bf16 step (2^-8 relative: 0.0156 for an
# output between 2 and 4, which short rows reach).
TOL = {("decode", "float32"): 2e-5, ("decode", "bfloat16"): 3e-2,
       ("flash", "float32"): 2e-3, ("flash", "bfloat16"): 3e-2}
# full-depth bf16 model, kernels against plain attention: the attention
# outputs differ by single bf16 roundings, which the layers above carry on;
# logits are O(1), and the limit is a tenth of that.
LOGIT_TOL = 0.1


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
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


def check_decode(torch, dev, gen, *, B, Hq, Hk, D, S, dtype, lens, strided=False):
    """One decode-attention case: values, atoms in permuted order bit-equal,
    rows outside an atom untouched.  Returns the max abs error."""
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
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = ref.decode_attention_ref(q, kc, vc, lens_t)
    got = ops.decode_attention(q, kc, vc, lens_t)
    err = (got.float() - want.float()).abs().max().item()
    if not math.isfinite(err) or err > TOL[("decode", dtype)]:
        fail(f"decode_attention {dtype} B={B} Hq={Hq} Hk={Hk} D={D} S={S}: "
             f"max abs err {err} > {TOL[('decode', dtype)]}")
    for b, n in enumerate(lens):
        if n == 0 and got[b].abs().max().item() != 0.0:
            fail("decode_attention: a row of length 0 must give zeros")
    a3 = ops.decode_attention(q, kc, vc, lens_t, n_atoms=3)
    p3 = ops.decode_attention(q, kc, vc, lens_t, n_atoms=3, order=(2, 0, 1))
    if not (torch.equal(a3, p3) and _same(torch, a3, got)):
        fail("decode_attention: atoms do not compose bit for bit")
    R = B * Hk
    start, num = R // 3, max(1, R // 3)
    o = torch.full_like(q, 7.0)
    ops.decode_attention_atom(q, kc, vc, lens_t, o, start=start, num_rows=num)
    og, gg = o.view(R, Hq // Hk, D), got.view(R, Hq // Hk, D)
    inside = torch.zeros(R, dtype=torch.bool, device=dev)
    inside[start:start + num] = True
    if not (torch.equal(og[inside], gg[inside])
            and bool((og[~inside] == 7.0).all())):
        fail("decode_attention_atom wrote outside its rows")
    return err


def check_flash(torch, dev, gen, *, B, Sq, Sk, Hq, Hk, D, dtype, causal=True):
    from repro_torch.kernels.flash_attention import ops, ref
    dt = getattr(torch, dtype)
    q = _randn(torch, gen, (B, Sq, Hq, D), dt, dev)
    k = _randn(torch, gen, (B, Sk, Hk, D), dt, dev)
    v = _randn(torch, gen, (B, Sk, Hk, D), dt, dev)
    want = ref.attention_ref(q, k, v, causal=causal)
    got = ops.flash_attention(q, k, v, causal=causal)
    err = (got.float() - want.float()).abs().max().item()
    if not math.isfinite(err) or err > TOL[("flash", dtype)]:
        fail(f"flash_attention {dtype} B={B} Sq={Sq} Sk={Sk} Hq={Hq} Hk={Hk} "
             f"D={D} causal={causal}: max abs err {err} > "
             f"{TOL[('flash', dtype)]}")
    a3 = ops.flash_attention(q, k, v, causal=causal, n_atoms=3)
    p3 = ops.flash_attention(q, k, v, causal=causal, n_atoms=3,
                             order=(1, 2, 0))
    if not (torch.equal(a3, p3) and _same(torch, a3, got)):
        fail("flash_attention: atoms do not compose bit for bit")
    bq = ops.BLOCK_Q
    nqb = -(-Sq // bq)
    total = B * Hq * nqb
    start, num = total // 3, max(1, total // 3)
    o = torch.full_like(q, 7.0)
    ops.flash_attention_atom(q, k, v, o, start=start, num_tiles=num,
                             causal=causal)
    # tile t covers rows [qi*bq, (qi+1)*bq) of head bh = t // nqb
    tile_of = (torch.arange(B * Hq, device=dev)[:, None] * nqb
               + torch.arange(Sq, device=dev)[None, :] // bq)    # [B*Hq, Sq]
    inside = ((tile_of >= start) & (tile_of < start + num))
    inside = inside.view(B, Hq, Sq).permute(0, 2, 1)              # [B,Sq,Hq]
    if not (torch.equal(o[inside], got[inside])
            and bool((o[~inside] == 7.0).all())):
        fail("flash_attention_atom wrote outside its tiles")
    return err


def _mm_err(torch, got, want, dtype):
    """(max abs error, its limit) of a matmul result against the plain one."""
    err = (got.float() - want.float()).abs().max().item()
    return err, MM_TOL[dtype] * want.float().abs().max().item()


def check_matmul(torch, dev, gen, *, M, N, K, dtype, bm=128, bn=None,
                 strided=False):
    """One atom-matmul case: values, atoms in permuted order bit-equal to
    n=1, tiles outside an atom untouched and those inside equal to the plain
    atom's.  Returns the max abs error."""
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
    return err


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


def decode_headline(torch, dev, gen, flush, iters):
    """Decode attention at the serving path's shape: 4 slots of llama3-8b,
    a 2048-token stripe each, ragged lengths."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import ops, ref
    B, Hq, Hk, D, S = (4, 32, 8, 128, 2048) if flush is not None else (2, 4, 2, 16, 64)
    lens = [300, 700, 1000, 1040][:B] if flush is not None else [5, 64]
    dt = torch.bfloat16
    q = _randn(torch, gen, (B, Hq, D), dt, dev)
    kc = _randn(torch, gen, (B, S, Hk, D), dt, dev)
    vc = _randn(torch, gen, (B, S, Hk, D), dt, dev)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    want = ref.decode_attention_ref(q, kc, vc, lens_t)
    got = ops.decode_attention(q, kc, vc, lens_t)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= TOL[("decode", "bfloat16")]:
        fail(f"decode_attention at the serving shape: err {err}")
    ms = time_ms(torch, lambda: ops.decode_attention(q, kc, vc, lens_t),
                 iters=iters, flush=flush)
    host_ms = enqueue_ms(torch, lambda: ops.decode_attention(q, kc, vc, lens_t))
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
            "dtype": "bfloat16", "max_abs_err": err,
            "err_limit": TOL[("decode", "bfloat16")], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "enqueue_ms": host_ms,
            "bytes": n_bytes, "flops": flops,
            "l2": "cold (flushed before every launch)"}


def flash_headline(torch, dev, gen, iters, real, dtype="bfloat16"):
    """Flash attention at the serving path's shape: one llama3-8b prompt of
    1000 tokens, causal."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops, ref
    B, S, Hq, Hk, D = (1, 1000, 32, 8, 128) if real else (1, 40, 4, 2, 16)
    dt = getattr(torch, dtype)
    q = _randn(torch, gen, (B, S, Hq, D), dt, dev)
    k = _randn(torch, gen, (B, S, Hk, D), dt, dev)
    v = _randn(torch, gen, (B, S, Hk, D), dt, dev)
    want = ref.attention_ref(q, k, v, causal=True)
    got = ops.flash_attention(q, k, v, causal=True)
    err = (got.float() - want.float()).abs().max().item()
    if not err <= TOL[("flash", dtype)]:
        fail(f"flash_attention {dtype} at the serving shape: err {err}")
    ms = time_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True),
                 iters=iters)
    host_ms = enqueue_ms(torch, lambda: ops.flash_attention(q, k, v, causal=True))
    plain_ms = time_ms(torch, lambda: ref.attention_ref(q, k, v, causal=True),
                       iters=iters)
    q4, k4, v4 = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                 enable_gqa=True)
    lib_err = (lib().transpose(1, 2).float() - want.float()).abs().max().item()
    if not lib_err <= 3e-2:
        fail(f"library yardstick disagrees with the plain version: {lib_err}")
    library_ms = time_ms(torch, lib, iters=iters)
    esz = q.element_size()
    pairs = S * (S + 1) // 2                       # unmasked (query, key) pairs
    flops = 4 * B * Hq * D * pairs
    n_bytes = (2 * B * S * Hq * D + 2 * B * S * Hk * D) * esz
    t_bytes = n_bytes / H100.hbm_bw * 1e3
    t_ops = flops / (H100.peak_flops if dtype == "bfloat16"
                     else H100.peak_flops_f32) * 1e3
    return {"shape": {"B": B, "Sq": S, "Sk": S, "Hq": Hq, "Hk": Hk, "D": D,
                      "causal": True},
            "dtype": dtype, "max_abs_err": err,
            "err_limit": TOL[("flash", dtype)], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms, "enqueue_ms": host_ms,
            "bytes": n_bytes, "flops": flops,
            "l2": "warm (the projections have just written q, k, v)"}


def kernels_phase(torch, dev, real: bool):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cases = []
    if real:
        dec = [dict(B=4, Hq=32, Hk=8, D=128, S=2048, dtype="bfloat16", lens=[1, 37, 1000, 2048]),
               dict(B=4, Hq=32, Hk=8, D=128, S=2048, dtype="float32", lens=[2048, 513, 0, 64]),
               dict(B=8, Hq=32, Hk=8, D=128, S=2048, dtype="bfloat16",
                    lens=[5, 2048, 31, 32, 33, 999, 1500, 257], strided=True),
               dict(B=4, Hq=16, Hk=16, D=128, S=2048, dtype="bfloat16", lens=[100, 2000, 3, 640]),
               dict(B=2, Hq=8, Hk=2, D=64, S=300, dtype="float32", lens=[300, 17]),
               dict(B=2, Hq=24, Hk=2, D=64, S=130, dtype="bfloat16", lens=[130, 64]),
               dict(B=3, Hq=6, Hk=2, D=128, S=96, dtype="float32", lens=[96, 1, 50])]
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
    else:
        dec = [dict(B=3, Hq=4, Hk=2, D=16, S=40, dtype="float32", lens=[40, 0, 7]),
               dict(B=2, Hq=4, Hk=4, D=16, S=33, dtype="bfloat16", lens=[1, 33], strided=True)]
        fl = [dict(B=2, Sq=70, Sk=70, Hq=4, Hk=2, D=16, dtype="float32"),
              dict(B=1, Sq=20, Sk=90, Hq=4, Hk=1, D=16, dtype="bfloat16"),
              dict(B=1, Sq=90, Sk=50, Hq=2, Hk=2, D=16, dtype="float32")]
        mm = [dict(M=257, N=129, K=65, dtype="float32"),
              dict(M=40, N=300, K=64, dtype="bfloat16", bm=256),
              dict(M=70, N=300, K=24, dtype="bfloat16", bm=128, bn=256,
                   strided=True)]
    for c in dec:
        err = check_decode(torch, dev, gen, **c)
        cases.append({"kernel": "decode_attention", **c, "max_abs_err": err,
                      "err_limit": TOL[("decode", c["dtype"])]})
    for c in fl:
        err = check_flash(torch, dev, gen, **c)
        cases.append({"kernel": "flash_attention", **c, "max_abs_err": err,
                      "err_limit": TOL[("flash", c["dtype"])]})
    for c in mm:
        err = check_matmul(torch, dev, gen, **c)
        cases.append({"kernel": "atom_matmul", **c, "max_abs_err": err,
                      "err_limit": f"{MM_TOL[c['dtype']]} x max|output|"})
    flush = (torch.empty(256 << 20, dtype=torch.uint8, device=dev)
             if real else None)
    k1 = decode_headline(torch, dev, gen, flush, iters=30 if real else 1)
    k2 = flash_headline(torch, dev, gen, iters=20 if real else 1, real=real)
    k2_f32 = flash_headline(torch, dev, gen, iters=10 if real else 1,
                            real=real, dtype="float32")
    k3 = matmul_headline(torch, dev, gen, flush, iters=20 if real else 1,
                         real=real)
    del flush
    if real:
        torch.cuda.synchronize()
    emit("kernels", cases=cases, decode_attention=k1, flash_attention=k2,
         flash_attention_float32=k2_f32, atom_matmul=k3,
         checked=["values", "atoms (n=3) in permuted order bit-equal to n=1",
                  "rows / tiles outside an atom untouched"])
    return k1, k2, k3


# ---------------------------------------------------------------------------
# the serving path
# ---------------------------------------------------------------------------

def _wrappers():
    from repro_torch.kernels.atom_matmul import ops as m_ops
    from repro_torch.kernels.decode_attention import ops as d_ops
    from repro_torch.kernels.flash_attention import ops as f_ops
    return {"decode_attention": d_ops, "flash_attention": f_ops,
            "atom_matmul": m_ops}


def reset_counts():
    for ops in _wrappers().values():
        ops.launches = 0


def read_counts():
    return {name: ops.launches for name, ops in _wrappers().items()}


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
    """Harness-only: route both wrappers' atoms to their plain versions, for
    holding the model path with kernels against the same path without."""
    from repro_torch.kernels.decode_attention import ops as d_ops, ref as d_ref
    from repro_torch.kernels.flash_attention import ops as f_ops, ref as f_ref
    saved = d_ops.decode_attention_atom, f_ops.flash_attention_atom
    d_ops.decode_attention_atom = d_ref.decode_attention_atom_ref
    f_ops.flash_attention_atom = f_ref.flash_attention_atom_ref
    try:
        yield
    finally:
        d_ops.decode_attention_atom, f_ops.flash_attention_atom = saved


def profile_phase(torch, dev, cfg, params, arch: str) -> None:
    """``--profile``: device time by kernel over one 1000-token prefill and
    eight decode steps of 4 slots, from ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import transformer
    B, L, plen = 4, 2048, 1000
    caches = transformer.init_caches(cfg, B, L, device=dev)
    toks = torch.randint(2, cfg.vocab_size, (1, plen), device=dev)
    last = torch.randint(2, cfg.vocab_size, (B,), device=dev)
    pos = torch.tensor([300, 700, 1000, 1040], device=dev)

    def window(kind):
        if kind == "prefill":
            transformer.prefill(params, cfg, toks, caches=caches, slot=2)
        else:
            for i in range(8):
                transformer.decode_step(params, cfg, last, pos + i, caches)
        torch.cuda.synchronize()

    out = {}
    for kind in ("prefill", "decode"):
        window(kind)                                  # warm up
        t0 = time.perf_counter()
        window(kind)
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            window(kind)
        # device-side rows only: an operator's row repeats its kernels' time
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        out[kind] = {"wall_ms_unprofiled": wall_ms, "device_busy_ms": busy,
                     "device_idle_share": max(0.0, 1 - busy / wall_ms),
                     "top": [{"kernel": k[:60], "ms": ms, "calls": n}
                             for k, ms, n in rows[:10]]}
    emit("profile", arch=arch, window={"prefill": "1 prompt of 1000 tokens",
                                       "decode": "8 steps, 4 slots"}, **out)


def serve_phase(torch, dev, arch: str, *, real: bool, n_requests, max_slots,
                max_len, max_new, with_profile: bool = False):
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

    # the main path, through the launcher's entry point, counts set to 0 first
    reset_counts()
    with count_calls(transformer, ("prefill", "decode_step")) as calls:
        t0 = time.time()
        done, lats = serve(cfg, n_requests=n_requests, max_slots=max_slots,
                           max_len=max_len, max_new=max_new, seed=0,
                           verbose=False, device=dev, params=params)
        if real:
            torch.cuda.synchronize()
        serve_s = time.time() - t0
    launches = read_counts()

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
    want = {"flash_attention": calls["prefill"] * cfg.n_layers,
            "decode_attention": calls["decode_step"] * cfg.n_layers,
            "atom_matmul": 0}           # not on the serving path
    if real and (launches != want or launches["flash_attention"] == 0
                 or launches["decode_attention"] == 0):
        fail(f"{arch}: launch counts {launches} but the path implies {want}")
    if calls["prefill"] != n_requests or calls["decode_step"] == 0:
        fail(f"{arch}: {calls} engine calls for {n_requests} requests")

    # the path against itself: kernels vs plain attention, same params/prompt
    rng = np.random.default_rng(1)
    plen = min(200, max_len // 2)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, (2, plen)),
                           device=dev)
    nxt = torch.as_tensor(rng.integers(2, cfg.vocab_size, (2,)), device=dev)
    pos = torch.tensor([plen, plen], device=dev)

    def run():
        lp, caches = transformer.prefill(params, cfg, toks, max_len=plen + 8)
        ld, _ = transformer.decode_step(params, cfg, nxt, pos, caches)
        return lp.float(), ld.float()

    lp_k, ld_k = run()
    with plain_attention():
        lp_p, ld_p = run()
    for name, a, b in (("prefill", lp_k, lp_p), ("decode", ld_k, ld_p)):
        if a.shape != (2, cfg.vocab_size) or not bool(torch.isfinite(a).all()):
            fail(f"{arch}: {name} logits not finite or of shape {tuple(a.shape)}")
    err_p = (lp_k - lp_p).abs().max().item()
    err_d = (ld_k - ld_p).abs().max().item()
    if real and max(err_p, err_d) > LOGIT_TOL:
        fail(f"{arch}: kernels vs plain attention: prefill logits differ by "
             f"{err_p}, decode logits by {err_d} (limit {LOGIT_TOL})")

    tokens = sum(len(r.output) for r in done)
    emit("serve", arch=arch, full_size=real, n_layers=cfg.n_layers,
         d_model=cfg.d_model, dtype=cfg.dtype, requests=len(done),
         max_slots=max_slots, max_len=max_len, tokens=tokens,
         prompt_tokens=int(sum(len(r.tokens) for r in done)),
         init_seconds=init_s, seconds=serve_s, tokens_per_s=tokens / serve_s,
         p50_latency_s=float(np.percentile(lats, 50)),
         prefills=calls["prefill"], decode_steps=calls["decode_step"],
         launches=launches,
         logit_err_vs_plain={"prefill": err_p, "decode": err_d,
                             "limit": LOGIT_TOL,
                             "logit_abs_max": lp_p.abs().max().item()},
         peak_memory_bytes=(torch.cuda.max_memory_allocated() if real else None))
    if with_profile and real:
        profile_phase(torch, dev, cfg, params, arch)
    del params
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
    return launches


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

    smi = nvidia_smi_line() if real else "rehearsal on the CPU"
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.time()
    if real:
        paths = build.build_all()
        for name in build.KERNELS:
            build.load(name)
        emit("build", seconds=time.time() - t0,
             libraries={n: os.path.relpath(p, ROOT) for n, p in paths.items()},
             flags=" ".join(build.NVCC_FLAGS))

    k1, k2, k3 = kernels_phase(torch, dev, real)

    sizes = (dict(n_requests=8, max_slots=4, max_len=2048, max_new=16) if real
             else dict(n_requests=3, max_slots=2, max_len=32, max_new=4))
    launches = serve_phase(torch, dev, "llama3-8b", real=real,
                           with_profile="--profile" in argv, **sizes)
    sizes = (dict(n_requests=4, max_slots=2, max_len=512, max_new=8) if real
             else dict(n_requests=2, max_slots=1, max_len=32, max_new=3))
    serve_phase(torch, dev, "olmo-1b", real=real, **sizes)
    launches["atom_matmul"] = atoms_phase(torch, dev, real)["atom_matmul"]

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
              "src/repro/kernels/atom_matmul/kernel.py:57", k3)]}),
        flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
