"""Atom-count sweep: what splitting a kernel into atoms costs on the GPU.

The LithOS atomizer (paper section 4.4, ``core/atomizer.py`` in the
reference) cuts a kernel's grid into contiguous ranges of tiles, one launch
each.  This sweep runs the port's real kernels as n = 1, 2, 4, 8, 16, 32
atoms (the reference bench's counts, plus ``AtomizerConfig.max_atoms``),
every atom in order on one stream, and reports for each count:

- the device time, from CUDA events, with the stream kept busy beforehand for
  1.5x the host's enqueue time, so no host gap is inside it; the atoms write
  into an output allocated once, so no memset is inside it either;
- the overhead against n = 1;
- the max error against n = 1, which must be 0: a tile's arithmetic does not
  depend on the atom that runs it;
- the host time to enqueue one atom;
- the CTA waves that the atoms' CTA tiles imply at the kernel's occupancy
  (the matmul's from ``ops.cta_tiles``, the mirror of its schedule; for its
  persistent bf16 kernel a wave is one round of the grid): atoms on one
  stream do not overlap, so each atom ends in a partial wave.

Each case's one-atom result, through the public entry point, is first held
against the plain PyTorch version on the same inputs (``plain_err``).

Cases: the reference bench's own (M = N = K = 1024, float32, 256 x 256
tiles); the matmul at the full-width ``llama3-8b`` prefill projections
(1000 tokens, bfloat16); flash attention at the same 1000-token prefill.
Decode is left out: the atomizer never splits it.

The port's counterpart of ``benchmarks/bench_pallas_atoms.py``, which times a
jnp re-expression of the schedule rather than the kernels.  Rows use that
bench's CSV layout (bench, case, value, unit).

Usage:
    PYTHONPATH=src python -m repro_torch.launch.atoms           # on the GPU
    PYTHONPATH=src python -m repro_torch.launch.atoms --device cpu --quick

``--device cpu`` runs the plain versions at the ``--quick`` sizes: it checks
the schedule and measures nothing.  Without ``--device`` the sweep needs a
GPU and raises without one.
"""
from __future__ import annotations

import argparse
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.registry import get_config
from repro_torch.kernels.atom_matmul import ops as mm_ops
from repro_torch.kernels.atom_matmul.ref import matmul_ref
from repro_torch.kernels.atoms import schedule, tile_count
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.common import make_generator, resolve_device

N_ATOMS = (1, 2, 4, 8, 16, 32)
QUICK_N_ATOMS = (1, 4, 32)
PREFILL_TOKENS = 1000
ITERS = 10                        # timed calls of each schedule (median)
# one atom against the plain version on the same inputs.  Matmul: max abs error
# over the largest |output|.  float32: the kernel takes each product in split
# TF32 (hi = tf32(x), lo = x - hi truncated to TF32; lo_a hi_b + hi_a lo_b +
# hi_a hi_b), which drops lo_a lo_b and leaves each operand's split within
# 2^-21 of it, and sums a K step's products on the tensor cores (rounding
# toward zero, chains of 12) before adding them in f32; the plain version sums
# exact f32 products.  Both errors are ~1e-6 of the largest output at K up to
# 14336 (1.1e-6 at the projection shape on an H100, PERF.md §6); the limit,
# ~170 f32 steps, sits above that and below one TF32 product (~1e-3).
# bfloat16: both round the f32 sum once, and a flipped rounding is one bf16
# step, at most 2^-7 of the largest output.  Flash attention: max abs error;
# the bf16 kernel also rounds P to bf16 for the tensor-core product, one bf16
# step of outputs between 2 and 4.
MM_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
FLASH_TOL = {"float32": 2e-3, "bfloat16": 3e-2}


def fmt_csv(*cols) -> str:
    """One row of the reference benchmarks' CSV layout."""
    return ",".join(str(c) for c in cols)


@dataclass
class Case:
    name: str
    kernel: str                   # "atom_matmul" | "flash_attention"
    dtype: str
    shape: dict


def cases(quick: bool) -> list[Case]:
    if quick:
        return [Case("ref_f32", "atom_matmul", "float32",
                     dict(M=256, N=256, K=256, block=128)),
                Case("proj_bf16", "atom_matmul", "bfloat16",
                     dict(M=40, N=300, K=64, block=128)),
                Case("prefill_attn", "flash_attention", "bfloat16",
                     dict(B=1, S=48, Hq=4, Hk=2, D=16))]
    cfg = get_config("llama3-8b")
    d, ff, dh, T = cfg.d_model, cfg.d_ff, cfg.head_dim, PREFILL_TOKENS
    proj = lambda K, N: dict(M=T, K=K, N=N, block=256)
    return [
        Case("ref_1024_f32", "atom_matmul", "float32",
             dict(M=1024, N=1024, K=1024, block=256)),
        Case("llama3-8b_wq_wo", "atom_matmul", "bfloat16",
             proj(d, cfg.n_heads * dh)),
        Case("llama3-8b_wk_wv", "atom_matmul", "bfloat16",
             proj(d, cfg.n_kv_heads * dh)),
        Case("llama3-8b_wi_wg", "atom_matmul", "bfloat16", proj(d, ff)),
        Case("llama3-8b_mlp_wo", "atom_matmul", "bfloat16", proj(ff, d)),
        Case("llama3-8b_prefill_attn", "flash_attention", "bfloat16",
             dict(B=1, S=T, Hq=cfg.n_heads, Hk=cfg.n_kv_heads, D=dh)),
    ]


@dataclass
class Prepared:
    run: Callable            # n_atoms -> a fresh output, through the entry point
    timed: Callable          # n_atoms -> every atom into one output made once
    plain: Callable          # () -> the plain PyTorch version's output
    limit: float             # max abs error allowed against ``plain()``
    tiles: int
    ctas: Callable           # (start, num_tiles) -> CTA tiles an atom runs
    occ: Optional[int]       # CTAs an SM holds, None off the GPU


def _prepare(case: Case, dev, gen) -> Prepared:
    dt = getattr(torch, case.dtype)
    randn = lambda *s: torch.randn(s, generator=gen, device=dev,
                                   dtype=torch.float32).to(dt)
    cuda = dev.type == "cuda"
    s = case.shape
    if case.kernel == "atom_matmul":
        a, b, bm = randn(s["M"], s["K"]), randn(s["K"], s["N"]), s["block"]
        tiles = tile_count(s["M"], s["N"], bm, bm)
        c = torch.zeros((s["M"], s["N"]), dtype=dt, device=dev)
        cta = mm_ops.cta_shape(dt, bm, mm_ops.vec16(a, b, c))

        def timed(n):
            for start, ln in schedule(tiles, n):
                mm_ops.matmul_atom(a, b, c, start=start, num_tiles=ln,
                                   block_m=bm, block_n=bm)
            return c

        want = matmul_ref(a, b)
        return Prepared(
            run=lambda n: mm_ops.atom_matmul(a, b, n_atoms=n, block_m=bm,
                                             block_n=bm),
            timed=timed, plain=lambda: want,
            limit=MM_TOL[case.dtype] * want.float().abs().max().item(),
            tiles=tiles,
            ctas=lambda start, n: len(mm_ops.cta_tiles(
                s["M"], s["N"], bm, bm, start, n, *cta)),
            occ=mm_ops.ctas_per_sm(dt, bm) if cuda else None)
    q = randn(s["B"], s["S"], s["Hq"], s["D"])
    k = randn(s["B"], s["S"], s["Hk"], s["D"])
    v = randn(s["B"], s["S"], s["Hk"], s["D"])
    tiles = fa_ops.tile_space(q)
    o = torch.zeros_like(q)

    def timed(n):
        for start, ln in schedule(tiles, n):
            fa_ops.flash_attention_atom(q, k, v, o, start=start,
                                        num_tiles=ln, causal=True)
        return o

    return Prepared(
        run=lambda n: fa_ops.flash_attention(q, k, v, causal=True,
                                             n_atoms=n),
        timed=timed, plain=lambda: attention_ref(q, k, v, causal=True),
        limit=FLASH_TOL[case.dtype], tiles=tiles, ctas=lambda start, n: n,
        occ=fa_ops.ctas_per_sm(s["D"], dt) if cuda else None)


def sweep(device=None, quick: bool = False) -> list[dict]:
    """One record per (case, atom count).  ``device=None`` means the GPU
    (raises when there is none); on the CPU the sizes are the quick ones and
    nothing is timed.  Raises if one atom disagrees with the plain version or
    an atomized result differs from n = 1."""
    from repro_torch.launch.timing import device_ms, enqueue_ms
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    quick = quick or not cuda
    sms = (torch.cuda.get_device_properties(dev).multi_processor_count
           if cuda else None)
    gen = make_generator(0, dev)
    records = []
    for case in cases(quick):
        p = _prepare(case, dev, gen)
        base = p.run(1)
        plain_err = (base.float() - p.plain().float()).abs().max().item()
        if not plain_err <= p.limit:
            raise RuntimeError(f"{case.name}: one atom differs from the plain "
                               f"version by {plain_err} > {p.limit}")
        base_ms = None
        for n in (QUICK_N_ATOMS if quick else N_ATOMS):
            ranges = schedule(p.tiles, n)
            out = p.run(n)
            err = (out.float() - base.float()).abs().max().item()
            if err != 0 or (cuda and not torch.equal(out, base)):
                raise RuntimeError(f"{case.name}: {n} atoms differ from one "
                                   f"by {err}")
            rec = {"case": case.name, "kernel": case.kernel,
                   "dtype": case.dtype, "shape": case.shape, "n_atoms": n,
                   "atoms": len(ranges), "tiles": p.tiles,
                   "ctas": p.ctas(0, p.tiles), "max_abs_err": err,
                   "plain_err": plain_err, "plain_limit": p.limit,
                   "device_ms": None, "overhead": None,
                   "host_ms_per_atom": None, "ctas_per_sm": p.occ,
                   "waves": None}
            if cuda:
                ms = device_ms(lambda: p.timed(n), iters=ITERS)
                base_ms = ms if n == 1 else base_ms
                rec.update(
                    device_ms=ms, overhead=ms / base_ms,
                    host_ms_per_atom=enqueue_ms(lambda: p.timed(n), iters=5)
                    / len(ranges),
                    waves=sum(math.ceil(p.ctas(start, ln) / (sms * p.occ))
                              for start, ln in ranges))
            records.append(rec)
    return records


def rows(records: list[dict]) -> list[str]:
    out = [fmt_csv("bench", "case", "value", "unit")]
    for r in records:
        if r["device_ms"] is None:
            value = "not measured"
            unit = f"(cpu) maxerr={r['max_abs_err']:.1e}"
        else:
            value = f"{r['device_ms'] * 1e3:.1f}"
            unit = (f"us  overhead={r['overhead']:.2f}x "
                    f"maxerr={r['max_abs_err']:.1e} "
                    f"host_us_per_atom={r['host_ms_per_atom'] * 1e3:.1f} "
                    f"waves={r['waves']}")
        out.append(fmt_csv("atoms", f"{r['case']}/atoms_{r['n_atoms']}",
                           value, f"{unit} atoms={r['atoms']} "
                           f"tiles={r['tiles']} ctas={r['ctas']} "
                           f"plainerr={r['plain_err']:.1e}"))
    return out


def run(device=None, quick: bool = False) -> list[str]:
    """Sweep, print the rows and return them."""
    out = rows(sweep(device, quick))
    for r in out:
        print(r)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without a GPU)")
    ap.add_argument("--quick", action="store_true",
                    help="small shapes and atom counts 1, 4, 32")
    args = ap.parse_args(argv)
    run(args.device, args.quick)


if __name__ == "__main__":
    main()
