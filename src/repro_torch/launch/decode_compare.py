"""Decode attention (K1): its timed shapes, the limit its bf16 result is held
to there, and a comparison of two source trees' kernels on one GPU.

    PYTHONPATH=src python -m repro_torch.launch.decode_compare \\
        --tree base=OTHER/src --tree change=src --order base,change,change,base

Each run is a fresh process that imports ``repro_torch`` from its tree's
``src`` directory (the other tree needs none of this module), builds that
tree's ``decode_attention.cu``, and times one atom over every row
(``decode_attention_atom``, bf16, L2 flushed before each launch, median of
CUDA-event times by the tree's ``launch.timing.device_ms``) at each of
``COMPARE_SHAPES``; and again with every length 0 (``zero_lens_ms``: launch,
prologue and merge, no key loaded).  Where the tree's kernel writes an lse
(``decode_attention_atom(..., lse=)``) it is timed with it too
(``lse_ms``); ``sha256`` digests the output bits, which two trees fed the
same inputs share where their arithmetic is the same.  ``floor_ms`` is the same harness around
the smallest kernel (zeroing 16 KB): what any one launch measures at least.
Each run holds its output against the plain version with ``headline_limit``.
A run also times flash attention (K2) at the smoke's serving shape (``flash_attention_atom``, one llama3-8b prompt of 1000 tokens, causal,
bf16, L2 warm as the smoke times it), held to 3e-2 against the plain
version, and its backward (K2-bwd) at olmo-1b's training shape (the delta
pass and one atom of every tile, L2 warm), held row by row to
``BWD_REL_TOL`` against autograd of the plain version.  Prints one JSON line
a run, then the card's name and power limit.  Needs a GPU.

``chip_smoke.py`` times ``DECODE_SHAPES`` and the backward and holds them to
the same limits.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import math
import os
import subprocess
import sys

# (B, Hq, Hk, D, S, lens) at full size, then the smoke's rehearsal toy: the
# serving path's 4 slots of llama3-8b with a 2048-token stripe each and ragged
# lengths; one slot of llama3-8b at its 8192-token context
DECODE_SHAPES = {
    "serving": ((4, 32, 8, 128, 2048, [300, 700, 1000, 1040]),
                (2, 4, 2, 16, 64, [5, 64])),
    "long_context": ((1, 32, 8, 128, 8192, [8000]),
                     (1, 4, 2, 16, 128, [100])),
}
# the comparison adds 40 slots of llama3-8b (320 rows): the split kernel runs
# there with one split a row, the domain of the one-block-a-row kernel it
# replaced
COMPARE_SHAPES = {**{k: v[0] for k, v in DECODE_SHAPES.items()},
                  "large_batch": (40, 32, 8, 128, 2048,
                                  [300, 700, 1000, 1040] * 10)}

# bf16 decode attention against its plain version at the timed shapes: max
# abs error over the largest |output|.  Both sides round an f32 result to
# bf16 once (and the kernel rounds P to bf16 for the tensor-core product), so
# they differ by about one bf16 step at the largest output, 2^-8 to 2^-7 of
# it; the limit is two steps.  An absolute limit cannot serve here: at 8000
# keys the outputs are about N(0, e/8000), largest ~0.07, below an O(1)
# limit; leaving out one split of a row moves the output by several times
# this limit (``dropped_split_err``, which the smoke reports and checks).
DECODE_REL_TOL = 2.0 ** -6


# flash attention's backward (bf16) against autograd of the plain version in
# f32 on the same bf16 inputs, row by row: for each query row of dQ and each
# key row of dK and dV, the max abs error over its heads and head dims over
# the row's largest |gradient|.  The kernel rounds P and dS to bf16 for its
# second products and its outputs to bf16 once, each a relative 2^-8; a row
# sums up to thousands of such terms, so it differs by a few bf16 steps at
# its largest value: the limit is eight (2^-5).  A row whose exact gradient
# is zero or nearly (a query that sees one key: P = 1, dS = 0) is measured
# against 2^-8 of the tensor's largest |gradient| instead of its own
# (``bwd_row_err``).
BWD_REL_TOL = 2.0 ** -5
# the backward's timed shape (B, S, H, D), causal: olmo-1b's training step
BWD_SHAPE = (2, 2048, 16, 128)


def bwd_row_err(got, want):
    """Each row's max abs error over its heads and head dims, over the row's
    largest |want| (at least 2^-8 of the tensor's largest): [B, S]."""
    d = (got.float() - want.float()).abs().amax(dim=(2, 3))
    scale = want.float().abs().amax(dim=(2, 3))
    return d / scale.clamp_min(2.0 ** -8 * scale.max().item() + 1e-30)


def headline_limit(want) -> float:
    """The largest max abs error ``DECODE_REL_TOL`` allows against ``want``."""
    return DECODE_REL_TOL * want.float().abs().max().item()


def _masked_attention(q, k_cache, v_cache, keep):
    """Plain f32 decode attention over the keys ``keep`` [B,S] marks; a row
    with no key gives zeros."""
    import torch
    B, Hq, D = q.shape
    Hk = k_cache.shape[2]
    qg = q.reshape(B, Hk, Hq // Hk, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_cache.float()) / math.sqrt(D)
    s = s.masked_fill(~keep[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    return torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float()).reshape(
        B, Hq, D)


def dropped_split_err(q, k_cache, v_cache, lens, chunk: int) -> float:
    """What a kernel that left out one split of ``chunk`` keys would read:
    the least, over the splits that hold a key, of the max abs difference
    between plain attention over every valid key and over all but that
    split's.  A limit below it sees any dropped split."""
    import torch
    S = k_cache.shape[1]
    kpos = torch.arange(S, device=q.device)
    lens = lens.clamp(0, S)
    keep = kpos[None, :] < lens[:, None]
    full = _masked_attention(q, k_cache, v_cache, keep)
    top = int(lens.max().item())
    errs = [(_masked_attention(q, k_cache, v_cache, keep & ~(
        (kpos >= j * chunk) & (kpos < (j + 1) * chunk))[None, :]) - full)
        .abs().max().item() for j in range(-(-top // chunk))]
    return min(errs) if errs else 0.0


def one(src: str, iters: int) -> dict:
    """Time the tree at ``src`` (this process imports it)."""
    sys.path.insert(0, os.path.abspath(src))
    import torch
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.launch.timing import device_ms
    if not torch.cuda.is_available():
        raise SystemExit("decode_compare: needs a GPU")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    small = torch.empty(8192, dtype=torch.bfloat16, device=dev)
    out = {"src": src, "floor_ms": device_ms(small.zero_, iters=iters)}
    for name, (B, Hq, Hk, D, S, lens) in COMPARE_SHAPES.items():
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(
                torch.bfloat16)
        q, kc, vc = randn(B, Hq, D), randn(B, S, Hk, D), randn(B, S, Hk, D)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        o = torch.empty_like(q)

        def atom():
            ops.decode_attention_atom(q, kc, vc, lens_t, o, start=0,
                                      num_rows=B * Hk)
        ms = device_ms(atom, iters=iters, flush=flush)
        want = ref.decode_attention_ref(q, kc, vc, lens_t)
        err = (o.float() - want.float()).abs().max().item()
        if not err <= headline_limit(want):
            raise SystemExit(f"decode_compare: {src} {name}: err {err} > "
                             f"{headline_limit(want)}")
        digest = hashlib.sha256(o.view(torch.int16).cpu().numpy().tobytes()
                                ).hexdigest()
        lse_ms = None
        if "lse" in inspect.signature(ops.decode_attention_atom).parameters:
            lse = torch.empty(B, Hq, device=dev)
            lse_ms = device_ms(lambda: ops.decode_attention_atom(
                q, kc, vc, lens_t, o, start=0, num_rows=B * Hk, lse=lse),
                iters=iters, flush=flush)
        lens_t.zero_()
        zero_ms = device_ms(atom, iters=iters, flush=flush)
        out[name] = {"ms": ms, "lse_ms": lse_ms, "zero_lens_ms": zero_ms,
                     "max_abs_err": err, "err_limit": headline_limit(want),
                     "sha256": digest,
                     "took": (ops.plan(q, kc, vc) if hasattr(ops, "plan")
                              else None)}
    from repro_torch.kernels.flash_attention import ops as f_ops
    from repro_torch.kernels.flash_attention import ref as f_ref
    B, S, Hq, Hk, D = 1, 1000, 32, 8, 128
    q = torch.randn((B, S, Hq, D), generator=gen, device=dev).to(
        torch.bfloat16)
    k, v = (torch.randn((B, S, Hk, D), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(2))
    o = torch.empty_like(q)

    def flash_atom():
        f_ops.flash_attention_atom(q, k, v, o, start=0,
                                   num_tiles=f_ops.tile_space(q))
    ms = device_ms(flash_atom, iters=iters)
    err = (o.float() - f_ref.attention_ref(q, k, v).float()).abs().max()
    if not err.item() <= 3e-2:
        raise SystemExit(f"decode_compare: {src} flash: err {err}")
    out["flash_serving"] = {"ms": ms, "max_abs_err": err.item()}
    B, S, H, D = BWD_SHAPE
    q, k, v, do = (torch.randn((B, S, H, D), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(4))
    o, lse = f_ops.flash_attention(q, k, v, return_lse=True)
    grads = [torch.empty_like(t) for t in (q, k, v)]

    def bwd():
        delta = f_ops.attention_delta(o, do)
        f_ops.flash_attention_bwd_atom(q, k, v, do, lse, delta, *grads,
                                       start=0,
                                       num_tiles=f_ops.bwd_tile_space(q, k))
    ms = device_ms(bwd, iters=iters)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(f_ref.attention_ref(*leaves), leaves,
                               do.float())
    rows = {n: bwd_row_err(g, w).max().item()
            for n, g, w in zip(("dq", "dk", "dv"), grads, want)}
    if not max(rows.values()) <= BWD_REL_TOL:
        raise SystemExit(f"decode_compare: {src} flash backward reads "
                         f"{rows} > {BWD_REL_TOL}")
    out["flash_bwd_olmo"] = {"ms": ms, "row_err": rows}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", default=[],
                    help="NAME=SRC_DIR, a tree to time")
    ap.add_argument("--order", default="",
                    help="comma-separated NAMEs, the order of the runs")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one, args.iters)), flush=True)
        return 0
    trees = dict(t.split("=", 1) for t in args.tree)
    for name in args.order.split(","):
        # -P: the tree's src alone decides which repro_torch is imported
        run = subprocess.run([sys.executable, "-P", os.path.abspath(__file__),
                              "--one", trees[name], "--iters",
                              str(args.iters)],
                             capture_output=True, text=True, timeout=900)
        if run.returncode != 0:
            print(run.stdout + run.stderr, file=sys.stderr)
            return 1
        rec = json.loads(run.stdout.strip().splitlines()[-1])
        print(json.dumps({"tree": name, **rec}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
