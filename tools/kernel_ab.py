"""Versions of the kernels' sources, checked and timed in turns in one call.

    python3 tools/kernel_ab.py new=atom_matmul old=atom_matmul@build/old.cu \
        new old old new [--peak] [--path olmo_f32]

Each ``name=kernel[@file.cu][:-DA=1,-DB=2]`` is a version of
``csrc/<kernel>.cu`` (``atom_matmul``, ``flash_attention``,
``flash_attention_bwd`` or ``decode_attention``), built by ``nvcc`` with
the package's flags, the given ``-D`` flags and ``csrc/`` on the include
path (a header beside ``file.cu`` comes first, so a copied directory is a
version of its headers too); the names after them are the order to run.  All versions build at
once; each is then loaded in place of the package's library and run through
``chip_smoke``'s checks: ``atom_matmul`` the f32 cases (K up to 14336, both
f32 routes, atoms bit-equal, tiles untouched) and its f32 headline
(``M=1000, K=4096, N=14336``: ``ms``, ``library_ms``, also timed alone as
``ms_alone``); ``flash_attention`` the f32 cases at head_dim 64 / 128 / 256
(window, chunked prefill, ragged ``Sk``; 1e-5 of max|output|, the lse) and
its f32 headline; ``flash_attention_bwd`` the training path ``--path`` (a
key of ``chip_smoke.BWD_PATH_SHAPES``: every check of the smoke, the delta
pass and one atom of every tile timed as ``ms``, the dQ and dK/dV tiles
apart as ``dq_ms`` / ``dkv_ms``); ``decode_attention`` the f32 cases (every
split count, head_dim 64 / 128 / 256, G up to 20; 2e-5, atoms bit-equal)
and its f32 headline at both ``DECODE_SHAPES`` (``serving``,
``long_context``; at ``serving`` also with every length 0,
``zero_lens_ms``), each version at the package's own split schedule and
cluster fit (a version that ignores ``nsplit``, as the one-block-a-row
kernel did, runs as it is), or with ``--fit own`` at its own library's fit
(every version then answers the package's occupancy query).  Prints one
JSON line a run (the version's registers and spills with it) and appends
it to ``--out`` (``reports/kernel_ab.jsonl``), then the card's name and
power limit.
``--peak`` also times ``tools/tf32_peak.cu``: the card's rate of
``mma.sync`` m16n8k8 TF32 at 4 to 32 warps an SM.  Runs on the GPU only; a
diagnostic beside the port: the package does not import it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

MM_CASES = [dict(M=128, N=128, K=128), dict(M=300, N=260, K=200),
            dict(M=64, N=512, K=96), dict(M=257, N=129, K=65),
            dict(M=1024, N=1024, K=1024, bm=256),
            dict(M=200, N=260, K=96, bm=256, bn=128, strided=True),
            dict(M=300, N=520, K=4096, bm=256),
            dict(M=130, N=260, K=14336, bm=128, bn=256),
            dict(M=1000, N=384, K=4096, bm=256, bn=128, strided=True)]
FLASH_CASES = [dict(B=1, Sq=37, Sk=37, Hq=32, Hk=8, D=128),
               dict(B=1, Sq=512, Sk=512, Hq=32, Hk=8, D=128),
               dict(B=1, Sq=300, Sk=1000, Hq=32, Hk=8, D=128, causal=False),
               dict(B=2, Sq=130, Sk=130, Hq=4, Hk=4, D=64),
               dict(B=2, Sq=90, Sk=50, Hq=6, Hk=2, D=64),
               dict(B=2, Sq=500, Sk=500, Hq=8, Hk=2, D=64, window=100),
               dict(B=1, Sq=200, Sk=200, Hq=4, Hk=1, D=256),
               dict(B=2, Sq=100, Sk=1500, Hq=12, Hk=12, D=64, causal=False),
               dict(B=1, Sq=300, Sk=300, Hq=56, Hk=8, D=128),
               dict(B=1, Sq=77, Sk=333, Hq=16, Hk=1, D=256, causal=False),
               dict(B=1, Sq=100, Sk=612, Hq=8, Hk=2, D=256, window=128)]
DECODE_CASES = [dict(B=4, Hq=32, Hk=8, D=128, S=2048, lens=[2048, 513, 0, 64]),
                dict(B=2, Hq=8, Hk=2, D=64, S=300, lens=[300, 17]),
                dict(B=3, Hq=6, Hk=2, D=128, S=96, lens=[96, 1, 50]),
                dict(B=3, Hq=16, Hk=1, D=256, S=2048, lens=[2048, 1, 0]),
                dict(B=4, Hq=56, Hk=8, D=128, S=2048, lens=[2048, 700, 0, 65]),
                dict(B=4, Hq=12, Hk=12, D=64, S=1500, lens=[1500] * 4),
                dict(B=3, Hq=32, Hk=8, D=128, S=64, lens=[0, 63, 64]),
                dict(B=4, Hq=32, Hk=8, D=128, S=150, lens=[127, 128, 129, 150]),
                dict(B=4, Hq=8, Hk=2, D=64, S=300, lens=[0, 127, 129, 300]),
                dict(B=2, Hq=40, Hk=2, D=128, S=1000, lens=[128, 1000]),
                dict(B=4, Hq=16, Hk=1, D=256, S=300, lens=[0, 127, 129, 300])]


def _matmul(torch, cs, dev, gen) -> dict:
    from repro_torch.kernels.atom_matmul import ops
    from repro_torch.kernels.atoms import tile_count
    M, K, N = 1000, 4096, 14336
    a = torch.randn(M, K, device=dev)
    b = torch.randn(K, N, device=dev)
    c = torch.empty(M, N, device=dev)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    alone = cs.time_ms(torch, lambda: ops.matmul_atom(
        a, b, c, start=0, num_tiles=tile_count(M, N, 256, 256)), iters=10,
        flush=flush)
    cases = [(c["M"], c["N"], c["K"], *cs.check_matmul(
        torch, dev, gen, dtype="float32", **c)[:2]) for c in MM_CASES]
    h = cs.matmul_headline(torch, dev, gen, flush, iters=10, real=True,
                           dtype="float32")
    return {"ms_alone": alone, "cases": cases,
            **{k: h[k] for k in ("ms", "library_ms", "plain_ms",
                                 "max_abs_err", "err_limit", "route")}}


def _flash(torch, cs, dev, gen) -> dict:
    cases = []
    for c in FLASH_CASES:
        r = cs.check_flash(torch, dev, gen, dtype="float32", **c)
        cases.append({**c, **{k: r[k] for k in ("max_abs_err", "rel_err",
                                                 "lse_err")}})
    h = cs.flash_headline(torch, dev, gen, iters=10, real=True,
                          dtype="float32")
    return {"cases": cases, **{k: h[k] for k in (
        "ms", "library_ms", "plain_ms", "max_abs_err", "rel_err", "lse_err",
        "route")}}


def _decode(torch, cs, dev, gen) -> dict:
    cases = []
    for c in DECODE_CASES:
        err, plan, _ = cs.check_decode(torch, dev, gen, dtype="float32",
                                       **c)
        cases.append({**c, "max_abs_err": err, "took": plan})
    from repro_torch.kernels.decode_attention import ops
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {"cases": cases, "fit_f32_d128": ops.cluster_fit(dev, 128,
                                                           torch.float32)}
    for shape in ("serving", "long_context"):
        h = cs.decode_headline(torch, dev, gen, flush, iters=30, shape=shape,
                               dtype="float32")
        out[shape] = {k: h[k] for k in (
            "ms", "library_ms", "plain_ms", "bound_ms", "max_abs_err",
            "err_limit", "dropped_split_err", "took")}
    # the launch, prologue and merges alone: every length 0, no key loaded
    B, Hq, Hk, D, S, _ = cs.DECODE_SHAPES["serving"][0]
    q = torch.randn(B, Hq, D, device=dev)
    kc = torch.randn(B, S, Hk, D, device=dev)
    zero = torch.zeros(B, dtype=torch.int32, device=dev)
    o = torch.empty_like(q)
    out["serving"]["zero_lens_ms"] = cs.time_ms(torch, lambda: (
        ops.decode_attention_atom(q, kc, kc, zero, o, start=0,
                                  num_rows=B * Hk)), iters=30, flush=flush)
    return out


def _pin_decode_fit(torch, dev) -> None:
    """Every decode version runs at the package's split schedule: the
    cluster fit its own library reads, once, for each head dim and dtype
    (a version's library need not answer the query the package asks)."""
    from repro_torch.kernels.decode_attention import ops
    fits = {(D, dt): ops.cluster_fit(dev, D, dt) for D in (64, 128, 256)
            for dt in (torch.float32, torch.bfloat16)}
    ops.cluster_fit = lambda device, D, dtype=torch.bfloat16: fits[D, dtype]
    ops.max_active_clusters = lambda D, n, dtype=torch.bfloat16: fits[
        D, dtype][ops.SPLITS.index(n)]


def _backward(torch, cs, dev, gen, path) -> dict:
    from repro_torch.kernels.flash_attention import ops, ref
    B, S, Hq, Hk, D, dtype, causal, W = cs.BWD_PATH_SHAPES[path][0]
    r = cs.check_flash_bwd_path(torch, dev, gen, B=B, S=S, Hq=Hq, Hk=Hk, D=D,
                                dtype=dtype, causal=causal, window=W,
                                iters=10)
    dt = getattr(torch, dtype)
    q, do = (torch.randn(B, S, Hq, D, device=dev).to(dt) for _ in range(2))
    k, v = (torch.randn(B, S, Hk, D, device=dev).to(dt) for _ in range(2))
    kw = dict(causal=causal, window=W)
    o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    d = ops.attention_delta(o, do)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    n_dq = ref.bwd_tile_space(q, k, *ops.bwd_blocks(dt, D))[0]
    total = ops.bwd_tile_space(q, k)
    half = {name: cs.time_ms(torch, lambda s0=s0, n=n: (
                ops.flash_attention_bwd_atom(q, k, v, do, lse, d, dq, dk, dv,
                                             start=s0, num_tiles=n, **kw)),
                             iters=10)
            for name, (s0, n) in {"dq_ms": (0, n_dq),
                                  "dkv_ms": (n_dq, total - n_dq)}.items()}
    return {"path": path, **{k: r[k] for k in ("ms", "err", "library_ms")},
            **half}


def _peak(torch, cs, dev, build, out_dir: Path) -> None:
    so = out_dir / "libtf32_peak.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                    str(ROOT / "tools" / "tf32_peak.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.tf32_peak.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    iters, sms = 4096, torch.cuda.get_device_properties(dev).multi_processor_count
    for nc in (4, 8, 16):
        for warps in (4, 8, 16, 32):
            out = torch.empty(sms * warps * 32, device=dev)
            run = lambda: lib.tf32_peak(        # noqa: E731
                nc, sms, warps * 32, iters, out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            if run() != 0:                      # too many registers a block
                continue
            ms = cs.time_ms(torch, run, iters=5)
            flops = sms * warps * nc * iters * 2 * 16 * 8 * 8
            print(json.dumps({"tf32_peak": {
                "chains": nc, "warps_per_sm": warps, "ms": ms,
                "tflops": flops / ms / 1e9}}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--peak", action="store_true",
                    help="also time mma.sync TF32 (tools/tf32_peak.cu)")
    ap.add_argument("--path", default="olmo_f32",
                    help="flash_attention_bwd's training path: a key of "
                         "chip_smoke.BWD_PATH_SHAPES")
    ap.add_argument("--fit", choices=("package", "own"), default="package",
                    help="decode_attention's cluster fit: the package "
                         "library's for every version, or each version's")
    ap.add_argument("--out", default=str(ROOT / "reports" / "kernel_ab.jsonl"),
                    help="file the JSON lines are appended to")
    ap.add_argument("items", nargs="+",
                    help="name=kernel[@file.cu][:-Dflags] definitions, then "
                         "the names in the order to run")
    args = ap.parse_args(argv)
    versions, order = {}, []
    for item in args.items:
        if "=" not in item:
            order.append(item)
            continue
        name, spec = item.split("=", 1)
        lib, _, flags = spec.partition(":")
        kernel, _, src = lib.partition("@")
        versions[name] = (kernel, src, [f for f in flags.split(",") if f])
    if not order or any(x not in versions for x in order):
        ap.error("define every version as name=kernel[...] before the order")

    import torch
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.atom_matmul import ops as mm_ops
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fl_ops
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = Path(tempfile.mkdtemp(prefix="kernel_ab_"))
    started = {}
    for name, (kernel, src, flags) in versions.items():
        so = out_dir / f"lib{name}.so"
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, *flags, "-I",
               str(build.CSRC), "-o", str(so),
               src or str(build.CSRC / f"{kernel}.cu")]
        started[name] = (so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    build.build_all()
    for name, (so, proc) in started.items():
        log, _ = proc.communicate()
        so.with_suffix(".log").write_text(log)
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log[-4000:]}")
    if args.fit == "package" and any(v[0] == "decode_attention"
                                     for v in versions.values()):
        _pin_decode_fit(torch, dev)
    runs = {"atom_matmul": _matmul, "flash_attention": _flash,
            "flash_attention_bwd": lambda *a: _backward(*a, args.path),
            "decode_attention": _decode}
    gen = torch.Generator(device=dev)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    for name in order:
        kernel, _, flags = versions[name]
        so = started[name][0]
        build._loaded[kernel] = ctypes.CDLL(str(so))
        if kernel == "flash_attention_bwd":
            fl_ops._bwd_lib = None
        elif kernel == "flash_attention":
            fl_ops._lib = None
        elif kernel == "decode_attention":
            dec_ops._lib = None
            dec_ops._fit.clear()
        else:
            mm_ops._lib = None
        gen.manual_seed(0)
        res = {"version": name, "kernel": kernel, "flags": flags}
        try:
            res.update(runs[kernel](torch, cs, dev, gen))
        except SystemExit as e:     # a failed check: record it, run on
            res["failed"] = str(e)
        orig = build.library_path
        build.library_path = lambda n, so=so: so
        try:
            res["ptxas"] = {k: v for k, v in build.ptxas_report(kernel)[
                "kernels"].items()
                if "tf32" in k or "bwd" in k or k.startswith("decode_attn")
                or k.startswith("decode_split_f32")}
        finally:
            build.library_path = orig
        print(json.dumps(res), flush=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(res) + "\n")
    if args.peak:
        _peak(torch, cs, dev, build, out_dir)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
