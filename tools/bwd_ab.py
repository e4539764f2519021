"""Versions of the flash-attention backward's source, timed in turns in one call.

    python3 tools/bwd_ab.py --path olmo_f32 old=build/old.cu new=src/repro_torch/kernels/csrc/flash_attention_bwd.cu old new new old

Each ``name=file.cu`` (optionally ``name=file.cu,ops.py`` when the version's
tiles differ, so ``ops.bwd_blocks`` must too) is a version of
``csrc/flash_attention_bwd.cu``; the names after them are the order to run.
For each, the version is put in place, built in a fresh process and run
through ``chip_smoke.check_flash_bwd_path`` at the path's training shape
(``chip_smoke.BWD_PATH_SHAPES``: every check of the smoke, then the delta
pass and one atom of every tile timed); the dQ and dK/dV tiles are also
timed apart.  Prints one JSON line a run, then the card's name and power
limit.  The checkout's own files are put back at the end.  Runs on the GPU
only; a diagnostic beside the port: the package does not import it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CU = os.path.join(ROOT, "src/repro_torch/kernels/csrc/flash_attention_bwd.cu")
OPS = os.path.join(ROOT, "src/repro_torch/kernels/flash_attention/ops.py")

CHILD = r'''
import json, sys, torch
sys.path.insert(0, "src"); sys.path.insert(0, ".")
import chip_smoke
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import ops, ref
path = sys.argv[1]
B, S, Hq, Hk, D, dtype, causal, W = chip_smoke.BWD_PATH_SHAPES[path][0]
dev = torch.device("cuda")
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device=dev)
gen.manual_seed(0)
build.build_all(("flash_attention_bwd",))
regs = build.ptxas_report("flash_attention_bwd")["kernels"]
res = chip_smoke.check_flash_bwd_path(torch, dev, gen, B=B, S=S, Hq=Hq, Hk=Hk,
                                      D=D, dtype=dtype, causal=causal,
                                      window=W, iters=10)
dt = getattr(torch, dtype)
q, do = (torch.randn(B, S, Hq, D, device=dev).to(dt) for _ in range(2))
k, v = (torch.randn(B, S, Hk, D, device=dev).to(dt) for _ in range(2))
kw = dict(causal=causal, window=W)
o, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
d = ops.attention_delta(o, do)
dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
n_dq = ref.bwd_tile_space(q, k, *ops.bwd_blocks(dt, D))[0]
total = ops.bwd_tile_space(q, k)
half = {name: chip_smoke.time_ms(torch, lambda s0=s0, n=n: (
            ops.flash_attention_bwd_atom(q, k, v, do, lse, d, dq, dk, dv,
                                         start=s0, num_tiles=n, **kw)),
                                 iters=10)
        for name, (s0, n) in {"dq_ms": (0, n_dq),
                              "dkv_ms": (n_dq, total - n_dq)}.items()}
print("RESULT " + json.dumps({
    "ms": res["ms"], "err": res["err"], "library_ms": res["library_ms"],
    **half, "ptxas": {k: v for k, v in regs.items() if "bwd" in k}}))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", default="olmo_f32",
                    help="a key of chip_smoke.BWD_PATH_SHAPES")
    ap.add_argument("items", nargs="+",
                    help="name=file.cu[,ops.py] definitions, then the names "
                         "in the order to run")
    args = ap.parse_args(argv)
    versions = {}
    for item in args.items:
        if "=" in item:
            name, files = item.split("=", 1)
            versions[name] = files.split(",")
    order = [x for x in args.items if "=" not in x]
    if not order or any(x not in versions for x in order):
        ap.error("name every version as name=file.cu before the run order")
    texts = {name: [open(f).read() for f in files]
             for name, files in versions.items()}
    own = (open(CU).read(), open(OPS).read())
    try:
        for name in order:
            cu, *ops = texts[name]
            with open(CU, "w") as f:
                f.write(cu)
            with open(OPS, "w") as f:
                f.write(ops[0] if ops else own[1])
            r = subprocess.run([sys.executable, "-c", CHILD, args.path],
                               cwd=ROOT, capture_output=True, text=True,
                               timeout=900)
            out = [ln[7:] for ln in r.stdout.splitlines()
                   if ln.startswith("RESULT ")]
            print(json.dumps({"version": name, "path": args.path,
                              **(json.loads(out[0]) if out else {
                                  "failed": r.returncode,
                                  "tail": (r.stdout + r.stderr)[-2000:]})}),
                  flush=True)
    finally:
        for path, text in ((CU, own[0]), (OPS, own[1])):
            with open(path, "w") as f:
                f.write(text)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
