"""How far a full-size model's logits move with the rounding of its attention.

    python3 tools/logit_spread.py --arch llava-next-34b --depths 1,4,15,30,60

Random bf16 weights from seed 0 (``--depths`` cuts the stack to its first
layers, at full width), two prompts of ``--prompt`` random tokens: a prefill
and one decode step, run with each attention in turn and compared by the
max abs difference of their f32 logits:

* ``kernel``   the hand-written CUDA kernels (the port's path);
* ``plain``    their plain PyTorch versions (``ref.py``, f32 math rounded to
               bf16 once; one query head / batch row at a time);
* ``batched``  the same plain math over the whole call at once, which
               differs from ``plain`` only in the order of f32 sums.

``kernel_vs_plain`` is what ``chip_smoke.py`` holds a served path to;
``batched_vs_plain`` says how far the same attention, rounded once more or
less often, moves the logits.  Prints one JSON line a depth, then the card's
name and power limit.  Runs on the GPU; ``--reduced --device cpu`` walks it
on the CPU, where the kernel route is the plain version.  A diagnostic
beside the port: the package does not import it.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


@contextlib.contextmanager
def attention(kind: str):
    """Route both wrappers' atoms to one attention (``kernel``, ``plain`` or
    ``batched``, which computes whole outputs only)."""
    from repro_torch.kernels.decode_attention import ops as d_ops, ref as d_ref
    from repro_torch.kernels.flash_attention import ops as f_ops, ref as f_ref
    saved = d_ops.decode_attention_atom, f_ops.flash_attention_atom

    def flash_batched(q, k, v, o, *, start, num_tiles, causal=True,
                      block_q=64, window=0):
        o.copy_(f_ref.attention_ref(q, k, v, causal=causal, window=window))
        return o

    def decode_batched(q, kc, vc, lens, o, *, start, num_rows, lse=None):
        out, row_lse = d_ref.decode_attention_ref(q, kc, vc, lens,
                                                  return_lse=True)
        o.copy_(out)
        if lse is not None:
            lse.copy_(row_lse)
        return o

    routes = {"kernel": saved[::-1],
              "plain": (f_ref.flash_attention_atom_ref,
                        d_ref.decode_attention_atom_ref),
              "batched": (flash_batched, decode_batched)}
    f_ops.flash_attention_atom, d_ops.decode_attention_atom = routes[kind]
    try:
        yield
    finally:
        d_ops.decode_attention_atom, f_ops.flash_attention_atom = saved


def spread(arch: str, depths, prompt: int, *, seed: int = 0,
           reduced: bool = False, device=None) -> list[dict]:
    """One record a depth (also printed as a JSON line)."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.models import transformer
    from repro_torch.models.common import resolve_device, tree_map
    from repro_torch.models.registry import init_model
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder or cfg.hybrid is not None or cfg.moe:
        raise ValueError("logit_spread: dense decoder-only configs")
    params = init_model(cfg, seed=seed, device=dev)
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(2, cfg.vocab_size, (2, prompt)),
                           device=dev)
    nxt = torch.as_tensor(rng.integers(2, cfg.vocab_size, (2,)), device=dev)
    recs = []
    for n in depths:
        p = {**params, "blocks": {"0": tree_map(lambda t: t[:n],
                                                params["blocks"]["0"])}}
        c = dataclasses.replace(cfg, n_layers=n)
        out = {}
        for kind in ("kernel", "plain", "batched"):
            with attention(kind):
                lp, caches = transformer.prefill(p, c, toks,
                                                 max_len=prompt + 8)
                ld, _ = transformer.decode_step(p, c, nxt, prompt, caches)
            out[kind] = (lp.float(), ld.float())
        rec = {"arch": arch, "layers": n, "prompt_tokens": prompt,
               "logit_abs_max": out["plain"][0].abs().max().item()}
        for kind in ("kernel", "batched"):
            rec[f"{kind}_vs_plain"] = {
                step: (out[kind][i] - out["plain"][i]).abs().max().item()
                for i, step in enumerate(("prefill", "decode"))}
        print(json.dumps(rec), flush=True)
        recs.append(rec)
    return recs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llava-next-34b")
    ap.add_argument("--depths", default="1,4,15,30,60",
                    help="comma-separated layer counts")
    ap.add_argument("--prompt", type=int, default=200)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without a GPU)")
    args = ap.parse_args(argv)
    spread(args.arch, [int(d) for d in args.depths.split(",")], args.prompt,
           reduced=args.reduced, device=args.device)
    if args.device == "cpu":
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
