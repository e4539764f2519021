"""Serving launcher: the continuous-batching engine over a synthetic request
stream, reporting latency and throughput.

Runs on the GPU unless ``--device cpu`` is given.  Serves every decoder-only
config: dense, MoE (qwen2-moe-a2.7b, grok-1-314b), hybrid RG-LRU + local
attention (recurrentgemma-9b), xLSTM (xlstm-1.3b) and the VLM backbone
(llava-next-34b, from token prompts, as the reference's server does).  The
encoder-decoder whisper-small is served through
``repro_torch.models.registry.serve_prefill / serve_decode``.  Submitting the
deployment to the online control plane (``--ctl-state-dir``) is not ported
yet.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
        --requests 8 --max-new 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \
        --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch recurrentgemma-9b --max-slots 2 --max-len 4608 \
        --min-prompt 2100 --requests 3 --max-new 8
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs.registry import ARCH_IDS, get_config


def serve(cfg, *, n_requests: int = 16, max_slots: int = 4,
          max_len: int = 128, max_new: int = 16, seed: int = 0,
          verbose: bool = True, device=None, params=None,
          min_prompt: int = 4):
    """Serve ``n_requests`` random prompts of ``[min_prompt, max_len // 2)``
    tokens and drain.  ``device=None`` means the GPU (raises when there is
    none).  Returns (done requests, latencies)."""
    if not 1 <= min_prompt < max_len // 2:
        raise ValueError(f"min_prompt {min_prompt} outside [1, "
                         f"{max_len // 2})")
    from repro_torch.serve.engine import ServeConfig, SlotServer

    rng = np.random.default_rng(seed)
    t0 = time.time()
    srv = SlotServer(cfg, params, serve_cfg=ServeConfig(
        max_slots=max_slots, max_len=max_len, max_new_tokens=max_new),
        seed=seed, clock=lambda: time.time() - t0, device=device)
    for _ in range(n_requests):
        plen = int(rng.integers(min_prompt, max_len // 2))
        srv.submit(rng.integers(2, cfg.vocab_size, plen).astype(np.int32),
                   max_new_tokens=max_new)
    done = srv.run_until_drained()
    lats = srv.latencies()
    if verbose:
        toks = sum(len(r.output) for r in done)
        wall = time.time() - t0
        print(f"[serve] {len(done)} requests, {toks} tokens in {wall:.2f}s "
              f"({toks/wall:.1f} tok/s) p50={np.percentile(lats,50)*1e3:.0f}ms "
              f"p99={np.percentile(lats,99)*1e3:.0f}ms on {srv.device}")
    return done, lats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="olmo-1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--min-prompt", type=int, default=4,
                    help="shortest prompt; prompts are drawn below "
                         "max_len // 2")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without a GPU)")
    ap.add_argument("--ctl-state-dir", default=None,
                    help="not ported yet: submit this deployment as a "
                         "control-plane job instead of serving locally")
    args = ap.parse_args(argv)
    if args.ctl_state_dir is not None:
        raise SystemExit("--ctl-state-dir: the control plane is not ported "
                         "yet (ROADMAP A12); use repro.launch.serve to "
                         "submit a job")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder:
        raise SystemExit("SlotServer serves decoder-only configs; serve "
                         f"{cfg.name} through repro_torch.models.registry."
                         "serve_prefill / serve_decode")
    serve(cfg, n_requests=args.requests, max_slots=args.max_slots,
          max_len=args.max_len, max_new=args.max_new, seed=args.seed,
          device=args.device, min_prompt=args.min_prompt)


if __name__ == "__main__":
    main()
