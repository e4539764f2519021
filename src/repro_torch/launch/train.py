"""Training launcher: the synthetic data pipeline -> ``train/step.py``'s
train step, on one device.

Runs on the GPU unless ``device="cpu"`` (``--device cpu``) is given; there
the attention layers' forward and backward are the flash-attention kernels.
Checkpointing (``--ckpt-dir``) and the fault-tolerance coordinator wait for
ROADMAP A9, meshes for A10.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --reduced --device cpu --steps 20 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 6 --batch 4 --seq 2048 --n-micro 2
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models.common import resolve_device
from repro_torch.train.step import TrainConfig, make_train_step


def to_device(batch: dict, device) -> dict:
    """numpy batch -> tensors: integer arrays as int64 (ids and labels),
    float arrays in their dtype."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = (t.to(torch.int64) if not t.is_floating_point() else t
                  ).to(device)
    return out


def train(cfg, *, steps: int = 50, batch: int = 8, seq: int = 128,
          tc: Optional[TrainConfig] = None, seed: int = 0, device=None,
          params=None, log_every: int = 10, frontend_batch=None,
          verbose: bool = True, on_step=None):
    """Train ``cfg`` on the synthetic corpus; returns (state, losses).
    ``params`` (converted from the reference, say) replaces the seeded
    init; ``on_step(step, metrics)`` is called after each step."""
    device = resolve_device(device)
    tc = tc or TrainConfig(total_steps=steps, warmup_steps=max(1, steps // 10))
    init_state, train_step = make_train_step(cfg, tc, device=device)
    state = init_state(seed=seed, params=params)
    if cfg.frontend == "none":
        data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                      global_batch=batch, seed=seed)).batches()
    elif frontend_batch is None:
        raise ValueError(f"{cfg.name} takes a {cfg.frontend} frontend: pass "
                         f"frontend_batch, a function returning one batch")
    else:
        data = iter(frontend_batch, None)

    losses = []
    t_start = time.time()
    for step in range(steps):
        state, metrics = train_step(state, to_device(next(data), device))
        loss = float(metrics["loss"])
        losses.append(loss)
        if on_step is not None:
            on_step(step, metrics)
        if verbose and (step + 1) % log_every == 0:
            dt = (time.time() - t_start) / (step + 1)
            print(f"[train] step {step + 1:5d} loss {loss:.4f} "
                  f"({dt * 1e3:.0f} ms/step on {device})")
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="olmo-1b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced (CPU-sized) config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--remat", default="none", choices=("none", "full",
                                                         "dots"))
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without a GPU)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="not ported yet: checkpoint to this directory")
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None:
        raise SystemExit("--ckpt-dir: checkpointing is not ported yet "
                         "(ROADMAP A9); use repro.launch.train to train "
                         "with checkpoints")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.frontend != "none":
        raise SystemExit(f"{cfg.name} takes a {cfg.frontend} frontend; "
                         f"train it through repro_torch.launch.train.train "
                         f"with a frontend_batch")
    tc = TrainConfig(remat=args.remat, n_micro=args.n_micro,
                     grad_compress=args.grad_compress,
                     moment_dtype=cfg.moment_dtype, total_steps=args.steps,
                     warmup_steps=max(1, args.steps // 10))
    _, losses = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      tc=tc, seed=args.seed, device=args.device)
    print(f"[train] done: first loss {losses[0]:.4f} -> last "
          f"{losses[-1]:.4f}")


if __name__ == "__main__":
    main()
