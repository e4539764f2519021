"""Training launcher: the synthetic data pipeline -> ``train/step.py``'s
train step -> checkpointing (async, keep-last-k) -> the fault-tolerance
coordinator (heartbeats, straggler log), on one device.

Runs on the GPU unless ``device="cpu"`` (``--device cpu``) is given; there
the attention layers' forward and backward are the flash-attention kernels.
With ``--ckpt-dir`` a run restores the latest committed step there and
resumes; as in the JAX package's launcher, the resumed run's data stream
starts again at batch 0 (ROADMAP §C).  A mesh of one rank is accepted (its
shardings are resolved and checked); execution over more ranks is ROADMAP
A10b.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --reduced --device cpu --steps 20 --batch 4 --seq 64
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --reduced --device cpu --steps 4 --ckpt-dir ckpt/olmo-reduced
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
        --steps 6 --batch 4 --seq 2048 --n-micro 2
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch

from repro_torch.checkpoint.sharded import (CheckpointManager, _flatten,
                                            latest_step)
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.distributed.coordinator import Coordinator, CoordinatorConfig
from repro_torch.launch import shardings as shlib
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


def state_template(cfg, tc: TrainConfig, seed: int = 0):
    """The train state's structure, shapes and dtypes on the ``meta``
    device: nothing is drawn or allocated."""
    return make_train_step(cfg, tc, device="meta")[0](seed=seed)


def check_mesh(cfg, mesh, template) -> None:
    """A mesh of one rank: every leaf of the state resolves to a sharding.
    A larger mesh is refused (execution over more ranks: ROADMAP A10b)."""
    if mesh.size != 1:
        raise NotImplementedError(
            f"{mesh}: training over a mesh of more than one rank is not "
            f"ported yet (ROADMAP A10b)")
    sh = _flatten(shlib.train_state_shardings(template, cfg, mesh))
    if set(sh) != set(_flatten(template)):
        raise ValueError(f"{mesh}: the shardings do not cover the state")


def train(cfg, *, steps: int = 50, batch: int = 8, seq: int = 128,
          tc: Optional[TrainConfig] = None, mesh=None, seed: int = 0,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          log_every: int = 10, coordinator: Optional[Coordinator] = None,
          device=None, params=None, frontend_batch=None,
          verbose: bool = True, on_step=None):
    """Train ``cfg`` on the synthetic corpus; returns (state, losses).
    ``params`` (converted from the reference, say) replaces the seeded
    init; a checkpoint under ``ckpt_dir`` replaces both.  ``on_step(step,
    metrics)`` is called after each step."""
    device = resolve_device(device)
    tc = tc or TrainConfig(total_steps=steps, warmup_steps=max(1, steps // 10))
    init_state, train_step = make_train_step(cfg, tc, device=device)
    template = (state_template(cfg, tc, seed)
                if ckpt_dir or mesh is not None else None)
    if mesh is not None:
        check_mesh(cfg, mesh, template)

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    state = None
    start_step = 0
    if mgr and latest_step(ckpt_dir) is not None:
        state = mgr.restore(template, device=device)
        start_step = int(state.opt.step)
        if verbose:
            print(f"[train] restored checkpoint at step {start_step}")
    if state is None:
        state = init_state(seed=seed, params=params)

    # a resumed run starts the stream again at batch 0, as the reference's
    # launcher does (ROADMAP §C)
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
    for step in range(start_step, steps):
        t0 = time.time()
        state, metrics = train_step(state, to_device(next(data), device))
        loss = float(metrics["loss"])
        losses.append(loss)
        if on_step is not None:
            on_step(step, metrics)
        if coordinator is not None:
            coordinator.report_step(0, time.time() - t0)
            coordinator.check()
        if mgr and (step + 1) % ckpt_every == 0:
            mgr.save(state, step + 1)
        if verbose and (step + 1) % log_every == 0:
            dt = (time.time() - t_start) / (step + 1 - start_step)
            print(f"[train] step {step + 1:5d} loss {loss:.4f} "
                  f"({dt * 1e3:.0f} ms/step on {device})")
    if mgr:
        mgr.save(state, steps)
        mgr.wait_all()
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
                    help="checkpoint here, and resume from its latest step")
    args = ap.parse_args(argv)
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
    coord = Coordinator(1, CoordinatorConfig())
    _, losses = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                      tc=tc, ckpt_dir=args.ckpt_dir, seed=args.seed,
                      coordinator=coord, device=args.device)
    if not losses:
        print(f"[train] nothing to do: the checkpoint is at step "
              f">= {args.steps}")
        return
    print(f"[train] done: first loss {losses[0]:.4f} -> last "
          f"{losses[-1]:.4f}")


if __name__ == "__main__":
    main()
