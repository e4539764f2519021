"""Training launcher: the synthetic data pipeline -> ``train/step.py``'s
train step -> checkpointing (async, keep-last-k) -> the fault-tolerance
coordinator (heartbeats, straggler log), on one device.

Runs on the GPU unless ``device="cpu"`` (``--device cpu``) is given; there
the attention layers' forward and backward are the flash-attention kernels.
With ``--ckpt-dir`` a run restores the latest committed step there and
resumes; as in the JAX package's launcher, the resumed run's data stream
starts again at batch 0 (ROADMAP §C).

Over a mesh (``train(mesh=...)``, a ``launch.mesh.Mesh`` whose ranks an
initialized process group holds: NCCL on the card, gloo on the CPU, each
rank one process calling ``train`` alike) every leaf of the state is a
DTensor at ``launch/shardings.py``'s placements, the batches come from
``data/pipeline.sharded_batches`` and the step runs under ``use_mesh``;
a restore places each leaf on the current mesh, whatever mesh saved it.
Without a process group a mesh of one rank is only checked against the
state, and a larger one is refused.

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
import contextlib
import time
from typing import Optional

import torch

from repro_torch.checkpoint.sharded import (CheckpointManager, _flatten,
                                            _unflatten, latest_step)
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.data.pipeline import batch_placer, sharded_batches
from repro_torch.distributed.coordinator import Coordinator, CoordinatorConfig
from repro_torch.launch import shardings as shlib
from repro_torch.models.common import is_dtensor, resolve_device
from repro_torch.models.sharding import placements, use_mesh
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
    """Every leaf of the state resolves to a sharding on ``mesh``."""
    sh = _flatten(shlib.train_state_shardings(template, cfg, mesh))
    if set(sh) != set(_flatten(template)):
        raise ValueError(f"{mesh}: the shardings do not cover the state")


def over_ranks(mesh) -> bool:
    """Whether ``mesh`` executes: a process group is up to hold its ranks."""
    import torch.distributed as dist
    return (mesh is not None and dist.is_available()
            and dist.is_initialized())


def state_placements(cfg, mesh, template) -> dict:
    """{leaf key: DTensor placements} of the train state on ``mesh``."""
    return {k: placements(s.spec, mesh) for k, s in _flatten(
        shlib.train_state_shardings(template, cfg, mesh)).items()}


def place_state(state, cfg, mesh, template, device_type: str = "cuda"):
    """Every leaf of ``state`` as a DTensor over ``mesh`` at its placements;
    each rank keeps its part of the leaf it holds (no communication)."""
    from torch.distributed.tensor import distribute_tensor
    pl = state_placements(cfg, mesh, template)
    dm = mesh.device_mesh(device_type)
    return _unflatten(state, iter(
        distribute_tensor(v, dm, pl[k], src_data_rank=None)
        for k, v in _flatten(state).items()))


def _scalar(x) -> float:
    return float(x.full_tensor() if is_dtensor(x) else x)


def train(cfg, *, steps: int = 50, batch: int = 8, seq: int = 128,
          tc: Optional[TrainConfig] = None, mesh=None, seed: int = 0,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          log_every: int = 10, coordinator: Optional[Coordinator] = None,
          device=None, params=None, frontend_batch=None,
          verbose: bool = True, on_step=None):
    """Train ``cfg`` on the synthetic corpus; returns (state, losses).
    ``params`` (converted from the reference, say) replaces the seeded
    init; a checkpoint under ``ckpt_dir`` replaces both.  ``on_step(step,
    metrics)`` is called after each step.  Over a mesh (see the module's
    docstring) the state returned is DTensors."""
    device = resolve_device(device)
    tc = tc or TrainConfig(total_steps=steps, warmup_steps=max(1, steps // 10))
    init_state, train_step = make_train_step(cfg, tc, device=device)
    template = (state_template(cfg, tc, seed)
                if ckpt_dir or mesh is not None else None)
    if mesh is not None:
        check_mesh(cfg, mesh, template)
    ranks = over_ranks(mesh)
    if mesh is not None and mesh.size > 1 and not ranks:
        raise RuntimeError(f"{mesh}: no process group holds its ranks; "
                           f"init_process_group (one process a rank) first")

    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    state = None
    start_step = 0
    if mgr and latest_step(ckpt_dir) is not None:
        if ranks:
            pl = state_placements(cfg, mesh, template)
            state = mgr.restore(template, device=device, sharding_fn=pl.get,
                                device_mesh=mesh.device_mesh(device.type))
        else:
            state = mgr.restore(template, device=device)
        start_step = int(_scalar(state.opt.step))
        if verbose:
            print(f"[train] restored checkpoint at step {start_step}")
    if state is None:
        state = init_state(seed=seed, params=params)
        if ranks:
            state = place_state(state, cfg, mesh, template, device.type)

    # a resumed run starts the stream again at batch 0, as the reference's
    # launcher does (ROADMAP §C)
    if cfg.frontend == "none":
        data = sharded_batches(cfg, ShapeConfig("train", seq, batch, "train"),
                               mesh if ranks else None, seed=seed,
                               device=device)
    elif frontend_batch is None:
        raise ValueError(f"{cfg.name} takes a {cfg.frontend} frontend: pass "
                         f"frontend_batch, a function returning one batch")
    else:
        place = batch_placer(mesh if ranks else None, device)
        data = (place(to_device(b, "cpu")) for b in iter(frontend_batch, None))

    losses = []
    t_start = time.time()
    with contextlib.ExitStack() as ctx:
        if ranks:
            from torch.distributed.tensor.experimental import (
                implicit_replication)
            ctx.enter_context(use_mesh(mesh, device.type))
            ctx.enter_context(implicit_replication())
        for step in range(start_step, steps):
            t0 = time.time()
            state, metrics = train_step(state, next(data))
            loss = _scalar(metrics["loss"])
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
        if ranks:
            import torch.distributed as dist
            dist.barrier()           # the writer's commit before any read
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
