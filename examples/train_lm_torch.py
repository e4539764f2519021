"""End-to-end script: train an LM with the full production substrate —
checkpointed state, async checkpointing with restart, fault-tolerance
coordinator — on the PyTorch/CUDA port.  The port of
``examples/train_lm.py``.

Default is a ~20M-param config (olmo-1b's family at 6 layers, d_model 384,
6 heads of 64, vocab 8192, bf16, 60 steps); ``--hundred-m`` gives the
~100M/200-step configuration.  Runs on the GPU unless ``--device cpu`` is
given.  Checkpoints go to ``--ckpt-dir`` (default
``/tmp/repro_torch_train_lm_ckpt``, never the reference's directory);
``--resume`` restarts from the latest one there.

Run:  PYTHONPATH=src python examples/train_lm_torch.py [--steps 60] [--hundred-m]
      PYTHONPATH=src python examples/train_lm_torch.py --device cpu --steps 3
"""
import argparse
import dataclasses
import os
import shutil
import time

from repro_torch.configs.registry import get_config
from repro_torch.distributed.coordinator import Coordinator, CoordinatorConfig
from repro_torch.launch.train import train
from repro_torch.models.common import resolve_device
from repro_torch.train.step import TrainConfig

CKPT = "/tmp/repro_torch_train_lm_ckpt"


def config(hundred_m: bool = False):
    if hundred_m:
        # ~100M params: olmo-1b family at width 768 / 12 layers
        return dataclasses.replace(
            get_config("olmo-1b"), n_layers=12, d_model=768, n_heads=12,
            n_kv_heads=12, d_ff=3072, vocab_size=32768)
    return dataclasses.replace(
        get_config("olmo-1b"), n_layers=6, d_model=384, n_heads=6,
        n_kv_heads=6, d_ff=1536, vocab_size=8192)


def run(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: str,
        resume: bool = False, device=None, params=None) -> dict:
    """Train ``cfg`` for ``steps`` steps with checkpoints every 20 under
    ``ckpt_dir`` (emptied first unless ``resume``) and the coordinator
    watching; returns the losses of the steps this run took, its wall
    seconds, the tokens it trained on and the coordinator."""
    if not resume and os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    coord = Coordinator(1, CoordinatorConfig())
    tc = TrainConfig(remat="none", n_micro=1, lr=3e-4, total_steps=steps,
                     warmup_steps=max(1, steps // 20))
    t0 = time.time()
    state, losses = train(cfg, steps=steps, batch=batch, seq=seq, tc=tc,
                          ckpt_dir=ckpt_dir, ckpt_every=20, log_every=10,
                          coordinator=coord, device=device, params=params)
    return {"state": state, "losses": losses, "seconds": time.time() - t0,
            "tokens": len(losses) * batch * seq, "coordinator": coord}


def main(argv=None, params=None):
    """The command line; ``params`` (converted from the reference's init,
    say) replaces the seeded init of a fresh run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--hundred-m", action="store_true",
                    help="~100M params / 200 steps")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-dir", default=CKPT)
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without a GPU)")
    args = ap.parse_args(argv)

    cfg = config(args.hundred_m)
    if args.hundred_m:
        args.steps = max(args.steps, 200)
    n = cfg.param_count()
    print(f"model: olmo-family {n/1e6:.0f}M params")
    device = resolve_device(args.device)
    batch, seq = (8, 256) if args.hundred_m else (4, 128)
    out = run(cfg, steps=args.steps, batch=batch, seq=seq,
              ckpt_dir=args.ckpt_dir, resume=args.resume, device=device,
              params=params)
    losses, coord = out["losses"], out["coordinator"]
    if not losses:
        print(f"\nnothing to do: the checkpoint in {args.ckpt_dir} is at "
              f"step {args.steps} already (pass a larger --steps)")
        return out
    print(f"\ndone: {len(losses)} steps, loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}, {out['tokens'] / out['seconds']:.0f} tok/s "
          f"on {device}")
    print(f"checkpoints in {args.ckpt_dir} (rerun with --resume to restart "
          f"from the latest)")
    print(f"coordinator events: {coord.events or 'none (healthy run)'}")
    assert losses[-1] < losses[0], "loss must decrease"
    return out


if __name__ == "__main__":
    main()
