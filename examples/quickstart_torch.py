"""Quickstart: the three layers of LithOS on the PyTorch/CUDA port.

1. Train olmo-1b on the synthetic pipeline (execution plane): on the card
   at its published widths (head_dim 128; the attention kernels take 64,
   128 and 256), or with ``--reduced`` the reference's reduced config
   (head_dim 16), which the CPU runs.
2. Serve it with continuous batching (serving substrate).
3. Stack an inference service with a best-effort trainer under LithOS vs
   MPS and compare tail latencies (the paper's control plane), on the
   simulator's ``h100_like`` profile (``--profile a100``: the reference's,
   where these lines equal the reference quickstart's).

The port of ``examples/quickstart.py``.  Like the port's entry points it
runs on the GPU unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python examples/quickstart_torch.py
      PYTHONPATH=src python examples/quickstart_torch.py --reduced \\
          --device cpu --profile a100
"""
import argparse
import time

import numpy as np

from repro_torch.configs.registry import get_config
from repro_torch.core.lithos import evaluate
from repro_torch.core.types import DeviceSpec, Priority
from repro_torch.core.workloads import AppSpec
from repro_torch.launch.train import train
from repro_torch.serve.engine import ServeConfig, SlotServer
from repro_torch.train.step import TrainConfig

PROFILES = {"h100": DeviceSpec.h100_like, "a100": DeviceSpec.a100_like}


def stack_lines(profile: str) -> list[str]:
    """Part 3: the inference service beside the trainer under LithOS and
    MPS on the simulator, one line each."""
    dev = PROFILES[profile]()
    apps = [
        AppSpec("inference", get_config("olmo-1b"), "fwd_infer",
                priority=Priority.HIGH, rps=20.0, batch=8,
                prompt_mix=((128, 1.0),), fusion=8),
        AppSpec("training", get_config("olmo-1b"), "train",
                priority=Priority.BEST_EFFORT, train_batch=8,
                train_seq=1024, fusion=8),
    ]
    lines = []
    for system in ("lithos", "mps"):
        res = evaluate(system, dev, apps, horizon=5.0, seed=0)
        inf, tr = res.client("inference"), res.client("training")
        lines.append(f"  {system:8s}  inference p99 = {inf.p99*1e3:7.1f} ms"
                     f"   training steps = {tr.n_completed}   util = "
                     f"{res.utilization:.2f}")
    return lines


def run(cfg, *, device=None, params=None, profile: str = "h100",
        verbose: bool = True) -> dict:
    """The quickstart's three parts on ``cfg``; ``params`` (converted from
    the reference, say) replaces the seeded init.  Returns the losses, the
    served requests' tokens, the simulation's lines and each part's wall
    seconds."""
    say = print if verbose else (lambda *a, **k: None)
    size = "reduced" if cfg.d_model < 512 else "full-width"
    # -- 1. train ------------------------------------------------------------
    say(f"== training {size} {cfg.name} on the synthetic corpus ==")
    t0 = time.time()
    state, losses = train(cfg, steps=20, batch=8, seq=64,
                          tc=TrainConfig(total_steps=20, warmup_steps=2),
                          log_every=5, device=device, params=params,
                          verbose=verbose)
    t_train = time.time() - t0
    say(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}\n")

    # -- 2. serve ------------------------------------------------------------
    say("== serving it with continuous batching ==")
    t0 = time.time()
    srv = SlotServer(cfg, params=state.params,
                     serve_cfg=ServeConfig(max_slots=3, max_len=64,
                                           max_new_tokens=8), device=device)
    rng = np.random.default_rng(0)
    for _ in range(6):
        srv.submit(rng.integers(2, cfg.vocab_size, 12).astype(np.int32))
    done = srv.run_until_drained()
    t_serve = time.time() - t0
    say(f"served {len(done)} requests; sample output tokens: "
        f"{done[0].output}\n")

    # -- 3. LithOS multi-tenancy ----------------------------------------------
    say(f"== stacking inference + training: LithOS vs MPS ({profile}) ==")
    t0 = time.time()
    lines = stack_lines(profile)
    t_sim = time.time() - t0
    for line in lines:
        say(line)
    say("\nLithOS keeps inference tails flat while the trainer consumes "
        "idle capacity — the paper's core result.")
    return {"losses": losses, "outputs": [list(r.output) for r in done],
            "sim": lines, "seconds": {"train": t_train, "serve": t_serve,
                                      "sim": t_sim}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduced", action="store_true",
                    help="the reference's reduced olmo-1b (for the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device; default: cuda (fails without a GPU)")
    ap.add_argument("--profile", choices=sorted(PROFILES), default="h100")
    args = ap.parse_args(argv)
    cfg = get_config("olmo-1b")
    return run(cfg.reduced() if args.reduced else cfg, device=args.device,
               profile=args.profile)


if __name__ == "__main__":
    main()
