"""Learning-rate schedules: functions of the step counter, computed in f32
tensors as the reference computes them in jnp (not in Python doubles)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.int32)


def linear_warmup(step, base_lr: float, warmup_steps: int) -> torch.Tensor:
    step = _step(step)
    return base_lr * torch.clamp((step + 1) / max(1, warmup_steps), max=1.0)


def cosine_schedule(step, base_lr: float, total_steps: int,
                    warmup_steps: int = 0,
                    min_ratio: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = linear_warmup(step, base_lr, warmup_steps)
    frac = torch.clamp((step - warmup_steps)
                       / max(1, total_steps - warmup_steps), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup_steps, warm, base_lr * cos)
