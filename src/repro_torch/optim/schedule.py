"""LR schedules (pure functions of the step counter).

The port of ``repro.optim.schedule``: the learning rate is computed in fp32
tensors on the step's device, in the reference's order of operations, so a
schedule and the update it scales round as the reference's do and never
wait for the host.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import TrainConfig


def warmup_cosine(cfg: TrainConfig):
    """Linear warmup -> cosine decay to 10% of peak."""
    peak, warm, total = cfg.learning_rate, cfg.warmup_steps, cfg.total_steps

    def lr(step) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm_lr = peak * step / max(warm, 1)
        frac = torch.clamp((step - warm) / max(total - warm, 1), 0.0, 1.0)
        cos_lr = 0.1 * peak + 0.9 * peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warm, warm_lr, cos_lr)

    return lr
