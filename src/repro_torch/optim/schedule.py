"""Learning-rate schedules as pure ``step -> lr`` functions (float32 0-d
tensors on the step's device)."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def warmup_cosine(peak_lr: float, *, warmup_steps: int, total_steps: int,
                  final_fraction: float = 0.1):
    def sched(step):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        progress = torch.clamp((step - warmup_steps)
                               / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_fraction + (1 - final_fraction) * 0.5 * (
            1.0 + torch.cos(math.pi * progress))
        return torch.where(step < warmup_steps, warm, peak_lr * cos)
    return sched


def inverse_sqrt(peak_lr: float, *, warmup_steps: int = 100):
    def sched(step):
        step = torch.clamp(step.to(torch.float32), min=1.0)
        return peak_lr * torch.minimum(
            step / max(warmup_steps, 1),
            torch.sqrt(warmup_steps / step))
    return sched
