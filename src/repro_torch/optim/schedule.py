"""Learning-rate schedule (linear warmup, then cosine decay to a floor).
Counterpart of ``repro/optim/schedule.py``: the same float32 arithmetic on
the step, so the two agree to a float32 ulp."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup: int = 100,
                  total: int = 10_000, floor: float = 0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a tensor), a float32
    scalar tensor on the step's device (the CPU for an int). Step 0 gets
    ``peak_lr / warmup``; from ``warmup`` on the rate falls along a half
    cosine to ``floor * peak_lr`` at ``total``."""
    dev = step.device if isinstance(step, torch.Tensor) else None
    step = torch.as_tensor(step, device=dev).to(torch.float32) + 1.0
    warm = peak_lr * torch.clamp(step / max(warmup, 1), max=1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)
