"""LR schedules (multiplicative factors on the base LR), of a step tensor."""
from __future__ import annotations

import math

import torch


def _steps(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(warmup_steps: int, total_steps: int, min_frac: float = 0.1):
    def f(step):
        s = _steps(step)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, cos)
    return f


def warmup_linear(warmup_steps: int, total_steps: int, min_frac: float = 0.0):
    def f(step):
        s = _steps(step)
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0, 1)
        return torch.where(s < warmup_steps, warm, 1 - (1 - min_frac) * prog)
    return f


def constant():
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=torch.as_tensor(step).device)
