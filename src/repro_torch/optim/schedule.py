"""LR schedules: linear warmup + cosine decay (``repro.optim.schedule``),
in float32."""

import math

import torch

__all__ = ["warmup_cosine"]


def warmup_cosine(step, *, peak=3e-4, warmup=100, total=1000, floor=0.1) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak * step / max(warmup, 1)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup, warm, cos)
