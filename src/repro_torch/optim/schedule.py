"""Learning-rate schedules (pure functions of the step counter; the port of
``repro.optim.schedule``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, peak_lr, warmup_steps, total_steps, floor=0.1):
    """Linear warm-up to ``peak_lr``, then a cosine down to ``floor·peak_lr``.

    ``step`` is a Python number or a tensor; the result is an f32 tensor (on
    the step's device), computed in f32 as the JAX function computes it, with
    no host synchronisation. Callers that need a float call ``float(...)``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup_steps, warm, cos)
