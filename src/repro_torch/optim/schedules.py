"""LR schedules: cosine and the WSD (warmup–stable–decay) schedule that
minicpm-2b trains with [arXiv:2404.06395].  Each maps the AdamW step (an
integer tensor) to a float32 multiplier of the learning rate, in the
JAX package's float32 arithmetic."""
from __future__ import annotations

import numpy as np
import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant():
    return lambda step: torch.tensor(1.0, dtype=torch.float32)


def cosine(total_steps: int, warmup: int = 100, floor: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total_steps - warmup, 1),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (
            1 + torch.cos(prog * np.pi))
        return warm * cos
    return f


def wsd(total_steps: int, warmup_frac: float = 0.01, decay_frac: float = 0.1,
        floor: float = 0.1):
    """Warmup-Stable-Decay [MiniCPM]: linear warmup, long flat stage, then a
    short steep (here linear-to-floor) decay tail."""
    warmup = max(int(total_steps * warmup_frac), 1)
    decay_start = int(total_steps * (1.0 - decay_frac))

    def f(step):
        s = _f32(step)
        warm = torch.clamp(s / warmup, max=1.0)
        decay = torch.clamp((s - decay_start) /
                            max(total_steps - decay_start, 1), 0.0, 1.0)
        return warm * (1.0 - (1.0 - floor) * decay)
    return f
