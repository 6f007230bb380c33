"""Learning-rate schedules (warmup + cosine / constant), ported from
``repro.optim.schedule``: functions of a 0-d step tensor, in f32."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    step = _f32(step)
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = ((step - warmup_steps)
            / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1.0 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, warmup_steps: int = 0, **_
             ) -> torch.Tensor:
    step = _f32(step)
    if not warmup_steps:
        return torch.full_like(step, peak_lr)
    warm = peak_lr * step / max(warmup_steps, 1)
    return torch.where(step < warmup_steps, warm,
                       torch.full_like(step, peak_lr))


SCHEDULES = {"warmup_cosine": warmup_cosine, "constant": constant}
