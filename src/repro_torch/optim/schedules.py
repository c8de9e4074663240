"""LR schedules: linear warmup + {cosine, WSD}, in float32 on tensors.

Counterpart of ``repro.optim.schedules``, with the reference's expressions
in the reference's order.  WSD (warmup-stable-decay) is the MiniCPM
schedule: warmup to peak, hold stable, then a short exponential decay tail.
``step`` is a tensor (any device) or a number.
"""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr, warmup_steps, total_steps,
                  min_ratio=0.1) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps)
                       / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)


def wsd(step, *, peak_lr, warmup_steps, stable_steps, decay_steps,
        min_ratio=0.1) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    decay_start = warmup_steps + stable_steps
    prog = torch.clamp((step - decay_start) / max(decay_steps, 1), 0.0, 1.0)
    decay = peak_lr * (min_ratio ** prog)        # exponential decay tail
    out = torch.where(step < warmup_steps, warm,
                      torch.full_like(step, peak_lr))
    return torch.where(step >= decay_start, decay, out)
