"""LR schedules: linear warmup + cosine decay (the LM-pretraining default).

The port of ``repro.training.schedule``. Each schedule maps a step (an int
or a tensor, whose device the result keeps) to a 0-d float32 tensor,
computed in float32 tensors as the reference computes in ``jnp`` float32,
so every step's lr matches the reference's to one ulp. The one exception
to float32 is ``cos``: taken in float64 and rounded, it is the correctly
rounded float32 cosine, as XLA's is where torch's float32 ``cos`` can be an
ulp off (and ``1 + cos`` near 0 makes that three ulps of the lr).
"""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_fraction: float = 0.1):
    """Returns step -> lr."""

    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        progress = torch.clamp(progress, 0.0, 1.0)
        cos = peak_lr * (
            final_fraction
            + (1 - final_fraction) * 0.5 * (1 + torch.cos((math.pi * progress).double()).float())
        )
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def constant(lr_value: float):
    def lr(step):
        return torch.full((), lr_value, dtype=torch.float32, device=_step(step).device)

    return lr
