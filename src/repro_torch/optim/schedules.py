"""LR schedules (port of ``repro/optim/schedules.py``), including the paper's
recipes (§4):

- Inception-V3: initial LR scaled linearly with global batch (Goyal et al.).
- GNMT: exponential warmup for 200 steps; decay x0.5 every 500 steps starting
  at step 6000, four decays total.
- plus warmup-cosine for the modern archs.

Each schedule maps a step (int or tensor) to a 0-d float32 tensor on the
CPU, computed in f32 as the JAX schedules are.
"""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step, dtype=torch.float32, device="cpu")


def constant_lr(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def linear_scaled_lr(base_lr: float, base_batch: int, global_batch: int,
                     warmup_steps: int = 500):
    """Goyal et al. linear scaling rule with gradual warmup."""
    peak = base_lr * global_batch / base_batch

    def sched(step):
        s = _f32(step)
        warm = peak * (s + 1) / max(warmup_steps, 1)
        return torch.clamp(warm, max=peak)

    return sched


def exp_warmup_step_decay(peak_lr: float, warmup_steps: int = 200,
                          decay_start: int = 6000, decay_interval: int = 500,
                          decay_factor: float = 0.5, n_decays: int = 4):
    """The paper's GNMT schedule."""

    def sched(step):
        s = _f32(step)
        warm = peak_lr * torch.exp((torch.clamp(s, max=warmup_steps) / warmup_steps - 1.0)
                                   * 4.0)
        n_dec = torch.clamp(torch.floor((s - decay_start) / decay_interval) + 1,
                            0, n_decays)
        return torch.where(s < warmup_steps, warm, peak_lr * decay_factor ** n_dec)

    return sched


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def sched(step):
        s = _f32(step)
        warm = peak_lr * (s + 1) / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                           0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, peak_lr * cos)

    return sched


def cosine_decay(peak_lr: float, total_steps: int, final_frac: float = 0.0):
    return warmup_cosine(peak_lr, 0, total_steps, final_frac)
