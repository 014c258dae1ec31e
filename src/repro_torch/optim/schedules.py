"""Learning-rate schedules (counterpart of ``repro.optim.schedules``):
callables ``step -> lr`` giving a 0-dim f32 tensor, computed in f32 as
the reference computes them under ``jit``."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, final_lr: float = 0.0):
    def sched(step):
        frac = torch.clamp(_f32(step) / _f32(max(total_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return final_lr + (base_lr - final_lr) * cos
    return sched


def step_decay_schedule(base_lr: float, decay_every: int, gamma: float = 0.1):
    def sched(step):
        k = torch.floor(_f32(step) / _f32(max(decay_every, 1)))
        return base_lr * torch.pow(_f32(gamma), k)
    return sched
