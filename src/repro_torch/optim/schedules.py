"""Learning-rate schedules (counterpart of ``repro.optim.schedules``):
callables ``step -> lr`` giving a 0-dim f32 tensor, computed in f32 as
the reference computes them under ``jit``. The paper uses step decay
(its "Baseline"), cosine over the whole budget (its "CA" and the
schedule under HWA), and a constant or cyclic sampling LR (what SWA
needs in its Stage II)."""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant_schedule(lr: float):
    def sched(step):
        return _f32(lr)
    return sched


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


def warmup_cosine_schedule(base_lr: float, warmup_steps: int,
                           total_steps: int, final_lr: float = 0.0):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          final_lr)

    def sched(step):
        warm = base_lr * _f32(step) / _f32(max(warmup_steps, 1))
        return torch.where(_f32(step) < warmup_steps, warm,
                           cos(_f32(step) - warmup_steps))
    return sched


def cyclic_schedule(lr_max: float, lr_min: float, cycle_steps: int):
    """SWA's cyclical sampling LR: a linear saw from lr_max down to
    lr_min."""
    def sched(step):
        t = _f32(int(step) % cycle_steps) / _f32(max(cycle_steps - 1, 1))
        return lr_max - (lr_max - lr_min) * t
    return sched


def swa_constant_schedule(base_sched, swa_start_step: int, swa_lr: float):
    """The paper's offline-WA Stage I/II split: the regular schedule until
    ``swa_start_step``, then a constant sampling LR (Fig. 2)."""
    def sched(step):
        return torch.where(_f32(step) < swa_start_step, base_sched(step),
                           _f32(swa_lr))
    return sched
