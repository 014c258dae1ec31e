"""Plain reference of HWA training (the paper's Algorithms 1 and 2) with
SGD, in float32, for the first steps of a run.

K replicas start from the same weights. Every step each replica takes
the gradient of the loss on its own rows, adds weight decay (g + wd * p)
into its f32 momentum (mu = m * mu + g), and moves by -lr * mu, the
learning rate on the cosine schedule; the weight is then stored in the
dtype the configuration states (bf16 here), as the configuration's
optimizer does. Every H steps the replicas' mean W̄ (in f32) replaces
every replica, is pushed into the slide window of I slots, and W̿ is the
window's mean, stored as the weights are. It imports no module of the program.
"""
from __future__ import annotations

import math

import torch


def cosine_lr(base_lr: float, total: int, step: int) -> float:
    frac = min(max(step / max(total, 1), 0.0), 1.0)
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * frac))


def follow(loss_fn, params0, batches, recipe: dict, n_steps: int,
           on_step=None, keep_at=None):
    """Run ``n_steps`` of HWA from ``params0`` (a flat list of the
    weights as stored) on ``batches`` (a function step -> [(inputs,
    targets)] per replica) with ``recipe`` (K, H, I, lr, total_steps,
    momentum, weight_decay). ``loss_fn(params_f32, inputs, targets)``.
    ``on_step(step, k, loss, grads)`` sees each replica's loss and its
    gradients as the optimizer takes them (weight decay added).

    Returns (replicas as stored after ``keep_at`` steps, by default all
    of them, W̿ as stored after ``n_steps``, or None before the first
    sync)."""
    K, H, I = recipe["K"], recipe["H"], recipe["I"]
    m, wd = recipe["momentum"], recipe["weight_decay"]
    stored = [[p.clone() for p in params0] for _ in range(K)]
    mom = [[torch.zeros_like(p, dtype=torch.float32) for p in params0]
           for _ in range(K)]
    ring, wa, kept = [], None, None
    for step in range(n_steps):
        lr = cosine_lr(recipe["lr"], recipe["total_steps"], step)
        rows = batches(step)
        for k in range(K):
            live = [p.float().requires_grad_(True) for p in stored[k]]
            loss = loss_fn(live, *rows[k])
            grads = torch.autograd.grad(loss, live)
            with torch.no_grad():
                grads = [g + wd * p for p, g in zip(live, grads)]
                if on_step is not None:
                    on_step(step, k, loss.detach(), grads)
                for i, (p, g) in enumerate(zip(live, grads)):
                    mom[k][i] = m * mom[k][i] + g
                    stored[k][i] = (p - lr * mom[k][i]).to(stored[k][i].dtype)
            del live, grads, loss
        if (step + 1) % H == 0:
            with torch.no_grad():
                wbar = [torch.stack([stored[k][i].float() for k in range(K)]
                                    ).mean(0) for i in range(len(params0))]
                for k in range(K):
                    stored[k] = [w.to(p.dtype) for w, p in zip(wbar,
                                                               stored[k])]
                ring = (ring + [wbar])[-I:]
                wa = [torch.stack([r[i] for r in ring]).mean(0)
                      .to(params0[i].dtype) for i in range(len(params0))]
        if step + 1 == keep_at:
            kept = [[p.detach() for p in replica] for replica in stored]
    return (stored if kept is None else kept), wa
