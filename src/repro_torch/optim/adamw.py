"""AdamW with f32 moments and decoupled weight decay (counterpart of
``repro.optim.adamw``)."""
from __future__ import annotations

import torch

from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.optim.base import Optimizer


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        dev = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "count": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        count = state["count"] + 1
        c = count.float()
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.float(),
                     state["m"], grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.float()),
                     state["v"], grads)
        mhat_scale = 1.0 / (1.0 - torch.pow(b1, c))
        vhat_scale = 1.0 / (1.0 - torch.pow(b2, c))

        def upd(m_, v_, p):
            step = m_ * mhat_scale / (torch.sqrt(v_ * vhat_scale) + eps)
            if weight_decay:
                step = step + weight_decay * p.float()
            return -lr * step

        return tree_map(upd, m, v, params), {"m": m, "v": v, "count": count}

    return Optimizer(init=init, update=update, name="adamw")
