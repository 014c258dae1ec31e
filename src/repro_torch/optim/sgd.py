"""SGD with momentum / Nesterov / coupled weight decay (counterpart of
``repro.optim.sgd``; the paper's optimizer: momentum 0.9, weight decay
5e-4). The dtypes follow the reference: weight decay is added in the
gradient's dtype (``wd`` rounded to it first, as a weakly-typed JAX
scalar is), the momentum buffer is f32."""
from __future__ import annotations

import torch

from repro_torch.common.pytree import tree_map
from repro_torch.optim.base import Optimizer


def sgd(momentum: float = 0.0, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {}
        return {"mu": tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params)}

    def update(grads, state, params, lr):
        if weight_decay:
            grads = tree_map(
                lambda g, p: g + torch.tensor(weight_decay, dtype=g.dtype)
                * p.to(g.dtype), grads, params)
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        mu = tree_map(lambda m, g: momentum * m + g.float(), state["mu"],
                      grads)
        if nesterov:
            step_dir = tree_map(lambda m, g: momentum * m + g.float(), mu,
                                grads)
        else:
            step_dir = mu
        return tree_map(lambda d: -lr * d, step_dir), {"mu": mu}

    return Optimizer(init=init, update=update, name="sgd")
