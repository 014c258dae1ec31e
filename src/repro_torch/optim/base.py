"""Minimal functional optimizer API (counterpart of ``repro.optim.base``).

An ``Optimizer`` is a pair of functions:

  init(params)                          -> opt_state
  update(grads, opt_state, params, lr)  -> (updates, opt_state)

``updates`` are additive deltas: new_params = params + updates. ``lr`` is
a 0-dim f32 tensor from a schedule (``optim.schedules``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.common.pytree import tree_map

PyTree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[PyTree], PyTree]
    update: Callable[..., tuple[PyTree, PyTree]]
    name: str = "optimizer"


def apply_updates(params: PyTree, updates: PyTree) -> PyTree:
    """``(p + u).astype(p.dtype)``: a bf16 parameter plus an f32 update is
    added in f32 and rounded once, as in the reference."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
