"""The paper's comparison methods (counterpart of
``repro.core.baselines``; Table II/III/V-VIII baselines).

- SWA  [15]  — offline WA: running average of checkpoints sampled every H
  steps after ``swa_start``, with a constant sampling LR
  (``optim.schedules.swa_constant_schedule``).
- EMA        — exponential moving average of the weights.
- Lookahead [32] — slow/fast weights: slow += α(fast − slow) every k
  steps, fast ← slow.
- SAM  [35]  — sharpness-aware minimization: the gradient at the
  adversarially perturbed point W + ρ g/‖g‖.

Averages and slow weights are kept in f32 and cast back to the
parameters' dtype. Each state is a registered tree node with the
reference's data and meta fields, so it checkpoints under the
reference's key paths. The updates are the reference's expressions as
written, each operation rounded; under ``jit`` XLA's CPU build contracts
EMA's ``x + t·(y − x)`` into one FMA (ROADMAP.md Queue C).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.pytree import (register_dataclass, tree_flatten,
                                       tree_lerp, tree_map, tree_unflatten)

PyTree = Any


def _f32(tree: PyTree) -> PyTree:
    return tree_map(lambda x: x.detach().to(torch.float32), tree)


# ------------------------------------------------------------------ SWA


@dataclasses.dataclass
class SWAState:
    avg: PyTree
    n: torch.Tensor            # 0-dim int32: models averaged


register_dataclass(SWAState, data_fields=["avg", "n"])


def swa_init(params: PyTree) -> SWAState:
    dev = tree_flatten(params)[0][0].device
    return SWAState(avg=_f32(params),
                    n=torch.zeros((), dtype=torch.int32, device=dev))


def swa_update(state: SWAState, params: PyTree) -> SWAState:
    """avg <- avg + (params - avg) / (n + 1)."""
    n1 = state.n.to(torch.float32) + 1.0
    avg = tree_map(lambda a, p: a + (p.detach().to(torch.float32) - a) / n1,
                   state.avg, params)
    return SWAState(avg=avg, n=state.n + 1)


def swa_params(state: SWAState, like: PyTree) -> PyTree:
    return tree_map(lambda a, x: a.to(x.dtype), state.avg, like)


# ------------------------------------------------------------------ EMA


@dataclasses.dataclass
class EMAState:
    avg: PyTree
    decay: float


register_dataclass(EMAState, data_fields=["avg"], meta_fields=["decay"])


def ema_init(params: PyTree, decay: float = 0.999) -> EMAState:
    return EMAState(avg=_f32(params), decay=decay)


def ema_update(state: EMAState, params: PyTree) -> EMAState:
    return EMAState(avg=tree_lerp(state.avg, _f32(params),
                                  1.0 - state.decay),
                    decay=state.decay)


# ------------------------------------------------------------- Lookahead


@dataclasses.dataclass
class LookaheadState:
    slow: PyTree
    k: int
    alpha: float


register_dataclass(LookaheadState, data_fields=["slow"],
                   meta_fields=["k", "alpha"])


def lookahead_init(params: PyTree, k: int = 5, alpha: float = 0.5
                   ) -> LookaheadState:
    return LookaheadState(slow=_f32(params), k=k, alpha=alpha)


def lookahead_update(state: LookaheadState, fast: PyTree
                     ) -> tuple[LookaheadState, PyTree]:
    """Call every k fast steps: slow += α(fast − slow); fast ← slow."""
    slow = tree_lerp(state.slow, _f32(fast), state.alpha)
    new_fast = tree_map(lambda s, f: s.to(f.dtype), slow, fast)
    return LookaheadState(slow=slow, k=state.k, alpha=state.alpha), new_fast


# ------------------------------------------------------------------ SAM


def value_and_grad(loss_fn: Callable, params: PyTree, batch):
    """((loss, metrics), grads) of ``loss_fn`` at ``params``: the leaves
    are differentiated as detached copies, so ``params`` is not touched
    and no graph outlives the call."""
    leaves, treedef = tree_flatten(params)
    live = [x.detach().requires_grad_(True) for x in leaves]
    loss, metrics = loss_fn(tree_unflatten(treedef, live), batch)
    # a leaf the loss does not use (BN running state carried in
    # the averaged tree) gets a zero gradient, as in JAX
    grads = torch.autograd.grad(loss, live, allow_unused=True,
                                materialize_grads=True)
    return (loss.detach(), metrics), tree_unflatten(treedef, list(grads))


def sam_gradient(loss_fn: Callable, params: PyTree, batch,
                 rho: float = 0.05):
    """Two-pass SAM gradient: ∇L(W + ρ ∇L(W)/‖∇L(W)‖). Returns the first
    pass's (loss, metrics) and the second pass's gradient. The norm is
    taken in f32 over all leaves; the perturbed parameters are cast back
    to the parameters' dtype."""
    (loss, metrics), g = value_and_grad(loss_fn, params, batch)
    with torch.no_grad():
        sq = [torch.sum(torch.square(x.to(torch.float32)))
              for x in tree_flatten(g)[0]]
        gnorm = torch.sqrt(sum(sq[1:], sq[0]))
        scale = rho / torch.clamp(gnorm, min=1e-12)
        perturbed = tree_map(
            lambda p, gl: (p.detach().to(torch.float32)
                           + scale * gl.to(torch.float32)).to(p.dtype),
            params, g)
    del g
    _, g_sam = value_and_grad(loss_fn, perturbed, batch)
    return (loss, metrics), g_sam
