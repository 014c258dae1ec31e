"""Training orchestration (counterpart of ``repro.train.trainer``).

Methods ported so far (paper §V):
  base      — SGD, step-decay LR ×0.1 every ``decay_every`` (paper Baseline)
  ca        — SGD, cosine LR over the whole budget
  online    — low-frequency online WA only (HWA with I=1)
  pmsgd     — parallel mini-batch SGD (sync every step, K replicas)
  hwa       — the full method (K replicas, period H, window I)

``swa``, ``ema``, ``lookahead`` and ``sam`` raise until
``core/baselines.py`` is ported (ROADMAP.md Queue A 7), and a
``checkpoint_dir`` raises until checkpointing is (Queue A 8).

The trainer evaluates W̿ for the K-replica methods and the live weights
otherwise, and tracks the best snapshot. It takes any pipeline with
``stacked_batch(step)``, ``replica_batch(r, step)``, ``steps_per_epoch``
and ``eval_batches()``, so a test can hand it the reference's batches.
Where the reference jit-compiles a step, the port runs eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.pytree import tree_flatten, tree_unflatten
from repro_torch.core.hwa import HWAConfig, hwa_init, hwa_inner_step, \
    hwa_sync
from repro_torch.optim import (adamw, apply_updates, cosine_schedule, sgd,
                               step_decay_schedule)

PyTree = Any

#: the ROADMAP items of what this module leaves to raise
BASELINES_ITEM = "ROADMAP.md Queue A 7 (core/baselines.py)"
CHECKPOINT_ITEM = "ROADMAP.md Queue A 8 (checkpoint interop)"
PARALLEL = ("hwa", "online", "pmsgd")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    method: str = "hwa"
    total_steps: int = 1000
    batch_size: int = 16
    base_lr: float = 0.1
    optimizer: str = "sgd"          # sgd | adamw
    momentum: float = 0.9
    weight_decay: float = 5e-4
    decay_every_frac: float = 0.33  # step-decay interval (method=base)
    hwa: HWAConfig = HWAConfig()
    eval_every: int = 0             # 0 → every sync cycle
    seed: int = 0
    checkpoint_dir: str = ""        # not ported: must stay ""


@dataclasses.dataclass
class Task:
    init: Callable[[], PyTree]
    loss_fn: Callable[[PyTree, Any], tuple[torch.Tensor, dict]]
    pipeline: Any
    name: str = "task"


def lm_task(lm, pipeline, name: str | None = None, device=None,
            seed: int = 0) -> Task:
    """The LM's loss over the pipeline's (tokens, targets) batches; the
    initial parameters are drawn on ``device`` from ``seed``."""
    def init():
        dev = pipeline.dataset.train_inputs.device if device is None \
            else torch.device(device)
        return lm.init(torch.Generator(device=dev).manual_seed(seed),
                       device=dev)

    def loss_fn(params, batch):
        if isinstance(batch, tuple):
            batch = {"tokens": batch[0], "targets": batch[1]}
        return lm.loss(params, batch)
    return Task(init=init, loss_fn=loss_fn, pipeline=pipeline,
                name=name or lm.cfg.name)


def _make_optimizer(tc: TrainConfig):
    if tc.optimizer == "adamw":
        return adamw(weight_decay=tc.weight_decay)
    return sgd(momentum=tc.momentum, weight_decay=tc.weight_decay)


def _make_schedule(tc: TrainConfig):
    if tc.method == "base":
        return step_decay_schedule(
            tc.base_lr, max(int(tc.total_steps * tc.decay_every_frac), 1))
    return cosine_schedule(tc.base_lr, tc.total_steps)


class Trainer:
    def __init__(self, task: Task, tc: TrainConfig):
        if tc.method in ("swa", "ema", "lookahead", "sam"):
            raise NotImplementedError(f"method {tc.method!r} is not ported "
                                      f"yet: {BASELINES_ITEM}")
        if tc.method not in PARALLEL + ("base", "ca"):
            raise ValueError(f"unknown method {tc.method!r}")
        if tc.checkpoint_dir:
            raise NotImplementedError(f"checkpointing is not ported yet: "
                                      f"{CHECKPOINT_ITEM}")
        self.task = task
        self.tc = tc
        self.optimizer = _make_optimizer(tc)
        self.schedule = _make_schedule(tc)
        self.is_parallel = tc.method in PARALLEL
        if tc.method == "online":
            self.hwa_cfg = dataclasses.replace(tc.hwa, window=1)
        elif tc.method == "pmsgd":
            self.hwa_cfg = dataclasses.replace(tc.hwa, sync_period=1,
                                               window=1)
        else:
            self.hwa_cfg = tc.hwa
        self.sync_period = self.hwa_cfg.sync_period or \
            task.pipeline.steps_per_epoch
        if tc.method == "pmsgd":
            self.sync_period = 1

    # ------------------------------------------------------------ steps

    def _hwa_step(self, state, step):
        batches = self.task.pipeline.stacked_batch(step)
        return hwa_inner_step(self.hwa_cfg, state, batches,
                              self.task.loss_fn, self.optimizer,
                              self.schedule(step))

    def _sync_step(self, state):
        return hwa_sync(self.hwa_cfg, state)

    def _single_step(self, params, opt_state, step):
        batch = self.task.pipeline.replica_batch(0, step)
        leaves, treedef = tree_flatten(params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        loss, metrics = self.task.loss_fn(tree_unflatten(treedef, live),
                                          batch)
        grads = torch.autograd.grad(loss, live)
        with torch.no_grad():
            plain = tree_unflatten(treedef, [x.detach() for x in live])
            updates, opt_state = self.optimizer.update(
                tree_unflatten(treedef, list(grads)), opt_state, plain,
                self.schedule(step))
            params = apply_updates(plain, updates)
        return params, opt_state, loss.detach(), metrics

    @torch.no_grad()
    def _eval_batch(self, params, inputs, targets):
        loss, metrics = self.task.loss_fn(params, {"tokens": inputs,
                                                   "targets": targets})
        return metrics["loss"], metrics.get("acc", torch.zeros(()))

    # ------------------------------------------------------------- eval

    def evaluate(self, params) -> dict:
        losses, accs = [], []
        for inputs, targets in self.task.pipeline.eval_batches():
            l, a = self._eval_batch(params, inputs, targets)
            losses.append(float(l))
            accs.append(float(a))
        return {"test_loss": sum(losses) / max(len(losses), 1),
                "test_acc": sum(accs) / max(len(accs), 1)}

    # -------------------------------------------------------------- run

    def run(self, log: bool = False) -> dict:
        tc = self.tc
        params = self.task.init()
        history = []
        best = {"test_acc": -1.0, "test_loss": float("inf"), "step": 0}
        eval_every = tc.eval_every or self.sync_period

        def record(step, train_loss, eval_params):
            rec = {"step": step, "train_loss": float(train_loss)}
            rec.update(self.evaluate(eval_params))
            history.append(rec)
            if rec["test_acc"] > best["test_acc"]:
                best.update({"test_acc": rec["test_acc"],
                             "test_loss": rec["test_loss"], "step": step})
            if log:
                print(f"[{self.task.name}/{tc.method}] step {step} "
                      f"train {rec['train_loss']:.4f} "
                      f"test {rec['test_loss']:.4f} acc {rec['test_acc']:.4f}")

        if self.is_parallel:
            state = hwa_init(self.hwa_cfg, params, self.optimizer)
            del params
            for step in range(tc.total_steps):
                state, metrics = self._hwa_step(state, step)
                train_loss = metrics["loss"]
                if (step + 1) % self.sync_period == 0:
                    state, _ = self._sync_step(state)
                    if ((step + 1) // self.sync_period) % max(
                            eval_every // self.sync_period, 1) == 0:
                        record(step + 1, train_loss, state.wa)
            final_params = state.wa
        else:
            opt_state = self.optimizer.init(params)
            for step in range(tc.total_steps):
                params, opt_state, train_loss, _ = self._single_step(
                    params, opt_state, step)
                if (step + 1) % eval_every == 0:
                    record(step + 1, train_loss, params)
            final_params = params

        final = self.evaluate(final_params)
        return {"history": history, "best": best, "final": final,
                "params": final_params}

