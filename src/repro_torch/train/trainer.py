"""Training orchestration (counterpart of ``repro.train.trainer``): HWA
and every paper baseline under one loop.

Methods (paper §V):
  base      — SGD, step-decay LR ×0.1 every ``decay_every`` (paper Baseline)
  ca        — SGD, cosine LR over the whole budget
  swa       — offline WA: Stage I regular LR, Stage II constant sampling LR,
              running average of the weights sampled every epoch (SWA [15])
  ema       — exponential moving average of weights
  lookahead — Lookahead optimizer [32]
  sam       — sharpness-aware minimization [35] (two passes a step)
  online    — low-frequency online WA only (HWA with I=1)
  pmsgd     — parallel mini-batch SGD (sync every step, K replicas)
  hwa       — the full method (K replicas, period H, window I)

The trainer evaluates the method's own weights (W̿ for the K-replica
methods, the running average for SWA and EMA, the live weights otherwise)
and tracks the best snapshot. The K-replica methods checkpoint through a
``resilience.CheckpointSession`` every ``checkpoint_every`` steps, in the
reference's format, and ``resume`` restarts from the newest intact save:
the data pipeline and schedules are functions of (seed, step), so the
saved state and step resume the run bit for bit.

It takes any pipeline with ``stacked_batch(step)``, ``replica_batch(r,
step)``, ``steps_per_epoch`` and ``eval_batches()``, so a test can hand
it the reference's batches. Where the reference jit-compiles a step, the
port runs eagerly.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.common.pytree import tree_map
from repro_torch.core.baselines import (ema_init, ema_update, lookahead_init,
                                        lookahead_update, sam_gradient,
                                        swa_init, swa_params, swa_update,
                                        value_and_grad)
from repro_torch.core.hwa import HWAConfig, hwa_init, hwa_inner_step, \
    hwa_sync
from repro_torch.core.online import online_average
from repro_torch.optim import (adamw, apply_updates, cosine_schedule, sgd,
                               step_decay_schedule, swa_constant_schedule)

PyTree = Any

PARALLEL = ("hwa", "online", "pmsgd")
METHODS = ("base", "ca", "swa", "ema", "lookahead", "sam") + PARALLEL


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
    swa_start_frac: float = 0.75
    swa_lr: float = 0.05
    ema_decay: float = 0.99
    lookahead_k: int = 5
    lookahead_alpha: float = 0.5
    sam_rho: float = 0.05
    eval_every: int = 0             # 0 → every sync cycle
    seed: int = 0
    checkpoint_dir: str = ""        # "" → no checkpointing
    checkpoint_every: int = 0       # steps between saves (0 → off)
    checkpoint_keep: int = 3        # retained checkpoints
    resume: bool = False            # restart from the newest intact save


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
    sched = cosine_schedule(tc.base_lr, tc.total_steps)
    if tc.method == "swa":
        return swa_constant_schedule(
            sched, int(tc.total_steps * tc.swa_start_frac), tc.swa_lr)
    return sched


class Trainer:
    def __init__(self, task: Task, tc: TrainConfig):
        if tc.method not in METHODS:
            raise ValueError(f"unknown method {tc.method!r}")
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
        # the reference's jitted updates; attributes, so a caller can
        # wrap them (as it wraps the steps)
        self._swa_update = swa_update
        self._ema_update = ema_update
        self._lookahead_update = lookahead_update

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
        if self.tc.method == "sam":
            (loss, metrics), grads = sam_gradient(
                self.task.loss_fn, params, batch, rho=self.tc.sam_rho)
        else:
            (loss, metrics), grads = value_and_grad(self.task.loss_fn,
                                                    params, batch)
        with torch.no_grad():
            plain = tree_map(lambda x: x.detach(), params)
            updates, opt_state = self.optimizer.update(
                grads, opt_state, plain, self.schedule(step))
            params = apply_updates(plain, updates)
        return params, opt_state, loss, metrics

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

    def _session(self):
        """The checkpoint session of the run, or None; raises for the
        settings the reference rejects."""
        tc = self.tc
        session = None
        if tc.checkpoint_dir and tc.checkpoint_every > 0:
            from repro_torch.resilience.session import CheckpointSession
            session = CheckpointSession(tc.checkpoint_dir,
                                        keep=tc.checkpoint_keep)
        if session is None and tc.resume:
            raise ValueError("resume=True needs checkpoint_dir and "
                             "checkpoint_every set")
        if session is not None and not self.is_parallel:
            raise ValueError("checkpointing covers the K-replica methods "
                             f"(hwa/online/pmsgd), not {tc.method!r}")
        return session

    # -------------------------------------------------------------- run

    def run(self, eval_views: bool = False, log: bool = False) -> dict:
        tc = self.tc
        session = self._session()
        params = self.task.init()
        history = []
        best = {"test_acc": -1.0, "test_loss": float("inf"), "step": 0}
        eval_every = tc.eval_every or self.sync_period

        def record(step, train_loss, eval_params, views=None):
            rec = {"step": step, "train_loss": float(train_loss)}
            rec.update(self.evaluate(eval_params))
            for name, p in (views or {}).items():
                v = self.evaluate(p)
                rec[f"{name}_loss"] = v["test_loss"]
                rec[f"{name}_acc"] = v["test_acc"]
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
            train_loss = torch.zeros(())
            start_step = 0
            if session is not None and tc.resume:
                latest = session.latest_intact()
                if latest is not None:
                    state = session.load(latest, "hwa", state)
                    meta = session.meta(latest)
                    start_step = int(meta["step"])
                    history = list(meta.get("history", []))
                    best.update(meta.get("best", {}))
                    train_loss = torch.tensor(meta.get("train_loss", 0.0))
                    if log:
                        print(f"[{self.task.name}/{tc.method}] resumed "
                              f"from step {start_step} "
                              f"({session.step_dir(start_step)})")
            for step in range(start_step, tc.total_steps):
                state, metrics = self._hwa_step(state, step)
                train_loss = metrics["loss"]
                if (step + 1) % self.sync_period == 0:
                    views = None
                    if eval_views:
                        # copied BEFORE the sync restarts the replicas
                        # in place
                        views = {"inner": tree_map(lambda x: x[0].clone(),
                                                   state.inner),
                                 "outer": online_average(state.inner)}
                    state, _ = self._sync_step(state)
                    if ((step + 1) // self.sync_period) % max(
                            eval_every // self.sync_period, 1) == 0:
                        record(step + 1, train_loss, state.wa, views)
                if session is not None and \
                        (step + 1) % tc.checkpoint_every == 0:
                    # HWAState is one registered tree (the window's layout
                    # rides in its structure), so one named tree round-
                    # trips everything bit for bit
                    session.save(step + 1, {"hwa": state},
                                 meta={"step": step + 1, "history": history,
                                       "best": dict(best),
                                       "train_loss": float(train_loss)})
            final_params = state.wa
        else:
            opt_state = self.optimizer.init(params)
            swa_state = swa_init(params) if tc.method == "swa" else None
            ema_state = (ema_init(params, tc.ema_decay)
                         if tc.method == "ema" else None)
            la_state = (lookahead_init(params, tc.lookahead_k,
                                       tc.lookahead_alpha)
                        if tc.method == "lookahead" else None)
            swa_start = int(tc.total_steps * tc.swa_start_frac)
            swa_period = self.task.pipeline.steps_per_epoch
            train_loss = torch.zeros(())

            def method_params(params):
                if tc.method == "swa" and int(swa_state.n) > 0:
                    return swa_params(swa_state, params)
                if tc.method == "ema":
                    return tree_map(lambda a, p: a.to(p.dtype),
                                    ema_state.avg, params)
                return params

            for step in range(tc.total_steps):
                params, opt_state, train_loss, _ = self._single_step(
                    params, opt_state, step)
                if tc.method == "ema":
                    ema_state = self._ema_update(ema_state, params)
                if tc.method == "lookahead" and \
                        (step + 1) % tc.lookahead_k == 0:
                    la_state, params = self._lookahead_update(la_state,
                                                              params)
                if (tc.method == "swa" and step + 1 > swa_start
                        and (step + 1) % swa_period == 0):
                    swa_state = self._swa_update(swa_state, params)
                if (step + 1) % eval_every == 0:
                    record(step + 1, train_loss, method_params(params))
            final_params = method_params(params)

        final = self.evaluate(final_params)
        return {"history": history, "best": best, "final": final,
                "params": final_params}
