"""HWA training cells: K replicas of the configuration's model stepped by
``repro_torch.core.hwa.hwa_inner_step`` on the loss of
``repro_torch.train.trainer.lm_task``, synchronized every H steps by
``hwa_sync`` (the fused sync kernel), SGD with momentum and weight decay
on the cosine schedule, as the traffic file states.

Set-up builds one HWA state from the benchmark's weights and runs whole
cycles (H steps and a sync) through the window's own calls until the
steps the reference follows are done: the first ``check_steps``, and on
to the first sync where that comes later. They warm up every shape the
window uses. The window then runs whole cycles until ``--seconds`` have
passed. Every row of every step is a fresh draw of uniform tokens from
the seed."""
from __future__ import annotations

import time

import torch

from hwabench import check, weights
from hwabench.drivers import program_config
from hwabench.reference import hwa as ref_hwa
from hwabench.devtrace import span


#: the traced slice of a ``--trace 1`` window: whole cycles from the
#: first one that starts past a third of the window, until this many
#: steps are traced
TRACE_STEPS = 8


class Data:
    """Token rows (K, B, S + 1) for each step from ``--seed``, drawn in
    step order on the device."""

    def __init__(self, seed, traffic, vocab, device):
        self.gen = torch.Generator(device=device).manual_seed(
            weights.derive(seed, "data"))
        self.shape = (traffic["K"], traffic["batch"], traffic["seq"] + 1)
        self.vocab, self.device = vocab, device

    def next(self):
        return torch.randint(0, self.vocab, self.shape, generator=self.gen,
                             device=self.device)


def split(rows):
    """(inputs, targets) of token rows: each position predicts the
    next."""
    return rows[..., :-1].contiguous(), rows[..., 1:].contiguous()


class Cell:
    kind = "train"

    def __init__(self, cfg: dict, traffic: dict, reference, seed: int,
                 device, step_fn=None):
        self.cfg, self.traffic, self.ref = cfg, traffic, reference
        self.seed, self.device = seed, torch.device(device)
        self.shapes = reference.param_shapes(cfg)
        self.sizes = reference.sizes(cfg)
        self.step_fn = step_fn
        self.spans = {"inner_step": [], "sync": []}

    # ------------------------------------------------------------ set-up

    def setup(self, clock) -> None:
        from repro_torch.core.hwa import (HWAConfig, hwa_init,
                                          hwa_inner_step, hwa_sync)
        from repro_torch.models.registry import build_model
        from repro_torch.optim import cosine_schedule, sgd
        from repro_torch.train.trainer import lm_task
        clock("imports")
        tr = self.traffic
        self.pcfg = program_config(self.cfg)
        params = weights.make_params(self.shapes, self.seed, self.device)
        clock("weights")
        self.hcfg = HWAConfig(n_replicas=tr["K"], sync_period=tr["H"],
                              window=tr["I"], use_kernels=True)
        self.opt = sgd(momentum=tr["momentum"],
                       weight_decay=tr["weight_decay"])
        self.schedule = cosine_schedule(tr["lr"], tr["total_steps"])
        self.loss_fn = lm_task(build_model(self.pcfg), None).loss_fn
        self.inner_step = self.step_fn or hwa_inner_step
        self.sync_call = hwa_sync
        self.state = hwa_init(self.hcfg, params, self.opt)
        del params
        self.data = Data(self.seed, tr, self.sizes["V"], self.device)
        self.step_i = 0
        self.losses = []
        self.readings = {}
        self.cycle(check=True)
        clock("first cycle")
        while self.step_i < followed(tr):
            self.cycle(check=True)
        clock("the other check cycles")

    def _sync_device(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _event(self):
        if self.device.type != "cuda":
            return None
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def step(self):
        rows = self.data.next()
        lr = self.schedule(self.step_i)
        t0 = self._event()
        with span("inner_step"):
            self.state, m = self.inner_step(self.hcfg, self.state,
                                            split(rows), self.loss_fn,
                                            self.opt, lr)
        self.spans["inner_step"].append((t0, self._event()))
        self.step_i += 1
        return m

    def sync(self):
        t0 = self._event()
        with span("sync"):
            self.state, _ = self.sync_call(self.hcfg, self.state)
        self.spans["sync"].append((t0, self._event()))

    def cycle(self, check=False):
        """H steps and a sync. With ``check``, the steps the reference
        follows record what the comparison reads: each replica's loss,
        the optimizer's view of the first gradient (its momentum after
        one step), the change of the weights in the state step
        ``check_steps`` + 1 starts from, and the change of W̿ in the
        state after the last step followed (a sync among them)."""
        tr = self.traffic
        H, n, last = tr["H"], tr["check_steps"], followed(tr)
        for _ in range(H):
            m = self.step()
            if not check or self.step_i > last:
                continue
            self.losses.append(m["per_replica_loss"].detach().float())
            if self.step_i == 1:
                self.readings["grad"] = self._norms(
                    self.state.inner_opt["mu"])
            if self.step_i == n and n % H:
                self._read("change")
            if self.step_i == last and last % H:
                self._read("wa")
        self.sync()
        if check and self.step_i == n and not n % H:
            self._read("change")
        if check and self.step_i == last and not last % H:
            self._read("wa")

    def _norms(self, stacked):
        K = self.traffic["K"]
        return torch.stack([check.slice_norms(weights.map_tree(
            lambda x: x[k], stacked)) for k in range(K)])

    def _read(self, what):
        """The change from the start of the replicas' weights
        (``change``) or of W̿ (``wa``), as leaf norms."""
        base = weights.make_params(self.shapes, self.seed, self.device)
        if what == "change":
            K = self.traffic["K"]
            self.readings["change"] = torch.stack([check.diff_norms(
                weights.map_tree(lambda x: x[k], self.state.inner), base)
                for k in range(K)])
        else:
            self.readings["wa"] = check.diff_norms(self.state.wa,
                                                   base)[None]
        del base

    # ------------------------------------------------------------ window

    def window(self, seconds: float, tracer=None) -> dict:
        tr = self.traffic
        self.spans = {"inner_step": [], "sync": []}
        traced = {"steps": 0, "syncs": 0}
        losses = []
        self._sync_device()
        t0 = time.perf_counter()
        cycles = 0
        while True:
            now = time.perf_counter()
            if tracer is not None and tracer.prof is None and \
                    tracer.window_s is None and now - t0 >= seconds / 3:
                tracer.start()
            for _ in range(tr["H"]):
                losses.append(self.step()["per_replica_loss"])
                if tracer is not None and tracer.running:
                    traced["steps"] += 1
            self.sync()
            cycles += 1
            if tracer is not None and tracer.running:
                traced["syncs"] += 1
                if traced["steps"] >= TRACE_STEPS:
                    tracer.stop()
            if time.perf_counter() - t0 >= seconds:
                break
        if tracer is not None and tracer.running:
            tracer.stop()
        self._sync_device()
        window_s = time.perf_counter() - t0
        steps = cycles * tr["H"]
        tokens = steps * tr["K"] * tr["batch"] * tr["seq"]
        bad = int((~torch.isfinite(torch.stack(losses))).sum())
        return {"window_s": window_s, "steps": steps, "syncs": cycles,
                "tokens": tokens, "attempted": steps, "failed": bad,
                "traced": traced}

    def end_to_end(self, w: dict) -> dict:
        return {"train_tokens_per_s": (w["tokens"] / w["window_s"],
                                       "tokens/s")}

    def span_ms(self) -> dict:
        out = {}
        for name, pairs in self.spans.items():
            out[name] = [a.elapsed_time(b) for a, b in pairs
                         if a is not None]
        return out

    def free(self):
        self.program_readings = {
            "loss": torch.stack(self.losses).cpu(),
            **{k: v.cpu() for k, v in self.readings.items()}}
        self.state = self.data = None
        self.readings = {}
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # --------------------------------------------------------- reference

    def reference_readings(self, quant=False, half_batch=False) -> dict:
        """The same readings of the plain reference over the same
        weights and rows: the losses of the steps followed, its first
        gradient as the optimizer takes it, the change of the weights
        after ``check_steps`` steps and of W̿ after the last step
        followed.
        ``quant``: the control (products in float8); ``half_batch``: the
        fault that drops half of each replica's rows."""
        self.ref.no_tf32()
        tr = self.traffic
        n = followed(tr)
        base = weights.make_params(self.shapes, self.seed, self.device)
        paths = [p for p, _ in weights.leaves_of(base)]
        params0 = [x for _, x in weights.leaves_of(base)]
        data = Data(self.seed, tr, self.sizes["V"], self.device)
        rows = [split(data.next()) for _ in range(n)]
        del data

        def unflat(plist):
            tree = weights.map_tree(lambda x: None, self.shapes)
            for p, x in zip(paths, plist):
                weights.set_leaf(tree, p, x)
            return tree

        def loss_fn(plist, inputs, targets):
            if half_batch:
                half = inputs.shape[0] // 2
                inputs, targets = inputs[:half], targets[:half]
            return self.ref.loss(self.cfg, unflat(plist), inputs, targets,
                                 quant=quant)

        def batches(step):
            inputs, targets = rows[step]
            return [(inputs[k], targets[k]) for k in range(tr["K"])]

        losses = torch.zeros(n, tr["K"])
        grad = [None] * tr["K"]

        def on_step(step, k, loss, grads):
            losses[step, k] = float(loss)
            if step == 0:
                grad[k] = check.slice_norms(unflat(grads)).cpu()

        stored, wa = ref_hwa.follow(loss_fn, params0, batches, tr, n,
                                    on_step=on_step,
                                    keep_at=tr["check_steps"])
        out = {"loss": losses, "grad": torch.stack(grad),
               "change": torch.stack([check.diff_norms(unflat(s), base).cpu()
                                      for s in stored]),
               "wa": check.diff_norms(unflat(wa), base).cpu()[None]}
        del stored, wa, base, params0
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out


def followed(traffic: dict) -> int:
    """The steps the reference follows: the first ``check_steps``, and on
    to the first sync where that comes later, so that W̿ is compared."""
    return max(traffic["check_steps"], traffic["H"])


def numbers(prog: dict, ref: dict) -> dict:
    """The numbers compared: the widest gap of a step's loss (nats), and
    by the worst leaf the gap of the first gradient's norm, of the
    weights' change after the check steps and of W̿'s change after the
    first sync (leaves whose reference gradient is under a thousandth of
    the median leaf's left out of both changes)."""
    keep = ref["grad"] >= 1e-3 * ref["grad"].median(dim=1,
                                                     keepdim=True).values
    return {"loss_gap": float((prog["loss"] - ref["loss"]).abs().max()),
            "grad_gap": check.worst_leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": check.worst_leaf_gap(prog["change"],
                                               ref["change"], keep),
            "wa_gap": check.worst_leaf_gap(prog["wa"], ref["wa"], keep[:1])}
