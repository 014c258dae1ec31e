"""The port's training path against the JAX reference on the CPU:
two optimizer updates (sgd, adamw) on a tree of the model's leaf kinds; LM.loss
and its gradients at f32 (naive and flash_pallas attention, the 512-token
chunked head included); the data pipeline's properties; and a 2-layer
smoke HWA run (K=2, H=2, I=3, 8 steps) of the port's Trainer against the
JAX Trainer from the reference's init with the reference's batches, on
both ``use_kernels`` settings. Tolerances, with the errors measured on
this CPU beside them:

- optimizer update: rtol = atol = 1e-6 (f32 ops in the same order;
  measured 0 for sgd, ~1e-8 for adamw's pow);
- loss 1e-5 and grads rtol = atol = 1e-4, as the port's other model
  tests (XLA's and torch's matmuls sum in different orders; measured
  |dloss| <= 5e-7, grads <= 2e-6 relative);
- Trainer: per-step losses and W̿ after each sync within 1e-5 (measured
  1e-6 and 4e-7: the same matmul-order drift over 8 steps).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import HWAConfig as JaxHWAConfig
from repro.data import DataPipeline as JaxPipeline
from repro.data import make_markov_lm_dataset as jax_markov
from repro.models.registry import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import sgd as jax_sgd
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import lm_task as jax_lm_task
from repro_torch.bridge import params_from_numpy
from repro_torch.common.pytree import tree_flatten, tree_leaves, \
    tree_unflatten
from repro_torch.configs import get_smoke_config
from repro_torch.core.hwa import HWAConfig
from repro_torch.data import DataPipeline, make_markov_lm_dataset, \
    replica_batch_indices
from repro_torch.models.registry import build_model
from repro_torch.optim import adamw, apply_updates, sgd
from repro_torch.train.trainer import Task, TrainConfig, Trainer, lm_task
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@functools.cache
def _jax_params(dtype="float32", arch="granite-3-2b"):
    """The reference's smoke-model init (numpy leaves, never mutated),
    compiled once per dtype and arch: the attention path does not change
    it."""
    cfg = jax_smoke_config(arch).with_(dtype=dtype)
    return jax.device_get(jax.jit(jax_build_model(cfg).init)(
        jax.random.key(0)))


# ----------------------------------------------------------- optim


@pytest.mark.parametrize("name", ["sgd", "adamw"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_update_matches_jax(name, dtype):
    # the model's kinds of leaf: matrices and a stacked layer in the
    # model dtype, f32 norm scales
    rng = np.random.RandomState(1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def leaf(*shape, dt=jdt):
        return np.asarray(jnp.asarray(rng.randn(*shape).astype(np.float32))
                          .astype(dt))

    f32 = jnp.float32
    jparams = {"embed": leaf(128, 64),
               "ln_f": {"scale": leaf(64, dt=f32)},
               "stack": [{"wq": leaf(2, 64, 4, 16),
                          "ln1": {"scale": leaf(2, 64, dt=f32)}}]}
    jgrads = jax.tree.map(lambda p: jnp.asarray(leaf(*p.shape, dt=p.dtype)),
                          jparams)
    make = {"sgd": (lambda m: m(momentum=0.9, weight_decay=5e-4)),
            "adamw": (lambda m: m(weight_decay=5e-4))}[name]
    jopt = make({"sgd": jax_sgd, "adamw": jax_adamw}[name])
    opt = make({"sgd": sgd, "adamw": adamw}[name])
    lr = np.float32(0.05)
    params = params_from_numpy(jparams, device="cpu")
    grads = params_from_numpy(jax.device_get(jgrads), device="cpu")
    jparams = jax.tree.map(jnp.asarray, jparams)   # XLA's ops, not numpy's
    jstate, state = jopt.init(jparams), opt.init(params)
    for _ in range(2):                  # a second update sees the moments
        # eager, as written: under jit XLA's CPU build contracts
        # momentum·mu + g into an FMA, which the expression does not ask for
        jupd, jstate = jopt.update(jgrads, jstate, jparams, jnp.float32(lr))
        jparams = jax_apply_updates(jparams, jupd)
        upd, state = opt.update(grads, state, params, torch.tensor(lr))
        params = apply_updates(params, upd)
    for g, w in zip(tree_leaves(params), jax.tree.leaves(jparams)):
        assert str(g.dtype) == f"torch.{w.dtype}"
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=1e-6, atol=1e-6)
    if name == "sgd":                   # the same f32 ops: exact
        for g, w in zip(tree_leaves(state), jax.tree.leaves(jstate)):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))


# ------------------------------------------------------------ model


@pytest.mark.parametrize("impl,S,arch", [
    pytest.param("naive", 32, "granite-3-2b", id="naive-32"),
    pytest.param("flash_pallas", 32, "granite-3-2b", id="flash_pallas-32"),
    pytest.param("naive", 1024, "granite-3-2b", id="naive-1024"),
    # the MoE family: the router loss rides in the total (and in ``aux``)
    pytest.param("flash_pallas", 32, "granite-moe-1b-a400m",
                 id="flash_pallas-32-granite-moe-1b-a400m"),
    pytest.param("naive", 32, "qwen2-moe-a2.7b", id="naive-32-qwen2-moe-a2.7b"),
])
def test_lm_loss_and_grads_match_jax(impl, S, arch):
    jcfg = jax_smoke_config(arch).with_(attn_impl=impl, remat="full")
    jlm = jax_build_model(jcfg)
    jparams = _jax_params(arch=arch)
    rng = np.random.RandomState(S)
    tok = rng.randint(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    tgt = rng.randint(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        jparams, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)})

    lm = build_model(get_smoke_config(arch).with_(attn_impl=impl,
                                                  remat="full"))
    leaves, treedef = tree_flatten(params_from_numpy(jparams, device="cpu"))
    live = [x.requires_grad_(True) for x in leaves]
    loss, m = lm.loss(tree_unflatten(treedef, live),
                      {"tokens": torch.from_numpy(tok),
                       "targets": torch.from_numpy(tgt)})
    grads = torch.autograd.grad(loss, live)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    assert abs(float(m["aux"].detach()) - float(jm["aux"])) <= 1e-6 * max(
        abs(float(jm["aux"])), 1.0)
    assert float(m["acc"]) == float(jm["acc"])
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_unported_training_options_raise():
    """Every training option of the reference runs: ``remat="dots"``,
    ``attn_impl="flash_jnp"`` (A5), a resilient HWA (A12) and, since the
    two-level tree is ported (A13), ``outer_every``, which the stacked
    Trainer carries without effect, as the reference's does."""
    cfg = get_smoke_config("granite-3-2b")
    tok = torch.zeros((1, 8), dtype=torch.int32)
    for ok in (cfg.with_(remat="dots"), cfg.with_(attn_impl="flash_jnp")):
        lm = build_model(ok)
        params = lm.init(torch.Generator().manual_seed(0), device="cpu")
        loss, _ = lm.loss(params, {"tokens": tok, "targets": tok})
        assert bool(torch.isfinite(loss))
    lm = build_model(cfg)
    pipe = DataPipeline(make_markov_lm_dataset(vocab=cfg.vocab_size,
                                               seq_len=8, n_train=8,
                                               n_test=4, device="cpu"),
                        batch_size=4, n_replicas=2)
    out = Trainer(lm_task(lm, pipe, device="cpu"),
                  TrainConfig(hwa=HWAConfig(resilient=True, window=2,
                                            max_param_rms=1e3),
                              total_steps=2)).run()
    assert np.isfinite(out["final"]["test_loss"])
    runs = [Trainer(lm_task(lm, pipe, device="cpu"),
                    TrainConfig(hwa=HWAConfig(outer_every=h2, window=2),
                                total_steps=2)).run()["final"]
            for h2 in (1, 2)]
    assert runs[0] == runs[1] and np.isfinite(runs[1]["test_loss"])


# ------------------------------------------------------------- data


def test_pipeline_properties():
    n_train, bs = 40, 8
    spe = n_train // bs
    for r in range(2):
        for epoch in range(2):
            seen = torch.cat([replica_batch_indices(3, r, epoch * spe + i,
                                                    n_train, bs)
                              for i in range(spe)])
            assert sorted(seen.tolist()) == list(range(n_train))
    # a distinct order per replica and per epoch; a pure function of
    # (seed, replica, step)
    a = replica_batch_indices(3, 0, 0, n_train, bs)
    assert not torch.equal(a, replica_batch_indices(3, 1, 0, n_train, bs))
    assert not torch.equal(a, replica_batch_indices(3, 0, spe, n_train, bs))
    assert not torch.equal(a, replica_batch_indices(4, 0, 0, n_train, bs))
    assert torch.equal(a, replica_batch_indices(3, 0, 0, n_train, bs))

    ds = make_markov_lm_dataset(vocab=32, seq_len=16, n_train=n_train,
                                n_test=16, seed=0, device="cpu")
    again = make_markov_lm_dataset(vocab=32, seq_len=16, n_train=n_train,
                                   n_test=16, seed=0, device="cpu")
    assert torch.equal(ds.train_inputs, again.train_inputs)
    assert ds.train_inputs.dtype == torch.int32
    assert torch.equal(ds.train_inputs[:, 1:], ds.train_targets[:, :-1])
    assert int(ds.train_inputs.max()) < 32
    pipe = DataPipeline(ds, batch_size=bs, n_replicas=3, seed=1)
    tok, tgt = pipe.stacked_batch(4)
    assert tok.shape == tgt.shape == (3, bs, 16)
    assert len(list(pipe.eval_batches())) == 2
    # learnable: the chain's transitions are far from uniform
    counts = torch.zeros(32, 32)
    counts.index_put_((ds.train_inputs.reshape(-1).long(),
                       ds.train_targets.reshape(-1).long()),
                      torch.ones(ds.train_inputs.numel()), accumulate=True)
    top = counts.max(1).values.sum() / counts.sum()
    assert float(top) > 3 / 32


# ---------------------------------------------------------- trainer


@pytest.mark.parametrize("method", ["base", "ca", "swa", "ema", "lookahead",
                                    "sam", "online", "pmsgd", "hwa"])
def test_port_trainer_methods_run_and_learn(method):
    """Every ported method trains the smoke model on the port's own data
    (as tests/test_trainer.py does for the reference)."""
    cfg = get_smoke_config("granite-3-2b")
    ds = make_markov_lm_dataset(vocab=cfg.vocab_size, seq_len=32,
                                n_train=64, n_test=16, seed=0, device="cpu")
    K = 2 if method in ("online", "pmsgd", "hwa") else 1
    pipe = DataPipeline(ds, batch_size=8, n_replicas=K, seed=0)
    tc = TrainConfig(method=method, total_steps=12, batch_size=8,
                     base_lr=0.3, eval_every=4,
                     hwa=HWAConfig(n_replicas=K, sync_period=4, window=2))
    out = Trainer(lm_task(build_model(cfg), pipe, device="cpu"), tc).run()
    losses = [h["test_loss"] for h in out["history"]]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_train_launcher_on_cpu(capsys):
    from repro_torch.launch.train import main
    main(["--device", "cpu", "--steps", "2", "--k", "2", "--window", "3",
          "--sync-period", "2", "--batch-size", "128", "--seq-len", "8"])
    out = capsys.readouterr().out
    assert "[granite-3-2b/hwa] step 2" in out and "on cpu: final" in out


class _Injected:
    """The port's pipeline interface over the JAX pipeline's batches."""

    def __init__(self, jpipe):
        self.jpipe = jpipe
        self.steps_per_epoch = jpipe.steps_per_epoch
        self._stacked = jax.jit(jpipe.stacked_batch)

    @staticmethod
    def _t(pair):
        return tuple(torch.from_numpy(np.array(x)) for x in
                     jax.device_get(pair))

    def stacked_batch(self, step):
        return self._t(self._stacked(step))

    def replica_batch(self, r, step):
        return self._t(self.jpipe.replica_batch(r, step))

    def eval_batches(self):
        for pair in self.jpipe.eval_batches():
            yield self._t(pair)


def _record(trainer, log, tree_to_np):
    """Wrap a trainer's step and sync to log each step's loss and W̿."""
    step, sync = trainer._hwa_step, trainer._sync_step

    def logged_step(state, i):
        state, m = step(state, i)
        log["loss"].append(float(m["loss"]))
        return state, m

    def logged_sync(state):
        state, m = sync(state)
        log["wa"].append(tree_to_np(state.wa))
        return state, m

    trainer._hwa_step, trainer._sync_step = logged_step, logged_sync


@pytest.mark.parametrize("use_kernels", [False, True])
def test_hwa_trainer_matches_jax(use_kernels):
    K, H, I, steps = 2, 2, 3, 8
    jcfg = jax_smoke_config("granite-3-2b")
    jlm = jax_build_model(jcfg)
    jpipe = JaxPipeline(jax_markov(vocab=jcfg.vocab_size, seq_len=32,
                                   n_train=64, n_test=16, seed=0),
                        batch_size=8, n_replicas=K, seed=0)
    jtc = JaxTrainConfig(method="hwa", total_steps=steps, batch_size=8,
                         base_lr=0.3, hwa=JaxHWAConfig(
                             n_replicas=K, sync_period=H, window=I,
                             use_kernels=use_kernels))
    jt = JaxTrainer(jax_lm_task(jlm, jpipe), jtc)
    jlog = {"loss": [], "wa": []}
    _record(jt, jlog, lambda t: [np.asarray(x, np.float32)
                                 for x in jax.tree.leaves(t)])
    jout = jt.run(eval_views=True)

    jparams = jax.device_get(jlm.init(jax.random.key(jtc.seed)))
    lm = build_model(get_smoke_config("granite-3-2b"))
    task = Task(init=lambda: params_from_numpy(jparams, device="cpu"),
                loss_fn=lm_task(lm, None).loss_fn, pipeline=_Injected(jpipe))
    tc = TrainConfig(method="hwa", total_steps=steps, batch_size=8,
                     base_lr=0.3, hwa=HWAConfig(n_replicas=K, sync_period=H,
                                                window=I,
                                                use_kernels=use_kernels))
    t = Trainer(task, tc)
    log = {"loss": [], "wa": []}
    _record(t, log, lambda tree: [x.float().numpy().copy()
                                  for x in tree_leaves(tree)])
    out = t.run(eval_views=True)

    assert len(log["loss"]) == steps and len(log["wa"]) == steps // H
    np.testing.assert_allclose(log["loss"], jlog["loss"], rtol=1e-5,
                               atol=1e-5)
    for got, want in zip(log["wa"], jlog["wa"]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([h["test_loss"] for h in out["history"]],
                               [h["test_loss"] for h in jout["history"]],
                               rtol=1e-5, atol=1e-5)
    # the inner (replica 0) and outer (replica mean) views are taken
    # before the sync restarts the replicas
    for view in ("inner", "outer"):
        got = [h[f"{view}_loss"] for h in out["history"]]
        want = [h[f"{view}_loss"] for h in jout["history"]]
        assert len(got) == len(want) == len(out["history"]) > 0
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert log["loss"][-1] < log["loss"][0]
