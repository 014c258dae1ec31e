"""The paper's baselines in the port against the JAX reference, on the
CPU: the four schedules the port lacked, the SWA/EMA/Lookahead updates,
the SAM gradient, the baseline states' key paths, and the Trainer's
``swa``, ``ema``, ``lookahead`` and ``sam`` methods on the reference's
init and batches. Tolerances, with what was measured here beside them:

- schedules: 2 f32 ULPs at the schedule's scale (its largest lr):
  torch's and XLA's ``cos`` differ by 1 ULP, which ``0.5·(1 + cos)``
  carries into the schedule's absolute error, and XLA contracts
  ``final + c·cos`` into an FMA under jit (measured 0.83 for
  warmup-cosine, 1.25 for SWA's, 0 for the constant and cyclic ones,
  which compute no cos);
- the updates: bit for bit against the reference's expressions run
  eagerly; under jit XLA contracts EMA's ``x + t·(y − x)`` into an FMA
  (ROADMAP.md Queue C), which moves the average by at most half an ULP
  of ``t·(y − x)`` a step: within 1 ULP at the data's scale (its RMS)
  over three steps;
- SAM's gradient: rtol = atol = 1e-4, the port's gradient tolerance
  (tests/test_torch_train.py; XLA's and torch's matmuls sum in different
  orders);
- Trainer: per-step losses and final parameters within 1e-5, the HWA
  Trainer's tolerance (tests/test_torch_train.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.compat import tree_flatten_with_path as jax_flatten_path
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import baselines as jb
from repro.data import DataPipeline as JaxPipeline
from repro.data import make_markov_lm_dataset as jax_markov
from repro.models.registry import build_model as jax_build_model
from repro.optim import schedules as js
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import lm_task as jax_lm_task
from repro_torch.bridge import params_from_numpy
from repro_torch.common.pytree import tree_flatten_with_path, tree_leaves
from repro_torch.common.quant import max_ulp, rel_ulp_error
from repro_torch.configs import get_smoke_config
from repro_torch.core import baselines as pb
from repro_torch.models.registry import build_model
from repro_torch.optim import schedules as ps
from repro_torch.train.trainer import Task, TrainConfig, Trainer, lm_task
from test_torch_train import _Injected, _jax_params
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _t(x):
    """A JAX array (or numpy) as a CPU tensor, bits kept."""
    return params_from_numpy(np.asarray(jax.device_get(x)), device="cpu")


def _bits_equal(got, want):
    assert str(got.dtype).removeprefix("torch.") == np.asarray(want).dtype.name
    assert torch.equal(got.reshape(-1).view(torch.uint8),
                       _t(want).reshape(-1).view(torch.uint8))


# ------------------------------------------------------------ schedules


#: name: (schedule of a module, its largest lr)
SCHEDULES = {
    "constant": (lambda m: m.constant_schedule(0.07), 0.07),
    "warmup_cosine": (lambda m: m.warmup_cosine_schedule(0.3, 5, 40, 0.01),
                      0.3),
    "cyclic": (lambda m: m.cyclic_schedule(0.1, 0.01, 7), 0.1),
    "swa_constant": (lambda m: m.swa_constant_schedule(
        m.cosine_schedule(0.3, 40), 25, 0.05), 0.3),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(name):
    """Steps 0..45 through the jitted reference (as the Trainer calls it,
    with an int32 step) against the port's f32 values."""
    make, top = SCHEDULES[name]
    jsched = jax.jit(make(js))
    sched = make(ps)
    want = torch.tensor([np.float32(jsched(jnp.int32(i)))
                         for i in range(46)])
    got = torch.stack([sched(i).reshape(()) for i in range(46)])
    assert got.dtype == torch.float32
    assert rel_ulp_error(want, got, torch.float32, floor=top) <= 2.0
    if name in ("constant", "cyclic"):          # no cos: the same bits
        assert max_ulp(got, want) == 0


# -------------------------------------------------------------- updates


def _pair(seed, dtype):
    """The same leaves on both sides: a matrix and a vector of ``dtype``
    and an f32 norm scale, made with numpy from a seed."""
    rng = np.random.RandomState(seed)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    j = {"w": jnp.asarray(rng.randn(64, 33).astype(np.float32)).astype(jdt),
         "b": jnp.asarray(rng.randn(100).astype(np.float32)).astype(jdt),
         "ln": {"scale": jnp.asarray(rng.randn(33).astype(np.float32))}}
    return j, params_from_numpy(jax.device_get(j), device="cpu")


def _tree_bits_equal(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        _bits_equal(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("method", ["swa", "ema", "lookahead"])
def test_update_matches_jax(method, dtype):
    """Three updates from the same init and parameters: the averages (f32)
    and the cast-back weights bit-equal to the reference's."""
    (j0, p0) = _pair(0, dtype)
    seq = [_pair(1 + i, dtype) for i in range(3)]
    if method == "swa":
        jst, st = jb.swa_init(j0), pb.swa_init(p0)
        for jp, pp in seq:
            jst, st = jb.swa_update(jst, jp), pb.swa_update(st, pp)
        assert int(st.n) == int(jst.n) == 3
        _tree_bits_equal(st.avg, jst.avg)
        _tree_bits_equal(pb.swa_params(st, p0), jb.swa_params(jst, j0))
    elif method == "ema":
        jst, st = jb.ema_init(j0, 0.99), pb.ema_init(p0, 0.99)
        jit_st = jst
        for jp, pp in seq:
            jst, st = jb.ema_update(jst, jp), pb.ema_update(st, pp)
            jit_st = jax.jit(jb.ema_update)(jit_st, jp)
        _tree_bits_equal(st.avg, jst.avg)
        # the jitted reference contracts x + t(y - x) into an FMA
        for g, w in zip(tree_leaves(st.avg), jax.tree.leaves(jit_st.avg)):
            assert rel_ulp_error(_t(w), g, torch.float32) <= 1.0
    else:
        jst, st = jb.lookahead_init(j0, 3, 0.5), pb.lookahead_init(p0, 3, 0.5)
        for jp, pp in seq:
            (jst, jfast), (st, fast) = jb.lookahead_update(jst, jp), \
                pb.lookahead_update(st, pp)
            _tree_bits_equal(fast, jfast)
            _tree_bits_equal(st.slow, jst.slow)
        assert (st.k, st.alpha) == (3, 0.5)


def test_baseline_states_flatten_as_jax():
    """The three states are tree nodes with the reference's data fields
    (the key paths a checkpoint stores) and meta fields (kept in the
    structure)."""
    j, p = _pair(0, "float32")
    for jst, st in ((jb.swa_init(j), pb.swa_init(p)),
                    (jb.ema_init(j, 0.9), pb.ema_init(p, 0.9)),
                    (jb.lookahead_init(j, 4, 0.3),
                     pb.lookahead_init(p, 4, 0.3))):
        jpaths = ["|".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
                  for path, _ in jax_flatten_path({"s": jst})[0]]
        flat, treedef = tree_flatten_with_path({"s": st})
        assert ["|".join(path) for path, _ in flat] == jpaths
        from repro_torch.common.pytree import tree_unflatten
        back = tree_unflatten(treedef, [x for _, x in flat])["s"]
        assert type(back) is type(st) and back == st


# ------------------------------------------------------------------ SAM


def _lm_batch(seed=0, S=32):
    jcfg = jax_smoke_config("granite-3-2b")
    rng = np.random.RandomState(seed)
    tok = rng.randint(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    tgt = rng.randint(0, jcfg.vocab_size, (2, S)).astype(np.int32)
    return tok, tgt


def test_sam_gradient_matches_jax():
    """SAM's two passes on the smoke model (f32, the reference's init):
    the first pass's loss and the gradient at the perturbed point."""
    jlm = jax_build_model(jax_smoke_config("granite-3-2b"))
    lm = build_model(get_smoke_config("granite-3-2b"))
    tok, tgt = _lm_batch()
    jparams = _jax_params()
    (jloss, _), jg = jax.jit(functools.partial(
        jb.sam_gradient, jlm.loss, rho=0.05))(
            jparams, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)})
    params = params_from_numpy(jparams, device="cpu")
    (loss, metrics), g = pb.sam_gradient(
        lm.loss, params, {"tokens": torch.from_numpy(tok),
                          "targets": torch.from_numpy(tgt)}, rho=0.05)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    assert float(metrics["loss"].detach()) == pytest.approx(float(loss))
    _, plain = pb.value_and_grad(lm.loss, params,
                                 {"tokens": torch.from_numpy(tok),
                                  "targets": torch.from_numpy(tgt)})
    moved = max(float((a - b).abs().max()) for a, b in
                zip(tree_leaves(g), tree_leaves(plain)))
    assert moved > 1e-6                       # the perturbation mattered
    for a, w in zip(tree_leaves(g), jax.tree.leaves(jg)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


# -------------------------------------------------------------- Trainer


@pytest.mark.parametrize("method", ["swa", "ema", "lookahead", "sam"])
def test_baseline_trainer_matches_jax(method):
    """8 steps of the smoke model from the reference's init on the
    reference's batches (4 steps an epoch: SWA samples twice, after step
    2; Lookahead syncs every 3 steps): per-step losses, the evaluated
    history and the final (method's own) parameters within 1e-5."""
    steps = 8
    jcfg = jax_smoke_config("granite-3-2b")
    jlm = jax_build_model(jcfg)
    jpipe = JaxPipeline(jax_markov(vocab=jcfg.vocab_size, seq_len=32,
                                   n_train=32, n_test=16, seed=0),
                        batch_size=8, n_replicas=1, seed=0)
    kw = dict(method=method, total_steps=steps, batch_size=8, base_lr=0.3,
              eval_every=4, swa_start_frac=0.25, swa_lr=0.05,
              ema_decay=0.9, lookahead_k=3, sam_rho=0.05)
    jt = JaxTrainer(jax_lm_task(jlm, jpipe), JaxTrainConfig(**kw))
    jlosses = []
    jstep = jt._single_step

    def jlogged(params, opt_state, step):
        out = jstep(params, opt_state, step)
        jlosses.append(float(out[2]))
        return out
    jt._single_step = jlogged
    jout = jt.run()

    jparams = jax.device_get(jlm.init(jax.random.key(0)))
    lm = build_model(get_smoke_config("granite-3-2b"))
    task = Task(init=lambda: params_from_numpy(jparams, device="cpu"),
                loss_fn=lm_task(lm, None).loss_fn, pipeline=_Injected(jpipe))
    t = Trainer(task, TrainConfig(**kw))
    losses, step = [], t._single_step

    def logged(params, opt_state, i):
        out = step(params, opt_state, i)
        losses.append(float(out[2]))
        return out
    t._single_step = logged
    out = t.run()

    assert len(losses) == steps
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose([h["test_loss"] for h in out["history"]],
                               [h["test_loss"] for h in jout["history"]],
                               rtol=1e-5, atol=1e-5)
    for g, w in zip(tree_leaves(out["params"]),
                    jax.tree.leaves(jout["params"])):
        assert str(g.dtype).removeprefix("torch.") == np.asarray(w).dtype.name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=1e-5,
                                   atol=1e-5)
