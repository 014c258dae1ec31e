"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's on the CPU, at both MoE archs' smoke configs in f32, on the
same bridged parameters and the same numpy inputs made from a seed:

- ``moe_forward``: out within rtol = atol = 1e-5, the router loss within
  1e-6 relatively, the routing (``top_i``) equal;
- ``moe_forward_capacity`` at full capacity and at a capacity that drops
  pairs, at the same tolerances;
- the layer's gradients (router, experts, shared experts, the input)
  against ``jax.grad`` at 1e-5;
- an 8-step HWA Trainer run of granite-moe's smoke model against the
  JAX Trainer on its batches, per-step losses and W̿ within 1e-5;
- the layer under ``remat`` "full" and "dots": loss and gradients
  bit-equal to no remat (the routing is recomputed to the same bits);
- the launchers with a MoE ``--arch`` on the CPU, and where the
  expert-parallel layer is reached (``tests/test_torch_ep.py`` holds it
  against the reference's).

The differences come from the order in which XLA's and torch's CPU
matmuls add (measured <= 5e-7 on out, 0 on aux here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import HWAConfig as JaxHWAConfig
from repro.data import DataPipeline as JaxPipeline
from repro.data import make_markov_lm_dataset as jax_markov
from repro.models import moe as jax_moe
from repro.models.registry import build_model as jax_build_model
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import Trainer as JaxTrainer
from repro.train import lm_task as jax_lm_task
from repro_torch.bridge import params_from_numpy
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.core.hwa import HWAConfig
from repro_torch.models import moe
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import Task, TrainConfig, Trainer, lm_task
from test_torch_train import _Injected, _record
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["granite-moe-1b-a400m", "qwen2-moe-a2.7b"]
TOL = dict(rtol=1e-5, atol=1e-5)


def _layer(arch):
    """Layer 0's MoE parameters of the reference's smoke init (numpy),
    the JAX and port configs, and a (2, 16, D) input."""
    jcfg = jax_smoke_config(arch)
    jparams = jax.device_get(jax_build_model(jcfg).init(jax.random.key(0)))
    p = {k: v[0] for k, v in jparams["stack"][0]["moe"].items()}
    x = np.random.RandomState(1).randn(2, 16, jcfg.d_model).astype(np.float32)
    return jcfg, get_smoke_config(arch), p, x


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_forward_matches_jax(arch):
    jcfg, cfg, p, x = _layer(arch)
    jout, jaux = jax.jit(lambda p, x: jax_moe.moe_forward(jcfg, p, x))(
        p, jnp.asarray(x))
    _, jtop_i, _ = jax_moe._route(jcfg, p, jnp.asarray(x.reshape(-1,
                                                                 x.shape[-1])))
    tp = params_from_numpy(p, device="cpu")
    out, aux = moe.moe_forward(cfg, tp, torch.from_numpy(x))
    _, top_i, _ = moe._route(cfg, tp, torch.from_numpy(x.reshape(-1,
                                                                 x.shape[-1])))
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jtop_i))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_moe_forward_capacity_matches_jax(arch, capacity_factor):
    """Capacity dispatch at a capacity every expert fits in (8.0: equal
    to the dropless ``moe_forward`` too) and at one that drops pairs."""
    jcfg, cfg, p, x = _layer(arch)
    jout, jaux = jax.jit(lambda p, x: jax_moe.moe_forward_capacity(
        jcfg, p, x, capacity_factor))(p, jnp.asarray(x))
    tp = params_from_numpy(p, device="cpu")
    xt = torch.from_numpy(x)
    out, aux = moe.moe_forward_capacity(cfg, tp, xt, capacity_factor)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    # the case is what it says: pairs dropped, or none
    N = x.shape[0] * x.shape[1]
    C = max(int(N * cfg.top_k * capacity_factor) // cfg.n_experts, 8)
    _, top_i, _ = moe._route(cfg, tp, xt.reshape(N, -1))
    most = int(torch.bincount(top_i.reshape(-1)).max())
    assert (most > C) == (capacity_factor < 1)
    dropless, _ = moe.moe_forward(cfg, tp, xt)
    assert torch.allclose(out, dropless, **TOL) == (capacity_factor > 1)


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_grads_match_jax(arch):
    """d(sum(out * cot) + aux) for every leaf of the layer and its input:
    router and shared-expert gate (f32), experts, shared experts."""
    jcfg, cfg, p, x = _layer(arch)
    cot = np.random.RandomState(2).randn(*x.shape).astype(np.float32)

    def jloss(p, x):
        out, aux = jax_moe.moe_forward(jcfg, p, x)
        return jnp.sum(out * cot) + aux
    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x))

    tp = {k: v.requires_grad_(True)
          for k, v in params_from_numpy(p, device="cpu").items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe.moe_forward(cfg, tp, xt)
    names = sorted(tp)
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum() + aux,
                                [tp[n] for n in names] + [xt])
    for n, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[n]), **TOL,
                                   err_msg=n)
    np.testing.assert_allclose(grads[-1].numpy(), np.asarray(jgx), **TOL)
    assert "router" in names and ("sh_route" in names) == (arch != ARCHS[0])


def test_moe_hwa_trainer_matches_jax():
    """granite-moe's smoke model through 8 HWA steps (K=2, H=2, I=3, the
    fused sync's plain version): per-step losses, W̿ after each sync and
    the evaluations within 1e-5 of the JAX Trainer's."""
    arch, K, H, I, steps = ARCHS[0], 2, 2, 3, 8
    jcfg = jax_smoke_config(arch)
    jlm = jax_build_model(jcfg)
    jpipe = JaxPipeline(jax_markov(vocab=jcfg.vocab_size, seq_len=32,
                                   n_train=64, n_test=16, seed=0),
                        batch_size=8, n_replicas=K, seed=0)
    jtc = JaxTrainConfig(method="hwa", total_steps=steps, batch_size=8,
                         base_lr=0.3, hwa=JaxHWAConfig(
                             n_replicas=K, sync_period=H, window=I,
                             use_kernels=True))
    jt = JaxTrainer(jax_lm_task(jlm, jpipe), jtc)
    jlog = {"loss": [], "wa": []}
    _record(jt, jlog, lambda t: [np.asarray(x, np.float32)
                                 for x in jax.tree.leaves(t)])
    jout = jt.run()

    jparams = jax.device_get(jlm.init(jax.random.key(jtc.seed)))
    lm = build_model(get_smoke_config(arch))
    task = Task(init=lambda: params_from_numpy(jparams, device="cpu"),
                loss_fn=lm_task(lm, None).loss_fn, pipeline=_Injected(jpipe))
    t = Trainer(task, TrainConfig(method="hwa", total_steps=steps,
                                  batch_size=8, base_lr=0.3,
                                  hwa=HWAConfig(n_replicas=K, sync_period=H,
                                                window=I, use_kernels=True)))
    log = {"loss": [], "wa": []}
    _record(t, log, lambda tree: [x.float().numpy().copy()
                                  for x in tree_leaves(tree)])
    out = t.run()

    assert len(log["loss"]) == steps and len(log["wa"]) == steps // H
    np.testing.assert_allclose(log["loss"], jlog["loss"], **TOL)
    for got, want in zip(log["wa"], jlog["wa"]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
    np.testing.assert_allclose([h["test_loss"] for h in out["history"]],
                               [h["test_loss"] for h in jout["history"]],
                               **TOL)
    assert log["loss"][-1] < log["loss"][0]


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_moe_remat_matches_no_remat(remat):
    """The MoE layer under ``remat`` recomputes the same routing: loss
    and gradients bit-equal to ``remat="none"``."""
    from repro_torch.common.pytree import tree_flatten, tree_unflatten
    tok = torch.from_numpy(np.random.RandomState(3).randint(0, 128, (2, 16)))
    res = {}
    for r in ("none", remat):
        lm = build_model(get_smoke_config(ARCHS[1]).with_(remat=r))
        leaves, treedef = tree_flatten(lm.init(
            torch.Generator().manual_seed(0), device="cpu"))
        live = [x.requires_grad_(True) for x in leaves]
        loss, m = lm.loss(tree_unflatten(treedef, live),
                          {"tokens": tok, "targets": tok})
        res[r] = [loss.detach(), m["aux"].detach(),
                  *torch.autograd.grad(loss, live)]
    assert all(torch.equal(a, b) for a, b in zip(res["none"], res[remat]))


def test_moe_launchers_on_cpu(capsys):
    from repro_torch.launch.serve import main as serve
    from repro_torch.launch.train import main as train
    serve(["--arch", ARCHS[1], "--device", "cpu", "--batch", "2",
           "--prompt-len", "8", "--new-tokens", "4"])
    train(["--arch", ARCHS[0], "--device", "cpu", "--steps", "2", "--k", "2",
           "--window", "3", "--sync-period", "2", "--batch-size", "8",
           "--seq-len", "16"])
    out = capsys.readouterr().out
    assert f"[serve:paged] {ARCHS[1]} on cpu: generated (2, 4)" in out
    assert f"[{ARCHS[0]}/hwa] step 2" in out and "on cpu: final" in out


def test_moe_sharded_paths_raise():
    """``expert_parallel=True`` selects nothing where no sharding rules
    apply, as in the reference (its mesh-native path included): the
    model builds and its layer is :func:`moe_forward`'s, bit for bit. The
    rules split the experts over ``model`` only for a train step built
    with ``expert_parallel`` (``bundles.replica_layout``, the layer then
    ``moe_forward_ep``), which refuses a config without the flag and a
    model axis that does not divide the experts."""
    from repro_torch.launch.mesh import MeshLayout
    from repro_torch.launch.sync.bundles import replica_layout
    from repro_torch.launch.sync.topology import Flat
    from repro_torch.models.parallel import experts_split
    cfg = get_smoke_config(ARCHS[0])
    ep = cfg.with_(expert_parallel=True)
    build_model(ep)
    params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                   device="cpu")
    p = {k: v[0] for k, v in params["stack"][0]["moe"].items()}
    x = torch.randn(2, 4, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    want, aux = moe.moe_forward(cfg, p, x)
    got, aux_ep = moe.moe_forward(ep, p, x)
    assert torch.equal(got, want) and torch.equal(aux_ep, aux)
    mesh = MeshLayout({"replica": 2, "model": 2})

    def w_gate(layout):
        return layout.places["stack"][0]["moe"]["w_gate"].spec
    plain = replica_layout(build_model(ep), mesh, Flat("replica"))
    assert not experts_split(plain.places)
    assert w_gate(plain) == (None, None, None, "model")     # mlp split
    split = replica_layout(build_model(ep), mesh, Flat("replica"),
                           expert_parallel=True)
    assert experts_split(split.places)
    assert w_gate(split) == (None, "model", None, None)     # experts split
    with pytest.raises(ValueError, match="expert_parallel=True"):
        replica_layout(build_model(cfg), mesh, Flat("replica"),
                       expert_parallel=True)
    with pytest.raises(ValueError, match="dividing them"):
        replica_layout(build_model(ep.with_(n_experts=3)), MeshLayout(
            {"replica": 2, "model": 2}), Flat("replica"),
            expert_parallel=True)