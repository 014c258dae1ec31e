"""The paper's ResNet-CIFAR in the port against the JAX reference on the
CPU: ``SAME`` convolutions at both strides and both parities of the
input size, ``apply_resnet``'s logits and new BN state in train and eval
mode, the gradients of ``resnet_loss``, ``recompute_bn_stats``, the
prototype image set's properties, and a 4-step HWA run of ResNet-8 with
the BN state in the averaged tree (the reference example's loop, rebuilt
here) on the reference's init and batches. Tolerances, all f32:

- forward, BN state, recompute: |got - want| <= 1e-5 x the largest
  |want| of the tensor (XLA and PyTorch add the convolutions' and the
  BN reductions' terms in other orders; measured 9.3e-7);
- gradients: the same rule at 1e-4, the port's gradient tolerance
  (tests/test_torch_train.py; measured 1.2e-6);
- the HWA run: W̿ and the per-step losses within 1e-5 (rtol = atol),
  the HWA Trainer's tolerance (tests/test_torch_train.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import HWAConfig as JaxHWAConfig
from repro.core import hwa_init as jax_hwa_init
from repro.core import hwa_inner_step as jax_hwa_inner_step
from repro.core import hwa_sync as jax_hwa_sync
from repro.core.bnstats import recompute_bn_stats as jax_recompute
from repro.data import make_prototype_image_dataset as jax_proto
from repro.data.pipeline import replica_batch_indices as jax_batch_indices
from repro.models import convnet as jc
from repro.optim import cosine_schedule as jax_cosine
from repro.optim import sgd as jax_sgd
from repro_torch.bridge import params_from_numpy
from repro_torch.common.pytree import tree_flatten, tree_leaves, \
    tree_unflatten
from repro_torch.core.bnstats import recompute_bn_stats
from repro_torch.core.hwa import HWAConfig, hwa_init, hwa_inner_step, \
    hwa_sync
from repro_torch.data import make_prototype_image_dataset
from repro_torch.launch.resnet_cifar import ResNetCifarConfig, \
    train_resnet_cifar
from repro_torch.models import convnet as tc
from repro_torch.models.registry import build_model
from repro_torch.optim import cosine_schedule, sgd
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _close(got, want, rel):
    """|got - want| <= rel x max|want| over the whole tensor."""
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _trees_close(got, want, rel):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        _close(g, w, rel)


@functools.cache
def _jax_model(image_size, n_classes=10, depth=8):
    cfg = jc.resnet_cifar_config(depth=depth, n_classes=n_classes,
                                 image_size=image_size)
    params, state = jax.device_get(jc.init_resnet(cfg, jax.random.key(0)))
    return cfg, params, state


def _images(n, size, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, size, size, 3)) * 1.5 + 0.3
            ).astype(np.float32)


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("stride", [1, 2])
def test_same_conv_matches_xla(size, stride):
    """``padding="SAME"``: at stride 2 an even input pads 0 before and 1
    after, an odd one 1 on both sides."""
    rng = np.random.default_rng(size + stride)
    x = _images(2, size)
    w = rng.standard_normal((3, 3, 3, 5)).astype(np.float32)
    want = jc._conv(jnp.asarray(x), jnp.asarray(w), stride)
    got = tc._conv(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert tuple(got.shape) == want.shape
    _close(got, want, 1e-5)
    if stride == 2 and size % 2 == 0:
        # symmetric padding reads other pixels: the explicit pad matters
        sym = torch.nn.functional.conv2d(
            torch.from_numpy(x).permute(0, 3, 1, 2),
            torch.from_numpy(w).permute(3, 2, 0, 1), stride=2, padding=1)
        assert not np.allclose(sym.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-3)


@pytest.mark.parametrize("size", [8, 7])
@pytest.mark.parametrize("train", [True, False])
def test_apply_resnet_matches_jax(size, train):
    cfg, params, state = _jax_model(size)
    x = _images(6, size)
    if not train:       # a non-trivial running state: one train apply's
        _, state = jax.device_get(jc.apply_resnet(cfg, params, state,
                                                  jnp.asarray(x), True))
    want_logits, want_state = jc.apply_resnet(cfg, params, state,
                                              jnp.asarray(x), train)
    tcfg = tc.resnet_cifar_config(depth=8, n_classes=10, image_size=size)
    logits, new_state = tc.apply_resnet(
        tcfg, params_from_numpy(params, device="cpu"),
        params_from_numpy(state, device="cpu"), torch.from_numpy(x), train)
    assert tuple(logits.shape) == (6, 10)
    _close(logits, want_logits, 1e-5)
    _trees_close(new_state, want_state, 1e-5)


def test_resnet_loss_grads_match_jax():
    cfg, params, state = _jax_model(8)
    x = _images(8, 8)
    y = np.random.default_rng(3).integers(0, 10, 8).astype(np.int32)
    batch = {"tokens": jnp.asarray(x), "targets": jnp.asarray(y)}
    (jloss, jm), jgrads = jax.value_and_grad(
        lambda p: jc.resnet_loss(cfg, p, state, batch), has_aux=True)(params)

    tcfg = tc.resnet_cifar_config(depth=8, n_classes=10, image_size=8)
    leaves, treedef = tree_flatten(params_from_numpy(params, device="cpu"))
    live = [t.requires_grad_(True) for t in leaves]
    loss, m = tc.resnet_loss(tcfg, tree_unflatten(treedef, live),
                             params_from_numpy(state, device="cpu"),
                             {"tokens": torch.from_numpy(x),
                              "targets": torch.from_numpy(y)})
    grads = torch.autograd.grad(loss, live)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert float(m["acc"]) == float(jm["acc"])
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        _close(g, w, 1e-4)


def test_recompute_bn_stats_matches_jax():
    cfg, params, state = _jax_model(8)
    x = 5.0 + _images(32, 8, seed=4)
    want = jax_recompute(cfg, params, state,
                         [jnp.asarray(x[:16]), jnp.asarray(x[16:])])
    tcfg = tc.resnet_cifar_config(depth=8, n_classes=10, image_size=8)
    got = recompute_bn_stats(tcfg, params_from_numpy(params, device="cpu"),
                             params_from_numpy(state, device="cpu"),
                             [torch.from_numpy(x[:16]),
                              torch.from_numpy(x[16:])])
    _trees_close(got, want, 1e-5)
    assert float(got["stem_bn"]["mean"].abs().max()) > 1e-3


def test_build_model_rejects_convnet():
    with pytest.raises(ValueError, match="convnet"):
        build_model(tc.resnet_cifar_config(depth=8))
    with pytest.raises(ValueError, match="6n\\+2"):
        tc.resnet_cifar_config(depth=9)


# ------------------------------------------------------------ data


def _centroid_stats(x, y, n_classes, x_eval, y_eval):
    """(accuracy of nearest-class-mean on the eval split, the residual's
    std about the class means)."""
    x, x_eval = x.reshape(len(x), -1), x_eval.reshape(len(x_eval), -1)
    cent = np.stack([x[y == c].mean(0) for c in range(n_classes)])
    pred = ((x_eval[:, None] - cent[None]) ** 2).sum(-1).argmin(1)
    return float((pred == y_eval).mean()), float((x - cent[y]).std())


def test_prototype_dataset_properties():
    kw = dict(n_classes=10, image_size=8, n_train=4000, n_test=1000,
              noise=0.6, label_noise=0.1)
    ds = make_prototype_image_dataset(seed=3, device="cpu", **kw)
    assert tuple(ds.train_inputs.shape) == (4000, 8, 8, 3)
    assert tuple(ds.test_inputs.shape) == (1000, 8, 8, 3)
    assert ds.train_inputs.dtype == torch.float32
    assert ds.train_targets.dtype == torch.int32 and ds.kind == "image"
    for t in (ds.train_targets, ds.test_targets):
        assert int(t.min()) >= 0 and int(t.max()) < 10
        assert len(torch.unique(t)) == 10
    again = make_prototype_image_dataset(seed=3, device="cpu", **kw)
    assert torch.equal(ds.train_inputs, again.train_inputs)
    assert torch.equal(ds.train_targets, again.train_targets)
    other = make_prototype_image_dataset(seed=4, device="cpu", **kw)
    assert not torch.equal(ds.train_inputs, other.train_inputs)

    # in distribution like the reference's set: clean test labels are
    # read off the class means, the train labels agree with them but for
    # the flipped share (0.1 x 9/10 change class), the noise is 0.6
    jds = jax.device_get(jax_proto(seed=3, **kw))
    for d, to_np in ((ds, lambda t: t.numpy()), (jds, np.asarray)):
        xtr, ytr = to_np(d.train_inputs), to_np(d.train_targets)
        xte, yte = to_np(d.test_inputs), to_np(d.test_targets)
        acc, resid = _centroid_stats(xte, yte, 10, xte, yte)
        assert acc == 1.0
        assert abs(resid - 0.6) < 0.02
        agree, _ = _centroid_stats(xte, yte, 10, xtr, ytr)
        assert 0.88 < agree < 0.94


# ------------------------------------------------------- the HWA loop


@pytest.mark.parametrize("use_kernels", [False, True])
def test_resnet_hwa_matches_jax_loop(use_kernels):
    """The reference example's loop (examples/resnet_cifar_hwa.py) at
    ResNet-8, K = 2, 4 steps with a sync every 2 (I = 3), the BN state in
    the averaged tree: the port on the reference's init and batches."""
    K, B, H, steps, size = 2, 8, 2, 4, 8
    cfg, params, bn_state = _jax_model(size)
    jds = jax_proto(n_classes=10, image_size=size, n_train=64, n_test=16,
                    noise=0.6, label_noise=0.05)
    jopt = jax_sgd(momentum=0.9, weight_decay=5e-4)
    jsched = jax_cosine(0.1, steps)
    jcfg = JaxHWAConfig(n_replicas=K, sync_period=H, window=3,
                        use_kernels=use_kernels)
    jstate = jax_hwa_init(jcfg, {"p": params, "bn": bn_state}, jopt)
    data_key = jax.random.key(1)

    def jloss(bundle, batch):
        return jc.resnet_loss(cfg, bundle["p"], bundle["bn"], batch)

    def jbatches(step):
        def batch_for(r):
            idx = jax_batch_indices(data_key, r, step, jds.n_train, B)
            return {"tokens": jnp.take(jds.train_inputs, idx, 0),
                    "targets": jnp.take(jds.train_targets, idx, 0)}
        return jax.vmap(batch_for)(jnp.arange(K))

    @jax.jit
    def jinner(state, batches, step):
        state, m = jax_hwa_inner_step(jcfg, state, batches, jloss, jopt,
                                      jsched(step))
        return state, m["loss"]

    tcfg = tc.resnet_cifar_config(depth=8, n_classes=10, image_size=size)
    hcfg = HWAConfig(n_replicas=K, sync_period=H, window=3,
                     use_kernels=use_kernels)
    opt = sgd(momentum=0.9, weight_decay=5e-4)
    sched = cosine_schedule(0.1, steps)
    state = hwa_init(hcfg, params_from_numpy({"p": params, "bn": bn_state},
                                             device="cpu"), opt)

    def loss_fn(bundle, batch):
        return tc.resnet_loss(tcfg, bundle["p"], bundle["bn"], batch)

    n_sync = 0
    for step in range(steps):
        batches = jbatches(step)
        jstate, jl = jinner(jstate, batches, step)
        state, m = hwa_inner_step(
            hcfg, state, params_from_numpy(jax.device_get(batches),
                                           device="cpu"),
            loss_fn, opt, sched(step))
        np.testing.assert_allclose(float(m["loss"]), float(jl), rtol=1e-5,
                                   atol=1e-5)
        if (step + 1) % H == 0:
            jstate, _ = jax_hwa_sync(jcfg, jstate)
            state, _ = hwa_sync(hcfg, state)
            n_sync += 1
            for g, w in zip(tree_leaves(state.wa),
                            jax.tree.leaves(jstate.wa)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-5)
    assert n_sync == 2
    # the unused BN leaves moved by weight decay alone, as in JAX
    assert not torch.equal(state.wa["bn"]["stem_bn"]["var"],
                           torch.ones_like(state.wa["bn"]["stem_bn"]["var"]))


def test_resnet_cifar_launcher_cpu():
    """The port's launcher (repro_torch.launch.resnet_cifar) end to end at
    a small size: finite, falling loss; W̿ with recomputed BN statistics
    well above chance."""
    lines = []
    out = train_resnet_cifar(
        ResNetCifarConfig(depth=8, epochs=3, n_train=256, n_test=128,
                          image_size=8, use_kernels=True),
        "cpu", log=lines.append)
    hist = out["history"]
    assert len(hist) == 3 and len(lines) == 3
    assert len(out["losses"]) == 3 * (256 // 32)
    assert all(np.isfinite(out["losses"]))
    assert hist[-1]["train_loss"] < 0.7 * hist[0]["train_loss"]
    assert hist[-1]["wa_acc"] > 0.5
    assert len(out["times"]["sync_ms"]) == 3
