"""The head-dim rule of the port's attention kernels, on the CPU.

On the card every attention wrapper zero-pads head_dim to the next
kernel instance (64, 128 or 192; ``repro_torch.kernels.head_dim``) with
the TRUE head_dim's softmax scale, and the serving pool is allocated at
the padded width. The kernels run only on the card, so this file holds
what makes the padding exact on their plain versions: each plain version
run on padded inputs with the true scale and sliced equals the unpadded
one to the bit in f32 (zero columns add exact zeros), and the padded
columns' gradients are exactly 0. Also: D > 192 raises; the two dense
configs the rule unblocks (stablelm-12b, head_dim 160, and command-r-35b)
equal the JAX package's field by field; and a 2-layer dense model at
head_dim 160 agrees with the JAX package on bridged weights (loss and
grads at the tolerances of tests/test_torch_train.py, a paged prefill and
decode step at those of tests/test_torch_models.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import lm_paged_decode_step as jax_decode
from repro.models.registry import lm_paged_prefill_chunk as jax_prefill
from repro_torch.bridge import params_from_numpy
from repro_torch.common.pytree import tree_flatten, tree_unflatten
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.kernels import ops as kops
from repro_torch.kernels.head_dim import (HEAD_DIMS, pad_head_dim,
                                         padded_head_dim)
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_fwd_ref,
                                     paged_attention_ref)
from repro_torch.models.registry import build_model
from repro_torch.models.registry import lm_paged_decode_step as decode
from repro_torch.models.registry import lm_paged_prefill_chunk as prefill
from repro_torch.models.transformer import paged_pool_head_dim
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: head dims below, at and between the instances, and stablelm-12b's 160
DIMS = [40, 64, 72, 160, 192]


def _randn(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def test_padded_head_dim_rule():
    assert HEAD_DIMS == (64, 128, 192)
    assert [padded_head_dim(d) for d in (1, 40, 64, 65, 72, 128, 129, 160,
                                         192)] == \
        [64, 64, 64, 128, 128, 128, 192, 192, 192]
    x = torch.ones(2, 3, 40)
    assert pad_head_dim(x, 40) is x
    y = pad_head_dim(x, 64)
    assert y.shape == (2, 3, 64) and bool((y[..., 40:] == 0).all())


@pytest.mark.parametrize("D", [193, 256])
def test_head_dim_above_192_raises(D):
    with pytest.raises(ValueError, match=r"\(64, 128, 192\)"):
        padded_head_dim(D)
    with pytest.raises(ValueError, match="does not pad"):
        pad_head_dim(torch.zeros(1, 200), 192)


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("window,cap", [(None, 0.0), (24, 15.0)])
def test_padded_flash_forward_is_exact(D, window, cap):
    rng = np.random.RandomState(D)
    q, k, v = _randn(rng, 2, 80, 4, D), _randn(rng, 2, 80, 2, D), \
        _randn(rng, 2, 80, 2, D)
    Dp = padded_head_dim(D)
    opts = dict(window=window, logit_softcap=cap, sm_scale=D ** -0.5)
    want_o, want_l = flash_attention_fwd_ref(q, k, v, **opts)
    got_o, got_l = flash_attention_fwd_ref(
        *(pad_head_dim(x, Dp) for x in (q, k, v)), **opts)
    assert torch.equal(got_o[..., :D], want_o)
    assert torch.equal(got_l, want_l)
    assert bool((got_o[..., D:] == 0).all())


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("window,cap", [(None, 0.0), (24, 15.0)])
def test_padded_flash_backward_is_exact(D, window, cap):
    rng = np.random.RandomState(100 + D)
    q, k, v = _randn(rng, 2, 80, 4, D), _randn(rng, 2, 80, 2, D), \
        _randn(rng, 2, 80, 2, D)
    dout = _randn(rng, 2, 80, 4, D)
    Dp = padded_head_dim(D)
    opts = dict(window=window, logit_softcap=cap, sm_scale=D ** -0.5)
    out, lse = flash_attention_fwd_ref(q, k, v, **opts)
    want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **opts)
    got = flash_attention_bwd_ref(
        *(pad_head_dim(x, Dp) for x in (q, k, v, out)), lse,
        pad_head_dim(dout, Dp), **opts)
    for g, w in zip(got, want):
        assert torch.equal(g[..., :D], w)
        assert bool((g[..., D:] == 0).all())       # padded columns: 0 grads


@pytest.mark.parametrize("D", DIMS)
def test_padded_flash_autograd_grads_of_pad_are_zero(D):
    """Autograd through the plain forward and backward on padded leaves
    (the shape ``ops.flash_attention`` hands the autograd function on
    the card): the padded columns of q, k and v get exactly 0."""
    rng = np.random.RandomState(200 + D)
    Dp = padded_head_dim(D)
    leaves = [pad_head_dim(_randn(rng, 1, 48, 4, D), Dp).requires_grad_(True),
              pad_head_dim(_randn(rng, 1, 48, 2, D), Dp).requires_grad_(True),
              pad_head_dim(_randn(rng, 1, 48, 2, D), Dp).requires_grad_(True)]
    out = kops.FlashAttention.apply(*leaves, None, 0.0, D ** -0.5)
    grads = torch.autograd.grad(out[..., :D].square().sum(), leaves)
    for g in grads:
        assert bool(torch.isfinite(g).all())
        assert bool((g[..., D:] == 0).all())


@pytest.mark.parametrize("D", DIMS)
@pytest.mark.parametrize("window,cap", [(None, 0.0), (16, 30.0)])
def test_padded_paged_attention_is_exact(D, window, cap):
    rng = np.random.RandomState(300 + D)
    B, Hq, Hkv, ps, TW = 4, 8, 2, 4, 6
    lens = torch.tensor([0, 1, 13, 23], dtype=torch.int32)
    q = _randn(rng, B, Hq, D)
    k_pages, v_pages = _randn(rng, 1 + B * TW, ps, Hkv, D), \
        _randn(rng, 1 + B * TW, ps, Hkv, D)
    tables = torch.from_numpy(
        (1 + np.arange(B * TW).reshape(B, TW)).astype(np.int32))
    Dp = padded_head_dim(D)
    opts = dict(window=window, logit_softcap=cap, sm_scale=D ** -0.5)
    want = paged_attention_ref(q, k_pages, v_pages, tables, lens, **opts)
    got = paged_attention_ref(
        *(pad_head_dim(x, Dp) for x in (q, k_pages, v_pages)), tables, lens,
        **opts)
    assert torch.equal(got[..., :D], want)
    assert bool((got[..., D:] == 0).all())
    # the wrapper's CPU path is the plain version at the true head_dim
    assert torch.equal(paged_attention_cuda(q, k_pages, v_pages, tables,
                                            lens, **opts), want)


def _fields(cfg):
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("arch", ["stablelm-12b", "command-r-35b"])
def test_dense_configs_equal_jax(arch):
    assert arch in ARCH_IDS
    assert _fields(get_config(arch)) == _fields(jax_get_config(arch))
    assert _fields(get_smoke_config(arch)) == \
        _fields(jax_smoke_config(arch))


def test_stablelm_pool_head_dim():
    """The serving pool is allocated at the kernel instance where the
    paged kernel runs, at the true head_dim elsewhere."""
    cfg = get_config("stablelm-12b").with_(attn_impl="flash_pallas")
    assert cfg.resolved_head_dim == 160
    assert paged_pool_head_dim(cfg, "cuda") == 192
    assert paged_pool_head_dim(cfg, torch.device("cuda:0")) == 192
    assert paged_pool_head_dim(cfg, "cpu") == 160
    assert paged_pool_head_dim(cfg.with_(attn_impl="naive"), "cuda") == 160
    assert paged_pool_head_dim(get_config("granite-3-2b").with_(
        attn_impl="flash_pallas"), "cuda") == 64


#: a 2-layer dense model at head_dim 160 (stablelm-12b's), 2/1 heads
HD160 = dict(d_model=320, n_heads=2, n_kv_heads=1)


def _hd160(impl):
    jcfg = jax_smoke_config("stablelm-12b").with_(attn_impl=impl, **HD160)
    cfg = get_smoke_config("stablelm-12b").with_(attn_impl=impl, **HD160)
    assert cfg.resolved_head_dim == 160
    return jcfg, cfg


@pytest.mark.parametrize("impl", ["naive", "flash_pallas"])
def test_head_dim_160_loss_and_grads_match_jax(impl):
    jcfg, cfg = _hd160(impl)
    jlm = jax_build_model(jcfg.with_(remat="full"))
    jparams = jax.device_get(jax.jit(jlm.init)(jax.random.key(0)))
    rng = np.random.RandomState(160)
    tok = rng.randint(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    tgt = rng.randint(0, jcfg.vocab_size, (2, 48)).astype(np.int32)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jlm.loss, has_aux=True))(
        jparams, {"tokens": jnp.asarray(tok), "targets": jnp.asarray(tgt)})

    lm = build_model(cfg.with_(remat="full"))
    leaves, treedef = tree_flatten(params_from_numpy(jparams, device="cpu"))
    live = [x.requires_grad_(True) for x in leaves]
    loss, _ = lm.loss(tree_unflatten(treedef, live),
                      {"tokens": torch.from_numpy(tok),
                       "targets": torch.from_numpy(tgt)})
    grads = torch.autograd.grad(loss, live)
    assert abs(float(loss.detach()) - float(jloss)) <= 1e-5
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_head_dim_160_paged_prefill_and_decode_match_jax():
    jcfg, cfg = _hd160("flash_pallas")
    jlm = jax_build_model(jcfg)
    jparams = jlm.init(jax.random.key(1))
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    B, ps, TW, chunk, n_valid, slot = 2, 4, 8, 16, 13, 1
    NP = 1 + B * TW
    tables = np.zeros((B, TW), np.int32)
    tables[slot, :5] = np.arange(3, 8)
    tokens = np.random.RandomState(2).randint(
        0, cfg.vocab_size, (1, chunk)).astype(np.int32)
    tol = dict(rtol=1e-4, atol=1e-4)

    jcaches, _ = jlm.init_paged_cache(B, NP, ps)
    jl, jcaches = jax_prefill(jcfg, jparams, jcaches,
                              {"tokens": jnp.asarray(tokens)},
                              jnp.int32(n_valid), jnp.int32(slot),
                              jnp.asarray(tables), ps)
    lm = build_model(cfg)
    caches = lm.init_paged_cache(B, NP, ps, device="cpu")
    assert caches[0]["pages"]["k"].shape[-1] == 160      # true D on the CPU
    tl, caches = prefill(cfg, params, caches,
                         {"tokens": torch.from_numpy(tokens)}, n_valid, slot,
                         torch.from_numpy(tables), ps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)

    tok = np.asarray([4, int(np.argmax(np.asarray(jl)))], np.int32)
    pos = np.asarray([0, n_valid], np.int32)
    jl2, jcaches = jax_decode(jcfg, jparams, jcaches, jnp.asarray(tok),
                              jnp.asarray(pos), jnp.asarray(tables), ps)
    tl2, caches = decode(cfg, params, caches, torch.from_numpy(tok),
                         torch.from_numpy(pos), torch.from_numpy(tables), ps)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **tol)
    assert int(tl2[1].argmax()) == int(np.argmax(np.asarray(jl2)[1]))
    for c, jc in zip(caches, jcaches):
        for name in ("k", "v"):
            np.testing.assert_allclose(c["pages"][name][:, 1:].numpy(),
                                       np.asarray(jc["pages"][name])[:, 1:],
                                       **tol)
