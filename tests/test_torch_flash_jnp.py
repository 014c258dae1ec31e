"""The port's ``attn_impl="flash_jnp"`` (the reference's blockwise
online-softmax path with its recompute backward, in plain PyTorch) and
``remat="dots"`` against the JAX package on the CPU.

- ``flash_attention_jnp``: forward and (dq, dk, dv) against the
  reference's ``flash_attention_jnp`` over the flash test matrix of
  tests/test_attention_ops.py, at 64-row blocks (several blocks a
  sequence, the banded window path included) and at the default 512,
  with that file's tolerances (``_tols``: 3e-2 bf16, 2e-5 f32,
  rtol = atol);
- ``remat="dots"``: the loss and every gradient bit-equal to
  ``remat="full"`` in the port (a product saved or recomputed gives the
  same bits), fewer products recomputed in the backward than under
  ``"full"``, and the model against the reference's ``remat="dots"``
  model within tests/test_torch_train.py's tolerance (loss 1e-5, grads
  rtol = atol = 1e-4).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.attention import flash_attention_jnp as jax_flash_jnp
from repro.models.registry import build_model as jax_build_model
from repro_torch.bridge import params_from_numpy
from repro_torch.common.pytree import tree_flatten, tree_unflatten
from repro_torch.configs import get_smoke_config
from repro_torch.models.attention import _pick_block, flash_attention_jnp, \
    run_attention
from repro_torch.models.registry import build_model
from repro_torch.models.transformer import _DOT_OPS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = 2

# tests/test_attention_ops.py MATRIX: S, Hq, Hkv, D, window, cap, dtype
MATRIX = [
    (64, 4, 4, 64, None, 0.0, "float32"),
    (80, 4, 2, 64, None, 0.0, "float32"),
    (256, 4, 2, 64, None, 0.0, "float32"),
    (128, 4, 2, 128, None, 0.0, "float32"),
    (128, 4, 2, 72, None, 0.0, "float32"),
    (128, 4, 4, 64, None, 0.0, "float32"),
    (128, 4, 1, 64, None, 0.0, "float32"),
    (128, 4, 2, 64, 32, 0.0, "float32"),
    (128, 4, 2, 64, None, 15.0, "float32"),
    (128, 4, 2, 64, 24, 15.0, "float32"),
    (160, 4, 1, 72, 48, 8.0, "float32"),
    (128, 4, 2, 64, None, 0.0, "bfloat16"),
    (128, 4, 4, 64, 32, 15.0, "bfloat16"),
]
IDS = [f"S{c[0]}-H{c[1]}kv{c[2]}-D{c[3]}-w{c[4]}-cap{c[5]}-{c[6]}"
       for c in MATRIX]


def _tols(dtype):
    return (3e-2, 3e-2) if dtype == "bfloat16" else (2e-5, 2e-5)


def _inputs(S, Hq, Hkv, D, dtype, seed=0):
    """q, k, v in ``dtype`` and an f32 cotangent w, as (jax, torch)."""
    rng = np.random.RandomState(seed + S + D)
    arrs = [rng.randn(B, S, Hq, D), rng.randn(B, S, Hkv, D),
            rng.randn(B, S, Hkv, D), rng.randn(B, S, Hq, D)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jax_in = [jnp.asarray(a, jnp.float32).astype(jdt) for a in arrs[:3]]
    torch_in = [torch.from_numpy(a.astype(np.float32)).to(
        getattr(torch, dtype)) for a in arrs[:3]]
    return jax_in, torch_in, jnp.asarray(arrs[3], jnp.float32), \
        torch.from_numpy(arrs[3].astype(np.float32))


def _f32(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("block", [64, 512])
@pytest.mark.parametrize("S,Hq,Hkv,D,window,cap,dtype", MATRIX, ids=IDS)
def test_flash_jnp_matches_jax(S, Hq, Hkv, D, window, cap, dtype, block):
    (jq, jk, jv), (tq, tk, tv), jw, tw = _inputs(S, Hq, Hkv, D, dtype)

    def f(q, k, v):
        out = jax_flash_jnp(q, k, v, window=window, logit_softcap=cap,
                            q_block=block, k_block=block)
        return jnp.sum(out.astype(jnp.float32) * jw), out

    (_, want_out), want = jax.jit(jax.value_and_grad(
        f, (0, 1, 2), has_aux=True))(jq, jk, jv)
    leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
    out = flash_attention_jnp(*leaves, window=window, logit_softcap=cap,
                              q_block=block, k_block=block)
    got = torch.autograd.grad((out.float() * tw).sum(), leaves)
    rtol, atol = _tols(dtype)
    assert out.dtype == tq.dtype
    np.testing.assert_allclose(_f32(out), _f32(want_out), rtol=rtol,
                               atol=atol, err_msg="out")
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tq.dtype
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=rtol, atol=atol,
                                   err_msg=name)


def test_pick_block_is_the_references():
    from repro.models.attention import _pick_block as jax_pick
    for n in (1, 7, 40, 64, 80, 96, 128, 160, 300, 512, 576, 1024, 4096):
        for target in (64, 128, 512):
            assert _pick_block(n, target) == jax_pick(n, target)


def test_run_attention_routes_flash_jnp():
    (_, (tq, tk, tv), _, _) = _inputs(128, 4, 2, 64, "float32")
    pos = torch.arange(128)
    got = run_attention("flash_jnp", tq, tk, tv, pos, pos, window=32)
    want = flash_attention_jnp(tq, tk, tv, window=32)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="unknown attn_impl"):
        run_attention("flash", tq, tk, tv, pos, pos)


# ------------------------------------------------------------ remat


@functools.cache
def _jax_params():
    cfg = jax_smoke_config("granite-3-2b").with_(dtype="float32")
    return jax.device_get(jax.jit(jax_build_model(cfg).init)(
        jax.random.key(0)))


def _batch(S, vocab, seed=0):
    rng = np.random.RandomState(seed + S)
    return (rng.randint(0, vocab, (2, S)).astype(np.int32),
            rng.randint(0, vocab, (2, S)).astype(np.int32))


class _CountDots(TorchDispatchMode):
    """Counts the products (``_DOT_OPS``) dispatched while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in _DOT_OPS
        return func(*args, **(kwargs or {}))


def _port_loss_grads(cfg, tok, tgt, count=None):
    lm = build_model(cfg)
    leaves, treedef = tree_flatten(params_from_numpy(_jax_params(),
                                                     device="cpu"))
    live = [x.requires_grad_(True) for x in leaves]
    loss, _ = lm.loss(tree_unflatten(treedef, live),
                      {"tokens": torch.from_numpy(tok),
                       "targets": torch.from_numpy(tgt)})
    if count is None:
        return loss.detach(), torch.autograd.grad(loss, live)
    with count:
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), grads


@pytest.mark.parametrize("impl", ["flash_jnp", "flash_pallas", "naive"])
def test_remat_dots_bitwise_equals_full(impl):
    cfg = get_smoke_config("granite-3-2b").with_(attn_impl=impl,
                                                 dtype="float32")
    tok, tgt = _batch(128, cfg.vocab_size)
    out, counts = {}, {}
    for remat in ("full", "dots", "none"):
        counts[remat] = _CountDots()
        out[remat] = _port_loss_grads(cfg.with_(remat=remat), tok, tgt,
                                      counts[remat])
    (lf, gf), (ld, gd) = out["full"], out["dots"]
    assert torch.equal(lf, ld)
    for a, b in zip(gf, gd):
        assert torch.equal(a, b)
    # "dots" keeps the layers' products: its backward recomputes fewer of
    # them than "full" and more than "none" only where an attention
    # Function's forward runs again
    assert counts["none"].n <= counts["dots"].n < counts["full"].n


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_flash_jnp_model_matches_jax(remat):
    """The ModelConfig default (attn_impl="flash_jnp") at 1,024 tokens
    (two 512-row blocks), loss and grads against the reference's model
    under the same remat."""
    jcfg = jax_smoke_config("granite-3-2b").with_(
        attn_impl="flash_jnp", remat=remat, dtype="float32")
    cfg = get_smoke_config("granite-3-2b").with_(
        attn_impl="flash_jnp", remat=remat, dtype="float32")
    assert cfg.attn_impl == type(cfg)(
        name="x", family="dense", n_layers=1, d_model=8, n_heads=1,
        n_kv_heads=1, d_ff=8, vocab_size=8).attn_impl
    tok, tgt = _batch(1024, cfg.vocab_size)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        jax_build_model(jcfg).loss, has_aux=True))(
        _jax_params(), {"tokens": jnp.asarray(tok),
                        "targets": jnp.asarray(tgt)})
    loss, grads = _port_loss_grads(cfg, tok, tgt)
    assert abs(float(loss) - float(jloss)) <= 1e-5
    for g, w in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)
