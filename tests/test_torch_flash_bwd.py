"""The flash backward of the port on the CPU: the plain recompute
backward (``kernels.ref.flash_attention_bwd_ref``, what the CUDA sweeps
are held to on the card) against the JAX package's Pallas backward
sweeps in interpret mode, and the port's differentiable
``kernels.ops.flash_attention`` (the ``autograd.Function``) against
autograd through ``naive_attention``. Both run the flash test matrix of
tests/test_attention_ops.py with its tolerances (``_tols``: 3e-2 bf16,
2e-5 f32, rtol = atol). Inputs are made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import flash_attention_bwd as fab
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_fwd_ref)
from repro_torch.models.attention import naive_attention
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
    """q, k, v in ``dtype`` and an f32 cotangent w, as (jax, torch) pairs."""
    rng = np.random.RandomState(seed + S + D)
    arrs = [rng.randn(B, S, Hq, D), rng.randn(B, S, Hkv, D),
            rng.randn(B, S, Hkv, D), rng.randn(B, S, Hq, D)]
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jax_in = [jnp.asarray(a, jnp.float32).astype(jdt) for a in arrs[:3]]
    torch_in = [torch.from_numpy(a.astype(np.float32)).to(getattr(torch, dtype))
                for a in arrs[:3]]
    return jax_in, torch_in, jnp.asarray(arrs[3], jnp.float32), \
        torch.from_numpy(arrs[3].astype(np.float32))


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float32)


@pytest.mark.parametrize("S,Hq,Hkv,D,window,cap,dtype", MATRIX, ids=IDS)
def test_plain_backward_matches_jax_pallas(S, Hq, Hkv, D, window, cap, dtype):
    (jq, jk, jv), (tq, tk, tv), jw, tw = _inputs(S, Hq, Hkv, D, dtype)

    def f(q, k, v):
        out = jax_ops.flash_attention(q, k, v, window=window,
                                      logit_softcap=cap, block_q=64,
                                      block_k=64)
        return jnp.sum(out.astype(jnp.float32) * jw)

    want = jax.jit(jax.grad(f, (0, 1, 2)))(jq, jk, jv)
    out, lse = flash_attention_fwd_ref(tq, tk, tv, window=window,
                                       logit_softcap=cap)
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, tw.to(tq.dtype),
                                  window=window, logit_softcap=cap)
    rtol, atol = _tols(dtype)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == tq.dtype
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("S,Hq,Hkv,D,window,cap,dtype", MATRIX, ids=IDS)
def test_autograd_function_matches_naive(S, Hq, Hkv, D, window, cap, dtype):
    _, (tq, tk, tv), _, tw = _inputs(S, Hq, Hkv, D, dtype)
    pos = torch.arange(S)[None].expand(B, -1)

    def grads(fn):
        leaves = [x.clone().requires_grad_(True) for x in (tq, tk, tv)]
        out = fn(*leaves)
        return torch.autograd.grad((out.float() * tw).sum(), leaves)

    got = grads(lambda q, k, v: kops.flash_attention(
        q, k, v, window=window, logit_softcap=cap))
    want = grads(lambda q, k, v: naive_attention(
        q, k, v, pos, pos, window=window, logit_softcap=cap))
    rtol, atol = _tols(dtype)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(_f32(g), _f32(w), rtol=rtol, atol=atol,
                                   err_msg=name)


def test_fully_masked_rows_get_zero_gradients():
    """Queries past a window's key horizon (S > T): zero dq rows, finite
    dk/dv, no NaN from the NEG_INF lse."""
    S, T, Hq, Hkv, D, window = 128, 64, 4, 2, 64, 16
    rng = np.random.RandomState(3)
    q, k, v, w = (torch.from_numpy(rng.randn(*s).astype(np.float32))
                  for s in ((1, S, Hq, D), (1, T, Hkv, D), (1, T, Hkv, D),
                            (1, S, Hq, D)))
    out, lse = flash_attention_fwd_ref(q, k, v, window=window)
    dq, dk, dv = flash_attention_bwd_ref(q, k, v, out, lse, w, window=window)
    dead = np.arange(S) - (T - 1) >= window
    assert dead.any() and not dead.all()
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all()
    assert not dq.numpy()[:, dead].any()


def test_cpu_backward_launches_nothing():
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, 32, 4, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 32, 2, 16).astype(np.float32))
    before = (fa.LAUNCHES, fab.DQ_LAUNCHES, fab.DKV_LAUNCHES)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, k)]
    kops.flash_attention(*leaves, window=8).sum().backward()
    assert all(x.grad is not None for x in leaves)
    assert (fa.LAUNCHES, fab.DQ_LAUNCHES, fab.DKV_LAUNCHES) == before
