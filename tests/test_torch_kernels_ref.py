"""The port's plain kernel versions (``repro_torch.kernels.ref``) against
the JAX Pallas kernels run in interpret mode on the CPU, with the JAX
reference tests' tolerances: paged 2e-2 bf16 / 2e-5 f32
(test_paged_attention.py), flash 3e-2 bf16 / 2e-5 f32
(test_attention_ops.py). Inputs are made with numpy from a seed and
handed to both packages. Also: the kernel wrappers take the plain
version for CPU tensors and count no launch there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _flash_forward
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.models.cache import TRASH_PAGE, paged_table_width
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as kops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.ref import (flash_attention_fwd_ref,
                                     paged_attention_ref)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray(arr, jnp.float32).astype(jdt)
    return x, torch.from_numpy(np.asarray(arr, np.float32)).to(tdt)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


# ------------------------------------------------------------ paged


def _ring_fill(ks, vs, lens, ps, TW):
    """Host simulation of the engine's write path (the reference test's)."""
    B = ks.shape[0]
    NP = 1 + B * TW
    k_pages = np.zeros((NP, ps) + ks.shape[2:], ks.dtype)
    v_pages = np.zeros_like(k_pages)
    tables = np.full((B, TW), TRASH_PAGE, np.int32)
    nxt = 1
    for b in range(B):
        for pos in range(int(lens[b])):
            j = (pos // ps) % TW
            if tables[b, j] == TRASH_PAGE:
                tables[b, j] = nxt
                nxt += 1
            k_pages[tables[b, j], pos % ps] = ks[b, pos]
            v_pages[tables[b, j], pos % ps] = vs[b, pos]
    return k_pages, v_pages, tables


# the reference's 8-case matrix: (page_size, window, Hkv, G, dtype, lens)
PAGED_CASES = [
    (4, None, 2, 2, "float32", (12, 7)),
    (2, None, 2, 1, "float32", (9, 2)),
    (8, None, 1, 4, "float32", (17, 8)),
    (4, 5, 2, 2, "float32", (12, 3)),
    (4, 16, 2, 2, "float32", (33, 16)),     # eviction: len >> window
    (2, 7, 4, 1, "float32", (21, 1)),
    (4, None, 2, 2, "bfloat16", (13, 6)),
    (4, 16, 2, 4, "bfloat16", (33, 9)),
]


@pytest.mark.parametrize("ps,window,Hkv,G,dtype,lens", PAGED_CASES)
def test_paged_ref_matches_jax_pallas(ps, window, Hkv, G, dtype, lens):
    lens = np.asarray(lens, np.int32)
    B, Smax, Hq, D = len(lens), int(lens.max()), Hkv * G, 16
    TW = paged_table_width(64, window, ps)
    rng = np.random.RandomState(int(lens.sum()))
    q = rng.randn(B, Hq, D)
    k_pages, v_pages, tables = _ring_fill(rng.randn(B, Smax, Hkv, D),
                                          rng.randn(B, Smax, Hkv, D),
                                          lens, ps, TW)
    jq, tq = _pair(q, dtype)
    jk, tk = _pair(k_pages, dtype)
    jv, tv = _pair(v_pages, dtype)
    want = jax_paged(jq, jk, jv, jnp.asarray(tables), jnp.asarray(lens),
                     window=window, logit_softcap=30.0, impl="pallas",
                     interpret=True)
    got = paged_attention_ref(tq, tk, tv, torch.from_numpy(tables),
                              torch.from_numpy(lens), window=window,
                              logit_softcap=30.0)
    assert got.dtype == DTYPES[dtype][1]
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def test_paged_ref_zero_len_slot_matches_jax_pallas():
    """An inactive slot (len 0, all-trash table) gives zeros in both, even
    over a pool that is not zero."""
    B, Hkv, G, D, ps, TW = 2, 2, 2, 16, 4, 3
    rng = np.random.RandomState(0)
    q = rng.randn(B, Hkv * G, D)
    pool = rng.randn(1 + TW, ps, Hkv, D)
    tables = np.full((B, TW), TRASH_PAGE, np.int32)
    tables[0] = [1, 2, 3]
    lens = np.asarray([5, 0], np.int32)
    jq, tq = _pair(q, "float32")
    jp, tp = _pair(pool, "float32")
    want = jax_paged(jq, jp, jp, jnp.asarray(tables), jnp.asarray(lens),
                     impl="pallas", interpret=True)
    got = paged_attention_ref(tq, tp, tp, torch.from_numpy(tables),
                              torch.from_numpy(lens))
    assert np.isfinite(_f32(got)).all()
    assert not _f32(got)[1].any()
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ flash


FLASH_CASES = [
    # S, Hq, Hkv, D, window, cap, dtype, block (divides S for the Pallas grid)
    (64, 4, 4, 64, None, 0.0, "float32", 32),
    (80, 4, 2, 64, None, 0.0, "float32", 16),       # ragged: not a 64 multiple
    (64, 4, 2, 72, None, 0.0, "float32", 32),       # head_dim 72
    (64, 4, 1, 64, None, 0.0, "float32", 32),       # G = 4
    (80, 4, 2, 64, 24, 15.0, "float32", 16),        # window + softcap
    (64, 4, 4, 72, 16, 0.0, "float32", 32),
    (64, 4, 2, 64, None, 0.0, "bfloat16", 32),
    (80, 4, 1, 64, 32, 15.0, "bfloat16", 16),
]


@pytest.mark.parametrize("S,Hq,Hkv,D,window,cap,dtype,block", FLASH_CASES)
def test_flash_ref_matches_jax_pallas(S, Hq, Hkv, D, window, cap, dtype,
                                      block):
    B = 2
    rng = np.random.RandomState(S + D + Hkv)
    jq, tq = _pair(rng.randn(B, S, Hq, D), dtype)
    jk, tk = _pair(rng.randn(B, S, Hkv, D), dtype)
    jv, tv = _pair(rng.randn(B, S, Hkv, D), dtype)
    want_o, want_lse = _flash_forward(jq, jk, jv, True, window, cap, block,
                                      block, D ** -0.5, True)
    got_o, got_lse = flash_attention_fwd_ref(tq, tk, tv, window=window,
                                             logit_softcap=cap)
    assert got_o.dtype == DTYPES[dtype][1]
    assert tuple(got_lse.shape) == (B, Hq, S)
    tol = 3e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_f32(got_o), _f32(want_o), rtol=tol, atol=tol)
    np.testing.assert_allclose(_f32(got_lse), _f32(want_lse), rtol=tol,
                               atol=tol)


def test_flash_ref_fully_masked_rows_match_jax_pallas():
    """Queries past a window's key horizon (S > T): O = 0 and lse = NEG_INF
    in both."""
    S, T, Hq, Hkv, D, window = 128, 64, 4, 2, 64, 16
    rng = np.random.RandomState(3)
    jq, tq = _pair(rng.randn(1, S, Hq, D), "float32")
    jk, tk = _pair(rng.randn(1, T, Hkv, D), "float32")
    jv, tv = _pair(rng.randn(1, T, Hkv, D), "float32")
    want_o, want_lse = _flash_forward(jq, jk, jv, True, window, 0.0, 64, 64,
                                      D ** -0.5, True)
    got_o, got_lse = flash_attention_fwd_ref(tq, tk, tv, window=window)
    dead = np.arange(S) - (T - 1) >= window
    assert dead.any()
    assert not _f32(got_o)[:, dead].any()
    assert (_f32(got_lse)[:, :, dead] == -1e30).all()
    np.testing.assert_allclose(_f32(got_o), _f32(want_o), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(_f32(got_lse), _f32(want_lse), rtol=2e-5,
                               atol=2e-5)


# ------------------------------------------------- wrappers on the CPU


def test_wrappers_take_plain_version_on_cpu_without_launching():
    rng = np.random.RandomState(0)
    q = torch.from_numpy(rng.randn(1, 32, 4, 16).astype(np.float32))
    k = torch.from_numpy(rng.randn(1, 32, 2, 16).astype(np.float32))
    flash_before, paged_before = fa.LAUNCHES, pa.LAUNCHES
    out = kops.flash_attention(q, k, k, window=8, logit_softcap=5.0)
    want, _ = flash_attention_fwd_ref(q, k, k, window=8, logit_softcap=5.0)
    torch.testing.assert_close(out, want, rtol=0, atol=0)

    pages = torch.from_numpy(rng.randn(3, 4, 2, 16).astype(np.float32))
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    lens = torch.tensor([6], dtype=torch.int32)
    got = pa.paged_attention(q[:, 0], pages, pages, tables, lens,
                             impl="kernel")
    want = paged_attention_ref(q[:, 0], pages, pages, tables, lens)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (fa.LAUNCHES, pa.LAUNCHES) == (flash_before, paged_before)
