"""The port's whole-batch decode path against the JAX package, on the CPU
at the smoke configs in f32 (the reference at its smoke attention,
``naive`` as its own tests run it), on bridged parameters and inputs
made from a numpy seed:

- the contiguous ring cache's functions (``attn_cache_len``,
  ``init_attn_cache``, ``update_attn_cache``, ``cache_positions``)
  bit-equal to the reference's, the ring wrapped;
- ``lm_prefill`` then ``lm_decode_step`` within 2e-4 of the port's own
  teacher forcing (``tests/test_decode_consistency.py``'s test) and
  within 1e-4 of the JAX package's logits at every step, on the
  reference's 7 archs (the windowed rings of gemma2 and hymba wrap: 20
  prompt positions in a ring of 16);
- the port's ``DecodeEngine`` tokens equal to the JAX ``DecodeEngine``'s
  on those 7 archs;
- the port's paged engine bit-equal in greedy tokens to the port's
  ``DecodeEngine`` on all 10 smoke configs, as the reference holds its
  own.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import cache as jcache
from repro.models.registry import build_model as jax_build_model
from repro.serve.engine import DecodeEngine as JaxDecodeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.models import cache
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import DecodeEngine, PagedDecodeEngine
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

#: the reference's tests/test_decode_consistency.py ARCHS
ARCHS = ["granite-3-2b", "gemma2-27b", "xlstm-125m", "hymba-1.5b",
         "musicgen-medium", "internvl2-1b", "qwen2-moe-a2.7b"]


def _batch(cfg, B, S, seed=1):
    rs = np.random.RandomState(seed)
    cb = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    out = {"tokens": rs.randint(0, cfg.vocab_size, (B, S) + cb)
           .astype(np.int32)}
    if cfg.family == "vlm":
        out["vis_embeds"] = rs.randn(B, cfg.n_vis_tokens,
                                     cfg.d_vis).astype(np.float32)
    return out


def _models(arch):
    jlm = jax_build_model(jax_smoke_config(arch))
    jparams = jlm.init(jax.random.key(0))
    lm = build_model(get_smoke_config(arch))
    return jlm, jparams, lm, params_from_numpy(jax.device_get(jparams),
                                              device="cpu")


def test_cache_functions_match_reference():
    assert cache.attn_cache_len(24, None) == jcache.attn_cache_len(24, None)
    assert cache.attn_cache_len(24, 16) == jcache.attn_cache_len(24, 16) \
        == 16
    rs = np.random.RandomState(0)
    B, C, H, D = 2, 5, 2, 4
    c = cache.init_attn_cache(3, B, C, H, D, torch.float32, device="cpu")
    jc, _ = jcache.init_attn_cache(3, B, C, H, D, jnp.float32)
    for k in ("k", "v"):
        assert c[k].shape == jc[k].shape and not c[k].any()
    layer = {k: v[0].clone() for k, v in c.items()}
    jlayer = {k: v[0] for k, v in jc.items()}
    for pos in range(12):                       # wraps the ring twice
        kn, vn = (rs.randn(B, 1, H, D).astype(np.float32) for _ in "kv")
        jlayer = jcache.update_attn_cache(jlayer, jnp.asarray(kn),
                                          jnp.asarray(vn), jnp.int32(pos))
        layer = cache.update_attn_cache(layer, torch.from_numpy(kn),
                                        torch.from_numpy(vn),
                                        torch.tensor(pos, dtype=torch.int32))
        for k in ("k", "v"):
            np.testing.assert_array_equal(layer[k].numpy(),
                                          np.asarray(jlayer[k]))
        for clen in (C, 16):
            np.testing.assert_array_equal(
                cache.cache_positions(clen, torch.tensor(pos)).numpy(),
                np.asarray(jcache.cache_positions(clen, jnp.int32(pos))))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_teacher_forcing_and_jax(arch):
    jlm, jparams, lm, params = _models(arch)
    B, S, Sp = 2, 24, 20
    b = _batch(lm.cfg, B, S)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tf_logits, _ = lm.apply(params, tb)

    pre = dict(tb, tokens=tb["tokens"][:, :Sp])
    jpre = {k: jnp.asarray(v.numpy()) for k, v in pre.items()}
    c = lm.init_cache(B, S, device="cpu")
    jc, _ = jlm.init_cache(B, S)
    logits, c = lm.prefill(params, c, pre)
    jlogits, jc = jax.jit(jlm.prefill)(jparams, jc, jpre)
    assert int(c["pos"]) == int(jc["pos"])
    jdecode = jax.jit(jlm.decode_step)
    errs, jerrs = [], []
    for t in range(Sp, S + 1):
        errs.append(float((logits - tf_logits[:, t - 1]).abs().max()))
        jerrs.append(float(np.abs(logits.numpy() - np.asarray(jlogits))
                           .max()))
        if t == S:
            break
        tok = tb["tokens"][:, t]
        logits, c = lm.decode_step(params, c, tok)
        jlogits, jc = jdecode(jparams, jc, jnp.asarray(tok.numpy()))
    assert max(errs) < 2e-4, errs
    assert max(jerrs) < 1e-4, jerrs


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_engine_equals_jax_engine(arch):
    jlm, jparams, lm, params = _models(arch)
    b = _batch(lm.cfg, 2, 9)
    want = np.asarray(JaxDecodeEngine(lm=jlm, params=jparams,
                                      max_seq_len=64).generate(
        {k: jnp.asarray(v) for k, v in b.items()}, 6))
    got = DecodeEngine(lm=lm, params=params, max_seq_len=64,
                       device="cpu").generate(b, 6)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_paged_engine_matches_decode_engine(arch):
    """The reference's parity test on the port alone: block-table cache,
    chunk or step prefill and the fixed-shape step against the
    whole-batch engine, greedy tokens equal to the bit."""
    lm = build_model(get_smoke_config(arch))
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    b = _batch(lm.cfg, 2, 9)
    want = DecodeEngine(lm=lm, params=params, max_seq_len=64,
                        device="cpu").generate(b, 6).numpy()
    got = PagedDecodeEngine(lm=lm, params=params, max_batch=2,
                            max_seq_len=64, max_new=6, page_size=4,
                            prefill_chunk=16, device="cpu").generate(b, 6)
    np.testing.assert_array_equal(got.numpy(), want)
