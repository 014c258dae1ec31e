"""The port's dense LM against the JAX reference on bridged parameters:
one paged prefill chunk and one paged decode step, the granite, gemma2
and command-r smoke configs (command-r also at its published group, 8
query heads a KV head) and both MoE archs' (the padded prefill chunk
routes its pad tokens too) in f32, attn_impl='flash_pallas' on both sides (JAX:
interpret-mode Pallas; port: the kernels' plain versions on the CPU).
Logits and the updated page pools agree to rtol = atol = 1e-4: XLA's and
torch's CPU matmuls sum in different orders. Also: a convnet or unknown
family is refused, and the recurrent archs' configs equal the
reference's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import lm_paged_decode_step as jax_decode
from repro.models.registry import lm_paged_prefill_chunk as jax_prefill
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models.attention import run_attention
from repro_torch.models.registry import build_model, init_lm
from repro_torch.models.registry import lm_paged_decode_step as decode
from repro_torch.models.registry import lm_paged_prefill_chunk as prefill
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOL = dict(rtol=1e-4, atol=1e-4)


#: command-r-35b's published group (64 query heads over 8 KV heads, G =
#: 8) on its smoke width: the ``-g8`` cases
G8 = dict(n_heads=16, n_kv_heads=2)


def smoke_configs(arch):
    """(JAX, port) smoke configs of ``arch``; ``<arch>-g8`` is the arch's
    smoke config at G = 8 (``G8``) on both packages."""
    base = arch.removesuffix("-g8")
    over = G8 if base != arch else {}
    return (jax_smoke_config(base).with_(**over),
            get_smoke_config(base).with_(**over))


def _pools(caches):
    return [np.asarray(c["pages"][k]) for c in caches for k in ("k", "v")]


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-27b",
                                  "granite-moe-1b-a400m", "qwen2-moe-a2.7b",
                                  "command-r-35b", "command-r-35b-g8"])
def test_paged_prefill_and_decode_match_jax(arch):
    jcfg, cfg = smoke_configs(arch)
    jcfg = jcfg.with_(attn_impl="flash_pallas")
    jlm = jax_build_model(jcfg)
    jparams = jlm.init(jax.random.key(0))
    cfg = cfg.with_(attn_impl="flash_pallas")
    lm = build_model(cfg)
    params = params_from_numpy(jax.device_get(jparams), device="cpu")

    B, ps, TW, chunk, n_valid, slot = 3, 4, 16, 32, 27, 1
    NP = 1 + B * TW
    tables = np.zeros((B, TW), np.int32)
    tables[slot, :8] = np.arange(5, 13)
    tables[2, :2] = [20, 21]
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, (1, chunk)).astype(np.int32)

    jcaches, _ = jlm.init_paged_cache(B, NP, ps)
    jl, jcaches = jax_prefill(jcfg, jparams, jcaches,
                              {"tokens": jnp.asarray(tokens)},
                              jnp.int32(n_valid), jnp.int32(slot),
                              jnp.asarray(tables), ps)
    caches = lm.init_paged_cache(B, NP, ps, device="cpu")
    tl, caches = prefill(cfg, params, caches,
                         {"tokens": torch.from_numpy(tokens)}, n_valid, slot,
                         torch.from_numpy(tables), ps)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # the trash page (0) holds the pad tail's writes in an unspecified
    # order on both sides; every real page must agree
    for got, want in zip(_pools(caches), _pools(jcaches)):
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], **TOL)

    # one ragged decode step: slot 1 continues, slot 2 at position 3,
    # slot 0 inactive (pos 0, trash table)
    tok = np.asarray([5, int(np.argmax(np.asarray(jl))), 9], np.int32)
    pos = np.asarray([0, n_valid, 3], np.int32)
    jl2, jcaches = jax_decode(jcfg, jparams, jcaches, jnp.asarray(tok),
                              jnp.asarray(pos), jnp.asarray(tables), ps)
    tl2, caches = decode(cfg, params, caches, torch.from_numpy(tok),
                         torch.from_numpy(pos), torch.from_numpy(tables), ps)
    np.testing.assert_allclose(tl2.numpy(), np.asarray(jl2), **TOL)
    for got, want in zip(_pools(caches), _pools(jcaches)):
        np.testing.assert_allclose(got[:, 1:], want[:, 1:], **TOL)


def test_init_matches_jax_layout():
    """The port's own init gives the JAX parameter tree's structure,
    shapes and dtypes leaf for leaf."""
    for arch in ("granite-3-2b", "gemma2-27b", "granite-moe-1b-a400m",
                 "qwen2-moe-a2.7b", "command-r-35b", "command-r-35b-g8"):
        jcfg, cfg = smoke_configs(arch)
        jparams = jax_build_model(jcfg).init(jax.random.key(0))
        params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
        jleaves, jdef = jax.tree.flatten(jax.device_get(jparams))
        leaves, tdef = jax.tree.flatten(params)
        assert jdef == tdef
        for a, b in zip(jleaves, leaves):
            assert tuple(a.shape) == tuple(b.shape)
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")


def test_unported_paths_raise():
    """Every LM family is ported (the MoE family's sharded paths raise:
    tests/test_torch_moe.py); a convnet config and an unknown family are
    still refused by ``build_model``. ``flash_jnp`` (ported) runs and an
    unknown attention implementation is refused."""
    cfg = get_smoke_config("granite-3-2b")
    q = torch.zeros(1, 8, 4, 16)
    pos = torch.arange(8)
    out = run_attention("flash_jnp", q, q[:, :, :2], q[:, :, :2], pos, pos)
    assert tuple(out.shape) == (1, 8, 4, 16)
    with pytest.raises(ValueError, match="unknown attn_impl"):
        run_attention("flash", q, q[:, :, :2], q[:, :, :2], pos, pos)
    with pytest.raises(ValueError, match="convnet"):
        build_model(cfg.with_(family="convnet"))
    with pytest.raises(NotImplementedError, match="no LM stack"):
        build_model(cfg.with_(family="diffusion"))


@pytest.mark.parametrize("arch", ["xlstm-125m", "hymba-1.5b"])
def test_recurrent_configs_equal_reference(arch):
    """The port's full and smoke configs of the recurrent archs equal the
    reference's ``config()`` and ``smoke_config()`` field by field."""
    import dataclasses
    from repro.configs import get_config as jax_config
    from repro_torch.configs import ARCH_IDS, get_config
    assert arch in ARCH_IDS
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
