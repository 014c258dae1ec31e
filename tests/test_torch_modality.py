"""The VLM (internvl2-1b) and audio (musicgen-medium) families in the
port against the JAX package, on the CPU at their smoke configs in f32,
on bridged parameters and inputs made from a numpy seed (token streams
(B, S, CB) for audio, f32 ``vis_embeds`` (B, n_vis, d_vis) for the VLM),
the reference at its smoke ``attn_impl="naive"``:

- the configs equal the reference's field by field, and the port's own
  init has the JAX init's structure, shapes and dtypes (``vis_proj``,
  the (CB, V, D) embed and (CB, D, V) head);
- ``lm_apply`` logits within rtol = atol = 1e-4, ``lm_loss`` and every
  gradient leaf within 1e-5 (musicgen at S = 1,024 too, where the xent
  is chunked: two 512-token slices of (B, 512, CB) targets);
- the paged engine's tokens equal to the JAX PagedDecodeEngine's on a
  ragged trace whose VLM requests carry ``vis_embeds`` and whose audio
  requests are codebook streams;
- ``apply_delay_pattern`` / ``undo_delay_pattern`` bit-equal to the
  reference's, and the round trip;
- two HWA inner steps and one ``hwa_sync`` over dict batches (tokens,
  targets, vis_embeds with a leading K = 2 axis) within 1e-5;
- the serve launcher with both engines; the train launcher refuses both
  archs, as the reference's does.

The differences come from the order in which XLA's and torch's CPU
matmuls add.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import HWAConfig as JaxHWAConfig
from repro.core import hwa_init as jax_hwa_init
from repro.core import hwa_inner_step as jax_hwa_inner_step
from repro.core import hwa_sync as jax_hwa_sync
from repro.models.registry import build_model as jax_build_model
from repro.optim import sgd as jax_sgd
from repro.serve.engine import PagedDecodeEngine as JaxPagedDecodeEngine
from repro.serve.engine import apply_delay_pattern as jax_apply_delay
from repro.serve.engine import undo_delay_pattern as jax_undo_delay
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.common.pytree import tree_flatten, tree_leaves, \
    tree_unflatten
from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.hwa import HWAConfig, hwa_init, hwa_inner_step, \
    hwa_sync
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models.registry import build_model, init_lm
from repro_torch.optim import sgd
from repro_torch.serve.engine import PagedDecodeEngine, \
    apply_delay_pattern, undo_delay_pattern
from repro_torch.serve.scheduler import ContinuousScheduler, Request
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["internvl2-1b", "musicgen-medium"]
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
TOL = dict(rtol=1e-5, atol=1e-5)


def _models(arch):
    jcfg = jax_smoke_config(arch)
    jlm = jax_build_model(jcfg)
    jparams = jlm.init(jax.random.key(0))
    lm = build_model(get_smoke_config(arch))
    return jlm, jparams, lm, params_from_numpy(jax.device_get(jparams),
                                              device="cpu")


def _batch(cfg, B, S, seed=1, lead=()):
    """numpy tokens/targets ((..., B, S) or (..., B, S, CB)) and, for the
    VLM, f32 vis_embeds; ``lead`` prepends axes (the replicas')."""
    rs = np.random.RandomState(seed)
    cb = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    out = {k: rs.randint(0, cfg.vocab_size, lead + (B, S) + cb)
           .astype(np.int32) for k in ("tokens", "targets")}
    if cfg.family == "vlm":
        out["vis_embeds"] = rs.randn(*lead, B, cfg.n_vis_tokens,
                                     cfg.d_vis).astype(np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_reference(arch):
    assert arch in ARCH_IDS
    for mine, ref in ((get_config(arch), jax_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_layout(arch):
    jparams = jax.device_get(jax_build_model(jax_smoke_config(arch)).init(
        jax.random.key(0)))
    params = init_lm(get_smoke_config(arch), torch.Generator().manual_seed(0),
                     device="cpu")
    jleaves, jdef = jax.tree.flatten(jparams)
    leaves, tdef = jax.tree.flatten(params)
    assert jdef == tdef
    for a, b in zip(jleaves, leaves):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
    assert ("vis_proj" in params) == (arch == "internvl2-1b")
    again = init_lm(get_smoke_config(arch), torch.Generator().manual_seed(0),
                    device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(params),
                                                 tree_leaves(again)))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_jax(arch):
    jlm, jparams, lm, params = _models(arch)
    b = _batch(lm.cfg, 2, 24)
    jlog = np.asarray(jax.jit(jlm.apply)(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})[0])
    log = lm.apply(params, {k: torch.from_numpy(v) for k, v in b.items()}
                   )[0].numpy()
    cb = (lm.cfg.n_codebooks,) if arch == "musicgen-medium" else ()
    assert log.shape == (2, 24) + cb + (lm.cfg.vocab_size,)
    np.testing.assert_allclose(log, jlog, **LOGIT_TOL)


@pytest.mark.parametrize("arch,S", [("internvl2-1b", 24),
                                    ("musicgen-medium", 24),
                                    ("musicgen-medium", 1024)])
def test_loss_and_grads_match_jax(arch, S):
    jlm, jparams, lm, params = _models(arch)
    b = _batch(lm.cfg, 2, S)
    jl, jg = jax.jit(jax.value_and_grad(lambda p, b: jlm.loss(p, b)[0]))(
        jparams, {k: jnp.asarray(v) for k, v in b.items()})
    leaves, treedef = tree_flatten(params)
    live = [x.requires_grad_(True) for x in leaves]
    loss, _ = lm.loss(tree_unflatten(treedef, live),
                      {k: torch.from_numpy(v) for k, v in b.items()})
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(jl), **TOL)
    jgl = jax.tree.leaves(jax.device_get(jg))
    assert len(jgl) == len(grads)
    for g, w in zip(grads, jgl):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


def _trace(cfg, seed):
    """A ragged trace of 5 requests over 2 slots (a slot reused), VLM
    requests with their vis_embeds, audio ones as (S, CB) streams."""
    rs = np.random.RandomState(seed)
    cb = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    out = []
    for i in range(5):
        r = dict(rid=i, tokens=rs.randint(0, cfg.vocab_size,
                                          (int(rs.randint(2, 13)),) + cb)
                 .astype(np.int32),
                 n_new=int(rs.randint(1, 7)), arrival=int(rs.randint(0, 6)))
        if cfg.family == "vlm":
            r["vis_embeds"] = rs.randn(cfg.n_vis_tokens,
                                       cfg.d_vis).astype(np.float32)
        out.append(r)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_engine_equals_jax_engine(arch):
    """Both packages under attn_impl='flash_pallas' (JAX: interpret-mode
    Pallas; port: the kernels' plain versions on the CPU)."""
    jcfg = jax_smoke_config(arch).with_(attn_impl="flash_pallas")
    jlm = jax_build_model(jcfg)
    jparams = jlm.init(jax.random.key(0))
    trace = _trace(jcfg, 7)
    kw = dict(max_batch=2, max_seq_len=40, max_new=8, page_size=4,
              prefill_chunk=16)
    want = JaxScheduler(JaxPagedDecodeEngine(lm=jlm, params=jparams, **kw)
                        ).run([JaxRequest(**r) for r in trace], max_steps=400)
    cfg = get_smoke_config(arch).with_(attn_impl="flash_pallas")
    eng = PagedDecodeEngine(lm=build_model(cfg), device="cpu",
                            params=params_from_numpy(
                                jax.device_get(jparams), device="cpu"), **kw)
    got = ContinuousScheduler(eng).run([Request(**r) for r in trace],
                                       max_steps=400)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")
    if arch == "musicgen-medium":
        assert got[0].shape == (trace[0]["n_new"], cfg.n_codebooks)


def test_delay_pattern_matches_reference():
    x = np.random.RandomState(0).randint(0, 100, (2, 10, 4)).astype(np.int32)
    want = np.asarray(jax_apply_delay(jnp.asarray(x), pad_token=7))
    got = apply_delay_pattern(torch.from_numpy(x), pad_token=7)
    assert got.shape == (2, 13, 4) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    back = undo_delay_pattern(got, 10)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jax_undo_delay(jnp.asarray(want), 10)))
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("arch", ARCHS)
def test_hwa_inner_steps_and_sync_match_jax(arch):
    """K = 2 replicas, two SGD steps (momentum 0.9, weight decay 5e-4)
    over dict batches with a leading K axis, then one sync (f32 ring, the
    fused sync's plain version): per-step losses, the restarted replicas
    and W̿ within 1e-5 of the reference's."""
    K, lr = 2, 0.1
    jlm, jparams, lm, params = _models(arch)
    jcfg = JaxHWAConfig(n_replicas=K, sync_period=2, window=3,
                        use_kernels=True)
    hcfg = HWAConfig(n_replicas=K, sync_period=2, window=3, use_kernels=True)
    jopt, opt = jax_sgd(momentum=0.9, weight_decay=5e-4), \
        sgd(momentum=0.9, weight_decay=5e-4)
    jstate = jax_hwa_init(jcfg, jparams, jopt)
    state = hwa_init(hcfg, params, opt)

    def jloss(p, b):
        return jlm.loss(p, b)

    jinner = jax.jit(lambda s, b: jax_hwa_inner_step(jcfg, s, b, jloss, jopt,
                                                     lr))
    for step in range(2):
        b = _batch(lm.cfg, 2, 16, seed=10 + step, lead=(K,))
        jstate, jm = jinner(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, m = hwa_inner_step(hcfg, state,
                                  params_from_numpy(b, device="cpu"),
                                  lm.loss, opt, lr)
        np.testing.assert_allclose(m["per_replica_loss"].numpy(),
                                   np.asarray(jm["per_replica_loss"]), **TOL)
    jstate, _ = jax.jit(lambda s: jax_hwa_sync(jcfg, s))(jstate)
    state, _ = hwa_sync(hcfg, state)
    for tree, jtree in ((state.wa, jstate.wa), (state.inner, jstate.inner)):
        for g, w in zip(tree_leaves(tree), jax.tree.leaves(jtree)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_on_cpu(arch, capsys):
    for engine in ("naive", "paged"):
        serve_launcher.main(["--device", "cpu", "--arch", arch, "--engine",
                             engine, "--batch", "2", "--prompt-len", "8",
                             "--new-tokens", "4"])
    out = capsys.readouterr().out
    cb = ", 2" if arch == "musicgen-medium" else ""
    for engine in ("naive", "paged"):
        assert f"[serve:{engine}] {arch} on cpu: generated (2, 4{cb})" in out
    with pytest.raises(SystemExit, match="Trainer"):
        train_launcher.main(["--device", "cpu", "--arch", arch, "--steps",
                             "2"])


def test_chip_smoke_phase13_on_cpu(monkeypatch):
    """chip_smoke.py's phase 13 at smoke size on the CPU: 13a's serving
    with vision prefixes and codebook streams and its trace, 13b's
    run-against-run comparison, 13c's DecodeEngine against the paged
    engine, 13d's HWA loop over dict batches (the launch counts and
    device times apply on the card only), and the parameter counts its
    mfu uses against the built trees."""
    from test_torch_serve import _chip_smoke
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "get_config", get_smoke_config)
    monkeypatch.setitem(smoke.TRAIN, "batch", 2)
    monkeypatch.setitem(smoke.TRAIN, "seq", 16)
    monkeypatch.setitem(smoke.MODALITY_TRAIN, "data_vocab", 64)
    for arch in ARCHS:
        cfg = get_smoke_config(arch).with_(attn_impl="flash_pallas")
        reqs = smoke._modality_requests(cfg, 5, (6, 20), 5, 0)
        res, eng = smoke.phase_serve_modality(
            "cpu", cfg, reqs=reqs, max_batch=3, page_size=4,
            prefill_chunk=32)
        assert res["admissions"] == 5 and res["prefix"] == (
            cfg.n_vis_tokens if arch == "internvl2-1b" else 0)
        cb = cfg.n_codebooks if arch == "musicgen-medium" else 1
        assert res["tokens"] == 25 * cb
        trace = smoke.phase_trace_modality("cpu", eng, res, n_steps=2)
        assert trace["traced_wall_ms"] > 0
        out = smoke.phase_modality_reference("cpu", arch, "float32",
                                             page_size=4, prefill_chunk=128)
        assert out["tokens_equal"] and out["steps"] > 0
        dec = smoke.phase_decode_engine("cpu", arch, batch=2, prompt=12,
                                        new=4)
        assert dec["tokens_equal"]
        tr = smoke.phase_train_modality(
            "cpu", cfg.with_(remat="full"), cfg.n_layers)
        assert tr["syncs"] == 3 and len(tr["step_loss"]) == 6
        params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert smoke.train_param_count(cfg) == sum(
            x.numel() for x in tree_leaves(params))
