"""Serving tier of the PyTorch port against the JAX reference: the page
manager's reservation/ring-reuse/defrag invariants (port copies of the
reference's tests), the continuous scheduler's tokens on the reference's
random ragged trace (equal to JAX's PagedDecodeEngine on the same
bridged parameters), and a CPU rehearsal of ``chip_smoke.py``'s serving
phase."""
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from repro.models.registry import build_model as jax_build_model
from repro.serve.engine import PagedDecodeEngine as JaxPagedDecodeEngine
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.models.cache import TRASH_PAGE
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import PagedDecodeEngine
from repro_torch.serve.pages import PageManager
from repro_torch.serve.scheduler import ContinuousScheduler, Request
from test_torch_models import smoke_configs
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------- page manager


def test_page_manager_reservation_and_ring_reuse():
    pm = PageManager(n_pages=8, page_size=4, table_width=3, max_slots=2)
    assert pm.pages_needed(4 * 3 + 5) == 3          # capped at the ring
    assert pm.can_admit(24)
    s0 = pm.admit(24)                                # reserves 3
    assert pm.available_pages == 4
    s1 = pm.admit(24)
    assert not pm.can_admit(4)                       # slots exhausted
    # lazy assignment: one page per first ring-slot touch, then reuse
    assert pm.touch(s0, 0) and pm.touch(s0, 4) and pm.touch(s0, 8)
    assert not pm.touch(s0, 12)                      # ring wrap: reuse
    assert pm.tables[s0, 0] != TRASH_PAGE
    pm.release(s0)
    assert all(pm.tables[s0] == TRASH_PAGE)
    assert pm.can_admit(24)
    pm.release(s1)
    assert pm.free_pages == 7


def test_page_manager_defrag_preserves_contents():
    pm = PageManager(n_pages=12, page_size=2, table_width=2, max_slots=3)
    slots = [pm.admit(8) for _ in range(3)]
    for s in slots:
        pm.touch_range(s, 0, 8)
    pm.release(slots[1])                             # punch a hole
    pool = np.arange(12 * 2 * 3, dtype=np.float32).reshape(12, 2, 3)
    before = {(s, j): pool[pm.tables[s, j]].copy()
              for s in (slots[0], slots[2]) for j in range(2)}
    perm = pm.defrag()
    assert perm[TRASH_PAGE] == TRASH_PAGE
    assert sorted(int(p) for row in pm.tables[[slots[0], slots[2]]]
                  for p in row) == [1, 2, 3, 4]      # compacted to front
    new_pool = pool[np.argsort(perm)]                # engine's re-gather
    for (s, j), want in before.items():
        np.testing.assert_array_equal(new_pool[pm.tables[s, j]], want)


def test_engine_apply_page_perm_matches_defrag():
    cfg = get_smoke_config("gemma2-27b").with_(attn_impl="flash_pallas")
    lm = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    params = lm.init(gen, device="cpu")
    tokens = np.random.RandomState(1).randint(0, cfg.vocab_size, (2, 9))
    eng = PagedDecodeEngine(lm=lm, params=params, max_batch=2,
                            max_seq_len=64, max_new=6, page_size=4,
                            prefill_chunk=16, device="cpu")
    a = eng.generate({"tokens": tokens}, 3).numpy()
    perm = eng.pages.defrag()
    eng.apply_page_perm(perm)
    b = eng.generate({"tokens": tokens}, 3).numpy()
    np.testing.assert_array_equal(a, b)


# ------------------------------------------- scheduler parity with JAX


def _trace(vocab, seed, prompt=(2, 13)):
    """The reference's random ragged trace (test_paged_attention.py):
    prompt lengths in [prompt[0], prompt[1])."""
    rng = np.random.RandomState(seed)
    return [dict(rid=i,
                 tokens=rng.randint(0, vocab,
                                    size=(int(rng.randint(*prompt)),)
                                    ).astype(np.int32),
                 n_new=int(rng.randint(1, 7)),
                 arrival=int(rng.randint(0, 6)))
            for i in range(7)]


def _assert_trace_equals_jax_engine(arch, seed, prompt=(2, 13),
                                    prefill_chunk=16):
    jcfg, cfg = smoke_configs(arch)
    jcfg = jcfg.with_(attn_impl="flash_pallas")
    jlm = jax_build_model(jcfg)
    jparams = jlm.init(jax.random.key(0))
    trace = _trace(jcfg.vocab_size, seed, prompt)
    kw = dict(max_batch=3, max_seq_len=64, max_new=8, page_size=4,
              prefill_chunk=prefill_chunk)

    jeng = JaxPagedDecodeEngine(lm=jlm, params=jparams, **kw)
    want = JaxScheduler(jeng).run([JaxRequest(**r) for r in trace],
                                  max_steps=600)

    cfg = cfg.with_(attn_impl="flash_pallas")
    params = params_from_numpy(jax.device_get(jparams), device="cpu")
    eng = PagedDecodeEngine(lm=build_model(cfg), params=params,
                            device="cpu", **kw)
    got = ContinuousScheduler(eng).run([Request(**r) for r in trace],
                                       max_steps=600)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")


@pytest.mark.parametrize("arch,seed", [("granite-3-2b", 0),
                                       ("gemma2-27b", 1),
                                       ("granite-moe-1b-a400m", 2),
                                       ("qwen2-moe-a2.7b", 3),
                                       ("xlstm-125m", 4),
                                       ("hymba-1.5b", 5),
                                       ("command-r-35b", 6),
                                       ("command-r-35b-g8", 7)])
def test_scheduler_random_trace_equals_jax_engine(arch, seed):
    """The port's scheduler + engine emit tokens EQUAL to the JAX
    PagedDecodeEngine's on the same bridged parameters, both under
    attn_impl='flash_pallas' (JAX: interpret-mode Pallas; port: the
    kernels' plain versions on the CPU). The recurrent stacks (xlstm,
    hymba) take the prefix fill and the step prefill, and the 7
    requests over 3 slots reuse slots, so ``reset_paged_states`` and the
    prefix fill's overwrite both run. ``command-r-35b-g8``: 8 query
    heads a KV head."""
    _assert_trace_equals_jax_engine(arch, seed)


@pytest.mark.parametrize("seed", [8, 9])
def test_scheduler_long_prompts_bind_gemma2_window(seed):
    """gemma2's smoke model (window 16 on its local layers) on prompts of
    20-40 tokens in one 40-token chunk: the window binds in every
    prefill and decode step of a local layer, while the global layers
    see the whole history; tokens EQUAL to the JAX engine's."""
    _assert_trace_equals_jax_engine("gemma2-27b", seed, prompt=(20, 41),
                                    prefill_chunk=40)


# ------------------------------------------ chip_smoke rehearsal on CPU


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_serving_phase_on_cpu():
    """chip_smoke.py's serving and trace phases at smoke size on the CPU:
    the same control flow (12 requests through 8 slots, evictions and
    admissions mid-run, token range and finite logits); the launch-count
    checks and device times apply on the card only."""
    smoke = _chip_smoke()
    cfg = get_smoke_config("granite-3-2b").with_(attn_impl="flash_pallas")
    res, eng = smoke.phase_serve("cpu", cfg=cfg, page_size=4,
                                 prefill_chunk=16, max_new=4, max_seq_len=24,
                                 prompt_range=(2, 16))
    assert res["requests"] == 12
    assert res["admissions"] == 12
    assert res["mid_run_admissions"] > 0
    assert res["decode_steps"] > 0
    assert res["tokens"] == 12 * 4
    smoke.phase_trace("cpu", eng, res, n_steps=2, prompt_len=8)


def test_chip_smoke_phase14_on_cpu(monkeypatch):
    """chip_smoke.py's phase 14 at smoke size on the CPU: gemma2 (window
    16) served with prompts past its window over 4 slots and command-r
    with phase 4's control flow, both traced; each cut to 2 layers,
    kernel path against plain path in f32 and bf16 with gemma2's window
    binding; gemma2's DecodeEngine against the paged engine past the
    window. Launch counts, parameter counts and device memory apply on
    the card only."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "get_config", get_smoke_config)
    small = dict(page_size=4, max_new=10)
    out = smoke.phase_large(
        "cpu",
        serve_over={"gemma2-27b": dict(small, prefill_chunk=48,
                                       max_seq_len=64, prompt_range=(20, 40)),
                    "command-r-35b": dict(small, prefill_chunk=16,
                                          max_seq_len=32,
                                          prompt_range=(2, 16))},
        reference={"gemma2-27b": dict(prompt_len=40, chunk=48),
                   "command-r-35b": dict(prompt_len=12, chunk=16)},
        decode=dict(batch=2, prompt=40, new=4))
    g2, cr = out["serve"]["gemma2-27b"], out["serve"]["command-r-35b"]
    assert g2["admissions"] == 6 and g2["mid_run_admissions"] > 0
    assert min(g2["prompt_lens"]) > get_smoke_config(
        "gemma2-27b").sliding_window
    assert cr["admissions"] == 12 and cr["mid_run_admissions"] > 0
    assert len(out["reference"]["command-r-35b"]) == 2
    assert out["decode_engine"]["tokens_equal"]
