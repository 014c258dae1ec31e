"""W̿ published from the trainer into the paged engine, in the port and
in the JAX reference, on the CPU: ``WeightPublisher`` from a live window
state and from a window-state checkpoint (written by either package)
gives engine params bit-equal to the JAX publisher's, and the engine
then emits the JAX engine's greedy tokens on the reference's random
trace (tests/test_torch_serve.py's harness). A CPU rehearsal of
``chip_smoke.py`` phase 9 closes the file."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.io import save_window_state as jax_save_window_state
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.hwa import HWAConfig as JaxHWAConfig
from repro.core.hwa import hwa_init as jax_hwa_init
from repro.core.offline import window_update as jax_window_update
from repro.models.registry import build_model as jax_build_model
from repro.optim import sgd as jax_sgd
from repro.serve.engine import PagedDecodeEngine as JaxPagedDecodeEngine
from repro.serve.publish import WeightPublisher as JaxPublisher
from repro.serve.scheduler import ContinuousScheduler as JaxScheduler
from repro.serve.scheduler import Request as JaxRequest
from repro_torch.bridge import hwa_state_from_numpy, params_from_numpy
from repro_torch.checkpoint.io import save_window_state
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import PagedDecodeEngine
from repro_torch.serve.publish import WeightPublisher, wa_snapshot
from repro_torch.serve.scheduler import ContinuousScheduler, Request
from test_torch_serve import _trace
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(max_batch=3, max_seq_len=64, max_new=8, page_size=4,
          prefill_chunk=16)


def _window(jcfg, kind="ring", pushes=4):
    """A JAX HWA state whose window (I = 3) took ``pushes`` outer weights
    (the init plus seeded noise), and the same state in the port."""
    jlm = jax_build_model(jcfg)
    jparams = jlm.init(jax.random.key(0))
    jst = jax_hwa_init(JaxHWAConfig(n_replicas=2, window=3,
                                    window_kind=kind), jparams,
                       jax_sgd(momentum=0.9))
    ws = jst.window_state
    rng = np.random.RandomState(1)
    for _ in range(pushes):
        outer = jax.tree.map(lambda x: (x.astype(jnp.float32) + 0.01 * jnp.asarray(
            rng.randn(*x.shape).astype(np.float32))).astype(x.dtype), jparams)
        ws, _ = jax_window_update(ws, outer)
    jst = jax.device_get(jst.__class__(
        inner=jst.inner, inner_opt=jst.inner_opt, window_state=ws,
        wa=jst.wa, cycle=jst.cycle, step=jst.step))
    return jlm, jparams, jst, hwa_state_from_numpy(jst, device="cpu")


def _engines(jcfg, jlm, jparams):
    cfg = get_smoke_config("granite-3-2b").with_(attn_impl=jcfg.attn_impl,
                                                 dtype=jcfg.dtype)
    jeng = JaxPagedDecodeEngine(lm=jlm, params=jparams, **KW)
    eng = PagedDecodeEngine(lm=build_model(cfg),
                            params=params_from_numpy(
                                jax.device_get(jparams), device="cpu"),
                            device="cpu", **KW)
    return jeng, eng


def _assert_params_equal(got, want):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name
        np.testing.assert_array_equal(
            g.contiguous().reshape(-1).view(torch.uint8).numpy(),
            np.ascontiguousarray(w).reshape(-1).view(np.uint8))


@pytest.mark.parametrize("dtype,kind", [("float32", "ring"),
                                        ("bfloat16", "ring"),
                                        ("float32", "streaming")])
def test_publish_window_state_equals_jax(dtype, kind):
    jcfg = jax_smoke_config("granite-3-2b").with_(dtype=dtype)
    jlm, jparams, jst, st = _window(jcfg, kind)
    jeng, eng = _engines(jcfg, jlm, jparams)
    jpub, pub = JaxPublisher(engine=jeng), WeightPublisher(engine=eng)
    old = eng.params
    new = pub.publish_window_state(st.window_state)
    want = jpub.publish_window_state(jst.window_state)
    assert eng.params is new and pub._standby is old
    assert pub.n_published == 1
    _assert_params_equal(new, want)
    buf, spec = wa_snapshot(st.window_state)
    assert buf.dtype == torch.float32 and buf.shape == (spec.padded,)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_publish_checkpoint_equals_jax(tmp_path, writer):
    """publish_checkpoint of a window-state file written by either package
    gives the params the JAX publisher gives from the same file."""
    jcfg = jax_smoke_config("granite-3-2b").with_(dtype="bfloat16")
    jlm, jparams, jst, st = _window(jcfg)
    path = str(tmp_path / "ws.npz")
    if writer == "jax":
        jax_save_window_state(path, jst.window_state)
    else:
        save_window_state(path, st.window_state)
    jeng, eng = _engines(jcfg, jlm, jparams)
    want = JaxPublisher(engine=jeng).publish_checkpoint(path)
    got = WeightPublisher(engine=eng).publish_checkpoint(path)
    _assert_params_equal(got, want)
    _assert_params_equal(WeightPublisher(engine=eng)
                         .publish_window_state(st.window_state), want)


def test_tokens_after_publish_equal_jax_engine():
    """After each package publishes W̿ into its engine (attn_impl
    flash_pallas: interpret-mode Pallas in JAX, the kernels' plain
    versions here), the scheduler's greedy tokens on the reference's
    random trace are equal."""
    jcfg = jax_smoke_config("granite-3-2b").with_(attn_impl="flash_pallas")
    jlm, jparams, jst, st = _window(jcfg)
    jeng, eng = _engines(jcfg, jlm, jparams)
    JaxPublisher(engine=jeng).publish_window_state(jst.window_state)
    WeightPublisher(engine=eng).publish_window_state(st.window_state)
    trace = _trace(jcfg.vocab_size, 0)
    want = JaxScheduler(jeng).run([JaxRequest(**r) for r in trace],
                                  max_steps=600)
    got = ContinuousScheduler(eng).run([Request(**r) for r in trace],
                                       max_steps=600)
    assert sorted(got) == sorted(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], np.asarray(want[rid]),
                                      err_msg=f"rid {rid}")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_phase9_on_cpu():
    """chip_smoke.py phase 9 at smoke size on the CPU: the same control
    flow and gates (falling losses, SWA's count, Lookahead's fast = slow,
    the checkpoint round trip, the bit-exact resume, the published params
    and tokens); the launch counts and
    device times apply on the card only."""
    smoke = _chip_smoke()
    cfg = get_smoke_config("granite-3-2b").with_(attn_impl="flash_pallas")
    runs = smoke.phase_baselines("cpu", cfg=cfg)
    assert sorted(runs) == sorted(smoke.BASELINES["methods"])
    assert runs["swa"]["swa_n"] == 2
    ck = smoke.phase_checkpoint("cpu", cfg=cfg)
    # one save; the run resumed from it saves nothing more
    assert len(ck["gb_per_save"]) == 1 and len(ck["save_s"]) == 1
    from repro_torch.core.offline import window_init, window_update
    lm = build_model(cfg)
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    ws = window_init(params, 3)
    for s in range(2):
        gen = torch.Generator().manual_seed(10 + s)
        ws, _ = window_update(ws, lm.init(gen, device="cpu"))
    res = smoke.phase_publish_serve(
        "cpu", {"final_window": ws}, cfg=cfg, page_size=4, prefill_chunk=16,
        max_new=4, max_seq_len=24, prompt_range=(2, 16))
    assert res["admissions"] == 12
