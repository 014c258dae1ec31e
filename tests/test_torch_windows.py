"""The port's slide windows against the JAX reference, on the CPU:

- the plain versions of the four WA kernels of slice 3 (the window
  update, the online mean, and their bf16-ring ``*_c`` siblings; what
  the CUDA kernels are held to on the card) at 0 ULP against the
  interpret-mode Pallas kernels, for K = 1-4, I = 1 and 3, full 0 and 1,
  and the fp8 ring's plain update against the jitted reference;
- the per-leaf wrappers on a ragged leaf;
- ``window_update_packed`` over 7 pushes (the I = 3 ring wraps) for
  every kind of window and ring dtype, on both ``use_kernel`` settings;
- ``hwa_sync`` over 5 syncs from bridged state, bitwise, for an f32 ring
  at stride 2, a bf16 ring at strides 1 and 2, an fp8 ring and the
  streaming window, with ``use_kernels`` True and False;
- the 8-step HWA Trainer at ``window_stride=2`` against the JAX
  Trainer, within 1e-5 (the tolerance and its reason are
  tests/test_torch_train.py's).

Inputs are made with numpy from a seed and handed to both packages; the
reference runs under ``jax.jit`` as its sync does."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.packing import pack_spec as jax_pack_spec
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.hwa import HWAConfig as JaxHWAConfig
from repro.core.hwa import hwa_init as jax_hwa_init
from repro.core.hwa import hwa_sync as jax_hwa_sync
from repro.core.offline import window_average_packed as jax_window_average
from repro.core.offline import window_init as jax_window_init
from repro.core.offline import window_update as jax_window_update
from repro.core.offline import window_update_packed as jax_window_update_p
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.kernels.wa_update import (online_mean_2d, wa_sync_fused_c_2d,
                                     wa_window_update_2d,
                                     wa_window_update_c_2d)
from repro.models.registry import build_model as jax_build_model
from repro.optim import sgd as jax_sgd
from repro_torch.bridge import hwa_state_from_numpy, params_from_numpy
from repro_torch.common.packing import ALIGN
from repro_torch.common.pytree import tree_leaves
from repro_torch.core.hwa import HWAConfig, hwa_sync
from repro_torch.core.offline import (window_average_packed, window_init,
                                      window_update, window_update_packed)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref
from repro_torch.kernels import wa_update as wa

from test_torch_train import _Injected, _record
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _bits(x):
    """Bits of a numpy/jax array or a tensor, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            x.element_size()]
        x = x.detach().cpu().view(view).numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[x.itemsize])


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=msg)


def _tiles(a):
    """A packed jnp buffer on the Pallas kernels' (…, rows, 1024) tiling."""
    a = jnp.asarray(a)
    return a.reshape(a.shape[:-1] + (-1, 1024))


def _flat(a, like):
    return np.asarray(a).reshape(like.shape)


def _scal(idx, full, inv):
    return (torch.tensor(idx, dtype=torch.int32), torch.tensor(full),
            torch.tensor(inv))


def _inputs(K, I, seed, ring_dtype=np.float32):
    """stacked (K, P), ring (I, P), total, comp, new (P,), P = 2·ALIGN,
    with signed zeros where XLA's sum order shows."""
    rng = np.random.RandomState(seed)
    P = 2 * ALIGN
    stacked = rng.randn(K, P).astype(np.float32)
    stacked[0, :4] = -0.0
    stacked[:, 4:8] = -0.0
    ring = np.asarray(jnp.asarray(rng.randn(I, P).astype(np.float32),
                                  ring_dtype))
    total = rng.randn(P).astype(np.float32)
    comp = (rng.randn(P) * 1e-6).astype(np.float32)
    new = rng.randn(P).astype(np.float32)
    new[:4] = -0.0
    return stacked, ring, total, comp, new


def _t(a):
    """A writable tensor of a numpy array (bf16 through its bits)."""
    return params_from_numpy(a, device="cpu")


# ----------------------------------------------- the four plain kernels


@pytest.mark.parametrize("I", [1, 3])
@pytest.mark.parametrize("full", [0.0, 1.0])
def test_window_update_plain_is_0ulp_against_pallas(I, full):
    _, ring, total, _, new = _inputs(1, I, 7 * I + int(full))
    idx, inv = I - 1, np.float32(1 / 3)
    ring_t, total_t = _t(ring), _t(total)
    before = wa.WINDOW_UPDATE_LAUNCHES
    got = wa.wa_window_update(ring_t, total_t, _t(new), *_scal(idx, full,
                                                               inv))
    assert wa.WINDOW_UPDATE_LAUNCHES == before     # the CPU launches none
    assert got[0] is ring_t and got[1] is total_t  # written in place
    want = wa_window_update_2d(
        _tiles(ring), _tiles(total), _tiles(new),
        jnp.int32(idx), jnp.float32(full), jnp.float32(inv), interpret=True)
    for g, w in zip(got, want):
        _eq(g, _flat(w, g))
    if I > 1:                                      # other rows untouched
        _eq(ring_t[:idx], ring[:idx])


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_online_mean_plain_is_0ulp_against_pallas(K, dtype):
    stacked = np.asarray(jnp.asarray(_inputs(K, 1, K)[0], dtype))
    got = wa.online_mean(_t(stacked))
    want = online_mean_2d(_tiles(stacked), interpret=True)
    assert got.dtype == torch.float32
    _eq(got, _flat(want, got))
    # the partial mean of a sync spread over processes: sum·inv_k
    got = wa.online_mean(_t(stacked), inv_k=0.125)
    want = online_mean_2d(_tiles(stacked), interpret=True, inv_k=0.125)
    _eq(got, _flat(want, got))


@pytest.mark.parametrize("I", [1, 3])
@pytest.mark.parametrize("full", [0.0, 1.0])
def test_window_update_c_plain_is_0ulp_against_pallas(I, full):
    _, ring, total, comp, new = _inputs(1, I, 11 * I + int(full),
                                        jnp.bfloat16)
    idx, inv = I - 1, np.float32(1 / 3)
    ring_t, total_t, comp_t = _t(ring), _t(total), _t(comp)
    got = wa.wa_window_update_c(ring_t, total_t, comp_t, _t(new),
                                *_scal(idx, full, inv))
    assert got[0] is ring_t and got[1] is total_t and got[2] is comp_t
    want = wa_window_update_c_2d(
        _tiles(ring), _tiles(total), _tiles(comp), _tiles(new),
        jnp.int32(idx), jnp.float32(full), jnp.float32(inv), interpret=True)
    for g, w in zip(got, want):
        _eq(g, _flat(w, g))


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("I", [1, 3])
@pytest.mark.parametrize("full", [0.0, 1.0])
def test_sync_fused_c_plain_is_0ulp_against_pallas(K, I, full):
    stacked, ring, total, comp, _ = _inputs(K, I, 13 * K + I + int(full),
                                            jnp.bfloat16)
    idx, inv = I - 1, np.float32(1 / 3)
    got = wa.wa_sync_fused_c(_t(stacked), _t(ring), _t(total), _t(comp),
                             *_scal(idx, full, inv))
    want = wa_sync_fused_c_2d(
        _tiles(stacked), _tiles(ring), _tiles(total), _tiles(comp),
        jnp.int32(idx), jnp.float32(full), jnp.float32(inv), interpret=True)
    for g, w in zip(got, want):
        _eq(g, _flat(w, g))
    # and the reference's own plain version (its contract)
    want = jax_ref.wa_sync_fused_c_ref(
        *(jnp.asarray(a) for a in (stacked, ring)), None,
        *(jnp.asarray(a) for a in (total, comp)), jnp.int32(idx),
        jnp.float32(full), jnp.float32(inv))
    for g, w in zip(got, [want[0]] + list(want[2:])):
        _eq(g, w)


@pytest.mark.parametrize("full", [0.0, 1.0])
def test_fp8_window_update_plain_matches_jitted_reference(full):
    I, idx, inv = 3, 1, np.float32(0.5)
    _, ring32, total, comp, new = _inputs(1, I, 17 + int(full))
    jring = jnp.asarray(ring32, jnp.float8_e4m3fn)
    scales = (np.random.RandomState(5).rand(I, 2) + 0.5).astype(np.float32)
    want = jax.jit(jax_ref.wa_window_update_c_ref)(
        jring, jnp.asarray(scales), jnp.asarray(total), jnp.asarray(comp),
        jnp.asarray(new), jnp.int32(idx), jnp.float32(full),
        jnp.float32(inv))
    got = ref.wa_window_update_c_ref(
        _t(np.asarray(jring)), _t(scales), _t(total), _t(comp), _t(new),
        *_scal(idx, full, inv))
    for g, w in zip(got, want):
        _eq(g, w)


def test_per_leaf_wrappers_on_a_ragged_leaf():
    rng = np.random.RandomState(9)
    shape = (5, 37)
    ring = rng.randn(3, *shape).astype(np.float32)
    total = rng.randn(*shape).astype(np.float32)
    new = np.asarray(jnp.asarray(rng.randn(*shape), jnp.bfloat16))
    args = (1, 1.0, np.float32(1 / 3))
    got = kops.wa_window_update(_t(ring), _t(total), _t(new), *args)
    want = jax_ops.wa_window_update(jnp.asarray(ring), jnp.asarray(total),
                                    jnp.asarray(new), *args)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _eq(g, w)
    for dtype in (jnp.float32, jnp.bfloat16):
        stacked = np.asarray(jnp.asarray(rng.randn(3, *shape), dtype))
        got = kops.online_mean(_t(stacked))
        want = jax_ops.online_mean(jnp.asarray(stacked))
        assert str(got.dtype) == f"torch.{want.dtype}"
        _eq(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_online_average_kernel_route_matches_jax(dtype):
    """``online_average(use_kernel=True)``: the K replicas packed and
    reduced in one online-mean launch, unpacked in the leaves' dtypes."""
    from repro.core.online import online_average as jax_online_average
    from repro_torch.core.online import online_average
    rng = np.random.RandomState(8)
    stacked = {"a": rng.randn(3, 5, 37), "b": [rng.randn(3, ALIGN + 3)]}
    stacked = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, dtype)),
                           stacked)
    got = online_average(_t(stacked), use_kernel=True)
    want = jax.jit(lambda t: jax_online_average(t, use_kernel=True))(
        stacked)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert str(g.dtype) == f"torch.{w.dtype}"
        _eq(g, w)


# ------------------------------------------------------ the window pushes

WINDOWS = [("ring", "f32"), ("ring", "bf16"), ("ring", "fp8"),
           ("streaming", "f32")]


@pytest.mark.parametrize("kind,ring_dtype", WINDOWS)
@pytest.mark.parametrize("use_kernel", [False, True])
def test_window_update_packed_over_7_pushes(kind, ring_dtype, use_kernel):
    rng = np.random.RandomState(3)
    tree = {"a": rng.randn(5, 37).astype(np.float32),
            "b": [rng.randn(3, ALIGN + 3).astype(np.float32)]}
    jws = jax_window_init(tree, 3, kind, ring_dtype=ring_dtype)
    ws = window_init(_t(tree), 3, kind, ring_dtype=ring_dtype)
    P = jax_pack_spec(tree).padded
    assert ws.spec.padded == P and ws.spec.ring_dtype == jws.spec.ring_dtype
    push = jax.jit(lambda s, n: jax_window_update_p(s, n,
                                                    use_kernel=use_kernel))
    for i in range(7):
        new = (rng.randn(P) * (1 + i)).astype(np.float32)
        jws, javg = push(jws, jnp.asarray(new))
        ws, avg = window_update_packed(ws, _t(new), use_kernel=use_kernel)
        msg = f"push {i}"
        _eq(avg, javg, msg)
        for name in ("ring", "total", "comp", "scales"):
            g, w = getattr(ws, name), getattr(jws, name)
            assert (g is None) == (w is None), (name, msg)
            if g is not None:
                _eq(g, w, f"{name} {msg}")
        assert (int(ws.count), int(ws.next_idx)) == (int(jws.count),
                                                     int(jws.next_idx))
        _eq(window_average_packed(ws), jax_window_average(jws), msg)
    # the tree-level push, in W̄'s dtypes
    new = jax.tree.map(lambda x: (x * 0.5).astype(np.float32), tree)
    jws, jtree = jax.jit(lambda s, t: jax_window_update(
        s, t, use_kernel=use_kernel))(jws, new)
    ws, got = window_update(ws, _t(new), use_kernel=use_kernel)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(jtree)):
        _eq(g, w)


# ------------------------------------------------------------- hwa_sync


@functools.cache
def _jax_params(dtype):
    cfg = jax_smoke_config("granite-3-2b").with_(dtype=dtype)
    return jax.device_get(jax.jit(jax_build_model(cfg).init)(
        jax.random.key(0)))


#: (ring dtype, window_stride, window kind, parameter dtype)
SYNCS = [("f32", 2, "ring", "float32"), ("bf16", 1, "ring", "bfloat16"),
         ("bf16", 2, "ring", "float32"), ("fp8", 1, "ring", "bfloat16"),
         ("f32", 1, "streaming", "float32")]


@pytest.mark.parametrize("ring_dtype,stride,kind,dtype", SYNCS)
@pytest.mark.parametrize("use_kernels", [True, False])
def test_hwa_sync_windows_match_jax_bitwise(ring_dtype, stride, kind, dtype,
                                            use_kernels):
    """Five syncs (the I = 3 ring wraps at the fourth; a stride of 2
    skips cycles 2 and 4) from one bridged state; before each, both
    sides' replicas move to the same numpy-made values."""
    K = 2
    opts = dict(n_replicas=K, window=3, window_stride=stride,
                window_kind=kind, use_kernels=use_kernels)
    jcfg, cfg = JaxHWAConfig(**opts), HWAConfig(**opts)
    jstate = jax_hwa_init(jcfg, _jax_params(dtype), jax_sgd(momentum=0.9),
                          ring_dtype=ring_dtype)
    state = hwa_state_from_numpy(jax.device_get(jstate), device="cpu")
    jax_sync = jax.jit(lambda s: jax_hwa_sync(jcfg, s))
    rng = np.random.RandomState(K)
    for cycle in range(5):
        jstate.inner = jax.tree.map(
            lambda x: (jnp.asarray(x, jnp.float32) + rng.randn(*x.shape)
                       .astype(np.float32) * 0.1).astype(x.dtype),
            jstate.inner)
        state.inner = params_from_numpy(jax.device_get(jstate.inner),
                                        device="cpu")
        jstate, _ = jax_sync(jstate)
        state, _ = hwa_sync(cfg, state)
        jws, ws = jstate.window_state, state.window_state
        msg = f"cycle {cycle}"
        for name in ("ring", "total", "comp", "scales"):
            g, w = getattr(ws, name), getattr(jws, name)
            assert (g is None) == (w is None), (name, msg)
            if g is not None:
                _eq(g, w, f"{name} {msg}")
        assert (int(ws.count), int(ws.next_idx), int(state.cycle)) == \
            (int(jws.count), int(jws.next_idx), int(jstate.cycle))
        for name, got, want in (("wa", state.wa, jstate.wa),
                                ("inner", state.inner, jstate.inner)):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                _eq(g, w, f"{name} {msg}")


# ------------------------------------------------------------ the Trainer


def test_strided_hwa_trainer_matches_jax():
    """8 steps, K = 2, H = 2, I = 3, window_stride 2 (cycles 1 and 3
    enter the window), on the kernel route: per-step losses, W̿ after
    each sync and its test losses within 1e-5 of the JAX Trainer."""
    from repro.configs import get_smoke_config as jax_cfg
    from repro.data import DataPipeline as JaxPipeline
    from repro.data import make_markov_lm_dataset as jax_markov
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import Trainer as JaxTrainer
    from repro.train import lm_task as jax_lm_task
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.registry import build_model
    from repro_torch.train.trainer import Task, TrainConfig, Trainer, \
        lm_task

    K, H, I, steps = 2, 2, 3, 8
    hwa = dict(n_replicas=K, sync_period=H, window=I, window_stride=2,
               use_kernels=True)
    jlm = jax_build_model(jax_cfg("granite-3-2b"))
    jpipe = JaxPipeline(jax_markov(vocab=jlm.cfg.vocab_size, seq_len=32,
                                   n_train=64, n_test=16, seed=0),
                        batch_size=8, n_replicas=K, seed=0)
    jtc = JaxTrainConfig(method="hwa", total_steps=steps, batch_size=8,
                         base_lr=0.3, hwa=JaxHWAConfig(**hwa))
    jt = JaxTrainer(jax_lm_task(jlm, jpipe), jtc)
    jlog = {"loss": [], "wa": []}
    _record(jt, jlog, lambda t: [np.asarray(x, np.float32)
                                 for x in jax.tree.leaves(t)])
    jout = jt.run()

    jparams = jax.device_get(jlm.init(jax.random.key(jtc.seed)))
    lm = build_model(get_smoke_config("granite-3-2b"))
    task = Task(init=lambda: params_from_numpy(jparams, device="cpu"),
                loss_fn=lm_task(lm, None).loss_fn, pipeline=_Injected(jpipe))
    tc = TrainConfig(method="hwa", total_steps=steps, batch_size=8,
                     base_lr=0.3, hwa=HWAConfig(**hwa))
    t = Trainer(task, tc)
    assert t.hwa_cfg.window_stride == 2 and t.hwa_cfg.use_kernels
    log = {"loss": [], "wa": []}
    _record(t, log, lambda tree: [x.float().numpy().copy()
                                  for x in tree_leaves(tree)])
    out = t.run()

    assert len(log["loss"]) == steps and len(log["wa"]) == steps // H
    np.testing.assert_allclose(log["loss"], jlog["loss"], rtol=1e-5,
                               atol=1e-5)
    for got, want in zip(log["wa"], jlog["wa"]):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
    # cycle 2 is skipped: W̿ stays what cycle 1 made it
    for a, b in zip(log["wa"][0], log["wa"][1]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose([h["test_loss"] for h in out["history"]],
                               [h["test_loss"] for h in jout["history"]],
                               rtol=1e-5, atol=1e-5)
