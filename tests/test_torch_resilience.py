"""The port's resilient HWA against the JAX reference on the CPU: every
function of ``resilience.health`` on numpy-made inputs (all alive, one
dead, all dead, an integer leaf, the RMS probe), the resilient
``hwa_sync`` over four syncs of bridged state with a replica poisoned
before the second, on both ``use_kernels`` settings (the window-update
kernel's plain version here, interpret-mode Pallas there), the fault
check's eight legs (the three mesh legs over two spawned ``gloo`` ranks),
and the launcher's ``--resilient``.

Tolerances: bit for bit everywhere but one place. The sum of squares of
``packed_health_stats`` is an f32 sum over a row, which XLA's CPU build
adds in a vectorized order PyTorch does not reproduce (measured: 1-2
ULP of the sum at 1,000 elements); it is held at rtol 1e-6, and the
alive verdict built on it is compared bit for bit from the same stats.
The reference documents the RMS probe as approximate for this reason.
"""
import contextlib
import functools
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.hwa import HWAConfig as JaxHWAConfig
from repro.core.hwa import hwa_init as jax_hwa_init
from repro.core.hwa import hwa_sync as jax_hwa_sync
from repro.models.registry import build_model as jax_build_model
from repro.optim import sgd as jax_sgd
from repro.resilience import health as jh
from repro_torch.bridge import hwa_state_from_numpy, params_from_numpy
from repro_torch.common.pytree import tree_leaves
from repro_torch.core.hwa import HWAConfig, hwa_sync
from repro_torch.core.offline import window_average_packed
from repro_torch.kernels import wa_update as wa
from repro_torch.launch import train as launch_train
from repro_torch.resilience import check
from repro_torch.resilience import health as th
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _np(t):
    """A tensor's bits as numpy (bf16 as uint16, 4-byte dtypes as
    uint32, bool as is)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.bool:
        return t.numpy()
    return _bits(t.numpy())


def _assert_trees_bitwise(got, want):
    gl, wl = tree_leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        w = np.asarray(w)
        assert str(g.dtype) == f"torch.{w.dtype}", (g.dtype, w.dtype)
        np.testing.assert_array_equal(_np(g), w if w.dtype == bool
                                      else _bits(w))


def _stacked(k=4, seed=0):
    """numpy tree: f32, bf16 and an integer leaf, K replicas."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((k, 3, 5)).astype(np.float32),
        "b": np.asarray(jnp.asarray(rng.standard_normal((k, 7))
                                    .astype(np.float32)).astype(jnp.bfloat16)),
        "count": np.arange(k, dtype=np.int32) + 3,
    }


# (alive pattern, max_rms, replica blown up by 1e4)
CASES = {
    "all_alive": ([1, 1, 1, 1], None, None),
    "one_dead": ([1, 0, 1, 1], None, None),
    "all_dead": ([0, 0, 0, 0], None, None),
    "max_rms": ([1, 1, 1, 1], 100.0, 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_health_matches_jax_bitwise(case):
    """replica_alive_mask, masked_mean_axis0 (jitted and eager reference)
    and quarantine_opt_state: the same bits as the reference."""
    pattern, max_rms, blown = CASES[case]
    tree = _stacked()
    dead = ~np.asarray(pattern, bool)
    tree["w"][dead] = np.nan
    tree["b"] = tree["b"].copy()
    tree["b"][dead] = np.asarray(jnp.asarray(np.inf, jnp.bfloat16))
    if blown is not None:
        tree["w"][blown] *= 1e4
    jtree = jax.tree.map(jnp.asarray, tree)
    ttree = params_from_numpy(tree, device="cpu")

    jalive = jh.replica_alive_mask(jtree, max_rms=max_rms)
    alive = th.replica_alive_mask(ttree, max_rms=max_rms)
    np.testing.assert_array_equal(alive.numpy(), np.asarray(jalive))
    if blown is not None:
        assert not bool(alive[blown]) and int(alive.sum()) == 3

    for fn in (jh.masked_mean_axis0, jax.jit(jh.masked_mean_axis0)):
        _assert_trees_bitwise(th.masked_mean_axis0(ttree, alive),
                              fn(jtree, jalive))

    rng = np.random.default_rng(1)
    opt = {"mu": rng.standard_normal((4, 3, 5)).astype(np.float32),
           "nu": np.full((4, 7), np.nan, np.float32),
           "count": np.ones((), np.int32)}       # not per replica
    want = jh.quarantine_opt_state(jax.tree.map(jnp.asarray, opt), jalive)
    topt = params_from_numpy(opt, device="cpu")
    got = th.quarantine_opt_state(topt, alive)
    assert got is topt                           # zeroed in place
    _assert_trees_bitwise(got, want)


def test_masked_mean_all_alive_equals_plain_mean():
    """All alive: the port's masked mean IS its plain mean, to the bit,
    for every leaf dtype (the resilient sync's parity with the plain
    route rests on it)."""
    from repro_torch.common.pytree import tree_mean_axis0
    for k in (1, 2, 3, 4):
        ttree = params_from_numpy(_stacked(k), device="cpu")
        got = th.masked_mean_axis0(ttree, torch.ones(k, dtype=torch.bool))
        for g, w in zip(tree_leaves(got), tree_leaves(tree_mean_axis0(ttree))):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(_np(g), _np(w))


def test_packed_health_stats_and_alive_from_stats():
    rng = np.random.default_rng(2)
    sbuf = (rng.standard_normal((4, 1000)) * 3).astype(np.float32)
    sbuf[1, 5], sbuf[2, 7], sbuf[2, 9] = np.nan, np.inf, -np.inf
    jstats = np.array(jax.jit(jh.packed_health_stats)(jnp.asarray(sbuf)))
    stats = th.packed_health_stats(torch.from_numpy(sbuf))
    np.testing.assert_array_equal(_np(stats[:, 0]), _bits(jstats[:, 0]))
    np.testing.assert_array_equal(stats[:, 0].numpy(), [0, 1, 2, 0])
    np.testing.assert_allclose(stats[:, 1].numpy(), jstats[:, 1], rtol=1e-6)
    # the verdict from the same stats: bit for bit, at a threshold
    # between the two healthy replicas' RMS
    rms = np.sqrt(jstats[[0, 3], 1] / 1000.0)
    for max_rms in (None, float(rms.mean()), 1e3):
        np.testing.assert_array_equal(
            th.alive_from_stats(torch.from_numpy(jstats), 1000.0,
                                max_rms).numpy(),
            np.asarray(jh.alive_from_stats(jnp.asarray(jstats), 1000.0,
                                           max_rms)))


def test_renormalized_inv_pins_1_over_k():
    for k in (2, 3, 4, 6, 8):
        pinned = th.renormalized_inv(torch.tensor(float(k)), k)
        assert pinned.dtype == torch.float32
        assert pinned.numpy().tobytes() == np.float32(1.0 / k).tobytes()
        for k_alive in range(k + 1):
            np.testing.assert_array_equal(
                _np(th.renormalized_inv(torch.tensor(float(k_alive)), k)),
                _bits(jh.renormalized_inv(jnp.float32(k_alive), k)))
    assert float(th.renormalized_inv(torch.tensor(2.0), 4)) == 0.5
    assert np.isfinite(float(th.renormalized_inv(torch.tensor(0.0), 4)))


# ------------------------------------------------------- resilient sync


@functools.cache
def _jax_params(dtype):
    cfg = jax_smoke_config("granite-3-2b").with_(dtype=dtype)
    return jax.device_get(jax.jit(jax_build_model(cfg).init)(
        jax.random.key(0)))


@pytest.mark.parametrize("use_kernels,K,dtype", [
    (True, 2, "bfloat16"), (False, 2, "bfloat16"),
    (True, 3, "float32"), (False, 3, "float32")])
def test_resilient_hwa_sync_matches_jax(use_kernels, K, dtype):
    """Four syncs from one bridged state (I = 3: the ring wraps at the
    fourth); before each, both sides' replicas and momenta move to the
    same numpy-made values, and before the second replica 1 is poisoned
    with NaN. Ring, total, W̿, the restarted replicas, the (quarantined)
    momenta and k_alive: bit for bit. With ``use_kernels`` the window
    push is the window-update kernel's route (its plain version here)
    and nothing else launches."""
    jcfg = JaxHWAConfig(n_replicas=K, window=3, use_kernels=use_kernels,
                        resilient=True)
    cfg = HWAConfig(n_replicas=K, window=3, use_kernels=use_kernels,
                    resilient=True)
    jstate = jax_hwa_init(jcfg, _jax_params(dtype), jax_sgd(momentum=0.9))
    state = hwa_state_from_numpy(jax.device_get(jstate), device="cpu")
    jax_sync = jax.jit(lambda s: jax_hwa_sync(jcfg, s))
    rng = np.random.RandomState(K)

    def moved(tree, poison):
        def one(x):
            y = np.asarray(x, np.float32) + rng.randn(*x.shape).astype(
                np.float32) * 0.1
            if poison:
                y[1] = np.nan
            return np.asarray(jnp.asarray(y).astype(x.dtype))
        return jax.tree.map(one, jax.device_get(tree))

    k_alive = []
    for cycle in range(4):
        inner = moved(jstate.inner, poison=cycle == 1)
        opt = moved(jstate.inner_opt, poison=cycle == 1)
        jstate.inner = jax.tree.map(jnp.asarray, inner)
        jstate.inner_opt = jax.tree.map(jnp.asarray, opt)
        state.inner = params_from_numpy(inner, device="cpu")
        state.inner_opt = params_from_numpy(opt, device="cpu")
        launches = (wa.LAUNCHES, wa.WINDOW_UPDATE_LAUNCHES,
                    wa.ONLINE_MEAN_LAUNCHES)
        jstate, jm = jax_sync(jstate)
        state, m = hwa_sync(cfg, state)
        assert (wa.LAUNCHES, wa.WINDOW_UPDATE_LAUNCHES,
                wa.ONLINE_MEAN_LAUNCHES) == launches   # CPU: plain versions
        jws, ws = jstate.window_state, state.window_state
        np.testing.assert_array_equal(_np(ws.ring), _bits(jws.ring))
        np.testing.assert_array_equal(_np(ws.total), _bits(jws.total))
        assert (int(ws.count), int(ws.next_idx), int(state.cycle)) == \
            (int(jws.count), int(jws.next_idx), int(jstate.cycle))
        from repro.core.offline import window_average_packed as jwa
        np.testing.assert_array_equal(_np(window_average_packed(ws)),
                                      _bits(jwa(jws)))
        for name, got, want in (("wa", state.wa, jstate.wa),
                                ("inner", state.inner, jstate.inner),
                                ("inner_opt", state.inner_opt,
                                 jstate.inner_opt)):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(_np(g), _bits(w),
                                              err_msg=f"{name} {cycle}")
        assert m["k_alive"].dtype == torch.int32
        assert int(m["k_alive"]) == int(jm["k_alive"])
        k_alive.append(int(m["k_alive"]))
        if cycle == 1:           # the dead replica's momenta are zeroed
            assert all(not bool(x[1].any())
                       for x in tree_leaves(state.inner_opt))
            assert all(bool(torch.isfinite(x).all())
                       for x in tree_leaves(state.wa))
    assert k_alive == [K, K - 1, K, K]


@pytest.mark.parametrize("avg_opt", [False, True])
def test_resilient_sync_healthy_equals_plain_route(avg_opt):
    """Every replica alive: the resilient sync (window-update route) and
    the plain non-resilient sync give the same W̄, ring, total, W̿ and
    momenta, to the bit (what chip_smoke phase 10a holds on the card)."""
    jstate = jax_hwa_init(JaxHWAConfig(n_replicas=2, window=3),
                          _jax_params("bfloat16"), jax_sgd(momentum=0.9))
    host = jax.device_get(jstate)
    rng = np.random.RandomState(7)
    moved = jax.tree.map(lambda x: np.asarray(jnp.asarray(
        np.asarray(x, np.float32) + rng.randn(*x.shape).astype(np.float32))
        .astype(x.dtype)), (host.inner, host.inner_opt))
    out = []
    for cfg in (HWAConfig(n_replicas=2, window=3, resilient=True,
                          use_kernels=True, avg_opt_state=avg_opt),
                HWAConfig(n_replicas=2, window=3, avg_opt_state=avg_opt)):
        state = hwa_state_from_numpy(host, device="cpu")
        state.inner = params_from_numpy(moved[0], device="cpu")
        state.inner_opt = params_from_numpy(moved[1], device="cpu")
        state, _ = hwa_sync(cfg, state)
        out.append(tree_leaves((state.inner, state.inner_opt, state.wa,
                                state.window_state.ring,
                                state.window_state.total)))
    for a, b in zip(*out):
        np.testing.assert_array_equal(_np(a), _np(b))


# ------------------------------------------------------ fault check


@pytest.mark.parametrize("leg", [leg.name for leg in check.default_legs()])
def test_fault_check_leg(leg, monkeypatch):
    # a hang of a mesh leg fails within a minute
    monkeypatch.setattr(launch_train, "COLLECTIVE_TIMEOUT", 60.0)
    (found,) = [x for x in check.default_legs() if x.name == leg]
    report = check.run_fault_check([found], log=lambda s: None,
                                   device="cpu")
    assert report["ok"], report["legs"][leg]


def test_fault_check_cli_smoke(monkeypatch):
    monkeypatch.setattr(launch_train, "COLLECTIVE_TIMEOUT", 60.0)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = check.main(["--smoke", "--device", "cpu"])
    assert rc == 0
    assert "fault-check: ALL_OK (4 legs)" in buf.getvalue()
    assert check.main(["--list"]) == 0


# --------------------------------------------------------- launcher


def test_launcher_resilient_cpu():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_train.main(["--device", "cpu", "--steps", "4", "--k", "2",
                           "--window", "3", "--sync-period", "2",
                           "--batch-size", "4", "--seq-len", "16",
                           "--resilient", "--max-param-rms", "10"])
    lines = buf.getvalue().splitlines()
    assert sum(ln.startswith("[granite-3-2b/hwa] step") for ln in lines) == 2
    assert lines[-1].startswith("[train] granite-3-2b/hwa on cpu: final")
