"""The port's WA state machine against the JAX reference: packing lays a
bridged tree out byte for byte as the reference does; the plain fused
sync (``kernels.ref.wa_sync_fused_ref``, what the CUDA kernel is held to
on the card) is 0 ULP against the reference's; and ``hwa_sync`` on
bridged state gives the reference's ring, total, W̄ and W̿ bit for bit,
on both routes (``use_kernels`` True: the fused kernel's plain version
here, the interpret-mode Pallas kernel there; False: the plain mean and
window push), for f32 and bf16 parameters. Inputs are made with numpy
from a seed and handed to both packages."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.packing import pack as jax_pack
from repro.common.packing import pack_spec as jax_pack_spec
from repro.common.packing import pack_stacked as jax_pack_stacked
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.hwa import HWAConfig as JaxHWAConfig
from repro.core.hwa import hwa_init as jax_hwa_init
from repro.core.hwa import hwa_sync as jax_hwa_sync
from repro.core.offline import window_average_packed as jax_window_average
from repro.kernels import ref as jax_ref
from repro.kernels.wa_update import wa_sync_fused_2d
from repro.models.registry import build_model as jax_build_model
from repro.optim import sgd as jax_sgd
from repro_torch.bridge import hwa_state_from_numpy, params_from_numpy
from repro_torch.common.packing import ALIGN, pack, pack_spec, pack_stacked, \
    unpack
from repro_torch.common.pytree import tree_leaves
from repro_torch.core.hwa import HWAConfig, hwa_sync
from repro_torch.core.offline import window_average_packed
from repro_torch.kernels import wa_update as wa
from repro_torch.kernels.ref import wa_sync_fused_ref
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _np(t):
    """A tensor's bits as numpy (bf16 as uint16, f32 as uint32)."""
    if t.dtype == torch.bfloat16:
        return t.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    return _bits(t.detach().cpu().numpy())


@functools.cache
def _jax_params(arch, dtype):
    """The reference's smoke init as numpy (never mutated), once per
    (arch, dtype)."""
    cfg = jax_smoke_config(arch).with_(dtype=dtype)
    return jax.device_get(jax.jit(jax_build_model(cfg).init)(
        jax.random.key(0)))


# ----------------------------------------------------------- packing


@pytest.mark.parametrize("arch", ["granite-3-2b", "gemma2-27b"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pack_is_byte_equal_to_jax(arch, dtype):
    jtree = _jax_params(arch, dtype)
    tree = params_from_numpy(jtree, device="cpu")
    jspec, spec = jax_pack_spec(jtree), pack_spec(tree)
    assert (spec.size, spec.padded, spec.padded % ALIGN) == \
        (jspec.size, jspec.padded, 0)
    assert [ls.offset for ls in spec.leaves] == \
        [ls.offset for ls in jspec.leaves]
    np.testing.assert_array_equal(
        _bits(pack(tree, spec)),
        _bits(jax.jit(lambda t: jax_pack(t, jspec))(jtree)))
    # a stacked (K=3) tree: K rows, each the pack of one replica
    jstacked = jax.tree.map(lambda x: np.stack([x, x * 2, x * 3]), jtree)
    stacked = params_from_numpy(jstacked, device="cpu")
    np.testing.assert_array_equal(
        _bits(pack_stacked(stacked, spec)),
        _bits(jax.jit(lambda t: jax_pack_stacked(t, jspec))(jstacked)))
    # and back: unpack restores every leaf bit for bit
    for got, want in zip(tree_leaves(unpack(pack(tree, spec), spec)),
                         jax.tree.leaves(jtree)):
        assert str(got.dtype) == f"torch.{want.dtype}"
        np.testing.assert_array_equal(_np(got), _bits(want))


# ------------------------------------------------- the fused sync


def _sync_inputs(K, I, full, seed):
    rng = np.random.RandomState(seed)
    P = 2 * ALIGN
    stacked = rng.randn(K, P).astype(np.float32)
    stacked[0, :4] = -0.0              # signed zeros must come out as XLA's
    stacked[:, 4:8] = -0.0
    ring = rng.randn(I, P).astype(np.float32)
    total = rng.randn(P).astype(np.float32)
    return stacked, ring, total, I - 1, np.float32(full), np.float32(1 / 3)


def _port_sync(stacked, ring, total, idx, full, inv):
    t = torch.from_numpy
    ring_t, total_t = t(ring.copy()), t(total.copy())
    _, total2, avg = wa_sync_fused_ref(
        t(stacked), ring_t, total_t, torch.tensor(idx, dtype=torch.int32),
        torch.tensor(full), torch.tensor(inv))
    assert total2 is total_t                 # written in place
    return ring_t.numpy(), total_t.numpy(), avg.numpy()


@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("I", [1, 3])
@pytest.mark.parametrize("full", [0.0, 1.0])
def test_plain_sync_is_0ulp_against_jax(K, I, full):
    stacked, ring, total, idx, full, inv = _sync_inputs(K, I, full, 10 * K + I)
    got = _port_sync(stacked, ring, total, idx, full, inv)
    j = [jnp.asarray(a) for a in (stacked, ring, total)]
    scal = (jnp.int32(idx), jnp.float32(full), jnp.float32(inv))
    want_ref = jax_ref.wa_sync_fused_ref(*j, *scal)
    for g, w in zip(got, want_ref):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # the Pallas kernel (interpret mode), on its (K, R, 1024) tiling
    tiles = [a.reshape(a.shape[:-1] + (-1, 1024)) for a in j]
    want_kernel = [np.asarray(w).reshape(g.shape) for w, g in zip(
        wa_sync_fused_2d(*tiles, *scal, interpret=True), got)]
    np.testing.assert_array_equal(_bits(got[0]), _bits(want_kernel[0]))
    if K != 3:
        for g, w in zip(got[1:], want_kernel[1:]):
            np.testing.assert_array_equal(_bits(g), _bits(w))
    else:
        # XLA's CPU build of the interpret-mode kernel contracts
        # total + sum * (1/3) into one FMA (1/K is inexact only at K = 3 of
        # these K): its total is exactly that fused formula, while the
        # port, the CUDA kernel and jnp's ref round the product first
        # (ROADMAP.md Queue C has the measured size of the difference)
        s = np.zeros_like(total) if K > 1 else stacked[0]
        for k in range(K):
            s = s + stacked[k]
        fused = (s.astype(np.float64) * np.float32(1 / K)
                 + total.astype(np.float64)).astype(np.float32)
        fused = fused - full * ring[idx]
        np.testing.assert_array_equal(_bits(want_kernel[1]), _bits(fused))


def test_untouched_ring_rows_and_cpu_wrapper_counts_no_launch():
    stacked, ring, total, _, full, inv = _sync_inputs(2, 3, 1.0, 5)
    before = wa.LAUNCHES
    ring_t = torch.from_numpy(ring.copy())
    wa.wa_sync_fused(torch.from_numpy(stacked), ring_t,
                     torch.from_numpy(total.copy()),
                     torch.tensor(1, dtype=torch.int32), torch.tensor(full),
                     torch.tensor(inv))
    assert wa.LAUNCHES == before
    np.testing.assert_array_equal(_bits(ring_t.numpy()[[0, 2]]),
                                  _bits(ring[[0, 2]]))
    scal = wa.sync_scalars(torch.tensor(7, dtype=torch.int32),
                           torch.tensor(1.0), torch.tensor(0.25))
    assert scal.dtype == torch.float32 and scal.shape == (3,)
    assert scal[:1].view(torch.int32).item() == 7


# ------------------------------------------------------- hwa_sync


@pytest.mark.parametrize("use_kernels,K,dtype,avg_opt", [
    (True, 2, "float32", False), (True, 2, "bfloat16", False),
    (True, 4, "float32", False), (False, 2, "float32", False),
    (False, 3, "bfloat16", False), (False, 3, "float32", False),
    (True, 2, "bfloat16", True), (False, 3, "float32", True),
])
def test_hwa_sync_matches_jax_bitwise(use_kernels, K, dtype, avg_opt):
    """Five syncs (the I = 3 ring wraps at the fourth) from one bridged
    state; before each, both sides' replicas (and, with ``avg_opt_state``,
    their momenta) are moved to the same numpy-made values."""
    jparams = _jax_params("granite-3-2b", dtype)
    jcfg = JaxHWAConfig(n_replicas=K, window=3, use_kernels=use_kernels,
                        avg_opt_state=avg_opt)
    jstate = jax_hwa_init(jcfg, jparams, jax_sgd(momentum=0.9))
    state = hwa_state_from_numpy(jax.device_get(jstate), device="cpu")
    cfg = HWAConfig(n_replicas=K, window=3, use_kernels=use_kernels,
                    avg_opt_state=avg_opt)
    rng = np.random.RandomState(K)
    jax_sync = jax.jit(lambda s: jax_hwa_sync(jcfg, s))

    def moved(tree):
        return jax.tree.map(
            lambda x: (jnp.asarray(x, jnp.float32) + rng.randn(*x.shape)
                       .astype(np.float32) * 0.1).astype(x.dtype), tree)
    for cycle in range(5):
        jstate.inner = moved(jstate.inner)
        state.inner = params_from_numpy(jax.device_get(jstate.inner),
                                        device="cpu")
        if avg_opt:
            jstate.inner_opt = moved(jstate.inner_opt)
            state.inner_opt = params_from_numpy(
                jax.device_get(jstate.inner_opt), device="cpu")
        jstate, jm = jax_sync(jstate)
        state, m = hwa_sync(cfg, state)
        jws, ws = jstate.window_state, state.window_state
        np.testing.assert_array_equal(_bits(ws.ring.numpy()),
                                      _bits(jws.ring))
        np.testing.assert_array_equal(_bits(ws.total.numpy()),
                                      _bits(jws.total))
        assert (int(ws.count), int(ws.next_idx), int(state.cycle)) == \
            (int(jws.count), int(jws.next_idx), int(jstate.cycle))
        np.testing.assert_array_equal(
            _bits(window_average_packed(ws).numpy()),
            _bits(jax_window_average(jws)))
        for name, got, want in (("wa", state.wa, jstate.wa),
                                ("inner", state.inner, jstate.inner),
                                ("inner_opt", state.inner_opt,
                                 jstate.inner_opt)):
            for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
                np.testing.assert_array_equal(_np(g), _bits(w),
                                              err_msg=f"{name} {cycle}")
        np.testing.assert_allclose(float(m["replica_divergence"]),
                                   float(jm["replica_divergence"]),
                                   rtol=1e-5)


def test_unported_hwa_options_raise():
    """``outer_every`` (H₂ of the two-level tree) is ported: the stacked
    path carries it and changes nothing, as the reference's does (the tree
    is the mesh-native path's, tests/test_torch_sync.py), so one sync with
    H₂ 2 is bit-equal to the reference's; the mesh-native builders refuse
    a value their topology disagrees with."""
    from repro_torch.launch.sync.bundles import _check_outer_every
    from repro_torch.launch.sync.topology import Flat, TwoLevel
    jparams = _jax_params("granite-3-2b", "float32")
    for resilient in (False, True):
        jcfg = JaxHWAConfig(n_replicas=2, window=3, outer_every=2,
                            resilient=resilient)
        jstate = jax_hwa_init(jcfg, jparams, jax_sgd(momentum=0.9))
        jstate.inner = jax.tree.map(
            lambda x: x + jnp.arange(2, dtype=x.dtype).reshape(
                (2,) + (1,) * (x.ndim - 1)), jstate.inner)
        state = hwa_state_from_numpy(jax.device_get(jstate), device="cpu")
        jstate, _ = jax.jit(lambda s: jax_hwa_sync(jcfg, s))(jstate)
        state, _ = hwa_sync(HWAConfig(n_replicas=2, window=3, outer_every=2,
                                      resilient=resilient), state)
        for g, w in zip(tree_leaves((state.inner, state.wa)),
                        jax.tree.leaves((jstate.inner, jstate.wa))):
            np.testing.assert_array_equal(_np(g), _bits(w))
    with pytest.raises(ValueError, match="silently ignored"):
        _check_outer_every(HWAConfig(outer_every=2), Flat())
    with pytest.raises(ValueError, match="disagrees"):
        _check_outer_every(HWAConfig(outer_every=3), TwoLevel(outer_every=2))
