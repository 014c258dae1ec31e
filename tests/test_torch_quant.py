"""The port's precision helpers (``repro_torch.common.quant``) against
the JAX reference's ``repro.common.quant``, bit for bit: the fp8 block
scales and codec, the bf16/fp8 slot encoding, the Kahan add and the ULP
measures, on blocks that hold an all-zero block, values beyond
±448·scale, -0 and e4m3 subnormals. The reference runs under
``jax.jit``, as its sync does: XLA turns ``amax / 448`` into ``amax *
f32(1/448)`` there, and the port computes that product. Also: the
PackSpec's ring precision and the bridge's fp8 leaves."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common import quant as jq
from repro.common.packing import pack_spec as jax_pack_spec
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.common import quant as q
from repro_torch.common.packing import ALIGN, pack_spec
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

B = q.SCALE_BLOCK


def _bits(x):
    """Bits of a numpy/jax array or a tensor, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        view = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
            x.element_size()]
        x = x.detach().cpu().view(view).numpy()
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[x.itemsize])


def _blocks(seed=0):
    """(2, 5·B) f32 rows whose blocks are: all zero (with -0s), normal
    values, one large value beside values that land in e4m3's subnormal
    range once scaled, a wide log-uniform spread, and values near the
    fp8 rounding ties."""
    rng = np.random.RandomState(seed)
    x = np.zeros((2, 5 * B), np.float32)
    x[:, :B:7] = -0.0
    x[:, B:2 * B] = rng.randn(2, B) * 3
    blk = rng.randn(2, B).astype(np.float32) * 1e-3
    blk[:, 0] = 448.0                          # scale 1: the rest subnormal
    blk[:, 1:9] = -0.0
    x[:, 2 * B:3 * B] = blk
    x[:, 3 * B:4 * B] = (np.exp(rng.uniform(-30, 30, (2, B)))
                         * rng.choice([-1, 1], (2, B)))
    ties = rng.randint(-448, 449, (2, B)).astype(np.float32)
    x[:, 4 * B:] = ties + 0.5 * rng.choice([-1, 1], (2, B))
    return x


def test_block_scales_match_the_jitted_reference():
    x = _blocks()
    got = q.block_scales(torch.from_numpy(x))
    want = jax.jit(jq.block_scales)(jnp.asarray(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(got[0, 0]) == 1.0                 # all-zero block
    # the product by f32(1/448), not a division by 448
    amax = np.abs(x.reshape(2, -1, B)).max(-1)
    prod = np.where(amax > 0, amax * np.float32(1 / 448), 1).astype(
        np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(prod))


@pytest.mark.parametrize("given_scales", [False, True])
def test_fp8_codec_matches_the_jitted_reference(given_scales):
    x = _blocks(1)
    if given_scales:
        # scales 4x too small: most values lie beyond ±448·scale and clip
        s = np.abs(x.reshape(2, -1, B)).max(-1) / 448 / 4
        s = np.where(s > 0, s, 1).astype(np.float32)
    else:
        s = np.array(jax.jit(jq.block_scales)(jnp.asarray(x)))
    got = q.quantize_fp8(torch.from_numpy(x), torch.from_numpy(s))
    want = jax.jit(jq.quantize_fp8)(jnp.asarray(x), jnp.asarray(s))
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(_bits(got), _bits(want))
    if given_scales:
        assert int((_bits(got) & 0x7F == 0x7E).sum()) > B   # ±448: clipped
    back = q.dequantize_fp8(got, torch.from_numpy(s))
    want_back = jax.jit(jq.dequantize_fp8)(want, jnp.asarray(s))
    np.testing.assert_array_equal(_bits(back), _bits(want_back))
    assert not np.isnan(back.numpy()).any()


@pytest.mark.parametrize("token", ["f32", "bf16", "fp8"])
def test_slot_codec_matches_the_jitted_reference(token):
    x = _blocks(2)
    slot, s = q.encode_slot(torch.from_numpy(x), token)
    jslot, js = jax.jit(lambda a: jq.encode_slot(a, token))(jnp.asarray(x))
    assert slot.dtype == q.WA_DTYPES[token]
    np.testing.assert_array_equal(_bits(slot), _bits(jslot))
    assert (s is None) == (js is None) == (token != "fp8")
    if s is not None:
        np.testing.assert_array_equal(_bits(s), _bits(js))
    dec = q.decode_slot(slot, s)
    jdec = jax.jit(jq.decode_slot)(jslot, js)
    np.testing.assert_array_equal(_bits(dec), _bits(jdec))


def test_kahan_add_matches_the_jitted_reference():
    rng = np.random.RandomState(3)
    total = (rng.randn(4 * B) * 100).astype(np.float32)
    comp = (rng.randn(4 * B) * 1e-5).astype(np.float32)
    delta = (rng.randn(4 * B) * 1e-3).astype(np.float32)
    comp[:8] = 0.0
    delta[8:16] = -0.0
    got = q.kahan_add(*(torch.from_numpy(a) for a in (total, comp, delta)))
    want = jax.jit(jq.kahan_add)(*(jnp.asarray(a)
                                   for a in (total, comp, delta)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # with comp = 0 the total is the plain sum
    np.testing.assert_array_equal(_bits(got[0][:8]),
                                  _bits(total[:8] + delta[:8]))


@pytest.mark.parametrize("dtype", ["bf16", "fp8", None])
def test_ulp_measures_match_the_reference(dtype):
    rng = np.random.RandomState(4)
    a = (rng.randn(3000) * 10).astype(np.float32)
    b = a + (rng.randn(3000) * 0.05).astype(np.float32)
    a[:4] = [0.0, -0.0, 1e-30, -1e-30]
    b[:4] = [-0.0, 0.0, -1e-30, 2e-30]
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    if dtype is None:                  # the narrower operand's dtype
        tb, jb = tb.to(torch.bfloat16), jnp.asarray(b, jnp.bfloat16)
    else:
        jb = jnp.asarray(b)
    got = q.ulp_distance(ta, tb, dtype)
    want = np.asarray(jq.ulp_distance(jnp.asarray(a), jb, dtype))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    assert q.max_ulp(ta, tb, dtype) == jq.max_ulp(jnp.asarray(a), jb, dtype)
    if dtype is not None:
        np.testing.assert_allclose(
            q.rel_ulp_error(ta, tb, dtype),
            jq.rel_ulp_error(jnp.asarray(a), jnp.asarray(b), dtype),
            rtol=1e-6)


def test_tokens_spec_precision_and_fp8_bridge():
    assert [q.wa_token(t) for t in (torch.float32, "bfloat16", "fp8")] == \
        ["f32", "bf16", "fp8"]
    assert q.wa_dtype("float8_e4m3fn") is torch.float8_e4m3fn
    assert (q.is_compressed("f32"), q.is_compressed(torch.bfloat16),
            q.needs_scales("bf16"), q.needs_scales(torch.float8_e4m3fn)) \
        == (False, True, False, True)
    with pytest.raises(ValueError):
        q.wa_token(torch.float16)
    tree = {"a": np.zeros((5, 37), np.float32),
            "b": [np.zeros((3 * ALIGN,), np.float32)]}
    spec, jspec = pack_spec(params_from_numpy(tree, device="cpu")), \
        jax_pack_spec(tree)
    for tok in ("f32", "bf16", "fp8"):
        s, js = spec.with_ring_dtype(tok), jspec.with_ring_dtype(tok)
        assert (s.ring_dtype, s.scale_blocks) == (js.ring_dtype,
                                                  js.scale_blocks)
    assert spec.with_ring_dtype("f32") is spec
    # fp8 leaves cross the bridge as their uint8 bits, both ways
    x = np.asarray(jnp.asarray([0.0, -0.0, 448.0, -1.5, 2.0 ** -9],
                               jnp.float8_e4m3fn))
    t = params_from_numpy({"w": x}, device="cpu")["w"]
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))
    np.testing.assert_array_equal(params_to_numpy({"w": t})["w"],
                                  x.view(np.uint8))


def test_fma_rounds_once_like_the_jitted_reference():
    """``fma_f32`` is the single rounding XLA:CPU gives ``a * b + c`` under
    jit (a contracted FMA), incl. products on an f32 rounding tie that a
    tiny c must break (a plain f64 sum would round twice there)."""
    rng = np.random.RandomState(6)
    a = rng.randn(4096).astype(np.float32)
    b = (rng.randn(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(
        np.float32)
    c = (rng.randn(4096) * np.exp(rng.uniform(-40, 40, 4096))).astype(
        np.float32)
    tie = np.float32(1 + 2.0 ** -12)           # tie·tie = 1 + 2^-11 + 2^-24
    a[:2], b[:2], c[:2] = tie, tie, [2.0 ** -60, -2.0 ** -60]
    got = q.fma_f32(*(torch.from_numpy(x) for x in (a, b, c)))
    want = jax.jit(lambda x, y, z: x * y + z)(a, b, c)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert float(got[0]) == 1 + 2.0 ** -11 + 2.0 ** -23
    assert float(got[1]) == 1 + 2.0 ** -11
