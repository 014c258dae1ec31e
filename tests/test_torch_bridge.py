"""The bridge from JAX parameter trees (as numpy) to the port's tensors:
a bit-exact round trip, bf16 included, that keeps the tree's structure
and leaf order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.models.registry import build_model
from repro_torch.bridge import params_from_numpy, params_to_numpy
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_bit_exact(dtype):
    cfg = get_smoke_config("gemma2-27b").with_(dtype=dtype)
    tree = jax.device_get(build_model(cfg).init(jax.random.key(0)))
    params = params_from_numpy(tree, device="cpu")
    back = params_to_numpy(params, bf16_dtype=jnp.bfloat16)
    leaves, treedef = jax.tree.flatten(tree)
    tleaves, ttreedef = jax.tree.flatten(params)
    bleaves, btreedef = jax.tree.flatten(back)
    assert treedef == ttreedef == btreedef
    for a, t, b in zip(leaves, tleaves, bleaves):
        assert str(a.dtype) == str(t.dtype).replace("torch.", "")
        assert a.dtype == b.dtype and a.shape == b.shape
        # compare bits, so NaN payloads and signed zeros count too
        bits = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        np.testing.assert_array_equal(a.view(bits), b.view(bits))


def test_bf16_values_cross_exactly():
    x = np.asarray(jnp.asarray([1.0, -0.0, 3.140625, 1e-8, np.inf],
                               jnp.bfloat16))
    t = params_from_numpy({"w": x}, device="cpu")["w"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), x.astype(np.float32))
    bits = params_to_numpy({"w": t})["w"]
    assert bits.dtype == np.uint16
    np.testing.assert_array_equal(bits, x.view(np.uint16))
