"""The reference's expert-parallel MoE layer (``repro.models.moe
.moe_forward_ep``) on 4 forced host devices, as the CPU oracle of
``tests/test_torch_ep.py``:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        PYTHONPATH=src python tests/ep_reference.py IN.npz OUT.npz

``IN.npz`` holds, per case i: ``arch_i``, ``cf_i``, ``coef_i``, ``x_i``
(B, S, D), ``g_i`` (the output's cotangent) and the layer's leaves
``p_i_<leaf>``. On a ``(data 2, model 2)`` mesh the script writes, per
case: the output (plus the shared-expert term of ``moe_forward_capacity``
where the config has shared experts, which the reference's EP path
drops), ``aux``, the gradients of ``sum(out · g) + coef · aux`` with
respect to ``x`` and every leaf, and each shard's kept mask of its
(token, k) pairs (``keep_i_<d>_<m>``; one a data shard, ``m`` 0, where S
does not divide by the model axis), from the reference's ``_route`` and
its capacity rule.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.launch.mesh import make_test_mesh  # noqa: E402
from repro.models import moe  # noqa: E402
from repro.models.common import activation  # noqa: E402


def shared_term(cfg, p, x):
    """``moe_forward_capacity``'s shared-expert term (moe.py:143-150)."""
    B, S, D = x.shape
    xf = x.reshape(B * S, D)
    act = activation(cfg.act)
    h = (act((xf @ p["sh_gate"]).astype(jnp.float32))
         * (xf @ p["sh_up"]).astype(jnp.float32)).astype(x.dtype)
    shared = (h @ p["sh_down"]).astype(jnp.float32)
    gate = jax.nn.sigmoid(xf.astype(jnp.float32) @ p["sh_route"])
    return (gate * shared).reshape(B, S, D)


def keep_mask(cfg, p, xs, cf):
    """The kept pairs of one shard's tokens (moe.py:246-253)."""
    N = xs.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    _, top_i, _ = moe._route(cfg, p, xs)
    C = max(int(N * k * cf) // E, 8)
    flat_e = top_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    rank = (jnp.cumsum(onehot, axis=0) - 1)[jnp.arange(N * k), flat_e]
    return np.asarray(rank < C)


def main(src, dst):
    data = np.load(src)
    mesh = make_test_mesh((2, 2), ("data", "model"))
    n = len([k for k in data.files if k.startswith("arch_")])
    res = {}
    for i in range(n):
        cfg = get_smoke_config(str(data[f"arch_{i}"]))
        cf, coef = float(data[f"cf_{i}"]), float(data[f"coef_{i}"])
        pre = f"p_{i}_"
        p = {k[len(pre):]: jnp.asarray(data[k]) for k in data.files
             if k.startswith(pre)}
        x, g = jnp.asarray(data[f"x_{i}"]), jnp.asarray(data[f"g_{i}"])

        def f(x, p):
            out, aux = moe.moe_forward_ep(cfg, p, x, mesh=mesh,
                                          capacity_factor=cf)
            if cfg.n_shared_experts:
                out = (out.astype(jnp.float32)
                       + shared_term(cfg, p, x)).astype(x.dtype)
            return jnp.sum(out * g) + coef * aux, (out, aux)

        with jax.set_mesh(mesh):
            (_, (out, aux)), (gx, gp) = jax.jit(jax.value_and_grad(
                f, argnums=(0, 1), has_aux=True))(x, p)
        res[f"out_{i}"], res[f"aux_{i}"] = np.asarray(out), np.asarray(aux)
        res[f"x_grad_{i}"] = np.asarray(gx)
        for k, v in gp.items():
            res[f"grad_{i}_{k}"] = np.asarray(v)
        B, S, D = x.shape
        seq = S % 2 == 0
        for d in range(2):
            for m in range(2 if seq else 1):
                xs = x[d * B // 2:(d + 1) * B // 2]
                if seq:
                    xs = xs[:, m * S // 2:(m + 1) * S // 2]
                res[f"keep_{i}_{d}_{m}"] = keep_mask(
                    cfg, p, xs.reshape(-1, D), cf)
    np.savez(dst, **res)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
