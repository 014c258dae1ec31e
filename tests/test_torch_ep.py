"""The expert-parallel all-to-all MoE layer (``repro_torch.models.moe
.moe_forward_ep``) against the reference's (``repro.models.moe
.moe_forward_ep``), on the CPU, in f32, at the MoE archs' smoke configs:

- the reference runs on 4 forced host devices in a subprocess
  (``tests/ep_reference.py``: a ``(data 2, model 2)`` mesh, its output,
  ``aux`` and ``jax.grad`` of ``sum(out · g) + coef · aux``);
- the port runs on 4 spawned ``gloo`` ranks of the same mesh
  (``moe.ep_cases``), one CPU thread each, on the same numpy inputs:
  each rank its data rows, its block of the experts, the exchange over
  ``model``.

Outputs and gradients within 1e-5, ``aux`` within 1e-6, the kept and
dropped pairs equal on every shard. Cases: granite-moe at capacity 1.0
and S 64 (pairs dropped), at capacity 4.0 (none dropped), at S 63 (S does
not divide by the model axis: the batch-only split), and qwen2-moe, whose
shared experts the port adds (the reference's EP path drops them): there
the port equals the reference's EP output plus ``moe_forward_capacity``'s
shared term. The exchange's ledger: four all-to-alls a layer, two each
way.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_to_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import spawn_ranks
from repro_torch.models import moe
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

HERE = os.path.dirname(os.path.abspath(__file__))
MESH = {"data": 2, "model": 2}
#: (arch, (B, S), capacity factor)
CASES = {"drops": ("granite-moe-1b-a400m", (4, 64), 1.0),
         "no_drops": ("granite-moe-1b-a400m", (4, 64), 4.0),
         "batch_only": ("granite-moe-1b-a400m", (4, 63), 1.0),
         "shared": ("qwen2-moe-a2.7b", (4, 16), 1.25)}
COEF = 0.5
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs():
    """Per case: the config, one layer's leaves drawn by the port's init,
    and x and the output's cotangent g, from numpy."""
    out = []
    for i, (arch, (B, S), cf) in enumerate(CASES.values()):
        cfg = get_smoke_config(arch)
        p = {k: v[0] for k, v in moe.init_moe(
            cfg, 1, torch.Generator().manual_seed(i), torch.float32,
            "cpu").items()}
        rng = np.random.default_rng(i)
        x = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
        g = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
        out.append((cfg, p, x, g, cf))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's results (its subprocess started first) and the
    port's four ranks', each case's."""
    cases = _inputs()
    tmp = tmp_path_factory.mktemp("ep")
    src, dst = str(tmp / "in.npz"), str(tmp / "out.npz")
    arrays = {}
    for i, (cfg, p, x, g, cf) in enumerate(cases):
        arrays.update({f"arch_{i}": cfg.name, f"cf_{i}": cf,
                       f"coef_{i}": COEF, f"x_{i}": x, f"g_{i}": g})
        arrays.update({f"p_{i}_{k}": v
                       for k, v in params_to_numpy(p).items()})
    np.savez(src, **arrays)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(HERE, "..", "src"), os.environ.get("PYTHONPATH", "")]),
        JAX_PLATFORMS="cpu")
    ref = subprocess.Popen([sys.executable, os.path.join(
        HERE, "ep_reference.py"), src, dst], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        ranks = spawn_ranks(MESH, "repro_torch.models.moe:ep_cases", [
            {"cfg": cfg, "p": p, "x": torch.from_numpy(x),
             "g": torch.from_numpy(g), "cf": cf, "coef": COEF,
             "tp_layer": name == "no_drops"}
            for name, (cfg, p, x, g, cf) in zip(CASES, cases)],
            levels=[("data",), ("model",)], timeout=600)
    finally:
        log = ref.communicate(timeout=600)[0].decode()
    assert ref.returncode == 0, log[-3000:]
    return np.load(dst), [r["result"] for r in ranks], cases


def _coords(r):
    return divmod(r, MESH["model"])          # (data, model), row-major


@pytest.mark.parametrize("case", list(CASES))
def test_ep_output_aux_and_drops_match_reference(runs, case):
    ref, ranks, cases = runs
    i = list(CASES).index(case)
    cfg, _, x, _, _ = cases[i]
    B, S = x.shape[:2]
    seq = S % MESH["model"] == 0
    out = np.concatenate([ranks[r][i]["out"].numpy() for r in range(4)
                          if _coords(r)[1] == 0])
    np.testing.assert_allclose(out, ref[f"out_{i}"], **TOL)
    for r in range(4):         # every model rank holds its rows whole
        d, m = _coords(r)
        np.testing.assert_array_equal(
            ranks[r][i]["out"].numpy(), out[d * B // 2:(d + 1) * B // 2])
        keep = ranks[r][i]["keep"].numpy()
        np.testing.assert_array_equal(
            keep, ref[f"keep_{i}_{d}_{m if seq else 0}"])
    # the reference hands back model shard 0's aux, meaned over data
    aux = np.mean([float(ranks[r][i]["aux"]) for r in range(4)
                   if _coords(r)[1] == 0])
    np.testing.assert_allclose(aux, ref[f"aux_{i}"], rtol=1e-6, atol=1e-6)
    dropped = sum(int((~ranks[r][i]["keep"]).sum()) for r in range(4)
                  if seq or _coords(r)[1] == 0)
    if case in ("drops", "batch_only"):
        assert dropped > 0
    elif case == "no_drops":
        assert dropped == 0
    # the exchange: dispatch and return, forward and backward
    assert ranks[0][i]["collectives"]["model"]["all_to_all"] == 4


@pytest.mark.parametrize("case", list(CASES))
def test_ep_gradients_match_reference(runs, case):
    ref, ranks, cases = runs
    i = list(CASES).index(case)
    cfg, p, x, _, _ = cases[i]
    B = x.shape[0]
    gx = np.concatenate([ranks[r][i]["x_grad"].numpy() for r in range(4)
                         if _coords(r)[1] == 0])
    np.testing.assert_allclose(gx, ref[f"x_grad_{i}"], **TOL)
    for r in range(4):
        d = _coords(r)[0]
        np.testing.assert_array_equal(
            ranks[r][i]["x_grad"].numpy(), gx[d * B // 2:(d + 1) * B // 2])
    El = cfg.n_experts // MESH["model"]
    for k in p:
        blocks = [ranks[r][i]["grads"][k].numpy() for r in (0, 1)]
        if k == "router":
            got = np.concatenate(blocks, axis=1)
        elif k in ("w_gate", "w_up", "w_down"):
            got = np.concatenate(blocks, axis=0)
            assert blocks[0].shape[0] == El
        elif k in ("sh_gate", "sh_up"):
            got = np.concatenate(blocks, axis=1)
        elif k == "sh_down":
            got = np.concatenate(blocks, axis=0)
        else:                                    # sh_route: whole
            np.testing.assert_array_equal(blocks[0], blocks[1])
            got = blocks[0]
        np.testing.assert_allclose(got, ref[f"grad_{i}_{k}"], **TOL)


def test_ep_layer_equals_tp_layer_without_drops(runs):
    """At a capacity that drops nothing the expert-parallel layer is the
    tensor-parallel one (``moe_forward_sharded``, the experts' hidden
    dim split) on the same rows, within 1e-5."""
    _, ranks, _ = runs
    i = list(CASES).index("no_drops")
    for r in range(4):
        assert bool(ranks[r][i]["keep"].all())
        np.testing.assert_allclose(ranks[r][i]["out"].numpy(),
                                   ranks[r][i]["out_tp"].numpy(), **TOL)
