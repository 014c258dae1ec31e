"""A data axis and a model axis inside a replica (``--mesh-native`` with
``--world-size``, ``--tp`` and ``--fsdp``: ``launch.train.run_mesh_native``
on spawned ``gloo`` ranks, one CPU thread each), on the smoke configs in
f32, against the JAX package's stacked ``hwa_inner_step``/``hwa_sync``
from the same initial weights on the same batches (the single-device
oracle):

- DP (K 2 × data 2), TP (K 2 × model 2; granite-3-2b, and qwen2-moe
  with its experts' hidden dim split), FSDP×TP (K 2 × data 2 × model 2,
  the grouped layout) and the rules' fall-through to ``head_dim`` (K 2 ×
  model 4: granite-3-2b's 2 kv heads, every kv head all-gathered and
  each rank keeping those its one q head reads; and a 2-head, 1-kv-head
  variant whose attention runs whole on every rank): per-step losses,
  final replicas, W̿, ring and total within 1e-5 after 4 steps (two
  syncs), as ``tests/mesh_hwa_check.py`` item 1 holds the reference's
  paths;
- every sync's W̄ 0 ULP from ``online_average_canonical`` of the
  replicas' blocks gathered before it, every rank restarted from it, and,
  for a split replica, rank 0's W̿ 0 ULP from the stacked per-leaf
  ``hwa_sync`` run on the host over the K replicas' blocks of rank 0's
  part (the whole state is held to the oracle within 1e-5 as above);
- the ledger a level: no replica-level collective in a train step
  (data- and model-level ones only, the data mean one sum a step), one
  replica-level all-reduce a sync and nothing else in it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.hwa import HWAConfig as JaxHWAConfig
from repro.core.hwa import hwa_init, hwa_inner_step, hwa_sync
from repro.models.registry import build_model as jax_build_model
from repro.optim import sgd as jax_sgd
from repro_torch.bridge import params_to_numpy
from repro_torch.common.packing import (merge_groups, pack_spec, repack,
                                        spec_from_json)
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launcher
from repro_torch.models.registry import build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RUN = dict(device="cpu", steps=4, sync_period=2, window=3, batch_size=4,
           seq_len=16, lr=0.1, seed=0)
FORMS = {"dp": dict(world_size=4), "tp": dict(tp=2),
         "fsdp_tp": dict(tp=2, fsdp=True, world_size=8)}


@pytest.fixture(autouse=True)
def _collective_timeout(monkeypatch):
    monkeypatch.setattr(launcher, "COLLECTIVE_TIMEOUT", 60.0)


_ORACLES = {}


def _oracle(arch, **over):
    """The JAX stacked run: per-step losses and the final state (the
    smoke config with ``over`` replaced)."""
    key = (arch, tuple(sorted(over.items())))
    if key in _ORACLES:
        return _ORACLES[key]
    port = build_model(get_smoke_config(arch).with_(**over)).init(
        torch.Generator().manual_seed(0), device="cpu")
    params = jax.tree.map(jnp.asarray, params_to_numpy(port))
    lm = jax_build_model(jax_smoke_config(arch).with_(**over))
    cfg = JaxHWAConfig(n_replicas=2, window=3)
    opt = jax_sgd(momentum=0.9, weight_decay=5e-4)
    state = hwa_init(cfg, params, opt)
    step = jax.jit(lambda s, b: hwa_inner_step(cfg, s, b, lm.loss, opt, 0.1))
    sync = jax.jit(lambda s: hwa_sync(cfg, s))
    losses = []
    for i in range(RUN["steps"]):
        b = launcher.mesh_batch(0, i, 2, 4, 16, lm.cfg.vocab_size)
        state, m = step(state, {k: jnp.asarray(v, jnp.int32)
                                for k, v in b.items()})
        losses.append(np.asarray(m["per_replica_loss"]))
        if (i + 1) % 2 == 0:
            state, _ = sync(state)
    _ORACLES[key] = (np.stack(losses), state)
    return _ORACLES[key]


def _f32(x):
    x = params_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.float32)


def _close(a, b, tol=1e-5):
    la = jax.tree.leaves(a, is_leaf=lambda t: isinstance(t, torch.Tensor))
    lb = jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(_f32(x), _f32(y), rtol=tol, atol=tol)


def _check(out, arch, split, **over):
    losses, state = _oracle(arch, **over)
    np.testing.assert_allclose(np.asarray(out["losses"]), losses,
                               rtol=1e-5, atol=1e-5)
    st = out["_state"]
    _close(st["inner"], state.inner)
    _close(st["wa"], state.wa)
    # the window in the run's layout, moved into the oracle's
    spec = spec_from_json(out["layout"]["json"])
    flat = pack_spec(build_model(get_smoke_config(arch).with_(**over))
                     .abstract()[0])
    for name in ("ring", "total"):
        buf = merge_groups(st[name], spec)
        _close(repack(buf, spec, flat), getattr(state.window_state, name))
    assert (out["cycles"], out["syncs"]) == (2, 2) and out["wa_finite"]
    for h in out["history"]:
        p = h["probe"]
        assert p["mean_ulps"] == 0 and p["restarts_equal"]
        assert p.get("wa_host_ulps", 0) == 0
        assert ("wa_host_ulps" in p) == split
    assert launcher.contract_violations(out) == []
    for rank in out["ranks"]:
        assert set(rank["train_collectives"]) <= {"data", "model"}
        for s in rank["syncs"]:
            assert {lvl: row["all_reduce"] for lvl, row in
                    s["collectives"].items()} == {"replica": 1}
            assert s["collectives"]["replica"]["all_gather"] == 0


@pytest.mark.parametrize("form", list(FORMS))
def test_parallel_run_matches_jax_stacked_hwa(form):
    runs = [launcher.mesh_args(**dict(RUN, arch="granite-3-2b", k=2,
                                      **FORMS[form]))]
    if form == "tp":        # the MoE family's split experts, same spawn
        runs.append(launcher.mesh_args(**dict(
            RUN, arch="qwen2-moe-a2.7b", k=2, **FORMS[form])))
    outs = launcher.run_mesh_native(runs, probe="host")
    lay = outs[0]["layout"]
    split = form != "dp"
    _check(outs[0], "granite-3-2b", split)
    if form == "dp":
        assert outs[0]["mesh"] == {"replica": 2, "data": 2}
        assert not lay["grouped"] and lay["shards"] == [1]
        for rank in outs[0]["ranks"]:     # the data mean: one sum a step
            assert rank["train_declared"] == {"data": {"all_reduce": 1}}
            assert rank["train_collectives"]["data"]["all_reduce"] == 4
    elif form == "tp":
        assert lay["shards"] == [2] and not lay["grouped"]
        assert outs[1]["layout"]["shards"] == [2]
        _check(outs[1], "qwen2-moe-a2.7b", True)
    else:
        assert outs[0]["mesh"] == {"replica": 2, "data": 2, "model": 2}
        assert lay["grouped"] and lay["n_groups"] >= 2
        assert set(outs[0]["ranks"][0]["train_collectives"]) == \
            {"data", "model"}


@pytest.mark.parametrize("over", [{}, {"n_heads": 2, "n_kv_heads": 1}])
def test_head_dim_fall_through_matches_jax_stacked_hwa(over):
    """At 4 model ranks granite-3-2b's smoke config has 2 kv heads: the
    rules split its k/v projections on ``head_dim``, which the layer
    all-gathers (its gradient summed back over ``model``). With 2 q
    heads the q and output projections fall through too, and the
    attention runs whole on each rank (the gathered leaves' gradients
    sliced, not summed)."""
    arch = "granite-3-2b"
    out = launcher.run_mesh_native(
        launcher.mesh_args(**dict(RUN, arch=arch, k=2, tp=4)),
        cfg=get_smoke_config(arch).with_(**over), probe="host")
    assert out["mesh"] == {"replica": 2, "model": 4}
    _check(out, arch, True, **over)

