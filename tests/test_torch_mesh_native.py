"""The port's mesh-native HWA (``launch.train.run_mesh_native``: K spawned
``gloo`` ranks, one replica each) on the CPU, on the granite-3-2b smoke
config.

- An 8-step K = 2 flat run (H 2, I 3, lr 0.1) against the JAX stacked
  ``hwa_inner_step``/``hwa_sync`` from the same initial weights on the
  same batches: per-step losses, final replicas, W̿, ring and total within
  1e-5, as ``tests/mesh_hwa_check.py`` property 1 holds its paths (the
  two packages' matmuls sum in different orders). Every sync's W̄ is 0 ULP
  from ``online_average_canonical`` of the replicas gathered before it,
  and every rank restarts from it.
- The collective ledger: no collective in any rank's train step, and each
  sync exactly the collectives its bundle declares.
- A 4-rank two-level run (2 pods of 2, H₂ 2) at f32, and with the bf16
  and fp8 ring and cross-pod payload: inner syncs cross no pod and push
  no window; every W̄ is 0 ULP from ``online_average_grouped``/
  ``pod_mean_grouped`` at f32; compressed W̿ within the reference's
  budgets (4 relative ULPs) of an exact f32 window fed the exact means
  of the same replicas; the cross-pod payload 2 or 1 bytes an element
  (plus the fp8 scales).
- A mesh-native checkpoint session that the JAX package's
  ``CheckpointSession`` verifies and loads, bit for bit.
- The launcher's command line, its JSON, and its refusals.

The three mesh legs of the fault check run in
``tests/test_torch_resilience.py`` (``test_fault_check_leg``).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.hwa import HWAConfig as JaxHWAConfig
from repro.core.hwa import hwa_init, hwa_inner_step, hwa_sync
from repro.core.offline import window_init as jax_window_init
from repro.models.registry import build_model as jax_build_model
from repro.optim import sgd as jax_sgd
from repro.resilience import CheckpointSession as JaxSession
from repro_torch.bridge import params_to_numpy
from repro_torch.common.packing import ALIGN
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launcher
from repro_torch.models.registry import build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCH = "granite-3-2b"
RUN = dict(arch=ARCH, device="cpu", steps=8, sync_period=2, window=3,
           batch_size=4, seq_len=16, lr=0.1, seed=0)


@pytest.fixture(autouse=True)
def _collective_timeout(monkeypatch):
    """A hang fails within a minute, not at the suite's time limit."""
    monkeypatch.setattr(launcher, "COLLECTIVE_TIMEOUT", 60.0)


def _args(**kw):
    return launcher.mesh_args(**dict(RUN, **kw))


def _f32(x):
    x = params_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.float32)


def _close(a, b, tol=1e-5):
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_allclose(_f32(x), _f32(y), rtol=tol, atol=tol)


def _sync_lvl(n_reduce, P, n_gather=0, nbytes=None):
    return {"all_reduce": n_reduce, "all_gather": n_gather, "gather": 0,
            "barrier": 0, "bytes": 4 * P * n_reduce if nbytes is None
            else nbytes, "staged_bytes": 0}


def _padded(params):
    n = sum(x.numel() for x in jax.tree.leaves(
        params, is_leaf=lambda t: isinstance(t, torch.Tensor)))
    return -(-n // ALIGN) * ALIGN


def test_flat_run_matches_jax_stacked_hwa():
    out = launcher.run_mesh_native(_args(k=2), probe=True)
    assert out["backend"] == "gloo" and out["mesh"] == {"replica": 2}
    assert (out["cycles"], out["syncs"]) == (4, 4) and out["wa_finite"]
    # the JAX stacked path from the port's initial weights
    port_params = build_model(get_smoke_config(ARCH)).init(
        torch.Generator().manual_seed(0), device="cpu")
    params = jax.tree.map(jnp.asarray, params_to_numpy(port_params))
    lm = jax_build_model(jax_smoke_config(ARCH))
    cfg = JaxHWAConfig(n_replicas=2, window=3)
    opt = jax_sgd(momentum=0.9, weight_decay=5e-4)
    state = hwa_init(cfg, params, opt)
    step = jax.jit(lambda s, b: hwa_inner_step(cfg, s, b, lm.loss, opt, 0.1))
    sync = jax.jit(lambda s: hwa_sync(cfg, s))
    losses = []
    for i in range(8):
        b = launcher.mesh_batch(0, i, 2, 4, 16, lm.cfg.vocab_size)
        state, m = step(state, {k: jnp.asarray(v, jnp.int32)
                                for k, v in b.items()})
        losses.append(np.asarray(m["per_replica_loss"]))
        if (i + 1) % 2 == 0:
            state, _ = sync(state)
    np.testing.assert_allclose(np.asarray(out["losses"]), np.stack(losses),
                               rtol=1e-5, atol=1e-5)
    st = out["_state"]
    _close(st["inner"], state.inner)
    _close(st["wa"], state.wa)
    _close(st["ring"], state.window_state.ring)
    _close(st["total"], state.window_state.total)
    # every W̄ is the canonical mean of the replicas gathered before it
    for h in out["history"]:
        assert h["sync"] == "outer"
        assert h["probe"]["mean_ulps"] == 0
        assert h["probe"]["restarts_equal"]
    # no collective in a train step; one two-way all-reduce a sync
    P = _padded(port_params)
    for r, rank in enumerate(out["ranks"]):
        assert rank["rank"] == r and rank["train_collectives"] == {}
        assert [s["collectives"] for s in rank["syncs"]] == \
            [{"replica": _sync_lvl(1, P)}] * 4


@pytest.mark.parametrize("tok", ["f32", "bf16", "fp8"])
def test_two_level_run(tok):
    out = launcher.run_mesh_native(
        _args(k=4, sync_tree="two-level", outer_every=2, wa_dtype=tok,
              comms_dtype=tok), probe=True)
    assert out["mesh"] == {"pod": 2, "replica": 2}
    hist = out["history"]
    assert [h["sync"] for h in hist] == ["inner", "outer"] * 2
    assert [h.get("cycle") for h in hist] == [None, 1, None, 2]
    assert out["cycles"] == 2 and out["syncs"] == 4 and out["wa_finite"]
    P = _padded(build_model(get_smoke_config(ARCH)).init(
        torch.Generator().manual_seed(0), device="cpu"))
    for h in hist:
        rec = h["probe"]
        assert rec["restarts_equal"], h
        if tok == "f32" or h["sync"] == "inner":
            assert rec["mean_ulps"] == 0, h
        if h["sync"] == "outer" and tok != "f32":
            assert rec["wa_rel_ulps"] <= 4.0, h
    pod = {"f32": _sync_lvl(1, P),
           "bf16": _sync_lvl(0, P, 1, 2 * P),
           "fp8": _sync_lvl(0, P, 2, P + 4 * (P // ALIGN))}[tok]
    for rank in out["ranks"]:
        assert rank["train_collectives"] == {}
        colls = [s["collectives"] for s in rank["syncs"]]
        inner_only = {"replica": _sync_lvl(1, P)}
        assert colls == [inner_only, dict(inner_only, pod=pod)] * 2
        # the CPU runs the plain window update: no kernel launch
        assert not any(rank["launches"].values())


def test_checkpoint_verifies_and_loads_in_the_jax_session(tmp_path):
    d = str(tmp_path / "ckpt")
    out = launcher.run_mesh_native(_args(k=2, checkpoint_dir=d,
                                         checkpoint_every=4, keep=2))
    sess = JaxSession(d)
    assert sess.steps() == [4, 8] and sess.latest_intact() == 8
    assert sess.verify(8) == (True, [])
    meta = sess.meta(8)
    assert (meta["step"], meta["cycle"], meta["sync_idx"]) == (8, 4, 4)
    assert [h["step"] for h in meta["history"]] == [2, 4, 6, 8]
    st = out["_state"]
    like = jax.tree.map(lambda x: np.zeros_like(x),
                        params_to_numpy(st["inner"]))
    inner = sess.load(8, "inner", like)
    for a, b in zip(jax.tree.leaves(inner), jax.tree.leaves(
            params_to_numpy(st["inner"]))):
        assert np.array_equal(np.asarray(a), b)
    one = jax.tree.map(lambda x: jnp.zeros(x.shape[1:], x.dtype), like)
    ws = sess.load_window(8, jax_window_init(one, 3))
    assert np.array_equal(np.asarray(ws.ring), params_to_numpy(st["ring"]))
    assert np.array_equal(np.asarray(ws.total),
                          params_to_numpy(st["total"]))
    assert (int(ws.count), int(ws.next_idx)) == (3, 1)


def test_launcher_cli_and_refusals(tmp_path, capfd):
    path = tmp_path / "out.json"
    launcher.main(["--device", "cpu", "--mesh-native", "--k", "2",
                   "--steps", "4", "--sync-period", "2", "--window", "3",
                   "--batch-size", "2", "--seq-len", "8", "--out",
                   str(path)])
    text = capfd.readouterr().out
    assert "[mesh-native] 2 ranks {'replica': 2} on the CPU: backend gloo" \
        in text
    assert "[mesh-native] step 4 loss" in text and "done: 2 outer" in text
    rec = json.loads(path.read_text())
    assert rec["syncs"] == 2 and "_state" not in rec
    assert len(rec["losses"]) == 4 and len(rec["losses"][0]) == 2
    for argv, err in [
            (["--tp", "2", "--arch", "internvl2-1b"], SystemExit),
            (["--tp", "2", "--attn-impl", "flash_pallas"], SystemExit),
            (["--tp", "2", "--world-size", "6"], SystemExit),
            (["--comms-dtype", "bf16"], SystemExit),
            (["--sync-tree", "two-level", "--k", "3"], SystemExit),
            (["--inject-nan", "2:5"], SystemExit),
            (["--resume"], SystemExit),
            (["--sync-tree", "two-level", "--k", "4", "--resilient",
              "--comms-dtype", "fp8"], SystemExit)]:
        with pytest.raises(err, match="LM families|--tp must stay 1|"
                                      "divisible by "
                                      "K×tp|two-level|K divisible|out of "
                                      "range|--resume|resilient"):
            launcher.main(["--device", "cpu", "--mesh-native"] + argv)
    # the recurrent families take a model axis (their run:
    # tests/test_torch_mesh_recurrent.py)
    for arch in ("xlstm-125m", "hymba-1.5b"):
        launcher._check_mesh_args(launcher.mesh_args(arch=arch, tp=2))
    for argv in (["--inject-nan", "2:1"], ["--wa-dtype", "bf16"]):
        with pytest.raises(SystemExit, match="--mesh-native"):
            launcher.main(["--device", "cpu"] + argv)


def test_chip_smoke_phase15_on_cpu(monkeypatch):
    """chip_smoke.py's phase 15 at smoke size on the CPU (the smoke
    granite-3-2b, 16 tokens a replica, the flash kernels' plain
    versions): the same gates but the launch counts, which apply on the
    card only; 15d's legs over 15a's checkpoints."""
    import importlib.util
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "MESH_FULL", False)
    monkeypatch.setattr(smoke, "MESH_RUN", dict(smoke.MESH_RUN, device="cpu",
                                                seq_len=16))
    out = smoke.phase_mesh("cpu")
    flat = out["flat"]
    assert flat["bitwise"] is False or flat["wa_rel_ulps"] == 0.0
    assert flat["loss_err"] <= smoke.MESH_LOSS_TOL
    assert [c["step"] for c in flat["saves"]] == [4, 8]
    for tok in ("f32", "bf16", "fp8"):
        assert [h["sync"] for h in out["tree"][tok]["history"]] == \
            ["inner", "outer"]
    assert sorted(out["faults"]) == ["corrupt-fallback", "nan-replica"]
    assert all(r["ok"] for r in out["faults"].values())
