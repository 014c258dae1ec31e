"""The grouped and sharded packed layouts at work inside mesh-native runs
(``launch.train.run_mesh_native`` on spawned ``gloo`` ranks, the
granite-3-2b smoke config in f32), on the CPU:

- FSDP×TP (K 2 × data 2 × model 2, the grouped layout): a checkpointed
  f32 run, a bf16 ring and a resilient run with a NaN replica in one
  spawn: W̄ 0 ULP from its oracle (f32), the bf16 W̿ within 4 relative
  ULPs of an exact f32 window fed the exact means, the NaN replica
  quarantined through the health stats summed over the replica's ranks
  (``k_alive`` 1, then 2, W̿ finite), each call's collectives those its
  bundle declares;
- the f32 run's checkpoint (the grouped layout on disk as the
  reference's one logical buffer) resumed under K 2 × data 1 × model 1,
  with no step left to run: the loaded replicas and W̿ bit-equal to the
  run's, the window bit-equal after a repack into the new layout;
- the two-level tree with a model axis (pod 2 × replica 2 × model 2) at
  f32 and with the bf16 ring and payload: inner syncs cross no pod, W̄
  0 ULP at f32;
- the train step's exact collectives a level under FSDP×TP, with remat
  and for the MoE family, and a bf16 model's W̿ against the host's
  per-leaf reference; in the same spawn the expert-parallel MoE
  (``expert_parallel``), its all-to-alls exact, and every sync's
  reference audit verdict (``grouped_sync_ok``);
- the launcher's ``--mesh-native --fsdp --tp 2 --k 2 --world-size 8``
  line.
"""
import numpy as np
import pytest
import torch

from repro_torch.common.packing import merge_groups, repack, spec_from_json
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as launcher
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

RUN = dict(arch="granite-3-2b", device="cpu", steps=4, sync_period=2,
           window=3, batch_size=4, seq_len=16, lr=0.1, seed=0, k=2)


@pytest.fixture(autouse=True)
def _collective_timeout(monkeypatch):
    monkeypatch.setattr(launcher, "COLLECTIVE_TIMEOUT", 60.0)


def _args(**kw):
    return launcher.mesh_args(**dict(RUN, **kw))


def _bits_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.contiguous().view(torch.uint8),
                                           y.contiguous().view(torch.uint8))
        for x, y in zip(la, lb))


def test_fsdp_tp_grouped_runs_and_resume_elsewhere(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    grouped = dict(tp=2, fsdp=True, world_size=8)
    f32, bf16, nan = launcher.run_mesh_native(
        [_args(checkpoint_dir=ckpt, checkpoint_every=2, **grouped),
         _args(wa_dtype="bf16", **grouped),
         _args(resilient=True, inject_nan="2:1", steps=6, **grouped)],
        probe=["host", "outer", False], with_state=[True, False, False])
    for out in (f32, bf16, nan):
        assert out["mesh"] == {"replica": 2, "data": 2, "model": 2}
        assert out["layout"]["grouped"] and out["layout"]["n_groups"] >= 2
        assert launcher.contract_violations(out) == []
        assert out["wa_finite"]
    for h in f32["history"]:
        assert h["probe"]["mean_ulps"] == 0 and h["probe"]["restarts_equal"]
        assert h["probe"]["wa_host_ulps"] == 0
    for h in bf16["history"]:
        assert h["probe"]["restarts_equal"]
        assert h["probe"]["wa_rel_ulps"] <= 4.0
    assert [h["k_alive"] for h in nan["history"]] == [2, 1, 2]
    assert nan["k_alive_min"] == 1
    health = nan["ranks"][0]["syncs"][0]["declared"]
    assert health["data+model"] == {"all_reduce": 2}    # the stats' psum
    assert [s["step"] for s in f32["saves"]] == [2, 4]
    # the checkpoint of step 4 loaded under one rank a replica
    back = launcher.run_mesh_native(
        _args(checkpoint_dir=ckpt, checkpoint_every=2, resume=True))
    assert back["resumed_from"] == 4 and back["mesh"] == {"replica": 2}
    a, b = f32["_state"], back["_state"]
    assert _bits_equal(a["inner"], b["inner"])
    assert _bits_equal(a["wa"], b["wa"])
    src = spec_from_json(f32["layout"]["json"])
    dst = spec_from_json(back["layout"]["json"])
    for name in ("ring", "total"):
        assert torch.equal(repack(merge_groups(a[name], src), src, dst),
                           b[name])


def test_two_level_tree_with_a_model_axis():
    f32, bf16 = launcher.run_mesh_native(
        [_args(k=4, tp=2, sync_tree="two-level", outer_every=2),
         _args(k=4, tp=2, sync_tree="two-level", outer_every=2,
               wa_dtype="bf16", comms_dtype="bf16")],
        probe=[True, "outer"], with_state=False)
    for out, tok in ((f32, "f32"), (bf16, "bf16")):
        assert out["mesh"] == {"pod": 2, "replica": 2, "model": 2}
        assert [h["sync"] for h in out["history"]] == ["inner", "outer"]
        assert launcher.contract_violations(out) == []
        for rank in out["ranks"]:
            assert set(rank["train_collectives"]) == {"model"}
            inner, outer = rank["syncs"]
            assert set(inner["collectives"]) == {"replica"}
            assert set(outer["collectives"]) == {"replica", "pod"}
        for h in out["history"]:
            if "probe" not in h:
                continue
            assert h["probe"]["restarts_equal"]
            if tok == "f32":
                assert h["probe"]["mean_ulps"] == 0
            elif h["sync"] == "outer":
                assert h["probe"]["wa_rel_ulps"] <= 4.0


def test_launcher_fsdp_tp_line(capfd):
    launcher.main(["--device", "cpu", "--mesh-native", "--fsdp", "--tp", "2",
                   "--k", "2", "--world-size", "8", "--steps", "2",
                   "--sync-period", "2", "--window", "3", "--batch-size",
                   "4", "--seq-len", "8"])
    text = capfd.readouterr().out
    assert ("[mesh-native] 8 ranks {'replica': 2, 'data': 2, 'model': 2} "
            "on the CPU: backend gloo") in text
    assert "done: 1 outer cycles / 1 syncs" in text
    assert np.isfinite(float(text.split("final loss ")[1].split(",")[0]))


@pytest.fixture(scope="module")
def step_runs():
    """FSDP×TP (K 2 × data 2 × model 2), one spawn: a bf16 granite, a
    granite under remat "full", a qwen2-moe under remat "dots" with its
    experts' hidden dim split, and a qwen2-moe under remat "full" built
    with ``expert_parallel`` (its experts split over ``model``)."""
    form = dict(RUN, tp=2, fsdp=True, world_size=8)
    cfgs = [get_smoke_config("granite-3-2b").with_(dtype="bfloat16"),
            get_smoke_config("granite-3-2b").with_(remat="full"),
            get_smoke_config("qwen2-moe-a2.7b").with_(remat="dots"),
            get_smoke_config("qwen2-moe-a2.7b").with_(
                remat="full", expert_parallel=True)]
    return launcher.run_mesh_native(
        [launcher.mesh_args(**dict(form, arch=c.name)) for c in cfgs],
        cfg=cfgs, probe=["host", True, True, True], with_state=False,
        expert_parallel=[False, False, False, True])


def test_audit_and_ep_wait_for_their_items(step_runs):
    """The collective audit (A14) and the expert-parallel MoE (A17) under
    FSDP×TP: every sync of the four runs passes the reference's grouped
    verdict (one replica all-reduce, nothing crossing ``data`` or
    ``model``); the expert-parallel train step (qwen2-moe, the experts
    split over ``model``, the shared experts gathered) issues exactly the
    collectives it declares, six all-to-alls a layer a step under remat
    (dispatch and return, twice forward and once backward), and its
    syncs' W̄ are 0 ULP from their oracle."""
    for out in step_runs:
        assert launcher.audit_violations(out) == []
        for rank in out["ranks"]:
            for s in rank["syncs"]:
                assert s["audit"]["grouped_sync_ok"]
                assert s["audit"]["n_groups"] == out["layout"]["n_groups"]
    ep = step_runs[3]
    assert ep["layout"]["grouped"]
    assert launcher.contract_violations(ep) == []
    assert np.isfinite(ep["final_loss"]) and ep["wa_finite"]
    for rank in ep["ranks"]:
        assert rank["train_declared"]["model"]["all_to_all"] == 2 * 6
        assert rank["train_collectives"]["model"]["all_to_all"] \
            == 2 * 6 * RUN["steps"]
    for h in ep["history"]:
        assert h["probe"]["mean_ulps"] == 0 and h["probe"]["restarts_equal"]


def test_exact_step_collectives_under_remat_and_bf16_host_reference(
        step_runs):
    """FSDP×TP (K 2 × data 2 × model 2), one spawn: the train step
    declares exact counts a level (``bundles.par_step_collectives``),
    which the ledger meets, under remat too (the layer's forward runs
    again whole in the backward: its model-axis sums twice) and for the
    MoE family's split experts and shared experts; a bf16 model's W̿ is
    0 ULP from the host's per-leaf ``hwa_sync`` (the replicas widened to
    f32, as the packed sync means them)."""
    outs = step_runs[:3]
    # granite: the vocab's 4 sums, 2 layers of attention and MLP (2 sums
    # each, the forward's twice under remat); FSDP's 19 gathered leaves
    # (a gather and a backward sum each) and the data mean's sum a dtype
    # (bf16 gradients and the f32 loss; f32 both)
    want = [{"data": {"all_reduce": 21, "all_gather": 19},
             "model": {"all_reduce": 12, "all_gather": 1}},
            {"data": {"all_reduce": 20, "all_gather": 19},
             "model": {"all_reduce": 16, "all_gather": 1}},
            None]
    for out, w in zip(outs, want):
        assert launcher.contract_violations(out) == []
        for rank in out["ranks"]:
            assert rank["train_steps"] == RUN["steps"]
            if w is not None:
                assert rank["train_declared"] == w
    assert outs[2]["ranks"][0]["train_declared"]["model"]["all_reduce"] \
        == 4 + 2 * 3 * 3       # attention, experts, shared experts
    for h in outs[0]["history"]:
        assert h["probe"]["wa_host_ulps"] == 0
        assert h["probe"]["mean_ulps"] == 0
