"""A model axis for the recurrent families (``--mesh-native --tp 2`` on
xlstm-125m and hymba-1.5b), the expert-parallel train step and the
collective audit, on the CPU, with ``chip_smoke.py``'s phase 17
rehearsed at smoke size in the same spawn:

- the phase (``MESH_FULL`` off: 17a-c on the smoke configs, 17d's tp 2
  runs against the single-rank runs, the EP layer against the TP layer)
  passes its gates, the launch counts aside, which apply on the card;
- 17d's K 2 × model 2 runs in f32 (4 spawned ``gloo`` ranks, one CPU
  thread each, lr 0.03: these smoke models are chaotic at 0.3 in the
  reference itself, 4 steps, H 2) of xlstm, hymba and hymba with 3 heads
  (which do not divide by tp 2, as hymba-1.5b's 25 do not: its Mamba
  branch and attention run whole from gathered leaves): per-step losses,
  final replicas, W̿, ring and total within 1e-5 of the JAX package's
  stacked ``hwa_inner_step``/``hwa_sync`` from the same initial weights
  on the same batches (the single-device oracle); every W̄ 0 ULP from
  the canonical mean of the replicas' blocks and rank 0's W̿ 0 ULP from
  the stacked per-leaf ``hwa_sync`` on the host; every call's
  collectives exactly those its bundle declares
  (``bundles.par_step_collectives``), none of a train step on a replica
  level, every sync's audit verdicts holding;
- in the same spawn, both models under ``remat`` "full", and the
  expert-parallel train step (granite-moe smoke, its experts split over
  ``model``, capacity E/k so no pair drops, router loss weight 1) within
  1e-5 of the port's one-process stacked HWA on the plain layer whose
  router loss is the EP layer's (model shard 0's value, the mean of the
  shards' gradients), and not within it of the whole-batch router loss;
- FSDP × TP (K 2 × data 2 × model 2) for both families, xlstm's run
  checkpointed, then resumed under K 2 × data 1 × model 1: replicas and
  W̿ bit-equal, the window bit-equal after the repack;
- the reference's synthetic audit cases (``tests/test_sync_topology.py``:
  inner-only, the outer composition, a miswired joint grouping, assembly
  traffic, the flat keys) as recorded groups on a (pod 2, replica 2,
  model 2) mesh: the port's verdicts equal the reference's key by key;
  and groups as a rank logs them (``launch.mesh.record_groups``): a
  hypercube chain over a level of 4 is one all-reduce when its rounds
  joined the whole level, and not when the chain was cut short.
"""
import importlib.util
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis.collectives import sync_collective_audit as jax_audit
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.hwa import HWAConfig as JaxHWAConfig
from repro.core.hwa import hwa_init, hwa_inner_step, hwa_sync
from repro.models.registry import build_model as jax_build_model
from repro.optim import sgd as jax_sgd
from repro_torch.bridge import params_to_numpy
from repro_torch.common.packing import (merge_groups, pack_spec, repack,
                                        spec_from_json)
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs import get_smoke_config
from repro_torch.core import hwa as torch_hwa
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import MeshLayout
from repro_torch.launch.sync.bundles import (_mk_optimizer,
                                             sync_collective_audit)
from repro_torch.models import moe, transformer
from repro_torch.models.registry import build_model
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["xlstm-125m", "hymba-1.5b"]
#: 17d's smoke configs, by test id (``chip_smoke._rec_smoke_cfgs``)
SMOKE = ARCHS + ["hymba-1.5b-3heads"]
RUN = dict(device="cpu", steps=4, sync_period=2, window=3, batch_size=4,
           seq_len=16, lr=0.03, seed=0, k=2)
#: the EP step's router loss weight: large enough that the whole-batch
#: router loss's gradient moves the replicas off the EP step's by more
#: than the tolerance
EP_AUX = 1.0


@pytest.fixture(autouse=True)
def _collective_timeout(monkeypatch):
    monkeypatch.setattr(launcher, "COLLECTIVE_TIMEOUT", 60.0)


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _batches(run, i, vocab):
    return launcher.mesh_batch(run["seed"], i, run["k"], run["batch_size"],
                               run["seq_len"], vocab)


def _init_numpy(cfg, run):
    return params_to_numpy(build_model(cfg).init(
        torch.Generator().manual_seed(run["seed"]), device="cpu"))


def _oracle(init, jax_cfg, run):
    """The JAX stacked run from the port's initial weights ``init`` (numpy):
    per-step losses and the final state."""
    params = jax.tree.map(jnp.asarray, init)
    lm = jax_build_model(jax_cfg)
    hcfg = JaxHWAConfig(n_replicas=run["k"], window=run["window"])
    opt = jax_sgd(momentum=0.9, weight_decay=5e-4)
    state = hwa_init(hcfg, params, opt)
    step = jax.jit(lambda s, b: hwa_inner_step(hcfg, s, b, lm.loss, opt,
                                               run["lr"]))
    sync = jax.jit(lambda s: hwa_sync(hcfg, s))
    losses = []
    for i in range(run["steps"]):
        b = _batches(run, i, jax_cfg.vocab_size)
        state, m = step(state, {k: jnp.asarray(v, jnp.int32)
                                for k, v in b.items()})
        losses.append(np.asarray(m["per_replica_loss"]))
        if (i + 1) % run["sync_period"] == 0:
            state, _ = sync(state)
    return np.stack(losses), state


def _ep_oracle(cfg, run, tp, shard_mean=True):
    """The port's one-process stacked HWA (``core.hwa``) on the plain MoE
    layer, whose router loss is the expert-parallel layer's with
    ``shard_mean``: model shard 0's value (each shard the rank's block of
    the sequence), the mean of the ``tp`` shards' gradients; otherwise
    the plain layer's whole-batch router loss."""
    lm = build_model(cfg)
    params = lm.init(torch.Generator().manual_seed(run["seed"]),
                     device="cpu")
    hcfg = torch_hwa.HWAConfig(n_replicas=run["k"], window=run["window"])
    opt = _mk_optimizer("sgd")
    state = torch_hwa.hwa_init(hcfg, params, opt)
    plain = transformer.moe_forward

    def layer(cfg, p, x):
        out, aux = plain(cfg, p, x)
        if not shard_mean:
            return out, aux
        shards = [moe._route(cfg, p, blk.reshape(-1, x.shape[-1]))[2]
                  for blk in x.chunk(tp, dim=1)]
        mean = torch.stack(shards).mean()
        return out, shards[0].detach() + (mean - mean.detach())
    losses = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer, "moe_forward", layer)
        for i in range(run["steps"]):
            b = _batches(run, i, cfg.vocab_size)
            state, m = torch_hwa.hwa_inner_step(
                hcfg, state, {k: torch.from_numpy(v) for k, v in b.items()},
                lm.loss, opt, run["lr"])
            losses.append(m["per_replica_loss"].numpy())
            if (i + 1) % run["sync_period"] == 0:
                state, _ = torch_hwa.hwa_sync(hcfg, state)
    return np.stack(losses), state


@pytest.fixture(scope="module")
def phase17(tmp_path_factory):
    """chip_smoke.py's phase 17 at smoke size on the CPU, with this
    module's runs added to its K 2 × model 2 spawn (the two recurrent
    models under remat "full", the EP train step, which also saves its
    checkpoints into ``seen["ep_ckpt"]``); the JAX oracles of
    17d's runs run here meanwhile, in a thread that runs no torch
    operation, then the EP step's oracles. Returns
    (the phase's result, 17d's tp 2 runs, the added runs, the run's
    arguments, the JAX oracles, the EP oracles)."""
    smoke = _chip_smoke()
    run = dict(RUN, window=smoke.REC_TP_RUN["window"])
    cfgs = smoke._rec_smoke_cfgs()
    jax_cfgs = [jax_smoke_config(a) for a in ARCHS]
    jax_cfgs.append(jax_cfgs[1].with_(**smoke.REC_TP_ODD))
    ep_cfg = get_smoke_config("granite-moe-1b-a400m").with_(
        expert_parallel=True, router_aux_coef=EP_AUX,
        moe_capacity_factor=4 / 2)
    assert (ep_cfg.n_experts, ep_cfg.top_k) == (4, 2)
    extra = [(c.with_(remat="full"), False, False, False) for c in cfgs[:2]]
    extra.append((ep_cfg, True, True, True))
    ckpt = str(tmp_path_factory.mktemp("ep") / "ckpt")
    saves = [{}] * 2 + [dict(checkpoint_dir=ckpt, checkpoint_every=2)]
    seen = {"ep_ckpt": ckpt, "ep_cfg": ep_cfg}
    plain_run = launcher.run_mesh_native

    def shared(args, **kw):
        if not any(kw.get("expert_parallel") or [False]):
            return plain_run(args, **kw)
        n = len(args)
        seen["args"] = [vars(a) for a in args]
        outs = plain_run(
            list(args) + [launcher.mesh_args(**dict(run, arch=c.name,
                                                    tp=2, **save))
                          for (c, *_), save in zip(extra, saves)],
            cfg=kw["cfg"] + [c for c, *_ in extra],
            probe=kw["probe"] + [p for _, p, _, _ in extra],
            with_state=kw["with_state"] + [w for *_, w, _ in extra],
            expert_parallel=kw["expert_parallel"] + [e for *_, e in extra])
        seen["tp2"], seen["extra"] = outs[n - len(cfgs):n], outs[n:]
        return outs[:n]

    inits = [_init_numpy(c, run) for c in cfgs]
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(1) as pool:
        mp.setattr(smoke, "MESH_FULL", False)
        mp.setattr(launcher, "COLLECTIVE_TIMEOUT", 60.0)
        mp.setattr(launcher, "run_mesh_native", shared)
        oracles = pool.submit(lambda: [
            _oracle(p, j, run) for p, j in zip(inits, jax_cfgs)])
        res = smoke.phase_mesh_model_axis("cpu")
        jax_oracles = oracles.result()
    ep_oracles = [_ep_oracle(ep_cfg, run, 2, mean) for mean in (True, False)]
    return res, seen, run, jax_oracles, ep_oracles


def _f32(x):
    x = params_to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.float32)


def _close(a, b, tol=1e-5):
    la = jax.tree.leaves(a, is_leaf=lambda t: isinstance(t, torch.Tensor))
    lb = jax.tree.leaves(b, is_leaf=lambda t: isinstance(t, torch.Tensor))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(_f32(x), _f32(y), rtol=tol, atol=tol)


def _bits_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.contiguous().view(torch.uint8),
                                           y.contiguous().view(torch.uint8))
        for x, y in zip(la, lb))


def _contracts(out):
    assert launcher.contract_violations(out) == []
    assert launcher.audit_violations(out) == []
    for rank in out["ranks"]:
        assert set(rank["train_collectives"]) <= {"data", "model"}
        for s in rank["syncs"]:
            a = s["audit"]
            assert a["replica"] == [("all_reduce", "replica")]
            assert a["assembly_free"]


def test_chip_smoke_phase17_on_cpu(phase17):
    res, seen, run, _, _ = phase17
    for args in seen["args"][-3:]:
        assert {k: args[k] for k in run} == dict(run, device="cpu")
    assert set(res["smoke"]["tp_vs_single"]) == {
        "xlstm-125m", "hymba-1.5b", "hymba-1.5b (3 heads)"}
    assert all(d <= 1e-5 for d in res["smoke"]["tp_vs_single"].values())
    assert res["smoke"]["ep_vs_tp"] <= 1e-3
    assert 0 < res["ep"]["pairs"] and res["ep"]["all_to_all"] == 2 * 4


@pytest.mark.parametrize("case", SMOKE)
def test_recurrent_tp_matches_jax_stacked_hwa(phase17, case):
    _, seen, run, oracles, _ = phase17
    out = seen["tp2"][SMOKE.index(case)]
    cfg = _chip_smoke()._rec_smoke_cfgs()[SMOKE.index(case)]
    assert out["mesh"] == {"replica": 2, "model": 2}
    losses, state = oracles[SMOKE.index(case)]
    np.testing.assert_allclose(np.asarray(out["losses"]), losses,
                               rtol=1e-5, atol=1e-5)
    st = out["_state"]
    _close(st["inner"], state.inner)
    _close(st["wa"], state.wa)
    spec = spec_from_json(out["layout"]["json"])
    flat = pack_spec(build_model(cfg).abstract()[0])
    for name in ("ring", "total"):
        _close(repack(merge_groups(st[name], spec), spec, flat),
               getattr(state.window_state, name))
    assert (out["cycles"], out["syncs"]) == (2, 2) and out["wa_finite"]
    for h in out["history"]:
        p = h["probe"]
        assert p["mean_ulps"] == 0 and p["restarts_equal"]
        assert p["wa_host_ulps"] == 0
    _contracts(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_recurrent_tp_exact_collectives_under_remat(phase17, arch):
    """The forward's model-axis sums and gathers run twice a step under
    remat, the backward's once; the gathers of the leaves before a layer
    once."""
    _, seen, run, _, _ = phase17
    plain = seen["tp2"][ARCHS.index(arch)]
    remat = seen["extra"][ARCHS.index(arch)]
    _contracts(remat)
    want = plain["ranks"][0]["train_declared"]["model"]
    got = remat["ranks"][0]["train_declared"]["model"]
    assert got["all_reduce"] > want["all_reduce"]
    assert np.isfinite(remat["final_loss"])
    for rank in remat["ranks"]:
        assert rank["train_collectives"]["model"]["all_reduce"] \
            == got["all_reduce"] * run["steps"]


def test_ep_train_step_matches_the_shard_mean_oracle(phase17):
    """The expert-parallel train step, at a capacity that drops nothing:
    its losses (rank 0's router loss value, model shard 0's), replicas,
    W̿ and window within 1e-5 of the one-process run of the plain layer
    with the EP layer's router loss, whose gradient is the mean over the
    model shards'; the whole-batch router loss's run is off by more."""
    _, seen, run, _, (oracle, whole) = phase17
    ep = seen["extra"][2]
    _contracts(ep)
    assert sum(r["ep_pairs"]["dropped"] for r in ep["ranks"]) == 0
    assert all(r["ep_pairs"]["pairs"] > 0 for r in ep["ranks"])
    losses, state = oracle
    np.testing.assert_allclose(np.asarray(ep["losses"]), losses,
                               rtol=1e-5, atol=1e-5)
    st = ep["_state"]
    _close(st["inner"], state.inner)
    _close(st["wa"], state.wa)
    gap = max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(st["inner"]), tree_leaves(whole[1].inner)))
    assert gap > 1e-4
def test_ep_replica_resumes_elsewhere(phase17):
    """The expert-parallel replica (K 2 × model 2, its experts split over
    ``model``) saved its checkpoints at steps 2 and 4 in the phase's
    spawn; resumed under K 2 whole (one rank a replica, the plain MoE
    layer), the state of step 4 is the uninterrupted run's bit for bit:
    the replicas, W̿, and the ring and total after the repack into the
    whole layout."""
    _, seen, run, _, _ = phase17
    ep = seen["extra"][2]
    assert [s["step"] for s in ep["saves"]] == [2, 4]
    back = launcher.run_mesh_native(launcher.mesh_args(**dict(
        run, arch=seen["ep_cfg"].name, checkpoint_dir=seen["ep_ckpt"],
        checkpoint_every=2, resume=True)), cfg=seen["ep_cfg"])
    assert back["resumed_from"] == 4 and back["mesh"] == {"replica": 2}
    a, b = ep["_state"], back["_state"]
    assert _bits_equal(a["inner"], b["inner"])
    assert _bits_equal(a["wa"], b["wa"])
    src = spec_from_json(ep["layout"]["json"])
    dst = spec_from_json(back["layout"]["json"])
    for name in ("ring", "total"):
        assert torch.equal(repack(merge_groups(a[name], src), src, dst),
                           b[name])


def test_recurrent_fsdp_tp_and_resume_elsewhere(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    form = dict(RUN, tp=2, fsdp=True, world_size=8, steps=2)
    x, h = launcher.run_mesh_native(
        [launcher.mesh_args(**dict(form, arch=ARCHS[0], checkpoint_dir=ckpt,
                                   checkpoint_every=2)),
         launcher.mesh_args(**dict(form, arch=ARCHS[1]))],
        probe=True, with_state=[True, False])
    for out in (x, h):
        assert out["mesh"] == {"replica": 2, "data": 2, "model": 2}
        _contracts(out)
        for hist in out["history"]:
            assert hist["probe"]["mean_ulps"] == 0
    back = launcher.run_mesh_native(launcher.mesh_args(**dict(
        RUN, arch=ARCHS[0], steps=2, checkpoint_dir=ckpt,
        checkpoint_every=2, resume=True)))
    assert back["resumed_from"] == 2 and back["mesh"] == {"replica": 2}
    a, b = x["_state"], back["_state"]
    assert _bits_equal(a["inner"], b["inner"])
    assert _bits_equal(a["wa"], b["wa"])
    src = spec_from_json(x["layout"]["json"])
    dst = spec_from_json(back["layout"]["json"])
    for name in ("ring", "total"):
        assert torch.equal(repack(merge_groups(a[name], src), src, dst),
                           b[name])


def test_audit_of_a_flat_sync_over_four_replicas():
    """K 4 flat (granite-3-2b smoke, 4 ranks): each sync's two two-way
    all-reduce rounds (the ledger's two) are logged as the one all-reduce
    over the four replicas that their rounds joined, on every rank."""
    out = launcher.run_mesh_native(launcher.mesh_args(**dict(
        RUN, arch="granite-3-2b", k=4, steps=2, lr=0.1)), with_state=False)
    assert out["mesh"] == {"replica": 4}
    assert launcher.audit_violations(out) == []
    for rank in out["ranks"]:
        (s,) = rank["syncs"]
        assert s["collectives"]["replica"]["all_reduce"] == 2
        assert s["audit"]["replica"] == [("all_reduce", "replica")]
        assert s["audit"]["replica_allreduce_only"]


# ------------------------------------------------ the audit's verdicts
#
# The reference's synthetic HLO (tests/test_sync_topology.py): a (pod 2,
# replica 2, model 2) mesh, device = pod·4 + replica·2 + model.

_MESH = MeshLayout({"pod": 2, "replica": 2, "model": 2})
_GROUPS = {"inner": [[0, 2], [1, 3], [4, 6], [5, 7]],
           "outer": [[0, 4], [1, 5], [2, 6], [3, 7]],
           "joint": [[0, 2, 4, 6], [1, 3, 5, 7]],
           "model": [[0, 1], [2, 3], [4, 5], [6, 7]]}
_LINES = {name: (f"  %ar.{i} = f32[1024]{{0}} all-reduce(f32[1024]{{0}} "
                 f"%p0), replica_groups={{"
                 + ",".join("{" + ",".join(map(str, g)) + "}" for g in gs)
                 + "}, to_apply=%add")
          for i, (name, gs) in enumerate(_GROUPS.items())}
_AUDITS = {"inner_only": ["inner"], "outer_composition": ["inner", "outer"],
           "joint": ["joint"], "joint_beside": ["inner", "outer", "joint"],
           "assembly": ["inner", "model"], "flat": ["inner"]}


class _JaxMesh:
    """The reference's mesh interface its audit reads."""
    axis_names = tuple(_MESH.shape)
    devices = np.arange(8).reshape(2, 2, 2)


def _verdicts(a):
    keys = ("replica_allreduce_only", "assembly_free", "inner_sync_ok",
            "outer_sync_ok")
    return {k: a[k] for k in keys} | {
        "n": (len(a["replica"]), len(a["outer"]), len(a["mixed"]),
              {ax: len(h) for ax, h in a["other"].items()})}


@pytest.mark.parametrize("case", list(_AUDITS))
def test_audit_verdicts_equal_the_reference(case):
    outer = None if case == "flat" else "pod"
    names = _AUDITS[case]
    want = jax_audit("\n".join(_LINES[n] for n in names), _JaxMesh(),
                     replica_axis="replica", outer_axis=outer, n_groups=2)
    got = sync_collective_audit([("all_reduce", _GROUPS[n]) for n in names],
                                _MESH, replica_axis="replica",
                                outer_axis=outer, n_groups=2)
    assert _verdicts(got) == _verdicts(want)
    assert got["grouped_sync_ok"] == want["grouped_sync_ok"]
    assert got["n_groups"] == want["n_groups"] == 2


def test_audit_reads_a_sync_from_the_ledger():
    """Syncs as a rank logs their groups (``launch.mesh.record_groups``):
    the two-level tree's outer sync on (pod 2, replica 2, model 2), one
    all-reduce a level; a flat sync over a replica level of 4, whose
    hypercube chain is one all-reduce over the ranks its two rounds
    joined, and the same chain cut short after one round, whose group is
    half its level; a compressed outer level's all-gathers, which are
    not its all-reduce; a group across ``model`` (assembly); a miswired
    group that joins replicas of two pods (mixed)."""
    def log(*entries):
        return [(op, [g]) for op, g in entries]
    tree = sync_collective_audit(log(("all_reduce", [0, 2]),
                                     ("all_reduce", [0, 4])), _MESH,
                                 outer_axis="pod")
    assert tree["outer_sync_ok"] and not tree["inner_sync_ok"]
    assert tree["outer"] == [("all_reduce", "pod")]
    flat4 = MeshLayout({"replica": 4, "model": 2})
    whole = sync_collective_audit(log(("all_reduce", [1, 3, 5, 7])), flat4)
    assert whole["replica_allreduce_only"] and whole["assembly_free"]
    cut = sync_collective_audit(log(("all_reduce", [1, 3])), flat4)
    assert not cut["replica_allreduce_only"]
    assert cut["replica"] == [("partial_all_reduce", "replica")]
    fp8 = sync_collective_audit(
        log(("all_reduce", [0, 2]), ("all_gather", [0, 4]),
            ("all_gather", [0, 4])), _MESH, outer_axis="pod")
    assert not fp8["outer_sync_ok"]
    assert fp8["outer"] == [("all_gather", "pod")] * 2
    leak = sync_collective_audit(log(("all_reduce", [0, 2]),
                                     ("all_reduce", [0, 1])), _MESH)
    assert not leak["assembly_free"]
    assert leak["other"]["model"] == [("all_reduce", "model")]
    wired = sync_collective_audit(log(("all_reduce", [0, 6])), _MESH,
                                  outer_axis="pod")
    assert not (wired["inner_sync_ok"] or wired["outer_sync_ok"])
    assert wired["mixed"] == [("partial_all_reduce", "pod+replica")]
