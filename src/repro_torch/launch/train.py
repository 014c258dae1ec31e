"""Training launcher of the port: HWA and every paper baseline on the
smoke config of an architecture, with preemption-safe checkpoints.

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 8 --k 2 --window 3 --sync-period 2 \
      --checkpoint-dir ckpt --checkpoint-every 4 --keep 2 [--resume]
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --method sam --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --steps 8 --k 2 --window 3 --sync-period 2 --resilient \
      [--max-param-rms 10]

Runs on the card unless ``--device cpu``. Mirrors the JAX package's
launcher (``repro.launch.train``), whose checkpoint directories it reads
and writes. ``--resilient`` and ``--max-param-rms`` select the
alive-masked sync (``HWAConfig.resilient``). A caller that builds its own
``TrainConfig`` passes any ``HWAConfig`` window (stride, streaming,
kernels) through the Trainer unchanged. The vlm and audio archs are
refused, as the JAX launcher refuses them: their batches carry vision
embeddings or codebook streams, which the Trainer's (tokens, targets)
pipeline does not; ``core.hwa``'s functions take them.

``--mesh-native`` runs :func:`run_mesh_native` instead: K processes, one
replica each, on ``torch.distributed`` (``launch.mesh``), one sync
every ``--sync-period`` steps and no collective in between:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --mesh-native --k 2 --steps 8 --sync-period 2 --window 3 \
      --batch-size 4 --seq-len 16
  ... --mesh-native --sync-tree two-level --k 4 --outer-every 2 \
      [--wa-dtype bf16|fp8 --comms-dtype bf16|fp8]

The launcher spawns the ranks itself (the counterpart of the reference's
forced host devices); on the card it builds the kernels first.
``--sync-tree two-level`` carves the replicas into ``--pods`` contiguous
pods that average internally every H steps; only every
``--outer-every``-th sync crosses pods and pushes the window.
``--wa-dtype`` compresses the ring, ``--comms-dtype`` the cross-pod
payload, ``--inject-nan STEP:REPLICA`` poisons a replica (with
``--resilient`` it is quarantined).

A replica may span several ranks, on the reference's ``(replica, data,
model)`` mesh (``(pod, replica, data, model)`` under the tree):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --mesh-native --fsdp --tp 2 --k 2 --world-size 8 --steps 4 \
      --sync-period 2 --window 3 --batch-size 4 --seq-len 16

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --mesh-native --tp 2 --arch xlstm-125m --k 2 --steps 4 \
      --sync-period 2 --window 3 --batch-size 4 --seq-len 16 --lr 0.03

``--world-size`` is the number of ranks, the counterpart of the
reference's device count (its default, K·tp, gives ``data`` 1); ``data =
world / (K·tp)``. ``--tp`` splits each replica's layers over ``model``
(tensor parallelism; the recurrent families' heads where they divide),
``--fsdp`` its ``embed`` weight dims over ``data``; the batch rows of a
replica split over ``data``. The command line never splits the MoE
experts, as the reference's mesh-native launcher does not: a caller of
:func:`run_mesh_native` passes ``expert_parallel=True`` for a config
with ``expert_parallel=True`` (the reference's rules-carrying
builders), whose layer is then ``moe.moe_forward_ep``. ``--attn-impl
flash_pallas`` runs the reference's manual step (parameters whole on
each rank, gradients averaged over ``data``) and refuses ``--tp > 1``,
as the reference does. The command line trains
the smoke config; a caller of :func:`run_mesh_native` passes any model
config (``chip_smoke.py`` passes the published width cut in depth).
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.core.hwa import HWAConfig
from repro_torch.data import DataPipeline, make_markov_lm_dataset
from repro_torch.device import resolve_device
from repro_torch.models.registry import build_model
from repro_torch.train.trainer import METHODS, PARALLEL, TrainConfig, \
    Trainer, lm_task

#: seconds before a mesh-native process group gives up on a collective (a
#: rank waits at a barrier while rank 0 writes a checkpoint)
COLLECTIVE_TIMEOUT = 300.0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b", choices=ARCH_IDS)
    ap.add_argument("--method", default="hwa", choices=list(METHODS))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-size", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--k", type=int, default=2, help="HWA replicas K")
    ap.add_argument("--sync-period", type=int, default=0, help="H (0=epoch)")
    ap.add_argument("--window", type=int, default=10, help="I")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attn-impl", default="",
                    choices=["", "naive", "flash_pallas"],
                    help="override the arch's attention implementation; "
                         "flash_pallas selects the flash kernels (their "
                         "plain versions on the CPU)")
    ap.add_argument("--resilient", action="store_true",
                    help="alive-masked sync: a replica whose weights go "
                         "non-finite (or whose RMS exceeds "
                         "--max-param-rms) is excluded from the K-mean "
                         "and re-seeded from W̄ at the next sync")
    ap.add_argument("--max-param-rms", type=float, default=0.0,
                    help="resilient only: divergence threshold on a "
                         "replica's parameter RMS (0 = finiteness only)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="preemption-safe checkpoint session directory "
                         "(manifest-last + CRC-verified)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="steps between checkpoints (0 = off)")
    ap.add_argument("--keep", type=int, default=3,
                    help="checkpoints retained (older ones are removed)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the newest INTACT checkpoint in "
                         "--checkpoint-dir (bit-exact: torn or corrupted "
                         "saves are skipped)")
    ap.add_argument("--mesh-native", action="store_true",
                    help="K replicas on spawned processes (each on "
                         "data x model ranks) on torch.distributed: one "
                         "sync every H steps and no collective across "
                         "replicas in between")
    ap.add_argument("--sync-tree", default="flat",
                    choices=["flat", "two-level"],
                    help="sync topology (mesh-native only): flat = one "
                         "global reduction per sync; two-level = pods "
                         "average internally every sync, the cross-pod "
                         "reduction + window push every --outer-every "
                         "syncs")
    ap.add_argument("--outer-every", type=int, default=2,
                    help="H₂: outer (cross-pod) sync period of the "
                         "two-level tree, in syncs")
    ap.add_argument("--pods", type=int, default=0,
                    help="pod count for --sync-tree two-level "
                         "(0 = auto: 2)")
    ap.add_argument("--wa-dtype", default="f32",
                    choices=["f32", "bf16", "fp8"],
                    help="mesh-native only: WA ring storage dtype (bf16, "
                         "or fp8 with per-block f32 scales; the running "
                         "total stays f32 with Kahan compensation). f32 "
                         "is bit-equal to the uncompressed path")
    ap.add_argument("--comms-dtype", default="f32",
                    choices=["f32", "bf16", "fp8"],
                    help="mesh-native only: cross-pod sync payload dtype "
                         "(needs --sync-tree two-level; incompatible "
                         "with --resilient)")
    ap.add_argument("--fsdp", action="store_true",
                    help="mesh-native only: FSDP inside a replica (the "
                         "embed weight dims split over the data axis)")
    ap.add_argument("--tp", type=int, default=1,
                    help="mesh-native only: tensor parallelism inside a "
                         "replica (the model axis)")
    ap.add_argument("--world-size", type=int, default=0,
                    help="mesh-native only: ranks in all, the "
                         "reference's device count (0 = K*tp); the data "
                         "axis is world / (K*tp)")
    ap.add_argument("--inject-nan", default="",
                    help="fault injection (mesh-native only): STEP:REPLICA "
                         "— poison that replica's weights with NaN before "
                         "that step")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    return ap


def mesh_args(**kw) -> argparse.Namespace:
    """The launcher's defaults as a Namespace for :func:`run_mesh_native`,
    with ``kw`` (underscored flag names) replacing them."""
    ns = _parser().parse_args([])
    for k, v in kw.items():
        if not hasattr(ns, k):
            raise AttributeError(f"no launcher flag {k!r}")
        setattr(ns, k, v)
    return ns


def mesh_config(args):
    """The model config of a mesh-native run from the command line: the
    smoke config with the ``--attn-impl`` override."""
    cfg = get_smoke_config(args.arch)
    if args.attn_impl:
        cfg = cfg.with_(attn_impl=args.attn_impl)
    return cfg


def mesh_batch(seed: int, step: int, K: int, batch_size: int, seq_len: int,
               vocab: int) -> dict:
    """Step ``step``'s (K, B, S) tokens and targets, drawn with numpy from
    (seed, step): the port's own stream (the reference draws them with
    ``jax.random`` from 1000 + step). Every rank draws the whole batch
    and takes its own row."""
    rng = np.random.default_rng([seed, step])
    shape = (K, batch_size, seq_len)
    return {"tokens": rng.integers(0, vocab, shape, dtype=np.int64),
            "targets": rng.integers(0, vocab, shape, dtype=np.int64)}


def _mesh_shape(args) -> dict[str, int]:
    """The rank mesh: ``{"replica": K}`` or ``{"pod": G, "replica": K //
    G}``, then ``data`` and ``model`` where larger than 1, row-major."""
    K = args.k
    tp = max(args.tp, 1)
    world = args.world_size or K * tp
    if world % (K * tp) or world // (K * tp) < 1:
        raise SystemExit(
            f"--mesh-native needs a world size divisible by K×tp="
            f"{K * tp} (have {world}; set --world-size)")
    if args.sync_tree != "two-level":
        shape = {"replica": K}
    else:
        pods = args.pods or 2
        if K % pods or K // pods < 1:
            raise SystemExit(f"--sync-tree two-level needs K divisible by "
                             f"--pods (K={K}, pods={pods})")
        shape = {"pod": pods, "replica": K // pods}
    for axis, n in (("data", world // (K * tp)), ("model", tp)):
        if n > 1:
            shape[axis] = n
    return shape


def _mesh_plan(args, K: int):
    from repro_torch.launch.sync import SyncPlan, TwoLevel
    tree = args.sync_tree == "two-level"
    topo = (TwoLevel("replica", "pod", outer_every=args.outer_every)
            if tree else None)
    hwa_cfg = HWAConfig(n_replicas=K, window=args.window,
                        outer_every=args.outer_every if tree else 1,
                        resilient=args.resilient,
                        max_param_rms=args.max_param_rms or None,
                        use_kernels=True)
    try:
        return SyncPlan(hwa=hwa_cfg, topology=topo, wa_dtype=args.wa_dtype,
                        comms_dtype=args.comms_dtype, optimizer="sgd",
                        lr=args.lr)
    except ValueError as e:
        raise SystemExit(f"invalid --wa-dtype/--comms-dtype combination: "
                         f"{e}") from None


def _parse_inject(args, K: int):
    if not args.inject_nan:
        return None
    s, _, r = args.inject_nan.partition(":")
    inject = (int(s), int(r))
    if not 0 <= inject[1] < K:
        raise SystemExit(f"--inject-nan replica {inject[1]} out of range "
                         f"[0, {K})")
    return inject


def _check_mesh_args(args, cfg=None) -> None:
    """The launcher's refusals of a mesh-native run, before any spawn:
    the reference's (``flash_pallas`` with ``--tp > 1``, the vlm and audio
    families, the divisibility of the world size and of the batch over
    ``data``)."""
    shape = _mesh_shape(args)
    cfg = cfg or mesh_config(args)
    if cfg.attn_impl == "flash_pallas" and args.tp > 1:
        raise SystemExit("--attn-impl flash_pallas runs the fully-manual "
                         "DP-only train step; --tp must stay 1")
    if cfg.family in ("vlm", "audio"):
        raise SystemExit(f"{args.arch}: the mesh-native launcher supports "
                         "LM families only")
    data = shape.get("data", 1)
    if args.batch_size % data:
        raise SystemExit(f"the per-replica batch {args.batch_size} must "
                         f"divide over the data axis (size {data})")
    _mesh_plan(args, args.k)
    _parse_inject(args, args.k)
    if args.resume and not (args.checkpoint_dir and args.checkpoint_every):
        raise SystemExit("--resume needs --checkpoint-dir and "
                         "--checkpoint-every")


def run_mesh_native(args, *, cfg=None, probe=False, with_state=True,
                    digest: bool = False, expert_parallel=False):
    """Train with the mesh-native HWA steps: spawned ranks
    (``launch.mesh.spawn_ranks``) on a mesh of ``{"replica": K}`` or, with
    ``--sync-tree two-level``, ``{"pod": G, "replica": K // G}``, then
    ``data`` and ``model`` where a replica spans several ranks
    (``--world-size``, ``--tp``). Inter-replica traffic happens only
    inside the syncs: the paper's H-fold communication amortization (×H₂
    more across pods under the tree), executed across processes.

    ``args`` is the launcher's Namespace, or a list of them over one mesh
    (its shape, tree and device): one spawn then runs them in turn, the
    ranks' start-up paid once, and a list of results comes back. ``cfg``
    (a ``ModelConfig``, or a list of them, one a run) replaces the smoke
    config of ``--arch``; ``probe``, ``with_state`` and
    ``expert_parallel`` may be lists too. ``expert_parallel`` builds the
    train step with the MoE experts split over ``model``
    (``bundles.replica_layout``; the config must set
    ``expert_parallel=True``); the command line never sets it.

    Returns rank 0's result with the reference's keys (``history`` with
    ``"sync": "inner"|"outer"``, ``cycles``, ``syncs``, ``wa_finite``,
    ``k_alive_min``, and ``_state``: the final stacked replicas, W̿, ring
    and total on the CPU, or only the keys in ``with_state`` when it is a
    tuple, none when it is false), and the port's: ``losses`` (per step,
    per replica), ``backend``, ``resumed_from`` (the step, or None),
    ``saves`` (rank 0's checkpoint seconds and GB), ``launches`` (every
    rank's kernel launches summed), ``layout`` (the sync's packed layout:
    grouped or not, its groups' shards, its JSON) and ``ranks`` (per
    rank: its train steps' collectives and their declared ones, each
    sync's kind, ms, collectives, declared collectives and audit
    verdicts (``bundles.sync_collective_audit``), the rest
    steps', its launches and the launches its bundles declare for the
    card, its peak device memory, the expert-parallel layer's pairs and
    dropped pairs). ``probe`` gathers the replicas around
    every sync (``"outer"``: every outer sync) and holds rank 0's W̄
    against ``core.online``'s canonical, grouped or pod mean of them on
    its device (``history[i]["probe"]``); ``"host"`` also holds a split
    replica's W̿ (rank 0's blocks) against the stacked per-leaf
    ``hwa_sync`` of the K replicas' blocks on rank 0's host
    (``wa_host_ulps``); a list gives each run its own. ``digest``
    adds ``digest``: the SHA-256 of
    the final replicas, W̿, ring and total, key by key, without moving
    them to this process. Process groups time out after
    :data:`COLLECTIVE_TIMEOUT` seconds."""
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    from repro_torch.launch.sync.bundles import INNER_AXES
    runs = list(args) if isinstance(args, (list, tuple)) else [args]
    cfgs = list(cfg) if isinstance(cfg, (list, tuple)) else [cfg] * len(runs)
    first = runs[0]
    for a, c in zip(runs, cfgs):
        _check_mesh_args(a, c)
        if (_mesh_shape(a), a.sync_tree, a.device) != (
                _mesh_shape(first), first.sync_tree, first.device):
            raise ValueError("runs of one spawn share the mesh, the sync "
                             "tree and the device")
    K = first.k
    shape = _mesh_shape(first)
    world = int(np.prod(list(shape.values())))
    dev = resolve_device(first.device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = backend_for(dev.type, world, n_cards)
    if dev.type == "cuda":
        from repro_torch.kernels import build
        build.build_all()          # once here, not in K ranks at once
    where = (f"{n_cards} card(s)" if dev.type == "cuda" else "the CPU")
    print(f"[mesh-native] {world} ranks {shape} on {where}: backend "
          f"{backend}"
          + (" (ranks share a card: CUDA tensors staged through host "
             "memory)" if backend == "gloo" and dev.type == "cuda" else ""))
    topo = _mesh_plan(first, K).resolved_topology
    inner = tuple(a for a in shape if a in INNER_AXES)
    levels = (topo.psum_groups() + (topo.inner_groups()
                                    if first.sync_tree == "two-level" else ())
              + (topo.replica_axes,) + tuple((a,) for a in inner)
              + ((inner,) if inner else ()))
    ranks = spawn_ranks(shape, "repro_torch.launch.train:mesh_rank",
                        {"runs": [vars(a) for a in runs], "cfg": cfgs,
                         "probe": (list(probe) if isinstance(probe, list)
                                   else [probe] * len(runs)),
                         "with_state": (list(with_state)
                                        if isinstance(with_state, list)
                                        else [with_state] * len(runs)),
                         "expert_parallel": (
                             list(expert_parallel)
                             if isinstance(expert_parallel, list)
                             else [expert_parallel] * len(runs)),
                         "digest": digest},
                        device=first.device, levels=levels,
                        collective_timeout=COLLECTIVE_TIMEOUT)
    outs = []
    for i in range(len(runs)):
        stats = [r["result"][i]["rank_stats"] for r in ranks]
        out = ranks[0]["result"][i]
        out.pop("rank_stats")
        out["backend"] = backend
        out["ranks"] = stats
        out["launches"] = {k: sum(r["launches"][k] for r in out["ranks"])
                           for k in out["ranks"][0]["launches"]}
        print(f"[mesh-native] done: {out['cycles']} outer cycles / "
              f"{out['syncs']} syncs, final loss {out['final_loss']:.4f}, "
              f"wa_finite {out['wa_finite']}")
        outs.append(out)
    return outs if isinstance(args, (list, tuple)) else outs[0]


#: elements of a packed buffer the probe moves or reads at a time
PROBE_CHUNK = 1 << 22


def _digest(buf) -> list[int]:
    """Two sums of a packed buffer's bits as int64 (plain, and weighted
    by position mod 127 + 1), a chunk at a time: equal digests mean equal
    buffers but for a collision."""
    s = w = 0
    for c in range(0, buf.numel(), PROBE_CHUNK):
        bits = buf[c:c + PROBE_CHUNK].view(torch.int32).to(torch.int64)
        pos = torch.arange(c, c + bits.numel(), device=buf.device) % 127
        s += int(bits.sum())
        w += int((bits * (pos + 1)).sum())
    return [s, w]


def _probe(mesh, before, params, spec, mean, kind, pods, shadow, ws, tok):
    """Rank 0's check of one sync against ``core.online``: W̄ (the packed
    mean it restarted from, in its local layout ``spec``) against the
    canonical (flat), grouped (outer) or pod (inner) mean of the replicas'
    blocks gathered before the sync (``before``, on the host: the K
    replicas' blocks of rank 0's part), computed on
    rank 0's device a chunk of columns at a time; every rank's restarted
    blocks against those of the first rank holding the same blocks in its
    pod (digests); for a compressed ring or payload, W̄ and, after an
    outer sync, W̿ against the exact f32 ``shadow`` window fed the exact
    means (on the host), in ``tok``'s relative ULPs. Every rank takes
    part in the digest gather; the others return None."""
    from repro_torch.common.packing import pack
    from repro_torch.common.quant import max_ulp, rel_ulp_error
    from repro_torch.core.offline import window_update_packed
    from repro_torch.core.online import (online_average_canonical,
                                         online_average_grouped,
                                         pod_mean_grouped)
    from repro_torch.launch.shards import inner_key, replica_index
    from repro_torch.launch.sync.packed import window_average_local
    dev = mesh.device
    digest = torch.tensor(_digest(pack(params, spec)), device=dev)
    digests = mesh.all_gather(digest, tuple(mesh.shape), level="probe")
    if mesh.rank != 0:
        return None
    def oracle(t):
        if kind == "inner":
            return pod_mean_grouped(t, pods)["w"]
        if pods == 1:
            return online_average_canonical(t)["w"][None]
        return online_average_grouped(t, pods)["w"][None]

    P = before.shape[1]
    want0 = torch.empty((P,), dtype=torch.float32)   # rank 0's row
    ulps = 0
    for c in range(0, P, PROBE_CHUNK):
        w = oracle({"w": before[:, c:c + PROBE_CHUNK].to(dev)})[0]
        ulps = max(ulps, max_ulp(mean[c:c + PROBE_CHUNK], w))
        want0[c:c + PROBE_CHUNK] = w.cpu()
    K = before.shape[0]
    per_pod = K // (pods if kind == "inner" else 1)

    def lead(r):
        g = replica_index(mesh, r) // per_pod
        return next(q for q in range(mesh.world)
                    if inner_key(mesh, q) == inner_key(mesh, r)
                    and replica_index(mesh, q) // per_pod == g)
    rec = {"mean_ulps": ulps,
           "restarts_equal": all(bool(torch.equal(digests[r],
                                                  digests[lead(r)]))
                                 for r in range(mesh.world))}
    if tok != "f32":
        rec["mean_rel_ulps"] = rel_ulp_error(want0, mean.cpu(), tok)
        if kind == "outer":
            shadow[0], _ = window_update_packed(shadow[0], want0)
            rec["wa_rel_ulps"] = rel_ulp_error(
                window_average_local(shadow[0]),
                window_average_local(ws).cpu(), tok)
    return rec


def _host_reference(mesh, state, before, lspec, window):
    """The per-leaf check of a sync of a split replica (rank 0): the K
    replicas' blocks of rank 0's part (``before``: their packed rows,
    gathered before the sync) as leaf trees on the host, widened to f32,
    stepped by the stacked ``core.hwa.hwa_sync`` (plain, no kernel) into
    ``state`` (a host ``HWAState``, its window fed every outer sync).
    Widened, a leaf's mean is the f32 W̄ the packed sync pushes (a bf16
    model's stacked ``hwa_sync`` would round W̄ to bf16 before the
    push). Returns the state; ``None`` elsewhere."""
    from repro_torch.common.packing import pack_spec, unpack
    from repro_torch.common.pytree import tree_map
    from repro_torch.core.hwa import HWAConfig as Cfg
    from repro_torch.core.hwa import HWAState, hwa_sync
    from repro_torch.core.offline import WindowState
    if mesh.rank != 0:
        return None
    stacked = tree_map(lambda x: x.float(), unpack(before, lspec))
    if state is None:
        fspec = pack_spec(tree_map(lambda x: x[0], stacked))
        zero = torch.zeros((), dtype=torch.int32)
        ws = WindowState(ring=torch.zeros((window, fspec.padded)),
                         total=torch.zeros((fspec.padded,)), count=zero,
                         next_idx=zero.clone(), window=window, spec=fspec)
        state = HWAState(inner=None, inner_opt={}, window_state=ws,
                         wa=None, cycle=zero.clone(), step=zero.clone())
    state.inner = stacked
    state, _ = hwa_sync(Cfg(n_replicas=before.shape[0], window=window),
                        state)
    return state


def _ops(row: dict) -> dict:
    from repro_torch.launch.mesh import _OPS
    return {op: n for op, n in row.items() if op in _OPS and n}


def contract_violations(out) -> list[str]:
    """Where a :func:`run_mesh_native` result leaves its bundles'
    collective contracts (``StepBundle.contract``), rank by rank: the
    train steps, from the ledger (a step is not recorded), issue exactly
    the collectives they declare, a step's count times the steps, and
    never cross a replica axis; every recorded sync and rest call passes
    the ``collectives`` pass (:func:`recorded_violations`). Each entry
    names its pass. An empty list: every call kept its contract."""
    from repro_torch.launch.sync.bundles import INNER_AXES
    bad = []
    for rank in out["ranks"]:
        r = rank["rank"]
        want = rank["train_declared"]
        used = {lvl: _ops(row) for lvl, row in
                rank["train_collectives"].items() if _ops(row)}
        for lvl in sorted(set(used) | set(want)):
            got = used.get(lvl, {})
            if set(lvl.split("+")) - set(INNER_AXES):
                bad.append(f"collectives: rank {r}: a train step crossed "
                           f"{lvl}: {got}")
            elif got != {op: n * rank["train_steps"]
                         for op, n in want.get(lvl, {}).items() if n}:
                bad.append(f"collectives: rank {r}: train steps issued "
                           f"{lvl} {got}, declared {want.get(lvl)} a step")
    return bad + recorded_violations(out, ("collectives",))


def recorded_violations(out, names=("collectives", "dtype", "donation")
                        ) -> list[str]:
    """The ``analysis.passes`` named in ``names`` on every sync and rest
    call a :func:`run_mesh_native` result recorded, against its bundle's
    contract: each violation names its pass, rank and call. The calls
    were timed, so the dtype pass holds the payloads and arguments (no
    op was recorded)."""
    from repro_torch.analysis.passes import run_passes
    bad = []
    for rank in out["ranks"]:
        calls = [(f"{c['sync']} sync {i}", c)
                 for i, c in enumerate(rank["syncs"])]
        calls += [(f"rest {i}", c) for i, c in enumerate(rank["rests"])]
        for label, c in calls:
            for res in run_passes(c["artifacts"], c["contract"], names):
                bad += [f"{res.name}: rank {rank['rank']}: {label}: {v}"
                        for v in res.violations]
    return bad


def audit_violations(out) -> list[str]:
    """Where a :func:`run_mesh_native` result's syncs leave the
    reference's audit verdicts (``bundles.sync_collective_audit``, each
    sync's on every rank): a flat sync ``replica_allreduce_only`` and
    ``assembly_free``, ``grouped_sync_ok`` for a grouped layout; the
    tree's inner syncs ``inner_sync_ok`` and its outer ones
    ``outer_sync_ok``, or, with a compressed cross-pod payload, its
    all-gathers (one for bf16, two for fp8: payload and scales) as the
    only outer traffic, nothing mixed, assembly-free. A resilient run is
    held to its contracts only: its alive count and health stats are
    collectives of their own. An empty list: every verdict holds."""
    if out["resilient"]:
        return []
    bad = []
    tree = out["sync_tree"] == "two-level"
    n_gather = {"f32": 0, "bf16": 1, "fp8": 2}[out["comms_dtype"]]
    for rank in out["ranks"]:
        for i, c in enumerate(rank["syncs"]):
            a = c["audit"]
            if not tree:
                ok = a["replica_allreduce_only"] and a["assembly_free"] \
                    and a.get("grouped_sync_ok", True)
            elif c["sync"] == "inner":
                ok = a["inner_sync_ok"]
            elif n_gather:
                ok = (a["outer"] == [("all_gather", "pod")] * n_gather
                      and not a["mixed"] and a["assembly_free"])
            else:
                ok = a["outer_sync_ok"]
            if not ok:
                bad.append(f"audit: rank {rank['rank']}: {c['sync']} sync "
                           f"{i} fails its verdicts: {a}")
    return bad


def _add(acc: dict, rows: dict, times: int = 1) -> None:
    """``acc[level][op] += times * rows[level][op]``."""
    for lvl, row in rows.items():
        into = acc.setdefault(lvl, {})
        for k, v in row.items():
            into[k] = into.get(k, 0) + times * v


def _sha256(tree) -> str:
    """SHA-256 of a tree's leaf bytes, in leaf order."""
    from repro_torch.common.pytree import tree_leaves
    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().contiguous().cpu().reshape(-1)
                 .view(torch.uint8).numpy())
    return h.hexdigest()


def mesh_rank(mesh, payload) -> list[dict]:
    """One rank of :func:`run_mesh_native` (spawned by
    ``launch.mesh.spawn_ranks``): each run of ``payload["runs"]`` in turn.
    Returns a list with, per run, rank 0's result and every rank's
    ``rank_stats``."""
    out = []
    for run, probe, keep, cfg, ep in zip(
            payload["runs"], payload["probe"], payload["with_state"],
            payload["cfg"], payload["expert_parallel"]):
        out.append(_mesh_rank_run(mesh, argparse.Namespace(**run), probe,
                                  dict(payload, with_state=keep, cfg=cfg,
                                       expert_parallel=ep)))
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def _mesh_rank_run(mesh, args, probe, payload) -> dict:
    """One run on one rank: the rank's part of its replica stepped by the
    train bundle with no collective across replicas, the sync or
    inner-sync bundle every H steps (and the rest bundle after a sync
    where it exists), checkpoints gathered to rank 0 (on the host). The
    ledger and the launch counts of every call are kept beside the
    call's contract."""
    from repro_torch.common.packing import pack, spec_to_json, unpack
    from repro_torch.common.pytree import tree_flatten, tree_leaves, \
        tree_map
    from repro_torch.common.quant import wa_token
    from repro_torch.core.offline import WindowState
    from repro_torch.launch import shards
    from repro_torch.analysis.passes import record_call
    from repro_torch.launch.mesh import (kernel_counts, ledger_delta,
                                         ledger_snapshot)
    from repro_torch.launch.sync import build_hwa_bundles, window_state_args
    from repro_torch.launch.sync.bundles import (_mk_optimizer,
                                                 sync_collective_audit)
    from repro_torch.models.parallel import blocks_of, places_tree

    t_start = time.perf_counter()
    K, rank, dev = args.k, mesh.rank, mesh.device
    rep = shards.replica_index(mesh)
    lead = rank == 0
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    launched0 = kernel_counts()
    from repro_torch.models import moe
    moe.ep_tally(reset=True)
    cfg = payload["cfg"] or mesh_config(args)
    lm = build_model(cfg)
    plan = _mesh_plan(args, K)
    topo = plan.resolved_topology
    pods = topo.pods(mesh) if plan.is_tree else 1
    all_axes = tuple(mesh.shape)
    full = lm.init(torch.Generator(device=dev).manual_seed(args.seed),
                   device=dev)
    bundles = build_hwa_bundles(lm, mesh, plan, full, fsdp=args.fsdp,
                                expert_parallel=payload["expert_parallel"],
                                seq_len=args.seq_len)
    train, sync, inner_sync = bundles.train, bundles.sync, bundles.inner_sync
    rest, layout = bundles.rest, bundles.layout
    spec = sync.pack_spec                  # global; a rank holds lspec
    lspec = spec.local_spec()
    split = spec.is_sharded
    abs_params = lm.abstract()[0]
    flat_abs, _ = tree_flatten(abs_params)
    # where the parameters rest: whole on each rank (the flash_pallas
    # step, or an unsplit replica) or as the rank's blocks
    whole = layout.whole or not layout.split
    p_places = (places_tree(abs_params, [()] * len(flat_abs),
                            [(None,) * x.dim() for x in flat_abs])
                if whole else layout.places)
    if whole:
        params = full
    else:
        params = tree_map(lambda x: x.contiguous().clone(),
                          blocks_of(full, p_places, mesh))
        del full
        if cuda:        # ranks may share the card: hand the replica back
            torch.cuda.empty_cache()
    del flat_abs

    def view(tree):
        """The blocks the sync packs: the rank's part of the layout."""
        return blocks_of(tree, layout.places, mesh) if layout.split \
            and whole else tree
    opt = _mk_optimizer("sgd")  # the train bundle's optimizer
    opt_state = opt.init(params)
    abs_opt = opt.init(abs_params)
    o_places = {k: p_places for k in abs_opt}    # moments mirror params
    p_layout = shards.tree_layout(abs_params, p_places, mesh)
    o_layout = shards.tree_layout(abs_opt, o_places, mesh)
    w_layout = shards.tree_layout(abs_params, layout.places, mesh)
    ws, cycle = window_state_args(bundles, device=dev)
    # W̿ before the first sync: the initial weights (the train step
    # writes the parameters in place)
    wa = tree_map(torch.clone, view(params))
    H = args.sync_period or 8
    inject = _parse_inject(args, K)
    tok = wa_token(plan.wa_dtype)

    session = None
    if args.checkpoint_dir and args.checkpoint_every > 0:
        from repro_torch.resilience.session import CheckpointSession
        session = CheckpointSession(args.checkpoint_dir, keep=args.keep)

    def log(msg):
        if lead:
            print(f"[mesh-native] {msg}", flush=True)

    loss = float("nan")
    history, losses, pending, saves = [], [], [], []
    sync_idx = start_step = 0
    resumed_from = resume_gib = None
    k_alive_min = K
    if session is not None and args.resume:
        # rank 0 reads the session's CRCs, the others take its answer
        found = torch.tensor([(session.latest_intact() or -1) if lead
                              else 0], dtype=torch.int64, device=dev)
        latest = int(mesh.all_gather(found, all_axes,
                                     level="checkpoint")[0, 0])
        latest = None if latest < 0 else latest
        if latest is not None:
            # batches are a function of (seed, step): restoring the
            # tensors and the step counter IS a bit-exact resume. The K
            # rows load on the host; only this rank's blocks reach the card
            def row(name, like, places):
                stacked = tree_map(lambda x: torch.empty(
                    (), dtype=x.dtype).expand((K,) + tuple(x.shape)), like)
                got = session.load(latest, name, stacked)
                return tree_map(lambda x: x.to(dev), shards.local_rows(
                    got, mesh, places))
            params = row("inner", abs_params, p_places)
            opt_state = row("inner_opt", abs_opt, o_places)
            wa_full = session.load(latest, "wa", tree_map(
                lambda x: torch.empty((), dtype=x.dtype).expand(x.shape),
                abs_params))
            wa = tree_map(lambda x: x.contiguous().to(dev),
                          blocks_of(wa_full, layout.places, mesh))
            if split:
                ws = shards.local_window(session.load_window(
                    latest, shards.global_window_template(ws)), mesh, dev)
            else:
                ws = session.load_window(latest, ws)
            meta = session.meta(latest)
            start_step = resumed_from = int(meta["step"])
            cycle = torch.tensor(meta["cycle"], dtype=torch.int32,
                                 device=dev)
            sync_idx = int(meta["sync_idx"])
            loss = float(meta["loss"])
            history = list(meta.get("history", []))
            if cuda:
                resume_gib = torch.cuda.max_memory_allocated(dev) / 2**30
            log(f"resumed from step {start_step} "
                f"({session.step_dir(latest)})")

    # the exact f32 window of the same pushes, for a compressed W̿'s
    # error, on the host
    shadow = None
    if probe and lead and tok != "f32":
        zero = torch.zeros((), dtype=torch.int32)
        shadow = [WindowState(
            ring=torch.zeros((args.window, lspec.padded)),
            total=torch.zeros((lspec.padded,)), count=zero,
            next_idx=zero.clone(), window=args.window, spec=lspec)]
    # the stacked per-leaf reference of a split replica's syncs
    host = {"state": None} if (
        probe == "host" and layout.split and tok == "f32"
        and not args.resilient) else None
    leads = shards.replica_leads(mesh)

    def flush_losses():
        """The per-step losses since the last flush, each replica's (its
        first rank's), onto rank 0 (a ``log`` all-gather, outside the
        train steps)."""
        if not pending:
            return
        got = mesh.all_gather(torch.tensor(pending, dtype=torch.float64,
                                           device=dev), all_axes,
                              level="log")
        losses.extend(got[leads].T.cpu().tolist())
        pending.clear()

    def wait():
        if cuda:
            torch.cuda.synchronize(dev)

    declared = {}                    # kernel -> launches the contracts say

    def declare(bundle):
        nonlocal declared
        launch = bundle.contract.launch
        if declared is not None and (launch is None or launch.counts is None):
            declared = None
        if declared is not None:
            for k, v in launch.counts.items():
                declared[k] = declared.get(k, 0) + v

    run_peak = 0                     # the run's peak before a recorded call

    def record(bundle, call_args):
        """One sync or rest call under the recorder (no op recording: the
        call is timed); the card's run peak kept across its reset."""
        nonlocal run_peak
        if cuda:
            run_peak = max(run_peak, torch.cuda.max_memory_allocated(dev))
        return record_call(bundle, call_args, mesh=mesh, ops=False)

    train_colls, train_steps = {}, 0
    sync_colls, rest_colls = [], []
    wait()
    times = {"init_s": time.perf_counter() - t_start, "step_ms": [],
             "probe_s": 0.0}
    for step in range(start_step, args.steps):
        if inject is not None and step == inject[0] and rep == inject[1]:
            for x in tree_leaves(params):
                if x.is_floating_point():
                    x.fill_(float("nan"))
            print(f"[mesh-native] step {step}: injected NaN into replica "
                  f"{rep} (rank {rank})", flush=True)
        b = mesh_batch(args.seed, step, K, args.batch_size, args.seq_len,
                       cfg.vocab_size)
        batch = {k: torch.from_numpy(v[rep]).to(dev) for k, v in b.items()}
        before = ledger_snapshot()
        t0 = time.perf_counter()
        params, opt_state, step_loss = train(params, opt_state, batch)
        wait()
        times["step_ms"].append((time.perf_counter() - t0) * 1e3)
        _add(train_colls, ledger_delta(before, ledger_snapshot()))
        train_steps += 1
        declare(train)
        pending.append(float(step_loss))
        if (step + 1) % H == 0:
            flush_losses()
            loss = float(np.mean(losses[-1]))
            inner = inner_sync is not None and not topo.is_outer(sync_idx)
            probing = probe in (True, "host") or (probe == "outer"
                                                  and not inner)
            t_probe = time.perf_counter()
            if probing:
                # the K replicas' blocks of rank 0's part, to rank 0,
                # among the ranks holding that part (the others skip it)
                mine = pack(view(params), lspec)
                gathered = None
                if shards.inner_key(mesh) == shards.inner_key(mesh, 0):
                    gathered = mesh.gather(mine, "probe", out_device="cpu",
                                           axes=topo.replica_axes)
                del mine
            times["probe_s"] += time.perf_counter() - t_probe
            wait()
            t0 = time.perf_counter()
            bundle = inner_sync if inner else sync
            if inner:
                mean, art = record(inner_sync, (params,))
            else:
                (ws, wa, cycle, alive, k_alive_t, mean), art = record(
                    sync, (params, ws, cycle))
            wait()
            ms = (time.perf_counter() - t0) * 1e3
            declare(bundle)
            sync_colls.append({
                "sync": "inner" if inner else "outer", "ms": ms,
                "collectives": art.ledger,
                "declared": bundle.contract.ledger(mesh.shape),
                "contract": bundle.contract, "artifacts": art,
                "audit": sync_collective_audit(
                    [(op, [g]) for op, g in art.groups], mesh,
                    outer_axis="pod" if plan.is_tree else None,
                    n_groups=spec.n_groups if spec.is_grouped else None)})
            if rest is not None:
                _, art = record(rest, (params, mean))
                rest_colls.append({
                    "collectives": art.ledger,
                    "declared": rest.contract.ledger(mesh.shape),
                    "contract": rest.contract, "artifacts": art})
            entry = {"step": step + 1, "loss": loss,
                     "sync": "inner" if inner else "outer"}
            if not inner:
                entry["cycle"] = int(cycle)
                if args.resilient:
                    ka = int(k_alive_t)
                    k_alive = K if ka == 0 else ka
                    k_alive_min = min(k_alive_min, k_alive)
                    if k_alive < K and not bool(alive[0]):
                        # the sync restarted this replica from W̄; its
                        # stale momentum goes too
                        for o in tree_leaves(opt_state):
                            o.zero_()
                    entry["k_alive"] = k_alive
            t_probe = time.perf_counter()
            if probing:
                rec = _probe(mesh, gathered, view(params), lspec, mean,
                             entry["sync"], pods, shadow, ws, tok)
                if host is not None and not inner:
                    host["state"] = _host_reference(
                        mesh, host["state"], gathered, lspec, args.window)
                    if lead:
                        from repro_torch.common.quant import max_ulp
                        # W̿ in the leaves' dtypes, as the sync gives it
                        rec["wa_host_ulps"] = max(
                            max_ulp(a.float().cpu(), b.to(a.dtype).float())
                            for a, b in zip(tree_leaves(wa), tree_leaves(
                                host["state"].wa)))
                del gathered
                if lead:
                    entry["probe"] = rec
            times["probe_s"] += time.perf_counter() - t_probe
            del mean
            if cuda:
                # ranks may share the card: hand the sync's buffers back
                torch.cuda.empty_cache()
            history.append(entry)
            if inner:
                log(f"step {step + 1} loss {loss:.4f} inner sync (pods "
                    f"avg internally)")
            elif args.resilient:
                log(f"step {step + 1} loss {loss:.4f} cycle {int(cycle)} "
                    f"k_alive {entry['k_alive']}/{K}")
            else:
                log(f"step {step + 1} loss {loss:.4f} cycle {int(cycle)} "
                    f"(K={K}, mesh={mesh.shape})")
            sync_idx += 1
        if session is not None and (step + 1) % args.checkpoint_every == 0:
            flush_losses()
            t0 = time.perf_counter()
            inner_all = shards.gather_full(mesh, params, p_layout,
                                           "checkpoint")
            opt_all = shards.gather_full(mesh, opt_state, o_layout,
                                         "checkpoint")
            wa_all = shards.gather_full(mesh, wa, w_layout, "checkpoint")
            ws_all = (shards.gather_window(mesh, ws, "checkpoint")
                      if split else ws)
            if lead:
                session.save(step + 1, {"inner": inner_all,
                                        "inner_opt": opt_all,
                                        "wa": tree_map(lambda x: x[0],
                                                       wa_all)},
                             window=ws_all,
                             meta={"step": step + 1, "cycle": int(cycle),
                                   "sync_idx": sync_idx, "loss": loss,
                                   "history": history})
                saves.append({"step": step + 1,
                              "s": time.perf_counter() - t0,
                              "gb": sum(f["size"] for f in session.manifest(
                                  step + 1)["files"].values()) / 1e9})
            del inner_all, opt_all, wa_all, ws_all
            mesh.barrier("checkpoint")
    flush_losses()
    launched = kernel_counts()
    stats = {"rank": rank, "replica": rep, "train_collectives": train_colls,
             "train_declared": train.contract.ledger(mesh.shape),
             "train_steps": train_steps, "syncs": sync_colls,
             "rests": rest_colls,
             "launches": {k: v - launched0[k] for k, v in launched.items()},
             "declared_launches": declared,
             "peak_gib": (max(run_peak, torch.cuda.max_memory_allocated(dev))
                          / 2**30 if cuda else None),
             "resume_gib": resume_gib, "times": times,
             "ep_pairs": moe.ep_tally()}
    keys = payload["with_state"]
    keys = (("inner", "wa", "ring", "total") if keys is True
            else tuple(keys or ()))
    gather_all = payload["digest"]
    inner_all = (shards.gather_full(mesh, params, p_layout, "state")
                 if "inner" in keys or gather_all else None)
    wa_all = (shards.gather_full(mesh, wa, w_layout, "state")
              if "wa" in keys or gather_all else None)
    ws_all = ws if not split else (
        shards.gather_window(mesh, ws, "state")
        if {"ring", "total"} & set(keys) or gather_all else None)
    wa_finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(wa)
                    if x.is_floating_point())
    finite = mesh.all_gather(torch.tensor([float(wa_finite)], device=dev),
                             all_axes, level="log")
    if not lead:
        return {"rank_stats": stats}
    if losses:
        loss = float(np.mean(losses[-1]))
    out = {"final_loss": loss, "cycles": int(cycle), "syncs": sync_idx,
           "history": history, "sync_tree": args.sync_tree,
           "resilient": args.resilient,
           "wa_dtype": plan.wa_dtype, "comms_dtype": plan.comms_dtype,
           "wa_finite": bool(finite.min() > 0), "k_alive_min": k_alive_min,
           "mesh": dict(mesh.shape), "losses": losses,
           "resumed_from": resumed_from, "saves": saves,
           "layout": {"grouped": spec.is_grouped, "n_groups": spec.n_groups,
                      "shards": [g.shards for g in spec.group_table()],
                      "padded": spec.padded, "local_padded": lspec.padded,
                      "json": spec_to_json(spec)},
           "rank_stats": stats}
    state = {"inner": inner_all,
             "wa": None if wa_all is None else tree_map(lambda x: x[0],
                                                        wa_all),
             "ring": None if ws_all is None else ws_all.ring,
             "total": None if ws_all is None else ws_all.total}
    if payload["digest"]:
        out["digest"] = {k: _sha256(v) for k, v in state.items()
                         if v is not None}
    if keys:
        out["_state"] = tree_map(lambda x: x.cpu(),
                                 {k: state[k] for k in keys})
    return out


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.inject_nan and not args.mesh_native:
        raise SystemExit("--inject-nan needs --mesh-native (the fault "
                         "check's in-process legs cover the rest)")
    if (args.wa_dtype != "f32" or args.comms_dtype != "f32") \
            and not args.mesh_native:
        raise SystemExit("--wa-dtype/--comms-dtype compress the "
                         "mesh-native packed window state; add "
                         "--mesh-native")
    if args.mesh_native:
        out = run_mesh_native(args)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                # "_"-prefixed keys carry tensors for in-process callers;
                # the calls' contracts and records go as their fields
                json.dump({k: v for k, v in out.items()
                           if not k.startswith("_")}, f, indent=2,
                          default=dataclasses.asdict)
        return

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch)
    if args.attn_impl:
        cfg = cfg.with_(attn_impl=args.attn_impl)
    if cfg.family in ("vlm", "audio"):
        raise SystemExit(f"{args.arch}: the Trainer's batches are (tokens, "
                         f"targets) only; train the modality archs through "
                         f"lm.loss and core.hwa directly")
    lm = build_model(cfg)
    ds = make_markov_lm_dataset(vocab=cfg.vocab_size, seq_len=args.seq_len,
                                n_train=2048, n_test=512, seed=args.seed,
                                device=dev)
    K = args.k if args.method in PARALLEL else 1
    pipe = DataPipeline(ds, batch_size=args.batch_size, n_replicas=K,
                        seed=args.seed)
    tc = TrainConfig(
        method=args.method, total_steps=args.steps,
        batch_size=args.batch_size, base_lr=args.lr, seed=args.seed,
        hwa=HWAConfig(n_replicas=K, sync_period=args.sync_period,
                      window=args.window, resilient=args.resilient,
                      max_param_rms=args.max_param_rms or None),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        checkpoint_keep=args.keep, resume=args.resume)
    out = Trainer(lm_task(lm, pipe, seed=args.seed), tc).run(log=True)
    print(f"[train] {args.arch}/{args.method} on {dev}: final "
          f"{out['final']}, best {out['best']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"final": out["final"], "best": out["best"],
                       "history": out["history"]}, f, indent=2)


if __name__ == "__main__":
    main()
