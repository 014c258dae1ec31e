"""The mesh-native HWA step builders (counterpart of the reference's
``_make_mesh_hwa_train_step``, ``_make_mesh_hwa_sync_step`` and
``_make_mesh_hwa_inner_sync_step`` in ``repro.launch.sync.bundles``).

Each builder returns a :class:`StepBundle`: a plain callable on one
rank's tensors, the packed layout its window state lives in, and its
declared contract (kernel launches on the card and collectives a call).
There are no shardings: one process holds one replica (``launch.mesh``). The GSPMD
builders (``make_train_step``, ``make_prefill_step``,
``make_decode_step``) and ``legacy.py`` are not ported: they exist for
XLA's partitioner.

- the train step is the rank's one replica stepped by
  ``core.hwa.hwa_local_inner_step``: it issues NO collective;
- the sync step is ``packed._local_packed_sync`` over the topology's
  composition: W̄, the window push, the restart;
- the inner-sync step (two-level tree only) is
  ``packed._local_inner_sync``: the pod mean, nothing else.

:func:`sync_collective_budget` declares what a sync issues, per level
(``launch.mesh.LEDGER``'s names). ``launch.train.mesh_rank`` records
each call's contract beside its ledger delta and launch counts, and the
tests and ``chip_smoke.py`` hold the counts to it.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch

from repro_torch.common.packing import pack_spec
from repro_torch.core.hwa import HWAConfig, hwa_local_inner_step
from repro_torch.launch.mesh import _is_pow2, level_name
from repro_torch.launch.sync.packed import (_local_inner_sync,
                                            _local_packed_sync,
                                            packed_sync_launch_budget)
from repro_torch.launch.sync.topology import Flat, SyncTopology, TwoLevel
from repro_torch.optim import adamw, sgd


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """A step callable with what it declares: ``pack_spec`` (the packed
    layout its window state lives in; None for the train step) and
    ``contract`` (``launches``: kernel -> launches a call on the card,
    None where not exact; ``collectives``: level -> {op: count} a
    call)."""
    fn: Callable
    pack_spec: Any = None
    contract: dict = dataclasses.field(default_factory=dict)

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)


def _mk_optimizer(name: str):
    if name == "sgd":
        return sgd(momentum=0.9, weight_decay=5e-4)
    return adamw(weight_decay=0.1)


def _check_outer_every(hwa_cfg: HWAConfig, topology: SyncTopology) -> None:
    """One source of truth for H₂: the training loop schedules off
    ``topology.is_outer`` while ``HWAConfig.outer_every`` rides along in
    config records and checkpoints; refuse silently-disagreeing values
    with the reference's messages."""
    if isinstance(topology, TwoLevel):
        if hwa_cfg.outer_every != topology.outer_every:
            raise ValueError(
                f"HWAConfig.outer_every={hwa_cfg.outer_every} disagrees "
                f"with TwoLevel.outer_every={topology.outer_every}; set "
                "both from the same value (the training loop schedules off "
                "the topology)")
    elif hwa_cfg.outer_every != 1:
        raise ValueError(
            f"HWAConfig.outer_every={hwa_cfg.outer_every} would be "
            "silently ignored: this sync path is flat (every sync is "
            "outer). Use make_mesh_hwa_sync_step with a TwoLevel "
            "topology for the H·H₂ hierarchy, or leave outer_every at 1")


def sync_collective_budget(mesh, topology: SyncTopology, *,
                           comms_dtype: str = "f32", resilient=False,
                           inner_only: bool = False) -> dict:
    """The collectives one sync issues on every rank, per level: a level
    of 2^m ranks costs m two-way all-reduces (twice that resilient: the
    alive count, then the weights), another size one all-gather (two
    resilient); the compressed outer level of the tree one all-gather
    (bf16) or two (fp8: payload and scales). A level of one rank costs
    nothing."""
    groups = (topology.inner_groups() if inner_only
              else topology.psum_groups())
    non_empty = [i for i, axes in enumerate(groups) if axes]
    last = non_empty[-1] if non_empty else None
    per = 2 if resilient else 1
    out = {}
    for i, axes in enumerate(groups):
        n = mesh.size(axes) if axes else 1
        if n == 1:
            continue
        if comms_dtype != "f32" and i == last:
            row = {"all_gather": 2 if comms_dtype == "fp8" else 1}
        elif _is_pow2(n):
            row = {"all_reduce": per * (n.bit_length() - 1)}
        else:
            row = {"all_gather": per}
        out[level_name(tuple(a for a in mesh.shape if a in axes))] = row
    return out


def _make_mesh_hwa_train_step(lm, mesh, hwa_cfg: HWAConfig,
                              optimizer: str = "sgd", lr: float = 3e-4,
                              replica_axis="replica") -> StepBundle:
    """The mesh-native inner step: the rank's one replica, one optimizer
    step, ``fn(params, opt_state, batch) -> (params, opt_state, loss)``.
    Collective-free by construction. With ``flash_pallas`` and remat off
    it launches the flash forward once and each backward sweep once a
    layer."""
    from repro_torch.launch.sync.topology import _norm_axes
    rep_axes = _norm_axes(replica_axis)
    K = hwa_cfg.n_replicas
    rep_size = math.prod(mesh.shape[a] for a in rep_axes)
    if K != rep_size:
        raise ValueError(f"mesh-native path needs K == replica-axes size "
                         f"({K} != {rep_size} over {rep_axes})")
    opt = _mk_optimizer(optimizer)

    def step(params, opt_state, batch):
        params, opt_state, loss, _ = hwa_local_inner_step(
            params, opt_state, batch, lm.loss, opt, lr)
        return params, opt_state, loss

    cfg = lm.cfg
    exact = (cfg.attn_impl == "flash_pallas" and cfg.remat == "none"
             and cfg.family in ("dense", "moe"))    # every layer attends
    launches = (dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                              cfg.n_layers) if exact else None)
    return StepBundle(fn=step, contract={"launches": launches,
                                         "collectives": {}})


def _make_mesh_hwa_sync_step(lm, mesh, hwa_cfg: HWAConfig, params,
                             ring_dtype=torch.float32,
                             replica_axis: str = "replica",
                             topology: SyncTopology | None = None,
                             comms_dtype: str = "f32") -> StepBundle:
    """The mesh-native sync, the once-per-H-steps collective(s):
    ``fn(params, window_state, cycle) -> (window_state, wa, cycle, alive,
    k_alive, mean)``, the replica restarted in place
    (``packed._local_packed_sync``). ``topology`` selects where the mean
    reduces: ``Flat`` (default, over ``replica_axis``) or ``TwoLevel``,
    for which this is the OUTER sync. ``params`` (the rank's replica)
    fixes the packed layout; allocate the window from ``pack_spec``.

    ``comms_dtype`` compresses the tree's cross-pod hop only; it needs a
    TwoLevel topology and is refused with ``resilient`` (the alive-masked
    mean renormalizes by k_alive after the reduction, so the quantized
    payload would be scaled before the mask is known)."""
    from repro_torch.common.quant import is_compressed, wa_dtype, wa_token
    K = hwa_cfg.n_replicas
    ring_dtype = wa_dtype(ring_dtype)
    tok = wa_token(ring_dtype)
    comms_tok = wa_token(comms_dtype)
    topology = topology if topology is not None else Flat(replica_axis)
    topology.validate(mesh, K)
    if comms_tok != "f32":
        if not isinstance(topology, TwoLevel):
            raise ValueError(
                "compressed comms quantize the two-level tree's cross-pod "
                "hop; a Flat sync has no outer level to compress (its one "
                "all-reduce IS the mean — quantizing it would quantize "
                f"the paper's W̄). Got comms_dtype={comms_tok!r} with "
                f"topology {topology!r}")
        if hwa_cfg.resilient:
            raise ValueError(
                "resilient + compressed comms is unsupported: the "
                "alive-masked mean renormalizes by k_alive after the "
                "psum, so the quantized payload would be scaled before "
                "the mask is known")
    _check_outer_every(hwa_cfg, topology)
    psum_groups = topology.psum_groups()
    spec = pack_spec(params)
    if is_compressed(tok):
        spec = spec.with_ring_dtype(ring_dtype)
    fn = functools.partial(_local_packed_sync, hwa_cfg, spec, K, psum_groups,
                           mesh=mesh, comms_dtype=comms_tok)
    budget = packed_sync_launch_budget(
        hwa_cfg, use_kernel=hwa_cfg.use_kernels, n_groups=1, k_local=1,
        collective=any(psum_groups), with_stride=True, ring_dtype=tok)
    # the push is the one kernel a rank's sync launches (K = 1 included:
    # the fused sync never runs here)
    kernel = {"f32": "wa_window_update", "bf16": "wa_window_update_c"}
    colls = sync_collective_budget(mesh, topology, comms_dtype=comms_tok,
                                   resilient=hwa_cfg.resilient)
    return StepBundle(fn=fn, pack_spec=spec, contract={
        "launches": {kernel[tok]: budget} if budget else {},
        "collectives": colls})


def _make_mesh_hwa_inner_sync_step(lm, mesh, hwa_cfg: HWAConfig, params,
                                   topology: TwoLevel) -> StepBundle:
    """The two-level tree's INNER sync, run on the ``outer_every - 1`` of
    every ``outer_every`` syncs that are not outer: each pod averages its
    own members, ``fn(params) -> pod mean`` (the replica restarted in
    place). Zero cross-pod traffic, no window traffic, no kernel."""
    K = hwa_cfg.n_replicas
    if not isinstance(topology, TwoLevel):
        raise ValueError("inner-only sync exists only for the TwoLevel "
                         f"topology, got {topology!r}")
    topology.validate(mesh, K)
    _check_outer_every(hwa_cfg, topology)
    spec = pack_spec(params)
    pod_size = K // topology.pods(mesh)
    fn = functools.partial(_local_inner_sync, spec, pod_size,
                           topology.inner_groups(), mesh=mesh)
    return StepBundle(fn=fn, pack_spec=spec, contract={
        "launches": {},
        "collectives": sync_collective_budget(mesh, topology,
                                              inner_only=True)})


def sync_cases(mesh, cases) -> list[dict]:
    """Run one sync per case on this rank (a ``launch.mesh.spawn_ranks``
    target: the parity tests' way in, and a direct way to drive a single
    sync). A case is a dict: ``plan`` (a ``SyncPlan``), ``stacked`` (a
    tree of (K, ...) CPU tensors: rank r's replica is row r), ``window``
    (a ``WindowState`` on the CPU) and ``cycle`` for a full sync, or
    ``inner: True`` for the two-level tree's inner sync, or ``group:
    True`` for ``core.online``'s process-group mean and divergence over
    the whole mesh. Returns, per case, the rank's restarted replica, the
    packed mean (or the group mean and divergence), the collectives the
    sync issued and those its bundle declares and, for a full sync, the
    window state, W̿, the cycle, the alive mask and the alive count, all
    on the CPU."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.core.online import (online_average_group,
                                         replica_divergence_group)
    from repro_torch.launch.mesh import ledger_delta, ledger_snapshot
    from repro_torch.launch.sync.plan import build_hwa_bundles

    dev = mesh.device
    results = []
    for case in cases:
        params = tree_map(lambda x: x[mesh.rank].clone().to(dev),
                          case["stacked"])
        if case.get("group"):
            axes = tuple(mesh.shape)
            results.append(tree_map(lambda x: x.cpu(), {
                "mean": online_average_group(params, mesh, axes),
                "divergence": replica_divergence_group(params, mesh,
                                                       axes)}))
            continue
        bundles = build_hwa_bundles(None, mesh, case["plan"], params,
                                    train=False)
        step = bundles.inner_sync if case.get("inner") else bundles.sync
        before = ledger_snapshot()
        if case.get("inner"):
            out = {"mean": step(params)}
        else:
            ws = tree_map(lambda x: x.clone().to(dev), case["window"])
            ws, wa, cycle, alive, k_alive, mean = step(
                params, ws, case["cycle"].to(dev))
            out = {"window": ws, "wa": wa, "cycle": cycle, "alive": alive,
                   "k_alive": k_alive, "mean": mean}
        out["params"] = params
        out = tree_map(lambda x: x.cpu(), out)
        out["collectives"] = ledger_delta(before, ledger_snapshot())
        out["declared"] = step.contract["collectives"]
        results.append(out)
    return results
