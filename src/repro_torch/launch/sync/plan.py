"""Declarative HWA bundle construction (counterpart of
``repro.launch.sync.plan``): ONE entry point over the topology ×
precision × resilience × kernel matrix.

A :class:`SyncPlan` names every choice a launch makes: the topology
(``Flat`` or ``TwoLevel``), the precision (``wa_dtype`` compresses the
ring, ``comms_dtype`` the tree's cross-pod payload), resilience and
kernels (``HWAConfig.resilient``, ``.use_kernels``) and the placement
(``mesh_native``: one replica a process, or the stacked path of
``core.hwa``). :func:`build_hwa_bundles` validates the combination once
and assembles the matching mesh-native :class:`HWABundles`. The invalid
corners fail here with the reference's messages: compressed comms on a
Flat topology, resilient with compressed comms, the two-level tree on
the stacked path.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.hwa import HWAConfig
from repro_torch.launch.sync.topology import Flat, SyncTopology, TwoLevel

@dataclasses.dataclass(frozen=True)
class SyncPlan:
    """Everything a launch decides about HWA synchronization, as data.
    ``wa_dtype``/``comms_dtype`` take precision tokens; the f32 defaults
    keep every path bit-equal to the uncompressed one. ``topology=None``
    means a flat sync over ``replica_axis``. ``mesh_native=False`` names
    the stacked path (flat only), which ``core.hwa``'s ``hwa_inner_step``
    and ``hwa_sync`` run. The reference's ``mesh_resident`` and
    ``n_microbatches`` have no counterpart: a rank always holds its
    packed window state, and the mesh-native step takes one batch."""
    hwa: HWAConfig
    topology: SyncTopology | None = None
    replica_axis: str = "replica"
    wa_dtype: str = "f32"
    comms_dtype: str = "f32"
    mesh_native: bool = True
    optimizer: str = "adamw"
    lr: float = 3e-4

    def __post_init__(self):
        from repro_torch.common.quant import wa_token
        object.__setattr__(self, "wa_dtype", wa_token(self.wa_dtype))
        object.__setattr__(self, "comms_dtype", wa_token(self.comms_dtype))
        if self.comms_dtype != "f32":
            if not isinstance(self.topology, TwoLevel):
                raise ValueError(
                    "comms_dtype compresses the two-level tree's "
                    "cross-pod hop; a flat sync has no outer level to "
                    f"compress (got comms_dtype={self.comms_dtype!r} "
                    f"with topology {self.topology!r})")
            if self.hwa.resilient:
                raise ValueError(
                    "resilient + compressed comms is unsupported (the "
                    "alive-masked mean renormalizes after the psum)")
        if isinstance(self.topology, TwoLevel) and not self.mesh_native:
            raise ValueError(
                "the two-level sync tree is mesh-native only (the "
                "stacked vmap path has no grouped psum composition)")

    @property
    def resolved_topology(self) -> SyncTopology:
        return (self.topology if self.topology is not None
                else Flat(self.replica_axis))

    @property
    def is_tree(self) -> bool:
        return isinstance(self.topology, TwoLevel)


@dataclasses.dataclass(frozen=True)
class HWABundles:
    """The bundles a :class:`SyncPlan` assembles. ``train`` is None when
    :func:`build_hwa_bundles` was asked for sync bundles only;
    ``inner_sync`` exists only for a TwoLevel topology
    (``plan.resolved_topology.is_outer`` schedules which sync is which);
    ``rest`` only where the parameters rest whole but the layout splits
    them (it follows every sync); ``layout`` is the replica's
    (``bundles.ReplicaLayout``)."""
    plan: SyncPlan
    sync: Any
    train: Any = None
    inner_sync: Any = None
    rest: Any = None
    layout: Any = None

    @property
    def pack_spec(self):
        """The packed window-state layout (global: a rank holds its
        ``local_spec()``), the layout the chooser picked."""
        return self.sync.pack_spec


def build_hwa_bundles(lm, mesh, plan: SyncPlan, params,
                      train: bool = True, fsdp: bool = False,
                      expert_parallel: bool = False,
                      seq_len: int | None = None) -> HWABundles:
    """Assemble the mesh-native train / sync / inner-sync (/ rest)
    bundles a plan describes, validated against ``mesh``
    (``launch.mesh.ReplicaMesh``) once. The replica's layout comes from
    the reference's rules over ``mesh`` with ``fsdp`` and
    ``expert_parallel`` (``bundles.replica_layout``); with no ``lm``
    (``train=False`` only) it is the whole-replica layout of ``params``,
    the rank's replica. ``seq_len``, the batch's sequence length (the
    reference's input specs), is required with ``train``: the train
    step's contract pins its data and model collectives from it."""
    from repro_torch.launch.sync.bundles import (
        _make_mesh_hwa_inner_sync_step, _make_mesh_hwa_sync_step,
        _make_mesh_hwa_train_step, _make_rest_step, replica_layout)
    if not plan.mesh_native:
        raise ValueError("the stacked path has no bundles in the port: "
                         "call core.hwa.hwa_inner_step and hwa_sync")
    if train and seq_len is None:
        raise ValueError("a train bundle needs the batch's seq_len: its "
                         "contract pins the step's data and model "
                         "collectives from it")
    topology = plan.resolved_topology
    layout = replica_layout(lm, mesh, topology, fsdp=fsdp, params=params,
                            expert_parallel=expert_parallel)
    train_b = (_make_mesh_hwa_train_step(
        lm, mesh, plan.hwa, optimizer=plan.optimizer, lr=plan.lr,
        replica_axis=topology.replica_axes, layout=layout, seq_len=seq_len)
        if train else None)
    sync = _make_mesh_hwa_sync_step(
        lm, mesh, plan.hwa, params, ring_dtype=plan.wa_dtype,
        replica_axis=plan.replica_axis, topology=plan.topology,
        comms_dtype=plan.comms_dtype, layout=layout)
    inner_sync = (_make_mesh_hwa_inner_sync_step(
        lm, mesh, plan.hwa, params, topology, layout=layout)
        if plan.is_tree else None)
    rest = (_make_rest_step(mesh, layout)
            if layout.whole and layout.split else None)
    return HWABundles(plan=plan, sync=sync, train=train_b,
                      inner_sync=inner_sync, rest=rest, layout=layout)


def window_state_args(bundles: HWABundles, params=None, device=None):
    """A fresh window state for the plan's sync: the rank's segment of
    its packed layout (``pack_spec.local_spec()``) on ``device`` (or
    ``params``' device), bare buffers for one range and per-group tuples
    for a grouped layout (the reference's ``window_state_args``):
    ``(window_state, cycle)``. Zeroed buffers, except the fp8 ring's
    per-block scales, which start at ONES (the scale of an all-zero
    block)."""
    from repro_torch.common.packing import window_aux_buffers, \
        window_buffers
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.core.offline import WindowState
    hwa = bundles.plan.hwa
    spec = bundles.pack_spec
    if device is None:
        device = tree_leaves(params)[0].device
    if hwa.window_kind != "ring":
        raise ValueError("the mesh-native sync keeps a ring window")
    lspec = spec.local_spec()
    ring, total = window_buffers(lspec, hwa.window, bundles.plan.wa_dtype,
                                 device=device)
    scales, comp = window_aux_buffers(lspec, hwa.window,
                                      bundles.plan.wa_dtype, device=device)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    ws = WindowState(ring=ring, total=total, count=zero,
                     next_idx=zero.clone(), window=hwa.window, kind="ring",
                     spec=spec, comp=comp, scales=scales)
    return ws, zero.clone()
