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
    (``plan.resolved_topology.is_outer`` schedules which sync is which)."""
    plan: SyncPlan
    sync: Any
    train: Any = None
    inner_sync: Any = None

    @property
    def pack_spec(self):
        """The packed window-state layout callers allocate from."""
        return self.sync.pack_spec


def build_hwa_bundles(lm, mesh, plan: SyncPlan, params,
                      train: bool = True) -> HWABundles:
    """Assemble the mesh-native train / sync / inner-sync bundles a plan
    describes, validated against ``mesh`` (``launch.mesh.ReplicaMesh``)
    once. ``params`` is the rank's replica, which fixes the packed
    layout; ``train=False`` builds the syncs only."""
    from repro_torch.launch.sync.bundles import (
        _make_mesh_hwa_inner_sync_step, _make_mesh_hwa_sync_step,
        _make_mesh_hwa_train_step)
    if not plan.mesh_native:
        raise ValueError("the stacked path has no bundles in the port: "
                         "call core.hwa.hwa_inner_step and hwa_sync")
    topology = plan.resolved_topology
    train_b = (_make_mesh_hwa_train_step(
        lm, mesh, plan.hwa, optimizer=plan.optimizer, lr=plan.lr,
        replica_axis=topology.replica_axes) if train else None)
    sync = _make_mesh_hwa_sync_step(
        lm, mesh, plan.hwa, params, ring_dtype=plan.wa_dtype,
        replica_axis=plan.replica_axis, topology=plan.topology,
        comms_dtype=plan.comms_dtype)
    inner_sync = (_make_mesh_hwa_inner_sync_step(
        lm, mesh, plan.hwa, params, topology) if plan.is_tree else None)
    return HWABundles(plan=plan, sync=sync, train=train_b,
                      inner_sync=inner_sync)


def window_state_args(bundles: HWABundles, params):
    """A fresh window state for the plan's sync, allocated from its
    packed layout on ``params``' device: ``(window_state, cycle)``.
    Zeroed buffers, except the fp8 ring's per-block scales, which start
    at ONES (the scale of an all-zero block): ``core.offline.window_init``."""
    from repro_torch.core.offline import window_init
    hwa = bundles.plan.hwa
    ws = window_init(params, hwa.window, hwa.window_kind,
                     ring_dtype=bundles.plan.wa_dtype)
    cycle = torch.zeros((), dtype=torch.int32, device=ws.total.device)
    return ws, cycle
