"""Sync topologies: WHICH replica axes the replica mean crosses, and WHEN
(counterpart of ``repro.launch.sync.topology``, the same pure structure).

- :class:`Flat`: every sync is one reduction over the whole replica axis
  set.
- :class:`TwoLevel`: replicas are carved into pods (the ``outer_axis``)
  of ``inner_axis``-many members each. Every H steps each pod averages
  over its OWN members only (no cross-pod traffic); only every
  H·``outer_every`` steps does the cross-pod reduction and the window
  push run.

A topology owns no tensors and never touches a process group. The axes
name the axes of the port's replica mesh (``launch.mesh.ReplicaMesh``):
one process a replica, ranks laid out row-major over the axes, so with
``("pod", "replica")`` the pods are CONTIGUOUS rank blocks, which the
0-ULP composition needs.

**Bit-parity contract.** The two-level OUTER mean is the composition of
the per-pod reduction and the cross-pod one over contiguous pods. With
power-of-two pod sizes it performs exactly the additions of the
canonical contiguous-pairing halving tree
(``core.online.halving_sum_axis0``), so it is bit-equal to the flat
mean and to ``core.online.online_average_grouped``.
"""
from __future__ import annotations

import dataclasses
import math


def _norm_axes(axis) -> tuple[str, ...]:
    """An axis argument (None | str | sequence of str) as a tuple."""
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


@dataclasses.dataclass(frozen=True)
class Flat:
    """Single-level sync: one reduction over ``axis`` per sync. ``axis``
    may name several mesh axes jointly (``("pod", "replica")``: a flat
    sync on a pod-carved mesh, the baseline the tree is compared with)."""
    axis: str | tuple[str, ...] = "replica"

    @property
    def replica_axes(self) -> tuple[str, ...]:
        """Mesh axes the replicas are spread over."""
        return _norm_axes(self.axis)

    @property
    def levels(self) -> int:
        return 1

    def n_replicas(self, mesh) -> int:
        return math.prod(mesh.shape[a] for a in self.replica_axes)

    def psum_groups(self) -> tuple[tuple[str, ...], ...]:
        """Axis groups the sync reduces over, in order (here: one joint)."""
        return (self.replica_axes,)

    def is_outer(self, sync_idx) -> bool:
        """Every flat sync is global (window push + full reduction)."""
        return True

    def validate(self, mesh, n_replicas: int) -> None:
        missing = [a for a in self.replica_axes if a not in mesh.shape]
        if missing:
            raise ValueError(f"Flat sync axes {missing} not in mesh "
                             f"{dict(mesh.shape)}")
        if n_replicas != self.n_replicas(mesh):
            raise ValueError(
                f"mesh-native flat sync needs K == replica-axis size "
                f"({n_replicas} != {self.n_replicas(mesh)} over "
                f"{self.replica_axes})")


@dataclasses.dataclass(frozen=True)
class TwoLevel:
    """Two-level (pod-inner / pod-outer) sync tree. ``inner_axis`` spans
    a pod's members, ``outer_axis`` the pods; replicas are laid out over
    ``(outer_axis, inner_axis)`` jointly so pods are CONTIGUOUS replica
    blocks. ``outer_every`` is H₂: sync index s (0-based) runs the outer
    level iff ``(s + 1) % outer_every == 0``; all other syncs are
    pod-internal restarts with zero cross-pod traffic."""
    inner_axis: str = "replica"
    outer_axis: str = "pod"
    outer_every: int = 1

    @property
    def replica_axes(self) -> tuple[str, ...]:
        # outer first: pod-major layout keeps pods contiguous in K
        return (self.outer_axis, self.inner_axis)

    @property
    def levels(self) -> int:
        return 2

    def n_replicas(self, mesh) -> int:
        return math.prod(mesh.shape[a] for a in self.replica_axes)

    def pods(self, mesh) -> int:
        return mesh.shape[self.outer_axis]

    def pod_size(self, mesh) -> int:
        """Replicas per pod (inner-axis extent)."""
        return mesh.shape[self.inner_axis]

    def psum_groups(self) -> tuple[tuple[str, ...], ...]:
        """The grouped composition: inner (per-pod) first, then the
        cross-pod reduction."""
        return ((self.inner_axis,), (self.outer_axis,))

    def inner_groups(self) -> tuple[tuple[str, ...], ...]:
        """The inner-only sync's reduction: one per-pod level."""
        return ((self.inner_axis,),)

    def is_outer(self, sync_idx) -> bool:
        """True iff 0-based sync ``sync_idx`` runs the outer level (the
        H₂-th, 2·H₂-th, ... syncs)."""
        if self.outer_every <= 1:
            return True
        return (sync_idx + 1) % self.outer_every == 0

    def validate(self, mesh, n_replicas: int) -> None:
        if self.inner_axis == self.outer_axis:
            raise ValueError("TwoLevel inner and outer axes must differ, "
                             f"both are {self.inner_axis!r}")
        missing = [a for a in self.replica_axes if a not in mesh.shape]
        if missing:
            raise ValueError(f"TwoLevel sync axes {missing} not in mesh "
                             f"{dict(mesh.shape)}")
        if self.outer_every < 1:
            raise ValueError(f"outer_every must be >= 1, got "
                             f"{self.outer_every}")
        if n_replicas != self.n_replicas(mesh):
            raise ValueError(
                f"two-level sync needs K == pods × pod_size "
                f"({n_replicas} != {self.pods(mesh)} × "
                f"{self.pod_size(mesh)})")


SyncTopology = Flat | TwoLevel
