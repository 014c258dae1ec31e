"""Online WA module (paper §III-A, Algorithm 1 lines 8-12).

Counterpart of ``repro.core.online`` (the single-device stacked
functions). The K inner replicas are held stacked on a leading axis; the
synchronization is a mean over axis 0 and a broadcast back:

    W̄_e      = (1/K) Σ_k W^k_{e,H}        (outer weights)
    W^k_{e+1,0} ← W̄_e                       (restart every replica)
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.common.packing import pack_spec, pack_stacked, unpack
from repro_torch.common.pytree import tree_leaves, tree_mean_axis0, tree_map
from repro_torch.kernels import wa_update


def online_average(stacked_params: Any, *, use_kernel: bool = False) -> Any:
    """Outer weights W̄_e from stacked inner weights (K, ...), cast to
    each leaf's dtype. Plain: the mean of ``common.pytree.tree_mean_axis0``
    (``jnp.mean``'s). Kernel: the K replicas packed into one (K, P) f32
    buffer and reduced in ONE ``online_mean`` launch however many
    leaves there are, then unpacked."""
    if use_kernel and tree_leaves(stacked_params):
        spec = pack_spec(tree_map(lambda x: x[0], stacked_params))
        buf = pack_stacked(stacked_params, spec)
        return unpack(wa_update.online_mean(buf), spec)
    return tree_mean_axis0(stacked_params)


def broadcast_to_replicas(outer: Any, n_replicas: int) -> Any:
    """W^k ← W̄ for every k, as new stacked tensors."""
    return tree_map(lambda x: x[None].expand((n_replicas,) + tuple(x.shape))
                    .clone(), outer)


def restart_replicas(stacked: Any, outer: Any) -> None:
    """W^k ← W̄ for every k, written IN PLACE into the stacked tensors
    (the same values as :func:`broadcast_to_replicas` without a second
    K-fold copy of the parameters)."""
    for x, m in zip(tree_leaves(stacked), tree_leaves(outer)):
        x.copy_(m[None].expand_as(x))


def replica_divergence(stacked_params: Any) -> torch.Tensor:
    """Mean L2 distance of each replica from the average (the restart
    magnitude of the paper's Fig. 12), as a 0-dim f32 device tensor."""
    mean = tree_mean_axis0(stacked_params)
    sq = [torch.square(x.float() - m[None].float()).reshape(x.shape[0], -1)
          .sum(1)
          for x, m in zip(tree_leaves(stacked_params), tree_leaves(mean))]
    return torch.sqrt(sum(sq)).mean()


# --------------------------------------------- grouped / subgroup means
#
# The two-level sync tree (launch/sync/topology.py) computes the global
# mean as a COMPOSITION of grouped reductions: per-pod partial sums of
# 1/K-pre-scaled replicas, then a sum of the pod partials. Floating-point
# addition is not associative, so "composition == flat" holds to 0 ULP
# only when the reduction ORDER is pinned: the canonical order is the
# contiguous-pairing binary tree below. Every add is one IEEE f32 add, so
# these functions equal the reference's to the bit.


def _f32_const(x: float, device) -> torch.Tensor:
    """``x`` rounded once to f32 (a weakly-typed JAX scalar's value)."""
    return torch.tensor(x, dtype=torch.float32, device=device)


def halving_sum_axis0(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0 by a fixed contiguous-pairing binary tree:
    adjacent pairs are added, then adjacent partial pairs, and so on (an
    odd trailing element is carried to the next round). Two properties
    the sync tree is built on:

    1. **composition**: halving-summing G contiguous groups of a
       power-of-two size and then the G partials performs EXACTLY the
       additions of the flat halving sum, in the same order;
    2. **process equivalence**: a two-way ``all_reduce`` is one IEEE add
       (commutative, hence order-free), so a chain of two-way all-reduces
       over hypercube pairs of contiguous ranks reproduces this tree's
       bits (``launch.sync.packed._psum_composition``)."""
    while x.shape[0] > 1:
        n = x.shape[0]
        half = x[0:n - (n % 2):2] + x[1:n:2]
        x = torch.cat([half, x[n - 1:]], dim=0) if n % 2 else half
    return x[0]


def online_average_canonical(stacked_params: Any) -> Any:
    """Flat K-replica mean with a defined reduction order: every replica
    pre-scaled by f32(1/K) (as the cross-process sync pre-scales its
    partials), then :func:`halving_sum_axis0`, cast to the leaf's dtype.
    The oracle the grouped and cross-process means are held against."""
    def one(x):
        inv = _f32_const(1.0 / x.shape[0], x.device)
        return halving_sum_axis0(x.float() * inv).to(x.dtype)
    return tree_map(one, stacked_params)


def _grouped(x: torch.Tensor, n_groups: int) -> torch.Tensor:
    k = x.shape[0]
    if n_groups < 1 or k % n_groups:
        raise ValueError(f"{n_groups} groups do not divide K={k}")
    return x.float().reshape((n_groups, k // n_groups) + tuple(x.shape[1:]))


def online_average_grouped(stacked_params: Any, n_groups: int) -> Any:
    """Two-level K-replica mean: axis 0 split into ``n_groups``
    contiguous pods, per-pod halving sums of the 1/K-pre-scaled replicas,
    then a halving sum over the pod partials: the arithmetic of the
    two-level sync's outer level. Bit-equal to
    :func:`online_average_canonical` whenever K/n_groups is a power of
    two."""
    def one(x):
        g = _grouped(x, n_groups) * _f32_const(1.0 / x.shape[0], x.device)
        partials = torch.stack([halving_sum_axis0(p) for p in g])
        return halving_sum_axis0(partials).to(x.dtype)
    return tree_map(one, stacked_params)


def pod_mean_grouped(stacked_params: Any, n_groups: int) -> Any:
    """Per-pod means, stacked: (K, ...) -> (n_groups, ...), group g the
    mean of its K/n_groups contiguous replicas with the halving order and
    the 1/(K/n_groups) pre-scaling of the inner sync level."""
    def one(x):
        g = _grouped(x, n_groups)
        inv = _f32_const(1.0 / g.shape[1], x.device)
        return torch.stack([halving_sum_axis0(p * inv) for p in g]
                           ).to(x.dtype)
    return tree_map(one, stacked_params)


def online_average_group(params: Any, mesh, axes=("replica",)) -> Any:
    """Outer weights W̄_e across processes, the process-group counterpart
    of the reference's ``online_average_named``: each rank holds its own
    unstacked replica and the mean is the pre-scaled halving composition
    over the ranks of ``axes`` of ``mesh`` (``launch.mesh.ReplicaMesh``),
    cast back to each leaf's dtype. Returns new tensors."""
    from repro_torch.launch.sync.packed import _psum_composition
    n = mesh.size(axes)
    level = (tuple(axes),)

    def one(x):
        part = x.float() * _f32_const(1.0 / n, x.device)
        return _psum_composition(part, level, mesh=mesh).to(x.dtype)
    return tree_map(one, params)


def replica_divergence_group(params: Any, mesh, axes=("replica",)
                             ) -> torch.Tensor:
    """Cross-process :func:`replica_divergence` (the counterpart of
    ``replica_divergence_named``): the mean over the ranks of ``axes`` of
    each replica's L2 distance from W̄. Costs a second collective: keep
    it out of the hot sync path unless the metric is wanted."""
    mean = online_average_group(params, mesh, axes)
    sq = sum(torch.square(x.float() - m.float()).sum()
             for x, m in zip(tree_leaves(params), tree_leaves(mean)))
    d = torch.sqrt(sq).reshape(1)
    return online_average_group({"d": d}, mesh, axes)["d"][0]
