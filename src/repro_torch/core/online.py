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
