"""Replica health probes and the alive-masked (elastic) K-mean
(counterpart of ``repro.resilience.health``).

- :func:`packed_health_stats` / :func:`alive_from_stats` /
  :func:`renormalized_inv`: the probe and the multiplier over a packed
  f32 ``(k, P)`` sync buffer, the formulation the reference's mesh sync
  runs (``launch.sync.packed._local_packed_sync``'s resilient branch).
- :func:`replica_alive_mask` / :func:`masked_mean_axis0` /
  :func:`quarantine_opt_state`: the stacked form ``core.hwa.hwa_sync``
  runs with ``HWAConfig.resilient``.

The finiteness verdict is exact; the RMS threshold (``max_rms``) is a
coarse blow-up detector: its sum of squares is accumulated in another
order than XLA's, so a replica within an ULP of the threshold may be
judged otherwise than the reference judges it.

The masked mean is 0 ULP equal to the plain mean
(``common.pytree.tree_mean_axis0``, what ``jnp.mean`` computes on XLA's
CPU build: the f32 sum times the f32 ``1/K``) when every replica is
alive, for every leaf dtype: both share one f32 sum over the replicas
(a ``where`` whose mask is all true passes every value through), and the
all-alive selection takes the plain product. With a dead replica it is
the f32 masked sum over a true division by the alive count, cast to the
leaf's dtype (an integer leaf's mean is f32, as ``jnp.mean``'s is). All
dead degrades to the plain sum of everyone over a true division by K.
Everything stays on the device: no host read.
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import mean_dtype, sum_axis0_f32, tree_leaves, \
    tree_map


def packed_health_stats(sbuf: torch.Tensor) -> torch.Tensor:
    """Per-replica ``(k, 2)`` f32 health stats of a packed buffer:
    ``[:, 0]`` the count of non-finite elements, ``[:, 1]`` the sum of
    squares of the finite ones."""
    finite = torch.isfinite(sbuf)
    nonfinite = (~finite).to(torch.float32).sum(1)
    masked = torch.where(finite, sbuf, torch.zeros((), dtype=sbuf.dtype,
                                                   device=sbuf.device))
    sumsq = (masked * masked).sum(1)
    return torch.stack([nonfinite, sumsq], dim=1)


def alive_from_stats(stats: torch.Tensor, n_elems: float,
                     max_rms: float | None) -> torch.Tensor:
    """``(k,)`` bool alive mask from health stats accumulated over
    ``n_elems`` elements a replica."""
    alive = stats[:, 0] == 0.0
    if max_rms is not None:
        dev = stats.device
        ms = stats[:, 1] / torch.tensor(n_elems, dtype=torch.float32,
                                        device=dev)
        limit = torch.tensor(max_rms, dtype=torch.float32, device=dev)
        alive = alive & (ms <= limit * limit)
    return alive


def renormalized_inv(k_alive: torch.Tensor, n_replicas: int) -> torch.Tensor:
    """The masked-mean multiplier ``1/k_alive`` as an f32 scalar, pinned
    to the f32 constant ``1/K`` (rounded once from the double, as the
    plain mean's) when every replica is alive."""
    k_alive = torch.as_tensor(k_alive, dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32, device=k_alive.device)
    pinned = torch.tensor(1.0 / n_replicas, dtype=torch.float32,
                          device=k_alive.device)
    return torch.where(k_alive >= n_replicas, pinned,
                       one / torch.maximum(k_alive, one))


def replica_alive_mask(stacked, max_rms: float | None = None
                       ) -> torch.Tensor:
    """``(K,)`` bool alive mask of a stacked (leading replica dim) tree: a
    replica is alive iff every one of its floating leaves is finite (and,
    with ``max_rms``, its RMS over all of them is at most that)."""
    leaves = [x for x in tree_leaves(stacked) if x.is_floating_point()]
    if not leaves:
        raise ValueError("replica_alive_mask: no floating leaves")
    k = leaves[0].shape[0]
    dev = leaves[0].device
    nonfinite = torch.zeros((k,), dtype=torch.float32, device=dev)
    sumsq = torch.zeros((k,), dtype=torch.float32, device=dev)
    n_elems = 0
    for x in leaves:
        finite = torch.isfinite(x)
        nonfinite = nonfinite + (~finite).reshape(k, -1).to(
            torch.float32).sum(1)
        xf = torch.where(finite, x, torch.zeros((), dtype=x.dtype,
                                                device=dev)).float()
        sumsq = sumsq + (xf * xf).reshape(k, -1).sum(1)
        n_elems += x.numel() // k
    stats = torch.stack([nonfinite, sumsq], dim=1)
    return alive_from_stats(stats, float(n_elems), max_rms)


def masked_mean_axis0(stacked, alive: torch.Tensor):
    """Alive-masked mean over the leading replica dim of a stacked tree
    (module doc): 0 ULP equal to ``tree_mean_axis0`` when every replica
    is alive; dead replicas add nothing and the divisor is the alive
    count; all dead degrades to the plain mean. Returns new tensors."""
    k = int(alive.shape[0])
    dev = alive.device
    k_alive = alive.to(torch.float32).sum()
    all_alive = k_alive >= k
    use = alive | (k_alive == 0.0)
    one = torch.ones((), dtype=torch.float32, device=dev)
    denom = torch.where(k_alive > 0.0, torch.maximum(k_alive, one),
                        torch.tensor(float(k), dtype=torch.float32,
                                     device=dev))
    inv_k = torch.tensor(1.0 / k, dtype=torch.float32)

    def one_leaf(x):
        mask = use.reshape((k,) + (1,) * (x.ndim - 1))
        s = sum_axis0_f32(torch.where(mask, x.float(),
                                      torch.zeros((), device=x.device)))
        dt = mean_dtype(x)
        return torch.where(all_alive, (s * inv_k).to(dt), (s / denom).to(dt))

    return tree_map(one_leaf, stacked)


def quarantine_opt_state(opt_state, alive: torch.Tensor):
    """Zero the optimizer slots of dead replicas IN PLACE (zeros are the
    fresh-init moments and counters of the port's sgd/adamw states), so a
    quarantined replica restarts from W̄ with a clean optimizer. Leaves
    whose leading dim is not the replica dim are left alone; with every
    replica alive nothing changes. Returns ``opt_state``."""
    k = int(alive.shape[0])
    for o in tree_leaves(opt_state):
        if o.ndim == 0 or o.shape[0] != k:
            continue
        o.masked_fill_(~alive.reshape((k,) + (1,) * (o.ndim - 1)), 0)
    return opt_state
