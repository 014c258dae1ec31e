"""Tree helpers of the port: the parameter and optimizer trees are nested
dicts and lists of tensors, as in the JAX package.

Counterpart of ``repro.common.pytree`` (only the helpers the training
path uses: flatten/unflatten/map and the replica mean). Leaves are visited in JAX's flatten order: dict keys sorted,
lists and tuples in order, ``None`` a node with no leaves. That order is
what makes a packed buffer byte-equal to the reference's.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

PyTree = Any


def _children(tree):
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys)), [tree[k] for k in keys]
    if isinstance(tree, (list, tuple)):
        return (type(tree), len(tree)), list(tree)
    if tree is None:
        return ("none", None), []
    return None, None


def tree_flatten(tree: PyTree) -> tuple[list, Any]:
    """(leaves in JAX's order, a structure :func:`tree_unflatten` takes)."""
    node, kids = _children(tree)
    if node is None:
        return [tree], "leaf"
    leaves, defs = [], []
    for kid in kids:
        sub_leaves, sub_def = tree_flatten(kid)
        leaves += sub_leaves
        defs.append(sub_def)
    return leaves, (node, tuple(defs))


def tree_unflatten(treedef, leaves) -> PyTree:
    it = iter(leaves)

    def build(d):
        if d == "leaf":
            return next(it)
        (kind, meta), kids = d
        vals = [build(k) for k in kids]
        if kind == "dict":
            return dict(zip(meta, vals))
        if kind == "none":
            return None
        return kind(vals)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree: PyTree) -> list:
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    leaves, treedef = tree_flatten(tree)
    others = [tree_flatten(r) for r in rest]
    for _, d in others:
        if d != treedef:
            raise ValueError("tree_map over trees of different structure")
    return tree_unflatten(treedef, [fn(*xs) for xs in
                                    zip(leaves, *(o[0] for o in others))])


def sum_axis0_f32(x: torch.Tensor) -> torch.Tensor:
    """Σ_k x[k] in f32, added sequentially from k = 0 in the order of
    XLA's reduce on the CPU: a single row is returned as it is, more rows
    are added onto a +0 start (so -0 + -0 gives +0 there, as in XLA).
    The sync kernel sums in the same order, so the bits agree everywhere,
    signed zeros included."""
    if x.shape[0] == 1:
        return x[0].float()
    acc = torch.zeros(x.shape[1:], dtype=torch.float32, device=x.device)
    for k in range(x.shape[0]):
        acc = acc + x[k].float()
    return acc


def tree_mean_axis0(tree: PyTree) -> PyTree:
    """Mean over the leading (replica) axis of every leaf, as ``jnp.mean``
    computes it on XLA's CPU backend: the f32 sum times the f32 reciprocal
    of K (XLA rewrites the division by the constant K into that product;
    measured against jax 0.9 — the two differ by up to 1 ULP when K is not
    a power of two), cast back to the leaf dtype."""
    def mean(x):
        inv_k = torch.tensor(1.0 / x.shape[0], dtype=torch.float32)
        return (sum_axis0_f32(x) * inv_k).to(x.dtype)
    return tree_map(mean, tree)
