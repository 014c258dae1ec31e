"""Tree helpers of the port: the parameter and optimizer trees are nested
dicts and lists of tensors, as in the JAX package.

Counterpart of ``repro.common.pytree`` (the helpers the port uses:
flatten/unflatten/map, the replica mean, ``tree_lerp``) and of
``jax.tree.flatten_with_path``. Leaves are visited in JAX's flatten
order: dict keys sorted, lists and tuples in order, ``None`` a node with
no leaves, and a dataclass registered with :func:`register_dataclass`
(the reference's ``jax.tree_util.register_dataclass``) by its data
fields in the order given there, its meta fields held in the structure.
That order is what makes a packed buffer byte-equal to the reference's
and a checkpoint's key paths equal to the ones the reference writes.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

PyTree = Any

#: class -> (data fields in the reference's order, meta fields)
_DATACLASSES: dict[type, tuple[tuple[str, ...], tuple[str, ...]]] = {}


def register_dataclass(cls, data_fields, meta_fields=()):
    """Make ``cls`` a tree node, as ``jax.tree_util.register_dataclass``
    does: its ``data_fields`` are children (a ``None`` one holds no
    leaf), its ``meta_fields`` are part of the structure. Returns
    ``cls``."""
    _DATACLASSES[cls] = (tuple(data_fields), tuple(meta_fields))
    return cls


def _children(tree):
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", tuple(keys)), [tree[k] for k in keys]
    if isinstance(tree, (list, tuple)):
        return (type(tree), len(tree)), list(tree)
    if tree is None:
        return ("none", None), []
    fields = _DATACLASSES.get(type(tree))
    if fields is not None:
        data, meta = fields
        return ((type(tree), tuple(getattr(tree, f) for f in meta)),
                [getattr(tree, f) for f in data])
    return None, None


def _child_keys(node) -> list[str]:
    """JAX's key of each child of ``node``, as ``str`` of its key entry
    prints it in a checkpoint: a dict key itself, a sequence index, and
    ``.field`` for a registered dataclass (``str(GetAttrKey)``)."""
    kind, meta = node
    if kind == "dict":
        return [str(k) for k in meta]
    if kind in _DATACLASSES:
        return ["." + f for f in _DATACLASSES[kind][0]]
    if kind == "none":
        return []
    return [str(i) for i in range(meta)]


def tree_flatten_with_path(tree: PyTree) -> tuple[list, Any]:
    """([(key path, leaf)] in JAX's order, a structure
    :func:`tree_unflatten` takes): each path a tuple of JAX's key
    strings (:func:`_child_keys`)."""
    node, kids = _children(tree)
    if node is None:
        return [((), tree)], "leaf"
    flat, defs = [], []
    for key, kid in zip(_child_keys(node), kids):
        sub, sub_def = tree_flatten_with_path(kid)
        flat += [((key,) + path, leaf) for path, leaf in sub]
        defs.append(sub_def)
    return flat, (node, tuple(defs))


def tree_flatten(tree: PyTree) -> tuple[list, Any]:
    """(leaves in JAX's order, a structure :func:`tree_unflatten` takes)."""
    flat, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in flat], treedef


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
        if kind in _DATACLASSES:
            data, meta_names = _DATACLASSES[kind]
            return kind(**dict(zip(data, vals)),
                        **dict(zip(meta_names, meta)))
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


def tree_lerp(a: PyTree, b: PyTree, t) -> PyTree:
    """``x + t·(y − x)`` over matching leaves, rounded after each
    operation as the reference's expression is when run eagerly (under
    ``jit`` XLA's CPU build contracts it into one FMA; ROADMAP.md
    Queue C)."""
    return tree_map(lambda x, y: x + t * (y - x), a, b)


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


def mean_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype of ``jnp.mean(x)``: ``x``'s own for a floating leaf, f32
    for an integer or bool one."""
    return x.dtype if x.is_floating_point() else torch.float32


def tree_mean_axis0(tree: PyTree) -> PyTree:
    """Mean over the leading (replica) axis of every leaf, as ``jnp.mean``
    computes it on XLA's CPU backend: the f32 sum times the f32 reciprocal
    of K (XLA rewrites the division by the constant K into that product;
    measured against jax 0.9 — the two differ by up to 1 ULP when K is not
    a power of two), cast back to the leaf dtype (:func:`mean_dtype`: an
    integer leaf's mean stays f32)."""
    def mean(x):
        inv_k = torch.tensor(1.0 / x.shape[0], dtype=torch.float32)
        return (sum_axis0_f32(x) * inv_k).to(mean_dtype(x))
    return tree_map(mean, tree)
