"""Logical dims -> mesh axes (counterpart of ``repro.sharding.rules``).

Every parameter leaf carries a tuple of logical dim names
(``models.registry.param_dims``: ``("layers", "embed", "kv_heads",
"head_dim")`` and so on). A rule table maps a name to the mesh axes it may
split over; :func:`spec_for_dims` resolves one leaf into a *spec*: a plain
tuple with one entry per leaf dim, ``None`` (whole), an axis name, or a
tuple of axis names (the dim split over them jointly), trailing ``None``s
dropped as the reference's ``PartitionSpec`` short form drops them. A
mesh is an ``{axis: size}`` dict in layout order. Two guarantees, the
reference's:

1. **Divisibility.** A dim is split only when its size divides the axes'
   device product; otherwise the rule falls through to the next named dim
   of the leaf. This is how a GQA model whose ``kv_heads`` do not divide
   the model axis gets its k/v projections split on ``head_dim``.
2. **No axis reuse.** An axis splits at most one dim of a leaf.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

#: logical dim name -> the mesh axes it may split over, jointly
LogicalRules = dict[str, tuple[str, ...]]


def _axes_size(mesh: dict, axes: tuple[str, ...]) -> int:
    return math.prod(mesh[a] for a in axes)


def spec_for_dims(mesh: dict, rules: LogicalRules,
                  dims: Sequence[str | None], shape: Sequence[int]) -> tuple:
    """One leaf's logical dims resolved into a spec tuple."""
    if len(dims) != len(shape):
        raise ValueError(f"dims {tuple(dims)} for shape {tuple(shape)}")
    used: set[str] = set()
    out: list[Any] = []
    for name, size in zip(dims, shape):
        assignment = None
        if name is not None and name in rules:
            axes = tuple(a for a in rules[name] if a in mesh)
            if axes and not (set(axes) & used):
                if size % _axes_size(mesh, axes) == 0 and size > 0:
                    assignment = axes if len(axes) > 1 else axes[0]
                    used.update(axes)
        out.append(assignment)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def is_dims(x) -> bool:
    """A dims tuple (a leaf of a dims tree): strings and Nones."""
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def flatten_dims(dims) -> list[tuple]:
    """The leaves of a dims tree in the parameter tree's flatten order
    (dict keys sorted, lists in order), a dims tuple being a leaf."""
    if is_dims(dims):
        return [dims]
    if isinstance(dims, dict):
        return [d for k in sorted(dims) for d in flatten_dims(dims[k])]
    if isinstance(dims, (list, tuple)):
        return [d for x in dims for d in flatten_dims(x)]
    raise TypeError(f"not a dims tree: {type(dims).__name__}")


def entry_axes(entry) -> tuple[str, ...]:
    """A spec entry as a tuple of axis names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: dict
    rules: LogicalRules

    def spec(self, dims, shape) -> tuple:
        return spec_for_dims(self.mesh, self.rules, dims, shape)

    def flat_specs(self, shapes: Sequence[Sequence[int]], dims) -> list:
        """The spec of every leaf, in flatten order: ``shapes`` the leaf
        shapes, ``dims`` the matching dims tree."""
        flat = flatten_dims(dims)
        if len(flat) != len(shapes):
            raise ValueError(f"{len(flat)} dims for {len(shapes)} leaves")
        return [self.spec(d, s) for d, s in zip(flat, shapes)]


def make_tp_rules(mesh: dict, *, expert_parallel: bool = False,
                  replica_axis: str | tuple[str, ...] | None = None,
                  fsdp: bool = False,
                  sequence_parallel: bool = False) -> ShardingRules:
    """The reference's data + tensor-parallel rule table: ``batch`` over
    the data-like axes (``pod``, ``data``) that are not replica axes;
    ``vocab``, ``mlp``, ``heads``, ``kv_heads``, ``head_dim``,
    ``ssm_heads`` and ``conv_out`` over ``model`` (earlier dims of a leaf
    win the axis, later ones fall through); with ``fsdp`` the ``embed``
    weight dim over the data axes too; ``experts`` over ``model`` only
    with ``expert_parallel``; ``replica`` names the replica axes."""
    replica_axes = ((replica_axis,) if isinstance(replica_axis, str)
                    else tuple(replica_axis or ()))
    data_axes = tuple(a for a in ("pod", "data") if a in mesh
                      and a not in replica_axes)
    rules: LogicalRules = {
        "batch": data_axes,
        "vocab": ("model",),
        "mlp": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": ("model",),
        "ssm_heads": ("model",),
        "conv_out": ("model",),
        "embed": data_axes if fsdp else (),
        "layers": (),
        "seq": (),
        "act_seq": ("model",) if sequence_parallel else (),
    }
    if expert_parallel:
        rules["experts"] = ("model",)
    if replica_axes:
        rules["replica"] = replica_axes
    return ShardingRules(mesh=dict(mesh), rules=rules)
