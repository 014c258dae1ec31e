"""The comparison that decides ``correct``: the numbers compared, taken
the same way from the program's outputs and from the reference's, and
each held to its limit (``limits/<workload>.json``)."""
from __future__ import annotations

import math
import sys

import torch

from hwabench.weights import leaves_of


def slice_norms(tree) -> torch.Tensor:
    """The f32 norm of every leaf of ``tree``, a stacked layer leaf
    (under ``stack``) taken a layer at a time: one 1-D tensor, in the
    order of ``weights.leaves_of``."""
    out = []
    for path, x in leaves_of(tree):
        x = x.detach()
        if path.startswith("stack/"):
            out.append(torch.linalg.vector_norm(
                x.reshape(x.shape[0], -1).float(), dim=1))
        else:
            out.append(torch.linalg.vector_norm(x.float()).reshape(1))
    return torch.cat(out)


def diff_norms(tree, base) -> torch.Tensor:
    """:func:`slice_norms` of ``tree - base``, a leaf at a time."""
    out = []
    for (path, x), (_, b) in zip(leaves_of(tree), leaves_of(base)):
        d = x.detach().float() - b.detach().float()
        if path.startswith("stack/"):
            out.append(torch.linalg.vector_norm(d.reshape(d.shape[0], -1),
                                                dim=1))
        else:
            out.append(torch.linalg.vector_norm(d).reshape(1))
        del d
    return torch.cat(out)


def worst_leaf_gap(prog, ref, keep=None) -> float:
    """max over leaves of |‖prog‖ - ‖ref‖| / max(‖ref‖, the median leaf's
    ‖ref‖), over rows (replicas) of (K, n) norms; ``keep`` (K, n) bool
    leaves out what it marks False."""
    prog, ref = prog.double().cpu(), ref.double().cpu()
    worst = 0.0
    for k in range(ref.shape[0]):
        r, p = ref[k], prog[k]
        if keep is not None:
            r, p = r[keep[k]], p[keep[k]]
        floor = r.median()
        gap = ((p - r).abs() / torch.maximum(r, floor)).max()
        worst = max(worst, float(gap))
    return worst


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): every number at or under
    its limit, and finite. A number without a limit fails."""
    table, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        table[name] = {"value": value, "limit": limit}
        if limit is None or value is None or not math.isfinite(value) \
                or value > limit:
            ok = False
    return ok, table


def print_table(table: dict) -> None:
    """The numbers compared, each beside its limit: the last lines a run
    writes on standard error."""
    for name, row in table.items():
        print(f"check {name}: {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
