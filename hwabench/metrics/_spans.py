"""Helpers of the readers of the program's own spans and counters
(``repro_torch.common.trace``): the registry of the latest profiling
session, which the traced slice of a ``--trace 1`` run is.

The registry is taken from the module the program has loaded
(``sys.modules``), not imported: a reader imports nothing of the
program, and a program without the module leaves every reader None. So
does a run without a trace (the CPU rehearsal).

"A step" is the traced slice's ``window.traced.steps``, "a sync" its
``syncs``; the K replicas' spans are summed. A device-idle gap of the
trace (between the merged intervals of ``ctx["trace"]["kernels"]``) is
put down to the innermost span open at the gap's middle, on the clock
the profiler and the spans share.
"""
from __future__ import annotations

import bisect
import sys

from hwabench.devtrace import _merge

MODULE = "repro_torch.common.trace"


def _module():
    return sys.modules.get(MODULE)


def spans(ctx: dict) -> list[dict] | None:
    """The closed spans of the traced slice, or None."""
    mod = _module()
    if not ctx.get("trace") or mod is None:
        return None
    recs = [r for r in mod.records() if r["end_ns"] is not None]
    return recs or None


def _per(ctx: dict, per: str) -> int:
    return ctx["window"]["traced"][per]


def device_ms(ctx: dict, name: str, per: str) -> float | None:
    """The device ms of the spans ``name`` a traced step (``per``
    "steps") or sync ("syncs")."""
    recs = spans(ctx)
    if recs is None or not _per(ctx, per):
        return None
    ms = [r["device_ms"] for r in recs
          if r["name"] == name and r["device_ms"] is not None]
    return sum(ms) / _per(ctx, per) if ms else None


def _innermost(recs: list[dict]):
    """(times, spans): from ``times[i]`` to ``times[i + 1]`` the
    innermost open span is ``spans[i]`` (None where none is open). The
    innermost is the deepest; of equal depth, the latest started."""
    by_id = {r["id"]: r for r in recs}
    depth = {}

    def depth_of(r):
        if r["id"] not in depth:
            p = by_id.get(r["parent"])
            depth[r["id"]] = 0 if p is None else depth_of(p) + 1
        return depth[r["id"]]

    marks = sorted([(r["start_ns"], 1, r["id"]) for r in recs]
                   + [(r["end_ns"], 0, r["id"]) for r in recs])
    open_, times, inner = set(), [], []
    for i, (t, opens, rid) in enumerate(marks):
        (open_.add if opens else open_.discard)(rid)
        if i + 1 < len(marks) and marks[i + 1][0] == t:
            continue
        times.append(t)
        inner.append(max(open_, key=lambda j: (depth_of(by_id[j]),
                                               by_id[j]["start_ns"], j))
                     if open_ else None)
    return times, inner


def idle_ms(ctx: dict, name: str) -> float | None:
    """The device idle a traced step put down to the spans ``name`` and
    the spans under them."""
    recs = spans(ctx)
    steps = _per(ctx, "steps")
    if recs is None or not steps or not ctx["trace"]["kernels"]:
        return None
    if not any(r["name"] == name for r in recs):
        return None
    by_id = {r["id"]: r for r in recs}

    def under(rid):
        while rid is not None:
            r = by_id.get(rid)
            if r is None:
                return False
            if r["name"] == name:
                return True
            rid = r["parent"]
        return False

    times, inner = _innermost(recs)
    merged = _merge([(s, s + d) for _, s, d in ctx["trace"]["kernels"]])
    hit = {}
    ns = 0
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        i = bisect.bisect_right(times, (e0 + s1) // 2) - 1
        rid = inner[i] if i >= 0 else None
        if rid is not None:
            if rid not in hit:
                hit[rid] = under(rid)
            if hit[rid]:
                ns += s1 - e0
    return ns / 1e6 / steps


def counter(ctx: dict, name: str) -> list[float] | None:
    """The device sum of the counter ``name`` over the traced slice."""
    mod = _module()
    if not ctx.get("trace") or mod is None:
        return None
    c = mod.summary()["counters"].get(name)
    return c["value"] if c else None
