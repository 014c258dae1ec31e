"""Spans and counters of the port's own phases, live only while a
``torch.profiler`` runs.

The profiler is the one switch. Run training under it::

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, _ = hwa_inner_step(cfg, state, batches, loss_fn, opt, lr)
        state, _ = hwa_sync(cfg, state)
    prof.export_chrome_trace("trace.json")
    print(repro_torch.common.trace.summary())

and the phases appear by name in the exported trace (``hwa.step``,
``hwa.step.forward``/``backward``/``update``, ``hwa.sync`` and its
``divergence``, ``pack`` and ``restart``, ``moe.dispatch`` and
``moe.combine``); :func:`summary` gives per span name the calls and the
device, host and self milliseconds, and the counters; :func:`records`
the raw spans, for a reader that needs their intervals.

While no profiler runs, :func:`span` and :func:`count` look at the
profiler's flag and do nothing more: no ``record_function``, no CUDA
event, no record. While one runs, a span opens a ``record_function``
range of its name and appends a record: its name and arguments, its
parent (the innermost span open in the process when it opened), its
thread, its host start and end on ``time.time_ns()``'s clock (the clock
the profiler stamps its host events with, and aligns the device's
kernel stamps to), a CUDA event pair on the current stream where CUDA
is in use, and the ordinal of the outermost span it lies in (the step
or the sync it belongs to: a count kept here on the host). The stack of
open spans is one for the process: the remat recompute runs on the
autograd engine's thread and nests under the backward span open on the
calling thread. A counter adds device tensors and is read to the host
only by :func:`summary`.

The registry holds the latest profiling session: the first span or
counter that finds the profiler on after a look (by a span, a counter,
:func:`summary` or :func:`records`) that found it off clears it.
"""
from __future__ import annotations

import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _prof


#: the context of a span while no profiler runs
_OFF = contextlib.nullcontext()


class _Registry:
    def __init__(self):
        self.lock = threading.Lock()
        self.live = False        # the last look found the profiler on
        self.clear()

    def clear(self):
        self.spans = []          # records in the order they opened
        self.stack = []          # open records, innermost last
        self.roots = {}          # name -> outermost spans of it so far
        self.counters = {}       # name -> [device sum, calls]

    def begin(self):
        """Under the lock, with the profiler on: a new session clears
        the last one."""
        if not self.live:
            self.clear()
            self.live = True


_REG = _Registry()


class _Span:
    __slots__ = ("rec", "rf")

    def __init__(self, name, args):
        self.rec = {"name": name, "args": args}

    def __enter__(self):
        rec = self.rec
        rec["thread"] = threading.get_ident()
        with _REG.lock:
            _REG.begin()
            parent = _REG.stack[-1] if _REG.stack else None
            if parent is None:
                rec["parent"], rec["root"] = None, rec["name"]
                rec["index"] = _REG.roots.get(rec["name"], 0)
                _REG.roots[rec["name"]] = rec["index"] + 1
            else:
                rec["parent"] = parent["id"]
                rec["root"], rec["index"] = parent["root"], parent["index"]
            rec["id"] = len(_REG.spans)
            _REG.spans.append(rec)
            _REG.stack.append(rec)
        args = rec["args"]
        self.rf = torch.profiler.record_function(
            rec["name"], ",".join(f"{k}={v}" for k, v in args.items())
            if args else None)
        rec["start_ns"] = time.time_ns()
        self.rf.__enter__()
        if torch.cuda.is_initialized():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["events"] = (ev, None)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if "events" in rec:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            rec["events"] = (rec["events"][0], ev)
        self.rf.__exit__(*exc)
        rec["end_ns"] = time.time_ns()
        with _REG.lock:
            stack = _REG.stack
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] is rec:
                    del stack[i]
                    break
        return False


def span(name: str, **args):
    """A context manager: the phase ``name`` (``args`` are its
    arguments, as ``k`` for a replica), traced while a profiler runs."""
    if not _prof._is_profiler_enabled:
        _REG.live = False
        return _OFF
    return _Span(name, args)


def count(name: str, value) -> None:
    """Add ``value()``, a device tensor, to the counter ``name`` on the
    device. ``value`` is called only while a profiler runs, so that
    nothing is computed otherwise."""
    if not _prof._is_profiler_enabled:
        _REG.live = False
        return
    with torch.no_grad():
        value = value()
    with _REG.lock:
        _REG.begin()
        c = _REG.counters.get(name)
        if c is None:
            _REG.counters[name] = [value, 1]
        else:
            c[0] = c[0] + value
            c[1] += 1


def _look():
    if not _prof._is_profiler_enabled:
        _REG.live = False


def records() -> list[dict]:
    """The spans of the latest profiling session in the order they
    opened: ``id``, ``name``, ``args``, ``parent`` (an ``id`` or None),
    ``root`` and ``index`` (the outermost span's name and ordinal),
    ``thread``, ``start_ns`` and ``end_ns`` (None while open) on
    ``time.time_ns()``'s clock, and ``device_ms`` (None without CUDA
    events or while open). The events are read once, after a device
    synchronize."""
    _look()
    with _REG.lock:
        spans = list(_REG.spans)
    pending = [r for r in spans if "events" in r and "end_ns" in r]
    if pending:
        torch.cuda.synchronize()
        for r in pending:
            a, b = r.pop("events")
            r["device_ms"] = a.elapsed_time(b)
    keys = ("id", "name", "args", "parent", "root", "index", "thread")
    return [{**{k: r[k] for k in keys}, "start_ns": r.get("start_ns"),
             "end_ns": r.get("end_ns"), "device_ms": r.get("device_ms")}
            for r in spans]


def summary() -> dict:
    """``{"spans": {name: {"calls", "device_ms", "host_ms",
    "self_ms"}}, "counters": {name: {"calls", "value"}}}`` of the latest
    profiling session over its closed spans. ``self_ms`` is a span's
    duration less its children's: device time where the spans have CUDA
    events, host time where they have none. ``device_ms`` is None
    without events. Each counter's device sum is read to the host
    here."""
    recs = [r for r in records() if r["end_ns"] is not None]
    host = {r["id"]: (r["end_ns"] - r["start_ns"]) / 1e6 for r in recs}
    own = {r["id"]: (r["device_ms"] if r["device_ms"] is not None
                     else host[r["id"]]) for r in recs}
    children = {}
    for r in recs:
        if r["parent"] in own:
            children[r["parent"]] = children.get(r["parent"], 0.0) \
                + own[r["id"]]
    spans = {}
    for r in recs:
        s = spans.setdefault(r["name"], {"calls": 0, "device_ms": None,
                                         "host_ms": 0.0, "self_ms": 0.0})
        s["calls"] += 1
        if r["device_ms"] is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r["device_ms"]
        s["host_ms"] += host[r["id"]]
        s["self_ms"] += own[r["id"]] - children.get(r["id"], 0.0)
    with _REG.lock:
        counters = dict(_REG.counters)
    return {"spans": spans,
            "counters": {n: {"calls": c, "value": v.cpu().tolist()}
                         for n, (v, c) in counters.items()}}
