"""The traced part of a run: ``torch.profiler`` over a slice of the
window, reduced to what the per-layer readers need.

The profiler's raw events are read once (``kineto_results.events()``);
``key_averages`` builds an event tree first and takes minutes over
10^5 kernels. The benchmark's own spans are ``record_function`` ranges
named ``hwabench.<what>`` around its calls into the program; an idle gap
of the device is put down to the innermost such range that was open at
its middle.
"""
from __future__ import annotations

import bisect
import time

import torch

SPAN_PREFIX = "hwabench."


def span(name: str):
    """A range of the benchmark's own around a call into the program."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class Tracer:
    """Starts and stops the profiler at step boundaries: ``start`` and
    ``stop`` synchronize the device, so the traced window is the host
    time between them and holds all the device work issued in it."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.window_s = None
        self.summary = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._t0 = time.perf_counter()

    @property
    def running(self) -> bool:
        return self.prof is not None and self.window_s is None

    def stop(self):
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.prof.stop()
        self.summary = reduce_events(self.prof.profiler.kineto_results
                                     .events(), self.window_s)
        self.prof = None
        return self.summary


def _merge(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events, window_s: float) -> dict:
    """kernels: [(name, start_ns, dur_ns)] of the device's work; busy_s:
    the union of their intervals; device_ops: [[name, seconds]] by time;
    idle_gaps: [[what the host was doing, seconds]] by time; window_s."""
    cpu = torch.autograd.DeviceType.CPU
    kernels, spans = [], []
    for e in events:
        name = e.name()
        if e.device_type() == cpu:
            if name.startswith(SPAN_PREFIX):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              name[len(SPAN_PREFIX):]))
        elif not e.is_user_annotation():
            kernels.append((name, e.start_ns(), e.duration_ns()))
    merged = _merge([(s, s + d) for _, s, d in kernels])
    busy_ns = sum(e - s for s, e in merged)
    by_name = {}
    for name, _, d in kernels:
        by_name[name] = by_name.get(name, 0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    spans.sort()
    starts = [s[0] for s in spans]
    gaps = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        mid = (e0 + s1) // 2
        # the innermost open range: the latest-started one still open
        # (the ranges nest); a bounded look back
        what = "outside the benchmark's spans"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 64, -1), -1):
            if spans[j][1] >= mid:
                what = spans[j][2]
                break
        gaps[what] = gaps.get(what, 0) + (s1 - e0)
    return {"kernels": kernels, "busy_s": busy_ns / 1e9,
            "window_s": window_s,
            "device_ops": [[n, d / 1e9] for n, d in ops[:10]],
            "idle_gaps": [[n, d / 1e9] for n, d in
                          sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]}
