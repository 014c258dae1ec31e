"""The readers of the program's spans and counters (``metrics/_spans.py``
and the twelve that use it) on a hand-made context and registry: device
ms a traced step and sync, the device idle put down to the innermost
span open at a gap's middle, the expert imbalance, and None wherever
there is nothing to read."""
import bisect
import os
import sys
import types

import pytest

from hwabench.harness import Bench
from hwabench.metrics import _spans

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = Bench(ROOT)

DEVICE = {"forward_ms.train": "hwa.step.forward",
          "backward_ms.train": "hwa.step.backward",
          "update_ms.train": "hwa.step.update",
          "moe_dispatch_ms.train": "moe.dispatch",
          "moe_combine_ms.train": "moe.combine"}
SYNC = {"sync_divergence_ms.train": "hwa.sync.divergence",
        "sync_pack_ms.train": "hwa.sync.pack",
        "sync_restart_ms.train": "hwa.sync.restart"}
IDLE = ("forward_idle_ms.train", "backward_idle_ms.train",
        "update_idle_ms.train")
ALL = sorted([*DEVICE, *SYNC, *IDLE, "moe_expert_imbalance.train"])

#: (name, parent index, start, end, device ms): two steps of one replica
#: each and a sync, with an expert layer in the forward and again in the
#: backward's recompute; times in ns
SPANS = [
    ("hwa.step", None, 0, 1000, 10.0),
    ("hwa.step.forward", 0, 0, 300, 3.0),
    ("moe.dispatch", 1, 100, 150, 0.5),
    ("moe.combine", 1, 200, 250, 0.25),
    ("hwa.step.backward", 0, 300, 700, 4.0),
    ("moe.dispatch", 4, 400, 450, 0.5),
    ("moe.combine", 4, 500, 550, 0.25),
    ("hwa.step.update", 0, 700, 990, 2.0),
    ("hwa.step", None, 1000, 2000, 10.0),
    ("hwa.step.forward", 8, 1000, 1300, 5.0),
    ("hwa.step.backward", 8, 1300, 1700, 6.0),
    ("hwa.step.update", 8, 1700, 1990, 4.0),
    ("hwa.sync", None, 2000, 2500, 8.0),
    ("hwa.sync.divergence", 12, 2000, 2100, 1.5),
    ("hwa.sync.pack", 12, 2100, 2200, 1.25),
    ("hwa.sync.restart", 12, 2300, 2400, 0.75),
    ("hwa.sync.restart", 12, 2400, 2500, 0.5),
]

#: device intervals (start, end): the gaps fall in the first step's
#: dispatch (10 ns), its forward (20), the recompute's combine (30), its
#: update (40), the step itself after its update (10: no phase), the
#: second step's backward (50) and outside every span (60)
KERNELS = [(0, 110), (120, 170), (190, 520), (550, 760), (800, 993),
           (1003, 1400), (1450, 2600), (2660, 2700)]


def _records():
    recs = []
    for i, (name, parent, s, e, ms) in enumerate(SPANS):
        root = name if parent is None else recs[parent]["root"]
        recs.append({"id": i, "name": name, "args": {}, "parent": parent,
                     "root": root, "index": 0, "thread": 1, "start_ns": s,
                     "end_ns": e, "device_ms": ms})
    return recs


@pytest.fixture
def registry(monkeypatch):
    mod = types.ModuleType(_spans.MODULE)
    mod.records = _records
    mod.summary = lambda: {"spans": {}, "counters": {
        "moe.expert_pairs": {"calls": 4, "value": [30.0, 20.0]}}}
    monkeypatch.setitem(sys.modules, _spans.MODULE, mod)
    return mod


def _ctx(trace=True):
    return {"window": {"traced": {"steps": 2, "syncs": 1}},
            "trace": {"kernels": [("k", s, e - s) for s, e in KERNELS],
                      "busy_s": 0.0, "window_s": 1.0} if trace else None}


@pytest.mark.parametrize("metric", sorted(DEVICE))
def test_device_ms_a_step(registry, metric):
    want = sum(ms for name, _, _, _, ms in SPANS
               if name == DEVICE[metric]) / 2
    assert BENCH.reader(metric)(_ctx()) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(SYNC))
def test_device_ms_a_sync(registry, metric):
    want = sum(ms for name, _, _, _, ms in SPANS if name == SYNC[metric])
    assert BENCH.reader(metric)(_ctx()) == pytest.approx(want)


def test_sync_restart_sums_both_entries(registry):
    assert BENCH.reader("sync_restart_ms.train")(_ctx()) == 1.25


def test_idle_goes_to_the_innermost_span_and_up_to_its_phase(registry):
    # forward: the gaps in its dispatch (110-120) and its own (170-190);
    # backward: the recompute's combine (520-550) and the second step's
    # (1400-1450); update: 760-800; the step's own gap (993-1003) and the
    # one outside every span (2600-2660) go to no phase
    got = {m: BENCH.reader(m)(_ctx()) for m in IDLE}
    assert got == {"forward_idle_ms.train": (10 + 20) / 1e6 / 2,
                   "backward_idle_ms.train": (30 + 50) / 1e6 / 2,
                   "update_idle_ms.train": 40 / 1e6 / 2}


def test_innermost_is_the_deepest_open_span():
    times, inner = _spans._innermost(_records())

    def at(t):
        return inner[bisect.bisect_right(times, t) - 1]
    assert at(125) == 2 and at(180) == 1 and at(995) == 0
    assert at(2050) == 13 and at(2250) == 12 and at(2600) is None


def test_expert_imbalance(registry):
    assert BENCH.reader("moe_expert_imbalance.train")(_ctx()) == 1.5


@pytest.mark.parametrize("metric", ALL)
def test_none_without_a_trace(registry, metric):
    assert BENCH.reader(metric)(_ctx(trace=False)) is None


@pytest.mark.parametrize("metric", ALL)
def test_none_without_the_programs_spans(monkeypatch, metric):
    """A program without the module (an older commit) or with nothing
    recorded gives no reading and raises nothing."""
    monkeypatch.delitem(sys.modules, _spans.MODULE, raising=False)
    assert BENCH.reader(metric)(_ctx()) is None
    empty = types.ModuleType(_spans.MODULE)
    empty.records = list
    empty.summary = lambda: {"spans": {}, "counters": {}}
    monkeypatch.setitem(sys.modules, _spans.MODULE, empty)
    assert BENCH.reader(metric)(_ctx()) is None


def test_the_twelve_are_declared():
    entries = {m["name"]: m for m in BENCH.manifest["per_layer"]}
    both = {w["name"] for w in BENCH.manifest["workloads"]}
    for metric in ALL:
        m = entries[metric]
        assert m["moves"] == "train_tokens_per_s"
        assert set(m["workloads"]) == (
            {"train.granite-moe-1b-a400m.h8"} if metric.startswith("moe_")
            else both)
