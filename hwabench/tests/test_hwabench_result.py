"""The result's last line: its keys, in order, as the harness prints
them from a run (here the CPU rehearsal of each cell)."""
import json

import pytest

from hwabench.harness import Bench, result_line
from hwabench.rehearse import ROOT, rehearse

WORKLOADS = [w["name"] for w in Bench(ROOT).manifest["workloads"]]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_last_line_keys(workload):
    res = rehearse(workload, seconds=1.0)
    line = result_line(res, {"platform": "gpu", "kind": "a card",
                             "count": 1})
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    names = {m["name"] for m in Bench(ROOT).metrics_for(workload, False)}
    assert set(line["metrics"]) == names
    assert all(set(v) == {"value", "unit"} for v in line["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    json.dumps(line)


def test_traced_line_carries_the_trace():
    res = {"correct": True, "attempted": 3, "failed": 0, "metrics": {},
           "memory_peak_bytes": 7, "busy_s": 1.5, "window_s": 2.0,
           "breakdown": {"device_ops": [["k", 1.0]], "idle_gaps": []},
           "checks": {"loss_gap": {"value": 0.0, "limit": 1.0}}}
    line = result_line(res, {"platform": "gpu", "kind": "a card",
                             "count": 1})
    assert list(line)[-1] == "checks"
    assert line["device"]["busy_s"] == 1.5
    assert line["device"]["window_s"] == 2.0
    assert "breakdown" in line
