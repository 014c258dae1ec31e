"""One run of one cell: find the cell's files by the names in
``BENCHMARK.json``, run its set-up and window, read its metrics, compare
with the reference, and print the result line.

Data-driven: a workload names a configuration (``configs/<name>.json``,
whose ``reference`` names ``reference/<name>.py``) and a traffic mix
(``traffic/<name>.json``, whose ``kind`` names ``drivers/<kind>.py``);
each per-layer metric is read by ``metrics/<name>.py``; each workload's
limits are ``limits/<workload>.json``. Adding a cell or a metric adds
files and entries and edits none.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
#: top-level modules that may not be loaded in a run: the JAX package
#: (``repro``) and JAX itself, compared whole (``repro_torch`` is fine)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Bench:
    """The manifest and the files each of its names leads to."""

    def __init__(self, root: str):
        self.root = root
        self.manifest = load_json(root, "BENCHMARK.json")
        self.dir = os.path.join(root, "hwabench")

    def workload(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        entry = next(c for c in self.manifest["configs"]
                     if c["name"] == name)
        return load_json(self.root, entry["file"])

    def traffic(self, name: str) -> dict:
        return load_json(self.dir, "traffic", name + ".json")

    def reference(self, cfg: dict):
        return importlib.import_module("hwabench.reference."
                                       + cfg["reference"])

    def limits(self, workload: str) -> dict:
        return load_json(self.dir, "limits", workload + ".json")["limits"]

    def metrics_for(self, workload: str, trace: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those whose ``workloads`` name it, or that have none."""
        key = "per_layer" if trace else "end_to_end"
        return [m for m in self.manifest[key]
                if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        path = os.path.join(self.dir, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "hwabench.metrics." + metric.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def build_cell(bench: Bench, workload: str, seed: int, device, **hooks):
    """The cell object of ``workload`` (its driver's ``Cell``)."""
    from hwabench.drivers import driver_for
    w = bench.workload(workload)
    cfg = bench.config(w["config"])
    traffic = bench.traffic(w["traffic"])
    driver = driver_for(traffic["kind"])
    return driver, driver.Cell(cfg, traffic, bench.reference(cfg), seed,
                               device, **hooks)


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def read_metrics(bench, workload, cell, w, trace_summary, trace: bool,
                 extra: dict) -> dict:
    """The metrics of the cell's result line: end to end (with the
    set-up and the memory peak in ``extra``), or per layer from their
    readers; a reader that finds nothing is left out."""
    out = {}
    if not trace:
        values = {**cell.end_to_end(w), **extra}
        for m in bench.metrics_for(workload, False):
            value, unit = values[m["name"]]
            out[m["name"]] = {"value": value, "unit": unit}
        return out
    from hwabench.weights import leaves_of
    ctx = {"kind": cell.kind, "sizes": cell.sizes, "traffic": cell.traffic,
           "window": w, "spans": cell.span_ms(), "trace": trace_summary,
           "param_shapes": [spec[0] for _, spec in leaves_of(cell.shapes)]}
    for m in bench.metrics_for(workload, True):
        value = bench.reader(m["name"])(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(bench: Bench, workload: str, seed: int, seconds: float,
        trace: bool, device, t_start: float, log=print, **hooks) -> dict:
    """Set-up, window, metrics, comparison: the result's dict (without
    ``device``). ``hooks`` go to the cell (the fault tests plant their
    faults through them)."""
    import torch

    from hwabench import check
    marks = [("start", t_start)]

    def clock(what):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        marks.append((what, time.perf_counter()))

    driver, cell = build_cell(bench, workload, seed, device, **hooks)
    cell.setup(clock)
    setup_s = time.perf_counter() - t_start
    split = ", ".join(f"{what} {b - a:.3f} s" for (_, a), (what, b)
                      in zip(marks, marks[1:]))
    log(f"setup_s {setup_s:.3f}: {split}", file=sys.stderr)
    tracer = None
    if trace and torch.device(device).type == "cuda":
        from hwabench.devtrace import Tracer
        tracer = Tracer(device)
    w = cell.window(seconds, tracer)
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)
    summary = tracer.summary if tracer is not None else None
    metrics = read_metrics(bench, workload, cell, w, summary, trace, {
        "setup_s": (setup_s, "s"), "peak_mem_gib": (peak / 2**30, "GiB")})
    log(f"window {w['window_s']:.3f} s: " + json.dumps(
        {k: v for k, v in w.items() if k != "traced"}), file=sys.stderr)
    cell.free()
    t_ref = time.perf_counter()
    nums = driver.numbers(cell.program_readings, cell.reference_readings())
    log(f"reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    correct, table = check.judge(nums, bench.limits(workload))
    result = {"correct": correct, "attempted": w["attempted"],
              "failed": w["failed"], "metrics": metrics,
              "memory_peak_bytes": peak}
    if summary is not None:
        result["busy_s"] = summary["busy_s"]
        result["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = table
    return result


def main(argv, t_start: float, root: str) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = Bench(root)
    chips = bench.workload(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"hwabench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.cuda.reset_peak_memory_stats(device)
    res = run(bench, args.workload, args.seed, args.seconds,
              bool(args.trace), device, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"hwabench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    out = result_line(res, {"platform": "gpu",
                            "kind": torch.cuda.get_device_name(device),
                            "count": chips})
    for v in out["metrics"].values():
        if not math.isfinite(v["value"]):
            print(f"hwabench: a metric is not finite: {out['metrics']}",
                  file=sys.stderr)
            return 5
    from hwabench.check import print_table
    print(json.dumps(out), flush=True)
    print_table(out["checks"])
    return 0


def result_line(res: dict, device: dict) -> dict:
    """The result's last line from :func:`run`'s dict: ``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device`` (with the memory
    peak, and the traced busy and window seconds), ``breakdown`` where
    traced, and the numbers compared last."""
    res = dict(res)
    dev = dict(device, memory_peak_bytes=res.pop("memory_peak_bytes"))
    if "busy_s" in res:
        dev["busy_s"] = res.pop("busy_s")
        dev["window_s"] = res.pop("window_s")
    checks = res.pop("checks")
    return {**res, "device": dev, "checks": checks}
