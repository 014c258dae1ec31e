"""Machine-readable lint report: build, serialize, summarize (the
reference's schema, version 1)::

    {"schema": 1,
     "smoke": bool,                     # the smoke subset vs the matrix
     "bundles": {
        "<case name>": {
           "ok": bool,
           "passes": {
              "<pass>": {"ok": bool, "skipped": bool,
                         "violations": [str], "evidence": [str]},
              ...},
           "error": str,               # only when the case failed to build
        }, ...},
     "ok": bool,
     "n_bundles": int, "n_violations": int}

``report_ok(json.loads(json.dumps(r)))`` is the exit-status predicate,
stable under a JSON round trip.
"""
from __future__ import annotations

import json

from repro_torch.analysis.passes import PassResult

SCHEMA_VERSION = 1


def bundle_entry(results: list[PassResult], error: str | None = None
                 ) -> dict:
    """One case's entry from its pass results (or a build error, which
    fails the case)."""
    if error is not None:
        return {"ok": False, "passes": {}, "error": error}
    return {"ok": all(r.ok for r in results),
            "passes": {r.name: r.as_json() for r in results}}


def build_report(bundles: dict[str, dict], smoke: bool = False) -> dict:
    n_violations = sum(
        len(p.get("violations", ())) for entry in bundles.values()
        for p in entry.get("passes", {}).values())
    n_violations += sum(1 for entry in bundles.values() if "error" in entry)
    return {"schema": SCHEMA_VERSION,
            "smoke": bool(smoke),
            "bundles": bundles,
            "ok": all(entry["ok"] for entry in bundles.values()),
            "n_bundles": len(bundles),
            "n_violations": n_violations}


def report_ok(report: dict) -> bool:
    """The exit-status predicate: every case ok, and at least one case
    (a matrix filtered to nothing fails)."""
    return bool(report.get("ok")) and report.get("n_bundles", 0) > 0


def to_json(report: dict) -> str:
    return json.dumps(report, indent=2, sort_keys=True)


def summarize(report: dict) -> str:
    """The per-case × per-pass table for the console."""
    lines = []
    for name in sorted(report["bundles"]):
        entry = report["bundles"][name]
        if "error" in entry:
            lines.append(f"ERROR {name}: {entry['error']}")
            continue
        verdicts = []
        for pname, p in entry["passes"].items():
            mark = ("skip" if p["skipped"] else
                    "ok" if p["ok"] else "FAIL")
            verdicts.append(f"{pname}={mark}")
        head = "PASS " if entry["ok"] else "FAIL "
        lines.append(head + name + "  [" + " ".join(verdicts) + "]")
        for p in entry["passes"].values():
            for v in p["violations"]:
                lines.append(f"    - {v}")
    mode = "smoke subset" if report.get("smoke") else "full matrix"
    lines.append(
        f"{'OK' if report_ok(report) else 'FAIL'} hwa-lint ({mode}): "
        f"{report['n_bundles']} bundle configs, "
        f"{report['n_violations']} violation(s)")
    return "\n".join(lines)
