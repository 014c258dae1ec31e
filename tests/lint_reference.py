"""The reference's contract checker (``repro.analysis.lint``) on 8 forced
host devices, as the CPU oracle of ``tests/test_torch_lint_*.py``:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        PYTHONPATH=src python tests/lint_reference.py OUT.json [SUBSTR ...]

For every case of the reference's matrix whose name contains one of the
SUBSTRs (all cases without one), OUT.json holds: ``smoke``; its report
entry (``run_case``'s: each pass's ``ok``, ``skipped``, violations and
evidence, or ``error``); and, from the same compiled module, its
``census``: every collective instruction a level and op (the level the
mesh axes its replica groups span, in mesh order, joined by ``+``; the
op in the port's spelling, ``all-reduce`` as ``all_reduce``),
``payloads``: the result dtype tokens of the collectives a level, and
``launches``: the ``pallas_call`` eqns in its jaxpr.
"""
import json
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ.setdefault("JAX_PLATFORMS", "cpu")

from repro.analysis.hlo_text import (axis_coords,  # noqa: E402
                                     collective_instructions,
                                     count_pallas_calls,
                                     parse_replica_groups)
from repro.analysis.lint import default_cases  # noqa: E402
from repro.analysis.passes import (BundleArtifacts,  # noqa: E402
                                   collectives_pass, donation_pass,
                                   dtype_pass, launch_budget_pass,
                                   manual_hazard_pass)
from repro.analysis.report import bundle_entry  # noqa: E402


def census(text, mesh):
    coords = axis_coords(mesh)
    counts, payloads = {}, {}
    for inst in collective_instructions(text):
        groups = parse_replica_groups(inst.line) or []
        lvl = "+".join(a for a in mesh.axis_names
                       if any(len({coords[a].get(d, -1) for d in g}) > 1
                              for g in groups))
        op = inst.base_op.replace("-", "_")
        row = counts.setdefault(lvl, {})
        row[op] = row.get(op, 0) + 1
        payloads[lvl] = sorted(set(payloads.get(lvl, []))
                               | set(inst.result_dtypes))
    return counts, payloads


def lint(case):
    """``run_case``'s entry, the passes in ``run_passes``' order over one
    ``BundleArtifacts``, and the census of its compiled module."""
    out = {"smoke": case.smoke}
    try:
        bundle, mesh = case.build()
        contract = case.contract or bundle.contract
        art = BundleArtifacts(bundle, mesh)
        hazard = manual_hazard_pass(art, contract)
        launch = launch_budget_pass(art, contract)
        results = [collectives_pass(art, contract), launch,
                   donation_pass(art, contract), dtype_pass(art, contract),
                   hazard]
        out["census"], out["payloads"] = census(art.compiled_text, mesh)
        out["launches"] = count_pallas_calls(art.jaxpr)
    except Exception as e:                      # noqa: BLE001
        out["entry"] = bundle_entry([], error=f"{type(e).__name__}: {e}")
        return out
    out["entry"] = bundle_entry(results)
    return out


def main(dst, subs):
    res = {}
    for case in default_cases():
        if subs and not any(s in case.name for s in subs):
            continue
        res[case.name] = lint(case)
    with open(dst, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
