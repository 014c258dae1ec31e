"""The port's contract checker's in-process cases
(``repro_torch.analysis.lint``: the ``@1dev`` cases and the stand-ins of
the reference's GSPMD cases), its matrix and its command line, held to
the reference's lint of the whole matrix (``tests/lint_compare.py``):

- the matrix is the reference's 17 cases in order, with its 8 smoke flags;
- every in-process case passes; the paged decode step agrees with the
  reference's (no collectives, the paged kernel once an attention layer);
  the stacked K 4 sync agrees on its verdicts, with the placement's stated
  differences;
- the two cases the reference cannot build on this jax
  (``train/hwa-vmap``, ``sync/legacy-kernel@1dev``) are named with its
  error and held to its formulas (``train_contract``, ``sync_contract``
  of a process-local stack), their launch budgets stated beside its
  counts;
- ``python -m repro_torch.analysis.lint --device cpu`` exits 0 with its
  cases PASS and writes the reference's schema; with no card and no
  ``--device cpu`` it exits nonzero rather than falling back.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from lint_compare import ERRORING, assert_agrees, run_both
from repro.analysis.contracts import sync_contract as ref_sync_contract
from repro.analysis.contracts import train_contract as ref_train_contract
from repro_torch.analysis import lint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = [c.name for c in lint.default_cases() if c.mesh is None]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # the reference's whole matrix: its names and smoke flags
    return run_both(lambda c: c.mesh is None, [],
                    tmp_path_factory.mktemp("lint"))


def test_matrix_and_smoke_flags_are_the_references(runs):
    _, _, ref = runs
    cases = lint.default_cases()
    assert [c.name for c in cases] == list(ref)
    assert {c.name: c.smoke for c in cases} == {
        n: r["smoke"] for n, r in ref.items()}
    assert sum(c.smoke for c in cases) == 8
    assert set(ERRORING) == {n for n, r in ref.items()
                             if "error" in r["entry"]}


@pytest.mark.parametrize("case", CASES)
def test_port_case_passes(runs, case):
    report, facts, _ = runs
    entry = report["bundles"][case]
    assert entry["ok"], entry
    assert entry["passes"]["launch_budget"]["skipped"]
    assert facts[case]["ranks"] == 1


@pytest.mark.parametrize("case", ["sync/flat-vmap-k4-kernel@2x2x2",
                                  "serve/paged-decode@1dev"])
def test_agrees_with_the_reference(runs, case):
    assert_agrees(case, *runs)


def test_gspmd_cases_the_reference_cannot_build(runs):
    """The reference's errors, and the stand-ins' contracts against its
    formulas: the vmap train step's ``train_contract()`` (no collective
    contract; the port pins 0 launches under the smoke config's
    attention, the reference leaves the budget unchecked); the legacy
    single-device sync's ``sync_contract((), n_collectives=0)`` with the
    f32 discipline, its budget one fused launch against the reference's
    2 (the mean kernel, then the push)."""
    report, facts, ref = runs
    for name in ("train/hwa-vmap@2x2x2", "sync/legacy-kernel@1dev"):
        assert ref[name]["entry"]["error"].startswith(ERRORING[name])
        assert report["bundles"][name]["ok"]
    got = facts["train/hwa-vmap@2x2x2"]["contract"]
    want = ref_train_contract()
    assert got.collectives is None and want.collectives is None
    assert want.launch is None and got.launch.counts == {}
    assert tuple(got.dtypes.forbid) == tuple(want.dtypes.forbid)
    got = facts["sync/legacy-kernel@1dev"]["contract"]
    want = ref_sync_contract((), launches=2, n_collectives=0,
                             float_args=("f32",))
    c, w = got.collectives, want.collectives
    assert (c.axes, dict(c.ops), c.outer_axis, c.assembly_free,
            dict(c.other_ops)) == (tuple(w.axis), dict(w.ops), w.outer_axis,
                                   w.assembly_free, dict(w.other_ops))
    assert (got.dtypes.collective_dtypes, got.dtypes.float_args,
            got.dtypes.forbid) == (want.dtypes.collective_dtypes,
                                   want.dtypes.float_args,
                                   want.dtypes.forbid)
    assert (got.launch.counts, want.launch.min) == ({"wa_sync_fused": 1}, 2)


def test_cli_on_the_cpu(tmp_path):
    out = tmp_path / "r.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--device",
         "cpu", "--only", "@1dev", "--json", str(out)], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rep = json.loads(out.read_text())
    assert set(rep) == {"bundles", "n_bundles", "n_violations", "ok",
                        "schema", "smoke"}
    assert rep["ok"] and rep["n_bundles"] == 2 and rep["schema"] == 1
    assert "PASS serve/paged-decode@1dev" in proc.stdout
    listed = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis.lint", "--list"],
        env=env, capture_output=True, text=True, timeout=300)
    assert listed.stdout.count("[smoke]") == 8


def test_cli_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert lint.main(["--only", "@1dev"]) == 2
    assert "--device cpu" in capsys.readouterr().err


def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_phase18_on_cpu(monkeypatch):
    """chip_smoke.py's phase 18a at smoke size on the CPU (the launch
    budgets, which apply on the card, skipped): the four in-process
    cases pass, the stacked train step under ``flash_pallas``."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "MESH_FULL", False)
    res = smoke.phase_lint("cpu")
    bundles = res["report"]["bundles"]
    assert sorted(bundles) == sorted(CASES)
    assert all(e["ok"] for e in bundles.values())
    assert res["facts"]["train/hwa-vmap@2x2x2"]["declared_launches"] == {
        "flash_fwd": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
    assert not any(res["launches"].values())
