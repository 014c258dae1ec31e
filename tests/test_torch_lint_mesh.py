"""The port's contract checker over the (replica 2, data 2, model 2) mesh
cases of the matrix (``repro_torch.analysis.lint``), on the CPU in one
spawn of 8 ``gloo`` ranks, held to the reference's lint of the same cases
(``tests/lint_compare.py``): every case passes; where the reference
builds the case, the two agree on each pass's verdict, the collective
census a level, the payload dtypes and the launch counts; the case the
reference cannot build on this jax (``train/mesh-native``) is named with
its error and held to the reference's ``train_contract`` formula."""
import pytest

from lint_compare import ERRORING, assert_agrees, run_both
from repro.analysis.contracts import train_contract as ref_train_contract
from repro_torch.analysis import lint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = [c.name for c in lint.default_cases() if c.mesh == lint.MESH_222]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(lambda c: c.mesh == lint.MESH_222, CASES,
                    tmp_path_factory.mktemp("lint"))


def test_the_mesh_cases_are_the_references():
    assert CASES == [
        "train/mesh-native@2x2x2", "train/mesh-native-flash-pallas@2x2x2",
        "sync/flat-resident@2x2x2", "sync/flat-resident-kernel@2x2x2",
        "sync/fsdp-grouped-kernel@2x2x2",
        "sync/flat-resident-bf16-ring@2x2x2",
        "sync/flat-resident-resilient@2x2x2",
        "sync/fsdp-grouped-resilient@2x2x2"]


@pytest.mark.parametrize("case", CASES)
def test_port_case_passes(runs, case):
    report, facts, _ = runs
    entry = report["bundles"][case]
    assert entry["ok"], entry
    assert list(entry["passes"]) == ["collectives", "launch_budget",
                                     "donation", "dtype", "manual_hazard"]
    # no kernel launches on the CPU; the budget is the card's
    assert entry["passes"]["launch_budget"]["skipped"]
    assert facts[case]["ranks"] == 8


@pytest.mark.parametrize("case", [c for c in CASES if c not in ERRORING])
def test_agrees_with_the_reference(runs, case):
    assert_agrees(case, *runs)


def test_train_step_the_reference_cannot_build(runs):
    """``train/mesh-native@2x2x2``: the reference's error on this jax, and
    the port's contract against the reference's formula: collective-free
    over ``replica``; the port also pins the data and model traffic it
    records (the reference leaves it to GSPMD) and 0 launches (no flash
    kernel under the smoke config's attention)."""
    name = "train/mesh-native@2x2x2"
    report, facts, ref = runs
    assert ref[name]["entry"]["error"].startswith(ERRORING[name])
    want = ref_train_contract(replica_axes=("replica",)).collectives
    got = facts[name]["contract"].collectives
    assert (got.axes, dict(got.ops)) == (tuple(want.axis), dict(want.ops))
    assert want.assembly_free is False and got.assembly_free is True
    census = facts[name]["census"]["collectives"]
    assert {k: dict(v) for k, v in got.other_ops.items()} == census
    assert set(census) == {"data", "model"}
    assert facts[name]["declared_launches"] == {}
    assert report["bundles"][name]["ok"]
