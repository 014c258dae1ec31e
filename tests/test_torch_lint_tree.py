"""The port's contract checker over the two-level tree's cases of the
matrix (``repro_torch.analysis.lint``: the pod-carved (pod 2, replica 2,
model 2) mesh), on the CPU in one spawn of 8 ``gloo`` ranks, held to the
reference's lint of the same cases (``tests/lint_compare.py``): every
case passes, and the two agree on each pass's verdict, the collective
census a level (the inner level's all-reduce, the outer level's
all-reduce or compressed all-gathers, the resilient health stats over
``model``), the payload dtypes (the bf16 payload's wire view aside:
``u8`` here, ``u16`` there) and the launch counts."""
import pytest

from lint_compare import assert_agrees, run_both
from repro_torch.analysis import lint
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CASES = [c.name for c in lint.default_cases() if c.mesh == lint.MESH_TREE]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(lambda c: c.mesh == lint.MESH_TREE, ["@tree"],
                    tmp_path_factory.mktemp("lint"))


def test_the_tree_cases_are_the_references():
    assert CASES == [
        "sync/two-level-outer-kernel@tree",
        "sync/two-level-outer-bf16-comms@tree",
        "sync/two-level-outer-fp8@tree",
        "sync/two-level-outer-resilient@tree", "sync/two-level-inner@tree"]


@pytest.mark.parametrize("case", CASES)
def test_port_case_passes(runs, case):
    report, facts, _ = runs
    entry = report["bundles"][case]
    assert entry["ok"], entry
    assert entry["passes"]["launch_budget"]["skipped"]
    assert facts[case]["ranks"] == 8


@pytest.mark.parametrize("case", CASES)
def test_agrees_with_the_reference(runs, case):
    assert_agrees(case, *runs)


def test_compressed_outer_levels_cross_as_bytes(runs):
    """The cross-pod payload of the compressed trees: one all-gather of
    the bf16 mean's bytes; the fp8 payload's bytes and its f32 scales."""
    _, facts, _ = runs
    bf16 = facts["sync/two-level-outer-bf16-comms@tree"]["census"]
    fp8 = facts["sync/two-level-outer-fp8@tree"]["census"]
    assert bf16["collectives"]["pod"] == {"all_gather": 1}
    assert bf16["payloads"]["pod"] == ["u8"]
    assert fp8["collectives"]["pod"] == {"all_gather": 2}
    assert fp8["payloads"]["pod"] == ["f32", "u8"]
