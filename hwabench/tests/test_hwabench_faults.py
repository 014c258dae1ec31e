"""The comparison that decides ``correct`` fails what it must, on the
CPU at the smoke sizes with the smoke limits: the harness's look for a
card skipped, the rest of a run driven with the timed path broken
underneath (a step that returns its state unchanged; half of each
replica's rows left out, the mean over the rest), and the control, the
reference in float8 put in the program's place. A clean run of every
cell passes."""
import pytest
import torch

from hwabench.harness import Bench, build_cell
from hwabench.rehearse import ROOT, SmokeBench, rehearse, smoke_limits

TRAIN = [w["name"] for w in Bench(ROOT).manifest["workloads"]]


def _stale_step(cfg, state, batches, loss_fn, optimizer, lr):
    """The fault: the replicas' losses are computed, nothing moves."""
    from repro_torch.core.hwa import _replica
    with torch.no_grad():
        losses = torch.stack([loss_fn(
            _replica(state.inner, k), _replica(batches, k))[0]
            for k in range(cfg.n_replicas)])
    return state, {"loss": losses.mean(), "per_replica_loss": losses}


def _half_batch_step(cfg, state, batches, loss_fn, optimizer, lr):
    """The fault: each replica steps on the first half of its rows."""
    from repro_torch.core.hwa import hwa_inner_step
    half = batches[0].shape[1] // 2
    return hwa_inner_step(cfg, state, tuple(b[:, :half] for b in batches),
                          loss_fn, optimizer, lr)


@pytest.mark.parametrize("workload", TRAIN)
def test_clean_run_is_correct(workload):
    res = rehearse(workload)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("workload", TRAIN)
@pytest.mark.parametrize("fault", [_stale_step, _half_batch_step],
                         ids=["state_unchanged", "half_batch"])
def test_training_fault_is_not_correct(workload, fault):
    res = rehearse(workload, step_fn=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", TRAIN)
def test_control_is_not_correct(workload):
    """The reference in float8 in the program's place fails one of the
    cell's numbers at the smoke limits."""
    bench = SmokeBench(ROOT)
    driver, cell = build_cell(bench, workload, 7, "cpu")
    cell.setup(lambda what: None)
    cell.free()
    ref = cell.reference_readings()
    nums = driver.numbers(cell.reference_readings(quant=True), ref)
    limits = smoke_limits(bench, workload)
    assert any(v > limits[k] for k, v in nums.items()), nums
