"""chip_smoke.py's phase 16 rehearsed on the CPU at smoke size (the smoke
granite-3-2b, 16 tokens a replica): 16a-c's runs, their layouts, probes,
contracts and the checkpoint resumed under another mesh, with the same
gates but the launch counts, which apply on the card only."""
import importlib.util
import os

import pytest

from repro_torch.launch import train as launcher
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _collective_timeout(monkeypatch):
    monkeypatch.setattr(launcher, "COLLECTIVE_TIMEOUT", 60.0)


def test_chip_smoke_phase16_on_cpu(monkeypatch):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    monkeypatch.setattr(smoke, "MESH_FULL", False)
    monkeypatch.setattr(smoke, "PAR_RUN", dict(smoke.PAR_RUN, device="cpu",
                                               seq_len=16))
    out = smoke.phase_mesh_parallel("cpu")
    assert out["dp"]["layout"]["n_groups"] == 1
    assert out["tp"]["layout"]["shards"] == [2]
    assert out["fsdp"]["layout"]["grouped"]
    assert out["fsdp"]["layout"]["n_groups"] >= 2
    for form in ("dp", "tp", "fsdp"):
        assert len(out[form]["syncs"]) == 2
