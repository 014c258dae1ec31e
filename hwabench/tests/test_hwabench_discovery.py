"""A cell, a traffic mix, a configuration and a per-layer metric added as
files to a copy of the benchmark are found by the harness, and no file
that was there before changes."""
import hashlib
import json
import os
import shutil

from hwabench.rehearse import SmokeBench, rehearse

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _hashes(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        if "__pycache__" in dirpath:
            continue
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = hashlib.sha256(
                open(p, "rb").read()).hexdigest()
    return out


def test_new_files_are_found_without_an_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "hwabench"), root / "hwabench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    before = _hashes(root)
    bench = root / "hwabench"
    cfg = json.loads((bench / "configs" / "granite-3-2b-l18.json")
                     .read_text())
    cfg.update(name="granite-3-2b-l4", num_hidden_layers=4)
    (bench / "configs" / "granite-3-2b-l4.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "hwa-k2-h2-b4x2048.json")
                     .read_text())
    mix.update(K=3, H=3)
    (bench / "traffic" / "hwa-k3-h3.json").write_text(json.dumps(mix))
    (bench / "limits" / "train.granite-3-2b-l4.k3.json").write_text(
        json.dumps({"limits": {"loss_gap": 1.0}}))
    (bench / "metrics" / "replicas.train.py").write_text(
        "def read(ctx):\n    return float(ctx['traffic']['K'])\n")
    # BENCHMARK.json gains entries only
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({
        "name": "granite-3-2b-l4", "source": cfg["source"],
        "file": "hwabench/configs/granite-3-2b-l4.json",
        "reduced": ["num_hidden_layers"], "why": "a test's cell"})
    manifest["workloads"].append({
        "name": "train.granite-3-2b-l4.k3", "config": "granite-3-2b-l4",
        "traffic": "hwa-k3-h3", "chips": 1, "why": "a test's cell"})
    manifest["end_to_end"][0]["workloads"].append("train.granite-3-2b-l4.k3")
    manifest["per_layer"].append({
        "name": "replicas.train", "unit": "count", "better": "higher",
        "source": "program_counter", "layer": "HWA inner step",
        "moves": "train_tokens_per_s",
        "workloads": ["train.granite-3-2b-l4.k3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    bench_obj = SmokeBench(str(root))
    assert bench_obj.config("granite-3-2b-l4")["name"] == "granite-3-2b-l4"
    res = rehearse("train.granite-3-2b-l4.k3", root=str(root), trace=True)
    assert res["metrics"]["replicas.train"]["value"] == 3.0
    assert res["attempted"] % 3 == 0 and res["correct"], res["checks"]
    after = _hashes(root)
    changed = [p for p, h in before.items()
               if after.get(p) != h and p != "BENCHMARK.json"]
    assert changed == []
