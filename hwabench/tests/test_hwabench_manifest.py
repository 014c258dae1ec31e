"""BENCHMARK.json against its format rules: its keys, names, units and
lengths, and every name leading to the files the harness
reads (configurations, traffic, drivers, references, readers, limits)."""
import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(manifest["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in manifest["paths"])
    assert len(manifest["command"]) <= 32
    assert all(_line(w) for w in manifest["command"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_names_files_under_paths(manifest):
    for word in manifest["command"]:
        if word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in manifest["paths"])
            assert os.path.exists(os.path.join(ROOT, word))


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_are_unique_and_well_formed(manifest, section):
    names = [e["name"] for e in manifest[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_configs(manifest):
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in manifest["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        widths = [k for k in c["reduced"] if k.endswith(("_dim", "_rank",
                                                         "_size"))
                  or k in ("num_experts_per_tok",)]
        assert widths == []
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert os.path.exists(os.path.join(
            ROOT, "hwabench", "reference", cfg["reference"] + ".py"))


def test_workloads(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    four = 0
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
        four += w["chips"] == 4
        assert _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        with open(os.path.join(ROOT, "hwabench", "traffic",
                               w["traffic"] + ".json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.exists(os.path.join(ROOT, "hwabench", "drivers",
                                           kind + ".py"))
        with open(os.path.join(ROOT, "hwabench", "limits",
                               w["name"] + ".json")) as f:
            assert json.load(f)["limits"]
    assert four <= max(1, len(manifest["workloads"]) // 4)


def test_metrics(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = {w["name"] for w in manifest["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
        assert os.path.exists(os.path.join(ROOT, "hwabench", "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        reported = [m for m in manifest["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2
        assert any(w in m.get("workloads", cells)
                   for m in manifest["per_layer"])


def test_layers_name_one_spelling(manifest):
    layers = {m["layer"] for m in manifest["per_layer"]}
    assert len({s.lower() for s in layers}) == len(layers)


@pytest.mark.parametrize("name", sorted(
    os.path.basename(p)[:-5] for p in os.listdir(
        os.path.join(ROOT, "hwabench", "configs"))))
def test_weights_have_the_programs_layout(name):
    """The benchmark's weight tree (the reference's ``param_shapes``) has
    the leaves, shapes and dtypes the program's model declares, at every
    configuration's full sizes (on the ``meta`` device: no memory)."""
    import torch
    from repro_torch.models.registry import build_model

    from hwabench import weights
    from hwabench.drivers import program_config
    from hwabench.harness import load_json
    cfg = load_json(ROOT, "hwabench", "configs", name + ".json")
    ref = __import__("hwabench.reference." + cfg["reference"],
                     fromlist=["param_shapes"])
    shapes = ref.param_shapes(cfg)
    have = [(p, tuple(spec[0]), torch.bfloat16 if spec[1] == "w"
             else torch.float32) for p, spec in weights.leaves_of(shapes)]
    want = [(p, tuple(x.shape), x.dtype) for p, x in weights.leaves_of(
        build_model(program_config(cfg)).abstract()[0])]
    assert have == want
