"""Nothing the benchmark runs loads JAX or the JAX package (top-level
module names compared whole: ``repro_torch`` is the port, ``repro`` is
not), and the yardstick, the references and the readers import nothing
of the program."""
import ast
import glob
import os
import subprocess
import sys
import types

import pytest

from hwabench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "hwabench")


def _imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            "import hwabench.harness, hwabench.drivers.train, "
            "hwabench.reference.granite, hwabench.reference.hwa, "
            "hwabench.calibrate, hwabench.rehearse\n"
            "import repro_torch.core.hwa, repro_torch.train.trainer, "
            "repro_torch.models.registry, repro_torch.optim\n"
            "b = hwabench.harness.Bench(sys.argv[1])\n"
            "[b.reader(m['name']) for m in b.manifest['per_layer']]\n"
            "print(hwabench.harness.forbidden_modules())\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.path.join(ROOT, "src")]))
    out = subprocess.run([sys.executable, "-c", code, ROOT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(BENCH, "reference", "*.py"))
    + glob.glob(os.path.join(BENCH, "metrics", "*.py"))
    + [os.path.join(BENCH, f) for f in ("yardstick.py", "check.py",
                                        "weights.py", "devtrace.py")]),
    ids=os.path.basename)
def test_yardstick_and_references_import_nothing_of_the_program(path):
    tops = {name.split(".")[0] for name in _imported(path)}
    assert not tops & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch.fake_leaf",
                        types.ModuleType("repro_torch.fake_leaf"))
    monkeypatch.setitem(sys.modules, "reproduce",
                        types.ModuleType("reproduce"))
    assert not [m for m in harness.forbidden_modules()
                if m in ("repro_torch.fake_leaf", "reproduce")]
    monkeypatch.setitem(sys.modules, "repro.fake_leaf",
                        types.ModuleType("repro.fake_leaf"))
    assert "repro.fake_leaf" in harness.forbidden_modules()
