"""The port stands alone: nothing under src/repro_torch/ (nor
chip_smoke.py) imports JAX, the JAX package or ``ml_dtypes`` (the card's
machine has none: bf16 and fp8 checkpoints travel as integer views),
importing the serving engine, the trainer, the checkpoint IO, the
publisher, the fault check and the ResNet launcher leaves them unloaded, and an entry point asked for the card where
there is none raises instead of running on the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.registry import build_model
from repro_torch.serve.engine import PagedDecodeEngine
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return files


def _imported_roots(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 15
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert bad == []


def test_engine_import_leaves_jax_unloaded():
    code = ("import sys, repro_torch.serve.engine, repro_torch.launch.serve, "
            "repro_torch.train.trainer, repro_torch.checkpoint.io, "
            "repro_torch.serve.publish, repro_torch.resilience, "
            "repro_torch.resilience.check, repro_torch.launch.train, "
            "repro_torch.launch.resnet_cifar; "
            "print(sorted(m for m in sys.modules "
            f"if m.split('.')[0] in {FORBIDDEN!r}))")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_engine_without_device_needs_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = get_smoke_config("granite-3-2b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PagedDecodeEngine(lm=build_model(cfg), params=None, max_batch=1,
                          max_seq_len=8, max_new=2)
