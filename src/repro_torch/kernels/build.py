"""Builds the port's CUDA sources and loads them with ``ctypes``.

Every ``*.cu`` under ``src/repro_torch/csrc/`` is compiled by its own
``nvcc`` process (all started together) into a shared library with a
plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o <build>/<name>-<hash>.so <name>.cu

The build directory is ``src/repro_torch/_build/`` (listed in
``.gitignore``); a library is named by the hash of its source, of the
local headers it includes (``#include "x.cuh"``, followed recursively)
and of the flags, so a changed source or header is never served from a
stale build. Nothing is
built at import: :func:`library` builds at first use, once per process.
PyTorch's extension builder is not used — it includes PyTorch's headers
and takes minutes per file where this takes seconds.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-shared", "-Xcompiler",
                           "-fPIC", "-Xptxas", "-v", "-lineinfo"]

_LIBS: dict[str, ctypes.CDLL] = {}
#: per source: {"seconds": build wall time or 0.0 if reused, "ptxas": log}
BUILD_INFO: dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME); "
                       "the port's CUDA kernels build only where the CUDA "
                       "toolkit is installed")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def sources_of(src: Path) -> list[Path]:
    """``src`` and the local headers it includes, recursively, each once,
    in the order first reached."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            dep = (path.parent / name.decode()).resolve()
            if dep.exists():
                todo.append(dep)
    return seen


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256()
    for path in sources_of(src):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(force: bool = False) -> dict[str, dict]:
    """Compile every source whose library is missing (all of them when
    ``force``), one ``nvcc`` per source, in parallel. Raises with nvcc's
    output if any build fails. Returns :data:`BUILD_INFO`."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    procs = {}
    t0 = time.perf_counter()
    for src in sources:
        out = _lib_path(src)
        if out.exists() and not force:
            BUILD_INFO.setdefault(src.stem, {"seconds": 0.0, "ptxas": ""})
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    failures = []
    for src, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {src.name} (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[src.stem] = {"seconds": time.perf_counter() - t0,
                                "ptxas": log}
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu``."""
    if name not in _LIBS:
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(src)
        path = _lib_path(src)
        if not path.exists():
            build_all()
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return _LIBS[name]


def check_launch(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a nonzero ``cudaGetLastError()``."""
    if rc != 0:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
