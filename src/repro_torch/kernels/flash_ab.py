"""A/B timing of the Hopper flash kernels' ring depth and head split.

The bf16 flash forward (``csrc/flash_fwd.cu``) streams K/V tiles through
a ring of ``STAGES`` shared-memory stages, the dk/dv sweep
(``csrc/flash_bwd.cu``) its Q/dO/lse/delta tiles. A deeper ring keeps
more tiles in flight; a shallower one leaves room for more CTAs on an SM.
This script builds each kernel as it is and with the other depth, from
the sources in the checkout, and times them against each other in one
process:

- flash forward: ``fwd_as_is`` (2 stages at head_dim 64) and
  ``fwd_stages_3``;
- dk/dv: ``dkv_as_is`` (3 stages, a cluster of min(G, 8) CTAs per key
  tile, one query head each), ``dkv_stages_2``, and
  ``dkv_one_cta_per_group`` (clusters of 1: one CTA walks the G heads of
  its group in series, as the mma.sync design before it did).

Each variant is first held against the plain version (``kernels.ref``)
within the bf16 flash tolerance (3e-2), then timed at the main paths'
shapes (forward B1 and B4, dk/dv B4; S 512, Hq 32, Hkv 8, D 64) in the
order A B B A: CUDA-graph replay of ``--iters`` launches between CUDA
events, over input sets large enough together to defeat the L2, as
``chip_smoke.py`` times. Run it on a machine with a card and ``nvcc``,
from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.flash_ab

It prints the card's name and power limit, ptxas's report of each
variant's bf16 kernels, one line per pass, and a JSON summary as the
last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import _ARGTYPES as FWD_ARGTYPES
from repro_torch.kernels.flash_attention_bwd import \
    _DKV_ARGTYPES as DKV_ARGTYPES
from repro_torch.kernels.ref import (flash_attention_bwd_ref,
                                     flash_attention_fwd_ref)

#: name: (source stem, text as it is, text of the variant)
VARIANTS = {
    "fwd_as_is": ("flash_fwd", None, None),
    "fwd_stages_3": ("flash_fwd",
                     "  static constexpr int STAGES = D == 128 ? 3 : 2;\n",
                     "  static constexpr int STAGES = 3;\n"),
    "dkv_as_is": ("flash_bwd", None, None),
    # head_dim 192 keeps 3: its two partial sums need the 3-stage ring
    "dkv_stages_2": ("flash_bwd", "  static constexpr int STAGES = 3;\n",
                     "  static constexpr int STAGES = D == 192 ? 3 : 2;\n"),
    "dkv_one_cta_per_group": ("flash_bwd",
                              "  const int C = min(Hq / Hkv, 8);",
                              "  const int C = 1;"),
}
SHAPE = dict(S=512, Hq=32, Hkv=8, D=64)
TOL = 3e-2


def build_variants() -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile every variant (one nvcc each, in parallel) into the build
    directory; returns {name: (library, ptxas lines of its bf16 kernel)}."""
    ab_dir = build.BUILD_DIR / "flash_ab"
    ab_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (stem, old, new) in VARIANTS.items():
        text = (build.CSRC / f"{stem}.cu").read_text()
        if old is not None:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {stem}.cu no longer reads as "
                                   f"expected")
            text = text.replace(old, new)
        src = ab_dir / f"{name}.cu"
        src.write_text(text)
        lib = ab_dir / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
             "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        kernel = "flash_fwd_bf16_kernelILi64" if name.startswith("fwd") \
            else "flash_dkv_bf16_kernelILi64"
        lines = log.splitlines()
        at = next(i for i, ln in enumerate(lines)
                  if "Compiling entry function" in ln and kernel in ln)
        report = [next(ln.strip() for ln in lines[at:] if word in ln)
                  for word in ("registers", "spill")]
        lib = ctypes.CDLL(str(path))
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        fn = lib.flash_fwd_launch if name.startswith("fwd") \
            else lib.flash_bwd_dkv_launch
        fn.argtypes = FWD_ARGTYPES if name.startswith("fwd") else DKV_ARGTYPES
        fn.restype = ctypes.c_int
        out[name] = (lib, " | ".join(report))
    return out


def _inputs(B, n_sets, seed):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    S, Hq, Hkv, D = SHAPE["S"], SHAPE["Hq"], SHAPE["Hkv"], SHAPE["D"]

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    sets = []
    for _ in range(n_sets):
        q, k, v, dout = rnd(B, S, Hq, D), rnd(B, S, Hkv, D), \
            rnd(B, S, Hkv, D), rnd(B, S, Hq, D)
        out, lse = flash_attention_fwd_ref(q, k, v)
        out, lse = out.bfloat16(), lse.contiguous()
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        sets.append((q, k, v, out, lse, dout, delta))
    return sets


def _call(name, lib, q, k, v, out, lse, dout, delta):
    """One launch of the variant's kernel; returns its outputs."""
    B, S, Hq, D = q.shape
    tail = (B, S, S, Hq, k.shape[2], D, 0, 0.0, D ** -0.5, 1,
            torch.cuda.current_stream().cuda_stream)
    if name.startswith("fwd"):
        o, lse_o = torch.empty_like(q), torch.empty_like(lse)
        rc = lib.flash_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  o.data_ptr(), lse_o.data_ptr(), *tail)
        res = (o, lse_o)
    else:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rc = lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *tail)
        res = (dk, dv)
    build.check_launch(lib, rc, name)
    return res


def check(libs) -> dict[str, float]:
    """Each variant against the plain version at B4: its largest error
    beyond the tolerance |got - want| <= TOL + TOL |want| (0 = within)."""
    q, k, v, out, lse, dout, delta = _inputs(4, 1, seed=1)[0]
    want_fwd = flash_attention_fwd_ref(q, k, v)
    want_dkv = flash_attention_bwd_ref(q, k, v, out, lse, dout)[1:]
    res = {}
    for name, (lib, _) in libs.items():
        got = _call(name, lib, q, k, v, out, lse, dout, delta)
        want = want_fwd if name.startswith("fwd") else want_dkv
        res[name] = max(float(((g.float() - w.float()).abs()
                               - TOL * (1 + w.float().abs())).clamp(min=0)
                              .max()) for g, w in zip(got, want))
    return res


def _graph_ms(fn, sets, iters):
    """Device ms per call: ``iters`` calls captured in one CUDA graph,
    replayed between two CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in sets[:3]:
            fn(*x)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def time_variants(libs, iters):
    """[(kernel shape, variant, ms)] in the order A B B A per shape."""
    passes = []
    for kind, B in (("fwd", 1), ("fwd", 4), ("dkv", 4)):
        sets = _inputs(B, 24 if B == 1 else 8, seed=7)
        names = [n for n in libs if n.startswith(kind)]
        for name in names + names[::-1]:
            lib = libs[name][0]
            ms = _graph_ms(lambda *x, n=name, l=lib: _call(n, l, *x), sets,
                           iters)
            passes.append((f"{kind} B{B}", name, ms))
        del sets
    return passes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the A/B runs only on a card")
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card)
    t0 = time.perf_counter()
    libs = build_variants()
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s")
    for name, (_, ptxas) in libs.items():
        print(f"ptxas {name}: {ptxas}")
    errs = check(libs)
    print(f"error beyond tolerance against the plain version: {errs}")
    passes = time_variants(libs, args.iters)
    summary: dict[str, dict[str, list[float]]] = {}
    for shape, name, ms in passes:
        print(f"{shape} {name}: {ms:.5f} ms")
        summary.setdefault(shape, {}).setdefault(name, []).append(ms)
    print(json.dumps({"card": card, "shape": SHAPE, "beyond_tol": errs,
                      "ms": summary}))
    return 0 if not any(errs.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
