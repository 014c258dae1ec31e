"""A/B timing of the f32 fused sync's load order (``csrc/wa_update.cu``).

The fused sync loads the ring slot and the total before the K replicas.
Loaded after them, the same arithmetic ran about 3x slower on an H100;
the cause is not known. This script builds the kernel in three variants
from the source in the checkout and times them against each other in one
process:

- ``slot_first``: the source as it is;
- ``replicas_first``: the same text with the slot and total loads moved
  after ``kmean4``;
- ``replicas_first_push4``: the loop body through the shared helpers,
  ``kmean4`` then ``push4`` (which loads the slot and the total).

Each variant is first held bit for bit against the plain version
(``ref.wa_sync_fused_ref``) on a small buffer, then timed at the training
run's packed size in the order A B C C B A (CUDA events, median of
``--iters`` launches per pass). Run it on a machine with a card and
``nvcc``, from the repository root:

    PYTHONPATH=src python -m repro_torch.kernels.wa_sync_ab

It prints the card's name and power limit, ptxas's register and spill
report of each variant's kernel, one line per pass, and a JSON summary
as the last line.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import time

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import wa_sync_fused_ref
from repro_torch.kernels.wa_update import sync_scalars

#: the f32 fused sync's loop head in ``csrc/wa_update.cu``
_HEAD = ("    float m[4], old[4], t[4], a[4];\n"
         "    ld4(slot, i, old);\n"
         "    ld4(total, i, t);\n"
         "    kmean4(stacked, P, K, inv_k, i, m);\n")
_BODY_TAIL = ("#pragma unroll\n"
              "    for (int j = 0; j < 4; ++j) {\n"
              "      t[j] = __fsub_rn(__fadd_rn(t[j], m[j]), "
              "__fmul_rn(old[j], s.full));\n"
              "      a[j] = __fmul_rn(t[j], s.inv_count);\n"
              "    }\n"
              "    st4(slot, i, m);\n"
              "    st4(total, i, t);\n"
              "    st4(avg, i, a);\n")
VARIANTS = {
    "slot_first": (_HEAD, _HEAD),
    "replicas_first": (_HEAD, "    float m[4], old[4], t[4], a[4];\n"
                              "    kmean4(stacked, P, K, inv_k, i, m);\n"
                              "    ld4(slot, i, old);\n"
                              "    ld4(total, i, t);\n"),
    "replicas_first_push4": (_HEAD + _BODY_TAIL,
                             "    float m[4];\n"
                             "    kmean4(stacked, P, K, inv_k, i, m);\n"
                             "    push4(slot, total, avg, m, s, i);\n"),
}
#: packed length of the training run (granite-3-2b cut to 8 layers)
TRAIN_P = 687_915_008

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def variant_sources() -> dict[str, str]:
    """Each variant's full source; raises if the kernel text moved."""
    src = (build.CSRC / "wa_update.cu").read_text()
    out = {}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: the fused sync's loop body in "
                               f"wa_update.cu no longer reads as expected")
        out[name] = src.replace(old, new)
    return out


def build_variants() -> dict[str, tuple[ctypes.CDLL, str]]:
    """Compile every variant (one nvcc each, in parallel) into the build
    directory; returns {name: (library, ptxas lines of the sync kernel)}."""
    ab_dir = build.BUILD_DIR / "ab"
    ab_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        src = ab_dir / f"{name}.cu"
        src.write_text(text)
        lib = ab_dir / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    out = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        at = next(i for i, ln in enumerate(lines)
                  if "wa_sync_fused_kernel" in ln)
        lib = ctypes.CDLL(str(path))
        lib.wa_sync_fused_launch.argtypes = \
            [_P] * 5 + [ctypes.c_int64, _I, _F, _I, _P]
        lib.wa_sync_fused_launch.restype = ctypes.c_int
        lib.repro_error_string.argtypes = [ctypes.c_int]
        lib.repro_error_string.restype = ctypes.c_char_p
        out[name] = (lib, " | ".join(ln.strip()
                                     for ln in lines[at + 1:at + 3]))
    return out


def _launch(lib, stacked, ring, total, avg, scalars, inv_k):
    dev = stacked.device
    rc = lib.wa_sync_fused_launch(
        stacked.data_ptr(), ring.data_ptr(), total.data_ptr(),
        avg.data_ptr(), scalars.data_ptr(), stacked.shape[1],
        stacked.shape[0], inv_k,
        torch.cuda.get_device_properties(dev).multi_processor_count,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(lib, rc, "wa_sync_fused")


def _inputs(P, K, I, seed, dev):
    g = torch.Generator(device=dev).manual_seed(seed)
    stacked = torch.randn((K, P), generator=g, device=dev)
    ring = torch.randn((I, P), generator=g, device=dev)
    total = torch.randn((P,), generator=g, device=dev)
    return stacked, ring, total


def check_bits(libs, K=2, I=3, P=3 * 8192, seed=0) -> dict[str, bool]:
    """Every variant against the plain version, bit for bit, on a full
    ring (evicting row 1)."""
    dev = torch.device("cuda")
    stacked, ring, total = _inputs(P, K, I, seed, dev)
    idx = torch.tensor(1, dtype=torch.int32, device=dev)
    full = torch.tensor(1.0, device=dev)
    inv_count = torch.tensor(1.0 / I, device=dev)
    want = wa_sync_fused_ref(stacked.cpu(), ring.cpu(), total.cpu(),
                             idx.cpu(), full.cpu(), inv_count.cpu())
    inv_k = float(torch.tensor(1.0 / K, dtype=torch.float32))
    out = {}
    for name, (lib, _) in libs.items():
        r, t, a = ring.clone(), total.clone(), torch.empty_like(total)
        _launch(lib, stacked, r, t, a, sync_scalars(idx, full, inv_count),
                inv_k)
        out[name] = all(torch.equal(x.cpu().view(torch.int32),
                                    y.view(torch.int32))
                        for x, y in zip((r, t, a), want))
    return out


def time_variants(libs, P=TRAIN_P, K=2, I=3, iters=10, seed=0):
    """Median ms per launch of each variant, in the order A B C C B A."""
    dev = torch.device("cuda")
    stacked, ring, total = _inputs(P, K, I, seed, dev)
    avg = torch.empty_like(total)
    scalars = sync_scalars(torch.tensor(1, dtype=torch.int32, device=dev),
                           torch.tensor(1.0, device=dev),
                           torch.tensor(1.0 / I, device=dev))
    inv_k = float(torch.tensor(1.0 / K, dtype=torch.float32))
    order = list(libs) + list(reversed(libs))
    passes = []
    for name in order:
        lib = libs[name][0]
        for _ in range(3):
            _launch(lib, stacked, ring, total, avg, scalars, inv_k)
        times = []
        for _ in range(iters):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            _launch(lib, stacked, ring, total, avg, scalars, inv_k)
            t1.record()
            t1.synchronize()
            times.append(t0.elapsed_time(t1))
        passes.append((name, statistics.median(times)))
    return passes


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--P", type=int, default=TRAIN_P)
    ap.add_argument("--K", type=int, default=2)
    ap.add_argument("--I", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
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
    bits = check_bits(libs, K=args.K, I=args.I)
    print(f"bit-equal to the plain version: {bits}")
    passes = time_variants(libs, P=args.P, K=args.K, I=args.I,
                           iters=args.iters)
    bound = (args.K + 5) * 4 * args.P / 3.35e12 * 1e3
    for name, ms in passes:
        print(f"{name}: {ms:.4f} ms ({bound / ms:.0%} of the {bound:.3f} "
              f"ms bound)")
    by_name: dict[str, list[float]] = {}
    for name, ms in passes:
        by_name.setdefault(name, []).append(ms)
    print(json.dumps({"card": card, "P": args.P, "K": args.K, "I": args.I,
                      "bound_ms": bound, "bit_equal": bits, "ms": by_name}))
    return 0 if all(bits.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
