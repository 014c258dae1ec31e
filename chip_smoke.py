#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives only ``repro_torch`` (no JAX). Phases, each printing its lines and
raising on any failure:

1. device    — the card's name and power limit from nvidia-smi; TF32 off.
2. build     — nvcc builds every CUDA source for sm_90a; ptxas registers,
               shared memory and spills per kernel.
3. kernels   — each CUDA kernel against its plain PyTorch version on the
               card, at the serving shapes and edge cases, with the JAX
               reference tests' tolerances.
4. serve     — granite-3-2b at full width and depth (bf16, random weights
               from a seed) serves 12 requests through PagedDecodeEngine
               with 8 slots; the kernels' launch counts must equal
               40 x admissions (flash) and 40 x decode steps (paged).
   trace     — torch.profiler over 8 admissions and over 8 full decode
               steps: device busy and idle share, top kernels by time.
5. reference — the same model cut to 2 layers: logits of the kernel path
               against the plain path on one prefill and one decode step.
6. yardstick — each kernel timed at the serving shapes (CUDA-graph replay
               between CUDA events: device time, cold L2), beside its plain
               version, a library call where one exists, and the bound
               from its bytes and FLOPs.

The second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels.ref import (flash_attention_fwd_ref,  # noqa: E402
                                     paged_attention_ref)
from repro_torch.models.cache import TRASH_PAGE  # noqa: E402
from repro_torch.models.registry import (build_model,  # noqa: E402
                                         lm_paged_decode_step,
                                         lm_paged_prefill_chunk)
from repro_torch.serve.engine import PagedDecodeEngine  # noqa: E402
from repro_torch.serve.scheduler import ContinuousScheduler, Request  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

FLASH_SRC = "src/repro_torch/csrc/flash_fwd.cu"
PAGED_SRC = "src/repro_torch/csrc/paged_attention.cu"
FLASH_TPU = "src/repro/kernels/flash_attention.py:68"
PAGED_TPU = "src/repro/kernels/paged_attention.py:71"

# tolerances of the JAX reference's own tests: flash 3e-2 bf16 / 2e-5 f32
# (tests/test_attention_ops.py:89-92), paged 2e-2 bf16 / 2e-5 f32
# (tests/test_paged_attention.py:87); |got - want| <= tol + tol * |want|
FLASH_TOL = {torch.bfloat16: 3e-2, torch.float32: 2e-5}
PAGED_TOL = {torch.bfloat16: 2e-2, torch.float32: 2e-5}

CARD = {"line": "not measured"}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _close(got, want, tol):
    """(max abs error, allclose at rtol = atol = tol)."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= tol + tol * want.abs()).all())
    return float(err.max()) if err.numel() else 0.0, ok


# ------------------------------------------------------------ 1. device


def phase_device(device):
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    CARD["line"] = proc.stdout.strip().splitlines()[0]
    print(CARD["line"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | allow_tf32: matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}")


# ------------------------------------------------------------- 2. build


def phase_build(device):
    t0 = time.perf_counter()
    info = build.build_all(force=True)
    total = time.perf_counter() - t0
    print(f"[build] nvcc {' '.join(build.ARCH_FLAGS)}: {len(info)} sources "
          f"in {total:.1f}s (parallel)")
    for name, rec in sorted(info.items()):
        print(f"[build] {name}.cu built in {rec['seconds']:.1f}s")
        for line in rec["ptxas"].splitlines():
            line = line.strip()
            if "registers" in line or "spill" in line or "entry" in line:
                print(f"[build]   {name}: {line}")
    return total


# ----------------------------------------------------------- 3. kernels


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def _flash_case(device, *, B, S, T, Hq, Hkv, D, dtype, window=None, cap=0.0,
                seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    q = _randn(gen, (B, S, Hq, D), dtype, device)
    k = _randn(gen, (B, T, Hkv, D), dtype, device)
    v = _randn(gen, (B, T, Hkv, D), dtype, device)
    out, lse = fa.flash_attention_fwd(q, k, v, window=window,
                                      logit_softcap=cap)
    want_o, want_lse = flash_attention_fwd_ref(q, k, v, window=window,
                                               logit_softcap=cap)
    _sync(device)
    tol = FLASH_TOL[dtype]
    err_o, ok_o = _close(out, want_o, tol)
    err_l, ok_l = _close(lse, want_lse, tol)
    return {"shape": f"B{B} S{S} T{T} Hq{Hq} Hkv{Hkv} D{D} "
                     f"{str(dtype)[6:]} w{window} cap{cap}",
            "max_abs_err": max(err_o, err_l), "tol": tol,
            "pass": ok_o and ok_l}


def ring_fill(kfull, vfull, lens, ps, TW):
    """The engine's write path on the host side: a page is taken the first
    time a ring slot is touched and reused in place once the ring wraps;
    every token's K/V is written (the last write to a page slot wins).
    kfull/vfull: (B, Smax, Hkv, D) on the device. Returns (k_pages,
    v_pages, tables int32) on the same device."""
    B = kfull.shape[0]
    tables = np.full((B, TW), TRASH_PAGE, np.int32)
    last = {}
    nxt = 1
    for b in range(B):
        for pos in range(int(lens[b])):
            j = (pos // ps) % TW
            if tables[b, j] == TRASH_PAGE:
                tables[b, j] = nxt
                nxt += 1
            last[(int(tables[b, j]), pos % ps)] = (b, pos)
    dev = kfull.device
    shape = (1 + B * TW, ps) + tuple(kfull.shape[2:])
    k_pages = torch.zeros(shape, dtype=kfull.dtype, device=dev)
    v_pages = torch.zeros_like(k_pages)
    if last:
        dst = torch.tensor(list(last.keys()), device=dev).T
        src = torch.tensor(list(last.values()), device=dev).T
        k_pages[dst[0], dst[1]] = kfull[src[0], src[1]]
        v_pages[dst[0], dst[1]] = vfull[src[0], src[1]]
    return k_pages, v_pages, torch.as_tensor(tables, device=dev)


def _paged_inputs(device, *, lens, Hq, Hkv, D, ps, TW, dtype, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    B, Smax = len(lens), max(max(lens), 1)
    q = _randn(gen, (B, Hq, D), dtype, device)
    kfull = _randn(gen, (B, Smax, Hkv, D), dtype, device)
    vfull = _randn(gen, (B, Smax, Hkv, D), dtype, device)
    k_pages, v_pages, tables = ring_fill(kfull, vfull, lens, ps, TW)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, k_pages, v_pages, tables, lens_t


def _paged_case(device, *, lens, Hq, Hkv, D, ps, TW, dtype, window=None,
                cap=0.0, seed=0):
    q, kp, vp, tables, lens_t = _paged_inputs(
        device, lens=lens, Hq=Hq, Hkv=Hkv, D=D, ps=ps, TW=TW, dtype=dtype,
        seed=seed)
    got = pa.paged_attention_cuda(q, kp, vp, tables, lens_t, window=window,
                                  logit_softcap=cap)
    want = paged_attention_ref(q, kp, vp, tables, lens_t, window=window,
                               logit_softcap=cap)
    _sync(device)
    tol = PAGED_TOL[dtype]
    err, ok = _close(got, want, tol)
    zero_rows = [i for i, n in enumerate(lens) if n == 0]
    ok = ok and all(bool((got[i] == 0).all()) for i in zero_rows)
    return {"shape": f"B{len(lens)} Hq{Hq} Hkv{Hkv} D{D} ps{ps} TW{TW} "
                     f"{str(dtype)[6:]} w{window} cap{cap} lens{list(lens)}",
            "max_abs_err": err, "tol": tol, "pass": ok}


def phase_kernels(device):
    flash = [
        # granite-3-2b prefill chunk
        _flash_case(device, B=1, S=512, T=512, Hq=32, Hkv=8, D=64,
                    dtype=torch.bfloat16),
        # ragged S (not a tile multiple), f32
        _flash_case(device, B=2, S=300, T=300, Hq=8, Hkv=2, D=64,
                    dtype=torch.float32, seed=1),
        # head_dim 128, sliding window, softcap
        _flash_case(device, B=2, S=256, T=256, Hq=8, Hkv=4, D=128,
                    dtype=torch.bfloat16, window=64, cap=50.0, seed=2),
        # queries past the key horizon of a window: fully-masked rows
        _flash_case(device, B=1, S=192, T=64, Hq=4, Hkv=2, D=64,
                    dtype=torch.float32, window=16, seed=3),
    ]
    paged = [
        # granite-3-2b decode: ragged lens incl. 0, 1 and a page crossing
        _paged_case(device, lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=32,
                    Hkv=8, D=64, ps=16, TW=35, dtype=torch.bfloat16),
        # window 16 with lens far beyond it: the ring wraps, f32, softcap
        _paged_case(device, lens=[50, 33, 17, 200], Hq=8, Hkv=2, D=128,
                    ps=4, TW=5, dtype=torch.float32, window=16, cap=30.0,
                    seed=1),
    ]
    result = {"flash_fwd": flash, "paged_attention": paged}
    summary = {name: {"cases": len(cases),
                      "max_abs_err": max(c["max_abs_err"] for c in cases),
                      "pass": all(c["pass"] for c in cases),
                      "detail": cases}
               for name, cases in result.items()}
    print("[kernels] " + json.dumps(summary))
    bad = [n for n, s in summary.items() if not s["pass"]]
    if bad:
        raise AssertionError(f"kernel vs plain mismatch: {bad}")
    return result


# ------------------------------------------------------------- 4. serve


class _Clock:
    """Per-call device time: CUDA events on the card (no host sync inside
    the run), the host clock on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.spans = []

    def wrap(self, fn):
        def timed(*a, **kw):
            if self.cuda:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                out = fn(*a, **kw)
                t1.record()
                self.spans.append((t0, t1))
            else:
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                self.spans.append((t0, time.perf_counter()))
            return out
        return timed

    def ms(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) for a, b in self.spans]
        return [(b - a) * 1e3 for a, b in self.spans]


def phase_serve(device, cfg=None, *, n_requests=12, max_batch=8,
                page_size=16, prefill_chunk=512, max_new=32, max_seq_len=560,
                prompt_range=(64, 512), seed=0):
    """Serve ``n_requests`` random prompts through PagedDecodeEngine and
    ContinuousScheduler. On the card the kernels' launch counts must equal
    n_layers x admissions (flash) and n_layers x decode steps (paged)."""
    dev = torch.device(device)
    cfg = cfg or get_config("granite-3-2b").with_(attn_impl="flash_pallas")
    lm = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = lm.init(gen, device=dev)
    eng = PagedDecodeEngine(lm=lm, params=params, max_batch=max_batch,
                            max_seq_len=max_seq_len, max_new=max_new,
                            page_size=page_size, prefill_chunk=prefill_chunk,
                            device=dev)
    rs = np.random.RandomState(0)
    lens = rs.randint(prompt_range[0], prompt_range[1] + 1, size=n_requests)
    reqs = [Request(rid=i, tokens=rs.randint(0, cfg.vocab_size, size=int(n))
                    .astype(np.int32), n_new=max_new)
            for i, n in enumerate(lens)]

    pre_clock, step_clock = _Clock(dev), _Clock(dev)
    log = {"admit_at_step": [], "decode_tokens": 0, "first_decode_lens": None}
    finite = torch.ones((), dtype=torch.bool, device=dev)
    prefill_into, step = eng.prefill_into, eng.step
    timed_prefill, timed_step = pre_clock.wrap(prefill_into), \
        step_clock.wrap(step)

    def counted_prefill(slot, batch1, n_valid):
        nonlocal finite
        log["admit_at_step"].append(len(step_clock.spans))
        timed_prefill(slot, batch1, n_valid)
        finite = finite & torch.isfinite(eng.state["logits"]).all()

    def counted_step(ctrl):
        nonlocal finite
        emitting = ctrl["out_idx"] != eng.scratch_idx
        log["decode_tokens"] += int(emitting.sum())
        if log["first_decode_lens"] is None:
            log["first_decode_lens"] = [int(p) + 1 for p in ctrl["pos"]]
        timed_step(ctrl)
        finite = finite & torch.isfinite(eng.state["logits"]).all()

    eng.prefill_into, eng.step = counted_prefill, counted_step
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    fa.LAUNCHES = 0
    pa.LAUNCHES = 0
    t0 = time.perf_counter()
    outs = ContinuousScheduler(eng).run(reqs)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = {"flash_fwd": fa.LAUNCHES, "paged_attention": pa.LAUNCHES}

    admissions = len(log["admit_at_step"])
    steps = len(step_clock.spans)
    toks = np.stack([outs[r.rid] for r in reqs])
    if toks.shape != (n_requests, max_new):
        raise AssertionError(f"output shape {toks.shape}")
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("token outside the vocab range")
    if not bool(finite):
        raise AssertionError("non-finite logits")
    if admissions != n_requests:
        raise AssertionError(f"{admissions} admissions for {n_requests}")
    if n_requests > max_batch and not any(s > 0 for s in log["admit_at_step"]):
        raise AssertionError("no admission happened mid-run")
    if dev.type == "cuda":
        want = {"flash_fwd": cfg.n_layers * admissions,
                "paged_attention": cfg.n_layers * steps}
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")

    pre_ms, step_ms = pre_clock.ms(), step_clock.ms()
    # the highest percentile with at least ten samples beyond it
    tail = int(100 * (1 - 10 / len(step_ms))) if len(step_ms) >= 20 else None
    res = {
        "requests": n_requests, "admissions": admissions,
        "decode_steps": steps, "tokens": int(toks.size),
        "mid_run_admissions": sum(1 for s in log["admit_at_step"] if s > 0),
        "launches": launches,
        "prefill_tok_s": float(lens.sum()) / (sum(pre_ms) / 1e3),
        "decode_tok_s": log["decode_tokens"] / (sum(step_ms) / 1e3),
        "median_step_ms": float(np.median(step_ms)),
        "median_prefill_ms": float(np.median(pre_ms)),
        "tail_pct": tail,
        "tail_step_ms": (float(np.percentile(step_ms, tail))
                         if tail else None),
        "wall_s": wall, "wall_tok_s": toks.size / wall,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None),
        "first_decode_lens": log["first_decode_lens"],
        "prompt_lens": lens.tolist(),
    }
    print(f"[serve] {cfg.name} L{cfg.n_layers} d{cfg.d_model} "
          f"H{cfg.n_heads}/{cfg.n_kv_heads} ff{cfg.d_ff} V{cfg.vocab_size} "
          f"{cfg.dtype} on {dev}: {n_requests} requests, {max_batch} slots, "
          f"{admissions} admissions ({res['mid_run_admissions']} mid-run), "
          f"{steps} decode steps, launches {launches}")
    print(f"[serve] prefill {res['prefill_tok_s']:.1f} tok/s, decode "
          f"{res['decode_tok_s']:.1f} tok/s, median step "
          f"{res['median_step_ms']:.3f} ms (p{tail} {res['tail_step_ms']} "
          f"ms, n={steps}), median prefill "
          f"{res['median_prefill_ms']:.3f} ms, wall {wall:.2f} s "
          f"({res['wall_tok_s']:.1f} generated tok/s), peak memory "
          f"{res['peak_mem_gib']} GiB | {CARD['line']}")
    return res, eng


# ------------------------------------------------------------- 4b. trace


def _profile(fn, device):
    """Run ``fn`` under torch.profiler (CPU + CUDA). Returns (wall ms,
    device-busy ms, kernel launches, [(kernel, ms, calls)] by time)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        _sync(device)
        wall = (time.perf_counter() - t0) * 1e3
    # device-side entries only: a CPU op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type != torch.autograd.DeviceType.CPU
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    launches = sum(r[2] for r in rows)
    return wall, busy, launches, rows


def _report_trace(label, n, untraced_ms, wall, busy, launches, rows):
    """Device busy time per call from the trace; the idle share is taken
    against the UNTRACED median of phase 4 (the profiler slows the host,
    so the traced wall time overstates idleness; both are printed)."""
    if not rows:                              # no device: nothing to report
        print(f"[trace] {label}: {n} calls, traced wall {wall / n:.3f} ms "
              f"each, device times not measured (no CUDA device)")
        return
    busy_ms = busy / n
    print(f"[trace] {label}: {n} calls, device busy {busy_ms:.3f} ms each, "
          f"{launches / n:.0f} kernels each; untraced median "
          f"{untraced_ms:.3f} ms -> device idle "
          f"{100 * (1 - busy_ms / untraced_ms):.1f}% (traced wall "
          f"{wall / n:.3f} ms) | {CARD['line']}")
    for name, ms, calls in rows[:6]:
        print(f"[trace]   {100 * ms / busy:5.1f}% {ms / n:8.4f} ms/call "
              f"x{calls // n} {name[:90]}")


def phase_trace(device, eng, serve, n_steps=8, prompt_len=256):
    """Where a prefill and a decode step spend their time: a fresh engine
    on the same weights admits ``max_batch`` prompts (traced), then runs
    ``n_steps`` full decode steps (traced) through the scheduler's own
    admission and control-array code."""
    dev = torch.device(device)
    eng = PagedDecodeEngine(lm=eng.lm, params=eng.params,
                            max_batch=eng.max_batch,
                            max_seq_len=eng.max_seq_len, max_new=eng.max_new,
                            page_size=eng.page_size,
                            prefill_chunk=eng.prefill_chunk, device=dev)
    sched = ContinuousScheduler(eng)
    rs = np.random.RandomState(1)
    reqs = [Request(rid=i, tokens=rs.randint(0, eng.lm.cfg.vocab_size,
                                             size=prompt_len).astype(np.int32),
                    n_new=eng.max_new) for i in range(eng.max_batch)]
    acts = []
    stats = _profile(lambda: acts.extend(sched._admit(r) for r in reqs), dev)
    _report_trace(f"prefill ({prompt_len}-token prompt, chunk "
                  f"{eng.prefill_chunk})", len(reqs),
                  serve["median_prefill_ms"], *stats)
    active = {a.slot: a for a in acts}

    def steps(n):
        for _ in range(n):
            ctrl = sched._build_ctrl(active, eng.max_batch, eng.scratch_idx,
                                     False, None)
            eng.step(ctrl)
            for a in active.values():
                a.pos += 1
                a.emitted += 1

    steps(1)                                  # warm
    stats = _profile(lambda: steps(n_steps), dev)
    _report_trace(f"decode step ({eng.max_batch} active)", n_steps,
                  serve["median_step_ms"], *stats)


# --------------------------------------------------------- 5. reference

#: max |logit(kernel path) - logit(plain path)| allowed at 2 layers, bf16
REF_LOGIT_TOL = 0.1


def phase_reference(device, n_layers=2, prompt_len=300, seed=0):
    """Full-width granite-3-2b cut to ``n_layers``: one prefill chunk and
    one decode step through the kernels against the plain path (naive
    prefill attention, gather-reference decode) on the same weights and
    inputs. bf16 activations round differently in the two paths, so the
    logits agree to REF_LOGIT_TOL, not bitwise."""
    dev = torch.device(device)
    base = get_config("granite-3-2b").with_(n_layers=n_layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = build_model(base).init(gen, device=dev)
    rs = np.random.RandomState(seed)
    ps, chunk, TW, B = 16, 512, 35, 2
    tokens = np.zeros((1, chunk), np.int64)
    tokens[0, :prompt_len] = rs.randint(0, base.vocab_size, prompt_len)
    tables = np.zeros((B, TW), np.int32)
    tables[1, :] = np.arange(1, TW + 1)
    tables_t = torch.as_tensor(tables, device=dev)
    logits = {}
    for impl in ("flash_pallas", "naive"):
        cfg = base.with_(attn_impl=impl)
        caches = build_model(cfg).init_paged_cache(B, 1 + B * TW, ps,
                                                   device=dev)
        pl, caches = lm_paged_prefill_chunk(
            cfg, params, caches, {"tokens": torch.as_tensor(tokens,
                                                            device=dev)},
            prompt_len, 1, tables_t, ps)
        tok = torch.tensor([0, int(pl.argmax())], device=dev)
        pos = torch.tensor([0, prompt_len], dtype=torch.int32, device=dev)
        dl, _ = lm_paged_decode_step(cfg, params, caches, tok, pos, tables_t,
                                     ps)
        logits[impl] = (pl[0], dl[1])
    errs = [float((a - b).abs().max())
            for a, b in zip(logits["flash_pallas"], logits["naive"])]
    scale = float(logits["naive"][0].abs().max())
    ok = max(errs) <= REF_LOGIT_TOL and all(
        bool(torch.isfinite(t).all()) for t in logits["flash_pallas"])
    print(f"[reference] granite-3-2b cut to {n_layers} layers, bf16: kernel "
          f"path vs plain path max |dlogit| prefill {errs[0]:.5f}, decode "
          f"{errs[1]:.5f} (tol {REF_LOGIT_TOL}, max |logit| {scale:.3f}): "
          f"{'pass' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel path disagrees with the plain path")
    return errs


# --------------------------------------------------------- 6. yardstick


def _time_ms(fn, sets, iters, warmup=3):
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed between two CUDA events, so host launch overhead is not
    counted (the serving phase shows that separately). The calls cycle
    through input sets large enough together to defeat the 50 MB L2: each
    call finds its inputs cold, as a layer does after the previous
    layer's weights have streamed through."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):             # warm-up off the capture
        for i in range(warmup):
            fn(*sets[i % len(sets)])
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*sets[i % len(sets)])
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / iters
    del graph
    return ms


def _bound(flops, nbytes, dtype):
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        "operations" if t_ops >= t_bytes else "bytes"


def _sdpa_ms(sets, iters):
    """torch's scaled_dot_product_attention on the same inputs, laid out
    (B, H, S, D) before timing. Timed here only: the port never calls it."""
    lib_sets = [(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
                for q, k, v in sets]
    try:
        F.scaled_dot_product_attention(*lib_sets[0], is_causal=True,
                                       enable_gqa=True)
        return _time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), lib_sets, iters)
    except TypeError:        # torch without enable_gqa: expand K/V first
        G = sets[0][0].shape[2] // sets[0][1].shape[2]
        lib_sets = [(q, k.repeat_interleave(G, 1), v.repeat_interleave(G, 1))
                    for q, k, v in lib_sets]
        return _time_ms(lambda q, k, v: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), lib_sets, iters)


def phase_yardstick(device, serve, kernels):
    dev = torch.device(device)
    dt = torch.bfloat16
    # flash at the serving prefill shape (one 512-token chunk)
    B, S, Hq, Hkv, D = 1, 512, 32, 8, 64
    gen = torch.Generator(device=dev).manual_seed(7)
    sets = [(_randn(gen, (B, S, Hq, D), dt, dev),
             _randn(gen, (B, S, Hkv, D), dt, dev),
             _randn(gen, (B, S, Hkv, D), dt, dev)) for _ in range(24)]
    f_ms = _time_ms(lambda q, k, v: fa.flash_attention_fwd(q, k, v), sets, 200)
    f_plain = _time_ms(lambda q, k, v: flash_attention_fwd_ref(q, k, v),
                       sets, 10, warmup=1)
    f_lib = _sdpa_ms(sets, 200)
    pairs = S * (S + 1) // 2                       # causal (row, key) pairs
    f_flops = 4 * B * Hq * D * pairs
    f_bytes = 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D) + 4 * B * Hq * S
    f_bound, f_by = _bound(f_flops, f_bytes, dt)

    # paged decode at the serving decode shape, lens of the run's first step
    lens = serve["first_decode_lens"]
    Bp, ps, TW = len(lens), 16, 35
    psets = []
    for i in range(8):
        q, kp, vp, tables, lens_t = _paged_inputs(
            dev, lens=lens, Hq=Hq, Hkv=Hkv, D=D, ps=ps, TW=TW, dtype=dt,
            seed=10 + i)
        psets.append((q, kp, vp, tables, lens_t))
    p_ms = _time_ms(lambda *a: pa.paged_attention_cuda(*a), psets, 500)
    p_plain = _time_ms(lambda *a: paged_attention_ref(*a), psets, 50)
    tokens = int(sum(lens))
    p_flops = 4 * Hq * D * tokens
    p_bytes = 2 * (2 * Bp * Hq * D + 2 * tokens * Hkv * D) + 4 * Bp * (TW + 1)
    p_bound, p_by = _bound(p_flops, p_bytes, dt)

    entries = [
        {"name": "flash_fwd", "route": "cuda", "source": FLASH_SRC,
         "replaces": FLASH_TPU, "launches": serve["launches"]["flash_fwd"],
         "max_abs_err": kernels["flash_fwd"][0]["max_abs_err"],
         "ms": f_ms, "plain_ms": f_plain, "bound_ms": f_bound,
         "bound_by": f_by, "library_ms": f_lib},
        {"name": "paged_attention", "route": "cuda", "source": PAGED_SRC,
         "replaces": PAGED_TPU,
         "launches": serve["launches"]["paged_attention"],
         "max_abs_err": kernels["paged_attention"][0]["max_abs_err"],
         "ms": p_ms, "plain_ms": p_plain, "bound_ms": p_bound,
         "bound_by": p_by, "library_ms": None},
    ]
    print(f"[yardstick] flash_fwd B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} bf16: "
          f"{f_ms:.4f} ms (plain {f_plain:.3f}, sdpa {f_lib:.4f}, bound "
          f"{f_bound:.4f} by {f_by}) | {CARD['line']}")
    print(f"[yardstick] paged_attention B{Bp} Hq{Hq} Hkv{Hkv} D{D} ps{ps} "
          f"TW{TW} lens {lens} bf16: {p_ms:.4f} ms (plain {p_plain:.3f}, "
          f"library none, bound {p_bound:.5f} by {p_by}) | {CARD['line']}")
    return entries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    device = "cuda"
    phase_device(device)
    phase_build(device)
    kernels = phase_kernels(device)
    serve, eng = phase_serve(device)
    phase_trace(device, eng, serve)
    del eng
    phase_reference(device)
    entries = phase_yardstick(device, serve, kernels)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
