#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Drives only ``repro_torch`` (no JAX). Phases, each printing its lines and
raising on any failure:

1. device    — the card's name and power limit from nvidia-smi; TF32 off.
2. build     — nvcc builds every CUDA source for sm_90a; ptxas registers,
               shared memory and spills per kernel.
3. kernels   — each CUDA kernel against its plain PyTorch version on the
               card, at the main paths' shapes and edge cases: flash
               forward and paged decode with the JAX reference tests'
               tolerances; the five WA kernels (the f32 sync, the window
               update, the online mean, and the bf16-ring update and
               sync) at 0 ULP, bits compared (K 1-4, I 1 and 3, full 0
               and 1, the training run's packed size with every ring row
               but idx untouched, a bf16 stack, an inv_k override, the
               per-leaf wrappers on a ragged leaf); the flash backward
               sweeps on the gradient matrix of tests/test_attention_ops.py;
               the bf16 edges of the Hopper flash designs (ragged S,
               fully-masked rows with O = 0 and lse = -1e30 exactly, GQA
               groups of 1, 2 and 8, head_dim 128) for the forward and
               both sweeps; head dims that are not kernel instances (160,
               run at 192, and 40, run at 64) and 192 itself on every
               attention kernel through the wrappers the model calls; the
               paged cluster split's edges (every live page on one CTA, a
               wrapped ring under a window that leaves CTAs without a
               page, all lens 0); two dk/dv and two paged launches
               compared bit for bit; phase 11's shapes (the forward and
               the paged kernel at qwen2-moe-a2.7b's Hq16 Hkv16 D128, the
               sweeps at granite-moe-1b-a400m's B4 S512 Hq16 Hkv8 D64,
               the fused sync at its 742.8M parameters); phase 12's
               (hymba-1.5b's G = 5 and window 1024: the forward at its
               prefix fill, its training batch and a binding window
               S = T = 1,536, the sweeps at B4 S640 and dk/dv twice, the
               paged kernel with lens across 1,024 so the ring wraps,
               twice to the bit; the fused sync at xlstm-125m's 176.5M
               and hymba's 748.1M parameters); phase 13's (internvl2-1b's
               G = 7 at head_dim 64: the forward over 256 vision + 512
               prompt positions at B1 and B4 and in f32, the sweeps at B4
               S768 directly, through the wrappers and in f32, dk/dv twice
               to the bit, the paged kernel with lens past the vision
               prefix in bf16 and f32 and twice to the bit; musicgen-
               medium's G = 1 at head_dim 64: the forward at B1 and B4
               S512, the sweeps at B4 S512, dk/dv and paged twice; the
               fused sync at internvl2's 630.6M and musicgen's 931.2M at
               24 layers); phase 14's (gemma2-27b's G = 2 at head_dim 128
               with softcap 50: the forward over its 5,888-token chunk on
               a local layer, window 4096, and a global one, and in f32
               at S 4,200; the paged kernel with lens across 4,096 at TW
               370, local in bf16 and f32, global, and twice to the bit;
               command-r-35b's G = 8: the forward at B1 S512 and in f32,
               the paged kernel in bf16 and f32 and twice to the bit, the
               sweeps at B1 S512 directly, through the wrappers and in
               f32, dk/dv twice to the bit).
14. large    — run right after phase 3, on a card holding under 1 GiB:
               14a gemma2-27b (46 layers, 28.407B, local and global
               layers, window 4096, softcaps 50 and 30, a 256,000-word
               head) whole in bf16 serves 6 requests of 4,200-5,800
               prompt tokens (every prefill and step binds the window)
               and 32 new over 4 slots, page 16, one 5,888-token chunk;
               14b command-r-35b (40 layers, 32.381B, G = 8) phase 4's 12
               requests: phase 4's gates (launches n_layers x admissions
               and n_layers x steps, finite logits, mid-run admissions,
               the pool at the kernel's head_dim), the parameter count,
               init and serving peaks under 80 GB; each traced (its first
               pool dropped). 14c: each cut to 2 layers, kernel path
               against plain path in f32 and bf16 (gemma2 at prompt 4,700
               in a 4,736 chunk: the window binds). 14d: gemma2 at 2
               layers in f32 through the DecodeEngine (B2, prompts of
               4,500: its window ring wraps), tokens equal to the paged
               engine's. One model on the card at a time.
4. serve     — granite-3-2b at full width and depth (bf16, random weights
               from a seed) serves 12 requests through PagedDecodeEngine
               with 8 slots; the kernels' launch counts must equal
               40 x admissions (flash) and 40 x decode steps (paged).
   trace     — torch.profiler over 8 admissions and over 8 full decode
               steps: device busy and idle share, top kernels by time.
5. reference — the same model cut to 2 layers: logits of the kernel path
               against the plain path on one prefill and one decode step.
4-5 again    — stablelm-12b (head_dim 160: the kernels and the page pool
               at 192) at full width and all 40 layers: the same 12
               requests, launch counts and trace; its 2-layer reference.
7. train     — HWA training of full-width granite-3-2b cut to 8 layers
               through Trainer.run (K=2, H=2, I=3, fused sync, SGD,
               4 x 512 tokens per replica, 10 steps, 5 syncs, W̿ evaluated
               at every sync and on 8 training sequences): finite,
               falling loss, a W̿ that changes at every sync and whose
               loss on the training sequences falls, exact launch counts;
               step time, tokens/s, mfu, sync time, peak memory.
   trace     — torch.profiler over 2 inner steps and 1 sync.
   reference — the model cut to 2 layers: loss, grads and W̿ after one
               step and one sync, kernel path against plain path; then the
               streaming window and the fp8 ring, kernel route (online
               mean + plain update) against plain route over 3 syncs
               (W̿ within 1.25 rel-ULP, replicas bit-equal).
8. windows   — the training run (same model, data, seed, optimizer, K, H,
               I) under three other windows, 10 steps and 5 syncs each:
               8a bf16 ring at stride 1 (one bf16 fused sync per sync),
               8b f32 ring at stride 2 through Trainer.run (online mean
               every sync, window update on cycles 1, 3, 5), 8c bf16 ring
               at stride 2. Gates: finite, falling loss; exact launch
               counts; W̿ unchanged to the bit on skipped cycles and
               changed on taken ones; 8a's W̿ within the reference's bf16
               budget (4.0 rel-ULP) of phase 7's f32-ring W̿.
9. phase 9  — 9a: the paper's baselines ca, swa, ema, lookahead and sam
               through Trainer.run on phase 7's model, data and SGD with
               one replica, 8 steps each (2 steps an epoch: SWA samples
               after step 4): finite, falling loss, SWA's sample count by
               the reference's rule, Lookahead's fast weights equal to
               its slow ones cast to bf16 after every update, finite
               losses of each method's evaluated weights, exact launches,
               and a SAM step launching twice each attention kernel of a
               ca step; median step and update, peak memory.
               9b: HWA (K=2, H=2, I=3, fused sync) on the model cut to 1
               layer, 8 steps, checkpointed once (step 6) into a
               temporary session: the run resumed from it (its scan
               verifies every CRC and finds step 6, which it loads;
               saving nothing more) ends bit for bit as the
               uninterrupted run did (W̿ and history); then the
               window state saved with save_window_state and published
               through publish_checkpoint into a 2-layer engine equals
               publish_window_state's params to the bit. GB a save,
               seconds to save, and the resume's seconds to scan and
               load. (The bit flip and the fallback run in 15d.)
               9c: phase 7's W̿ published (publish_window_state) into an
               engine on its 8-layer model serves phase 4's 12 requests:
               params bit-equal to window_average cast to bf16, tokens
               equal to an engine given those params directly, launches
               8 x admissions and 8 x decode steps; the publish's time.
10. phase 10 — 10a: resilient HWA (K=2, H=2, I=3, f32 ring, kernels) on
               the training model cut to 2 layers: a healthy sync through the
               resilient route (window-update kernel) bit-equal to the
               plain route with one window-update launch; Trainer.run
               with replica 1 poisoned with NaN before step 3: k_alive 1
               at the next sync, W̄ equal to replica 0, replica 1's
               momenta zeroed, W̿ finite, k_alive 2 at the sync after; a
               replica scaled x1e3 quarantined by max_param_rms.
               10b: the same model, one step: flash_jnp against
               flash_pallas (each layer's output and dq, dk, dv within the
               bf16 flash tolerance, the loss within it relatively), remat
               dots against full bit-equal, peak memory and flash launches
               of a step under none, full and dots.
               10c: the paper's ResNet-110 (32x32, widths 16/32/64, 10
               classes) through repro_torch.launch.resnet_cifar: K=2,
               batch 128, SGD momentum 0.9, wd 5e-4, cosine LR from 0.1,
               H one epoch (40 steps), I=3, the fused sync, BN statistics
               recomputed under W̿ each epoch, 3 epochs; the first sync
               held against its plain version at 0 ULP; finite losses,
               the last epoch's loss below 0.7 of the first's, W̿ above
               chance; median replica step, sync and recompute times.
11. MoE      — 11a: qwen2-moe-a2.7b (14.3B parameters, 16/16 heads at
               head_dim 128, 60 experts top-4 and 4 shared) and then
               granite-moe-1b-a400m (32 experts top-8) at full width and
               depth, bf16, random weights from a seed, serve phase 4's 12
               requests: launches 24 x admissions (flash) and 24 x decode
               steps (paged); qwen2's weights are freed before the next.
               11b: each cut to 2 layers, kernel path against plain path
               in f32 (every logit within the f32 flash tolerance, greedy
               tokens equal) and in bf16 (greedy tokens equal or tied;
               the logits' distance reported: the router turns bf16
               rounding into other experts). The expert products
               (``torch._grouped_mm``) against the per-expert loop at a
               qwen2 decode step and prefill chunk and granite-moe's
               training batch (forward and backward): equal within the
               bf16 tolerance, times of both, the grouped product the
               faster. 11c: HWA training of granite-moe-1b-a400m cut to
               12 layers by phase 7's recipe and gates (the router loss
               finite at every step too); step, tok/s, mfu over the
               239.5M parameters a token's products touch, sync, peak.
               11d: torch.profiler over qwen2's prefill and decode and
               granite-moe's 2 steps and a sync, with the grouped
               products' share of the device time.
12. recurrent — 12a: hymba-1.5b (32 layers, 1.394B parameters, 25/5
               heads, window 1024, 128 meta tokens) and then xlstm-125m (12
               layers) at full width, bf16, random weights from a seed,
               serve 8 requests of 64-256 tokens and 32 new through the
               prefix fill and the step prefill, 8 slots: launches 32 x
               prefix fills (flash) and 32 x decode steps (paged) for
               hymba, none for xlstm; median and tail step, decode tok/s,
               the share of steps that feed a prompt, peak memory. 12b:
               each cut to 2 layers, kernel path against plain path over a
               whole serving run (3 requests over 2 slots: a slot reused)
               in f32 (every logit of every step within the f32 flash
               tolerance, tokens equal) and bf16 (tokens equal or tied,
               the logits' distance reported), and hymba with one request
               of 960 + 96 tokens (the window ring wraps at TW 65) in f32.
               12c: HWA training by phase 7's recipe of xlstm-125m whole and
               hymba-1.5b cut to 16 layers (748.1M), phase 7's gates and
               exact launches. 12d: torch.profiler over a hymba decode step
               and an xlstm training step: the recurrences' share of the
               device time, kernels a layer, idle share.
13. modality — 13a: internvl2-1b (24 layers, 630.6M parameters, 14/2
               heads at head_dim 64, 256 x 1,024 f32 patch embeddings a
               request through the vision projection) and then
               musicgen-medium (48 layers, 1.837B, 24/24 heads, 4
               codebook streams summed in and 4 heads out) at full width
               and depth, bf16, random weights from a seed, serve 8
               requests of 64-512 prompt tokens and 32 new through
               PagedDecodeEngine (8 slots, page 16, chunk 512):
               launches n_layers x admissions (flash) and n_layers x
               decode steps (paged); prefill and decode tok/s, median
               and tail step, peak memory; torch.profiler over 4 decode
               steps (busy, idle share, kernels a step). 13b: each cut
               to 2 layers, kernel path against plain path over a whole
               serving run (3 requests over 2 slots) in f32 (every logit
               of the prefills and steps within the f32 flash tolerance,
               tokens equal) and bf16 (tokens equal or tied). 13c: the
               whole-batch DecodeEngine on granite-3-2b and both archs
               at full width cut to 2 layers, f32: one prefill at B4
               (2 flash launches), the plain decode over the contiguous
               ring; tokens equal to the paged engine's. 13d: HWA
               training (phase 7's recipe, 6 steps, 3 fused syncs,
               through hwa_inner_step and hwa_sync over dict batches of
               tokens, targets and vis_embeds) of internvl2-1b whole and
               musicgen-medium cut to 24 layers: finite, falling loss,
               exact launches, step, sync, tok/s, mfu, peak memory.
15. mesh     — HWA across processes (``launch.train.run_mesh_native``:
               one spawned rank a replica, ``gloo`` on this card with
               CUDA tensors staged through host memory) on full-width
               granite-3-2b, flash kernels, remat off, right after phase
               14, on a card this process holds under 4 GiB of, cut to
               1 layer (phase 16 takes the time of a second). 15a:
               flat, K 2, 8 steps, H 2, I 2: every W̄ 0 ULP from
               ``online_average_canonical`` of the replicas gathered
               before it (computed on the card), every rank restarted
               from it, exact launches (the window update once a rank a
               sync, the flash forward and both sweeps once a layer a
               step a rank), no collective in a train step, one two-way
               all-reduce a sync; W̿, replicas and losses against the
               one-process stacked run (phase 7's path) on the same
               batches. 15b: the two-level tree, K 4 as 2 pods of 2,
               H₂ 2, f32, 4 steps: inner syncs cross no pod and push no
               window, every W̄ 0 ULP from the grouped or pod mean. 15c:
               the bf16 ring with bf16 comms and the fp8 ring with fp8
               comms on that tree: W̿ within the reference's 4 rel-ULP
               budgets of an exact f32 window on the same replicas, the
               cross-pod payload 2 or 1 bytes an element plus scales.
               15d: the fault check's nan-replica, resume-exact and
               corrupt-fallback legs on the card. ``[mesh15]`` lines give
               each sync's ms, its collectives and bytes a level, the
               host-staged bytes and the launches.
16. parallel — a data and a model axis inside a replica, right after
               phase 15, the same model at 4 steps and a window of 2
               (``--world-size``, ``--tp``, ``--fsdp``;
               ``phase_mesh_parallel``). 16c first, alone: K 2 × data 2
               × model 2 with FSDP, the grouped packed layout, the window
               update once a group a sync, and in its spawn a
               smoke-width bf16 run held 0 ULP against the stacked
               per-leaf ``hwa_sync`` on the host (the replicas widened
               to f32), saving a checkpoint; then side
               by side 16a (K 2 × data 2, the flash kernels, gradients
               averaged over data), 16b (K 2 × model 2, ``flash_jnp``,
               tensor-parallel layers) and the checkpoint resumed
               bit-exactly under one rank a replica. Every W̄ 0 ULP from
               its oracle, the train steps exactly the data- and
               model-level collectives they declare (counted from the
               leaves' places and the layers), the syncs one
               replica-level all-reduce. 15a's and 15b-c's times, and
               16a's and 16b's, are taken side by side, under each
               other's load; 16c's alone.
               ``[mesh16]`` lines give the layouts, rank 0's set-up,
               steps and probes, each sync's ms and bytes a level, and
               each rank's peak device memory.
17. model axis — right after phase 16: a model axis for the recurrent
               families and the expert-parallel MoE, K 2 × model 2 on
               ``gloo``, 4 steps, H 2, I 2, 4 × 512 tokens a replica,
               bf16, in one spawn (``phase_mesh_model_axis``): 17a
               xlstm-125m whole (12 layers; its 4 heads 2 a rank, the
               vocab split), 17b hymba-1.5b cut to 2 layers (its 25
               heads and ssm heads divide by no 2: attention and Mamba
               whole on each rank from gathered leaves), 17c
               granite-moe-1b-a400m cut to 2 layers with its experts
               split over ``model`` (16 a rank, capacity 1.25, the
               all-to-all exchange; the share of pairs dropped printed).
               Gates: every W̄ 0 ULP, the train steps exactly their
               declared collectives a level and none on a replica level,
               the window update launched exactly, the loss finite, every
               sync's audit verdict (the audit also gates phases 15-16's
               syncs). 17d, beside it: the smoke configs in f32 at tp 2
               within 1e-5 of one rank a replica after 4 steps, and the EP
               layer within 1e-3 of the TP layer at capacity E/k.
               ``[mesh17]`` lines give each sync's ms and bytes a level,
               each rank's peak memory and the train steps' collectives.
18. lint     — the contract checker (``repro_torch.analysis``) on the
               card, right after phase 17, spawning nothing. 18a: the
               lint's in-process cases at granite-3-2b's published width
               cut to MESH_LAYERS, ``flash_pallas``: the paged decode
               step (the paged kernel once an attention layer), the
               stacked syncs of K 2 (``sync/legacy-kernel@1dev``) and K 4
               (``sync/flat-vmap-k4-kernel``), the fused sync once each,
               and the stacked K 2 train step (the flash forward and both
               sweeps once a layer a replica): every pass holds, the
               launch budgets exactly. 18b, inside phases 15-17's
               ``_mesh_checks``: the collectives, dtype and donation
               passes on every sync and rest call those runs recorded
               (payload dtypes a level, 15c's bf16 and fp8 wire views
               included; a sync's window state, which it returns, kept
               in place; each call's peak allocation above its start
               within the working set its builder declares).
               ``[lint18]`` lines give each case's launches and peak
               beside its declared working set, and each run's recorded
               payloads and its call closest to its bound.
6. yardstick — each kernel timed at its main path's shapes (CUDA-graph
               replay between CUDA events: device time, cold L2), beside
               its plain version, a library call where one exists, and
               the bound from its bytes and FLOPs; the flash forward at
               both of its shapes (serving prefill B1, training B4); the
               forward and the paged kernel at stablelm-12b's serving
               shapes, their bounds at the true head_dim; and at
               qwen2-moe-a2.7b's (B1 S512 and B8, Hq16 Hkv16 D128); and
               at hymba-1.5b's serving shapes (the prefix fill B1 S128
               and 12a's fullest decode step B8, Hq25 Hkv5 D64, window
               1024), SDPA with ``enable_gqa``; and at phase 13's: the
               forward at a prefill chunk (B1) and the training batch
               (B4), the paged kernel at 13a's fullest step and both
               sweeps at 13d's batch, for internvl2-1b and musicgen-medium;
               and at phase 14's: the forward at the served chunk and the
               paged kernel at 14a-b's first decode step, for gemma2-27b's
               local and global layers (library none: SDPA has no tanh
               softcap) and command-r-35b's G = 8 (SDPA, ``enable_gqa``).
               A [time] line gives phase 14's and the script's seconds.

The second-to-last line is ``{"kernels": [...]}``, the last
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 2.
"""
from __future__ import annotations

import dataclasses
import gc
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

from repro_torch.common.packing import ALIGN  # noqa: E402
from repro_torch.common.quant import max_ulp, rel_ulp_error  # noqa: E402
from repro_torch.common.pytree import (tree_flatten, tree_leaves,  # noqa: E402
                                       tree_map, tree_unflatten)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.hwa import (HWAConfig, hwa_init,  # noqa: E402
                                  hwa_inner_step, hwa_sync)
from repro_torch.data import DataPipeline, make_markov_lm_dataset  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import flash_attention_bwd as fab  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import wa_update as wa  # noqa: E402
from repro_torch.kernels.head_dim import (pad_head_dim,  # noqa: E402
                                         padded_head_dim)
from repro_torch.kernels.ref import (flash_attention_bwd_ref,  # noqa: E402
                                     flash_attention_fwd_ref,
                                     online_mean_ref, paged_attention_ref,
                                     wa_sync_fused_c_ref, wa_sync_fused_ref,
                                     wa_window_update_c_ref,
                                     wa_window_update_ref)
from repro_torch.launch.mesh import kernel_counts  # noqa: E402
from repro_torch.launch.serve import make_batch  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.cache import TRASH_PAGE  # noqa: E402
from repro_torch.models.registry import (_prefix_len,  # noqa: E402
                                         build_model,
                                         lm_paged_decode_step,
                                         lm_paged_prefill_chunk)
from repro_torch.optim import cosine_schedule, sgd  # noqa: E402
from repro_torch.serve.engine import (DecodeEngine,  # noqa: E402
                                      PagedDecodeEngine)
from repro_torch.serve.scheduler import ContinuousScheduler, Request  # noqa: E402
from repro_torch.train.trainer import TrainConfig, Trainer, lm_task  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

FLASH_SRC = "src/repro_torch/csrc/flash_fwd.cu"
PAGED_SRC = "src/repro_torch/csrc/paged_attention.cu"
SYNC_SRC = "src/repro_torch/csrc/wa_update.cu"
BWD_SRC = "src/repro_torch/csrc/flash_bwd.cu"
FLASH_TPU = "src/repro/kernels/flash_attention.py:68"
PAGED_TPU = "src/repro/kernels/paged_attention.py:71"
SYNC_TPU = "src/repro/kernels/wa_update.py:128"
WA_TPU = {"wa_window_update": "src/repro/kernels/wa_update.py:89",
          "online_mean": "src/repro/kernels/wa_update.py:272",
          "wa_window_update_c": "src/repro/kernels/wa_update.py:173",
          "wa_sync_fused_c": "src/repro/kernels/wa_update.py:222"}
DQ_TPU = "src/repro/kernels/flash_attention_bwd.py:67"
DKV_TPU = "src/repro/kernels/flash_attention_bwd.py:102"

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


def _reset_counts():
    """Zero every kernel wrapper's launch count (before a main path)."""
    fa.LAUNCHES = pa.LAUNCHES = wa.LAUNCHES = 0
    fab.DQ_LAUNCHES = fab.DKV_LAUNCHES = 0
    wa.WINDOW_UPDATE_LAUNCHES = wa.ONLINE_MEAN_LAUNCHES = 0
    wa.WINDOW_UPDATE_C_LAUNCHES = wa.SYNC_FUSED_C_LAUNCHES = 0


def _counts():
    """Every kernel wrapper's launch count in this process (a spawned
    rank reports its own, ``launch.mesh.spawn_ranks``)."""
    return kernel_counts()


def _want(**nonzero):
    """The launch counts of a main path: ``nonzero`` and 0 elsewhere."""
    want = dict.fromkeys(_counts(), 0)
    want.update(nonzero)
    return want


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
    # a fully-masked row (no key within the window) gets O = 0 and lse =
    # NEG_INF exactly
    dead = torch.arange(S, device=device) - (T - 1) >= (window or 10**9)
    ok_dead = not bool(out[:, dead].any()) and \
        bool((lse[:, :, dead] == -1e30).all())
    return {"shape": f"B{B} S{S} T{T} Hq{Hq} Hkv{Hkv} D{D} "
                     f"{str(dtype)[6:]} w{window} cap{cap}",
            "max_abs_err": max(err_o, err_l), "tol": tol,
            "dead_rows": int(dead.sum()), "pass": ok_o and ok_l and ok_dead}


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
    """The paged kernel against its plain version, through the wrapper the
    model calls: the pools at the kernel's head_dim instance (the model
    allocates them padded), q at the true head_dim, the true scale."""
    q, kp, vp, tables, lens_t = _paged_inputs(
        device, lens=lens, Hq=Hq, Hkv=Hkv, D=D, ps=ps, TW=TW, dtype=dtype,
        seed=seed)
    Dp = padded_head_dim(D)
    got = pa.paged_attention(q, pad_head_dim(kp, Dp), pad_head_dim(vp, Dp),
                             tables, lens_t, window=window,
                             logit_softcap=cap, sm_scale=D ** -0.5)
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


def _paged_repeat_case(device, *, lens, Hq, Hkv, D, ps, TW,
                       dtype=torch.bfloat16, window=None, cap=0.0, seed=0):
    """Two paged launches on the same inputs must give the same bits: the
    cluster combines its CTAs' partials in a fixed order, no atomics."""
    q, kp, vp, tables, lens_t = _paged_inputs(
        device, lens=lens, Hq=Hq, Hkv=Hkv, D=D, ps=ps, TW=TW, dtype=dtype,
        seed=seed)
    runs = [pa.paged_attention_cuda(q, kp, vp, tables, lens_t, window=window,
                                    logit_softcap=cap) for _ in range(2)]
    _sync(device)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    same = torch.equal(runs[0].view(bits), runs[1].view(bits))
    return {"shape": f"B{len(lens)} Hq{Hq} Hkv{Hkv} D{D} ps{ps} TW{TW} "
                     f"{str(dtype)[6:]} w{window} cap{cap} twice",
            "max_abs_err": 0.0 if same else float(
                (runs[0].float() - runs[1].float()).abs().max()),
            "tol": "bitwise", "pass": same}


#: paged cases that stress the cluster split (8 CTAs per sequence and kv
#: head where TW >= 8): every live page on one CTA, a wrapped ring under a
#: window that leaves CTAs of the cluster with no page, all lens 0
PAGED_SPLIT_CASES = [
    dict(lens=[1, 5, 16, 3], Hq=8, Hkv=2, D=64, ps=16, TW=35,
         dtype=torch.bfloat16, seed=21),
    dict(lens=[300, 75, 41, 9], Hq=8, Hkv=2, D=64, ps=8, TW=9,
         dtype=torch.bfloat16, window=40, seed=22),
    dict(lens=[300, 75, 41, 9], Hq=8, Hkv=2, D=128, ps=8, TW=9,
         dtype=torch.float32, window=40, cap=30.0, seed=23),
    dict(lens=[0, 0], Hq=4, Hkv=1, D=64, ps=16, TW=35, dtype=torch.float32,
         seed=24),
]

#: head dims that are not kernel instances, on every attention kernel:
#: stablelm-12b's 160 (runs at 192) and 40 (runs at 64)
ODD_DIMS = (160, 40)


def _ulps(got, want):
    """Largest distance in units in the last place of their dtype (f32 or
    bf16) between two tensors of equal shape; 0 = the same bits, and +0
    against -0 counts 1. Only the elements whose bits differ are
    widened, so a multi-GB buffer needs no copy."""
    view = torch.int32 if got.element_size() == 4 else torch.int16
    a, b = got.reshape(-1), want.reshape(-1)
    where = (a.view(view) != b.view(view)).nonzero()[:, 0]
    if where.numel() == 0:
        return 0
    return max(1, max_ulp(a[where], b[where], got.dtype))


def _sync_case(device, *, K, I, full, P, seed=0):
    """The fused sync kernel against its plain version on the same inputs:
    ring, total and avg must agree to 0 ULP, and the kernel may touch no
    ring row but ``idx``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    stacked = torch.randn((K, P), generator=gen, device=device)
    stacked[:, :8] = -0.0                  # signed zeros: XLA's sum order
    ring = torch.randn((I, P), generator=gen, device=device)
    total = torch.randn((P,), generator=gen, device=device)
    idx = I - 1
    scal = (torch.tensor(idx, dtype=torch.int32, device=device),
            torch.tensor(full, dtype=torch.float32, device=device),
            torch.tensor(1.0 / min(I, 2), dtype=torch.float32,
                         device=device))
    ring_p, total_p = ring.clone(), total.clone()
    _, _, avg_p = wa_sync_fused_ref(stacked, ring_p, total_p, *scal)
    ring_k, total_k = ring, total             # the kernel writes in place
    _, _, avg_k = wa.wa_sync_fused(stacked, ring_k, total_k, *scal)
    _sync(device)
    pairs = ((ring_k, ring_p), (total_k, total_p), (avg_k, avg_p))
    ulp = max(_ulps(x, y) for x, y in pairs)
    err = 0.0 if ulp == 0 else max(float((x - y).abs().max())
                                   for x, y in pairs)
    return {"shape": f"K{K} I{I} P{P} full{full}", "max_abs_err": err,
            "max_ulp": ulp, "tol": "0 ULP", "pass": ulp == 0}


def _wa_case(device, kernel, *, K=2, I=3, full=1.0, P, stack_dtype=None,
             inv_k=None, seed=0):
    """One of the four slice-3 WA kernels against its plain version on the
    same inputs: every output (ring, total, comp, avg, or the mean) must
    have the plain version's bits, signed zeros included, and the ring
    rows other than idx must keep their bits."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, dtype=torch.float32):
        x = torch.randn(shape, generator=gen, device=device)
        x.reshape(-1)[:8] = -0.0
        return x.to(dtype)

    idx = I - 1
    scal = (torch.tensor(idx, dtype=torch.int32, device=device),
            torch.tensor(full, dtype=torch.float32, device=device),
            torch.tensor(1.0 / min(I, 2), dtype=torch.float32,
                         device=device))
    ring_dt = torch.bfloat16 if kernel.endswith("_c") else torch.float32
    kept = None
    if kernel == "online_mean":
        stacked = rnd(K, P, dtype=stack_dtype or torch.float32)
        got = [wa.online_mean(stacked, inv_k)]
        want = [online_mean_ref(stacked, inv_k)]
        shape = f"K{K} P{P} {str(stacked.dtype)[6:]} inv_k {inv_k}"
    else:
        ring = rnd(I, P, dtype=ring_dt)
        kept = ring[torch.arange(I, device=device) != idx].clone()
        total = rnd(P)
        comp = rnd(P) * 1e-6
        ring_p, total_p, comp_p = ring.clone(), total.clone(), comp.clone()
        if kernel in ("wa_window_update", "wa_window_update_c"):
            new = rnd(P)
            if kernel == "wa_window_update":
                want = wa_window_update_ref(ring_p, total_p, new, *scal)
                got = wa.wa_window_update(ring, total, new, *scal)
            else:
                want = wa_window_update_c_ref(ring_p, None, total_p, comp_p,
                                              new, *scal)
                want = want[:1] + want[2:]
                got = wa.wa_window_update_c(ring, total, comp, new, *scal)
        else:
            stacked = rnd(K, P)
            want = wa_sync_fused_c_ref(stacked, ring_p, None, total_p,
                                       comp_p, *scal)
            want = want[:1] + want[2:]
            got = wa.wa_sync_fused_c(stacked, ring, total, comp, *scal)
            del stacked
        shape = f"K{K} I{I} P{P} full{full}"
    _sync(device)
    ulp = max(_ulps(g, w) for g, w in zip(got, want))
    err = 0.0 if ulp == 0 else max(float((g.float() - w.float()).abs().max())
                                   for g, w in zip(got, want))
    ok = ulp == 0
    if kept is not None:
        rows = got[0][torch.arange(I, device=device) != idx]
        bits = torch.int16 if ring_dt == torch.bfloat16 else torch.int32
        ok = ok and torch.equal(rows.view(bits), kept.view(bits))
    return {"kernel": kernel, "shape": shape, "max_abs_err": err,
            "max_ulp": ulp, "tol": "0 ULP", "pass": bool(ok)}


def _leaf_case(device, seed=0):
    """The per-leaf wrappers (``kernels.ops.wa_window_update`` and
    ``online_mean``) on a ragged leaf, on the card against the same
    wrappers handed CPU copies (which run the plain versions)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shape = (301, 1001)                      # not an ALIGN multiple
    ring = torch.randn((3,) + shape, generator=gen, device=device)
    total = torch.randn(shape, generator=gen, device=device)
    new = torch.randn(shape, generator=gen, device=device).bfloat16()
    args = (1, 1.0, 1.0 / 3)
    got = list(kops.wa_window_update(ring, total, new, *args))
    want = list(kops.wa_window_update(ring.cpu(), total.cpu(), new.cpu(),
                                      *args))
    for dt in (torch.float32, torch.bfloat16):
        stacked = torch.randn((3,) + shape, generator=gen,
                              device=device).to(dt)
        got.append(kops.online_mean(stacked))
        want.append(kops.online_mean(stacked.cpu()))
    _sync(device)
    ok = all(tuple(g.shape) == tuple(w.shape) and g.dtype == w.dtype
             for g, w in zip(got, want))
    ulp = max(_ulps(g.cpu(), w) for g, w in zip(got, want))
    return {"kernel": "per-leaf", "shape": f"leaf {shape}",
            "max_abs_err": 0.0 if ulp == 0 else max(
                float((g.cpu().float() - w.float()).abs().max())
                for g, w in zip(got, want)),
            "max_ulp": ulp, "tol": "0 ULP", "pass": ok and ulp == 0}


def _bwd_case(device, *, B, S, Hq, Hkv, D, dtype, T=None, window=None,
              cap=0.0, seed=0, through_ops=False):
    """dq/dk/dv of the CUDA backward against the plain backward.

    Direct (default): the plain backward gets the forward kernel's own
    (O, lse), so the two sweeps alone are compared; a fully-masked row
    must get dq exactly 0. ``through_ops``: autograd through the port's
    differentiable ``kernels.ops.flash_attention`` (forward kernel, two
    backward sweeps, head_dim padding) against the plain forward and
    backward end to end, as tests/test_attention_ops.py holds the
    reference's grads to naive autodiff."""
    T = T or S
    gen = torch.Generator(device=device).manual_seed(seed)
    q = _randn(gen, (B, S, Hq, D), dtype, device)
    k = _randn(gen, (B, T, Hkv, D), dtype, device)
    v = _randn(gen, (B, T, Hkv, D), dtype, device)
    dout = _randn(gen, (B, S, Hq, D), dtype, device)
    opts = dict(window=window, logit_softcap=cap)
    if through_ops:
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = kops.flash_attention(*leaves, **opts)
        got = torch.autograd.grad(out, leaves, dout)
        o_r, lse_r = flash_attention_fwd_ref(q, k, v, **opts)
        want = flash_attention_bwd_ref(q, k, v, o_r, lse_r, dout, **opts)
    else:
        out, lse = fa.flash_attention_fwd(q, k, v, **opts)
        got = fab.flash_attention_bwd(q, k, v, out, lse, dout, **opts)
        want = flash_attention_bwd_ref(q, k, v, out, lse, dout, **opts)
    _sync(device)
    tol = FLASH_TOL[dtype]
    errs, ok = [], all(bool(torch.isfinite(g).all()) for g in got)
    for g, w in zip(got, want):
        e, good = _close(g, w, tol)
        errs.append(e)
        ok = ok and good
    dead = torch.arange(S, device=device) - (T - 1) >= (window or 10**9)
    if dead.any():
        ok = ok and not bool(got[0][:, dead].any())
    return {"shape": f"B{B} S{S} T{T} Hq{Hq} Hkv{Hkv} D{D} "
                     f"{str(dtype)[6:]} w{window} cap{cap}"
                     f"{' ops' if through_ops else ''}",
            "max_abs_err": max(errs), "dq_dk_dv_err": errs, "tol": tol,
            "pass": ok}


def _dkv_repeat_case(device, *, B, S, Hq, Hkv, D, dtype=torch.bfloat16,
                     window=None, cap=0.0, seed=0):
    """Two dk/dv launches on the same inputs must give the same bits: the
    cluster sums its heads' partials in a fixed order, with no atomics."""
    gen = torch.Generator(device=device).manual_seed(seed)
    q = _randn(gen, (B, S, Hq, D), dtype, device)
    k = _randn(gen, (B, S, Hkv, D), dtype, device)
    v = _randn(gen, (B, S, Hkv, D), dtype, device)
    dout = _randn(gen, (B, S, Hq, D), dtype, device)
    opts = dict(window=window, logit_softcap=cap)
    out, lse = fa.flash_attention_fwd(q, k, v, **opts)
    runs = [fab.flash_attention_bwd(q, k, v, out, lse, dout, **opts)[1:]
            for _ in range(2)]
    _sync(device)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    same = all(torch.equal(a.view(bits), b.view(bits))
               for a, b in zip(runs[0], runs[1]))
    return {"shape": f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} {str(dtype)[6:]} "
                     f"w{window} cap{cap} dk/dv twice",
            "max_abs_err": 0.0 if same else max(
                float((a.float() - b.float()).abs().max())
                for a, b in zip(runs[0], runs[1])),
            "tol": "bitwise", "pass": same}


#: phase 11's attention shapes: qwen2-moe-a2.7b's prefill chunk and
#: decode step (16 query and 16 KV heads at head_dim 128, the lens edges
#: of phase 3's decode case), granite-moe-1b-a400m's training batch
QWEN2_MOE_FLASH = dict(B=1, S=512, T=512, Hq=16, Hkv=16, D=128,
                       dtype=torch.bfloat16)
QWEN2_MOE_PAGED = dict(lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=16,
                       Hkv=16, D=128, ps=16, TW=35)
MOE_TRAIN_ATTN = dict(B=4, S=512, Hq=16, Hkv=8, D=64)
#: phase 12's attention shapes: hymba-1.5b's 25 query heads over 5 KV
#: heads (G = 5: the first group that is not a power of two; dk/dv runs a
#: cluster of 5 with 12/13-row shares, the paged kernel 5 warps a CTA)
#: and window 1024: the prefix fill (the 128 meta tokens), the training
#: batch (128 + 512 positions), a window that binds (S = T = 1,536), and
#: the decode step with lens that cross 1,024 (TW 65: the ring wraps)
HYMBA_ATTN = dict(Hq=25, Hkv=5, D=64, window=1024)
HYMBA_PAGED = dict(lens=[0, 1, 129, 300, 1023, 1024, 1025, 1184], ps=16,
                   TW=65, Hq=25, Hkv=5, D=64, window=1024)
#: phase 13's attention shapes: internvl2-1b's 14 query heads over 2 KV
#: heads (G = 7, the first odd group above hymba's 5: dk/dv runs a
#: cluster of 7, the paged kernel 7 warps a CTA) at head_dim 64, over 256
#: vision + 512 prompt positions a prefill chunk and a training sequence,
#: and its decode step with lens past the vision prefix (TW 50 at page
#: 16); musicgen-medium's 24/24 heads (G = 1 at head_dim 64), its prefill
#: chunk and training batch at S 512 and its decode step
INTERNVL2_ATTN = dict(Hq=14, Hkv=2, D=64)
INTERNVL2_PAGED = dict(lens=[0, 1, 257, 300, 544, 700, 799, 800], ps=16,
                       TW=50, **INTERNVL2_ATTN)
MUSICGEN_ATTN = dict(Hq=24, Hkv=24, D=64)
MUSICGEN_PAGED = dict(lens=[0, 1, 17, 16, 100, 300, 543, 544], ps=16,
                      TW=34, **MUSICGEN_ATTN)
#: phase 14's attention shapes. gemma2-27b: 32 query heads over 16 KV
#: heads (G = 2) at head_dim 128 with tanh softcap 50, window 4096 on its
#: local layers and none on its global ones, over its 5,888-token prefill
#: chunk (46 x 128), and its decode step with lens across 4,096 (TW 370
#: at page 16: the table is the global layers' width, so a local layer's
#: pages never wrap and only the mask applies the window; 4,096 and 4,097
#: are the edges). command-r-35b: 64 over 8 (G = 8: the largest cluster
#: of dk/dv, 8 warps and a cluster of 8 CTAs in the paged kernel) at
#: head_dim 128, its 512-token chunk and phase 4's decode lens.
GEMMA2_ATTN = dict(Hq=32, Hkv=16, D=128, cap=50.0)
GEMMA2_WINDOW = 4096
GEMMA2_CHUNK = 5888
GEMMA2_PAGED = dict(lens=[1, 4095, 4096, 4097, 4098, 4700, 5800, 5920],
                    ps=16, TW=370, **GEMMA2_ATTN)
COMMANDR_ATTN = dict(Hq=64, Hkv=8, D=128)
COMMANDR_PAGED = dict(lens=[0, 1, 17, 16, 100, 300, 543, 560], ps=16,
                      TW=35, **COMMANDR_ATTN)

#: the flash gradient matrix of tests/test_attention_ops.py (B = 2):
#: S, Hq, Hkv, D, window, cap, dtype
GRAD_MATRIX = [
    (64, 4, 4, 64, None, 0.0, torch.float32),
    (80, 4, 2, 64, None, 0.0, torch.float32),
    (256, 4, 2, 64, None, 0.0, torch.float32),
    (128, 4, 2, 128, None, 0.0, torch.float32),
    (128, 4, 2, 72, None, 0.0, torch.float32),
    (128, 4, 4, 64, None, 0.0, torch.float32),
    (128, 4, 1, 64, None, 0.0, torch.float32),
    (128, 4, 2, 64, 32, 0.0, torch.float32),
    (128, 4, 2, 64, None, 15.0, torch.float32),
    (128, 4, 2, 64, 24, 15.0, torch.float32),
    (160, 4, 1, 72, 48, 8.0, torch.float32),
    (128, 4, 2, 64, None, 0.0, torch.bfloat16),
    (128, 4, 4, 64, 32, 15.0, torch.bfloat16),
]


def _bf16_edge_cases(case, device):
    """The bf16 edges of the Hopper flash forward and dk/dv designs,
    through ``case`` (``_flash_case`` or ``_bwd_case``): a ragged S (TMA
    zero-fills the last tile), fully-masked rows, GQA groups of 1, 2 and
    8 (cluster sizes of dk/dv) and head_dim 128 without a window."""
    shapes = [dict(S=300, T=300, Hq=8, Hkv=2, D=64, seed=11),
              dict(S=192, T=64, Hq=4, Hkv=2, D=64, window=16, seed=12),
              dict(S=256, T=256, Hq=8, Hkv=8, D=64, seed=13),
              dict(S=256, T=256, Hq=32, Hkv=16, D=64, seed=14),
              dict(S=256, T=256, Hq=32, Hkv=4, D=64, seed=15),
              dict(S=256, T=256, Hq=8, Hkv=4, D=128, seed=16)]
    return [case(device, B=1 if sh["T"] < sh["S"] else 2,
                 dtype=torch.bfloat16, **sh) for sh in shapes]


def _ffn_param_count(cfg, active: bool) -> int:
    """One layer's feed-forward parameters: the MLP's, or the MoE layer's
    (router, experts, shared experts and their gate). ``active``: only
    the top-k experts one token's products touch."""
    D = cfg.d_model
    if cfg.family != "moe":
        return 3 * D * cfg.d_ff
    Fe = cfg.expert_d_ff or cfg.d_ff
    experts = cfg.top_k if active else cfg.n_experts
    shared = (3 * D * cfg.n_shared_experts * Fe + D
              if cfg.n_shared_experts else 0)
    return D * cfg.n_experts + experts * 3 * D * Fe + shared


def _recurrent_layer_counts(cfg, matmul: bool) -> int:
    """The parameters of a recurrent config's layers (xlstm's mLSTM and
    sLSTM blocks, hymba's attention || Mamba + MLP layers), as
    ``models/ssm.py`` and ``models/transformer.py`` lay them out.
    ``matmul``: only the matrices that enter a product (not the conv
    taps, biases, gate constants, fusion weights or norm scales)."""
    D, H, K = cfg.d_model, cfg.n_heads, cfg.conv_kernel
    norms = 0 if matmul else D
    if cfg.family == "ssm":
        di = 2 * D
        mlstm = D * 2 * di + 3 * di * di + di * 2 * H + di * D + norms + (
            0 if matmul else K * di + 2 * H)
        P, ff = D // H, max(2 * D, 64)
        slstm = D * 4 * D + H * P * 4 * P + D * D + 2 * D * ff + norms + (
            0 if matmul else 4 * D)
        return cfg.n_layers // 2 * (mlstm + slstm)
    Kv, P, Hs, N = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.ssm_heads, \
        cfg.ssm_state
    attn = 2 * D * H * P + 2 * D * Kv * P
    mamba = 2 * D * D + D * 2 * N + D * Hs + D * D + (
        0 if matmul else K * D + 3 * Hs)
    return cfg.n_layers * (attn + mamba + 3 * D * cfg.d_ff + 2 * norms
                           + (0 if matmul else 2))


def _vocab_rows(cfg) -> int:
    """Rows of the embedding and of the head: V, or CB x V for audio's
    per-codebook tables."""
    return cfg.vocab_size * (cfg.n_codebooks if cfg.family == "audio"
                             else 1)


def train_param_count(cfg) -> int:
    """Parameters of a config (embed, head, meta tokens, the VLM's
    vision projection, per-layer attention or recurrent blocks,
    feed-forward and norm scales, final norm), without building them."""
    D, V = cfg.d_model, _vocab_rows(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return 2 * V * D + cfg.n_meta_tokens * D + D + \
            _recurrent_layer_counts(cfg, matmul=False)
    H, Kv, P = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    per_layer = 2 * D * H * P + 2 * D * Kv * P + \
        _ffn_param_count(cfg, active=False) + 2 * D
    vis = cfg.d_vis * D if cfg.family == "vlm" else 0
    return 2 * V * D + vis + cfg.n_layers * per_layer + D


def train_matmul_param_count(cfg) -> int:
    """The parameters one token's products touch, the N of ``mfu``'s
    6*N*tokens: all but the embedding table (a gather), the norm scales
    and the VLM's vision projection (its 256 positions a sequence only),
    and of a MoE layer only the router, the top-k experts and the shared
    experts."""
    D, V = cfg.d_model, _vocab_rows(cfg)
    if cfg.family in ("ssm", "hybrid"):
        return V * D + _recurrent_layer_counts(cfg, matmul=True)
    H, Kv, P = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    per_layer = 2 * D * H * P + 2 * D * Kv * P + \
        _ffn_param_count(cfg, active=True)
    return V * D + cfg.n_layers * per_layer


def phase_kernels(device):
    flash = [
        # granite-3-2b prefill chunk
        _flash_case(device, B=1, S=512, T=512, Hq=32, Hkv=8, D=64,
                    dtype=torch.bfloat16),
        # the training shape (one replica's batch of one layer)
        _flash_case(device, B=4, S=512, T=512, Hq=32, Hkv=8, D=64,
                    dtype=torch.bfloat16, seed=4),
        # ragged S (not a tile multiple), f32
        _flash_case(device, B=2, S=300, T=300, Hq=8, Hkv=2, D=64,
                    dtype=torch.float32, seed=1),
        # head_dim 128, sliding window, softcap
        _flash_case(device, B=2, S=256, T=256, Hq=8, Hkv=4, D=128,
                    dtype=torch.bfloat16, window=64, cap=50.0, seed=2),
        # queries past the key horizon of a window: fully-masked rows
        _flash_case(device, B=1, S=192, T=64, Hq=4, Hkv=2, D=64,
                    dtype=torch.float32, window=16, seed=3),
    ] + _bf16_edge_cases(_flash_case, device) + [
        # head dims that are not instances: padded to 192 and 64
        _flash_case(device, B=2, S=S, T=S, Hq=8, Hkv=2, D=D, dtype=dt,
                    window=w, cap=cap, seed=30 + D)
        for D in ODD_DIMS
        for S, dt, w, cap in ((256, torch.bfloat16, None, 0.0),
                              (200, torch.float32, 48, 20.0))] + [
        # stablelm-12b's prefill chunk (head_dim 160 runs at 192)
        _flash_case(device, B=1, S=512, T=512, Hq=32, Hkv=8, D=160,
                    dtype=torch.bfloat16, seed=36),
        # head_dim 192 itself, fully-masked rows
        _flash_case(device, B=1, S=192, T=64, Hq=4, Hkv=2, D=192,
                    dtype=torch.bfloat16, window=16, seed=37),
        # qwen2-moe-a2.7b's prefill chunk: G = 1 at head_dim 128
        _flash_case(device, **QWEN2_MOE_FLASH, seed=38),
        # hymba-1.5b: the prefix fill, the training batch, a binding window
        _flash_case(device, B=1, S=128, T=128, **HYMBA_ATTN,
                    dtype=torch.bfloat16, seed=39),
        _flash_case(device, B=4, S=640, T=640, **HYMBA_ATTN,
                    dtype=torch.bfloat16, seed=40),
        _flash_case(device, B=1, S=1536, T=1536, **HYMBA_ATTN,
                    dtype=torch.bfloat16, seed=41),
        # internvl2-1b: the prefill chunk (256 + 512), the training batch,
        # f32; musicgen-medium: the prefill chunk, the training batch
        _flash_case(device, B=1, S=768, T=768, **INTERNVL2_ATTN,
                    dtype=torch.bfloat16, seed=42),
        _flash_case(device, B=4, S=768, T=768, **INTERNVL2_ATTN,
                    dtype=torch.bfloat16, seed=43),
        _flash_case(device, B=1, S=300, T=300, **INTERNVL2_ATTN,
                    dtype=torch.float32, seed=44),
        _flash_case(device, B=1, S=512, T=512, **MUSICGEN_ATTN,
                    dtype=torch.bfloat16, seed=45),
        _flash_case(device, B=4, S=512, T=512, **MUSICGEN_ATTN,
                    dtype=torch.bfloat16, seed=46),
        # gemma2-27b's prefill chunk: a local layer (the window binds) and
        # a global one, and in f32 with S across 4,096; command-r-35b's
        # (G = 8) in bf16 and f32
        _flash_case(device, B=1, S=GEMMA2_CHUNK, T=GEMMA2_CHUNK,
                    **GEMMA2_ATTN, window=GEMMA2_WINDOW,
                    dtype=torch.bfloat16, seed=47),
        _flash_case(device, B=1, S=GEMMA2_CHUNK, T=GEMMA2_CHUNK,
                    **GEMMA2_ATTN, dtype=torch.bfloat16, seed=48),
        _flash_case(device, B=1, S=4200, T=4200, **GEMMA2_ATTN,
                    window=GEMMA2_WINDOW, dtype=torch.float32, seed=49),
        _flash_case(device, B=1, S=512, T=512, **COMMANDR_ATTN,
                    dtype=torch.bfloat16, seed=50),
        _flash_case(device, B=1, S=300, T=300, **COMMANDR_ATTN,
                    dtype=torch.float32, seed=51),
    ]
    paged = [
        # granite-3-2b decode: ragged lens incl. 0, 1 and a page crossing
        _paged_case(device, lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=32,
                    Hkv=8, D=64, ps=16, TW=35, dtype=torch.bfloat16),
        # window 16 with lens far beyond it: the ring wraps, f32, softcap
        _paged_case(device, lens=[50, 33, 17, 200], Hq=8, Hkv=2, D=128,
                    ps=4, TW=5, dtype=torch.float32, window=16, cap=30.0,
                    seed=1),
        # stablelm-12b decode (head_dim 160 on a pool padded to 192)
        _paged_case(device, lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=32,
                    Hkv=8, D=160, ps=16, TW=35, dtype=torch.bfloat16, seed=2),
    ] + [_paged_case(device, lens=[3, 40, 129, 77], Hq=8, Hkv=2, D=D, ps=16,
                     TW=9, dtype=dt, window=w, cap=cap, seed=3 + D)
         for D in ODD_DIMS
         for dt, w, cap in ((torch.bfloat16, None, 0.0),
                            (torch.float32, 50, 30.0))] + [
        _paged_case(device, **c) for c in PAGED_SPLIT_CASES] + [
        # the cluster's fixed-order combine: two launches, the same bits
        _paged_repeat_case(device, lens=[0, 1, 17, 16, 100, 300, 543, 560],
                           Hq=32, Hkv=8, D=64, ps=16, TW=35, seed=4),
        _paged_repeat_case(device, lens=[300, 75, 41, 9], Hq=8, Hkv=2, D=192,
                           ps=8, TW=9, window=40, cap=30.0, seed=5),
        # qwen2-moe-a2.7b decode: G = 1 at head_dim 128, the lens edges
        # above, against the plain version and twice to the bit
        _paged_case(device, **QWEN2_MOE_PAGED, dtype=torch.bfloat16, seed=6),
        _paged_repeat_case(device, **QWEN2_MOE_PAGED, seed=7),
        # hymba-1.5b decode: G = 5, window 1024, lens across it (the ring
        # wraps at TW 65), in bf16 and f32, and twice to the bit
        _paged_case(device, **HYMBA_PAGED, dtype=torch.bfloat16, seed=8),
        _paged_case(device, **HYMBA_PAGED, dtype=torch.float32, seed=9),
        _paged_repeat_case(device, **HYMBA_PAGED, seed=10),
        # internvl2-1b decode (G = 7) in bf16 and f32, musicgen-medium's
        # (G = 1, head_dim 64); each twice to the bit
        _paged_case(device, **INTERNVL2_PAGED, dtype=torch.bfloat16, seed=11),
        _paged_case(device, **INTERNVL2_PAGED, dtype=torch.float32, seed=12),
        _paged_repeat_case(device, **INTERNVL2_PAGED, seed=13),
        _paged_case(device, **MUSICGEN_PAGED, dtype=torch.bfloat16, seed=14),
        _paged_repeat_case(device, **MUSICGEN_PAGED, seed=15),
        # gemma2-27b decode, lens across 4,096 at TW 370: a local layer
        # (window 4096) in bf16 and f32, a global one, and twice to the
        # bit; command-r-35b's (G = 8) in bf16 and f32 and twice
        _paged_case(device, **GEMMA2_PAGED, window=GEMMA2_WINDOW,
                    dtype=torch.bfloat16, seed=16),
        _paged_case(device, **GEMMA2_PAGED, window=GEMMA2_WINDOW,
                    dtype=torch.float32, seed=17),
        _paged_case(device, **GEMMA2_PAGED, dtype=torch.bfloat16, seed=18),
        _paged_repeat_case(device, **GEMMA2_PAGED, window=GEMMA2_WINDOW,
                           seed=19),
        _paged_case(device, **COMMANDR_PAGED, dtype=torch.bfloat16, seed=20),
        _paged_case(device, **COMMANDR_PAGED, dtype=torch.float32, seed=21),
        _paged_repeat_case(device, **COMMANDR_PAGED, seed=22),
    ]
    P_train = -(-train_param_count(train_config()) // ALIGN) * ALIGN
    sync = [_sync_case(device, K=K, I=I, full=full, P=3 * ALIGN,
                       seed=10 * K + I)
            for K in (1, 2, 3, 4) for I in (1, 3) for full in (0.0, 1.0)]
    # the training runs' packed sizes (K = 2, I = 3): phase 7's, then
    # phase 11's granite-moe-1b-a400m
    sync.insert(0, _sync_case(device, K=2, I=3, full=1.0, P=P_train, seed=1))
    torch.cuda.empty_cache()
    sync.append(_sync_case(device, K=2, I=3, full=1.0, P=-(-train_param_count(
        moe_train_config()) // ALIGN) * ALIGN, seed=3))
    torch.cuda.empty_cache()
    # phase 12c's packed sizes: xlstm-125m and hymba-1.5b at 16 layers
    # and phase 13d's: internvl2-1b and musicgen-medium at 24 layers
    for seed, cfg in ((4, get_config("xlstm-125m")),
                      (5, get_config("hymba-1.5b").with_(
                          n_layers=HYMBA_TRAIN_LAYERS)),
                      (6, get_config("internvl2-1b")),
                      (7, get_config("musicgen-medium").with_(
                          n_layers=MUSICGEN_TRAIN_LAYERS))):
        sync.append(_sync_case(device, K=2, I=3, full=1.0, P=-(
            -train_param_count(cfg) // ALIGN) * ALIGN, seed=seed))
        torch.cuda.empty_cache()
    slice3 = {}
    for kernel in ("wa_window_update", "online_mean", "wa_window_update_c",
                   "wa_sync_fused_c"):
        cases = [_wa_case(device, kernel, P=P_train, seed=2)]
        torch.cuda.empty_cache()
        Ks = (1, 2, 3, 4) if kernel in ("online_mean", "wa_sync_fused_c") \
            else (2,)
        Is = (1,) if kernel == "online_mean" else (1, 3)
        fulls = (1.0,) if kernel == "online_mean" else (0.0, 1.0)
        cases += [_wa_case(device, kernel, K=K, I=I, full=full, P=3 * ALIGN,
                           seed=100 * K + 10 * I + int(full))
                  for K in Ks for I in Is for full in fulls]
        if kernel == "online_mean":
            cases += [_wa_case(device, kernel, K=K, P=3 * ALIGN,
                               stack_dtype=torch.bfloat16, seed=K)
                      for K in (1, 2, 3)]
            cases.append(_wa_case(device, kernel, K=2, P=3 * ALIGN,
                                  inv_k=0.125, seed=9))
            cases.append(_leaf_case(device))
        slice3[kernel] = cases
    bwd = [
        # the training shape, through the wrappers the model calls
        _bwd_case(device, B=4, S=512, Hq=32, Hkv=8, D=64,
                  dtype=torch.bfloat16, through_ops=True),
        _bwd_case(device, B=4, S=512, Hq=32, Hkv=8, D=64,
                  dtype=torch.bfloat16),
        # ragged S (not a tile multiple), f32
        _bwd_case(device, B=2, S=300, Hq=8, Hkv=2, D=64,
                  dtype=torch.float32, seed=1),
        # queries past a window's key horizon: fully-masked rows
        _bwd_case(device, B=1, S=192, T=64, Hq=4, Hkv=2, D=64,
                  dtype=torch.float32, window=16, seed=3),
        # softcap 30, head_dim 128, bf16
        _bwd_case(device, B=2, S=256, Hq=8, Hkv=4, D=128,
                  dtype=torch.bfloat16, window=64, cap=30.0, seed=2),
    ] + [_bwd_case(device, B=2, S=S, Hq=Hq, Hkv=Hkv, D=D, dtype=dt,
                   window=w, cap=cap, seed=i, through_ops=True)
         for i, (S, Hq, Hkv, D, w, cap, dt) in enumerate(GRAD_MATRIX)] \
        + _bf16_edge_cases(_bwd_case, device) + [
        # head dims that are not instances, through the model's wrapper
        _bwd_case(device, B=2, S=S, Hq=8, Hkv=2, D=D, dtype=dt, window=w,
                  cap=cap, seed=40 + D, through_ops=True)
        for D in ODD_DIMS
        for S, dt, w, cap in ((256, torch.bfloat16, None, 0.0),
                              (200, torch.float32, 48, 20.0))] + [
        # head_dim 192: two-warpgroup dk/dv, fully-masked rows get dq = 0
        _bwd_case(device, B=1, S=192, T=64, Hq=4, Hkv=2, D=192,
                  dtype=torch.bfloat16, window=16, seed=45),
        _bwd_case(device, B=2, S=300, Hq=8, Hkv=2, D=192,
                  dtype=torch.bfloat16, cap=30.0, seed=46),
        _bwd_case(device, B=1, S=192, T=64, Hq=4, Hkv=2, D=192,
                  dtype=torch.float32, window=16, seed=47),
        _dkv_repeat_case(device, B=2, S=256, Hq=8, Hkv=2, D=192, seed=48),
    ] + [
        # the cluster's fixed-order sums: two launches, the same bits
        _dkv_repeat_case(device, B=4, S=512, Hq=32, Hkv=8, D=64, seed=5),
        _dkv_repeat_case(device, B=2, S=300, Hq=32, Hkv=4, D=64, window=100,
                         cap=30.0, seed=6),
        # granite-moe-1b-a400m's training shape (phase 11c), through the
        # wrappers the model calls, and dk/dv twice to the bit
        _bwd_case(device, **MOE_TRAIN_ATTN, dtype=torch.bfloat16,
                  through_ops=True, seed=7),
        _dkv_repeat_case(device, **MOE_TRAIN_ATTN, seed=8),
        # hymba-1.5b's training batch (phase 12c): G = 5 (a dk/dv cluster
        # of 5), window 1024, through the model's wrappers and directly,
        # and dk/dv twice to the bit
        _bwd_case(device, B=4, S=640, **HYMBA_ATTN, dtype=torch.bfloat16,
                  through_ops=True, seed=9),
        _bwd_case(device, B=4, S=640, **HYMBA_ATTN, dtype=torch.bfloat16,
                  seed=10),
        _dkv_repeat_case(device, B=4, S=640, **HYMBA_ATTN, seed=11),
        # internvl2-1b's training batch (13d): G = 7 (a dk/dv cluster of
        # 7), directly, through the wrappers and in f32, dk/dv twice to
        # the bit; musicgen-medium's (G = 1 at head_dim 64)
        _bwd_case(device, B=4, S=768, **INTERNVL2_ATTN, dtype=torch.bfloat16,
                  seed=12),
        _bwd_case(device, B=4, S=768, **INTERNVL2_ATTN, dtype=torch.bfloat16,
                  through_ops=True, seed=13),
        _bwd_case(device, B=1, S=300, **INTERNVL2_ATTN, dtype=torch.float32,
                  seed=14),
        _dkv_repeat_case(device, B=4, S=768, **INTERNVL2_ATTN, seed=15),
        _bwd_case(device, B=4, S=512, **MUSICGEN_ATTN, dtype=torch.bfloat16,
                  through_ops=True, seed=16),
        _dkv_repeat_case(device, B=4, S=512, **MUSICGEN_ATTN, seed=17),
        # command-r-35b's G = 8 (a dk/dv cluster of 8, its largest):
        # directly, through the wrappers, in f32, and dk/dv twice
        _bwd_case(device, B=1, S=512, **COMMANDR_ATTN, dtype=torch.bfloat16,
                  seed=18),
        _bwd_case(device, B=1, S=512, **COMMANDR_ATTN, dtype=torch.bfloat16,
                  through_ops=True, seed=19),
        _bwd_case(device, B=1, S=300, **COMMANDR_ATTN, dtype=torch.float32,
                  seed=20),
        _dkv_repeat_case(device, B=1, S=512, **COMMANDR_ATTN, seed=21),
    ]
    result = {"flash_fwd": flash, "paged_attention": paged,
              "wa_sync_fused": sync, "flash_bwd": bwd, **slice3}
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
                prompt_range=(64, 512), seed=0, setup=None):
    """Serve ``n_requests`` random prompts through PagedDecodeEngine and
    ContinuousScheduler. On the card the kernels' launch counts must equal
    n_layers x admissions (flash) and n_layers x decode steps (paged).
    ``setup(engine)``, when given, runs on the built engine first (phase
    9c publishes W̿ into it there); the result carries the tokens."""
    dev = torch.device(device)
    cfg = cfg or get_config("granite-3-2b").with_(attn_impl="flash_pallas")
    lm = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    params = lm.init(gen, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    init_peak = (torch.cuda.max_memory_allocated(dev) / 2**30
                 if dev.type == "cuda" else None)
    eng = PagedDecodeEngine(lm=lm, params=params, max_batch=max_batch,
                            max_seq_len=max_seq_len, max_new=max_new,
                            page_size=page_size, prefill_chunk=prefill_chunk,
                            device=dev)
    if setup is not None:
        setup(eng)
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
    _reset_counts()
    t0 = time.perf_counter()
    outs = ContinuousScheduler(eng).run(reqs)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _counts()

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
    # the head_dim the kernels run at: the pool's (padded where the paged
    # kernel runs, kernels/head_dim.py); the flash wrapper pads to the same
    pool_d = eng.state["caches"][0]["pages"]["k"].shape[-1]
    if dev.type == "cuda":
        want = _want(flash_fwd=cfg.n_layers * admissions,
                     paged_attention=cfg.n_layers * steps)
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
        if pool_d != padded_head_dim(cfg.resolved_head_dim):
            raise AssertionError(f"pool head_dim {pool_d} is not the kernel "
                                 f"instance of {cfg.resolved_head_dim}")

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
        "prompt_lens": lens.tolist(), "arch": cfg.name,
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.resolved_head_dim, "kernel_head_dim": pool_d,
        "table_width": eng.table_width, "params": n_params,
        "init_peak_gib": init_peak, "outputs": toks,
    }
    print(f"[serve] {cfg.name} L{cfg.n_layers} d{cfg.d_model} "
          f"H{cfg.n_heads}/{cfg.n_kv_heads} hd{cfg.resolved_head_dim} (kernels "
          f"and pool at {pool_d}) ff{cfg.d_ff} V{cfg.vocab_size} "
          f"{cfg.dtype} on {dev}: {n_requests} requests, {max_batch} slots, "
          f"{admissions} admissions ({res['mid_run_admissions']} mid-run), "
          f"{steps} decode steps, launches {launches}; {n_params} "
          f"parameters ({n_params / 1e9:.3f}B), init peak {init_peak} GiB")
    print(f"[serve] {cfg.name}: prefill {res['prefill_tok_s']:.1f} tok/s, decode "
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
    # the device's events only (a CPU op's time repeats its kernels'),
    # read raw: ``key_averages`` spends seconds building its event tree
    busy, launches, rows, _ = _trace_stats(prof)
    return wall, busy, launches, rows


def _report_trace(label, n, untraced_ms, wall, busy, launches, rows, top=6):
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
    for name, ms, calls in rows[:top]:
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
    dstats = _profile(lambda: steps(n_steps), dev)
    _report_trace(f"decode step ({eng.max_batch} active)", n_steps,
                  serve["median_step_ms"], *dstats)
    return stats, dstats


# --------------------------------------------------------- 5. reference

#: max |logit(kernel path) - logit(plain path)| allowed at 2 layers, bf16
REF_LOGIT_TOL = 0.1


def phase_reference(device, n_layers=2, prompt_len=300, seed=0,
                    arch="granite-3-2b", dtype=None, gate_logits=True,
                    chunk=512):
    """Full-width ``arch`` cut to ``n_layers``: one prefill chunk of
    ``chunk`` tokens (``prompt_len`` of them real) and one
    decode step (of the plain path's greedy token) through the kernels
    against the plain path (naive prefill attention, gather-reference
    decode) on the same weights and inputs, in the config's dtype or
    ``dtype``. In bf16 the two paths round differently, so the logits
    agree to REF_LOGIT_TOL, not bitwise, and the greedy tokens must be
    equal or the plain path's logit of the kernel path's token within
    REF_LOGIT_TOL of its own largest (a tie at rounding). In f32 every
    logit must be within the f32 flash tolerance and the greedy tokens
    equal. ``gate_logits=False`` reports the bf16 logits' distance
    without failing on it (phase 11b: the MoE router turns bf16 rounding
    into other experts, and the f32 run is the gate)."""
    dev = torch.device(device)
    base = get_config(arch).with_(n_layers=n_layers)
    base = base.with_(dtype=dtype) if dtype else base
    f32 = base.dtype == "float32"
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = build_model(base).init(gen, device=dev)
    rs = np.random.RandomState(seed)
    ps, B = 16, 2
    TW = chunk // ps + 3
    tokens = np.zeros((1, chunk), np.int64)
    tokens[0, :prompt_len] = rs.randint(0, base.vocab_size, prompt_len)
    tables = np.zeros((B, TW), np.int32)
    tables[1, :] = np.arange(1, TW + 1)
    tables_t = torch.as_tensor(tables, device=dev)
    logits, greedy = {}, None
    for impl in ("naive", "flash_pallas"):
        cfg = base.with_(attn_impl=impl)
        caches = build_model(cfg).init_paged_cache(B, 1 + B * TW, ps,
                                                   device=dev)
        pl, caches = lm_paged_prefill_chunk(
            cfg, params, caches, {"tokens": torch.as_tensor(tokens,
                                                            device=dev)},
            prompt_len, 1, tables_t, ps)
        greedy = int(pl.argmax()) if greedy is None else greedy
        tok = torch.tensor([0, greedy], device=dev)
        pos = torch.tensor([0, prompt_len], dtype=torch.int32, device=dev)
        dl, _ = lm_paged_decode_step(cfg, params, caches, tok, pos, tables_t,
                                     ps)
        logits[impl] = (pl[0], dl[1])
    del params
    pairs = list(zip(logits["flash_pallas"], logits["naive"]))
    errs = [float((a - b).abs().max()) for a, b in pairs]
    scale = float(logits["naive"][0].abs().max())
    tokens_ok = []
    for got, want in pairs:
        g, w = int(got.argmax()), int(want.argmax())
        tokens_ok.append(g == w or (not f32 and float(want[w] - want[g])
                                    <= REF_LOGIT_TOL))
    if f32:
        tol = FLASH_TOL[torch.float32]
        logits_ok = all(_close(a, b, tol)[1] for a, b in pairs)
        rule = f"each within {tol} + {tol}|logit|"
    else:
        tol = REF_LOGIT_TOL
        logits_ok = max(errs) <= tol or not gate_logits
        rule = f"tol {tol}{'' if gate_logits else ', reported, not gated'}"
    ok = logits_ok and all(tokens_ok) and all(
        bool(torch.isfinite(t).all()) for t in logits["flash_pallas"])
    print(f"[reference] {arch} cut to {n_layers} layers, {base.dtype}, "
          f"prompt {prompt_len} in a chunk of {chunk}: kernel "
          f"path vs plain path max |dlogit| prefill {errs[0]:.5g}, decode "
          f"{errs[1]:.5g} ({rule}; max |logit| {scale:.3f}); greedy tokens "
          f"prefill, decode {[int(t.argmax()) for t, _ in pairs]} vs "
          f"{[int(t.argmax()) for _, t in pairs]} (equal"
          f"{'' if f32 else ' or tied within the tol'}: {tokens_ok}): "
          f"{'pass' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("kernel path disagrees with the plain path")
    return errs


# ------------------------------------------------------------- 7. train

#: the training run: full-width granite-3-2b cut from 40 to TRAIN_LAYERS
#: layers (at 40 the HWA state — K bf16 replicas, f32 momentum, the f32
#: ring of I slots and total, the (K, P) f32 pack at sync — needs ~130 GB).
#: lr 0.1 is a hand choice, not the result of a sweep.
TRAIN_LAYERS = 8
TRAIN = dict(K=2, H=2, I=3, batch=4, seq=512, steps=10, n_train=64,
             n_test=8, lr=0.1)


def train_config(n_layers=TRAIN_LAYERS):
    return get_config("granite-3-2b").with_(n_layers=n_layers,
                                            attn_impl="flash_pallas",
                                            remat="full")


#: phase 11c: full-width granite-moe-1b-a400m cut from 24 to 12 layers
#: (742.8M parameters; at 24, 1.385B, phase 7's ~50 bytes a parameter of
#: HWA state leave too little of the card for the activations)
MOE_TRAIN_LAYERS = 12


def moe_train_config(n_layers=MOE_TRAIN_LAYERS):
    return get_config("granite-moe-1b-a400m").with_(
        n_layers=n_layers, attn_impl="flash_pallas", remat="full")


def _train_setup(device, cfg, *, steps=None, seed=0, n_train=None,
                 replicas=None, **tc_kw):
    """The HWA trainer of the training phase: the port's Markov dataset at
    the model's vocabulary (built first, so its V x V transition matrix is
    gone before the model state exists), K replicas of batch x seq tokens,
    SGD (momentum 0.9, weight decay 5e-4, cosine schedule). ``tc_kw``
    replaces fields of its TrainConfig (another method, checkpoints)."""
    ds = make_markov_lm_dataset(vocab=cfg.vocab_size, seq_len=TRAIN["seq"],
                                n_train=n_train or TRAIN["n_train"],
                                n_test=TRAIN["n_test"], seed=seed,
                                device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    K = replicas or TRAIN["K"]
    pipe = DataPipeline(ds, batch_size=TRAIN["batch"], n_replicas=K,
                        seed=seed)
    tc = TrainConfig(method="hwa", total_steps=steps or TRAIN["steps"],
                     batch_size=TRAIN["batch"], base_lr=TRAIN["lr"],
                     momentum=0.9, weight_decay=5e-4, seed=seed,
                     hwa=HWAConfig(n_replicas=K, sync_period=TRAIN["H"],
                                   window=TRAIN["I"], use_kernels=True))
    tc = dataclasses.replace(tc, **tc_kw)
    return Trainer(lm_task(build_model(cfg), pipe, device=device, seed=seed),
                   tc)


def _probe_loss(trainer, params, batches) -> float:
    """Mean loss of ``params`` over ``batches`` of (inputs, targets)."""
    return float(np.mean([float(trainer._eval_batch(params, i, t)[0])
                          for i, t in batches]))


def _rel_change(leaves, prev_host) -> float:
    """||W - W_prev|| / ||W_prev|| over all leaves, in f32, one leaf on
    the device at a time."""
    num = den = 0.0
    for x, p in zip(leaves, prev_host):
        p = p.to(x.device).float()
        num += float((x.float() - p).square().sum())
        den += float(p.square().sum())
    return (num / den) ** 0.5


def _attention_layers(cfg) -> int:
    """Layers that run attention (every layer but xlstm's)."""
    return 0 if cfg.family == "ssm" else cfg.n_layers


def phase_train(device, cfg=None, full_layers=40):
    """HWA training of full-width granite-3-2b (depth cut to TRAIN_LAYERS
    of ``full_layers``; phase 11c passes granite-moe-1b-a400m's ``cfg``)
    through ``Trainer.run``: K replicas, a fused sync every H steps, W̿
    evaluated at every sync. The loss and the router loss must be finite
    at every step and the loss fall, W̿ must change at every sync and its
    loss on training sequences must fall, and the kernels' launch counts
    must be exact."""
    dev = torch.device(device)
    cfg = cfg or train_config()
    trainer = _train_setup(dev, cfg)
    step_clock, sync_clock = _Clock(dev), _Clock(dev)
    losses, auxes = [], []
    hwa_step, sync_step = trainer._hwa_step, trainer._sync_step
    timed_step, timed_sync = step_clock.wrap(hwa_step), \
        sync_clock.wrap(sync_step)

    def logged_step(state, step):
        state, m = timed_step(state, step)
        losses.append(m["per_replica_loss"])
        auxes.append(m["aux"])
        return state, m

    # W̿ is also evaluated on training sequences (replica 0's batches of
    # steps 0-1), and its change from the previous sync is measured: a W̿
    # that learns shows a falling train-probe loss whatever the test loss
    # does. Both run outside the clocks; the previous W̿ waits on the host
    # so that it adds nothing to the device's peak.
    pipe = trainer.task.pipeline
    probe = [pipe.replica_batch(0, s) for s in range(TRAIN["H"])]
    init = trainer.task.init()
    wa_probe = {"init_test": trainer.evaluate(init)["test_loss"],
                "init_train": _probe_loss(trainer, init, probe),
                "train": [], "rel_change": [], "prev": None}
    del init

    def checked_sync(state):
        state, m = timed_sync(state)
        wa_probe["state"] = state
        wa_probe["train"].append(_probe_loss(trainer, state.wa, probe))
        leaves = tree_leaves(state.wa)
        if wa_probe["prev"] is not None:
            wa_probe["rel_change"].append(_rel_change(leaves,
                                                      wa_probe["prev"]))
        wa_probe["prev"] = [x.detach().to("cpu") for x in leaves]
        return state, m

    trainer._hwa_step, trainer._sync_step = logged_step, checked_sync
    n_eval_batches = len(list(pipe.eval_batches()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    _reset_counts()
    t0 = time.perf_counter()
    out = trainer.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _counts()
    # the trace phase reuses the trainer: without the clocks and probes
    trainer._hwa_step, trainer._sync_step = hwa_step, sync_step
    # phase 9c publishes the run's W̿ from its window state: kept on the
    # host meanwhile, off the device phase 8 measures
    final_window = tree_map(lambda x: x.to("cpu"),
                            wa_probe.pop("state").window_state)

    K, H, steps = TRAIN["K"], TRAIN["H"], TRAIN["steps"]
    syncs = steps // H
    per_step = torch.stack(losses).float().cpu()          # (steps, K)
    if not bool(torch.isfinite(per_step).all()):
        raise AssertionError(f"non-finite training loss: {per_step}")
    step_aux = torch.stack(auxes).float().cpu()           # replica mean
    if not bool(torch.isfinite(step_aux).all()):
        raise AssertionError(f"non-finite router loss: {step_aux}")
    step_loss = per_step.mean(1).tolist()
    first, last = float(np.mean(step_loss[:2])), float(np.mean(step_loss[-2:]))
    if not last < first:
        raise AssertionError(f"loss did not fall: first two {first:.4f}, "
                             f"last two {last:.4f}")
    L = cfg.n_layers
    La = _attention_layers(cfg)
    evals = (len(out["history"]) + 1) * n_eval_batches   # + final evaluate
    evals += syncs * len(probe)                           # W̿ train probe
    want = _want(flash_fwd=steps * K * La * 2 + evals * La,
                 wa_sync_fused=syncs, flash_bwd_dq=steps * K * La,
                 flash_bwd_dkv=steps * K * La)
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if len(out["history"]) != syncs or not all(
            np.isfinite(h["test_loss"]) for h in out["history"]):
        raise AssertionError(f"W̿ evaluations: {out['history']}")
    wa_train, wa_change = wa_probe["train"], wa_probe["rel_change"]
    if not (all(c > 0 for c in wa_change) and len(wa_change) == syncs - 1):
        raise AssertionError(f"W̿ did not change at every sync: {wa_change}")
    if not (np.isfinite(wa_train).all() and wa_train[-1] < wa_train[0]
            and wa_train[-1] < wa_probe["init_train"]):
        raise AssertionError(f"W̿'s loss on training sequences did not fall: "
                             f"init {wa_probe['init_train']}, per sync "
                             f"{wa_train}")

    step_ms, sync_ms = step_clock.ms(), sync_clock.ms()
    n_params = train_param_count(cfg)
    n_matmul = train_matmul_param_count(cfg)
    tokens = K * TRAIN["batch"] * TRAIN["seq"]
    # positions a step computes: the tokens and any meta-token prefix
    positions = K * TRAIN["batch"] * (TRAIN["seq"] + cfg.n_meta_tokens)
    med_step = float(np.median(step_ms))
    res = {
        "layers": L, "params": n_params, "steps": steps, "syncs": syncs,
        "launches": launches, "step_loss": step_loss,
        "step_aux": step_aux.tolist(),
        "wa_test_loss": [h["test_loss"] for h in out["history"]],
        "init_test_loss": wa_probe["init_test"],
        "init_train_probe_loss": wa_probe["init_train"],
        "wa_train_probe_loss": wa_train, "wa_rel_change": wa_change,
        "median_step_ms": med_step, "step_ms": step_ms,
        "tokens_per_step": tokens, "tok_s": tokens / (med_step / 1e3),
        "mfu": 6 * n_matmul * positions / (med_step / 1e3) / PEAK_FLOPS[
            torch.bfloat16], "matmul_params": n_matmul,
        "median_sync_ms": float(np.median(sync_ms)), "sync_ms": sync_ms,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else float("nan")),
        "wall_s": wall, "lr": TRAIN["lr"],
        # for phase 8: the per-replica losses and the final W̿ (host)
        "per_step_loss": per_step.tolist(), "final_wa": wa_probe["prev"],
        "final_window": final_window,
    }
    moe = (f" E{cfg.n_experts} top-{cfg.top_k} expert ff"
           f"{cfg.expert_d_ff}" if cfg.family == "moe" else "")
    print(f"[train] {cfg.name} L{L} (cut from {full_layers}) d{cfg.d_model} "
          f"H{cfg.n_heads}/{cfg.n_kv_heads} ff{cfg.d_ff}{moe} "
          f"V{cfg.vocab_size} "
          f"bf16 remat=full, {n_params / 1e6:.1f}M params: HWA K{K} H{H} "
          f"I{TRAIN['I']} fused sync, SGD lr {TRAIN['lr']} m0.9 wd5e-4 "
          f"cosine, {TRAIN['batch']}x{TRAIN['seq']} tokens per replica, "
          f"{steps} steps, {syncs} syncs, launches {launches}")
    print(f"[train] loss per step {[round(x, 4) for x in step_loss]} "
          f"(first two {first:.4f} -> last two {last:.4f})")
    if cfg.family == "moe":
        print(f"[train] router loss per step (summed over layers, replica "
              f"mean) {[round(x, 4) for x in res['step_aux']]}")
    print(f"[train] W̿ per sync: test loss "
          f"{[round(x, 4) for x in res['wa_test_loss']]} (init "
          f"{wa_probe['init_test']:.4f}), loss on training sequences "
          f"{[round(x, 4) for x in wa_train]} (init "
          f"{wa_probe['init_train']:.4f}), ||dW̿||/||W̿|| from the previous "
          f"sync {[float(f'{x:.4g}') for x in wa_change]}")
    print(f"[train] median inner step {med_step:.3f} ms (K={K} replicas, "
          f"{tokens} tokens, {positions} positions), {res['tok_s']:.1f} "
          f"tok/s, mfu {res['mfu']:.4f} (6*N*positions over 989 TFLOP/s, "
          f"N = the "
          f"{n_matmul / 1e6:.1f}M parameters a token's products touch), "
          f"median sync "
          f"{res['median_sync_ms']:.3f} ms, peak memory "
          f"{res['peak_mem_gib']:.3f} GiB, wall {wall:.2f} s | {CARD['line']}")
    return res, trainer


def phase_train_trace(device, trainer, train):
    """torch.profiler over 2 inner steps and 1 sync of the training run's
    model (a fresh HWA state from its final W̿): device busy, idle share
    against the untraced medians, top kernels."""
    dev = torch.device(device)
    params = trainer.task.init()
    state = hwa_init(trainer.hwa_cfg, params, trainer.optimizer)
    del params
    state, _ = trainer._hwa_step(state, 0)             # warm
    box = {"state": state}

    def work():
        st, _ = trainer._hwa_step(box["state"], 1)
        st, _ = trainer._hwa_step(st, 2)
        box["state"], _ = trainer._sync_step(st)

    stats = _profile(work, dev)
    untraced = 2 * train["median_step_ms"] + train["median_sync_ms"]
    _report_trace("train (2 inner steps + 1 sync)", 1, untraced, *stats,
                  top=12)
    del box, state
    return stats


# ------------------------------------------------------------ 8. windows

#: phase 8's runs: (name, ring dtype, window_stride, through Trainer.run)
WINDOW_RUNS = (("8a", torch.bfloat16, 1, False),
               ("8b", torch.float32, 2, True),
               ("8c", torch.bfloat16, 2, False))
#: benchmarks/thresholds.json ulp_budgets: a compressed ring's W̿ within
#: 4 ULPs of its dtype (``rel_ulp_error``) of the f32 ring's
ULP_BUDGET = 4.0


def _window_run(device, trainer, train, name, ring_dtype, stride, via_run):
    """The training run under another window: ``trainer``'s model, data,
    optimizer and K/H/I, with ``window_stride`` and ``ring_dtype``. Runs
    through ``Trainer.run`` (``via_run``) or drives the trainer's step and
    sync on a state that ``hwa_init`` built with the ring dtype. Returns
    the run's record; raises if a gate fails."""
    dev = torch.device(device)
    K, H, steps = TRAIN["K"], TRAIN["H"], TRAIN["steps"]
    syncs = steps // H
    L = train["layers"]
    base_cfg, hwa_step, sync_step = trainer.hwa_cfg, trainer._hwa_step, \
        trainer._sync_step
    cfg = dataclasses.replace(base_cfg, window_stride=stride)
    trainer.hwa_cfg = cfg
    step_clock, sync_clock = _Clock(dev), _Clock(dev)
    timed_step, timed_sync = step_clock.wrap(hwa_step), \
        sync_clock.wrap(sync_step)
    losses, deltas = [], []
    init = trainer.task.init()
    names = _leaf_names(init)
    box = {"prev": [x.detach().to("cpu") for x in tree_leaves(init)]}
    del init

    def logged_step(state, step):
        state, m = timed_step(state, step)
        losses.append(m["per_replica_loss"])
        return state, m

    def checked_sync(state):
        # outside the clock: the ring's size, and W̿ against the last one
        state, m = timed_sync(state)
        ring = state.window_state.ring
        box["ring"] = (ring.numel(), ring.element_size())
        leaves = tree_leaves(state.wa)
        same = all(torch.equal(x, p.to(x.device))
                   for x, p in zip(leaves, box["prev"]))
        deltas.append((same, _rel_change(leaves, box["prev"])))
        box["prev"] = [x.detach().to("cpu") for x in leaves]
        return state, m

    trainer._hwa_step, trainer._sync_step = logged_step, checked_sync
    n_eval_batches = len(list(trainer.task.pipeline.eval_batches()))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    _reset_counts()
    t0 = time.perf_counter()
    if via_run:
        out = trainer.run()
        evals = (len(out["history"]) + 1) * n_eval_batches
        del out
    else:
        params = trainer.task.init()
        state = hwa_init(cfg, params, trainer.optimizer, ring_dtype=ring_dtype)
        del params
        for step in range(steps):
            state, _ = trainer._hwa_step(state, step)
            if (step + 1) % H == 0:
                state, _ = trainer._sync_step(state)
        del state
        evals = 0
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else float("nan"))
    trainer.hwa_cfg, trainer._hwa_step, trainer._sync_step = \
        base_cfg, hwa_step, sync_step
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    taken = [(c - 1) % stride == 0 for c in range(1, syncs + 1)]
    if stride == 1 and ring_dtype == torch.bfloat16:
        route, wa_counts = "_sync_fused_c", {"wa_sync_fused_c": syncs}
    else:
        update = "wa_window_update_c" if ring_dtype == torch.bfloat16 \
            else "wa_window_update"
        route = "two-launch"
        wa_counts = {"online_mean": syncs, update: sum(taken)}
    want = _want(flash_fwd=steps * K * L * 2 + evals * L,
                 flash_bwd_dq=steps * K * L, flash_bwd_dkv=steps * K * L,
                 **wa_counts)
    per_step = torch.stack(losses).float().cpu()
    step_loss = per_step.mean(1).tolist()
    first, last = np.mean(step_loss[:2]), np.mean(step_loss[-2:])
    fails = []
    if not bool(torch.isfinite(per_step).all()) or not last < first:
        fails.append(f"loss not finite or not falling: {step_loss}")
    if dev.type == "cuda" and launches != want:
        fails.append(f"launch counts {launches} != {want}")
    for c, ((same, rel), take) in enumerate(zip(deltas, taken), 1):
        if take and (same or not rel > 0):
            fails.append(f"W̿ did not change on taken cycle {c}")
        if not take and not same:
            fails.append(f"W̿ changed on skipped cycle {c} ({rel})")
    res = {"run": name, "ring_dtype": str(ring_dtype)[6:], "stride": stride,
           "route": route, "via_run": via_run, "launches": launches,
           "step_loss": step_loss, "taken": taken,
           "wa_unchanged": [d[0] for d in deltas],
           "wa_rel_change": [d[1] for d in deltas],
           "losses_bit_equal_to_phase7":
               per_step.tolist() == train["per_step_loss"],
           "median_sync_ms": float(np.median(sync_clock.ms())),
           "median_step_ms": float(np.median(step_clock.ms())),
           "peak_mem_gib": peak, "ring_bytes": box["ring"][0] * box["ring"][1],
           "ring_bytes_f32": box["ring"][0] * 4, "wall_s": wall}
    if name == "8a":
        # the bf16 ring's final W̿ against phase 7's f32 ring's, leaf by leaf
        errs = [rel_ulp_error(p7.to(dev), x.to(dev), "bf16")
                for p7, x in zip(train["final_wa"], box["prev"])]
        worst = int(np.argmax(errs))
        res["wa_rel_ulp_bf16"] = errs[worst]
        res["wa_rel_ulp_worst_leaf"] = (f"{names[worst]} "
                                        f"{str(box['prev'][worst].dtype)[6:]}")
        if not res["wa_rel_ulp_bf16"] <= ULP_BUDGET:
            fails.append(f"W̿ {res['wa_rel_ulp_bf16']} bf16 rel-ULP from "
                         f"phase 7's (budget {ULP_BUDGET})")
    print(f"[windows] {name}: {res['ring_dtype']} ring, stride {stride}, "
          f"{route} ({'Trainer.run' if via_run else 'hwa_init + steps'}): "
          f"loss per step {[round(x, 4) for x in step_loss]}, per-replica "
          f"losses bit-equal to phase 7: {res['losses_bit_equal_to_phase7']}"
          f"; per sync taken {taken}, W̿ unchanged {res['wa_unchanged']}, "
          f"||dW̿||/||W̿|| {[float(f'{x:.4g}') for x in res['wa_rel_change']]}"
          + (f"; final W̿ vs phase 7's {res['wa_rel_ulp_bf16']:.4f} bf16 "
             f"rel-ULP at {res['wa_rel_ulp_worst_leaf']} (budget "
             f"{ULP_BUDGET})" if name == "8a" else ""))
    print(f"[windows] {name}: launches {launches}; median sync "
          f"{res['median_sync_ms']:.3f} ms, median step "
          f"{res['median_step_ms']:.3f} ms, peak memory {peak:.3f} GiB, ring "
          f"{res['ring_bytes'] / 2**30:.3f} GiB ({res['ring_dtype']}; f32 "
          f"{res['ring_bytes_f32'] / 2**30:.3f} GiB), wall {wall:.2f} s | "
          f"{CARD['line']}")
    if fails:
        raise AssertionError(f"phase 8 run {name}: {fails}")
    return res


def phase_windows(device, trainer, train):
    """Phase 8: the training run under the three windows of WINDOW_RUNS,
    each run's state dropped before the next starts."""
    return {name: _window_run(device, trainer, train, name, dt, stride, run)
            for name, dt, stride, run in WINDOW_RUNS}


#: the kernel path against the plain path at 2 layers, bf16. Loss and
#: grads: the activations round to bf16 at different places on the two
#: attention paths (REF_LOSS_TOL absolute on the loss, REF_GRAD_TOL of the
#: largest |grad| of a leaf). W̿ after a step and a sync: the replicas'
#: steps differ as the grads do, and rounding the new weight may flip:
#: each element agrees to REF_WA_ULPS ULPs of its dtype plus REF_GRAD_TOL
#: of the largest step of its leaf.
REF_LOSS_TOL = 0.05
REF_GRAD_TOL = 0.05
REF_WA_ULPS = 2


def phase_train_reference(device, n_layers=2, seed=0):
    """The training model cut to ``n_layers``: loss and a few grad leaves
    of the kernel path (flash kernels, fused sync) against the plain path
    (naive attention, plain mean and window push) on the same weights and
    batches, then one HWA step plus one sync on each path and W̿."""
    from repro_torch.core.hwa import hwa_inner_step, hwa_sync
    dev = torch.device(device)
    base = train_config(n_layers)
    trainer = _train_setup(dev, base, steps=2)
    params = trainer.task.init()
    batch = trainer.task.pipeline.replica_batch(0, 0)
    batch = {"tokens": batch[0], "targets": batch[1]}
    loss, grads, wa_out = {}, {}, {}
    for name, impl, kern in (("kernel", "flash_pallas", True),
                             ("plain", "naive", False)):
        cfg = base.with_(attn_impl=impl)
        lm = build_model(cfg)
        leaves, treedef = tree_flatten(params)
        live = [x.detach().clone().requires_grad_(True) for x in leaves]
        l, _ = lm.loss(tree_unflatten(treedef, live), batch)
        g = torch.autograd.grad(l, live)
        loss[name] = float(l.detach())
        # embed, head, layer-0 wq and w_down: both ends and the middle
        names = ("embed", "head", "stack.0.attn.wq", "stack.0.mlp.w_down")
        flat_names = _leaf_names(params)
        grads[name] = {n: g[flat_names.index(n)].float() for n in names}
        hcfg = HWAConfig(n_replicas=TRAIN["K"], sync_period=1,
                         window=TRAIN["I"], use_kernels=kern)
        state = hwa_init(hcfg, params, trainer.optimizer)
        batches = trainer.task.pipeline.stacked_batch(0)
        state, _ = hwa_inner_step(
            hcfg, state, batches,
            lambda p, b, lm=lm: lm.loss(p, {"tokens": b[0], "targets": b[1]}),
            trainer.optimizer, trainer.schedule(0))
        state, _ = hwa_sync(hcfg, state)
        wa_out[name] = [x.detach() for x in tree_leaves(state.wa)]
        del state
    dloss = abs(loss["kernel"] - loss["plain"])
    grad_rel = {n: float((grads["kernel"][n] - grads["plain"][n]).abs().max()
                         / grads["plain"][n].abs().max())
                for n in grads["plain"]}
    wa_err = 0.0
    for a, b, w0 in zip(wa_out["kernel"], wa_out["plain"],
                        tree_leaves(params)):
        eps = torch.finfo(a.dtype).eps
        a, b = a.float(), b.float()
        beyond = torch.clamp((a - b).abs() - REF_WA_ULPS * eps * b.abs(),
                             min=0)
        step = torch.clamp((b - w0.float()).abs().max(), min=1e-30)
        wa_err = max(wa_err, float(beyond.max() / step))
    ok = (dloss <= REF_LOSS_TOL and max(grad_rel.values()) <= REF_GRAD_TOL
          and wa_err <= REF_GRAD_TOL and np.isfinite(loss["kernel"]))
    print(f"[train-reference] granite-3-2b cut to {n_layers} layers, bf16, "
          f"kernel path vs plain path: loss {loss['kernel']:.5f} vs "
          f"{loss['plain']:.5f} (|d| {dloss:.5f}, tol {REF_LOSS_TOL}); "
          f"grad max|d|/max|g| "
          f"{ {n: round(v, 5) for n, v in grad_rel.items()} } (tol "
          f"{REF_GRAD_TOL}); W̿ after 1 step + 1 sync: max|d| beyond "
          f"{REF_WA_ULPS} ULP {wa_err:.5f} of the leaf's step (tol "
          f"{REF_GRAD_TOL}): {'pass' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("training kernel path disagrees with the "
                             "plain path")
    routes = _window_routes(dev, trainer, build_model(base), params)
    return {"dloss": dloss, "grad_rel": grad_rel, "wa_err": wa_err,
            "window_routes": routes}


#: the 2-layer route check's W̿ limit, in ``rel_ulp_error`` units of the
#: window's dtype (bf16 for the streaming window, fp8 for the fp8 ring).
#: The routes feed the window the f32 mean and its bf16 rounding, less
#: than half a bf16 ULP apart, so a stored value (an fp8 slot, the
#: streaming window's bf16 W̿) may round one step apart: at most 1 ULP of
#: its dtype at its magnitude, plus 1/16 of an fp8 ULP for the bf16 cast
#: of the fp8 ring's W̿. A push that stores a zero W̄ (a lost slot or scale
#: row) reads 1 / (3 eps) at I = 3 slots, far above it.
ROUTE_ULP_LIMIT = 1.25


def _window_routes(dev, trainer, lm, params, syncs=3):
    """The streaming window and the fp8 ring at 2 layers: the kernel route
    (the online-mean kernel, then the plain update, as in the reference)
    against the plain route (the plain mean in the leaves' dtype and the
    plain update) over ``syncs`` steps and syncs on the same weights,
    batches and attention path. The plain route feeds the window the mean
    rounded to bf16, the kernel route the f32 mean, so W̿ agrees within
    ROUTE_ULP_LIMIT, and the replicas restart from the same bf16 mean on
    both routes: bit-equal. Two wrong pushes are read against the plain
    W̿ beside it, ungated: one that stored a zero W̄ ((syncs - 1) / syncs
    of the plain W̿, with ``syncs`` = I slots), and one that was dropped
    (the plain W̿ one sync earlier)."""
    from repro_torch.core.hwa import hwa_inner_step, hwa_sync
    K, I, L = TRAIN["K"], TRAIN["I"], lm.cfg.n_layers
    pipe = trainer.task.pipeline

    def loss(p, b):
        return lm.loss(p, {"tokens": b[0], "targets": b[1]})

    out = {}
    for kind, ring_dtype, unit in (("streaming", torch.float32, "bf16"),
                                   ("ring", torch.float8_e4m3fn, "fp8")):
        runs = {}
        for kern in (True, False):
            hcfg = HWAConfig(n_replicas=K, sync_period=1, window=I,
                             window_kind=kind, use_kernels=kern)
            state = hwa_init(hcfg, params, trainer.optimizer,
                             ring_dtype=ring_dtype)
            _reset_counts()
            for step in range(syncs):
                earlier = [x.detach().clone() for x in tree_leaves(state.wa)]
                state, _ = hwa_inner_step(hcfg, state,
                                          pipe.stacked_batch(step), loss,
                                          trainer.optimizer,
                                          trainer.schedule(step))
                state, _ = hwa_sync(hcfg, state)
            _sync(dev)
            runs[kern] = ([x.detach() for x in tree_leaves(state.wa)],
                          [x.detach() for x in tree_leaves(state.inner)],
                          _counts(), earlier)
            del state, earlier
        err = max(rel_ulp_error(p, k, unit)
                  for k, p in zip(runs[True][0], runs[False][0]))
        lost = max(rel_ulp_error(p, p.float() * ((syncs - 1) / syncs), unit)
                   for p in runs[False][0])
        dropped = max(rel_ulp_error(p, e, unit)
                      for p, e in zip(runs[False][0], runs[False][3]))
        same_inner = all(torch.equal(a, b)
                         for a, b in zip(runs[True][1], runs[False][1]))
        want = _want(flash_fwd=syncs * K * L * 2, flash_bwd_dq=syncs * K * L,
                     flash_bwd_dkv=syncs * K * L, online_mean=syncs)
        finite = all(bool(torch.isfinite(x).all()) for x in runs[True][0])
        ok = (err <= ROUTE_ULP_LIMIT and same_inner and finite
              and (dev.type != "cuda" or runs[True][2] == want))
        name = f"{kind} {str(ring_dtype)[6:]}"
        out[name] = {"wa_rel_ulp": err, "zero_push_rel_ulp": lost,
                     "dropped_push_rel_ulp": dropped, "unit": unit, "inner_bit_equal": same_inner,
                     "launches": runs[True][2], "pass": ok}
        print(f"[train-reference] {name} window, {syncs} steps + syncs: "
              f"kernel route (online_mean kernel + plain update) vs plain "
              f"route W̿ {err:.4f} {unit} rel-ULP (limit {ROUTE_ULP_LIMIT}; "
              f"a push of a zero W̄ reads {lost:.4f}, a dropped push "
              f"{dropped:.4f}), replicas bit-equal "
              f"{same_inner}, kernel-route launches {runs[True][2]}: "
              f"{'pass' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} window: kernel route disagrees "
                                 f"with the plain route")
    return out


# -------------------------------------------------------- 9. phase 9

#: 9a: phase 7's model, data and SGD with one replica; 2 steps an epoch
BASELINES = dict(methods=("ca", "swa", "ema", "lookahead", "sam"), steps=8,
                 n_train=2 * TRAIN["batch"], swa_start_frac=0.5,
                 lookahead_k=3, eval_every=4)
#: 9b: the same model cut to 1 layer, HWA with the fused sync, one save
#: (at step 6 of 8). Its file IO makes room for phase 15's time: the
#: second save, the bit flip and the fallback scan run in 15a/15d, on the
#: mesh-native checkpoints of the same session code
CKPT = dict(layers=1, steps=8, every=6, keep=2)


def _bits_equal(a, b) -> bool:
    """Two tensors equal to the bit (dtype, shape, bytes)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().reshape(-1).view(torch.uint8),
                       b.contiguous().reshape(-1).view(torch.uint8))


def _trees_bits_equal(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        _bits_equal(x.to("cpu"), y.to("cpu")) for x, y in zip(la, lb))


def _baseline_run(device, cfg, method):
    """One baseline through Trainer.run, its step and update timed with
    CUDA events, the launches of each step read, and the method's own
    gates checked (SWA's sample count, Lookahead's fast = slow)."""
    dev = torch.device(device)
    b = BASELINES
    trainer = _train_setup(dev, cfg, steps=b["steps"], n_train=b["n_train"],
                           replicas=1, method=method,
                           swa_start_frac=b["swa_start_frac"],
                           lookahead_k=b["lookahead_k"],
                           eval_every=b["eval_every"])
    spe = trainer.task.pipeline.steps_per_epoch
    if spe != 2:
        raise AssertionError(f"steps_per_epoch {spe} != 2")
    step_clock, upd_clock = _Clock(dev), _Clock(dev)
    timed_step = step_clock.wrap(trainer._single_step)
    losses, per_step = [], []
    log = {"swa_n": 0, "lookahead_ok": [], "updates": 0}

    def logged_step(params, opt_state, step):
        before = _counts()
        out = timed_step(params, opt_state, step)
        _sync(dev)
        after = _counts()
        per_step.append({k: after[k] - before[k] for k in after})
        losses.append(out[2])
        return out

    def wrap_update(name):
        timed = upd_clock.wrap(getattr(trainer, name))

        def update(state, params):
            out = timed(state, params)
            log["updates"] += 1
            if name == "_swa_update":
                log["swa_n"] = int(out.n)
            if name == "_lookahead_update":
                slow, fast = out[0].slow, out[1]
                log["lookahead_ok"].append(all(
                    _bits_equal(f, s.to(f.dtype)) for f, s in
                    zip(tree_leaves(fast), tree_leaves(slow))))
            return out
        return update

    trainer._single_step = logged_step
    for name in ("_swa_update", "_ema_update", "_lookahead_update"):
        setattr(trainer, name, wrap_update(name))
    n_eval = len(list(trainer.task.pipeline.eval_batches()))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    _reset_counts()
    t0 = time.perf_counter()
    out = trainer.run()
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _counts()

    loss = torch.stack(losses).float().cpu()
    fails = []
    if not bool(torch.isfinite(loss).all()):
        fails.append(f"non-finite loss {loss.tolist()}")
    first, last = float(loss[:2].mean()), float(loss[-2:].mean())
    if not last < first:
        fails.append(f"loss did not fall: {first:.4f} -> {last:.4f}")
    evals = [h["test_loss"] for h in out["history"]] + \
        [out["final"]["test_loss"]]
    if not np.isfinite(evals).all():
        fails.append(f"evaluated weights' loss not finite: {evals}")
    steps, L = b["steps"], cfg.n_layers
    swa_start = int(steps * b["swa_start_frac"])
    want_n = sum(1 for s in range(1, steps + 1)
                 if s > swa_start and s % spe == 0)
    if method == "swa" and log["swa_n"] != want_n:
        fails.append(f"SWA averaged {log['swa_n']} models, the rule says "
                     f"{want_n}")
    want_la = steps // b["lookahead_k"]
    if method == "lookahead" and (len(log["lookahead_ok"]) != want_la
                                  or not all(log["lookahead_ok"])):
        fails.append(f"lookahead fast != slow: {log['lookahead_ok']}")
    passes = 2 if method == "sam" else 1
    want = _want(flash_fwd=steps * passes * 2 * L
                 + (len(out["history"]) + 1) * n_eval * L,
                 flash_bwd_dq=steps * passes * L,
                 flash_bwd_dkv=steps * passes * L)
    if cuda and launches != want:
        fails.append(f"launch counts {launches} != {want}")
    step_ms = step_clock.ms()
    res = {"method": method, "loss": loss.tolist(), "evals": evals,
           "launches": launches, "step_launches": per_step[0],
           "median_step_ms": float(np.median(step_ms)), "step_ms": step_ms,
           "median_update_ms": (float(np.median(upd_clock.ms()))
                                if upd_clock.spans else None),
           "updates": log["updates"], "swa_n": log["swa_n"],
           "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                            if cuda else float("nan")),
           "wall_s": wall}
    upd = res["median_update_ms"]
    print(f"[baselines] {method}: loss {[round(x, 4) for x in res['loss']]} "
          f"({first:.4f} -> {last:.4f}), evaluated {[round(x, 4) for x in evals]}"
          f", median step {res['median_step_ms']:.3f} ms, "
          + (f"{log['updates']} updates, median {upd:.3f} ms, "
             if upd is not None else "")
          + f"peak memory {res['peak_mem_gib']:.3f} GiB, launches "
          f"{launches} | {CARD['line']}")
    del trainer, out
    if fails:
        raise AssertionError(f"phase 9a {method}: {fails}")
    return res


def phase_baselines(device, cfg=None):
    """9a: the paper's baselines (ca, swa, ema, lookahead, sam) on phase
    7's model, data and SGD with one replica, 8 steps each; SAM must
    launch each attention kernel twice as often a step as ca."""
    cuda = torch.device(device).type == "cuda"
    cfg = cfg or train_config()
    runs = {}
    for method in BASELINES["methods"]:
        runs[method] = _baseline_run(device, cfg, method)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    ca, sam = runs["ca"]["step_launches"], runs["sam"]["step_launches"]
    if cuda and (any(sam[k] != 2 * ca[k] for k in
                     ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"))
                 or ca["flash_bwd_dq"] != cfg.n_layers):
        raise AssertionError(f"phase 9a: a sam step launched {sam}, a ca "
                             f"step {ca}")
    ratio = runs["sam"]["median_step_ms"] / runs["ca"]["median_step_ms"]
    print(f"[baselines] sam/ca median step {ratio:.3f}x; a ca step launches "
          f"{ca}, a sam step {sam} | {CARD['line']}")
    return runs


def phase_checkpoint(device, cfg=None):
    """9b: HWA on the training model cut to ``CKPT["layers"]`` (K 2, H 2, I
    3, the fused sync) checkpointing once (step 6 of 8) into a temporary
    session directory: the run resumed from it (its scan verifies every
    array's CRC, and it loads that step: both timed) ends bit for bit
    where the uninterrupted run ended. Then the run's window state goes through
    save_window_state and publish_checkpoint into a 2-layer engine, whose
    params must equal publish_window_state's of the same state to the
    bit. (The bit flip and the fallback to an older save run in phase 15,
    at full width.)"""
    import shutil
    import tempfile

    from repro_torch.checkpoint.io import save_window_state
    from repro_torch.resilience.session import CheckpointSession
    from repro_torch.serve.publish import WeightPublisher

    dev = torch.device(device)
    c = CKPT
    cfg = cfg or train_config(c["layers"])
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    saves, scans, loads, kept = [], [], [], {}
    real = {k: getattr(CheckpointSession, k)
            for k in ("save", "latest_intact", "load")}

    def timed(name, into):
        def call(self, *args, **kw):
            _sync(dev)
            t0 = time.perf_counter()
            out = real[name](self, *args, **kw)
            _sync(dev)
            into.append((time.perf_counter() - t0, args, out))
            return out
        return call

    def trainer_for(resume):
        # the resumed run saves nothing (its save was checked by nothing)
        every = c["steps"] + 1 if resume else c["every"]
        return _train_setup(dev, cfg, steps=c["steps"], checkpoint_dir=root,
                            checkpoint_every=every,
                            checkpoint_keep=c["keep"], resume=resume)

    try:
        CheckpointSession.save = timed("save", saves)
        trainer = trainer_for(False)
        sync = trainer._sync_step

        def kept_sync(state):
            state, m = sync(state)
            if int(state.step) == c["steps"]:
                kept["final"] = state
            return state, m

        trainer._sync_step = kept_sync
        n_eval = len(list(trainer.task.pipeline.eval_batches()))
        _reset_counts()
        out = trainer.run()
        _sync(dev)
        launches = _counts()
        session = CheckpointSession(root, keep=c["keep"])
        steps = session.steps()
        fails = []
        K, L, n = TRAIN["K"], cfg.n_layers, c["steps"]
        want = _want(flash_fwd=n * K * L * 2
                     + (len(out["history"]) + 1) * n_eval * L,
                     wa_sync_fused=n // TRAIN["H"], flash_bwd_dq=n * K * L,
                     flash_bwd_dkv=n * K * L)
        if dev.type == "cuda" and launches != want:
            fails.append(f"launch counts {launches} != {want}")
        if steps != [c["every"]]:
            fails.append(f"checkpoints at {steps}")
        gb = [sum(f["size"] for f in session.manifest(step)["files"]
                  .values()) / 1e9 for step in steps]
        final = kept.pop("final")
        gc.collect()
        CheckpointSession.latest_intact = timed("latest_intact", scans)
        CheckpointSession.load = timed("load", loads)
        resumed = trainer_for(True).run()
        _sync(dev)
        for k, f in real.items():
            setattr(CheckpointSession, k, f)
        found = [o for *_, o in scans]
        loaded = [a[0] for _, a, _ in loads]
        if found != [c["every"]] or loaded != [c["every"]]:
            fails.append(f"the resume scanned to {found} and loaded "
                         f"{loaded}, not step {c['every']}")
        if not _trees_bits_equal(resumed["params"], out["params"]):
            fails.append("the resumed run's W̿ differs from the "
                         "uninterrupted run's")
        if resumed["history"] != out["history"]:
            fails.append(f"histories differ: {resumed['history']} vs "
                         f"{out['history']}")
        del resumed
        # W̿ from a window-state file into a serving engine
        wpath = os.path.join(root, "window.npz")
        t0 = time.perf_counter()
        save_window_state(wpath, final.window_state)
        wsave_s = time.perf_counter() - t0
        lm = build_model(cfg)
        eng = PagedDecodeEngine(
            lm=lm, params=lm.init(torch.Generator(device=dev).manual_seed(1),
                                  device=dev),
            max_batch=8, max_seq_len=560, max_new=32, page_size=16,
            prefill_chunk=512, device=dev)
        pub = WeightPublisher(engine=eng)
        t0 = time.perf_counter()
        from_file = pub.publish_checkpoint(wpath)
        _sync(dev)
        wpub_s = time.perf_counter() - t0
        live = pub.publish_window_state(final.window_state)
        if not _trees_bits_equal(from_file, live):
            fails.append("publish_checkpoint and publish_window_state "
                         "disagree")
        wgb = os.path.getsize(wpath) / 1e9
        del eng, pub, from_file, live, final
    finally:
        for k, f in real.items():
            setattr(CheckpointSession, k, f)
        shutil.rmtree(root, ignore_errors=True)
    res = {"params": train_param_count(cfg), "gb_per_save": gb,
           "save_s": [t for t, *_ in saves],
           "verify_s": sum(t for t, *_ in scans),
           "load_s": [t for t, *_ in loads],
           "window_gb": wgb,
           "window_save_s": wsave_s, "window_publish_s": wpub_s,
           "launches": launches,
           "history": [h["test_loss"] for h in out["history"]]}
    print(f"[checkpoint] granite-3-2b L{cfg.n_layers} "
          f"({res['params'] / 1e6:.1f}M params), HWA K{TRAIN['K']} "
          f"H{TRAIN['H']} I{TRAIN['I']} fused sync, {c['steps']} steps, "
          f"saves at {steps}: {[round(x, 3) for x in gb]} GB a save, save "
          f"{[round(x, 2) for x in res['save_s']]} s; the resume's scan "
          f"(every CRC) {res['verify_s']:.2f} s, its load "
          f"{[round(x, 2) for x in res['load_s']]} s; resumed from step "
          f"{c['every']}: W̿ and history "
          f"bit-equal; window state {wgb:.3f} GB saved in {wsave_s:.2f} s, "
          f"published from the file in {wpub_s:.2f} s, bit-equal to the live "
          f"publish; launches {launches} | {CARD['line']}")
    if fails:
        raise AssertionError(f"phase 9b: {fails}")
    return res


def phase_publish_serve(device, train, cfg=None, **serve_kw):
    """9c: phase 7's W̿ published (publish_window_state) into an engine on
    the same 8-layer model, then phase 4's 12 requests: the engine's
    params equal window_average cast to bf16 to the bit, the tokens equal
    those of an engine given those params directly, and the launches are
    8 x admissions and 8 x decode steps (checked in phase_serve)."""
    from repro_torch.core.offline import window_average
    from repro_torch.serve.publish import WeightPublisher

    dev = torch.device(device)
    cfg = cfg or train_config()
    window = tree_map(lambda x: x.to(dev), train["final_window"])
    box = {}

    def publish(eng):
        like = eng.params
        pub = WeightPublisher(engine=eng)
        clock = _Clock(dev)
        new = clock.wrap(pub.publish_window_state)(window)
        box["publish_ms"] = clock.ms()[0]
        box["direct"] = window_average(window, like)
        box["equal"] = _trees_bits_equal(new, box["direct"])

    served, eng = phase_serve(dev, cfg=cfg, setup=publish, **serve_kw)
    launches = served["launches"]
    del eng
    gc.collect()
    direct = box.pop("direct")
    plain, eng = phase_serve(dev, cfg=cfg,
                             setup=lambda e: e.set_params(direct),
                             **serve_kw)
    del eng, direct, window
    gc.collect()
    fails = []
    if not box["equal"]:
        fails.append("published params != window_average cast to bf16")
    if not np.array_equal(served["outputs"], plain["outputs"]):
        fails.append("tokens after the publish differ from the direct "
                     "engine's")
    res = {"publish_ms": box["publish_ms"], "launches": launches,
           "admissions": served["admissions"],
           "decode_steps": served["decode_steps"],
           "median_step_ms": served["median_step_ms"]}
    print(f"[publish] phase 7's W̿ into an 8-layer engine in "
          f"{box['publish_ms']:.3f} ms (CUDA events: repack, unpack, cast); "
          f"params bit-equal to window_average: {box['equal']}; "
          f"{served['requests']} requests, tokens equal to the direct "
          f"engine's: {np.array_equal(served['outputs'], plain['outputs'])};"
          f" launches {launches} | {CARD['line']}")
    if fails:
        raise AssertionError(f"phase 9c: {fails}")
    return res


def _leaf_names(tree, prefix=""):
    """Dotted names of a tree's leaves in flatten order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, x in enumerate(tree)
                for n in _leaf_names(x, f"{prefix}{i}.")]
    return [prefix[:-1]]


# ------------------------------------------------------------ 10. phase 10

#: 10a: the training model cut to 2 layers, HWA K 2 H 2 I 3 on an f32 ring with the
#: kernels, resilient; replica 1 poisoned before step index 2 (the sync
#: after step 4 must drop it, the one after step 6 count it again)
RESILIENT = dict(layers=2, steps=6, poison_before=2, scale=1e3)
#: 10c: the paper's ResNet-110 on CIFAR-sized prototype images
RESNET = dict(depth=110, epochs=3, k=2, window=3, batch_size=128,
              image_size=32, n_train=5120, n_test=1024, use_kernels=True)


def _free(dev):
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _clone(tree):
    return tree_map(lambda x: x.detach().clone(), tree)


def _replica_tree(tree, k):
    return tree_map(lambda x: x[k].clone(), tree)


def _floating_rms(tree, k) -> float:
    """RMS of replica ``k`` over every floating leaf, in f32."""
    sq, n = 0.0, 0
    for x in tree_leaves(tree):
        if x.is_floating_point():
            sq += float(x[k].float().square().sum())
            n += x[k].numel()
    return (sq / n) ** 0.5


def phase_resilient(device):
    """10a: resilient HWA at full width, 2 layers. (1) a healthy state
    synced resiliently (the window-update kernel) and plainly (no kernel):
    W̄, ring, total and W̿ bit-equal, one window-update launch. (2)
    Trainer.run with replica 1 poisoned with NaN before step index 2: at
    the next sync k_alive is 1, W̄ equals replica 0's weights, replica
    1's momenta are zero and W̿ is finite; at the sync after, k_alive is
    2. (3) a replica scaled x1e3 is quarantined by max_param_rms."""
    from repro_torch.core.hwa import hwa_sync
    from repro_torch.resilience.faults import poison_replica
    from repro_torch.resilience.health import replica_alive_mask

    dev = torch.device(device)
    r = RESILIENT
    K, H, I = TRAIN["K"], TRAIN["H"], TRAIN["I"]
    cfg = train_config(r["layers"])
    L = cfg.n_layers
    hcfg = HWAConfig(n_replicas=K, sync_period=H, window=I,
                     use_kernels=True, resilient=True)
    trainer = _train_setup(dev, cfg, steps=r["steps"], hwa=hcfg)
    fails = []

    # (1) healthy: resilient (window-update kernel) vs plain, bit for bit
    state = hwa_init(hcfg, trainer.task.init(), trainer.optimizer)
    for step in range(H):
        state, _ = trainer._hwa_step(state, step)
    twin = _clone(state)
    _sync(dev)
    _reset_counts()
    a, ma = hwa_sync(hcfg, state)
    _sync(dev)
    healthy_launches = _counts()
    b, _ = hwa_sync(dataclasses.replace(hcfg, resilient=False,
                                        use_kernels=False), twin)
    cuda = dev.type == "cuda"
    if cuda and healthy_launches != _want(wa_window_update=1):
        fails.append(f"healthy resilient sync launched {healthy_launches}")
    healthy_equal = {
        "outer": _trees_bits_equal(_replica_tree(a.inner, 0),
                                   _replica_tree(b.inner, 0)),
        "ring": _bits_equal(a.window_state.ring, b.window_state.ring),
        "total": _bits_equal(a.window_state.total, b.window_state.total),
        "wa": _trees_bits_equal(a.wa, b.wa)}
    if not all(healthy_equal.values()) or int(ma["k_alive"]) != K:
        fails.append(f"healthy resilient sync vs plain: {healthy_equal}, "
                     f"k_alive {int(ma['k_alive'])}")
    del state, twin, a, b
    _free(dev)

    # (2) a NaN replica through Trainer.run
    hwa_step, sync_step = trainer._hwa_step, trainer._sync_step
    syncs, kept = [], {}

    def poisoning_step(state, step):
        if step == r["poison_before"]:
            state.inner = poison_replica(state.inner, 1)
        return hwa_step(state, step)

    def checked_sync(state):
        dead_in = not all(bool(torch.isfinite(x[1]).all())
                          for x in tree_leaves(state.inner))
        r0 = _replica_tree(state.inner, 0) if dead_in else None
        _sync(dev)
        t0 = time.perf_counter()
        state, m = sync_step(state)
        _sync(dev)
        rec = {"ms": (time.perf_counter() - t0) * 1e3,
               "step": int(state.step), "k_alive": int(m["k_alive"]),
               "nan_in": dead_in,
               "wa_finite": all(bool(torch.isfinite(x).all())
                                for x in tree_leaves(state.wa))}
        if dead_in:
            # torch.equal: the masked sum adds the dead row's 0 onto a
            # -0.0 and gives +0.0
            rec["outer_is_replica0"] = all(
                torch.equal(x[0], y)
                for x, y in zip(tree_leaves(state.inner), tree_leaves(r0)))
            rec["opt1_zero"] = all(not bool(x[1].any())
                                   for x in tree_leaves(state.inner_opt))
        syncs.append(rec)
        kept["state"] = state
        return state, m

    trainer._hwa_step, trainer._sync_step = poisoning_step, checked_sync
    n_eval = len(list(trainer.task.pipeline.eval_batches()))
    _sync(dev)
    _reset_counts()
    out = trainer.run()
    _sync(dev)
    launches = _counts()
    n = r["steps"]
    want = _want(flash_fwd=n * K * L * 2 + (len(out["history"]) + 1)
                 * n_eval * L, flash_bwd_dq=n * K * L,
                 flash_bwd_dkv=n * K * L, wa_window_update=n // H)
    if cuda and launches != want:
        fails.append(f"launch counts {launches} != {want}")
    want_alive = [K, 1, K]
    if [s["k_alive"] for s in syncs] != want_alive:
        fails.append(f"k_alive per sync {[s['k_alive'] for s in syncs]} "
                     f"!= {want_alive}")
    poisoned = [s for s in syncs if s["nan_in"]]
    if len(poisoned) != 1 or not (poisoned[0]["outer_is_replica0"]
                                  and poisoned[0]["opt1_zero"]):
        fails.append(f"the poisoned sync: {poisoned}")
    if not all(s["wa_finite"] for s in syncs) or not np.isfinite(
            out["final"]["test_loss"]):
        fails.append(f"W̿ not finite: {syncs}, final {out['final']}")

    # (3) a diverged (finite) replica: quarantined by max_param_rms only
    state = kept.pop("state")
    trainer._hwa_step, trainer._sync_step = hwa_step, sync_step
    for x in tree_leaves(state.inner):
        if x.is_floating_point():
            x[1].mul_(r["scale"])
    rms = (_floating_rms(state.inner, 0), _floating_rms(state.inner, 1))
    limit = 10 * rms[0]
    finite_only = replica_alive_mask(state.inner).tolist()
    r0 = _replica_tree(state.inner, 0)
    state, m = hwa_sync(dataclasses.replace(hcfg, max_param_rms=limit),
                        state)
    diverged = {"k_alive": int(m["k_alive"]), "finite_only": finite_only,
                "outer_is_replica0": all(torch.equal(x[0], y) for x, y in
                                         zip(tree_leaves(state.inner),
                                             tree_leaves(r0))),
                "opt1_zero": all(not bool(x[1].any())
                                 for x in tree_leaves(state.inner_opt))}
    if not (diverged["k_alive"] == 1 and finite_only == [True, True]
            and diverged["outer_is_replica0"] and diverged["opt1_zero"]):
        fails.append(f"the diverged replica: {diverged}")
    del state, r0, trainer
    _free(dev)
    res = {"launches": launches, "healthy_launches": healthy_launches,
           "healthy_bit_equal": healthy_equal, "syncs": syncs,
           "diverged": diverged, "rms": rms, "max_param_rms": limit,
           "history": [h["test_loss"] for h in out["history"]]}
    print(f"[resilient] granite-3-2b L{L} ({train_param_count(cfg) / 1e6:.1f}"
          f"M params), HWA K{K} H{H} I{I} f32 ring, use_kernels, "
          f"resilient: healthy sync vs plain route bit-equal "
          f"{healthy_equal}, launches {healthy_launches}; replica 1 NaN "
          f"before step {r['poison_before'] + 1}: per sync "
          f"{[(s['step'], s['k_alive']) for s in syncs]} (step, k_alive), "
          f"W̄ == replica 0 {poisoned[0]['outer_is_replica0'] if poisoned else None}, "
          f"replica 1 momenta zeroed "
          f"{poisoned[0]['opt1_zero'] if poisoned else None}, W̿ test loss "
          f"{[round(x, 4) for x in res['history']]}, resilient sync "
          f"{[round(s['ms'], 3) for s in syncs]} ms; replica 1 x{r['scale']:g} "
          f"(RMS {rms[1]:.4g} vs {rms[0]:.4g}, max_param_rms {limit:.4g}): "
          f"{diverged}; launches {launches} | {CARD['line']}")
    if fails:
        raise AssertionError(f"phase 10a: {fails}")
    return res


def phase_flash_jnp_remat(device):
    """10b: phase 10a's model, one step's loss and gradients on a
    training batch. flash_jnp against flash_pallas: each layer's
    attention output and (dq, dk, dv) within the bf16 flash tolerance,
    and the loss within it relatively; remat "dots" against "full": loss
    and every gradient bit-equal. Peak memory and flash launches of a
    step under remat none, full and dots (flash_pallas)."""
    import repro_torch.models.transformer as tfm
    from repro_torch.models.attention import flash_attention_jnp

    dev = torch.device(device)
    base = train_config(RESILIENT["layers"])
    L = base.n_layers
    trainer = _train_setup(dev, base, steps=1)
    params = trainer.task.init()
    tok, tgt = trainer.task.pipeline.replica_batch(0, 0)
    batch = {"tokens": tok, "targets": tgt}
    tol = FLASH_TOL[torch.bfloat16]
    fails = []

    def step(cfg):
        leaves, treedef = tree_flatten(params)
        live = [x.detach().requires_grad_(True) for x in leaves]
        loss, _ = build_model(cfg).loss(tree_unflatten(treedef, live), batch)
        return loss.detach(), torch.autograd.grad(loss, live)

    cuda = dev.type == "cuda"
    runs = {}
    for remat in ("none", "full", "dots"):
        _free(dev)
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
            base_mem = torch.cuda.memory_allocated(dev)
        _sync(dev)
        _reset_counts()
        loss, grads = step(base.with_(remat=remat))
        _sync(dev)
        runs[remat] = {"launches": _counts(), "loss": float(loss),
                       "peak_gib": ((torch.cuda.max_memory_allocated(dev)
                                     - base_mem) / 2**30 if cuda
                                    else float("nan"))}
        want = _want(flash_fwd=L * (1 if remat == "none" else 2),
                     flash_bwd_dq=L, flash_bwd_dkv=L)
        if cuda and runs[remat]["launches"] != want:
            fails.append(f"remat {remat}: launches "
                         f"{runs[remat]['launches']} != {want}")
        if remat in ("full", "dots"):
            runs[remat]["out"] = (loss, grads)
        del loss, grads
    (lf, gf), (ld, gd) = runs["full"].pop("out"), runs["dots"].pop("out")
    dots_equal = _bits_equal(lf, ld) and all(
        _bits_equal(x, y) for x, y in zip(gf, gd))
    if not dots_equal:
        fails.append("remat dots differs from full")
    del gf, gd

    # flash_jnp: the step's loss, then each layer's attention
    loss_jnp, _ = step(base.with_(attn_impl="flash_jnp"))
    dloss = abs(float(loss_jnp) - runs["full"]["loss"])
    if not dloss <= tol * abs(runs["full"]["loss"]):
        fails.append(f"flash_jnp loss {float(loss_jnp)} vs flash_pallas "
                     f"{runs['full']['loss']}")
    seen = []
    real = tfm.run_attention

    def recording(impl, q, k, v, *a, **kw):
        seen.append((q.detach().clone(), k.detach().clone(),
                     v.detach().clone(), kw))
        return real(impl, q, k, v, *a, **kw)

    tfm.run_attention = recording
    try:
        with torch.no_grad():
            build_model(base).loss(params, batch)
    finally:
        tfm.run_attention = real
    gen = torch.Generator(device=dev).manual_seed(10)
    layer_err = []
    for q, k, v, kw in seen:
        w = torch.randn(q.shape, generator=gen, device=dev)
        got = {}
        for name, fn in (("pallas", kops.flash_attention),
                         ("jnp", flash_attention_jnp)):
            leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
            out = fn(*leaves, window=kw["window"],
                     logit_softcap=kw["logit_softcap"])
            got[name] = (out.detach(),) + torch.autograd.grad(
                (out.float() * w).sum(), leaves)
        errs = {}
        for i, nm in enumerate(("out", "dq", "dk", "dv")):
            err, ok = _close(got["jnp"][i], got["pallas"][i], tol)
            errs[nm] = err
            if not ok:
                fails.append(f"layer {len(layer_err)} {nm}: flash_jnp vs "
                             f"flash_pallas max|d| {err}")
        layer_err.append(errs)
    if len(seen) != L:
        fails.append(f"{len(seen)} attention calls for {L} layers")
    del seen, params
    _free(dev)
    res = {"runs": runs, "dots_bit_equal": dots_equal,
           "loss_flash_jnp": float(loss_jnp), "dloss": dloss,
           "layer_max_abs_err": layer_err,
           # the main path: the three steps (remat none, full, dots)
           "launches": {k: sum(r["launches"][k] for r in runs.values())
                        for k in _counts()}}
    print(f"[flash_jnp/remat] granite-3-2b L{L}, {TRAIN['batch']}x"
          f"{TRAIN['seq']} tokens, one step: flash_jnp vs flash_pallas loss "
          f"{float(loss_jnp):.5f} vs {runs['full']['loss']:.5f}, per layer "
          f"max|d| {[{k: round(v, 5) for k, v in e.items()} for e in layer_err]}"
          f" (tol {tol}); remat dots vs full loss and grads bit-equal "
          f"{dots_equal}; peak memory above the weights "
          f"{ {m: round(r['peak_gib'], 3) for m, r in runs.items()} } GiB, "
          f"flash forward launches a step "
          f"{ {m: r['launches']['flash_fwd'] for m, r in runs.items()} } "
          f"| {CARD['line']}")
    if fails:
        raise AssertionError(f"phase 10b: {fails}")
    return res


def phase_resnet(device):
    """10c: the paper's ResNet-110 (CIFAR 32x32, widths 16/32/64, 10
    classes) under HWA through ``repro_torch.launch.resnet_cifar``: K 2
    replicas of batch 128, SGD momentum 0.9, weight decay 5e-4, cosine LR
    from 0.1, H one epoch (40 steps), I 3, the fused sync kernel, BN
    statistics recomputed under W̿ after each sync, 3 epochs. The first
    sync's kernel is held against its plain version on its own inputs at
    0 ULP. Gates: finite losses, the last epoch's mean loss below 0.7 of
    the first's, W̿'s accuracy above chance, 3 fused-sync launches."""
    import repro_torch.launch.resnet_cifar as rn
    from repro_torch.common.packing import pack, pack_stacked
    from repro_torch.core.offline import window_scalars

    dev = torch.device(device)
    held = {}
    hwa_sync = rn.hwa_sync

    def checked_sync(hcfg, state):
        if held:
            return hwa_sync(hcfg, state)
        ws = state.window_state
        full_flag, _, inv_count = window_scalars(ws)
        want = wa_sync_fused_ref(pack_stacked(state.inner, ws.spec),
                                 ws.ring.clone(), ws.total.clone(),
                                 ws.next_idx, full_flag, inv_count)
        state, m = hwa_sync(hcfg, state)
        got = (state.window_state.ring, state.window_state.total,
               pack(state.wa, ws.spec))
        held["ulp"] = max(max_ulp(g, w) for g, w in zip(got, want))
        held["P"] = int(ws.spec.padded)
        return state, m

    rn.hwa_sync = checked_sync
    try:
        _sync(dev)
        _reset_counts()
        t0 = time.perf_counter()
        out = rn.train_resnet_cifar(rn.ResNetCifarConfig(**RESNET), dev,
                                    log=lambda s: print(f"[resnet] {s}"))
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        rn.hwa_sync = hwa_sync
    launches = _counts()
    hist = out["history"]
    fails = []
    if dev.type == "cuda" and launches != _want(
            wa_sync_fused=RESNET["epochs"]):
        fails.append(f"launch counts {launches}")
    if held.get("ulp") != 0:
        fails.append(f"fused sync vs plain: {held.get('ulp')} ULP")
    if not np.isfinite(out["losses"]).all():
        fails.append("non-finite loss")
    if not hist[-1]["train_loss"] < 0.7 * hist[0]["train_loss"]:
        fails.append(f"epoch losses {[h['train_loss'] for h in hist]}")
    if not hist[-1]["wa_acc"] > 1.0 / rn.N_CLASSES:
        fails.append(f"W̿ accuracy {hist[-1]['wa_acc']}")
    t = out["times"]
    res = {"launches": launches, "sync_ulp": held.get("ulp"),
           "packed_size": held.get("P"), "history": hist,
           "median_step_ms": out["median_step_ms"],
           "sync_ms": t["sync_ms"], "bn_ms": t["bn_ms"], "wall_s": wall,
           "params": sum(x.numel() for x in
                         tree_leaves(out["state"].wa["p"]))}
    print(f"[resnet] resnet{RESNET['depth']}-cifar ({res['params'] / 1e6:.3f}"
          f"M params, packed P {res['packed_size']}) HWA K{RESNET['k']} "
          f"I{RESNET['window']} H {RESNET['n_train'] // RESNET['batch_size']}"
          f" steps, batch {RESNET['batch_size']} "
          f"per replica, {RESNET['epochs']} epochs: epoch loss "
          f"{[round(h['train_loss'], 4) for h in hist]}, W̿ test acc with "
          f"the BN recompute {[h['wa_acc'] for h in hist]}, without "
          f"{[h['wa_acc_stale_bn'] for h in hist]}; fused sync vs plain "
          f"{res['sync_ulp']} ULP; median replica step "
          f"{res['median_step_ms']:.3f} ms, sync "
          f"{[round(x, 3) for x in t['sync_ms']]} ms, BN recompute "
          f"{[round(x, 3) for x in t['bn_ms']]} ms, wall {wall:.1f} s; "
          f"launches {launches} | {CARD['line']}")
    del out
    _free(dev)
    if fails:
        raise AssertionError(f"phase 10c: {fails}")
    return res


# ---------------------------------------------------------------- 11. MoE

#: phase 11a-b's served models, in order (qwen2's 28.6 GB of weights are
#: freed before granite-moe's are drawn)
MOE_SERVE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-1b-a400m")


def _routed_counts(gen, N, E, k, device):
    """Group sizes of N tokens each routed to k distinct experts of E."""
    top = torch.rand((N, E), generator=gen, device=device).topk(k).indices
    return torch.zeros(E, dtype=torch.int64, device=device).scatter_add_(
        0, top.reshape(-1), torch.ones(N * k, dtype=torch.int64,
                                       device=device))


#: the expert products' kernels in a trace: ATen's CUTLASS 3.x grouped
#: GEMM, which ``torch._grouped_mm`` launches on sm90 (forward, and each
#: operand's gradient in the backward); nothing else in the port
#: launches ATen's CUTLASS 3.x kernels (the other products are cuBLAS's)
GROUPED_GEMM_TAG = "enable_3x_kernel_for_sm9x"


def _expert_share(label, stats, n_calls, want_launches):
    """The expert products' share of a trace's device time, and their
    launches beside the count the path should make."""
    rows, busy = stats[3], stats[1]
    mine = [(t, c) for n, t, c in rows if GROUPED_GEMM_TAG in n]
    ms, launches = sum(t for t, _ in mine), sum(c for _, c in mine)
    share = ms / busy if busy else float("nan")
    print(f"[trace] {label}: expert products (torch._grouped_mm, "
          f"{len(mine)} kernels, {launches} launches; {want_launches} "
          f"products) {ms / n_calls:.4f} ms of {busy / n_calls:.4f} ms "
          f"device busy per call = {100 * share:.1f}% | {CARD['line']}")
    return {"expert_ms": ms / n_calls, "busy_ms": busy / n_calls,
            "share": share, "launches": launches,
            "products": want_launches}


def _host_ms(fn, iters=20, warmup=3):
    """Milliseconds a call, host clock around ``iters`` calls ending in a
    synchronize: the loop reads its group sizes back to the host, so a
    CUDA graph cannot hold it, and its host time is part of its cost."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def phase_moe_grouped(device):
    """The expert products both ways on the card (``expert_ffn`` with
    ``impl="device"``, one ``torch._grouped_mm`` per weight, against
    ``impl="loop"``, a matmul per expert after reading the group sizes
    back), at three main-path shapes: a qwen2-moe-a2.7b decode step (8
    tokens, 32 pairs over 60 experts, most groups empty) and prefill
    chunk (512 tokens), and granite-moe-1b-a400m's training batch (2,048
    tokens per replica, forward and backward). Outputs (and gradients)
    must agree within the bf16 flash tolerance (bit equality is
    reported); the port runs ``device`` (``moe.ffn_impl``), which must be
    the faster here."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(43)
    rows = []
    for arch, N, train in (("qwen2-moe-a2.7b", 8, False),
                           ("qwen2-moe-a2.7b", 512, False),
                           ("granite-moe-1b-a400m", 2048, True)):
        cfg = get_config(arch)
        D, Fe, E, k = cfg.d_model, cfg.expert_d_ff, cfg.n_experts, cfg.top_k
        p = {"w_gate": _randn(gen, (E, D, Fe), torch.bfloat16, dev) * 0.03,
             "w_up": _randn(gen, (E, D, Fe), torch.bfloat16, dev) * 0.03,
             "w_down": _randn(gen, (E, Fe, D), torch.bfloat16, dev) * 0.03}
        counts = _routed_counts(gen, N, E, k, dev)
        tokens = _randn(gen, (N * k, D), torch.bfloat16, dev)
        gout = _randn(gen, (N * k, D), torch.bfloat16, dev)
        outs, ms = {}, {}
        for impl in ("device", "loop", "loop", "device"):
            if train:
                live = [tokens.requires_grad_(True)] + [
                    w.requires_grad_(True) for w in p.values()]

                def fn():
                    y = moe.expert_ffn(cfg, p, tokens, counts, impl)
                    return (y.detach(),) + torch.autograd.grad(y, live, gout)
            else:
                def fn():
                    with torch.no_grad():
                        return (moe.expert_ffn(cfg, p, tokens, counts, impl),)
            outs[impl] = fn()
            ms.setdefault(impl, []).append(_host_ms(fn))
        same = all(torch.equal(a, b) for a, b in zip(outs["device"],
                                                     outs["loop"]))
        close = [_close(a, b, FLASH_TOL[torch.bfloat16])
                 for a, b in zip(outs["device"], outs["loop"])]
        rec = {"arch": arch, "tokens": N, "pairs": N * k,
               "empty_groups": int((counts == 0).sum()),
               "train": train, "device_ms": float(np.mean(ms["device"])),
               "loop_ms": float(np.mean(ms["loop"])), "runs": ms,
               "bit_equal": same, "max_abs_err": max(c[0] for c in close)}
        rows.append(rec)
        print(f"[moe] expert products {arch} {N} tokens ({N * k} pairs over "
              f"{E} experts, {rec['empty_groups']} empty) "
              f"{'forward+backward' if train else 'forward'}: "
              f"torch._grouped_mm {ms['device']} ms, per-expert loop "
              f"{ms['loop']} ms (order device, loop, loop, device); "
              f"bit-equal {same}, max |d| {rec['max_abs_err']:.3g} (tol "
              f"{FLASH_TOL[torch.bfloat16]}) | {CARD['line']}")
        del p, tokens, gout, outs
        torch.cuda.empty_cache()
        if not all(c[1] for c in close):
            raise AssertionError(f"grouped products differ: {arch} {N}")
        if rec["device_ms"] >= rec["loop_ms"]:
            raise AssertionError(f"torch._grouped_mm is not the faster at "
                                 f"{arch} {N}: {ms}")
    return rows


def phase_moe(device):
    """Phase 11, the MoE family. 11a: qwen2-moe-a2.7b and then
    granite-moe-1b-a400m at full width and depth serve phase 4's 12
    requests (launch counts n_layers x admissions and x decode steps);
    11d traces qwen2's prefill and decode. 11b: each cut to 2 layers,
    kernel path against plain path in f32 (the gate) and bf16. The
    expert products both ways. 11c: HWA training of granite-moe-1b-a400m
    cut to 12 layers (phase 7's recipe) and its trace (11d)."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    out = {"serve": {}, "reference": {}}
    for arch in MOE_SERVE_ARCHS:
        cfg = get_config(arch).with_(attn_impl="flash_pallas")
        res, eng = phase_serve(dev, cfg=cfg)
        if arch == MOE_SERVE_ARCHS[0]:
            _, dstats = phase_trace(dev, eng, res)
            out["decode_trace"] = _expert_share(
                f"{arch} decode step", dstats, 8, 8 * 3 * cfg.n_layers)
        res.pop("outputs")
        out["serve"][arch] = res
        del eng                  # held in a cycle by its timing wrappers
        gc.collect()
        torch.cuda.empty_cache()
    for arch in MOE_SERVE_ARCHS:
        out["reference"][arch] = {
            dt: phase_reference(dev, arch=arch, dtype=dt,
                                gate_logits=dt == "float32")
            for dt in ("float32", "bfloat16")}
        torch.cuda.empty_cache()
    out["grouped"] = phase_moe_grouped(dev)
    cfg = moe_train_config()
    train, trainer = phase_train(dev, cfg=cfg, full_layers=24)
    stats = phase_train_trace(dev, trainer, train)
    del trainer
    train.pop("final_wa")
    train.pop("final_window")
    gc.collect()
    torch.cuda.empty_cache()
    # 2 steps x K replicas x 3 products a layer, each run forward twice
    # (remat) and differentiated for both operands
    out["train_trace"] = _expert_share(
        "granite-moe-1b-a400m train (2 inner steps + 1 sync)", stats, 1,
        2 * TRAIN["K"] * 3 * cfg.n_layers * 4)
    out["train"] = train
    torch.cuda.empty_cache()
    print(f"[moe] phase 11 in {time.perf_counter() - t0:.1f} s | "
          f"{CARD['line']}")
    return out


# ---------------------------------------------------------- 12. recurrent

#: phase 12a's served models, in order (hymba's weights are freed before
#: xlstm's are drawn)
RECURRENT_SERVE_ARCHS = ("hymba-1.5b", "xlstm-125m")
#: phase 12a's traffic. Recurrent stacks take the prompt one token a
#: decode step (step prefill), so phase 4's 12 requests of up to 512
#: tokens would cost ~1,100 steps of a 32-layer stack; 8 requests of
#: 64-256 tokens fill the 8 slots at once.
RECURRENT_SERVE = dict(n_requests=8, prompt_range=(64, 256), max_new=32)
#: phase 12c: hymba-1.5b cut from 32 to 16 layers (748.1M parameters; at
#: 32, 1.394B need ~70 GB of HWA state at phase 7's ~50 bytes a
#: parameter before activations); xlstm-125m whole
HYMBA_TRAIN_LAYERS = 16
#: phase 12b's window-binding run: 128 + 960 + 96 = 1,184 tokens, so the
#: paged ring (TW 65 at window 1024, page 16) wraps
WINDOW_RUN = dict(prompt=960, new=96)


def _recurrent_requests(cfg, n, prompt_range, new, seed):
    rs = np.random.RandomState(seed)
    lens = rs.randint(prompt_range[0], prompt_range[1] + 1, size=n)
    return [Request(rid=i, tokens=rs.randint(0, cfg.vocab_size, size=int(m))
                    .astype(np.int32), n_new=new)
            for i, m in enumerate(lens)]


def phase_serve_recurrent(device, cfg, *, reqs=None, params=None,
                          max_batch=8, page_size=16, seed=0, record=False):
    """Serve a recurrent stack (xlstm, hymba) through PagedDecodeEngine
    and ContinuousScheduler: at admission the meta-token prefix fill
    (hymba), then the prompt one token a decode step (the use_prompt
    lane), then the new tokens. ``reqs`` default to RECURRENT_SERVE's
    traffic. On the card the launch counts must be exact: the flash
    forward n_layers x prefix fills, the paged kernel n_layers x decode
    steps (hymba); none for xlstm. ``record`` keeps each step's logits
    of the active slots (phase 12b compares two runs)."""
    dev = torch.device(device)
    lm = build_model(cfg)
    if params is None:
        params = lm.init(torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    if reqs is None:
        t = RECURRENT_SERVE
        reqs = _recurrent_requests(cfg, t["n_requests"], t["prompt_range"],
                                   t["max_new"], seed)
    max_new = max(r.n_new for r in reqs)
    max_seq = cfg.n_meta_tokens + max(len(r.tokens) for r in reqs) + max_new
    eng = PagedDecodeEngine(lm=lm, params=params, max_batch=max_batch,
                            max_seq_len=max_seq, max_new=max_new,
                            page_size=page_size, device=dev)
    fill_clock, step_clock = _Clock(dev), _Clock(dev)
    log = {"fills": 0, "emitted": 0, "prompt_steps": 0, "lens": [],
           "logits": []}
    finite = torch.ones((), dtype=torch.bool, device=dev)
    timed_fill = fill_clock.wrap(eng.prefix_fill_into)
    timed_step = step_clock.wrap(eng.step)

    def counted_fill(slot):
        log["fills"] += 1
        timed_fill(slot)

    def counted_step(ctrl):
        nonlocal finite
        active = ctrl["use_prompt"] | (ctrl["out_idx"] != eng.scratch_idx)
        log["emitted"] += int((ctrl["out_idx"] != eng.scratch_idx).sum())
        log["prompt_steps"] += bool(ctrl["use_prompt"].any())
        log["lens"].append([int(p) + 1 if a else 0
                            for p, a in zip(ctrl["pos"], active)])
        timed_step(ctrl)
        logits = eng.state["logits"]
        finite = finite & torch.isfinite(logits[torch.as_tensor(
            active, device=dev)]).all()
        if record:
            log["logits"].append((active.copy(),
                                  logits[torch.as_tensor(active, device=dev)]
                                  .float().clone()))

    eng.prefix_fill_into, eng.step = counted_fill, counted_step
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    _reset_counts()
    t0 = time.perf_counter()
    outs = ContinuousScheduler(eng).run(reqs)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _counts()
    steps = len(step_clock.spans)
    toks = np.stack([outs[r.rid] for r in reqs])
    if toks.shape != (len(reqs), max_new):
        raise AssertionError(f"output shape {toks.shape}")
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("token outside the vocab range")
    if not bool(finite):
        raise AssertionError("non-finite logits")
    if log["fills"] != (len(reqs) if cfg.n_meta_tokens else 0):
        raise AssertionError(f"{log['fills']} prefix fills for {len(reqs)}")
    La = _attention_layers(cfg)
    if dev.type == "cuda" and cfg.attn_impl == "flash_pallas":
        want = _want(flash_fwd=La * log["fills"], paged_attention=La * steps)
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
    step_ms, fill_ms = step_clock.ms(), fill_clock.ms()
    tail = int(100 * (1 - 10 / len(step_ms))) if len(step_ms) >= 20 else None
    full = [ln for ln in log["lens"] if all(ln)]
    res = {
        "arch": cfg.name, "layers": cfg.n_layers, "requests": len(reqs),
        "slots": max_batch, "prefix_fills": log["fills"],
        "decode_steps": steps, "prompt_steps": log["prompt_steps"],
        "prompt_step_share": log["prompt_steps"] / steps,
        "tokens": int(toks.size), "launches": launches,
        "decode_tok_s": log["emitted"] / (sum(step_ms) / 1e3),
        "median_step_ms": float(np.median(step_ms)),
        "tail_pct": tail,
        "tail_step_ms": (float(np.percentile(step_ms, tail))
                         if tail else None),
        "median_fill_ms": (float(np.median(fill_ms)) if fill_ms else None),
        "wall_s": wall, "wall_tok_s": toks.size / wall,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None),
        # the step with the most keys among those with every slot busy:
        # phase 6 times the paged kernel at its lens
        "full_step_lens": max(full, key=sum) if full else None,
        "prompt_lens": [len(r.tokens) for r in reqs],
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.resolved_head_dim,
        "table_width": eng.table_width,
        "outputs": toks, "step_logits": log["logits"],
    }
    print(f"[serve12] {cfg.name} L{cfg.n_layers} d{cfg.d_model} "
          f"{cfg.family} {cfg.dtype} {cfg.attn_impl} on {dev}: "
          f"{len(reqs)} requests (prompts {min(res['prompt_lens'])}-"
          f"{max(res['prompt_lens'])}, {max_new} new), {max_batch} slots, "
          f"{log['fills']} prefix fills, {steps} decode steps "
          f"({log['prompt_steps']} feed a prompt: "
          f"{100 * res['prompt_step_share']:.1f}%), table width "
          f"{eng.table_width}, launches {launches}")
    print(f"[serve12] {cfg.name}: decode {res['decode_tok_s']:.1f} tok/s, "
          f"median step {res['median_step_ms']:.3f} ms (p{tail} "
          f"{res['tail_step_ms']} ms, n={steps}), median prefix fill "
          f"{res['median_fill_ms']} ms, wall {wall:.2f} s, peak memory "
          f"{res['peak_mem_gib']} GiB | {CARD['line']}")
    return res, eng


def _labelled_recurrences():
    """Wrap the recurrent cells (and the sLSTM's hand-written backward) in
    ``torch.profiler.record_function`` ranges named ``ssm.<cell>``, so a
    trace can sum the device time of the kernels they launch. The
    backward that autograd derives for mLSTM and Mamba runs outside any
    range and is not counted. Returns a function that restores them."""
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tfm

    def labelled(name, fn):
        def run(*a, **kw):
            with torch.profiler.record_function(f"ssm.{name}"):
                return fn(*a, **kw)
        return run
    saved = (ssm.mamba_scan, dict(tfm._CELLS), ssm._SLSTMScan.backward)
    ssm.mamba_scan = labelled("mamba", saved[0])
    for kind, (scan, init) in saved[1].items():
        tfm._CELLS[kind] = (labelled(kind, scan), init)
    ssm._SLSTMScan.backward = staticmethod(labelled("slstm_backward",
                                                    saved[2]))

    def restore():
        ssm.mamba_scan = saved[0]
        tfm._CELLS.update(saved[1])
        ssm._SLSTMScan.backward = staticmethod(saved[2])
    return restore


#: the host-side calls that put work on the device; a kernel's launch is
#: found by its correlation id (a CUDA graph's kernels carry the id of
#: the graph's launch)
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                 "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                 "cudaMemsetAsync")


def _trace_stats(prof):
    """Device busy ms, device event count, [(name, ms, count)] by time, and
    the device ms of the work each ``ssm.*`` range launched, read from the
    profiler's raw events: a kernel belongs to a range when the host call
    that launched it lies inside the range. The raw events are read once
    (~0.1 s for 10^5); ``key_averages`` builds an event tree first, which
    took minutes for an xlstm training step's ~3 x 10^5 kernels."""
    import bisect
    events = prof.profiler.kineto_results.events()
    cpu = torch.autograd.DeviceType.CPU
    ranges, launched, work = [], {}, []
    for e in events:
        name = e.name()
        if e.device_type() == cpu:
            if name.startswith("ssm."):
                ranges.append((e.start_ns(), e.end_ns(), name))
            elif name.startswith(_LAUNCH_CALLS):
                launched[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation() and not name.startswith("ssm."):
            work.append(e)
    ranges.sort()
    starts = [r[0] for r in ranges]
    by_name, cells = {}, {}
    for e in work:
        ms = e.duration_ns() / 1e6
        t, c = by_name.get(e.name(), (0.0, 0))
        by_name[e.name()] = (t + ms, c + 1)
        at = launched.get(e.correlation_id(),
                          launched.get(e.linked_correlation_id()))
        i = bisect.bisect_right(starts, at) - 1 if at is not None else -1
        if i >= 0 and at <= ranges[i][1]:
            cells[ranges[i][2]] = cells.get(ranges[i][2], 0.0) + ms
    rows = sorted(((k, t, c) for k, (t, c) in by_name.items()),
                  key=lambda r: -r[1])
    return sum(r[1] for r in rows), len(work), rows, cells


def _profile_recurrences(label, fn, device, n, untraced_ms, n_layers):
    """torch.profiler over ``fn`` (``n`` calls) with the recurrent cells
    labelled: device busy, idle share against the untraced time, kernels
    per layer, and the recurrences' share of the device time."""
    from torch.profiler import ProfilerActivity, profile
    restore = _labelled_recurrences()
    try:
        _sync(device)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            _sync(device)
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        restore()
    busy, launches, rows, cells = _trace_stats(prof)
    rec_ms = sum(cells.values())
    _report_trace(label, n, untraced_ms, wall, busy, launches, rows)
    share = rec_ms / busy if busy else float("nan")
    print(f"[trace] {label}: recurrences {', '.join(f'{k} {v / n:.3f} ms' for k, v in sorted(cells.items()))} "
          f"per call = {100 * share:.1f}% of device busy; "
          f"{launches / n / n_layers:.0f} kernels a layer | {CARD['line']}")
    return {"busy_ms": busy / n, "kernels": launches / n,
            "kernels_per_layer": launches / n / n_layers,
            "recurrence_ms": {k: v / n for k, v in cells.items()},
            "recurrence_share": share,
            "idle_share": (1 - busy / n / untraced_ms) if busy else None,
            "traced_wall_ms": wall / n}


def phase_trace_recurrent(device, eng, serve, n_steps=4):
    """12d: a hymba decode step traced: a fresh engine on the served
    weights admits 8 requests (prefix fills), then ``n_steps`` full steps
    run through the scheduler's control-array code."""
    dev = torch.device(device)
    eng = PagedDecodeEngine(lm=eng.lm, params=eng.params,
                            max_batch=eng.max_batch,
                            max_seq_len=eng.max_seq_len, max_new=eng.max_new,
                            page_size=eng.page_size, device=dev)
    sched = ContinuousScheduler(eng)
    plen = eng.max_seq_len - eng.prefix_len - eng.max_new
    reqs = _recurrent_requests(eng.lm.cfg, eng.max_batch, (plen, plen),
                               eng.max_new, 1)
    active = {a.slot: a for a in (sched._admit(r) for r in reqs)}

    def steps(n):
        for _ in range(n):
            ctrl = sched._build_ctrl(active, eng.max_batch, eng.scratch_idx,
                                     False, None)
            eng.step(ctrl)
            for a in active.values():
                a.fresh = False
                a.pos += 1
                a.fed += 1

    steps(1)                                  # warm
    return _profile_recurrences(
        f"{eng.lm.cfg.name} decode step ({eng.max_batch} active)",
        lambda: steps(n_steps), dev, n_steps, serve["median_step_ms"],
        eng.lm.cfg.n_layers)


def phase_train_trace_recurrent(device, trainer, train):
    """12d: one replica's training step (the loss on its 4 x 512 batch,
    the forward recomputed under remat, the gradients) of a recurrent
    run, traced with the recurrences labelled; the idle share against the
    same step untraced (host clock, synchronized). One replica, not the
    inner step's two: the profiler's host-side processing grows with the
    events, ~200,000 kernels a replica here."""
    dev = torch.device(device)
    leaves, treedef = tree_flatten(trainer.task.init())
    live = [x.requires_grad_(True) for x in leaves]
    inputs, targets = trainer.task.pipeline.replica_batch(0, 0)

    def step():
        loss, _ = trainer.task.loss_fn(tree_unflatten(treedef, live),
                                       (inputs, targets))
        return torch.autograd.grad(loss, live)

    step()                                             # warm
    _sync(dev)
    t0 = time.perf_counter()
    step()
    _sync(dev)
    untraced = (time.perf_counter() - t0) * 1e3
    stats = _profile_recurrences(
        f"{trainer.task.name} train (one replica's step)", step, dev, 1,
        untraced, train["layers"])
    stats["untraced_ms"] = untraced
    del live, leaves
    return stats


def _compare_runs(label, runs, f32, tol, tag="reference12"):
    """Phase 12b's gate on two serving runs of one model (the plain path,
    the kernel path): the greedy tokens equal (in bf16: or, at the first
    difference, the plain path's logit of the kernel path's token within
    REF_LOGIT_TOL of its largest: a tie at rounding), and in f32 every
    logit of every active slot at every step within ``tol``; the logits'
    largest distance is reported either way."""
    plain, kern = runs["naive"], runs["flash_pallas"]
    same = np.array_equal(plain["outputs"], kern["outputs"])
    steps = min(len(plain["step_logits"]), len(kern["step_logits"]))
    err, close, tie = 0.0, True, None
    for i in range(steps):
        (ma, a), (mb, b) = plain["step_logits"][i], kern["step_logits"][i]
        if not np.array_equal(ma, mb):
            break
        e, ok = _close(b, a, tol)
        err, close = max(err, e), close and ok
        ga, gb = a.argmax(-1), b.argmax(-1)
        if not torch.equal(ga, gb):
            j = int((ga != gb).nonzero()[0, 0])
            tie = float(a[j, ga[j]] - a[j, gb[j]])
            break
    tokens_ok = same or (not f32 and tie is not None
                         and tie <= REF_LOGIT_TOL)
    ok = tokens_ok and (close or not f32)
    print(f"[{tag}] {label}: kernel path vs plain path over "
          f"{steps} steps: greedy tokens equal {same}"
          f"{'' if tie is None else f' (first difference a tie of {tie:.4g})'}"
          f", max |dlogit| {err:.5g} ({f'each within {tol} + {tol}|logit|' if f32 else 'reported'}"
          f"{': ' + str(close) if f32 else ''}): {'pass' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: kernel path disagrees with plain")
    return {"tokens_equal": same, "tie": tie, "max_abs_dlogit": err,
            "steps": steps}


def phase_recurrent_reference(device, arch, dtype, *, reqs=None,
                              max_batch=2, seed=3, label=""):
    """12b: ``arch`` at full width cut to 2 layers, served twice on the
    same weights and requests, through the plain path (naive attention in
    the prefix fill, the plain paged version) and the kernel path
    (flash_pallas); ``_compare_runs`` is the gate. By default 3 requests
    over 2 slots, so a slot is reused (``reset_paged_states`` for
    xlstm, the prefix fill's overwrite for hymba)."""
    dev = torch.device(device)
    base = get_config(arch).with_(n_layers=2, dtype=dtype)
    params = build_model(base).init(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    if reqs is None:
        reqs = _recurrent_requests(base, 3, (40, 100), 16, seed)
    runs = {}
    for impl in ("naive", "flash_pallas"):
        runs[impl], eng = phase_serve_recurrent(
            dev, base.with_(attn_impl=impl), reqs=reqs, params=params,
            max_batch=max_batch, record=True)
        del eng
        gc.collect()
    f32 = dtype == "float32"
    tol = FLASH_TOL[torch.float32 if f32 else torch.bfloat16]
    out = _compare_runs(f"{arch} L2 {dtype}{label}", runs, f32, tol)
    out["launches"] = runs["flash_pallas"]["launches"]
    del params, runs
    torch.cuda.empty_cache()
    return out


def phase_recurrent(device):
    """Phase 12, the recurrent families. 12a: hymba-1.5b (32 layers) and
    xlstm-125m (12) at full width serve 8 requests; 12d traces a hymba
    decode step. 12b: each cut to 2 layers, kernel path against plain
    path in f32 and bf16 (3 requests over 2 slots), and hymba's
    window-binding run (the ring wraps). 12c: HWA training of xlstm-125m
    and of hymba-1.5b cut to 16 layers by phase 7's recipe; 12d traces an
    xlstm training step."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    out = {"serve": {}, "reference": {}, "train": {}}
    for arch in RECURRENT_SERVE_ARCHS:
        cfg = get_config(arch).with_(attn_impl="flash_pallas")
        res, eng = phase_serve_recurrent(dev, cfg)
        if arch == "hymba-1.5b":
            out["decode_trace"] = phase_trace_recurrent(dev, eng, res)
        res.pop("outputs")
        res.pop("step_logits")
        out["serve"][arch] = res
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for arch in RECURRENT_SERVE_ARCHS:
        out["reference"][arch] = {
            dt: phase_recurrent_reference(dev, arch, dt)
            for dt in ("float32", "bfloat16")}
    hymba = get_config("hymba-1.5b")
    window = _recurrent_requests(hymba, 1, (WINDOW_RUN["prompt"],) * 2,
                                 WINDOW_RUN["new"], 5)
    out["reference"]["window"] = phase_recurrent_reference(
        dev, "hymba-1.5b", "float32", reqs=window, max_batch=1,
        label=f" window-binding ({hymba.n_meta_tokens} + "
              f"{WINDOW_RUN['prompt']} + {WINDOW_RUN['new']} tokens)")
    for arch, layers in (("xlstm-125m", None),
                         ("hymba-1.5b", HYMBA_TRAIN_LAYERS)):
        full = get_config(arch)
        cfg = full.with_(n_layers=layers or full.n_layers,
                         attn_impl="flash_pallas", remat="full")
        train, trainer = phase_train(dev, cfg=cfg,
                                     full_layers=full.n_layers)
        if arch == "xlstm-125m":
            out["train_trace"] = phase_train_trace_recurrent(dev, trainer,
                                                             train)
        del trainer
        train.pop("final_wa")
        train.pop("final_window")
        out["train"][arch] = train
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[recurrent] phase 12 in {time.perf_counter() - t0:.1f} s | "
          f"{CARD['line']}")
    return out


# ------------------------------------------------- 13. vlm and audio

#: phase 13a's served models, in order (internvl2's weights are freed
#: before musicgen's are drawn)
MODALITY_ARCHS = ("internvl2-1b", "musicgen-medium")
#: 13a's traffic: phase 4's prompts, chunk, page and slots; 8 requests
#: fill the 8 slots at once. internvl2's carry 256 x 1,024 f32 patch
#: embeddings (the attention runs over 256 + 512 positions a chunk),
#: musicgen's are 4-codebook streams.
MODALITY_SERVE = dict(n_requests=8, prompt_range=(64, 512), max_new=32,
                      max_batch=8, page_size=16, prefill_chunk=512)
#: 13d: musicgen-medium cut from 48 to 24 layers (0.931B parameters; at
#: 48, 1.837B need ~92 GB of HWA state at phase 7's ~50 bytes a
#: parameter); internvl2-1b (0.631B) trains whole
MUSICGEN_TRAIN_LAYERS = 24
#: 13d's recipe: phase 7's K, H, I, 4 x 512 tokens a replica, SGD, lr
#: and schedule, over 6 steps (3 syncs); the tokens are the port's Markov
#: chain over the first 2,048 ids (a V x V chain at internvl2's 151,655
#: would take 92 GB), each codebook its own chain for musicgen
MODALITY_TRAIN = dict(steps=6, data_vocab=2048)
#: 13c's whole-batch engine: these archs at full width cut to 2 layers,
#: f32, B = 4 prompts of 256 tokens, 16 new
DECODE_ENGINE_ARCHS = ("granite-3-2b",) + MODALITY_ARCHS
DECODE_ENGINE_RUN = dict(layers=2, batch=4, prompt=256, new=16)


def _modality_requests(cfg, n, prompt_range, new, seed):
    """``n`` requests of ``prompt_range`` tokens from a numpy seed: (S,
    CB) codebook streams for audio; the VLM's carry f32 (n_vis, d_vis)
    vis_embeds."""
    rs = np.random.RandomState(seed)
    lens = rs.randint(prompt_range[0], prompt_range[1] + 1, size=n)
    cb = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    reqs = []
    for i, m in enumerate(lens):
        vis = (rs.randn(cfg.n_vis_tokens, cfg.d_vis).astype(np.float32)
               if cfg.family == "vlm" else None)
        reqs.append(Request(rid=i, tokens=rs.randint(
            0, cfg.vocab_size, size=(int(m),) + cb).astype(np.int32),
            n_new=new, vis_embeds=vis))
    return reqs


def phase_serve_modality(device, cfg, *, reqs=None, params=None, seed=0,
                         record=False, **traffic):
    """Serve a vlm or audio model through PagedDecodeEngine and
    ContinuousScheduler: each admission one chunk prefill over (vision
    prefix +) prompt, then the decode steps. ``traffic`` overrides
    MODALITY_SERVE's fields. On the card the launch counts must be exact:
    the flash forward n_layers x admissions, the paged kernel n_layers x
    decode steps. ``record`` keeps each prefill's and step's logits of
    the slots that emit, one row a codebook (13b compares two runs)."""
    dev = torch.device(device)
    t = dict(MODALITY_SERVE, **traffic)
    lm = build_model(cfg)
    if params is None:
        params = lm.init(torch.Generator(device=dev).manual_seed(seed),
                         device=dev)
    if reqs is None:
        reqs = _modality_requests(cfg, t["n_requests"], t["prompt_range"],
                                  t["max_new"], seed)
    max_new = max(r.n_new for r in reqs)
    npre = _prefix_len(cfg)
    eng = PagedDecodeEngine(
        lm=lm, params=params, max_batch=t["max_batch"],
        max_seq_len=npre + max(len(r.tokens) for r in reqs) + max_new,
        max_new=max_new, page_size=t["page_size"],
        prefill_chunk=t["prefill_chunk"], device=dev)
    pre_clock, step_clock = _Clock(dev), _Clock(dev)
    log = {"admissions": 0, "emitted": 0, "lens": [], "logits": []}
    finite = torch.ones((), dtype=torch.bool, device=dev)
    timed_prefill = pre_clock.wrap(eng.prefill_into)
    timed_step = step_clock.wrap(eng.step)

    def keep(rows, logits):
        nonlocal finite
        finite = finite & torch.isfinite(logits).all()
        if record:
            log["logits"].append((rows.copy(), logits.reshape(
                -1, logits.shape[-1]).float().clone()))

    def counted_prefill(slot, batch1, n_valid):
        log["admissions"] += 1
        timed_prefill(slot, batch1, n_valid)
        rows = np.zeros(eng.max_batch, bool)
        rows[slot] = True
        keep(rows, eng.state["logits"])

    def counted_step(ctrl):
        emitting = ctrl["out_idx"] != eng.scratch_idx
        log["emitted"] += int(emitting.sum())
        log["lens"].append([int(p) + 1 if e else 0
                            for p, e in zip(ctrl["pos"], emitting)])
        timed_step(ctrl)
        keep(emitting, eng.state["logits"][torch.as_tensor(emitting,
                                                           device=dev)])

    eng.prefill_into, eng.step = counted_prefill, counted_step
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    _reset_counts()
    t0 = time.perf_counter()
    outs = ContinuousScheduler(eng).run(reqs)
    _sync(dev)
    wall = time.perf_counter() - t0
    launches = _counts()
    steps = len(step_clock.spans)
    toks = np.stack([outs[r.rid] for r in reqs])
    cb = (cfg.n_codebooks,) if cfg.family == "audio" else ()
    if toks.shape != (len(reqs), max_new) + cb:
        raise AssertionError(f"output shape {toks.shape}")
    if toks.min() < 0 or toks.max() >= cfg.vocab_size:
        raise AssertionError("token outside the vocab range")
    if not bool(finite):
        raise AssertionError("non-finite logits")
    if log["admissions"] != len(reqs):
        raise AssertionError(f"{log['admissions']} admissions for "
                             f"{len(reqs)}")
    if dev.type == "cuda" and cfg.attn_impl == "flash_pallas":
        want = _want(flash_fwd=cfg.n_layers * log["admissions"],
                     paged_attention=cfg.n_layers * steps)
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
    pre_ms, step_ms = pre_clock.ms(), step_clock.ms()
    tail = int(100 * (1 - 10 / len(step_ms))) if len(step_ms) >= 20 else None
    prompt_tokens = sum(len(r.tokens) for r in reqs)
    full = [ln for ln in log["lens"] if all(ln)]
    res = {
        "arch": cfg.name, "layers": cfg.n_layers, "requests": len(reqs),
        "slots": eng.max_batch, "admissions": log["admissions"],
        "decode_steps": steps, "tokens": int(toks.size),
        "launches": launches, "prefix": npre,
        "prefill_tok_s": prompt_tokens / (sum(pre_ms) / 1e3),
        "prefill_positions_s": (prompt_tokens + npre * len(reqs))
        / (sum(pre_ms) / 1e3),
        "decode_tok_s": log["emitted"] / (sum(step_ms) / 1e3),
        "median_step_ms": float(np.median(step_ms)),
        "tail_pct": tail,
        "tail_step_ms": (float(np.percentile(step_ms, tail))
                         if tail else None),
        "median_prefill_ms": float(np.median(pre_ms)),
        "wall_s": wall,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                         if dev.type == "cuda" else None),
        "full_step_lens": max(full, key=sum) if full else None,
        "prompt_lens": [len(r.tokens) for r in reqs],
        "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
        "head_dim": cfg.resolved_head_dim, "table_width": eng.table_width,
        "outputs": toks, "step_logits": log["logits"],
    }
    print(f"[serve13] {cfg.name} L{cfg.n_layers} d{cfg.d_model} "
          f"H{cfg.n_heads}/{cfg.n_kv_heads} {cfg.family} {cfg.dtype} "
          f"{cfg.attn_impl} on {dev}: {len(reqs)} requests (prompts "
          f"{min(res['prompt_lens'])}-{max(res['prompt_lens'])} + prefix "
          f"{npre}, {max_new} new{f', {cb[0]} codebooks' if cb else ''}), "
          f"{eng.max_batch} slots, {log['admissions']} admissions, {steps} "
          f"decode steps, table width {eng.table_width}, launches "
          f"{launches}")
    print(f"[serve13] {cfg.name}: prefill {res['prefill_tok_s']:.1f} "
          f"prompt tok/s ({res['prefill_positions_s']:.1f} positions/s), "
          f"decode {res['decode_tok_s']:.1f} tok/s, median step "
          f"{res['median_step_ms']:.3f} ms (p{tail} {res['tail_step_ms']} "
          f"ms, n={steps}), median prefill {res['median_prefill_ms']:.3f} "
          f"ms, wall {wall:.2f} s, peak memory {res['peak_mem_gib']} GiB | "
          f"{CARD['line']}")
    return res, eng


def phase_trace_modality(device, eng, serve, n_steps=4):
    """13a's trace: a fresh engine on the served weights admits
    ``max_batch`` requests of the longest prompt that fits (chunk
    prefills), then ``n_steps`` full decode steps run traced through the
    scheduler's control-array code: device busy, idle share against 13a's
    untraced median, kernels a step and a layer."""
    dev = torch.device(device)
    cfg = eng.lm.cfg
    eng = PagedDecodeEngine(lm=eng.lm, params=eng.params,
                            max_batch=eng.max_batch,
                            max_seq_len=eng.max_seq_len, max_new=eng.max_new,
                            page_size=eng.page_size,
                            prefill_chunk=eng.prefill_chunk, device=dev)
    sched = ContinuousScheduler(eng)
    plen = min(eng.max_seq_len - eng.prefix_len - eng.max_new,
               eng.prefill_chunk)
    reqs = _modality_requests(cfg, eng.max_batch, (plen, plen), eng.max_new,
                              1)
    active = {a.slot: a for a in (sched._admit(r) for r in reqs)}
    audio = cfg.family == "audio"

    def steps(n):
        for _ in range(n):
            ctrl = sched._build_ctrl(active, eng.max_batch, eng.scratch_idx,
                                     audio, cfg.n_codebooks if audio else None)
            eng.step(ctrl)
            for a in active.values():
                a.pos += 1
                a.emitted += 1

    steps(1)                                  # warm
    wall, busy, launches, rows = _profile(lambda: steps(n_steps), dev)
    _report_trace(f"{cfg.name} decode step ({eng.max_batch} active)",
                  n_steps, serve["median_step_ms"], wall, busy, launches,
                  rows)
    return {"busy_ms": busy / n_steps, "kernels": launches / n_steps,
            "kernels_per_layer": launches / n_steps / cfg.n_layers,
            "idle_share": (1 - busy / n_steps / serve["median_step_ms"])
            if busy else None, "traced_wall_ms": wall / n_steps,
            "top": [(n, ms / n_steps) for n, ms, _ in rows[:6]]}


def phase_modality_reference(device, arch, dtype, seed=3, **traffic):
    """13b: ``arch`` at full width cut to 2 layers, served twice on the
    same weights and requests (3 over 2 slots, so a slot is reused)
    through the plain path (naive prefill attention, the plain paged
    version) and the kernel path (flash_pallas); phase 12b's
    ``_compare_runs`` is the gate, over the prefill's and every step's
    logits (one row a codebook). ``traffic`` overrides MODALITY_SERVE's
    fields."""
    dev = torch.device(device)
    base = get_config(arch).with_(n_layers=2, dtype=dtype)
    params = build_model(base).init(
        torch.Generator(device=dev).manual_seed(seed), device=dev)
    reqs = _modality_requests(base, 3, (40, 100), 16, seed)
    traffic.setdefault("max_batch", 2)
    runs = {}
    for impl in ("naive", "flash_pallas"):
        runs[impl], eng = phase_serve_modality(
            dev, base.with_(attn_impl=impl), reqs=reqs, params=params,
            record=True, **traffic)
        del eng
        gc.collect()
    f32 = dtype == "float32"
    tol = FLASH_TOL[torch.float32 if f32 else torch.bfloat16]
    out = _compare_runs(f"{arch} L2 {dtype}", runs, f32, tol,
                        tag="reference13")
    out["launches"] = runs["flash_pallas"]["launches"]
    del params, runs
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def phase_decode_engine(device, arch, tag="decode13", **run):
    """13c: the whole-batch DecodeEngine on ``arch`` at full width cut to
    2 layers in f32 (flash_pallas): one prefill of the whole batch (the
    flash forward n_layers x 1 times, at B = batch), then the plain
    one-token decode over the contiguous ring; its greedy tokens must
    equal the paged engine's on the same weights and prompts (chunk
    prefill and the paged kernel)."""
    dev = torch.device(device)
    r = dict(DECODE_ENGINE_RUN, **run)
    cfg = get_config(arch).with_(n_layers=r["layers"], dtype="float32",
                                 attn_impl="flash_pallas")
    lm = build_model(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(5), device=dev)
    B, S, new = r["batch"], r["prompt"], r["new"]
    batch = make_batch(cfg, B, S, seed=5)
    eng = DecodeEngine(lm, params, max_seq_len=S + new, device=dev)
    pre_clock, step_clock = _Clock(dev), _Clock(dev)
    eng.step = step_clock.wrap(eng.step)
    lm.prefill = pre_clock.wrap(lm.prefill)
    _sync(dev)
    _reset_counts()
    try:
        toks = eng.generate(batch, new)
        _sync(dev)
    finally:
        del lm.prefill
    launches = _counts()
    if dev.type == "cuda":
        want = _want(flash_fwd=cfg.n_layers)
        if launches != want:
            raise AssertionError(f"launch counts {launches} != {want}")
    paged = PagedDecodeEngine(
        lm=lm, params=params, max_batch=B,
        max_seq_len=_prefix_len(cfg) + S + new, max_new=new, page_size=16,
        prefill_chunk=S, device=dev).generate(batch, new)
    same = np.array_equal(toks.cpu().numpy(), paged.numpy())
    pre_ms, step_ms = pre_clock.ms(), step_clock.ms()
    res = {"arch": arch, "layers": cfg.n_layers, "batch": B, "prompt": S,
           "new": new, "tokens_equal": same, "launches": launches,
           "prefill_ms": pre_ms[0], "median_step_ms": float(np.median(
               step_ms)), "shape": tuple(toks.shape)}
    print(f"[{tag}] {arch} L{cfg.n_layers} d{cfg.d_model} f32 "
          f"DecodeEngine on {dev}: B{B} prompts of {S} (+ prefix "
          f"{_prefix_len(cfg)}), {new} new -> {tuple(toks.shape)}; prefill "
          f"{res['prefill_ms']:.3f} ms (flash forward at B{B}), median step "
          f"{res['median_step_ms']:.3f} ms; launches {launches}; tokens equal "
          f"to the paged engine's: {same} | {CARD['line']}")
    if not same:
        raise AssertionError(f"{arch}: DecodeEngine tokens differ from the "
                             f"paged engine's")
    del eng, params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return res


def _modality_train_batches(cfg, K, B, S, steps, device, seed=0):
    """Per step, a (K, ...) batch dict: tokens/targets from the Markov
    chain over MODALITY_TRAIN's first ids ((K, B, S, CB) for audio: one
    chain sample a codebook), f32 vis_embeds (K, B, n_vis, d_vis) for the
    VLM."""
    cb = cfg.n_codebooks if cfg.family == "audio" else 1
    ds = make_markov_lm_dataset(vocab=MODALITY_TRAIN["data_vocab"],
                                seq_len=S, n_train=K * steps * B * cb,
                                n_test=1, seed=seed, device=device)
    gen = torch.Generator(device=device).manual_seed(seed + 1)

    def shape(x):                         # (steps*K*B*cb, S) -> per step
        x = x.reshape(steps, K, B, cb, S)
        return x.permute(0, 1, 2, 4, 3) if cfg.family == "audio" \
            else x[:, :, :, 0]

    tokens, targets = shape(ds.train_inputs), shape(ds.train_targets)
    out = []
    for s in range(steps):
        b = {"tokens": tokens[s], "targets": targets[s]}
        if cfg.family == "vlm":
            b["vis_embeds"] = torch.randn((K, B, cfg.n_vis_tokens, cfg.d_vis),
                                          generator=gen, device=device)
        out.append(b)
    return out


def phase_train_modality(device, cfg, full_layers):
    """13d: HWA training of a vlm or audio config (K replicas, fused sync
    every H steps, SGD, phase 7's recipe) through ``core.hwa``'s
    ``hwa_inner_step`` and ``hwa_sync`` over dict batches (the Trainer's
    pipeline carries (tokens, targets) only, as the reference's does).
    Gates: finite losses and W̿; the loss falls, read on fixed data: W̿'s
    mean loss on the first step's K batches below the initial weights'
    (per-step losses are each on new batches, whose own spread over 6
    steps is as large as the fall: they are reported); exact launches
    (under remat="full" the forward runs twice a layer, replica and step;
    each of the 2 x K probe losses once a layer)."""
    dev = torch.device(device)
    K, H, I = TRAIN["K"], TRAIN["H"], TRAIN["I"]
    B, S, steps = TRAIN["batch"], TRAIN["seq"], MODALITY_TRAIN["steps"]
    batches = _modality_train_batches(cfg, K, B, S, steps, dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lm = build_model(cfg)
    opt = sgd(momentum=0.9, weight_decay=5e-4)
    sched = cosine_schedule(TRAIN["lr"], steps)
    hcfg = HWAConfig(n_replicas=K, sync_period=H, window=I, use_kernels=True)
    state = hwa_init(hcfg, lm.init(torch.Generator(device=dev).manual_seed(0),
                                   device=dev), opt)
    step_clock, sync_clock = _Clock(dev), _Clock(dev)
    inner = step_clock.wrap(hwa_inner_step)
    sync = sync_clock.wrap(hwa_sync)

    @torch.no_grad()
    def probe(params):
        """Mean loss of ``params`` over the first step's K batches."""
        return float(np.mean([float(lm.loss(params, {
            k: v[r] for k, v in batches[0].items()})[0]) for r in range(K)]))

    losses = []
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    _reset_counts()
    init_probe = probe(state.wa)
    t0 = time.perf_counter()
    for step in range(steps):
        state, m = inner(hcfg, state, batches[step], lm.loss, opt,
                         sched(step))
        losses.append(m["per_replica_loss"])
        if (step + 1) % H == 0:
            state, _ = sync(hcfg, state)
    _sync(dev)
    wall = time.perf_counter() - t0
    wa_probe = probe(state.wa)
    launches = _counts()
    per_step = torch.stack(losses).float().cpu()
    if not bool(torch.isfinite(per_step).all()):
        raise AssertionError(f"non-finite training loss: {per_step}")
    wa_finite = all(bool(torch.isfinite(x).all())
                    for x in tree_leaves(state.wa))
    if not wa_finite:
        raise AssertionError("non-finite W̿")
    step_loss = per_step.mean(1).tolist()
    first, last = float(np.mean(step_loss[:2])), float(np.mean(step_loss[-2:]))
    if not (np.isfinite(wa_probe) and wa_probe < init_probe):
        raise AssertionError(f"loss did not fall: on the first step's "
                             f"batches {init_probe:.4f} at init, "
                             f"{wa_probe:.4f} under W̿")
    L, syncs = cfg.n_layers, steps // H
    fwd_per_layer = 2 if cfg.remat != "none" else 1
    want = _want(flash_fwd=fwd_per_layer * steps * K * L + 2 * K * L,
                 wa_sync_fused=syncs, flash_bwd_dq=steps * K * L,
                 flash_bwd_dkv=steps * K * L)
    if dev.type == "cuda" and launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    step_ms, sync_ms = step_clock.ms(), sync_clock.ms()
    med_step = float(np.median(step_ms))
    tokens = K * B * S
    positions = K * B * (S + cfg.n_vis_tokens * (cfg.family == "vlm"))
    n_matmul = train_matmul_param_count(cfg)
    res = {"arch": cfg.name, "layers": L, "params": train_param_count(cfg),
           "steps": steps, "syncs": syncs, "launches": launches,
           "step_loss": step_loss, "init_probe_loss": init_probe,
           "wa_probe_loss": wa_probe, "median_step_ms": med_step,
           "step_ms": step_ms, "tok_s": tokens / (med_step / 1e3),
           "mfu": 6 * n_matmul * positions / (med_step / 1e3)
           / PEAK_FLOPS[torch.bfloat16],
           "median_sync_ms": float(np.median(sync_ms)), "wall_s": wall,
           "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2**30
                            if dev.type == "cuda" else float("nan"))}
    extra = {"audio": f" x {cfg.n_codebooks} codebooks",
             "vlm": f" + {cfg.n_vis_tokens} vision positions"}.get(
                 cfg.family, "")
    print(f"[train13] {cfg.name} L{L} (cut from {full_layers}) "
          f"d{cfg.d_model} H{cfg.n_heads}/{cfg.n_kv_heads} {cfg.family} "
          f"{cfg.dtype} remat={cfg.remat}, {res['params'] / 1e6:.1f}M params: "
          f"HWA K{K} H{H} I{I} fused sync via hwa_inner_step/hwa_sync, SGD "
          f"lr {TRAIN['lr']} m0.9 wd5e-4 cosine, {B}x{S} tokens per replica"
          f"{extra}"
          f", {steps} steps, {syncs} syncs, launches {launches}")
    print(f"[train13] {cfg.name}: loss per step "
          f"{[round(x, 4) for x in step_loss]} (first two {first:.4f} -> "
          f"last two {last:.4f}); on the first step's batches "
          f"{init_probe:.4f} at init -> {wa_probe:.4f} under W̿; median "
          f"inner step {med_step:.3f} ms, "
          f"{res['tok_s']:.1f} tok/s, mfu {res['mfu']:.4f} "
          f"({n_matmul / 1e6:.1f}M "
          f"parameters in products, {positions} positions), median sync "
          f"{res['median_sync_ms']:.3f} ms, peak memory "
          f"{res['peak_mem_gib']:.3f} GiB, wall {wall:.2f} s | "
          f"{CARD['line']}")
    del state, batches
    return res


def phase_modality(device):
    """Phase 13, the VLM and audio families and the whole-batch engine.
    13a: internvl2-1b (24 layers) and musicgen-medium (48) at full width
    serve 8 requests, each with a trace of 4 decode steps. 13b: each cut
    to 2 layers, kernel path against plain path in f32 and bf16. 13c: the
    DecodeEngine against the paged engine on granite-3-2b and both. 13d:
    HWA training of internvl2-1b whole and musicgen-medium cut to 24
    layers."""
    dev = torch.device(device)
    t0 = time.perf_counter()
    out = {"serve": {}, "trace": {}, "reference": {}, "decode_engine": {},
           "train": {}}
    for arch in MODALITY_ARCHS:
        cfg = get_config(arch).with_(attn_impl="flash_pallas")
        res, eng = phase_serve_modality(dev, cfg)
        out["trace"][arch] = phase_trace_modality(dev, eng, res)
        res.pop("outputs")
        res.pop("step_logits")
        out["serve"][arch] = res
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for arch in MODALITY_ARCHS:
        out["reference"][arch] = {
            dt: phase_modality_reference(dev, arch, dt)
            for dt in ("float32", "bfloat16")}
    for arch in DECODE_ENGINE_ARCHS:
        out["decode_engine"][arch] = phase_decode_engine(dev, arch)
        gc.collect()
    for arch, layers in (("internvl2-1b", None),
                         ("musicgen-medium", MUSICGEN_TRAIN_LAYERS)):
        full = get_config(arch)
        cfg = full.with_(n_layers=layers or full.n_layers,
                         attn_impl="flash_pallas", remat="full")
        out["train"][arch] = phase_train_modality(dev, cfg, full.n_layers)
        gc.collect()
        torch.cuda.empty_cache()
    print(f"[modality] phase 13 in {time.perf_counter() - t0:.1f} s | "
          f"{CARD['line']}")
    return out


# ------------------------------------------------- 14. the large dense LMs

#: 14a-b: the two largest dense configs served whole in bf16 through
#: PagedDecodeEngine + ContinuousScheduler. gemma2-27b: 6 requests over
#: 4 slots (admissions mid-run), prompts of 4,200-5,800 tokens in one
#: chunk of 5,888 (46 x 128), so every prefill and decode step binds the
#: window of the local layers; its pool is 1 + 4 x 370 pages (~8.3 GiB).
#: command-r-35b: phase 4's traffic (12 requests, 8 slots, 64-512).
LARGE_SERVE = {
    "gemma2-27b": dict(n_requests=6, max_batch=4, prefill_chunk=GEMMA2_CHUNK,
                       max_seq_len=5920, prompt_range=(4200, 5800)),
    "command-r-35b": {},
}
#: the served trees' parameter counts, in billions to 3 decimals (the
#: reference's init shapes)
LARGE_PARAMS_B = {"gemma2-27b": 28.407, "command-r-35b": 32.381}
#: 14c: each cut to 2 layers (gemma2 keeps one local and one global
#: layer); gemma2's prompt of 4,700 in a chunk of 4,736 binds the window
#: in the prefill and the decode step; command-r runs G = 8
LARGE_REFERENCE = {"gemma2-27b": dict(prompt_len=4700, chunk=4736),
                   "command-r-35b": dict(prompt_len=300)}
#: 14d: gemma2 cut to 2 layers in f32 through the whole-batch
#: DecodeEngine: its contiguous ring (window 4096) wraps in the prefill
LARGE_DECODE = dict(arch="gemma2-27b", batch=2, prompt=4500, new=16)


def phase_large(device, serve_over=None, reference=None, decode=None):
    """Phase 14: gemma2-27b and command-r-35b, one at a time, on a card
    that holds nothing else (checked: under 1 GiB allocated). 14a-b: each
    served whole (``LARGE_SERVE``; ``serve_over`` overrides its traffic)
    with phase 4's gates, its parameter count, peak memory under 80 GB
    and, for a windowed model, every prompt past the window; then traced
    at the run's shortest prompt (its caches dropped first: the trace
    builds a second pool on the same weights). 14c: each cut to 2
    layers, kernel path against plain path in f32 and bf16
    (``phase_reference``; ``reference`` overrides its arguments). 14d:
    ``phase_decode_engine`` at ``LARGE_DECODE`` (``decode`` overrides)."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        held = torch.cuda.memory_allocated(dev)
        if held >= 2**30:
            raise AssertionError(f"{held / 2**30:.2f} GiB held on the card "
                                 f"before phase 14")
    out = {"serve": {}, "reference": {}}
    for arch, traffic in LARGE_SERVE.items():
        cfg = get_config(arch).with_(attn_impl="flash_pallas")
        traffic = dict(traffic, **(serve_over or {}).get(arch, {}))
        serve, eng = phase_serve(dev, cfg, **traffic)
        window = cfg.sliding_window if cfg.global_every else None
        if window and min(serve["prompt_lens"]) <= window:
            raise AssertionError(f"{arch}: a prompt within the window")
        if cuda:
            if round(serve["params"] / 1e9, 3) != LARGE_PARAMS_B[arch]:
                raise AssertionError(f"{arch}: {serve['params']} parameters")
            if serve["peak_mem_gib"] * 2**30 >= 80e9 or \
                    serve["init_peak_gib"] * 2**30 >= 80e9:
                raise AssertionError(f"{arch}: peak memory over 80 GB")
        eng.state = None
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        phase_trace(dev, eng, serve, prompt_len=min(serve["prompt_lens"]))
        del eng
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        serve.pop("outputs")
        out["serve"][arch] = serve
    for arch, kw in LARGE_REFERENCE.items():
        kw = dict(kw, **(reference or {}).get(arch, {}))
        out["reference"][arch] = [
            phase_reference(dev, arch=arch, dtype=dt, **kw)
            for dt in ("float32", "bfloat16")]
        if cuda:
            torch.cuda.empty_cache()
    out["decode_engine"] = phase_decode_engine(
        dev, tag="decode14", **dict(LARGE_DECODE, **(decode or {})))
    return out


# ---------------------------------------------------- 15. mesh-native HWA

#: phase 15: HWA across processes (``launch.train.run_mesh_native``: one
#: spawned rank a replica, ``gloo`` on this one card, CUDA tensors staged
#: through host memory) on granite-3-2b at its published width cut to
#: MESH_LAYERS layers, with the flash kernels and remat off, H 2, I 2
#: (a slot less in each of 15a's two saves than I 3 would write), SGD
#: lr 0.1, 4 x 512 tokens a replica a step. Depth: each rank holds its
#: replica (bf16), f32 momentum, the f32 ring of I slots and total, and
#: the packed f32 sync buffers, ~36 bytes a parameter: 262.2M at 1 layer
#: (phase 16 takes the time a second layer would: 322.8M, ~12 GB a
#: rank), ~40 GB for K = 4 (15b-c) and for 15d's two runs side by side.
#: Checkpoints (15a, 15d) are gathered to rank 0's host.
MESH_LAYERS = 1
MESH_FULL = True
MESH_RUN = dict(arch="granite-3-2b", steps=8, sync_period=2, window=2,
                batch_size=4, seq_len=512, lr=0.1, seed=0, device="cuda")
#: 15a's comparison with the one-process stacked run: the reference's
#: bf16 budget (rel-ULPs) on W̿ and the replicas, 1e-3 on the losses
MESH_STACKED_ULPS = 4.0
MESH_LOSS_TOL = 1e-3
#: 15c: the compressed rings and payloads against an exact f32 window of
#: the same replicas (benchmarks/thresholds.json ``ulp_budgets``)
MESH_ULP_BUDGET = {"bf16": 4.0, "fp8": 4.0}


def _mesh_cfg(n_layers=None):
    """Phase 15's model: granite-3-2b at its published width cut to
    MESH_LAYERS, or ``n_layers`` (the smoke config when MESH_FULL is off,
    as the CPU rehearsal runs it), the flash kernels, remat off."""
    from repro_torch.configs import get_smoke_config
    cfg = (get_config("granite-3-2b").with_(
        n_layers=n_layers or MESH_LAYERS)
        if MESH_FULL else get_smoke_config("granite-3-2b"))
    return cfg.with_(attn_impl="flash_pallas", remat="none")


def _mesh_args(K, **kw):
    from repro_torch.launch.train import mesh_args
    return mesh_args(**dict(MESH_RUN, k=K, **kw))


def _mesh_report(label, out, cfg, tag="mesh15", beside=None):
    """Print a run's syncs (rank 0's ms, each level's collectives and
    bytes a rank, host-staged bytes) and its launches; return them.
    ``beside`` names the runs that shared the card and the host with it
    (its times are taken under their load)."""
    K = out["mesh"].get("pod", 1) * out["mesh"]["replica"]
    syncs = out["ranks"][0]["syncs"]
    for h, s in zip(out["history"], syncs):
        lv = "; ".join(
            f"{name}: {r['all_reduce']} all-reduce {r['all_gather']} "
            f"all-gather, {r['bytes'] / 2**20:.1f} MiB, staged "
            f"{r['staged_bytes'] / 2**20:.1f} MiB"
            for name, r in s["collectives"].items())
        p = h.get("probe")
        if p is None:
            print(f"[{tag}] {label} step {h['step']} {h['sync']} sync "
                  f"{s['ms']:.1f} ms | {lv} | not probed")
            continue
        print(f"[{tag}] {label} step {h['step']} {h['sync']} sync "
              f"{s['ms']:.1f} ms | {lv} | W̄ {p['mean_ulps']} ULP"
              + (f" ({p['mean_rel_ulps']:.3f} rel-ULP of the ring dtype)"
                 if "mean_rel_ulps" in p else "")
              + f", restarts equal {p['restarts_equal']}"
              + (f", W̿ {p['wa_rel_ulps']:.3f} rel-ULP"
                 if "wa_rel_ulps" in p else ""))
    by_kind = {}
    for s in syncs:
        by_kind.setdefault(s["sync"], []).append(s["ms"])
    med = {k: round(float(np.median(v)), 1) for k, v in by_kind.items()}
    peaks = [r["peak_gib"] for r in out["ranks"]]
    print(f"[{tag}] {label}: {cfg.name} L{cfg.n_layers} d{cfg.d_model} K{K} "
          f"{out['mesh']} backend {out['backend']}, {out['syncs']} syncs, "
          f"median sync ms {med}"
          + (f" (under the load of {beside}, beside it)" if beside else "")
          + f", losses first {np.mean(out['losses'][0]):.4f} last "
          f"{np.mean(out['losses'][-1]):.4f}, launches "
          f"{ {k: v for k, v in out['launches'].items() if v} }, peak "
          f"device memory per rank "
          f"{[None if p is None else round(p, 2) for p in peaks]} GiB | "
          f"{CARD['line']}")
    return {"sync_ms": by_kind, "syncs": syncs, "history": out["history"],
            "launches": out["launches"], "losses": out["losses"],
            "peak_gib": peaks, "beside": beside}


def _nonzero(rows):
    return {lvl: {op: n for op, n in row.items()
                  if op in ("all_reduce", "all_gather", "gather", "barrier")
                  and n}
            for lvl, row in rows.items()}


def launcher_violations(out) -> list[str]:
    """A run's contract and audit violations
    (``launch.train.contract_violations``, ``audit_violations``)."""
    from repro_torch.launch.train import audit_violations, \
        contract_violations
    return contract_violations(out) + audit_violations(out)


#: 18b's record: per checked run, its recorded calls' payloads and peaks
LINT_RECORDED: list = []


def _mesh_checks(label, out, *, exact=True, cuda=True):
    """Every rank's train steps and syncs issue exactly the collectives
    their bundles declare (``launch.train.contract_violations``: a train
    step never crosses a replica axis, with one rank a replica it issues
    none; every recorded sync and rest call passes the contract
    checker's collectives pass), every sync passes the reference's audit
    (``launch.train.audit_violations``: flat, grouped, the tree's inner
    and outer levels), every recorded sync and rest call passes the
    dtype and donation passes (18b: ``launch.train
    .recorded_violations``: its payloads and arguments, its window state
    in place, on the card its peak within its declared working set), and
    on the card launch exactly the kernels the bundles declare; every
    rank restarted from the same W̄; with ``exact`` every W̄ 0 ULP from
    its core.online oracle. Each failure names its pass."""
    from repro_torch.launch.train import recorded_violations
    bad = launcher_violations(out) + recorded_violations(
        out, ("dtype", "donation"))
    if bad:
        raise AssertionError(f"{label}: calls off their contracts: {bad}")
    for rank in out["ranks"]:
        want = rank["declared_launches"]
        got = {k: v for k, v in rank["launches"].items() if v}
        if cuda and (want is None
                     or got != {k: v for k, v in want.items() if v}):
            raise AssertionError(f"{label}: launch_budget: rank "
                                 f"{rank['rank']} launched {got}, its "
                                 f"bundles declare {want}")
    bad = [h for h in out["history"] if "probe" in h and (
        not h["probe"]["restarts_equal"]
        or (exact and h["probe"]["mean_ulps"]))]
    if bad:
        raise AssertionError(f"{label}: W̄ off its oracle, or ranks "
                             f"restarted from different W̄: {bad}")
    calls = [c for r in out["ranks"] for c in r["syncs"] + r["rests"]]
    payloads: dict = {}
    for c in calls:
        for _, lvl, tok in c["artifacts"].payloads:
            payloads.setdefault(lvl, set()).add(tok)
    peaks = [(c["artifacts"].peak_above_start,
              c["contract"].donation.peak_bytes)
             for c in calls if c["artifacts"].peak_above_start is not None
             and c["contract"].donation.peak_bytes is not None]
    LINT_RECORDED.append({"label": label, "calls": len(calls),
                          "payloads": {k: sorted(v)
                                       for k, v in payloads.items()},
                          "peaks": peaks})


def _stacked_mesh_run(dev, cfg, K):
    """Phase 7's path on 15a's batches: ``hwa_inner_step``/``hwa_sync``
    with K stacked replicas in this process, the fused sync kernel.
    Returns the losses, W̿ and replicas on the host."""
    from repro_torch.launch.train import mesh_batch
    t0 = time.perf_counter()
    lm = build_model(cfg)
    params = lm.init(torch.Generator(device=dev).manual_seed(
        MESH_RUN["seed"]), device=dev)
    hcfg = HWAConfig(n_replicas=K, window=MESH_RUN["window"],
                     use_kernels=True)
    opt = sgd(momentum=0.9, weight_decay=5e-4)
    state = hwa_init(hcfg, params, opt)
    del params
    losses = []
    for step in range(MESH_RUN["steps"]):
        b = mesh_batch(MESH_RUN["seed"], step, K, MESH_RUN["batch_size"],
                       MESH_RUN["seq_len"], cfg.vocab_size)
        state, m = hwa_inner_step(hcfg, state, {
            k: torch.from_numpy(v).to(dev) for k, v in b.items()},
            lm.loss, opt, MESH_RUN["lr"])
        losses.append(m["per_replica_loss"].float().cpu().tolist())
        if (step + 1) % MESH_RUN["sync_period"] == 0:
            state, _ = hwa_sync(hcfg, state)
    out = {"losses": losses, "wa": tree_map(lambda x: x.cpu(), state.wa),
           "inner": tree_map(lambda x: x.cpu(), state.inner)}
    del state
    _free(dev)
    out["s"] = time.perf_counter() - t0
    return out


def phase_mesh_flat(device, ckpt_dir, ref):
    """15a: flat sync, K = 2 ranks, f32 ring, 8 steps, a checkpoint every
    4 steps into ``ckpt_dir`` (15d's saves): every W̄ 0 ULP from
    ``online_average_canonical`` of the replicas gathered before it (on
    the card); the launches and collectives each rank's bundles declare
    (the window update once a rank a sync; the flash forward and both
    sweeps once a layer a step a rank; no collective in a train step and
    one two-way all-reduce a sync); the run held against phase 7's
    stacked path on the same batches (``ref``, ``_stacked_mesh_run``'s,
    run first). Returns the report and the run (its final state's digest
    is 15d's uninterrupted run)."""
    from repro_torch.launch.train import run_mesh_native
    dev = torch.device(device)
    K = 2
    cfg = _mesh_cfg()
    args = _mesh_args(K, device=dev.type, checkpoint_dir=ckpt_dir,
                      checkpoint_every=4)
    t1 = time.perf_counter()
    _reset_counts()
    out = run_mesh_native(args, cfg=cfg, probe=True,
                          with_state=("inner", "wa"), digest=True)
    parent = _counts()
    print(f"[mesh15] 15a: the stacked run {ref['s']:.1f} s, the mesh-native "
          f"run {time.perf_counter() - t1:.1f} s, its checkpoints "
          + ", ".join(f"step {c['step']} {c['gb']:.3f} GB in {c['s']:.1f} s"
                      for c in out["saves"]))
    if any(parent.values()):
        raise AssertionError(f"15a: this process launched {parent}")
    if [c["step"] for c in out["saves"]] != [4, 8]:
        raise AssertionError(f"15a: saves {out['saves']}")
    _mesh_checks("15a", out, cuda=dev.type == "cuda")
    st = out.pop("_state")
    wa_err = max(rel_ulp_error(r, g, "bf16") for r, g in zip(
        tree_leaves(ref["wa"]), tree_leaves(st["wa"])))
    inner_err = max(rel_ulp_error(r, g, "bf16") for r, g in zip(
        tree_leaves(ref["inner"]), tree_leaves(st["inner"])))
    loss_err = float(np.max(np.abs(np.asarray(ref["losses"])
                                   - np.asarray(out["losses"]))))
    bitwise = _trees_bits_equal(ref["wa"], st["wa"]) and \
        _trees_bits_equal(ref["inner"], st["inner"])
    del st, ref
    print(f"[mesh15] 15a against the stacked one-process run: W̿ "
          f"{wa_err:.3f} rel-ULP, replicas {inner_err:.3f} rel-ULP (bf16; "
          f"limit {MESH_STACKED_ULPS}), losses |d| {loss_err:.2e} (limit "
          f"{MESH_LOSS_TOL}), bit-equal {bitwise}")
    if not (wa_err <= MESH_STACKED_ULPS and inner_err <= MESH_STACKED_ULPS
            and loss_err <= MESH_LOSS_TOL):
        raise AssertionError("15a: the mesh-native run left the stacked "
                             "run's tolerance")
    res = _mesh_report("15a flat", out, cfg, beside="15b-c")
    res.update(wa_rel_ulps=wa_err, inner_rel_ulps=inner_err,
               loss_err=loss_err, bitwise=bitwise, saves=out["saves"])
    return res, out


def phase_mesh_tree(device):
    """15b: the two-level tree, K = 4 ranks as 2 pods of 2, H₂ 2, f32, 4
    steps (an inner and an outer sync): the inner sync crosses no pod and
    pushes no window, every W̄ 0 ULP from ``pod_mean_grouped``/
    ``online_average_grouped``. 15c: the bf16 ring with bf16 comms and
    the fp8 ring with fp8 comms on the same tree: W̿ within the
    reference's budgets of an exact f32 window fed the exact means of the
    same replicas, the cross-pod payload 2 or 1 bytes an element plus the
    fp8 scales. The three runs share one spawn of the four ranks; 15c
    probes its outer syncs only (its inner syncs are 15b's, bit for bit:
    the same replicas through the same f32 level)."""
    from repro_torch.launch.train import run_mesh_native
    K, steps = 4, 4
    toks = ("f32", "bf16", "fp8")
    cuda = torch.device(device).type == "cuda"
    cfg = _mesh_cfg()
    _reset_counts()
    t0 = time.perf_counter()
    outs = run_mesh_native(
        [_mesh_args(K, sync_tree="two-level", outer_every=2, wa_dtype=tok,
                    comms_dtype=tok, steps=steps,
                    device=torch.device(device).type) for tok in toks],
        cfg=cfg, probe=[True, "outer", "outer"], with_state=False)
    print(f"[mesh15] 15b-c: the three runs in one spawn "
          f"{time.perf_counter() - t0:.1f} s")
    if any(_counts().values()):
        raise AssertionError(f"15b-c: this process launched {_counts()}")
    res = {}
    for tok, out in zip(toks, outs):
        label = "15b" if tok == "f32" else f"15c {tok}"
        if [h["sync"] for h in out["history"]] != ["inner", "outer"]:
            raise AssertionError(f"{label}: syncs {out['history']}")
        _mesh_checks(label, out, exact=tok == "f32", cuda=cuda)
        P = None
        for s in out["ranks"][0]["syncs"]:
            rep = s["collectives"]["replica"]
            P = rep["bytes"] // 4
            if s["sync"] == "outer" and tok != "f32":
                pod = s["collectives"]["pod"]["bytes"]
                want_b = 2 * P if tok == "bf16" else P + 4 * (P // ALIGN)
                if pod != want_b:
                    raise AssertionError(f"{label}: cross-pod payload "
                                         f"{pod} B != {want_b} B")
        for h in out["history"]:
            if tok != "f32" and h["sync"] == "outer" and not (
                    h["probe"]["wa_rel_ulps"] <= MESH_ULP_BUDGET[tok]):
                raise AssertionError(f"{label}: W̿ {h['probe']} past the "
                                     f"{tok} budget")
        res[tok] = _mesh_report(label, out, cfg, beside="15a")
        res[tok]["packed"] = P
    return res


def phase_mesh_faults(device, flat_run, ckpt_dir):
    """15d: the fault check's three mesh legs at 15a's size, two runs side
    by side. nan-replica: a NaN replica quarantined (k_alive 1) and
    recovered (2) with W̿ finite, through the alive-masked sync over the
    full-width buffer. corrupt-fallback over 15a's session: a bit flipped
    in step 8's replicas fails its CRC, the ranks' own scan falls back to
    step 4, and the run resumed from it ends with the SHA-256 of 15a's
    uninterrupted final state. That resume is resume-exact's
    checkpoint@4 + --resume, so resume-exact is not run a second time.
    Each leg prints its ranks' device memory (after the resume's load,
    and at the peak)."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.resilience import check as fault_check
    run = {k: MESH_RUN[k] for k in ("arch", "window", "sync_period",
                                    "batch_size", "seq_len", "lr", "seed")}
    run["cfg"] = _mesh_cfg()
    legs = [fault_check.Leg("nan-replica", lambda d: fault_check
                            .leg_nan_replica(d, run=run)),
            fault_check.Leg("corrupt-fallback", lambda d: fault_check
                            .leg_corrupt_fallback(d, run=run,
                                                  saved=(flat_run, ckpt_dir)))]
    dev = torch.device(device)
    with ThreadPoolExecutor(len(legs)) as pool:
        report = dict(zip((leg.name for leg in legs), pool.map(
            lambda leg: fault_check.run_leg(leg, dev), legs)))
    for name, r in report.items():
        print(f"[mesh15] 15d {name}: {'ok' if r['ok'] else 'FAIL'} — "
              f"{r.get('detail', r.get('error'))}")
    if not all(r["ok"] for r in report.values()):
        raise AssertionError(f"15d: fault legs failed: {report}")
    print("[mesh15] 15d resume-exact: ok — corrupt-fallback's resume is "
          "checkpoint@4 + --resume, bit-equal (SHA-256) to the "
          "uninterrupted 15a run")
    return report


def phase_mesh(device):
    """Phase 15: mesh-native HWA across processes (15a-d), on a card this
    process holds little of (checked: under 4 GiB allocated). Launch
    counts and device memory apply on the card only. 15a's checkpoints
    live in a temporary directory until 15d is done."""
    import shutil
    import tempfile
    dev = torch.device(device)
    _free(dev)
    held = (torch.cuda.memory_allocated(dev) / 2**30
            if dev.type == "cuda" else 0.0)
    print(f"[mesh15] this process holds {held:.2f} GiB of the card before "
          f"spawning the ranks")
    if held > 4.0:
        raise AssertionError(f"phase 15 needs the card: {held:.2f} GiB "
                             f"held")
    from concurrent.futures import ThreadPoolExecutor
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        t0 = time.perf_counter()
        out = {}
        # 15a's one-process reference first: it launches kernels here
        ref = _stacked_mesh_run(dev, _mesh_cfg(), 2)
        # 15a and 15b-c side by side (their 6 ranks fit the card at once;
        # their sync times are taken under each other's load)
        with ThreadPoolExecutor(2) as pool:
            flat = pool.submit(phase_mesh_flat, dev, ckpt_dir, ref)
            tree = pool.submit(phase_mesh_tree, dev)
            out["flat"], flat_run = flat.result()
            out["tree"] = tree.result()
        _free(dev)
        t2 = time.perf_counter()
        out["faults"] = phase_mesh_faults(device, flat_run, ckpt_dir)
        t3 = time.perf_counter()
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"[mesh15] phase 15 in {t3 - t0:.1f} s (15a with 15b-c beside "
          f"it {t2 - t0:.1f} s, 15d {t3 - t2:.1f} s) | {CARD['line']}")
    return out


# ------------------------------------- 16. data and model axes inside
#: phase 16: the K 2 replicas of phase 15's model split over a data axis
#: (16a), a model axis (16b) and both with FSDP (16c), 4 steps, H 2, I 2
#: (16c's 8 ranks share the card: each holds the whole embedding and head,
#: as the vocab of 49,155 splits over no axis; 16a and 16b run side by
#: side)
PAR_RUN = dict(MESH_RUN, steps=4)
#: 16c's checkpoint, at smoke width: saved at step 4, resumed elsewhere
PAR_CKPT_EVERY = 4



def _par_report(label, out, cfg, beside=None, tag="mesh16"):
    """A phase-16 or -17 run's report (``_mesh_report``) with its layout
    and each rank's peak device memory."""
    lay = out["layout"]
    t = out["ranks"][0]["times"]
    print(f"[{tag}] {label}: layout "
          f"{'grouped' if lay['grouped'] else 'one range'}, "
          f"{lay['n_groups']} group(s) of {lay['shards']} segment(s), "
          f"{lay['padded']} elements, {lay['local_padded']} a rank; rank "
          f"0: set-up {t['init_s']:.1f} s, train steps "
          f"{[round(x, 1) for x in t['step_ms']]} ms, probes "
          f"{t['probe_s']:.1f} s")
    res = _mesh_report(label, out, cfg, tag=tag, beside=beside)
    res["layout"] = {k: v for k, v in lay.items() if k != "json"}
    res["times"] = t
    return res


def _par_probes(label, out, host: bool):
    """Every W̄ 0 ULP from its oracle, the restarts equal, and with
    ``host`` rank 0's W̿ 0 ULP from the stacked per-leaf ``hwa_sync`` run
    on the host over the K replicas' blocks of rank 0's part."""
    for h in out["history"]:
        p = h["probe"]
        if p["mean_ulps"] or not p["restarts_equal"] or (
                host and p.get("wa_host_ulps", 1)):
            raise AssertionError(f"{label}: sync off its oracle: {h}")


def phase_mesh_parallel(device):
    """Phase 16: a data and a model axis inside a replica
    (``--mesh-native`` with ``--world-size``, ``--tp``, ``--fsdp``), phase
    15's model (full width, 1 layer) on ``gloo`` on the one card, K 2, 4
    steps, H 2.

    16c first, alone on the card, FSDP with TP: K 2 × data 2 × model 2 (8
    ranks), ``flash_jnp``: the grouped layout (n_groups ≥ 2), the window
    update once a group a sync on each rank's segment, every W̄ 0 ULP; in
    the same spawn a smoke-width bf16 run whose W̿ is held 0 ULP against
    the stacked per-leaf ``hwa_sync`` on the host at every sync and which
    saves its checkpoint at step 4.
    Then three spawns side by side (their 10 ranks fit the card at once;
    their times are taken under each other's load):
    16a, the data axis: K 2 × data 2 (4 ranks), the flash kernels: each
    rank steps 2 of its replica's 4 rows, gradients and loss averaged over
    ``data`` (one all-reduce a dtype a step); every W̄ 0 ULP from the
    canonical mean of the replicas gathered before it; the flash kernels
    launched exactly once a layer a step a rank; the train steps
    data-level collectives only, the syncs replica-level only;
    16b, the model axis: K 2 × model 2 (4 ranks), ``flash_jnp``: the
    head-parallel attention and the column-then-row MLP, the embedding
    and head whole (the vocab of 49,155 does not divide by 2); W̄ 0 ULP;
    16c's checkpoint resumed under K 2 × data 1 × model 1: replicas and
    W̿ bit-equal, the window bit-equal after the repack into that
    layout."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.common.packing import merge_groups, repack, \
        spec_from_json
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import mesh_args, run_mesh_native
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    _free(dev)
    # eight ranks on one card: their allocators grow segments in place
    # rather than holding a reserved block per size
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    base = dict(PAR_RUN, device=dev.type)
    cfg_a = _mesh_cfg()
    cfg_b = _mesh_cfg().with_(attn_impl="flash_jnp")
    # the smoke-width run in bf16, as the full-width runs: the host's
    # per-leaf reference widens the replicas to f32, as the packed sync
    # means them
    smoke = get_smoke_config("granite-3-2b").with_(attn_impl="flash_jnp",
                                                   dtype="bfloat16")
    res = {}
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_mesh16_")
    try:
        t0 = time.perf_counter()
        # 16c, with the smoke-width run in the same spawn
        grouped = dict(base, k=2, tp=2, fsdp=True, world_size=8)
        out, small = run_mesh_native(
            [mesh_args(**grouped), mesh_args(**dict(
                grouped, seq_len=16, checkpoint_dir=ckpt,
                checkpoint_every=PAR_CKPT_EVERY))],
            cfg=[cfg_b, smoke], probe=[True, "host"],
            with_state=[False, True])
        t1 = time.perf_counter()
        _reset_counts()
        jobs = [
            lambda: run_mesh_native(mesh_args(**dict(
                base, k=2, world_size=4)), cfg=cfg_a, probe=True,
                with_state=False),
            lambda: run_mesh_native(mesh_args(**dict(base, k=2, tp=2)),
                                    cfg=cfg_b, probe=True, with_state=False),
            lambda: run_mesh_native(mesh_args(**dict(
                base, k=2, seq_len=16, checkpoint_dir=ckpt,
                checkpoint_every=PAR_CKPT_EVERY, resume=True)), cfg=smoke)]
        with ThreadPoolExecutor(len(jobs)) as pool:
            out_a, out_b, back = [f.result() for f in
                                  [pool.submit(j) for j in jobs]]
        t2 = time.perf_counter()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    if any(_counts().values()):
        raise AssertionError(f"16a-b: this process launched {_counts()}")
    # 16a
    if out_a["mesh"] != {"replica": 2, "data": 2}:
        raise AssertionError(f"16a: mesh {out_a['mesh']}")
    _mesh_checks("16a", out_a, cuda=cuda)
    _par_probes("16a", out_a, host=False)
    for rank in out_a["ranks"]:
        if set(rank["train_collectives"]) != {"data"}:
            raise AssertionError(f"16a: train collectives "
                                 f"{rank['train_collectives']}")
    res["dp"] = _par_report("16a data", out_a, cfg_a,
                            beside="16b and the resume")
    # 16b
    if out_b["mesh"] != {"replica": 2, "model": 2}:
        raise AssertionError(f"16b: mesh {out_b['mesh']}")
    _mesh_checks("16b", out_b, cuda=cuda)
    _par_probes("16b", out_b, host=False)
    res["tp"] = _par_report("16b model", out_b, cfg_b,
                            beside="16a and the resume")
    # 16c
    lay = out["layout"]
    if not lay["grouped"] or lay["n_groups"] < 2:
        raise AssertionError(f"16c: layout {lay}")
    _mesh_checks("16c", out, cuda=cuda)
    _mesh_checks("16c smoke", small, cuda=cuda)
    _par_probes("16c", out, host=False)
    _par_probes("16c smoke", small, host=True)
    for rank in out["ranks"]:
        for s in rank["syncs"]:
            if s["declared"] != {"replica": {"all_reduce": 1}}:
                raise AssertionError(f"16c: sync declares {s['declared']}")
        if cuda and not 1 <= rank["launches"]["wa_window_update"] / len(
                rank["syncs"]) <= lay["n_groups"]:
            raise AssertionError(f"16c: rank {rank['rank']} launched "
                                 f"{rank['launches']}")
    res["fsdp"] = _par_report("16c fsdp+tp", out, cfg_b)
    res["fsdp"]["smoke_launches"] = small["launches"]
    print(f"[mesh16] 16c smoke ({smoke.dtype}): W̿ against the host's "
          f"per-leaf hwa_sync (the replicas widened to f32) "
          f"{[h['probe']['wa_host_ulps'] for h in small['history']]} ULP "
          f"at its {len(small['history'])} syncs, layout "
          f"{small['layout']['n_groups']} groups")
    a, b = small["_state"], back["_state"]
    src = spec_from_json(small["layout"]["json"])
    dst = spec_from_json(back["layout"]["json"])
    same = (back["resumed_from"] == PAR_CKPT_EVERY
            and _trees_bits_equal(a["inner"], b["inner"])
            and _trees_bits_equal(a["wa"], b["wa"])
            and all(_bits_equal(repack(merge_groups(a[k], src), src, dst),
                                b[k]) for k in ("ring", "total")))
    print(f"[mesh16] 16c checkpoint: saved under {small['mesh']} "
          f"({small['layout']['n_groups']} groups) at step "
          f"{PAR_CKPT_EVERY}, resumed under {back['mesh']}: bit-equal "
          f"{same}")
    if not same:
        raise AssertionError("16c: the checkpoint did not resume "
                             "bit-exactly under K 2 x data 1 x model 1")
    print(f"[mesh16] phase 16 in {t2 - t0:.1f} s (16c {t1 - t0:.1f} s, "
          f"16a, 16b and the resume side by side {t2 - t1:.1f} s) | "
          f"{CARD['line']}")
    return res


# ------------------------ 17. the recurrent model axis, the EP MoE
#: phase 17: K 2 × model 2 on the one card, 4 steps, H 2, I 2, 4 × 512
#: tokens a replica, bf16: xlstm-125m whole (17a), hymba-1.5b cut to 2
#: layers (17b, ``flash_jnp``: tp > 1 refuses the flash kernels), and
#: granite-moe-1b-a400m cut to 2 layers with its experts split over
#: ``model`` (17c, 16 a rank, capacity 1.25); the recurrent models at lr
#: 0.03 (their smoke configs are chaotic at 0.3)
REC_TP_RUN = dict(MESH_RUN, steps=4, k=2, tp=2)
REC_TP_LR = 0.03
REC_TP_LAYERS = {"hymba-1.5b": 2, "granite-moe-1b-a400m": 2}
#: 17d: the smoke configs in f32 on the card: the tp 2 steps against the
#: single-rank steps (1e-5), the EP layer against the TP layer at a
#: capacity that drops nothing (the reference's 1e-3, spmd_check.py:57)
REC_TP_SMOKE_TOL = 1e-5
EP_TP_TOL = 1e-3
#: 17d's hymba with heads that do not divide by tp 2, as hymba-1.5b's 25
#: do not: its Mamba branch and attention run whole on each rank
REC_TP_ODD = dict(d_model=48, n_heads=3, n_kv_heads=1, ssm_heads=3)


def _rec_tp_cfgs():
    """17a-c's configs (the smoke configs when MESH_FULL is off, as the
    CPU rehearsal runs them)."""
    from repro_torch.configs import get_smoke_config
    out = []
    for arch in ("xlstm-125m", "hymba-1.5b", "granite-moe-1b-a400m"):
        cfg = get_config(arch) if MESH_FULL else get_smoke_config(arch)
        if MESH_FULL and arch in REC_TP_LAYERS:
            cfg = cfg.with_(n_layers=REC_TP_LAYERS[arch])
        if cfg.family != "ssm":
            cfg = cfg.with_(attn_impl="flash_jnp")
        if cfg.family == "moe":
            cfg = cfg.with_(expert_parallel=True, moe_capacity_factor=1.25)
        out.append(cfg)
    return out


def _rec_smoke_cfgs():
    """17d's smoke configs: xlstm-125m's, hymba-1.5b's and hymba-1.5b's
    with 3 heads (:data:`REC_TP_ODD`)."""
    from repro_torch.configs import get_smoke_config
    hymba = get_smoke_config("hymba-1.5b")
    return [get_smoke_config("xlstm-125m"), hymba, hymba.with_(**REC_TP_ODD)]


def _ep_layer_case():
    """17d's EP-against-TP case: granite-moe's smoke layer in f32 at
    capacity E/k (no pair dropped), 4 × 64 tokens."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("granite-moe-1b-a400m")
    p = {k: v[0] for k, v in moe.init_moe(
        cfg, 1, torch.Generator().manual_seed(17), torch.float32,
        "cpu").items()}
    g = torch.Generator().manual_seed(18)
    x = torch.randn((4, 64, cfg.d_model), generator=g)
    return {"cfg": cfg, "p": p, "x": x, "g": torch.randn(x.shape, generator=g),
            "cf": cfg.n_experts / cfg.top_k, "coef": 0.0, "tp_layer": True}


def phase_mesh_model_axis(device):
    """Phase 17: a model axis for the recurrent families and the
    expert-parallel MoE (``--mesh-native --tp 2``; the EP layer through
    ``run_mesh_native(expert_parallel=True)``), on ``gloo`` on the one
    card. One spawn of K 2 × model 2 runs 17a xlstm-125m (12 layers),
    17b hymba-1.5b (2 layers) and 17c granite-moe-1b-a400m (2 layers,
    experts split) at full width, then 17d's smoke-width f32 runs of
    xlstm, hymba and hymba with 3 heads (whose heads do not divide, as
    hymba-1.5b's do not), each probed against the host's per-leaf
    reference; beside it, 17d's single-rank runs (K 2 × model 1)
    and the EP layer against the TP layer (data 2 × model 2,
    ``moe.ep_cases``). Gates for 17a-c: every W̄ 0 ULP from its oracle,
    the train steps exactly the collectives they declare a level (none on
    a replica level), the window update launched exactly, the loss
    finite, every sync's audit verdict; 17d: the tp 2 runs' replicas, W̿
    and losses within 1e-5 of the single-rank runs', the EP layer within
    1e-3 of the TP layer."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.launch.train import mesh_args, run_mesh_native
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    _free(dev)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    base = dict(REC_TP_RUN, device=dev.type)
    cfgs = _rec_tp_cfgs()
    smoke = _rec_smoke_cfgs()
    small = dict(base, seq_len=16, lr=REC_TP_LR)
    runs = [mesh_args(**dict(base, arch=c.name, lr=REC_TP_LR
                             if c.family != "moe" else base["lr"]))
            for c in cfgs]
    runs += [mesh_args(**dict(small, arch=c.name)) for c in smoke]
    _reset_counts()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        main = pool.submit(
            run_mesh_native, runs, cfg=cfgs + smoke,
            probe=[True] * 3 + ["host"] * len(smoke),
            with_state=[False] * 3 + [True] * len(smoke),
            expert_parallel=[False, False, True] + [False] * len(smoke))
        single = pool.submit(
            run_mesh_native, [mesh_args(**dict(small, arch=c.name, tp=1))
                              for c in smoke], cfg=smoke, with_state=True)
        layer = pool.submit(spawn_ranks, {"data": 2, "model": 2},
                            "repro_torch.models.moe:ep_cases",
                            [_ep_layer_case()], device=device,
                            levels=[("data",), ("model",)])
        outs, ones, ranks = main.result(), single.result(), layer.result()
    t1 = time.perf_counter()
    if any(_counts().values()):
        raise AssertionError(f"17: this process launched {_counts()}")
    res = {}
    for label, key, out, cfg in zip(("17a", "17b", "17c"),
                                    ("xlstm_tp", "hymba_tp", "ep"),
                                    outs[:3], cfgs):
        if out["mesh"] != {"replica": 2, "model": 2}:
            raise AssertionError(f"{label}: mesh {out['mesh']}")
        _mesh_checks(label, out, cuda=cuda)
        _par_probes(label, out, host=False)
        if not (np.isfinite(out["final_loss"]) and out["wa_finite"]):
            raise AssertionError(f"{label}: loss {out['final_loss']}, W̿ "
                                 f"finite {out['wa_finite']}")
        res[key] = _par_report(f"{label} {cfg.name}", out, cfg,
                               beside="17d", tag="mesh17")
        res[key]["train_declared"] = out["ranks"][0]["train_declared"]
        print(f"[mesh17] {label}: a train step's collectives (rank 0) "
              f"{out['ranks'][0]['train_declared']}, audit "
              f"{[s['audit']['replica'] for s in out['ranks'][0]['syncs']]}"
              f" (replica level), assembly-free "
              f"{all(s['audit']['assembly_free'] for s in out['ranks'][0]['syncs'])}")
    ep = outs[2]
    tally = [r["ep_pairs"] for r in ep["ranks"]]
    pairs = sum(t["pairs"] for t in tally)
    dropped = sum(t["dropped"] for t in tally)
    fwd = 1 if cfgs[2].remat == "none" else 2
    a2a = ep["ranks"][0]["train_declared"]["model"]["all_to_all"]
    want = cfgs[2].n_layers * (2 * fwd + 2)
    if a2a != want or ep["ranks"][0]["train_collectives"]["model"][
            "all_to_all"] != want * REC_TP_RUN["steps"]:
        raise AssertionError(f"17c: {a2a} all-to-alls a step, want {want}")
    res["ep"].update(pairs=pairs, dropped=dropped, all_to_all=a2a)
    print(f"[mesh17] 17c: {cfgs[2].n_experts // 2} experts a rank, "
          f"capacity {cfgs[2].moe_capacity_factor}: {dropped} of {pairs} "
          f"pairs dropped ({dropped / max(pairs, 1):.4%}, every forward "
          f"counted); all-to-alls a layer a step: {2 * fwd} forward "
          f"({'twice ' if fwd == 2 else ''}dispatch and return), 2 "
          f"backward")
    # 17d: tp 2 against one rank a replica, at smoke width in f32
    worst = {}
    for c, got, ref in zip(smoke, outs[3:], ones):
        name = c.name + ("" if c.n_heads % 2 == 0
                         else f" ({c.n_heads} heads)")
        for o, lbl in ((got, "tp 2"), (ref, "tp 1")):
            if launcher_violations(o):
                raise AssertionError(f"17d {name} {lbl}: "
                                     f"{launcher_violations(o)}")
        _par_probes(f"17d {name}", got, host=True)
        d = max(float(np.max(np.abs(np.asarray(got["losses"])
                                    - np.asarray(ref["losses"])))),
                max(float((a.float() - b.float()).abs().max())
                    for k in ("inner", "wa") for a, b in zip(
                        tree_leaves(got["_state"][k]),
                        tree_leaves(ref["_state"][k]))))
        worst[name] = d
        print(f"[mesh17] 17d {name} smoke f32: K 2 × model 2 against K 2 "
              f"× model 1 after {small['steps']} steps: max |d| {d:.3e} "
              f"(losses, replicas, W̿; limit {REC_TP_SMOKE_TOL})")
        if not d <= REC_TP_SMOKE_TOL:
            raise AssertionError(f"17d {name}: tp 2 off the single-rank "
                                 f"run by {d}")
    lay = [r["result"][0] for r in ranks]
    ep_d = max(float((r["out"] - r["out_tp"]).abs().max()) for r in lay)
    kept = all(bool(r["keep"].all()) for r in lay)
    print(f"[mesh17] 17d EP layer against the TP layer (granite-moe smoke, "
          f"f32, capacity E/k, all pairs kept {kept}): max |d| {ep_d:.3e} "
          f"(limit {EP_TP_TOL}); {lay[0]['collectives']['model']} a rank")
    if not (kept and ep_d <= EP_TP_TOL):
        raise AssertionError(f"17d: the EP layer off the TP layer by {ep_d}")
    res["smoke"] = {"tp_vs_single": worst, "ep_vs_tp": ep_d}
    print(f"[mesh17] phase 17 in {t1 - t0:.1f} s (one spawn of 17a-c and "
          f"17d's tp 2 runs, beside 17d's single-rank runs and layer "
          f"check) | {CARD['line']}")
    return res


# ------------------------------------------------ 18. the contract checker


def phase_lint(device):
    """Phase 18. 18a: the lint's in-process cases
    (``analysis.lint.default_cases`` without a mesh) on ``device`` at
    phase 15's model (granite-3-2b at its published width cut to
    MESH_LAYERS, ``flash_pallas``, remat off; the smoke config when
    MESH_FULL is off), the stacked train step under ``flash_pallas``:
    every pass holds and, on the card, every launch budget is exact.
    18b: the summary of the passes ``_mesh_checks`` ran on phases 15-17's
    recorded calls. Returns the report, the launches and 18b's record."""
    from repro_torch.analysis import lint
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    _free(dev)
    cfg = _mesh_cfg()
    cases = [c for c in lint.default_cases(cfg, train_attn="flash_pallas")
             if c.mesh is None]
    facts = {}
    _reset_counts()
    t0 = time.perf_counter()
    rep = lint.run_lint(cases, device=device, facts=facts,
                        log=lambda *_: None)
    _sync(device)
    secs = time.perf_counter() - t0
    launches = _counts()
    bad = []
    for name, entry in rep["bundles"].items():
        if "error" in entry:
            bad.append(f"{name}: {entry['error']}")
            continue
        lb = entry["passes"]["launch_budget"]
        if cuda and lb["skipped"]:
            bad.append(f"{name}: launch_budget skipped on the card")
        for p, r in entry["passes"].items():
            bad += [f"{name}: {p}: {v}" for v in r["violations"]]
        print(f"[lint18] 18a {name}: {'PASS' if entry['ok'] else 'FAIL'}; "
              f"{lb['evidence'][0]}; "
              + "; ".join(entry["passes"]["donation"]["evidence"]))
    print(f"[lint18] 18a: {cfg.name} L{cfg.n_layers} d{cfg.d_model}, "
          f"{len(cases)} cases in {secs:.1f} s, launches "
          f"{ {k: v for k, v in launches.items() if v} } | {CARD['line']}")
    for r in LINT_RECORDED:
        worst = max(r["peaks"], key=lambda x: x[0] / x[1], default=None)
        print(f"[lint18] 18b {r['label']}: {r['calls']} recorded sync/rest "
              f"calls held to their collectives, dtype and donation "
              f"contracts; payloads {r['payloads']}"
              + ("" if worst is None else
                 f"; closest peak above a call's start {worst[0]} B of its "
                 f"declared working set {worst[1]} B"))
    if bad:
        raise AssertionError(f"phase 18: {bad}")
    if cuda and not LINT_RECORDED:
        raise AssertionError("phase 18b: no run of phases 15-17 recorded")
    return {"report": rep, "launches": launches, "seconds": secs,
            "recorded": list(LINT_RECORDED), "facts": facts}


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
          f"{f_ms:.4f} ms (plain {f_plain:.3f}, sdpa {f_lib:.4f}, "
          f"{f_ms / f_lib:.2f}x; bound "
          f"{f_bound:.4f} by {f_by}) | {CARD['line']}")
    print(f"[yardstick] paged_attention B{Bp} Hq{Hq} Hkv{Hkv} D{D} ps{ps} "
          f"TW{TW} lens {lens} bf16: {p_ms:.4f} ms (plain {p_plain:.3f}, "
          f"library none, bound {p_bound:.5f} by {p_by}) | {CARD['line']}")
    return entries


def phase_yardstick_serving(device, serve_slm, seed=17):
    """The flash forward and the paged kernel at a served model's shapes
    (stablelm-12b's; phase 11's qwen2-moe-a2.7b's): the forward at one
    512-token prefill chunk (B1 S512, the model's heads; stablelm's
    head_dim 160 runs at 192), the paged kernel at the serving run's
    first full decode step (its lens; the pool at the kernel's head_dim).
    Inputs are padded before timing, as the model hands them over (the
    pool is padded at allocation; q, k and v of a prefill are padded by
    the wrapper before the kernel), so the times are the kernels'. The
    bounds count the TRUE head_dim's bytes and FLOPs: padding shows as
    distance from them. Returns (forward, paged) records."""
    dev = torch.device(device)
    dt = torch.bfloat16
    B, S, D = 1, 512, serve_slm["head_dim"]
    Hq, Hkv = serve_slm["n_heads"], serve_slm["n_kv_heads"]
    Dp = padded_head_dim(D)
    gen = torch.Generator(device=dev).manual_seed(seed)
    true_sets = [(_randn(gen, (B, S, Hq, D), dt, dev),
                  _randn(gen, (B, S, Hkv, D), dt, dev),
                  _randn(gen, (B, S, Hkv, D), dt, dev)) for _ in range(16)]
    sets = [tuple(pad_head_dim(x, Dp) for x in st) for st in true_sets]
    f_ms = _time_ms(lambda q, k, v: fa.flash_attention_fwd(
        q, k, v, sm_scale=D ** -0.5), sets, 200)
    f_plain = _time_ms(lambda q, k, v: flash_attention_fwd_ref(q, k, v),
                       true_sets, 10, warmup=1)
    f_lib = _sdpa_ms(true_sets, 200)
    pairs = S * (S + 1) // 2
    f_bound, f_by = _bound(4 * B * Hq * D * pairs,
                           2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
                           + 4 * B * Hq * S, dt)
    fwd = {"shape": f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} (kernel at {Dp}) bf16",
           "ms": f_ms, "plain_ms": f_plain, "library_ms": f_lib,
           "bound_ms": f_bound, "bound_by": f_by,
           "launches": serve_slm["launches"]["flash_fwd"]}

    lens = serve_slm["first_decode_lens"]
    Bp, ps, TW = len(lens), 16, 35
    psets, tsets = [], []
    for i in range(8):
        q, kp, vp, tables, lens_t = _paged_inputs(
            dev, lens=lens, Hq=Hq, Hkv=Hkv, D=D, ps=ps, TW=TW, dtype=dt,
            seed=13 + seed + i)
        tsets.append((q, kp, vp, tables, lens_t))
        psets.append((pad_head_dim(q, Dp), pad_head_dim(kp, Dp),
                      pad_head_dim(vp, Dp), tables, lens_t))
    p_ms = _time_ms(lambda *a: pa.paged_attention_cuda(
        *a, sm_scale=D ** -0.5), psets, 500)
    p_plain = _time_ms(lambda *a: paged_attention_ref(*a), tsets, 50)
    tokens = int(sum(lens))
    p_bound, p_by = _bound(4 * Hq * D * tokens,
                           2 * (2 * Bp * Hq * D + 2 * tokens * Hkv * D)
                           + 4 * Bp * (TW + 1), dt)
    paged = {"shape": f"B{Bp} Hq{Hq} Hkv{Hkv} D{D} (kernel at {Dp}) ps{ps} "
                      f"TW{TW} lens {lens} bf16",
             "ms": p_ms, "plain_ms": p_plain, "library_ms": None,
             "bound_ms": p_bound, "bound_by": p_by,
             "launches": serve_slm["launches"]["paged_attention"]}
    arch = serve_slm["arch"]
    print(f"[yardstick] {arch} flash_fwd {fwd['shape']}: {f_ms:.4f} ms "
          f"(plain {f_plain:.3f}, sdpa {f_lib:.4f}, {f_ms / f_lib:.2f}x; "
          f"bound {f_bound:.5f} by {f_by} at the true head_dim) | "
          f"{CARD['line']}")
    print(f"[yardstick] {arch} paged_attention {paged['shape']}: "
          f"{p_ms:.4f} ms (plain {p_plain:.3f}, library none, bound "
          f"{p_bound:.5f} by {p_by} at the true head_dim) | {CARD['line']}")
    return fwd, paged


def phase_yardstick_hymba(device, serve, seed=37):
    """The flash forward and the paged kernel at hymba-1.5b's serving
    shapes (phase 12a): the forward at the prefix fill (B1 S128 Hq25 Hkv5
    D64, window 1024), the paged kernel at 12a's fullest decode step (B8,
    its lens, TW and window 1024), each beside its plain version, SDPA
    for the forward (``enable_gqa``, G = 5; causal, which the window does
    not bind at S 128) and its bound. Returns (forward, paged)
    records."""
    dev = torch.device(device)
    dt = torch.bfloat16
    B, S, Hq, Hkv, D, w = 1, 128, 25, 5, 64, 1024
    gen = torch.Generator(device=dev).manual_seed(seed)
    sets = [(_randn(gen, (B, S, Hq, D), dt, dev),
             _randn(gen, (B, S, Hkv, D), dt, dev),
             _randn(gen, (B, S, Hkv, D), dt, dev)) for _ in range(64)]
    f_ms = _time_ms(lambda q, k, v: fa.flash_attention_fwd(q, k, v,
                                                           window=w),
                    sets, 200)
    f_plain = _time_ms(lambda q, k, v: flash_attention_fwd_ref(q, k, v,
                                                               window=w),
                       sets, 10, warmup=1)
    f_lib = _sdpa_ms(sets, 200)
    f_bound, f_by = _bound(4 * B * Hq * D * (S * (S + 1) // 2),
                           2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
                           + 4 * B * Hq * S, dt)
    fwd = {"shape": f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} w{w} bf16", "ms": f_ms,
           "plain_ms": f_plain, "library_ms": f_lib, "bound_ms": f_bound,
           "bound_by": f_by, "launches": serve["launches"]["flash_fwd"]}

    lens, TW, ps = serve["full_step_lens"], serve["table_width"], 16
    psets = [_paged_inputs(dev, lens=lens, Hq=Hq, Hkv=Hkv, D=D, ps=ps, TW=TW,
                           dtype=dt, seed=seed + i) for i in range(8)]
    p_ms = _time_ms(lambda *a: pa.paged_attention_cuda(*a, window=w), psets,
                    500)
    p_plain = _time_ms(lambda *a: paged_attention_ref(*a, window=w), psets, 50)
    tokens = int(sum(min(n, w) for n in lens))
    p_bound, p_by = _bound(4 * Hq * D * tokens,
                           2 * (2 * len(lens) * Hq * D + 2 * tokens * Hkv * D)
                           + 4 * len(lens) * (TW + 1), dt)
    paged = {"shape": f"B{len(lens)} Hq{Hq} Hkv{Hkv} D{D} ps{ps} TW{TW} "
                      f"w{w} lens {lens} bf16",
             "ms": p_ms, "plain_ms": p_plain, "library_ms": None,
             "bound_ms": p_bound, "bound_by": p_by,
             "launches": serve["launches"]["paged_attention"]}
    print(f"[yardstick] hymba-1.5b flash_fwd {fwd['shape']}: {f_ms:.4f} ms "
          f"(plain {f_plain:.3f}, sdpa {f_lib:.4f}, {f_ms / f_lib:.2f}x; "
          f"bound {f_bound:.5f} by {f_by}) | {CARD['line']}")
    print(f"[yardstick] hymba-1.5b paged_attention {paged['shape']}: "
          f"{p_ms:.4f} ms (plain {p_plain:.3f}, library none, bound "
          f"{p_bound:.5f} by {p_by}) | {CARD['line']}")
    return fwd, paged


def _sweep_launchers(dev, dscale):
    """One dq launch and one dk/dv launch of the backward library, each
    alone (what phase 6 times), on bf16 (q, k, v, out, lse, dout, delta)
    sets; shapes are read from the tensors, ``dscale`` is the true head
    dim's."""
    lib = fab._lib()

    def shape(q, k):      # the stream is read per call: capture runs on its own
        B, S, Hq, D = q.shape
        return (B, S, k.shape[1], Hq, k.shape[2], D, 0, 0.0, dscale, 1,
                torch.cuda.current_stream(dev).cuda_stream)

    def dq_only(q, k, v, out, lse, dout, delta):
        dq = torch.empty_like(q)
        build.check_launch(lib, lib.flash_bwd_dq_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), *shape(q, k)),
            "dq")

    def dkv_only(q, k, v, out, lse, dout, delta):
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        build.check_launch(lib, lib.flash_bwd_dkv_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            *shape(q, k)), "dkv")

    return dq_only, dkv_only


def phase_yardstick_sweeps_192(device):
    """The two backward sweeps' head_dim-192 instances at stablelm-12b's
    attention shape (B1 S512 Hq32 Hkv8, head_dim 160 run at 192): no main
    path of this script trains stablelm-12b (it does not fit one card
    with HWA's state), so these are the instances' times on the inputs
    the wrappers would hand them, beside SDPA's backward at the true
    head_dim; the bounds count the true head_dim. Returns (dq, dk/dv)
    records."""
    dev = torch.device(device)
    dt = torch.bfloat16
    B, S, Hq, Hkv, D = 1, 512, 32, 8, 160
    Dp = padded_head_dim(D)
    gen = torch.Generator(device=dev).manual_seed(19)
    sets, bsets = [], []
    for _ in range(16):
        q, dout = (_randn(gen, (B, S, Hq, D), dt, dev) for _ in range(2))
        k, v = (_randn(gen, (B, S, Hkv, D), dt, dev) for _ in range(2))
        qp, kp, vp, dp = (pad_head_dim(x, Dp) for x in (q, k, v, dout))
        out, lse = fa.flash_attention_fwd(qp, kp, vp, sm_scale=D ** -0.5)
        delta = (dp.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        sets.append((qp, kp, vp, out, lse, dp, delta))
        bsets.append((q, k, v, dout))
    dq_only, dkv_only = _sweep_launchers(dev, D ** -0.5)
    dq_ms = _time_ms(dq_only, sets, 100)
    dkv_ms = _time_ms(dkv_only, sets, 100)
    b_lib = _sdpa_bwd_ms(bsets, 50)
    b_plain = _plain_bwd_ms(bsets[:4])
    prod = 2 * B * Hq * D * (S * (S + 1) // 2)
    q_bytes, kv_bytes, row_bytes = 2 * B * S * Hq * D, 2 * B * S * Hkv * D, \
        4 * B * Hq * S
    dq_bound, dq_by = _bound(3 * prod, 3 * q_bytes + 2 * kv_bytes
                             + 2 * row_bytes, dt)
    dkv_bound, dkv_by = _bound(4 * prod, 2 * q_bytes + 4 * kv_bytes
                               + 2 * row_bytes, dt)
    shape = f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} (kernels at {Dp}) bf16"
    print(f"[yardstick] flash_bwd {shape}: dq {dq_ms:.4f} ms (bound "
          f"{dq_bound:.5f} by {dq_by}), dk/dv {dkv_ms:.4f} ms (bound "
          f"{dkv_bound:.5f} by {dkv_by}), both at the true head_dim; plain "
          f"backward {b_plain:.3f} ms, sdpa backward {b_lib:.4f} ms | "
          f"{CARD['line']}")
    return ({"shape": shape, "ms": dq_ms, "library_ms": b_lib,
             "plain_ms": b_plain, "bound_ms": dq_bound, "bound_by": dq_by},
            {"shape": shape, "ms": dkv_ms, "library_ms": b_lib,
             "plain_ms": b_plain, "bound_ms": dkv_bound, "bound_by": dkv_by})


def _plain_bwd_ms(sets, iters=3):
    """The plain backward (``kernels/ref.py``: both sweeps' work) on (q,
    k, v, dout) sets at their true head_dim, after the plain forward's
    (O, lse)."""
    full = [(q, k, v, *flash_attention_fwd_ref(q, k, v), dout)
            for q, k, v, dout in sets]
    return _time_ms(lambda q, k, v, out, lse, dout: flash_attention_bwd_ref(
        q, k, v, out, lse, dout), full, iters, warmup=1)


def _sdpa_bwd_ms(sets, iters):
    """The backward of torch's scaled_dot_product_attention alone, on the
    same inputs laid out (B, H, S, D): each set's forward runs once on a
    side stream, then ``iters`` backward calls on it (``retain_graph``)
    are captured in one CUDA graph on that stream, where autograd runs
    them, and replayed between CUDA events: timed alone, not as the
    difference of a forward+backward and a forward timing, which is not
    robust (it came out negative at internvl2-1b's shape). Timed here
    only: the port never calls it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    lib = []
    with torch.cuda.stream(side):
        for q, k, v, dout in sets:
            q, k, v, dout = (x.transpose(1, 2).detach()
                             for x in (q, k, v, dout))
            ins = tuple(x.requires_grad_(True) for x in (q, k, v))
            lib.append((F.scaled_dot_product_attention(
                *ins, is_causal=True, enable_gqa=True), ins, dout))

        def bwd(i):
            out, ins, dout = lib[i % len(lib)]
            return torch.autograd.grad(out, ins, dout, retain_graph=True)

        for i in range(3):                        # warm-up off the capture
            bwd(i)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(iters):
            bwd(i)
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / iters
    del graph, lib
    return ms


def phase_yardstick_train(device, train, kernels):
    """The kernels of the training path at its shapes: the fused sync at
    the run's packed size (K = 2, I = 3), and the flash forward and the
    two backward sweeps at one layer's attention (B4 S512 Hq32 Hkv8 D64
    bf16). Returns (the sync's and sweeps' entries, the forward's times
    at this shape)."""
    dev = torch.device(device)
    K, I = TRAIN["K"], TRAIN["I"]
    P = -(-train["params"] // ALIGN) * ALIGN
    gen = torch.Generator(device=dev).manual_seed(11)
    stacked = torch.randn((K, P), generator=gen, device=dev)
    ring = torch.randn((I, P), generator=gen, device=dev)
    total = torch.randn((P,), generator=gen, device=dev)
    scal = (torch.tensor(1, dtype=torch.int32, device=dev),
            torch.tensor(1.0, device=dev), torch.tensor(1.0 / I, device=dev))
    sset = [(stacked, ring, total)]
    s_ms = _time_ms(lambda st, r, t: wa.wa_sync_fused(st, r, t, *scal),
                    sset, 10)
    s_plain = _time_ms(lambda st, r, t: wa_sync_fused_ref(st, r, t, *scal),
                       sset, 3, warmup=1)
    s_bytes = (K + 5) * 4 * P                 # K + 2 reads, 3 writes
    s_bound, s_by = _bound((K + 3) * P, s_bytes, torch.float32)
    del stacked, ring, total, sset
    torch.cuda.empty_cache()

    B, S, Hq, Hkv, D = 4, 512, 32, 8, 64
    dt = torch.bfloat16
    sets, bsets = [], []
    for _ in range(8):
        q = _randn(gen, (B, S, Hq, D), dt, dev)
        k = _randn(gen, (B, S, Hkv, D), dt, dev)
        v = _randn(gen, (B, S, Hkv, D), dt, dev)
        dout = _randn(gen, (B, S, Hq, D), dt, dev)
        out, lse = fa.flash_attention_fwd(q, k, v)
        delta = (dout.float() * out.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        sets.append((q, k, v, out, lse, dout, delta))
        bsets.append((q, k, v, dout))
    dq_only, dkv_only = _sweep_launchers(dev, D ** -0.5)
    dq_ms = _time_ms(dq_only, sets, 100)
    dkv_ms = _time_ms(dkv_only, sets, 100)
    # the forward at the training shape (its 32 launches a step run here)
    f_ms = _time_ms(lambda q, k, v, *_: fa.flash_attention_fwd(q, k, v),
                    sets, 100)
    f_lib = _sdpa_ms([x[:3] for x in bsets], 100)
    b_plain = _time_ms(lambda q, k, v, out, lse, dout, delta:
                       flash_attention_bwd_ref(q, k, v, out, lse, dout),
                       sets, 5, warmup=1)
    b_lib = _sdpa_bwd_ms(bsets, 50)
    pairs = S * (S + 1) // 2
    prod = 2 * B * Hq * D * pairs             # one causal product, in FLOPs
    q_bytes, kv_bytes, row_bytes = 2 * B * S * Hq * D, 2 * B * S * Hkv * D, \
        4 * B * Hq * S
    dq_bound, dq_by = _bound(3 * prod, 3 * q_bytes + 2 * kv_bytes
                             + 2 * row_bytes, dt)
    dkv_bound, dkv_by = _bound(4 * prod, 2 * q_bytes + 4 * kv_bytes
                               + 2 * row_bytes, dt)
    f_bound, f_by = _bound(2 * prod, 2 * q_bytes + 2 * kv_bytes + row_bytes,
                           dt)
    fwd_b4 = {"shape": f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} bf16", "ms": f_ms,
              "library_ms": f_lib, "bound_ms": f_bound, "bound_by": f_by}
    bwd = kernels["flash_bwd"][1]             # the training shape, direct
    launches = train["launches"]
    entries = [
        {"name": "wa_sync_fused", "route": "cuda", "source": SYNC_SRC,
         "replaces": SYNC_TPU, "launches": launches["wa_sync_fused"],
         "max_abs_err": max(c["max_abs_err"]
                            for c in kernels["wa_sync_fused"]),
         "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
         "bound_by": s_by, "library_ms": None},
        {"name": "flash_bwd_dq", "route": "cuda", "source": BWD_SRC,
         "replaces": DQ_TPU, "launches": launches["flash_bwd_dq"],
         "max_abs_err": bwd["dq_dk_dv_err"][0], "ms": dq_ms,
         "plain_ms": b_plain, "bound_ms": dq_bound, "bound_by": dq_by,
         "library_ms": b_lib},
        {"name": "flash_bwd_dkv", "route": "cuda", "source": BWD_SRC,
         "replaces": DKV_TPU, "launches": launches["flash_bwd_dkv"],
         "max_abs_err": max(bwd["dq_dk_dv_err"][1:]), "ms": dkv_ms,
         "plain_ms": b_plain, "bound_ms": dkv_bound, "bound_by": dkv_by,
         "library_ms": b_lib},
    ]
    print(f"[yardstick] wa_sync_fused K{K} I{I} P{P} f32: {s_ms:.4f} ms "
          f"(plain {s_plain:.3f}, library none, bound {s_bound:.4f} by "
          f"{s_by}) | {CARD['line']}")
    print(f"[yardstick] flash_fwd B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} bf16 "
          f"(training shape): {f_ms:.4f} ms (sdpa {f_lib:.4f}, "
          f"{f_ms / f_lib:.2f}x; bound {f_bound:.5f} by {f_by}) | "
          f"{CARD['line']}")
    print(f"[yardstick] flash_bwd B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} bf16: dq "
          f"{dq_ms:.4f} ms (bound {dq_bound:.5f} by {dq_by}), dk/dv "
          f"{dkv_ms:.4f} ms (bound {dkv_bound:.5f} by {dkv_by}); plain "
          f"backward {b_plain:.3f} ms, sdpa backward {b_lib:.4f} ms (both "
          f"sweeps; dk/dv {dkv_ms / b_lib:.2f}x) | {CARD['line']}")
    return entries, fwd_b4


def phase_yardstick_windows(device, train, kernels, windows):
    """The four slice-3 WA kernels at the training run's packed size
    (P = 687.9M, K = 2, I = 3): the window update, the online mean (with
    ``torch.mean`` as the library call), and the bf16-ring update and
    sync. Their launches are phase 8's, summed over its runs."""
    dev = torch.device(device)
    K, I = TRAIN["K"], TRAIN["I"]
    P = -(-train["params"] // ALIGN) * ALIGN
    gen = torch.Generator(device=dev).manual_seed(12)
    scal = (torch.tensor(1, dtype=torch.int32, device=dev),
            torch.tensor(1.0, device=dev), torch.tensor(1.0 / I, device=dev))
    bf16 = torch.bfloat16

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # name: (inputs, kernel, plain, library, bytes, f32 operations); bytes
    # count each input read once and each output written once
    cases = {
        "wa_window_update": (
            lambda: (rnd(I, P), rnd(P), rnd(P)),
            lambda r, t, n: wa.wa_window_update(r, t, n, *scal),
            lambda r, t, n: wa_window_update_ref(r, t, n, *scal), None,
            24 * P, 4 * P),
        "online_mean": (
            lambda: (rnd(K, P),), wa.online_mean, online_mean_ref,
            lambda x: torch.mean(x, 0), (4 * K + 4) * P, (K + 1) * P),
        "wa_window_update_c": (
            lambda: (rnd(I, P, dtype=bf16), rnd(P), rnd(P) * 1e-6, rnd(P)),
            lambda r, t, c, n: wa.wa_window_update_c(r, t, c, n, *scal),
            lambda r, t, c, n: wa_window_update_c_ref(r, None, t, c, n,
                                                      *scal),
            None, 28 * P, 8 * P),
        "wa_sync_fused_c": (
            lambda: (rnd(K, P), rnd(I, P, dtype=bf16), rnd(P),
                     rnd(P) * 1e-6),
            lambda x, r, t, c: wa.wa_sync_fused_c(x, r, t, c, *scal),
            lambda x, r, t, c: wa_sync_fused_c_ref(x, r, None, t, c, *scal),
            None, (4 * K + 24) * P, (K + 8) * P),
    }
    entries = []
    for name, (make, kernel, plain, library, nbytes, flops) in cases.items():
        sets = [make()]
        ms = _time_ms(kernel, sets, 10)
        plain_ms = _time_ms(plain, sets, 3, warmup=1)
        lib_ms = _time_ms(library, sets, 10) if library else None
        bound, by = _bound(flops, nbytes, torch.float32)
        del sets
        torch.cuda.empty_cache()
        by_run = {run: rec["launches"][name] for run, rec in windows.items()}
        entries.append({
            "name": name, "route": "cuda", "source": SYNC_SRC,
            "replaces": WA_TPU[name], "launches": sum(by_run.values()),
            "launches_by_path": by_run,
            "max_abs_err": max(c["max_abs_err"] for c in kernels[name]),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": lib_ms})
        print(f"[yardstick] {name} K{K} I{I} P{P}: {ms:.4f} ms (plain "
              f"{plain_ms:.3f}, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} (torch.mean)'}"
              f", bound {bound:.4f} by {by}) | {CARD['line']}")
    return entries


def phase_yardstick_modality(device, mod, seed=51):
    """The attention kernels at phase 13's shapes, for each arch: the
    flash forward at a 13a prefill chunk (B1, the vision prefix + 512
    positions) and at 13d's training batch (B4), the paged kernel at
    13a's fullest decode step (B8, its lens and TW), and the two backward
    sweeps at 13d's batch; each beside its plain version (the sweeps'
    is the whole plain backward), SDPA or SDPA's backward
    (``enable_gqa``) and its bound. Returns {arch: {"fwd", "fwd_b4",
    "paged", "dq", "dkv"}}."""
    dev = torch.device(device)
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for arch in MODALITY_ARCHS:
        cfg = get_config(arch)
        Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        npre = cfg.n_vis_tokens if cfg.family == "vlm" else 0
        S = npre + TRAIN["seq"]
        serve = mod["serve"][arch]
        train = mod["train"][arch]
        rec = {}
        for key, B in (("fwd", 1), ("fwd_b4", TRAIN["batch"])):
            sets = [tuple(_randn(gen, (B, S, h, D), dt, dev)
                          for h in (Hq, Hkv, Hkv))
                    for _ in range(24 if B == 1 else 8)]
            f_ms = _time_ms(lambda q, k, v: fa.flash_attention_fwd(q, k, v),
                            sets, 100)
            f_plain = _time_ms(lambda q, k, v: flash_attention_fwd_ref(
                q, k, v), sets, 5, warmup=1)
            f_lib = _sdpa_ms(sets, 100)
            prod = 2 * B * Hq * D * (S * (S + 1) // 2)
            f_bound, f_by = _bound(
                2 * prod, 2 * (2 * B * S * Hq * D + 2 * B * S * Hkv * D)
                + 4 * B * Hq * S, dt)
            rec[key] = {"shape": f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} bf16",
                        "ms": f_ms, "plain_ms": f_plain, "library_ms": f_lib,
                        "bound_ms": f_bound, "bound_by": f_by}
            del sets
        rec["fwd"]["launches"] = serve["launches"]["flash_fwd"]
        rec["fwd_b4"]["launches"] = train["launches"]["flash_fwd"]

        lens, TW, ps = serve["full_step_lens"], serve["table_width"], 16
        psets = [_paged_inputs(dev, lens=lens, Hq=Hq, Hkv=Hkv, D=D, ps=ps,
                               TW=TW, dtype=dt, seed=seed + i)
                 for i in range(8)]
        p_ms = _time_ms(lambda *a: pa.paged_attention_cuda(*a), psets, 500)
        p_plain = _time_ms(lambda *a: paged_attention_ref(*a), psets, 50)
        tokens = int(sum(lens))
        p_bound, p_by = _bound(4 * Hq * D * tokens,
                               2 * (2 * len(lens) * Hq * D
                                    + 2 * tokens * Hkv * D)
                               + 4 * len(lens) * (TW + 1), dt)
        rec["paged"] = {"shape": f"B{len(lens)} Hq{Hq} Hkv{Hkv} D{D} ps{ps} "
                                 f"TW{TW} lens {lens} bf16",
                        "ms": p_ms, "plain_ms": p_plain, "library_ms": None,
                        "bound_ms": p_bound, "bound_by": p_by,
                        "launches": serve["launches"]["paged_attention"]}
        del psets

        B = TRAIN["batch"]
        sets, bsets = [], []
        for _ in range(8):
            q, dout = (_randn(gen, (B, S, Hq, D), dt, dev) for _ in range(2))
            k, v = (_randn(gen, (B, S, Hkv, D), dt, dev) for _ in range(2))
            o, lse = fa.flash_attention_fwd(q, k, v)
            delta = (dout.float() * o.float()).sum(-1).transpose(1, 2) \
                .contiguous()
            sets.append((q, k, v, o, lse, dout, delta))
            bsets.append((q, k, v, dout))
        dq_only, dkv_only = _sweep_launchers(dev, D ** -0.5)
        dq_ms = _time_ms(dq_only, sets, 100)
        dkv_ms = _time_ms(dkv_only, sets, 100)
        b_lib = _sdpa_bwd_ms(bsets, 50)
        b_plain = _plain_bwd_ms(bsets[:4])
        prod = 2 * B * Hq * D * (S * (S + 1) // 2)
        q_bytes, kv_bytes, row_bytes = 2 * B * S * Hq * D, \
            2 * B * S * Hkv * D, 4 * B * Hq * S
        shape = f"B{B} S{S} Hq{Hq} Hkv{Hkv} D{D} bf16"
        for key, ms, flops, nbytes, launches in (
                ("dq", dq_ms, 3 * prod, 3 * q_bytes + 2 * kv_bytes
                 + 2 * row_bytes, train["launches"]["flash_bwd_dq"]),
                ("dkv", dkv_ms, 4 * prod, 2 * q_bytes + 4 * kv_bytes
                 + 2 * row_bytes, train["launches"]["flash_bwd_dkv"])):
            bound, by = _bound(flops, nbytes, dt)
            rec[key] = {"shape": shape, "ms": ms, "library_ms": b_lib,
                        "plain_ms": b_plain, "bound_ms": bound,
                        "bound_by": by, "launches": launches}
        del sets, bsets
        torch.cuda.empty_cache()
        out[arch] = rec
        for key, r in rec.items():
            print(f"[yardstick] {arch} {key} {r['shape']}: {r['ms']:.4f} ms "
                  f"(plain {r['plain_ms']:.3f}, library {r['library_ms']}, "
                  f"bound {r['bound_ms']:.5f} by {r['bound_by']}) | "
                  f"{CARD['line']}")
    return out


def _causal_pairs(S, window=None) -> int:
    """(row, key) pairs a causal S x S attention computes, under a window
    of ``window`` keys where given."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def phase_yardstick_large(device, large, seed=61):
    """The flash forward and the paged kernel at phase 14's shapes, for
    each arch and each kind of layer it has (gemma2-27b: local, window
    4096, and global, both with softcap 50; command-r-35b: one kind, G =
    8): the forward at the served prefill chunk (B1, gemma2 S 5,888,
    command-r S 512), the paged kernel at 14a-b's first full decode step
    (its lens and TW); each beside its plain version, SDPA with
    ``enable_gqa`` where the layer has no softcap (else none: SDPA has
    none), and its bound from this input's pairs. A row's launches are
    its kind's share of the serving run's. Returns {arch: {"fwd": {kind:
    rec}, "paged": {kind: rec}}}."""
    dev = torch.device(device)
    dt = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for arch, serve in large["serve"].items():
        cfg = get_config(arch)
        Hq, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        cap = cfg.logit_softcap
        S = LARGE_SERVE[arch].get("prefill_chunk", 512)
        kinds = ({"local": cfg.sliding_window, "global": None}
                 if cfg.global_every else {"all": None})
        share = len(kinds)
        rec = {"fwd": {}, "paged": {}}
        n_sets = max(2, min(16, (2 << 30) // (2 * S * (Hq + 2 * Hkv) * D)))
        sets = [tuple(_randn(gen, (1, S, h, D), dt, dev)
                      for h in (Hq, Hkv, Hkv)) for _ in range(n_sets)]
        for kind, w in kinds.items():
            opts = dict(window=w, logit_softcap=cap)
            f_ms = _time_ms(lambda q, k, v: fa.flash_attention_fwd(
                q, k, v, **opts), sets, 50 if S > 512 else 200)
            f_plain = _time_ms(lambda q, k, v: flash_attention_fwd_ref(
                q, k, v, **opts), sets, 1 if S > 512 else 10, warmup=1)
            f_lib = None if cap else _sdpa_ms(sets, 200)
            pairs = _causal_pairs(S, w)
            f_bound, f_by = _bound(
                4 * Hq * D * pairs,
                2 * (2 * S * Hq * D + 2 * S * Hkv * D) + 4 * Hq * S, dt)
            rec["fwd"][kind] = {
                "shape": f"B1 S{S} Hq{Hq} Hkv{Hkv} D{D} w{w} cap{cap} bf16",
                "ms": f_ms, "plain_ms": f_plain, "library_ms": f_lib,
                "bound_ms": f_bound, "bound_by": f_by,
                "launches": serve["launches"]["flash_fwd"] // share}
            if f_lib is None:
                rec["fwd"][kind]["library"] = "none: SDPA has no tanh softcap"
        del sets
        lens, TW, ps = serve["first_decode_lens"], serve["table_width"], 16
        psets = [_paged_inputs(dev, lens=lens, Hq=Hq, Hkv=Hkv, D=D, ps=ps,
                               TW=TW, dtype=dt, seed=seed + i)
                 for i in range(8)]
        tokens = int(sum(lens))
        for kind, w in kinds.items():
            opts = dict(window=w, logit_softcap=cap)
            p_ms = _time_ms(lambda *a: pa.paged_attention_cuda(*a, **opts),
                            psets, 500)
            p_plain = _time_ms(lambda *a: paged_attention_ref(*a, **opts),
                               psets, 50)
            # the keys a step reads: within the window where one binds
            keys = int(sum(min(n, w or n) for n in lens))
            p_bound, p_by = _bound(4 * Hq * D * keys,
                                   2 * (2 * len(lens) * Hq * D
                                        + 2 * keys * Hkv * D)
                                   + 4 * len(lens) * (TW + 1), dt)
            rec["paged"][kind] = {
                "shape": f"B{len(lens)} Hq{Hq} Hkv{Hkv} D{D} ps{ps} TW{TW} "
                         f"w{w} cap{cap} lens {lens} ({tokens} tokens) bf16",
                "ms": p_ms, "plain_ms": p_plain, "library_ms": None,
                "bound_ms": p_bound, "bound_by": p_by,
                "launches": serve["launches"]["paged_attention"] // share}
        del psets
        torch.cuda.empty_cache()
        out[arch] = rec
        for name, recs in rec.items():
            for kind, r in recs.items():
                print(f"[yardstick] {arch} {name} {kind} {r['shape']}: "
                      f"{r['ms']:.4f} ms (plain {r['plain_ms']:.3f}, library "
                      f"{r['library_ms'] or r.get('library', 'none')}, "
                      f"bound {r['bound_ms']:.5f} by {r['bound_by']}; "
                      f"launches {r['launches']}) | {CARD['line']}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    device = "cuda"
    t_start = last = time.perf_counter()

    def stamp(label):
        """A [time] line: the seconds since the previous stamp."""
        nonlocal last
        now = time.perf_counter()
        print(f"[time] {label}: {now - last:.1f} s (script at "
              f"{now - t_start:.1f} s)")
        last = now

    phase_device(device)
    phase_build(device)
    stamp("phases 1-2")
    kernels = phase_kernels(device)
    stamp("phase 3")
    gc.collect()
    torch.cuda.empty_cache()
    # phase 14 first, while the card holds nothing of another phase
    large = phase_large(device)
    stamp("phase 14")
    gc.collect()
    torch.cuda.empty_cache()
    # phase 15 next: its ranks need the card to themselves
    mesh = phase_mesh(device)
    stamp("phase 15")
    par = phase_mesh_parallel(device)
    stamp("phase 16")
    model_axis = phase_mesh_model_axis(device)
    stamp("phase 17")
    lint18 = phase_lint(device)
    stamp("phase 18")
    serve, eng = phase_serve(device)
    phase_trace(device, eng, serve)
    del eng                  # its timing wrappers hold it in a cycle: collect
    gc.collect()
    phase_reference(device)
    torch.cuda.empty_cache()
    # stablelm-12b at full width and depth: head_dim 160, run at 192
    serve_slm, eng = phase_serve(device, cfg=get_config("stablelm-12b").with_(
        attn_impl="flash_pallas"))
    phase_trace(device, eng, serve_slm)
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    phase_reference(device, arch="stablelm-12b")
    torch.cuda.empty_cache()
    stamp("phases 4-5")
    train, trainer = phase_train(device)
    phase_train_trace(device, trainer, train)
    windows = phase_windows(device, trainer, train)
    del trainer
    train.pop("final_wa")
    gc.collect()
    torch.cuda.empty_cache()
    phase_train_reference(device)
    torch.cuda.empty_cache()
    stamp("phases 7-8")
    baselines = phase_baselines(device)
    ckpt = phase_checkpoint(device)
    gc.collect()
    torch.cuda.empty_cache()
    published = phase_publish_serve(device, train)
    train.pop("final_window")
    gc.collect()
    torch.cuda.empty_cache()
    stamp("phase 9")
    resilient = phase_resilient(device)
    remat = phase_flash_jnp_remat(device)
    resnet = phase_resnet(device)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("phase 10")
    moe_res = phase_moe(device)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("phase 11")
    rec = phase_recurrent(device)
    gc.collect()
    torch.cuda.empty_cache()
    stamp("phase 12")
    mod = phase_modality(device)
    stamp("phase 13")
    entries = phase_yardstick(device, serve, kernels)
    fwd_slm, paged_slm = phase_yardstick_serving(device, serve_slm)
    fwd_qwen, paged_qwen = phase_yardstick_serving(
        device, moe_res["serve"][MOE_SERVE_ARCHS[0]], seed=27)
    train_entries, fwd_b4 = phase_yardstick_train(device, train, kernels)
    entries += train_entries
    entries += phase_yardstick_windows(device, train, kernels, windows)
    # the flash forward runs on three paths, the paged kernel on two: their
    # launches are the sums
    entries[0]["launches_by_path"] = {
        "serve": serve["launches"]["flash_fwd"],
        "serve_stablelm": serve_slm["launches"]["flash_fwd"],
        "train": train["launches"]["flash_fwd"]}
    entries[0]["at_train_shape"] = fwd_b4
    entries[0]["at_stablelm_shape"] = fwd_slm
    entries[1]["launches_by_path"] = {
        "serve": serve["launches"]["paged_attention"],
        "serve_stablelm": serve_slm["launches"]["paged_attention"]}
    # phase 9's paths (9a's five runs summed) and phase 10's add to the
    # counts of the kernels they launch
    paths = {"baselines": {k: sum(r["launches"][k] for r in
                                  baselines.values())
                           for k in _counts()},
             "checkpoint": ckpt["launches"],
             "publish_serve": published["launches"],
             "resilient": resilient["launches"],
             "remat_steps": remat["launches"],
             "resnet": resnet["launches"],
             "moe_serve": {k: sum(r["launches"][k] for r in
                                  moe_res["serve"].values())
                           for k in _counts()},
             "moe_train": moe_res["train"]["launches"],
             "hymba_serve": rec["serve"]["hymba-1.5b"]["launches"],
             "hymba_train": rec["train"]["hymba-1.5b"]["launches"],
             "xlstm_train": rec["train"]["xlstm-125m"]["launches"],
             "vlm_serve": mod["serve"]["internvl2-1b"]["launches"],
             "audio_serve": mod["serve"]["musicgen-medium"]["launches"],
             "naive_serve": {k: sum(r["launches"][k] for r in
                                    mod["decode_engine"].values())
                             for k in _counts()},
             "vlm_train": mod["train"]["internvl2-1b"]["launches"],
             "audio_train": mod["train"]["musicgen-medium"]["launches"],
             "gemma2_serve": large["serve"]["gemma2-27b"]["launches"],
             "command_r_serve": large["serve"]["command-r-35b"]["launches"],
             "gemma2_naive_serve": large["decode_engine"]["launches"],
             # phase 15: every rank's launches, summed over the ranks
             "mesh_flat": mesh["flat"]["launches"],
             "mesh_tree": {k: sum(r["launches"][k] for r in
                                  mesh["tree"].values())
                           for k in _counts()},
             # phase 16: every rank's launches, summed over the ranks
             "mesh_dp": par["dp"]["launches"],
             "mesh_tp": par["tp"]["launches"],
             "mesh_fsdp": {k: par["fsdp"]["launches"][k]
                           + par["fsdp"]["smoke_launches"][k]
                           for k in _counts()},
             # phase 17: every rank's launches, summed over the ranks
             "mesh_xlstm_tp": model_axis["xlstm_tp"]["launches"],
             "mesh_hymba_tp": model_axis["hymba_tp"]["launches"],
             "mesh_ep": model_axis["ep"]["launches"],
             # phase 18a: the lint's in-process cases
             "lint": lint18["launches"]}
    for e in entries:
        by_path = e.setdefault("launches_by_path", {"train": e["launches"]})
        for path, counts in paths.items():
            if counts[e["name"]]:
                by_path[path] = counts[e["name"]]
        e["launches"] = sum(by_path.values())
    entries[1]["at_stablelm_shape"] = paged_slm
    entries[0]["at_qwen2_moe_shape"] = fwd_qwen
    entries[1]["at_qwen2_moe_shape"] = paged_qwen
    entries[0]["at_hymba_shape"], entries[1]["at_hymba_shape"] = \
        phase_yardstick_hymba(device, rec["serve"]["hymba-1.5b"])
    # the sweeps' head_dim-192 instances (entries 3 and 4: dq, dk/dv)
    entries[3]["at_stablelm_shape"], entries[4]["at_stablelm_shape"] = \
        phase_yardstick_sweeps_192(device)
    # phase 13's shapes: internvl2-1b (G = 7) and musicgen-medium (G = 1,
    # head_dim 64) on the forward, the paged kernel and both sweeps
    for arch, recs in phase_yardstick_modality(device, mod).items():
        key = "at_" + arch.split("-")[0] + "_shape"
        entries[0][key] = {"prefill": recs["fwd"], "train": recs["fwd_b4"]}
        entries[1][key] = recs["paged"]
        entries[3][key], entries[4][key] = recs["dq"], recs["dkv"]
    # phase 14's shapes: gemma2-27b's local and global layers, command-r-
    # 35b's G = 8, on the forward and the paged kernel
    for arch, recs in phase_yardstick_large(device, large).items():
        key = "at_" + arch.rsplit("-", 1)[0].replace("-", "_") + "_shape"
        entries[0][key], entries[1][key] = recs["fwd"], recs["paged"]
    stamp("phase 6")
    print(f"[time] chip_smoke.py: {time.perf_counter() - t_start:.1f} s "
          f"from phase 1 to the kernels line | {CARD['line']}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
