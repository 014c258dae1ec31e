"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: where there is no card (the CPU lanes) every test
skips with a reason. The check happens inside a fixture, so every
worker collects the same tests.

On the card, from the repo root (this file imports no JAX, and
``--noconftest`` keeps pytest from importing the JAX test fixtures):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import importlib.util
import os

import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py's kernel cases, on a card; skip without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels run only on "
                    "the card; their plain versions are tested on the CPU)")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return mod


FLASH_CASES = [
    dict(B=1, S=512, T=512, Hq=32, Hkv=8, D=64, dtype=torch.bfloat16),
    dict(B=4, S=512, T=512, Hq=32, Hkv=8, D=64, dtype=torch.bfloat16),
    dict(B=2, S=300, T=300, Hq=8, Hkv=2, D=64, dtype=torch.float32),
    dict(B=2, S=80, T=80, Hq=4, Hkv=4, D=128, dtype=torch.float32, window=24,
         cap=15.0),
    dict(B=2, S=256, T=256, Hq=8, Hkv=4, D=128, dtype=torch.bfloat16,
         window=64, cap=50.0),
    dict(B=1, S=192, T=64, Hq=4, Hkv=2, D=64, dtype=torch.float32, window=16),
    # the bf16 edges of the Hopper design: ragged S, fully-masked rows, GQA
    # groups of 1, 2 and 8, head_dim 128 without a window
    dict(B=2, S=300, T=300, Hq=8, Hkv=2, D=64, dtype=torch.bfloat16),
    dict(B=1, S=192, T=64, Hq=4, Hkv=2, D=64, dtype=torch.bfloat16,
         window=16),
    dict(B=2, S=256, T=256, Hq=8, Hkv=8, D=64, dtype=torch.bfloat16),
    dict(B=2, S=256, T=256, Hq=32, Hkv=16, D=64, dtype=torch.bfloat16),
    dict(B=2, S=256, T=256, Hq=32, Hkv=4, D=64, dtype=torch.bfloat16),
    dict(B=2, S=256, T=256, Hq=8, Hkv=4, D=128, dtype=torch.bfloat16),
    # head dims that are not instances (160 runs at 192, 40 at 64), and 192
    dict(B=2, S=256, T=256, Hq=8, Hkv=2, D=160, dtype=torch.bfloat16),
    dict(B=2, S=200, T=200, Hq=8, Hkv=2, D=160, dtype=torch.float32,
         window=48, cap=20.0),
    dict(B=2, S=256, T=256, Hq=8, Hkv=2, D=40, dtype=torch.bfloat16),
    dict(B=2, S=200, T=200, Hq=8, Hkv=2, D=40, dtype=torch.float32,
         window=48, cap=20.0),
    dict(B=1, S=192, T=64, Hq=4, Hkv=2, D=192, dtype=torch.bfloat16,
         window=16),
    # qwen2-moe-a2.7b's prefill chunk: G = 1 at head_dim 128
    dict(B=1, S=512, T=512, Hq=16, Hkv=16, D=128, dtype=torch.bfloat16),
    # hymba-1.5b (G = 5, window 1024): the prefix fill, the training
    # batch, a window that binds (S = T = 1,536), and f32
    dict(B=1, S=128, T=128, Hq=25, Hkv=5, D=64, dtype=torch.bfloat16,
         window=1024),
    dict(B=4, S=640, T=640, Hq=25, Hkv=5, D=64, dtype=torch.bfloat16,
         window=1024),
    dict(B=1, S=1536, T=1536, Hq=25, Hkv=5, D=64, dtype=torch.bfloat16,
         window=1024),
    dict(B=1, S=1100, T=1100, Hq=25, Hkv=5, D=64, dtype=torch.float32,
         window=1024),
    # internvl2-1b (G = 7): the prefill chunk over 256 vision + 512 prompt
    # positions, the training batch, and f32; musicgen-medium (G = 1 at
    # head_dim 64): the prefill chunk and the training batch
    dict(B=1, S=768, T=768, Hq=14, Hkv=2, D=64, dtype=torch.bfloat16),
    dict(B=4, S=768, T=768, Hq=14, Hkv=2, D=64, dtype=torch.bfloat16),
    dict(B=1, S=300, T=300, Hq=14, Hkv=2, D=64, dtype=torch.float32),
    dict(B=1, S=512, T=512, Hq=24, Hkv=24, D=64, dtype=torch.bfloat16),
    dict(B=4, S=512, T=512, Hq=24, Hkv=24, D=64, dtype=torch.bfloat16),
    # gemma2-27b (G = 2 at head_dim 128, softcap 50): its 5,888-token
    # prefill chunk on a local layer (window 4096 binds) and a global one,
    # and f32 with S across 4,096; command-r-35b (G = 8): its 512-token
    # chunk and f32
    dict(B=1, S=5888, T=5888, Hq=32, Hkv=16, D=128, dtype=torch.bfloat16,
         window=4096, cap=50.0),
    dict(B=1, S=5888, T=5888, Hq=32, Hkv=16, D=128, dtype=torch.bfloat16,
         cap=50.0),
    dict(B=1, S=4200, T=4200, Hq=32, Hkv=16, D=128, dtype=torch.float32,
         window=4096, cap=50.0),
    dict(B=1, S=512, T=512, Hq=64, Hkv=8, D=128, dtype=torch.bfloat16),
    dict(B=1, S=300, T=300, Hq=64, Hkv=8, D=128, dtype=torch.float32),
]

PAGED_CASES = [
    dict(lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=32, Hkv=8, D=64, ps=16,
         TW=35, dtype=torch.bfloat16),
    dict(lens=[50, 33, 17, 200], Hq=8, Hkv=2, D=128, ps=4, TW=5,
         dtype=torch.float32, window=16, cap=30.0),
    dict(lens=[12, 7, 1], Hq=2, Hkv=2, D=64, ps=2, TW=32,
         dtype=torch.float32),
    # head dims that are not instances, on a pool padded as the model pads
    dict(lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=32, Hkv=8, D=160,
         ps=16, TW=35, dtype=torch.bfloat16),
    dict(lens=[3, 40, 129, 77], Hq=8, Hkv=2, D=160, ps=16, TW=9,
         dtype=torch.float32, window=50, cap=30.0),
    dict(lens=[3, 40, 129, 77], Hq=8, Hkv=2, D=40, ps=16, TW=9,
         dtype=torch.bfloat16),
    dict(lens=[3, 40, 129, 77], Hq=8, Hkv=2, D=40, ps=16, TW=9,
         dtype=torch.float32, window=50, cap=30.0),
    # the cluster split's edges (chip_smoke.PAGED_SPLIT_CASES)
    dict(lens=[1, 5, 16, 3], Hq=8, Hkv=2, D=64, ps=16, TW=35,
         dtype=torch.bfloat16),
    dict(lens=[300, 75, 41, 9], Hq=8, Hkv=2, D=64, ps=8, TW=9,
         dtype=torch.bfloat16, window=40),
    dict(lens=[300, 75, 41, 9], Hq=8, Hkv=2, D=128, ps=8, TW=9,
         dtype=torch.float32, window=40, cap=30.0),
    dict(lens=[0, 0], Hq=4, Hkv=1, D=64, ps=16, TW=35, dtype=torch.float32),
    # qwen2-moe-a2.7b decode: G = 1 at head_dim 128
    dict(lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=16, Hkv=16, D=128,
         ps=16, TW=35, dtype=torch.bfloat16),
    # hymba-1.5b decode: 5 warps a CTA (G = 5), window 1024, lens across
    # it so the ring (TW 65) wraps, in bf16 and f32
    dict(lens=[0, 1, 129, 300, 1023, 1024, 1025, 1184], Hq=25, Hkv=5, D=64,
         ps=16, TW=65, dtype=torch.bfloat16, window=1024),
    dict(lens=[0, 1, 129, 300, 1023, 1024, 1025, 1184], Hq=25, Hkv=5, D=64,
         ps=16, TW=65, dtype=torch.float32, window=1024),
    # internvl2-1b decode: 7 warps a CTA (G = 7), lens past the 256 vision
    # positions; musicgen-medium decode: G = 1 at head_dim 64
    dict(lens=[0, 1, 257, 300, 544, 700, 799, 800], Hq=14, Hkv=2, D=64,
         ps=16, TW=50, dtype=torch.bfloat16),
    dict(lens=[0, 1, 257, 300, 544, 700, 799, 800], Hq=14, Hkv=2, D=64,
         ps=16, TW=50, dtype=torch.float32),
    dict(lens=[0, 1, 17, 16, 100, 300, 543, 544], Hq=24, Hkv=24, D=64,
         ps=16, TW=34, dtype=torch.bfloat16),
    # gemma2-27b decode: lens across 4,096 (its edges 4,096 and 4,097) at
    # TW 370, a local layer (window 4096) in bf16 and f32 and a global one
    dict(lens=[1, 4095, 4096, 4097, 4098, 4700, 5800, 5920], Hq=32, Hkv=16,
         D=128, ps=16, TW=370, dtype=torch.bfloat16, window=4096, cap=50.0),
    dict(lens=[1, 4095, 4096, 4097, 4098, 4700, 5800, 5920], Hq=32, Hkv=16,
         D=128, ps=16, TW=370, dtype=torch.float32, window=4096, cap=50.0),
    dict(lens=[1, 4095, 4096, 4097, 4098, 4700, 5800, 5920], Hq=32, Hkv=16,
         D=128, ps=16, TW=370, dtype=torch.bfloat16, cap=50.0),
    # command-r-35b decode: 8 warps a CTA (G = 8) at head_dim 128
    dict(lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=64, Hkv=8, D=128,
         ps=16, TW=35, dtype=torch.bfloat16),
    dict(lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=64, Hkv=8, D=128,
         ps=16, TW=35, dtype=torch.float32),
]

#: two paged launches on the same inputs (chip_smoke._paged_repeat_case)
PAGED_REPEAT_CASES = [
    dict(lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=32, Hkv=8, D=64, ps=16,
         TW=35),
    dict(lens=[300, 75, 41, 9], Hq=8, Hkv=2, D=192, ps=8, TW=9, window=40,
         cap=30.0),
    dict(lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=16, Hkv=16, D=128, ps=16,
         TW=35),
    dict(lens=[0, 1, 129, 300, 1023, 1024, 1025, 1184], Hq=25, Hkv=5, D=64,
         ps=16, TW=65, window=1024),
    dict(lens=[0, 1, 257, 300, 544, 700, 799, 800], Hq=14, Hkv=2, D=64,
         ps=16, TW=50),
    dict(lens=[0, 1, 17, 16, 100, 300, 543, 544], Hq=24, Hkv=24, D=64,
         ps=16, TW=34),
    dict(lens=[1, 4095, 4096, 4097, 4098, 4700, 5800, 5920], Hq=32, Hkv=16,
         D=128, ps=16, TW=370, window=4096, cap=50.0),
    dict(lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=64, Hkv=8, D=128,
         ps=16, TW=35),
]


SYNC_CASES = [dict(K=K, I=I, full=full, P=3 * 8192)
              for K in (1, 2, 3, 4) for I in (1, 3) for full in (0.0, 1.0)]

#: the four slice-3 WA kernels (chip_smoke._wa_case), each at 0 ULP
WA_CASES = (
    [dict(kernel=k, I=I, full=full, P=3 * 8192)
     for k in ("wa_window_update", "wa_window_update_c")
     for I in (1, 3) for full in (0.0, 1.0)]
    + [dict(kernel="wa_sync_fused_c", K=K, I=I, full=full, P=3 * 8192)
       for K in (1, 2, 3, 4) for I in (1, 3) for full in (0.0, 1.0)]
    + [dict(kernel="online_mean", K=K, P=3 * 8192) for K in (1, 2, 3, 4)]
    + [dict(kernel="online_mean", K=3, P=3 * 8192,
            stack_dtype=torch.bfloat16),
       dict(kernel="online_mean", K=2, P=3 * 8192, inv_k=0.125)])

BWD_CASES = [
    dict(B=4, S=512, Hq=32, Hkv=8, D=64, dtype=torch.bfloat16),
    dict(B=4, S=512, Hq=32, Hkv=8, D=64, dtype=torch.bfloat16,
         through_ops=True),
    dict(B=2, S=300, Hq=8, Hkv=2, D=64, dtype=torch.float32),
    dict(B=1, S=192, T=64, Hq=4, Hkv=2, D=64, dtype=torch.float32,
         window=16),
    dict(B=2, S=256, Hq=8, Hkv=4, D=128, dtype=torch.bfloat16, window=64,
         cap=30.0),
    dict(B=2, S=160, Hq=4, Hkv=1, D=72, dtype=torch.float32, window=48,
         cap=8.0, through_ops=True),
    dict(B=2, S=128, Hq=4, Hkv=2, D=128, dtype=torch.float32,
         through_ops=True),
    dict(B=2, S=300, Hq=8, Hkv=2, D=64, dtype=torch.bfloat16),
    dict(B=1, S=192, T=64, Hq=4, Hkv=2, D=64, dtype=torch.bfloat16,
         window=16),
    dict(B=2, S=256, Hq=8, Hkv=8, D=64, dtype=torch.bfloat16),
    dict(B=2, S=256, Hq=32, Hkv=16, D=64, dtype=torch.bfloat16),
    dict(B=2, S=256, Hq=32, Hkv=4, D=64, dtype=torch.bfloat16, cap=20.0),
    dict(B=2, S=256, Hq=8, Hkv=4, D=128, dtype=torch.bfloat16),
    # head dims that are not instances, through the model's wrapper
    dict(B=2, S=256, Hq=8, Hkv=2, D=160, dtype=torch.bfloat16,
         through_ops=True),
    dict(B=2, S=200, Hq=8, Hkv=2, D=160, dtype=torch.float32, window=48,
         cap=20.0, through_ops=True),
    dict(B=2, S=256, Hq=8, Hkv=2, D=40, dtype=torch.bfloat16,
         through_ops=True),
    dict(B=2, S=200, Hq=8, Hkv=2, D=40, dtype=torch.float32, window=48,
         cap=20.0, through_ops=True),
    # head_dim 192: fully-masked rows get dq = 0 exactly; the two-warpgroup
    # dk/dv with a softcap
    dict(B=1, S=192, T=64, Hq=4, Hkv=2, D=192, dtype=torch.bfloat16,
         window=16),
    dict(B=2, S=300, Hq=8, Hkv=2, D=192, dtype=torch.bfloat16, cap=30.0),
    # granite-moe-1b-a400m's training shape
    dict(B=4, S=512, Hq=16, Hkv=8, D=64, dtype=torch.bfloat16,
         through_ops=True),
    # hymba-1.5b's training batch: G = 5 (a dk/dv cluster of 5 with 12/13
    # key rows a rank), window 1024, directly and through the wrappers;
    # and a binding window in f32
    dict(B=4, S=640, Hq=25, Hkv=5, D=64, dtype=torch.bfloat16,
         window=1024),
    dict(B=4, S=640, Hq=25, Hkv=5, D=64, dtype=torch.bfloat16,
         window=1024, through_ops=True),
    dict(B=1, S=1100, Hq=25, Hkv=5, D=64, dtype=torch.float32,
         window=1024),
    # internvl2-1b's training batch (256 + 512 positions): G = 7, a dk/dv
    # cluster of 7, directly and through the wrappers, and f32;
    # musicgen-medium's: G = 1 at head_dim 64
    dict(B=4, S=768, Hq=14, Hkv=2, D=64, dtype=torch.bfloat16),
    dict(B=4, S=768, Hq=14, Hkv=2, D=64, dtype=torch.bfloat16,
         through_ops=True),
    dict(B=1, S=300, Hq=14, Hkv=2, D=64, dtype=torch.float32),
    dict(B=4, S=512, Hq=24, Hkv=24, D=64, dtype=torch.bfloat16,
         through_ops=True),
    # command-r-35b's G = 8 (a dk/dv cluster of 8, its largest): directly,
    # through the wrappers, and f32
    dict(B=1, S=512, Hq=64, Hkv=8, D=128, dtype=torch.bfloat16),
    dict(B=1, S=512, Hq=64, Hkv=8, D=128, dtype=torch.bfloat16,
         through_ops=True),
    dict(B=1, S=300, Hq=64, Hkv=8, D=128, dtype=torch.float32),
]

#: two dk/dv launches on the same inputs (chip_smoke._dkv_repeat_case)
DKV_REPEAT_CASES = [
    dict(B=4, S=512, Hq=32, Hkv=8, D=64),
    dict(B=2, S=300, Hq=32, Hkv=4, D=64, window=100, cap=30.0),
    dict(B=2, S=256, Hq=8, Hkv=4, D=128),
    dict(B=2, S=256, Hq=8, Hkv=2, D=192),
    dict(B=4, S=512, Hq=16, Hkv=8, D=64),
    dict(B=4, S=640, Hq=25, Hkv=5, D=64, window=1024),
    dict(B=4, S=768, Hq=14, Hkv=2, D=64),
    dict(B=4, S=512, Hq=24, Hkv=24, D=64),
    dict(B=1, S=512, Hq=64, Hkv=8, D=128),
]


@pytest.mark.parametrize("case", SYNC_CASES)
def test_sync_kernel_is_0ulp_against_plain(smoke, case):
    res = smoke._sync_case("cuda", **case)
    assert res["pass"], res


@pytest.mark.parametrize("case", WA_CASES)
def test_slice3_wa_kernels_are_0ulp_against_plain(smoke, case):
    res = smoke._wa_case("cuda", **case)
    assert res["pass"], res


def test_per_leaf_wa_wrappers_match_plain(smoke):
    res = smoke._leaf_case("cuda")
    assert res["pass"], res


def test_slice3_wrappers_count_launches_and_reject_bad_input(smoke):
    from repro_torch.kernels import wa_update as wa
    dev = "cuda"
    P = 8192
    scal = (torch.tensor(0, dtype=torch.int32, device=dev),
            torch.tensor(0.0, device=dev), torch.tensor(1.0, device=dev))
    ring = torch.zeros(3, P, device=dev)
    ring_c = torch.zeros(3, P, device=dev, dtype=torch.bfloat16)
    total, comp, new = (torch.zeros(P, device=dev) for _ in range(3))
    before = (wa.WINDOW_UPDATE_LAUNCHES, wa.ONLINE_MEAN_LAUNCHES,
              wa.WINDOW_UPDATE_C_LAUNCHES, wa.SYNC_FUSED_C_LAUNCHES)
    wa.wa_window_update(ring, total, new + 1, *scal)
    wa.online_mean(torch.ones(2, P, device=dev, dtype=torch.bfloat16))
    wa.wa_window_update_c(ring_c, total, comp, new + 2, *scal)
    wa.wa_sync_fused_c(torch.ones(2, P, device=dev), ring_c, total, comp,
                       torch.tensor(1, dtype=torch.int32, device=dev),
                       *scal[1:])
    assert (wa.WINDOW_UPDATE_LAUNCHES, wa.ONLINE_MEAN_LAUNCHES,
            wa.WINDOW_UPDATE_C_LAUNCHES, wa.SYNC_FUSED_C_LAUNCHES) == \
        tuple(b + 1 for b in before)
    assert bool((ring[0] == 1).all()) and bool((ring[1:] == 0).all())
    assert bool((ring_c[0] == 2).all()) and bool((ring_c[1] == 1).all())
    with pytest.raises(TypeError):
        wa.wa_window_update_c(ring, total, comp, new, *scal)
    with pytest.raises(TypeError):
        wa.online_mean(torch.ones(2, P, device=dev, dtype=torch.float16))
    with pytest.raises(ValueError):
        wa.wa_window_update(ring[:, :6].contiguous(), total[:6], new[:6],
                            *scal)


@pytest.mark.parametrize("case", BWD_CASES)
def test_flash_bwd_kernels_match_plain(smoke, case):
    res = smoke._bwd_case("cuda", **case)
    assert res["pass"], res


@pytest.mark.parametrize("case", DKV_REPEAT_CASES)
def test_dkv_kernel_is_bitwise_reproducible(smoke, case):
    res = smoke._dkv_repeat_case("cuda", **case)
    assert res["pass"], res


def test_train_wrappers_count_launches(smoke):
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import wa_update as wa
    q = torch.randn(1, 64, 4, 64, device="cuda", requires_grad=True)
    k = torch.randn(1, 64, 2, 64, device="cuda", requires_grad=True)
    before = (fab.DQ_LAUNCHES, fab.DKV_LAUNCHES, wa.LAUNCHES)
    kops.flash_attention(q, k, k).sum().backward()
    ring = torch.zeros(3, 8192, device="cuda")
    total = torch.zeros(8192, device="cuda")
    scal = (torch.tensor(0, dtype=torch.int32, device="cuda"),
            torch.tensor(0.0, device="cuda"), torch.tensor(1.0, device="cuda"))
    wa.wa_sync_fused(torch.ones(2, 8192, device="cuda"), ring, total, *scal)
    assert (fab.DQ_LAUNCHES, fab.DKV_LAUNCHES, wa.LAUNCHES) == \
        (before[0] + 1, before[1] + 1, before[2] + 1)
    assert bool((ring[0] == 1).all()) and bool((ring[1:] == 0).all())
    with pytest.raises(TypeError):
        wa.wa_sync_fused(torch.ones(2, 8192, device="cuda",
                                    dtype=torch.float64), ring, total, *scal)


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(smoke, case):
    res = smoke._flash_case("cuda", **case)
    assert res["pass"], res


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain(smoke, case):
    res = smoke._paged_case("cuda", **case)
    assert res["pass"], res


@pytest.mark.parametrize("case", PAGED_REPEAT_CASES)
def test_paged_kernel_is_bitwise_reproducible(smoke, case):
    res = smoke._paged_repeat_case("cuda", **case)
    assert res["pass"], res


def test_wrappers_count_launches_and_reject_bad_input(smoke):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    q = torch.randn(1, 64, 4, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    before = fa.LAUNCHES
    fa.flash_attention_fwd(q, k, k)
    assert fa.LAUNCHES == before + 1
    # a head_dim above the largest instance (192) is refused; below it
    # every head_dim runs, zero-padded (tests/test_torch_headdim.py)
    wide = torch.zeros(1, 64, 4, 200, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(wide, wide[:, :, :2], wide[:, :, :2])
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), k.half())
    pages = torch.zeros(3, 4, 2, 64, device="cuda", dtype=torch.bfloat16)
    tables = torch.zeros(1, 2, dtype=torch.int64, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention_cuda(q[:, 0], pages, pages, tables, lens)
    assert fa.LAUNCHES == before + 1


def _card_trainer(method, remat="full"):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import DataPipeline, make_markov_lm_dataset
    from repro_torch.models.registry import build_model
    from repro_torch.train.trainer import TrainConfig, Trainer, lm_task
    cfg = get_smoke_config("granite-3-2b").with_(
        attn_impl="flash_pallas", dtype="bfloat16", remat=remat)
    ds = make_markov_lm_dataset(vocab=cfg.vocab_size, seq_len=64,
                                n_train=16, n_test=8, device="cuda")
    pipe = DataPipeline(ds, batch_size=4, n_replicas=1)
    tc = TrainConfig(method=method, total_steps=2, batch_size=4)
    return Trainer(lm_task(build_model(cfg), pipe, device="cuda"), tc), cfg


def test_sam_step_launches_twice_a_plain_step(smoke):
    """A SAM step runs two forward and backward passes: twice the flash
    forward, dq and dk/dv launches of a ca step."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    counts = {}
    for method in ("ca", "sam"):
        trainer, cfg = _card_trainer(method)
        params = trainer.task.init()
        before = (fa.LAUNCHES, fab.DQ_LAUNCHES, fab.DKV_LAUNCHES)
        params, _, loss, _ = trainer._single_step(
            params, trainer.optimizer.init(params), 0)
        assert bool(torch.isfinite(loss))
        counts[method] = tuple(a - b for a, b in zip(
            (fa.LAUNCHES, fab.DQ_LAUNCHES, fab.DKV_LAUNCHES), before))
    L = cfg.n_layers
    assert counts["ca"] == (2 * L, L, L)          # remat: two forwards
    assert counts["sam"] == tuple(2 * c for c in counts["ca"])


def test_publish_then_decode_equals_direct_params(smoke):
    """W̿ published into a card engine from a window state: the params are
    window_average's, bit for bit, and greedy decoding emits the tokens
    of an engine built on those params directly."""
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.offline import window_average, window_init, \
        window_update
    from repro_torch.models.registry import build_model
    from repro_torch.serve.engine import PagedDecodeEngine
    from repro_torch.serve.publish import WeightPublisher
    cfg = get_smoke_config("granite-3-2b").with_(attn_impl="flash_pallas",
                                                 dtype="bfloat16")
    lm = build_model(cfg)
    params = lm.init(torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    ws = window_init(params, 3)
    for s in range(4):
        ws, _ = window_update(ws, lm.init(
            torch.Generator(device="cuda").manual_seed(10 + s),
            device="cuda"), use_kernel=True)
    kw = dict(max_batch=2, max_seq_len=64, max_new=8, page_size=4,
              prefill_chunk=16, device="cuda")
    eng = PagedDecodeEngine(lm=lm, params=params, **kw)
    new = WeightPublisher(engine=eng).publish_window_state(ws)
    direct = window_average(ws, params)
    for a, b in zip(tree_leaves(new), tree_leaves(direct)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 9),
                                     generator=torch.Generator()
                                     .manual_seed(1)).numpy()}
    got = eng.generate(batch, 6)
    want = PagedDecodeEngine(lm=lm, params=direct, **kw).generate(batch, 6)
    assert torch.equal(got, want)


def test_resilient_sync_routes_on_card(smoke):
    """The resilient sync on the card: healthy, the window-update route
    equals the plain non-resilient route to the bit with one launch; with
    replica 1 poisoned, the card's resilient sync equals the CPU's (the
    plain versions) to the bit and k_alive is 1."""
    import dataclasses

    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.hwa import HWAConfig, hwa_init, hwa_sync
    from repro_torch.kernels import wa_update as wa
    from repro_torch.models.registry import build_model
    from repro_torch.optim import sgd

    cfg = get_smoke_config("granite-3-2b").with_(dtype="bfloat16")
    gen = torch.Generator().manual_seed(0)
    params = build_model(cfg).init(gen, device="cpu")
    hcfg = HWAConfig(n_replicas=2, window=3, use_kernels=True,
                     resilient=True)

    def state_on(dev, poison):
        state = hwa_init(hcfg, tree_map(lambda x: x.to(dev), params),
                         sgd(momentum=0.9))
        g = torch.Generator().manual_seed(1)
        for tree in (state.inner, state.inner_opt):
            for x in tree_leaves(tree):
                step = torch.randn(x.shape, generator=g) * 0.1
                x.copy_((x.float().cpu() + step).to(x.dtype))
                if poison:
                    x[1] = float("nan")
        return state

    def flat(state):
        return [x.cpu() for x in tree_leaves(
            (state.inner, state.inner_opt, state.wa,
             state.window_state.ring, state.window_state.total))]

    before = wa.WINDOW_UPDATE_LAUNCHES
    a, _ = hwa_sync(hcfg, state_on("cuda", False))
    assert wa.WINDOW_UPDATE_LAUNCHES == before + 1
    b, _ = hwa_sync(dataclasses.replace(hcfg, resilient=False,
                                        use_kernels=False),
                    state_on("cuda", False))
    for x, y in zip(flat(a), flat(b)):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))
    card, m = hwa_sync(hcfg, state_on("cuda", True))
    host, mh = hwa_sync(hcfg, state_on("cpu", True))
    assert int(m["k_alive"]) == int(mh["k_alive"]) == 1
    for x, y in zip(flat(card), flat(host)):
        assert torch.equal(x.view(torch.uint8), y.view(torch.uint8))


@pytest.mark.parametrize("size", [32, 31])
def test_resnet8_forward_on_card_matches_cpu(smoke, size):
    """ResNet-8's logits and new BN state on the card (cuDNN, TF32 off)
    against the CPU run, both parities of the stride-2 SAME padding:
    within 1e-5 of the tensor's largest value, the CPU tests' rule
    against JAX."""
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.models import convnet as tc

    cfg = tc.resnet_cifar_config(depth=8, n_classes=10, image_size=size)
    params, state = tc.init_resnet(cfg, torch.Generator().manual_seed(0))
    x = torch.randn((16, size, size, 3),
                    generator=torch.Generator().manual_seed(1))
    for train in (True, False):
        want = tc.apply_resnet(cfg, params, state, x, train)
        got = tc.apply_resnet(cfg, tree_map(lambda t: t.cuda(), params),
                              tree_map(lambda t: t.cuda(), state), x.cuda(),
                              train)
        for g, w in zip(tree_leaves(got), tree_leaves(want)):
            tol = 1e-5 * float(w.abs().max())
            assert float((g.cpu() - w).abs().max()) <= tol


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "granite-moe-1b-a400m"])
def test_moe_grouped_products_on_card_match_loop(smoke, arch):
    """The MoE layer on the card at its full widths (one layer, bf16):
    ``torch._grouped_mm`` (what the port runs on CUDA tensors) against the
    per-expert loop, forward and gradients, with empty groups (a decode
    step's 8 tokens); the same bits twice."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(arch).with_(n_layers=1)
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = {k: v[0].requires_grad_(True) for k, v in
         moe.init_moe(cfg, 1, gen, torch.bfloat16, "cuda").items()}
    x = torch.randn((1, 8, cfg.d_model), generator=gen, device="cuda") \
        .to(torch.bfloat16).requires_grad_(True)
    runs = []
    for impl in ("device", "loop", "device"):
        out, aux = moe.moe_forward(cfg, p, x, impl=impl)
        grads = torch.autograd.grad(out.float().square().sum() + aux,
                                    [x] + list(p.values()))
        runs.append([out.detach(), aux.detach(), *grads])
    assert moe.ffn_impl(x.device) == "device"
    for a, b in zip(runs[0], runs[2]):
        assert torch.equal(a, b)
    for a, b in zip(runs[0], runs[1]):
        assert smoke._close(a, b, smoke.FLASH_TOL[torch.bfloat16])[1]


def test_slstm_graphs_equal_eager_loops(smoke):
    """The sLSTM loops replayed as CUDA graphs (``ssm._run``, what the
    model runs on the card) give the eager loops' bits, forward and
    backward, on the first capture and on a later replay, at xlstm-125m's
    head shape (H 4, P 192) and a training batch of 4."""
    from repro_torch.models import ssm
    gen = torch.Generator(device="cuda").manual_seed(0)
    T, H, B, P = 96, 4, 4, 192

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    pre, r = rnd(T, H, B, 4 * P), rnd(H, P, 4 * P, scale=P ** -0.5)
    c0, n0, h0 = (rnd(H, B, P, scale=0.5) for _ in range(3))
    m0 = rnd(H, B, P, scale=0.5).abs()
    eager = ssm._slstm_forward(pre, r, c0, n0, m0, h0)
    for _ in range(2):                        # capture, then a replay
        graphed = ssm._run(ssm._slstm_forward, pre, r, c0, n0, m0, h0)
        assert all(torch.equal(a, b) for a, b in zip(eager, graphed))
    hs, cs, ns, ms, *gates = eager
    cot = (rnd(T, H, B, P), rnd(H, B, P), rnd(H, B, P), rnd(H, B, P))
    want = ssm._slstm_backward(r, hs, cs, ns, ms, *gates, *cot)
    for _ in range(2):
        got = ssm._run(ssm._slstm_backward, r, hs, cs, ns, ms, *gates, *cot)
        assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert all(bool(torch.isfinite(g).all()) for g in want)


# --------------------------------------- mesh-native HWA (phase 15's sites)


def _mesh_cases(K, tree, seed):
    """One sync case per ring dtype on numpy-made replicas (a shared
    normal plus 1% per replica) over an empty window."""
    import numpy as np
    from repro_torch.core.hwa import HWAConfig
    from repro_torch.core.offline import window_init
    from repro_torch.launch.sync import SyncPlan, TwoLevel
    rng = np.random.default_rng(seed)
    base = {"w": rng.standard_normal((64, 129)),
            "b": rng.standard_normal((300,))}
    stacked = {k: torch.from_numpy((v[None] + 0.01 * rng.standard_normal(
        (K,) + v.shape)).astype(np.float32)) for k, v in base.items()}
    one = {k: v[0] for k, v in stacked.items()}
    cases = []
    for tok in ("f32", "bf16", "fp8"):
        plan = SyncPlan(
            hwa=HWAConfig(n_replicas=K, window=3, use_kernels=True,
                          outer_every=2 if tree else 1),
            topology=TwoLevel(outer_every=2) if tree else None,
            wa_dtype=tok, comms_dtype=tok if tree else "f32")
        cases.append({"plan": plan, "stacked": stacked,
                      "window": window_init(one, 3, ring_dtype=tok),
                      "cycle": torch.tensor(0, dtype=torch.int32)})
    return cases


@pytest.mark.parametrize("shape", [{"replica": 2},
                                   {"pod": 2, "replica": 2}])
def test_mesh_sync_on_card_equals_cpu(smoke, shape):
    """The window-update kernels at their new call site, after a
    collective: the same syncs across ranks on the card (``gloo`` staged
    through the host on one card, ``nccl`` on a card a rank) and on the
    CPU (the plain versions),
    bit for bit; one window-update launch a rank for the f32 and bf16
    rings, none for fp8; no fused sync, no online mean."""
    from repro_torch.launch.mesh import backend_for, spawn_ranks
    tree = "pod" in shape
    K = 4 if tree else 2
    # ranks sharing a card take gloo, staged through the host; a card
    # a rank takes nccl, staged nowhere
    staging = backend_for("cuda", K, torch.cuda.device_count()) == "gloo"
    levels = [("replica",), ("pod",)] if tree else [("replica",)]
    job = "repro_torch.launch.sync.bundles:sync_cases"
    cases = _mesh_cases(K, tree, seed=K)
    card = spawn_ranks(shape, job, cases, device="cuda", levels=levels,
                       timeout=300)
    cpu = spawn_ranks(shape, job, cases, device="cpu", levels=levels,
                      timeout=300)

    def bits(t):
        return t.reshape(-1).view(torch.uint8)
    for a, b in zip(card, cpu):
        for ca, cb in zip(a["result"], b["result"]):
            for x, y in zip(smoke.tree_leaves({k: ca[k] for k in (
                    "params", "wa", "mean")}), smoke.tree_leaves(
                    {k: cb[k] for k in ("params", "wa", "mean")})):
                assert torch.equal(bits(x), bits(y))
            for f in ("ring", "total", "comp", "scales"):
                x, y = getattr(ca["window"], f), getattr(cb["window"], f)
                assert (x is None) == (y is None)
                assert x is None or torch.equal(bits(x), bits(y)), f
        launched = a["launches"]
        assert launched["wa_window_update"] == 1
        assert launched["wa_window_update_c"] == 1
        assert launched["wa_sync_fused"] == launched["online_mean"] == 0
        rep = a["ledger"]["replica"]
        assert rep["bytes"] > 0
        assert rep["staged_bytes"] == (2 * rep["bytes"] if staging else 0)


def test_mesh_native_smoke_run_on_card(smoke):
    """A 2-rank flat run of the smoke granite-3-2b with the flash kernels
    and remat off: every W̄ 0 ULP from the canonical mean of the gathered
    replicas, the flash forward and both sweeps once a layer a step a
    rank, the window update once a rank a sync, no collective in a train
    step."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import mesh_args, run_mesh_native
    cfg = get_smoke_config("granite-3-2b").with_(attn_impl="flash_pallas",
                                                 remat="none")
    out = run_mesh_native(mesh_args(
        k=2, steps=4, sync_period=2, window=3, batch_size=2, seq_len=64,
        device="cuda"), cfg=cfg, probe=True, with_state=False)
    L, steps, K = 2, 4, 2
    assert out["launches"] == dict(
        smoke._want(flash_fwd=K * steps * L, flash_bwd_dq=K * steps * L,
                    flash_bwd_dkv=K * steps * L, wa_window_update=K * 2))
    for rank in out["ranks"]:      # what the bundles declare, per rank
        assert rank["declared_launches"] == {
            "flash_fwd": steps * L, "flash_bwd_dq": steps * L,
            "flash_bwd_dkv": steps * L, "wa_window_update": 2}
    assert all(h["probe"]["mean_ulps"] == 0 and
               h["probe"]["restarts_equal"] for h in out["history"])
    assert all(r["train_collectives"] == {} for r in out["ranks"])


def test_mesh_native_nccl_route(smoke, tmp_path):
    """A card a rank (two or more cards) takes ``nccl``: the unstaged
    two-way all-reduce, the probe's all-gather and gather, the
    checkpoint's gather to rank 0 and a resume, on the smoke granite-3-2b.
    Every W̄ 0 ULP from its oracle, nothing staged through the host, the
    run resumed from step 4 bit-equal (SHA-256) to the uninterrupted
    one."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: nccl runs a card a rank")
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import mesh_args, run_mesh_native
    cfg = get_smoke_config("granite-3-2b").with_(attn_impl="flash_pallas",
                                                 remat="none")
    run = dict(k=2, steps=8, sync_period=2, window=3, batch_size=2,
               seq_len=64, device="cuda", checkpoint_dir=str(tmp_path),
               checkpoint_every=4)
    kw = dict(cfg=cfg, with_state=False, digest=True)
    out = run_mesh_native(mesh_args(**run), probe=True, **kw)
    assert out["backend"] == "nccl"
    assert all(h["probe"]["mean_ulps"] == 0 and
               h["probe"]["restarts_equal"] for h in out["history"])
    for rank in out["ranks"]:
        for s in rank["syncs"]:
            assert all(r["staged_bytes"] == 0
                       for r in s["collectives"].values())
    # a resume from step 4 of a session holding only that save
    import shutil
    shutil.rmtree(tmp_path / "step_00000008")
    resumed = run_mesh_native(mesh_args(**dict(run, checkpoint_every=9,
                                               resume=True)), **kw)
    assert resumed["resumed_from"] == 4
    assert resumed["digest"] == out["digest"]


@pytest.mark.parametrize("ring", ["f32", "bf16"])
def test_grouped_window_push_on_card_equals_plain(smoke, ring):
    """The window-update kernels at the grouped layout's call site, once a
    group (``packed._push_window_groups``) over a rank's ``(I, seg_len)``
    slices with one shared set of counters: three pushes on the card
    against the plain twin on the CPU on the same inputs, bit for bit;
    one launch a group a push."""
    from repro_torch.common.packing import (pack_spec_grouped,
                                            window_aux_buffers,
                                            window_buffers)
    from repro_torch.core.hwa import HWAConfig
    from repro_torch.core.offline import WindowState
    from repro_torch.kernels import wa_update
    from repro_torch.launch.sync.packed import _group_bounds, \
        _push_window_groups
    g = torch.Generator().manual_seed(5)
    tree = {"a": torch.zeros(64, 96), "b": torch.zeros(4096),
            "c": torch.zeros(8, 64, 32)}
    spec = pack_spec_grouped(tree, placements=[
        ((0, ("data",)),), (), ((1, ("data",)), (2, ("model",)))],
        axis_sizes={"data": 2, "model": 2})
    lspec = spec.local_spec()
    assert lspec.n_groups == 3
    cfg = HWAConfig(n_replicas=2, window=3, use_kernels=True)
    means = [torch.randn(lspec.padded, generator=g) for _ in range(3)]

    def run(dev):
        r, t = window_buffers(lspec, 3, ring, device=dev)
        s, c = window_aux_buffers(lspec, 3, ring, device=dev)
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        ws = WindowState(ring=r, total=t, count=zero,
                         next_idx=zero.clone(), window=3, spec=spec,
                         comp=c, scales=s)
        cycle, avgs = zero.clone(), []
        for m in means:
            ws, avg, cycle = _push_window_groups(
                cfg, _group_bounds(lspec), ws, m.to(dev), cycle)
            avgs.append(avg.cpu())
        return ws, avgs
    counter = ("WINDOW_UPDATE_LAUNCHES" if ring == "f32"
               else "WINDOW_UPDATE_C_LAUNCHES")
    before = getattr(wa_update, counter)
    card, card_avgs = run(torch.device("cuda"))
    torch.cuda.synchronize()
    assert getattr(wa_update, counter) - before == 3 * lspec.n_groups
    cpu, cpu_avgs = run(torch.device("cpu"))

    def bits(t):
        return t.cpu().reshape(-1).view(torch.uint8)
    for a, b in zip(card_avgs, cpu_avgs):
        assert torch.equal(bits(a), bits(b))
    for f in ("ring", "total", "comp"):
        x, y = getattr(card, f), getattr(cpu, f)
        assert (x is None) == (y is None)
        if x is not None:
            assert all(torch.equal(bits(p), bits(q)) for p, q in zip(x, y))
    assert int(card.count) == int(cpu.count) == 3


def test_mesh_native_grouped_run_on_card(smoke):
    """K 2 × data 2 × model 2 with FSDP (8 ranks on the card, ``gloo``),
    the smoke granite-3-2b: the grouped layout, the window update once a
    group a sync on every rank, every W̄ 0 ULP from its oracle and W̿ 0
    ULP from the stacked per-leaf ``hwa_sync`` on the host, the calls'
    collectives those their bundles declare."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import (contract_violations, mesh_args,
                                          run_mesh_native)
    cfg = get_smoke_config("granite-3-2b").with_(attn_impl="flash_jnp")
    out = run_mesh_native(mesh_args(
        k=2, tp=2, fsdp=True, world_size=8, steps=4, sync_period=2,
        window=3, batch_size=4, seq_len=64, device="cuda"), cfg=cfg,
        probe="host", with_state=False)
    n = out["layout"]["n_groups"]
    assert out["layout"]["grouped"] and n >= 2
    assert contract_violations(out) == []
    for rank in out["ranks"]:
        assert rank["launches"]["wa_window_update"] == 2 * n
        assert rank["declared_launches"] == {"wa_window_update": 2 * n}
    assert all(h["probe"]["mean_ulps"] == 0 and h["probe"]["restarts_equal"]
               and h["probe"]["wa_host_ulps"] == 0 for h in out["history"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ep_exchange_on_card_equals_cpu(smoke, dtype):
    """The expert-parallel exchange (``ReplicaMesh.all_to_all`` over
    ``model``, 2 ranks on the card, ``gloo``): CUDA tensors, staged
    through host memory, give the bits the same exchange gives CPU
    tensors; each rank receives block i from model rank i."""
    from repro_torch.launch.mesh import spawn_ranks
    g = torch.Generator().manual_seed(25)
    x = torch.randn((2, 3, 40, 64), generator=g).to(dtype)
    ranks = spawn_ranks({"data": 1, "model": 2},
                        "repro_torch.models.moe:ep_cases",
                        [{"exchange": x}], device="cuda",
                        levels=[("data",), ("model",)])
    for r, got in enumerate(ranks):
        res = got["result"][0]
        assert res["device"].dtype == dtype
        assert torch.equal(res["device"].view(torch.uint8),
                           res["cpu"].view(torch.uint8))
        # every rank sends the same x: block i of the result is x[r]
        assert torch.equal(res["cpu"], x[r][None].expand_as(x))
        staged = got["ledger"]["model"]["staged_bytes"]
        assert staged == 2 * x.numel() * x.element_size()


class _Widen(torch.autograd.Function):
    """Doubles its input; its backward (seeded) goes through f64."""
    @staticmethod
    def forward(ctx, x):
        return x * 2

    @staticmethod
    def backward(ctx, g):
        return (g.double() * 2).float()


def test_dtype_pass_sees_a_backward_on_the_card(smoke):
    """Autograd runs a CUDA backward on its own device thread: the dtype
    pass's op record sees an f64 op made there."""
    from repro_torch.analysis.contracts import BundleContract
    from repro_torch.analysis.passes import dtype_pass, record_call
    from repro_torch.launch.sync.bundles import StepBundle

    def fn(x):
        _Widen.apply(x).sum().backward()
        return x.grad
    x = torch.ones(64, device="cuda", requires_grad=True)
    _, art = record_call(StepBundle(fn=fn), (x,))
    res = dtype_pass(art, BundleContract())
    assert not res.ok and "forbidden dtype f64" in res.violations[0], res


@pytest.mark.parametrize("copy", [False, True], ids=["in-place", "copied"])
def test_donation_bounds_the_peak_on_the_card(smoke, copy):
    """The stacked fused sync of a 16 MiB block in four leaves holds its
    declared working set (K + 1 blocks); the same sync keeping a copy of
    its ring alive through the call (a window written out of place, its
    storage kept) goes over it and fails the donation pass."""
    from repro_torch.analysis import lint
    from repro_torch.analysis.passes import donation_pass, record_call
    from repro_torch.core.hwa import HWAConfig, hwa_init
    from repro_torch.launch.sync.bundles import _mk_optimizer
    hwa = HWAConfig(n_replicas=2, window=3, use_kernels=True)
    params = {k: torch.randn(1 << 20, device="cuda") for k in "abcd"}
    st = hwa_init(hwa, params, _mk_optimizer("sgd"))
    bundle = lint.stacked_sync_bundle(hwa, params)
    fn = inner = bundle.fn
    if copy:
        def fn(*a):
            ring = a[2].ring.clone()
            out = inner(*a)
            del ring
            return out
    bundle = dataclasses.replace(bundle, fn=fn)
    _, art = record_call(bundle, (st.inner, st.inner_opt, st.window_state,
                                  st.wa, st.cycle))
    res = donation_pass(art, bundle.contract)
    assert res.ok != copy, res
    if copy:
        assert "exceeds the declared working set" in res.violations[0]
