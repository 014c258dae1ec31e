"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: where there is no card (the CPU lanes) every test
skips with a reason. The check happens inside a fixture, so every
worker collects the same tests.

On the card, from the repo root (this file imports no JAX, and
``--noconftest`` keeps pytest from importing the JAX test fixtures):

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
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
    dict(B=2, S=300, T=300, Hq=8, Hkv=2, D=64, dtype=torch.float32),
    dict(B=2, S=80, T=80, Hq=4, Hkv=4, D=128, dtype=torch.float32, window=24,
         cap=15.0),
    dict(B=2, S=256, T=256, Hq=8, Hkv=4, D=128, dtype=torch.bfloat16,
         window=64, cap=50.0),
    dict(B=1, S=192, T=64, Hq=4, Hkv=2, D=64, dtype=torch.float32, window=16),
]

PAGED_CASES = [
    dict(lens=[0, 1, 17, 16, 100, 300, 543, 560], Hq=32, Hkv=8, D=64, ps=16,
         TW=35, dtype=torch.bfloat16),
    dict(lens=[50, 33, 17, 200], Hq=8, Hkv=2, D=128, ps=4, TW=5,
         dtype=torch.float32, window=16, cap=30.0),
    dict(lens=[12, 7, 1], Hq=2, Hkv=2, D=64, ps=2, TW=32,
         dtype=torch.float32),
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernel_matches_plain(smoke, case):
    res = smoke._flash_case("cuda", **case)
    assert res["pass"], res


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_kernel_matches_plain(smoke, case):
    res = smoke._paged_case("cuda", **case)
    assert res["pass"], res


def test_wrappers_count_launches_and_reject_bad_input(smoke):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    q = torch.randn(1, 64, 4, 64, device="cuda", dtype=torch.bfloat16)
    k = torch.randn(1, 64, 2, 64, device="cuda", dtype=torch.bfloat16)
    before = fa.LAUNCHES
    fa.flash_attention_fwd(q, k, k)
    assert fa.LAUNCHES == before + 1
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(q[..., :48].contiguous(),
                               k[..., :48].contiguous(),
                               k[..., :48].contiguous())
    with pytest.raises(TypeError):
        fa.flash_attention_fwd(q.half(), k.half(), k.half())
    pages = torch.zeros(3, 4, 2, 64, device="cuda", dtype=torch.bfloat16)
    tables = torch.zeros(1, 2, dtype=torch.int64, device="cuda")
    lens = torch.ones(1, dtype=torch.int32, device="cuda")
    with pytest.raises(TypeError, match="int32"):
        pa.paged_attention_cuda(q[:, 0], pages, pages, tables, lens)
    assert fa.LAUNCHES == before + 1
