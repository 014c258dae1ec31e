"""Paged-attention decode: wrapper of the CUDA kernel
``csrc/paged_attention.cu`` and the ``paged_attention(..., impl=)``
dispatch.

Counterpart of ``repro.kernels.paged_attention`` (the Pallas
``_paged_kernel``). A CUDA tensor gets the kernel or an exception; a CPU
tensor gets the plain version (``kernels.ref.paged_attention_ref``).
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.head_dim import (HEAD_DIMS, pad_head_dim,
                                         padded_head_dim)
from repro_torch.kernels.ref import paged_attention_ref

#: kernel launches made in this process (the wrapper adds one per launch)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + \
    [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = build.library("paged_attention")
    if lib.paged_attention_launch.argtypes is None:
        lib.paged_attention_launch.argtypes = _ARGTYPES
        lib.paged_attention_launch.restype = ctypes.c_int
    return lib


def _check(q, k_pages, v_pages, tables, lens):
    devs = {t.device for t in (q, k_pages, v_pages, tables, lens)}
    if len(devs) != 1:
        raise ValueError(f"paged kernel inputs on several devices: {devs}")
    if q.device.type != "cuda":
        raise ValueError(f"paged kernel needs CUDA tensors, got {q.device}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype) or \
            q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"paged kernel takes bf16 or f32 q/pages of one dtype, "
                        f"got {q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
    if tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError("tables and lens must be int32")
    if q.ndim != 3 or k_pages.ndim != 4 or v_pages.shape != k_pages.shape:
        raise ValueError(f"want q (B,Hq,D), pages (NP,ps,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    B, Hq, D = q.shape
    Hkv = k_pages.shape[2]
    if k_pages.shape[3] != D or Hq % Hkv or Hq // Hkv > 32:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} pages "
                         f"{tuple(k_pages.shape)} (group size must be <= 32)")
    if tables.ndim != 2 or tables.shape[0] != B or tuple(lens.shape) != (B,):
        raise ValueError(f"want tables (B,TW), lens (B,); got "
                         f"{tuple(tables.shape)}, {tuple(lens.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged kernel instances are head_dim {HEAD_DIMS}, "
                         f"got {D}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("tables", tables), ("lens", lens)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:                   # 16-byte cp.async copies
            raise ValueError(f"{name} must be 16-byte aligned")


def paged_attention_cuda(q, k_pages, v_pages, tables, lens, *, window=None,
                         logit_softcap=0.0, sm_scale=None):
    """Kernel launch. Same contract as :func:`paged_attention_ref`; table
    entries must be valid pool indices (TRASH_PAGE for unallocated ring
    slots: the lens/ring masking hides them). CPU tensors take the plain
    version.

    On the card the head_dim of ``q`` runs at its kernel instance
    (``kernels.head_dim``): q is zero-padded per call and the output
    sliced back. The pools should already be that wide — the model
    allocates them padded — and a pool at q's own width is padded here,
    a full copy. ``sm_scale`` defaults to q's (true) head_dim**-0.5."""
    global LAUNCHES
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, tables, lens,
                                   window=window, logit_softcap=logit_softcap,
                                   sm_scale=sm_scale)
    D = q.shape[-1]
    Dp = padded_head_dim(D)
    if sm_scale is None:
        sm_scale = float(D) ** -0.5
    if Dp != D:
        out = paged_attention_cuda(
            pad_head_dim(q, Dp), pad_head_dim(k_pages, Dp),
            pad_head_dim(v_pages, Dp), tables, lens, window=window,
            logit_softcap=logit_softcap, sm_scale=sm_scale)
        return out[..., :D]
    _check(q, k_pages, v_pages, tables, lens)
    B, Hq, D = q.shape
    ps, Hkv = k_pages.shape[1], k_pages.shape[2]
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.paged_attention_launch(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        B, Hq, Hkv, D, ps, tables.shape[1],
        0 if window is None else int(window), float(logit_softcap),
        float(sm_scale), int(q.dtype == torch.bfloat16), stream)
    build.check_launch(lib, rc, "paged_attention")
    LAUNCHES += 1
    return out


def paged_attention(q, k_pages, v_pages, tables, lens, *, window=None,
                    logit_softcap=0.0, sm_scale=None, impl: str = "kernel"):
    """Dispatch: ``impl`` "kernel" (the CUDA kernel; its plain version on
    CPU tensors) or "ref" (the gather reference on any device — what the
    ``naive`` attention config selects, as the JAX package's "jnp")."""
    if impl == "kernel":
        return paged_attention_cuda(q, k_pages, v_pages, tables, lens,
                                    window=window, logit_softcap=logit_softcap,
                                    sm_scale=sm_scale)
    if impl == "ref":
        return paged_attention_ref(q, k_pages, v_pages, tables, lens,
                                   window=window, logit_softcap=logit_softcap,
                                   sm_scale=sm_scale)
    raise ValueError(f"unknown paged-attention impl {impl!r}")
