"""Flash-attention forward: wrapper of the CUDA kernel ``csrc/flash_fwd.cu``.

Counterpart of ``repro.kernels.flash_attention`` (the Pallas
``_flash_kernel``). A CUDA tensor gets the kernel or an exception; a CPU
tensor gets the plain version (``kernels.ref.flash_attention_fwd_ref``).
There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.head_dim import (HEAD_DIMS, pad_head_dim,
                                         padded_head_dim)
from repro_torch.kernels.ref import flash_attention_fwd_ref

#: kernel launches made in this process (the wrapper adds one per launch)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + \
    [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_void_p]


def _lib():
    lib = build.library("flash_fwd")
    if lib.flash_fwd_launch.argtypes is None:
        lib.flash_fwd_launch.argtypes = _ARGTYPES
        lib.flash_fwd_launch.restype = ctypes.c_int
    return lib


def check_qkv(q, k, v):
    """Raise on q/k/v the CUDA kernels do not take (a head_dim must
    already be one of :data:`HEAD_DIMS`: the wrappers pad it)."""
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if q.device.type != "cuda":
        raise ValueError(f"flash kernel needs CUDA tensors, got {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or \
            q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernel takes bf16 or f32 q/k/v of one dtype, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,S,Hq,D), k/v (B,T,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, S, Hq, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Hq % k.shape[2]:
        raise ValueError(f"shape mismatch q {tuple(q.shape)} k {tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim {HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def flash_attention_fwd(q, k, v, *, window=None, logit_softcap=0.0,
                        sm_scale=None):
    """Causal GQA flash forward. q: (B,S,Hq,D); k/v: (B,T,Hkv,D); query
    row i and key j at positions i and j; ``sm_scale`` defaults to
    D**-0.5. Returns (out (B,S,Hq,D) in q's dtype, lse (B,Hq,S) f32) —
    lse is what a recompute backward needs. On the card a head_dim
    below 192 that is not an instance runs zero-padded
    (``kernels.head_dim``)."""
    global LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, window=window,
                                       logit_softcap=logit_softcap,
                                       sm_scale=sm_scale)
    D = q.shape[-1]
    Dp = padded_head_dim(D)
    if Dp != D:
        out, lse = flash_attention_fwd(
            *(pad_head_dim(x, Dp) for x in (q, k, v)), window=window,
            logit_softcap=logit_softcap,
            sm_scale=float(D) ** -0.5 if sm_scale is None else sm_scale)
        return out[..., :D], lse
    check_qkv(q, k, v)
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if B == 0 or S == 0:
        return out, lse
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, S, T, Hq, Hkv, D,
        0 if window is None else int(window), float(logit_softcap),
        float(D) ** -0.5 if sm_scale is None else float(sm_scale),
        int(q.dtype == torch.bfloat16), stream)
    build.check_launch(lib, rc, "flash_fwd")
    LAUNCHES += 1
    return out, lse


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention, the counterpart of the reference's
    ``custom_vjp``: the forward kernel saves (q, k, v, O, lse) and the
    backward runs the two recompute sweeps (``flash_attention_bwd``), so
    one gradient costs 1 forward and 2 backward launches. Under
    ``torch.utils.checkpoint`` the forward runs again inside the
    backward (and counts a second launch), exactly as ``jax.checkpoint``
    recomputes it."""

    @staticmethod
    def forward(ctx, q, k, v, window, logit_softcap, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, window=window,
                                       logit_softcap=logit_softcap,
                                       sm_scale=sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(window=window, logit_softcap=logit_softcap,
                        sm_scale=sm_scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        from repro_torch.kernels.flash_attention_bwd import \
            flash_attention_bwd
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None
