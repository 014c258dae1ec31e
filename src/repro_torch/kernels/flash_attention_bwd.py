"""Flash-attention backward: wrapper of the CUDA kernels ``csrc/flash_bwd.cu``.

Counterpart of ``repro.kernels.flash_attention_bwd`` (the Pallas
``_dq_kernel`` and ``_dkv_kernel``): one dq launch and one dk/dv launch
per backward, with δ = rowsum(dO⊙O) computed in PyTorch beforehand, as
the reference computes it in XLA. A CUDA tensor gets the kernels or an
exception; a CPU tensor gets the plain version
(``kernels.ref.flash_attention_bwd_ref``). There is no fallback from one
to the other.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import check_qkv
from repro_torch.kernels.head_dim import pad_head_dim, padded_head_dim
from repro_torch.kernels.ref import flash_attention_bwd_ref

#: kernel launches made in this process, per kernel (the wrapper adds one
#: per launch)
DQ_LAUNCHES = 0
DKV_LAUNCHES = 0

_COMMON = [ctypes.c_int] * 7 + [ctypes.c_float] * 2 + [ctypes.c_int,
                                                      ctypes.c_void_p]
_DQ_ARGTYPES = [ctypes.c_void_p] * 7 + _COMMON
_DKV_ARGTYPES = [ctypes.c_void_p] * 8 + _COMMON


def _lib():
    lib = build.library("flash_bwd")
    if lib.flash_bwd_dq_launch.argtypes is None:
        lib.flash_bwd_dq_launch.argtypes = _DQ_ARGTYPES
        lib.flash_bwd_dq_launch.restype = ctypes.c_int
        lib.flash_bwd_dkv_launch.argtypes = _DKV_ARGTYPES
        lib.flash_bwd_dkv_launch.restype = ctypes.c_int
    return lib


def flash_attention_bwd(q, k, v, out, lse, dout, *, window=None,
                        logit_softcap=0.0, sm_scale=None):
    """(dq, dk, dv) of causal GQA flash attention by the two recompute
    sweeps. Shapes as the forward; ``lse`` is its (B, Hq, S) f32 residual,
    ``out`` its output, ``dout`` the cotangent of ``out``. On the card a
    head_dim that is not an instance runs zero-padded, as the forward."""
    global DQ_LAUNCHES, DKV_LAUNCHES
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, window=window,
                                       logit_softcap=logit_softcap,
                                       sm_scale=sm_scale)
    D = q.shape[-1]
    Dp = padded_head_dim(D)
    if Dp != D:
        q, k, v, out, dout = (pad_head_dim(x, Dp)
                              for x in (q, k, v, out, dout))
        grads = flash_attention_bwd(
            q, k, v, out, lse, dout, window=window,
            logit_softcap=logit_softcap,
            sm_scale=float(D) ** -0.5 if sm_scale is None else sm_scale)
        return tuple(g[..., :D] for g in grads)
    check_qkv(q, k, v)
    for name, t, shape, dtype in (("out", out, q.shape, q.dtype),
                                  ("dout", dout, q.shape, q.dtype),
                                  ("lse", lse, (q.shape[0], q.shape[2],
                                                q.shape[1]), torch.float32)):
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype or \
                t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {tuple(shape)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.data_ptr() % 16:                   # TMA reads dout and lse
            raise ValueError(f"{name} must be 16-byte aligned")
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if B == 0 or S == 0:
        return dq, dk.zero_(), dv.zero_()
    # δ = Σ_d dO·O per row, in f32, laid out (B, Hq, S) like lse
    delta = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dscale = float(D) ** -0.5 if sm_scale is None else float(sm_scale)
    shape = (B, S, T, Hq, Hkv, D, 0 if window is None else int(window),
             float(logit_softcap), dscale, int(q.dtype == torch.bfloat16),
             torch.cuda.current_stream(q.device).cuda_stream)
    lib = _lib()
    rc = lib.flash_bwd_dq_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 dout.data_ptr(), lse.data_ptr(),
                                 delta.data_ptr(), dq.data_ptr(), *shape)
    build.check_launch(lib, rc, "flash_bwd_dq")
    DQ_LAUNCHES += 1
    rc = lib.flash_bwd_dkv_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  dout.data_ptr(), lse.data_ptr(),
                                  delta.data_ptr(), dk.data_ptr(),
                                  dv.data_ptr(), *shape)
    build.check_launch(lib, rc, "flash_bwd_dkv")
    DKV_LAUNCHES += 1
    return dq, dk, dv
