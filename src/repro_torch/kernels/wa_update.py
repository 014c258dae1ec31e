"""The HWA weight-averaging kernels: wrappers of ``csrc/wa_update.cu``.

Counterparts of the Pallas launches of ``repro.kernels.wa_update``, over
flat packed buffers where the reference takes (rows, 1024) tiles:

- :func:`wa_sync_fused` (``wa_sync_fused_2d``): the whole f32 sync;
- :func:`wa_window_update` (``wa_window_update_2d``): push a given W̄
  into an f32 ring;
- :func:`online_mean` (``online_mean_2d``): the K-replica mean, of an
  f32 or bf16 stack;
- :func:`wa_window_update_c` (``wa_window_update_c_2d``): push into a
  bf16 ring with a Kahan-compensated f32 total;
- :func:`wa_sync_fused_c` (``wa_sync_fused_c_2d``): the whole sync
  over a bf16 ring.

A CUDA tensor gets the kernel or an exception; a CPU tensor gets the
plain version from ``kernels.ref``. There is no fallback from one to the
other. Both write ring, total and comp in place, as the reference's
aliased outputs do, and agree bit for bit. Each wrapper adds one to its
count where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import (online_mean_ref, wa_sync_fused_c_ref,
                                     wa_sync_fused_ref,
                                     wa_window_update_c_ref,
                                     wa_window_update_ref)

#: ring dtypes that have a window-update kernel: f32, and bf16 (the
#: ``*_c`` kernels). An fp8 ring runs the plain update, as in the
#: reference (its per-block scales have no kernel there either).
KERNEL_RING_DTYPES = (torch.float32, torch.bfloat16)

#: kernel launches made in this process, one count per kernel
LAUNCHES = 0                    # wa_sync_fused
WINDOW_UPDATE_LAUNCHES = 0      # wa_window_update
ONLINE_MEAN_LAUNCHES = 0        # online_mean
WINDOW_UPDATE_C_LAUNCHES = 0    # wa_window_update_c
SYNC_FUSED_C_LAUNCHES = 0       # wa_sync_fused_c

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    # stacked, ring, total, avg, scalars, P, K, inv_k, n_sm, stream
    "wa_sync_fused_launch": [_P] * 5 + [ctypes.c_int64, _I, _F, _I, _P],
    # ring, total, new, avg, scalars, P, n_sm, stream
    "wa_window_update_launch": [_P] * 5 + [ctypes.c_int64, _I, _P],
    # stacked, stacked_bf16, out, P, K, inv_k, n_sm, stream
    "online_mean_launch": [_P, _I, _P, ctypes.c_int64, _I, _F, _I, _P],
    # ring, total, comp, new, avg, scalars, P, n_sm, stream
    "wa_window_update_c_launch": [_P] * 6 + [ctypes.c_int64, _I, _P],
    # stacked, ring, total, comp, avg, scalars, P, K, inv_k, n_sm, stream
    "wa_sync_fused_c_launch": [_P] * 6 + [ctypes.c_int64, _I, _F, _I, _P],
}


def _lib():
    lib = build.library("wa_update")
    for name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, name)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _launch_args(dev):
    """(SM count, current stream) of ``dev``, the launchers' last two."""
    return (torch.cuda.get_device_properties(dev).multi_processor_count,
            torch.cuda.current_stream(dev).cuda_stream)


def _f32(x: float) -> float:
    """``x`` rounded to f32, as the reference's kernels take 1/K."""
    return float(torch.tensor(x, dtype=torch.float32))


def sync_scalars(idx, full_flag, inv_count) -> torch.Tensor:
    """The kernels' 3-word scalar operand, built on the device without a
    host read: idx's int32 bits, then full and inv_count as f32."""
    return torch.stack([idx.to(torch.int32).reshape(()).view(torch.float32),
                        full_flag.to(torch.float32).reshape(()),
                        inv_count.to(torch.float32).reshape(())])


def _check(P: int, dev, **named):
    """Each named (tensor, dtype, ndim) must lie on ``dev`` (a CUDA
    device), have that dtype and rank, be contiguous and 16-byte aligned,
    and end in the packed length P (P % 4 == 0)."""
    if P % 4 or P < 4:
        raise ValueError(f"packed length {P} is not a positive multiple "
                         f"of 4")
    for name, (t, dtype, ndim) in named.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must lie on {dev}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.ndim != ndim or t.shape[-1] != P:
            raise ValueError(f"{name} must be {ndim}-D ending in P={P}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


def wa_sync_fused(stacked, ring, total, idx, full_flag, inv_count):
    """The whole sync in one launch. stacked: (K, P); ring: (I, P); total:
    (P,), all f32; idx (int), full_flag and inv_count (f32) are 0-dim
    tensors on the same device. ``ring[idx]`` and ``total`` are written
    in place. Returns (ring, total, avg); W̄ is ring[idx]."""
    global LAUNCHES
    if stacked.device.type == "cpu":
        return wa_sync_fused_ref(stacked, ring, total, idx, full_flag,
                                 inv_count)
    K, P = stacked.shape
    f32 = torch.float32
    _check(P, stacked.device, stacked=(stacked, f32, 2), ring=(ring, f32, 2),
           total=(total, f32, 1))
    avg = torch.empty_like(total)
    scalars = sync_scalars(idx, full_flag, inv_count)
    lib = _lib()
    rc = lib.wa_sync_fused_launch(
        stacked.data_ptr(), ring.data_ptr(), total.data_ptr(), avg.data_ptr(),
        scalars.data_ptr(), P, K, _f32(1.0 / K), *_launch_args(stacked.device))
    build.check_launch(lib, rc, "wa_sync_fused")
    LAUNCHES += 1
    return ring, total, avg


def wa_window_update(ring, total, new, idx, full_flag, inv_count):
    """Push ``new`` (P,) f32 into the f32 ring (I, P) in one launch: ring
    row idx takes it, total becomes (total + new) - full·ring[idx], both
    in place. Returns (ring, total, avg = total·inv_count)."""
    global WINDOW_UPDATE_LAUNCHES
    if ring.device.type == "cpu":
        return wa_window_update_ref(ring, total, new, idx, full_flag,
                                    inv_count)
    P = total.shape[-1]
    f32 = torch.float32
    _check(P, ring.device, ring=(ring, f32, 2), total=(total, f32, 1),
           new=(new, f32, 1))
    avg = torch.empty_like(total)
    scalars = sync_scalars(idx, full_flag, inv_count)
    lib = _lib()
    rc = lib.wa_window_update_launch(
        ring.data_ptr(), total.data_ptr(), new.data_ptr(), avg.data_ptr(),
        scalars.data_ptr(), P, *_launch_args(ring.device))
    build.check_launch(lib, rc, "wa_window_update")
    WINDOW_UPDATE_LAUNCHES += 1
    return ring, total, avg


def online_mean(stacked, inv_k=None):
    """(K, P) f32 or bf16 replicas -> (P,) f32 mean, sum·f32(1/K) (or
    sum·f32(inv_k): a partial mean), in one launch."""
    global ONLINE_MEAN_LAUNCHES
    if stacked.device.type == "cpu":
        return online_mean_ref(stacked, inv_k)
    K, P = stacked.shape
    if stacked.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stacked must be float32 or bfloat16, got "
                        f"{stacked.dtype}")
    _check(P, stacked.device, stacked=(stacked, stacked.dtype, 2))
    out = torch.empty((P,), dtype=torch.float32, device=stacked.device)
    lib = _lib()
    rc = lib.online_mean_launch(
        stacked.data_ptr(), int(stacked.dtype == torch.bfloat16),
        out.data_ptr(), P, K, _f32(1.0 / K if inv_k is None else inv_k),
        *_launch_args(stacked.device))
    build.check_launch(lib, rc, "online_mean")
    ONLINE_MEAN_LAUNCHES += 1
    return out


def wa_window_update_c(ring, total, comp, new, idx, full_flag, inv_count):
    """Push ``new`` (P,) f32 into the bf16 ring (I, P) in one launch, the
    f32 total kept with the Kahan compensation comp; ring row idx, total
    and comp are written in place. Returns (ring, total, comp, avg)."""
    global WINDOW_UPDATE_C_LAUNCHES
    if ring.device.type == "cpu":
        ring, _, total, comp, avg = wa_window_update_c_ref(
            ring, None, total, comp, new, idx, full_flag, inv_count)
        return ring, total, comp, avg
    P = total.shape[-1]
    f32 = torch.float32
    _check(P, ring.device, ring=(ring, torch.bfloat16, 2),
           total=(total, f32, 1), comp=(comp, f32, 1), new=(new, f32, 1))
    avg = torch.empty_like(total)
    scalars = sync_scalars(idx, full_flag, inv_count)
    lib = _lib()
    rc = lib.wa_window_update_c_launch(
        ring.data_ptr(), total.data_ptr(), comp.data_ptr(), new.data_ptr(),
        avg.data_ptr(), scalars.data_ptr(), P, *_launch_args(ring.device))
    build.check_launch(lib, rc, "wa_window_update_c")
    WINDOW_UPDATE_C_LAUNCHES += 1
    return ring, total, comp, avg


def wa_sync_fused_c(stacked, ring, total, comp, idx, full_flag, inv_count):
    """The whole sync over a bf16 ring in one launch: the K-mean of the
    (K, P) f32 stack pushed as :func:`wa_window_update_c` pushes it.
    Returns (ring, total, comp, avg); W̄ is the decoded ring[idx]."""
    global SYNC_FUSED_C_LAUNCHES
    if stacked.device.type == "cpu":
        ring, _, total, comp, avg = wa_sync_fused_c_ref(
            stacked, ring, None, total, comp, idx, full_flag, inv_count)
        return ring, total, comp, avg
    K, P = stacked.shape
    f32 = torch.float32
    _check(P, stacked.device, stacked=(stacked, f32, 2),
           ring=(ring, torch.bfloat16, 2), total=(total, f32, 1),
           comp=(comp, f32, 1))
    avg = torch.empty_like(total)
    scalars = sync_scalars(idx, full_flag, inv_count)
    lib = _lib()
    rc = lib.wa_sync_fused_c_launch(
        stacked.data_ptr(), ring.data_ptr(), total.data_ptr(),
        comp.data_ptr(), avg.data_ptr(), scalars.data_ptr(), P, K,
        _f32(1.0 / K), *_launch_args(stacked.device))
    build.check_launch(lib, rc, "wa_sync_fused_c")
    SYNC_FUSED_C_LAUNCHES += 1
    return ring, total, comp, avg
