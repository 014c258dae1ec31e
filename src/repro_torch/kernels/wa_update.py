"""The fused HWA sync: wrapper of the CUDA kernel ``csrc/wa_update.cu``.

Counterpart of ``repro.kernels.wa_update.wa_sync_fused_2d`` (the Pallas
``_wa_sync_fused_kernel``). A CUDA tensor gets the kernel or an
exception; a CPU tensor gets the plain version
(``kernels.ref.wa_sync_fused_ref``). There is no fallback from one to
the other. Both update ``ring`` and ``total`` in place, as the
reference's aliased outputs do, and agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import wa_sync_fused_ref

#: kernel launches made in this process (the wrapper adds one per launch)
LAUNCHES = 0

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]


def _lib():
    lib = build.library("wa_update")
    if lib.wa_sync_fused_launch.argtypes is None:
        lib.wa_sync_fused_launch.argtypes = _ARGTYPES
        lib.wa_sync_fused_launch.restype = ctypes.c_int
    return lib


def sync_scalars(idx, full_flag, inv_count) -> torch.Tensor:
    """The kernel's 3-word scalar operand, built on the device without a
    host read: idx's int32 bits, then full and inv_count as f32."""
    return torch.stack([idx.to(torch.int32).reshape(()).view(torch.float32),
                        full_flag.to(torch.float32).reshape(()),
                        inv_count.to(torch.float32).reshape(())])


def _check(stacked, ring, total):
    for name, t in (("stacked", stacked), ("ring", ring), ("total", total)):
        if t.device.type != "cuda" or t.device != stacked.device:
            raise ValueError(f"{name} must lie on stacked's CUDA device, "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if stacked.ndim != 2 or ring.ndim != 2 or total.ndim != 1:
        raise ValueError(f"want stacked (K,P), ring (I,P), total (P,); got "
                         f"{tuple(stacked.shape)}, {tuple(ring.shape)}, "
                         f"{tuple(total.shape)}")
    P = stacked.shape[1]
    if ring.shape[1] != P or total.shape[0] != P or P % 4:
        raise ValueError(f"packed length mismatch or P % 4 != 0: stacked "
                         f"{tuple(stacked.shape)}, ring {tuple(ring.shape)}, "
                         f"total {tuple(total.shape)}")


def wa_sync_fused(stacked, ring, total, idx, full_flag, inv_count):
    """The whole sync in one launch. stacked: (K, P); ring: (I, P); total:
    (P,), all f32; idx (int), full_flag and inv_count (f32) are 0-dim
    tensors on the same device. ``ring[idx]`` and ``total`` are written
    in place. Returns (ring, total, avg); W̄ is ring[idx]."""
    global LAUNCHES
    if stacked.device.type == "cpu":
        return wa_sync_fused_ref(stacked, ring, total, idx, full_flag,
                                 inv_count)
    _check(stacked, ring, total)
    K, P = stacked.shape
    avg = torch.empty_like(total)
    scalars = sync_scalars(idx, full_flag, inv_count)
    lib = _lib()
    dev = stacked.device
    rc = lib.wa_sync_fused_launch(
        stacked.data_ptr(), ring.data_ptr(), total.data_ptr(), avg.data_ptr(),
        scalars.data_ptr(), P, K, float(torch.tensor(1.0 / K,
                                                      dtype=torch.float32)),
        torch.cuda.get_device_properties(dev).multi_processor_count,
        torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(lib, rc, "wa_sync_fused")
    LAUNCHES += 1
    return ring, total, avg
