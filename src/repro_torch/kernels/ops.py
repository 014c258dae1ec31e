"""Public wrappers around the port's kernels, shaped like
``repro.kernels.ops``.

Unlike the TPU wrapper, :func:`flash_attention` pads no sequence: the
CUDA kernels mask their own ragged edge (rows >= S, keys >= T). They take
head_dim 64 or 128; another head_dim is zero-padded up to the next of
those on the card (grad-exact: zero columns add nothing to q·k and get
zero gradients), as the reference pads to 128.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.flash_attention import HEAD_DIMS, FlashAttention
from repro_torch.kernels.wa_update import wa_sync_fused


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, window=None,
                    logit_softcap=0.0):
    """run_attention-compatible wrapper (training/prefill layout: positions
    are arange from 0; ``q_pos``/``k_pos`` accepted for API parity and
    ignored). Differentiable: the backward is the two recompute sweeps.
    Returns out (B,S,Hq,D)."""
    D = q.shape[-1]
    pad = 0
    if q.device.type == "cuda" and D not in HEAD_DIMS:
        pad = next((h for h in HEAD_DIMS if h > D), D) - D
        q, k, v = (F.pad(x, (0, pad)) for x in (q, k, v))
    out = FlashAttention.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), window, float(logit_softcap),
                               float(D) ** -0.5)
    return out[..., :D] if pad else out


def hwa_sync_packed(stacked, ring, total, idx, full_flag, inv_count):
    """The whole HWA sync in ONE launch over packed state (the CUDA kernel
    on the card, its plain version on the CPU).

    stacked: (K, P) packed replicas; ring: (I, P); total: (P,), f32;
    idx/full_flag/inv_count: 0-dim device tensors. ring and total are
    updated in place. Returns (ring, total, avg); W̄ for the replica
    restart is ring[idx]."""
    return wa_sync_fused(stacked, ring, total, idx, full_flag, inv_count)
