"""Public wrappers around the port's kernels, shaped like
``repro.kernels.ops``.

The WA state machine calls the packed kernels of ``kernels.wa_update``
directly (flat ALIGN-padded buffers of ``common.packing``, one launch
for the whole parameter set). The per-leaf wrappers here
(:func:`wa_window_update`, :func:`online_mean`) pad ONE parameter leaf
to an ALIGN multiple and call the same kernels; their inputs are left
as they are.

Unlike the TPU wrapper, :func:`flash_attention` pads no sequence: the
CUDA kernels mask their own ragged edge (rows >= S, keys >= T). On the
card it pads head_dim once, before the autograd function, to the next
kernel instance (``kernels.head_dim``: 64, 128 or 192; grad-exact: zero
columns add nothing to q·k and get zero gradients), where the reference
pads to a multiple of 128.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.packing import ALIGN
from repro_torch.kernels import wa_update as wa
from repro_torch.kernels.flash_attention import FlashAttention
from repro_torch.kernels.head_dim import pad_head_dim, padded_head_dim


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, window=None,
                    logit_softcap=0.0):
    """run_attention-compatible wrapper (training/prefill layout: positions
    are arange from 0; ``q_pos``/``k_pos`` accepted for API parity and
    ignored). Differentiable: the backward is the two recompute sweeps.
    Returns out (B,S,Hq,D)."""
    D = q.shape[-1]
    Dp = padded_head_dim(D) if q.device.type == "cuda" else D
    q, k, v = (pad_head_dim(x, Dp) for x in (q, k, v))
    out = FlashAttention.apply(q.contiguous(), k.contiguous(),
                               v.contiguous(), window, float(logit_softcap),
                               float(D) ** -0.5)
    return out[..., :D] if Dp != D else out


def _pad_flat(x, n_lead=0):
    """``x`` flattened after its first ``n_lead`` dims and zero-padded to
    an ALIGN multiple (a new contiguous tensor). Returns (padded, n)."""
    flat = x.reshape(tuple(x.shape[:n_lead]) + (-1,))
    n = flat.shape[-1]
    return F.pad(flat, (0, (-n) % ALIGN)).contiguous(), n


def _scalar(x, dtype, device):
    return torch.as_tensor(x, dtype=dtype, device=device)


def wa_window_update(ring, total, new, idx, full_flag, inv_count):
    """Window push for ONE parameter leaf. ring: (I, *shape) f32; total:
    (*shape) f32; new: (*shape) of any float dtype; the scalars may be
    numbers or 0-dim tensors. Returns new (ring, total, avg) in the
    original shapes (avg f32); the inputs are not written."""
    dev = ring.device
    ring2, n = _pad_flat(ring, 1)
    total2, _ = _pad_flat(total)
    new2, _ = _pad_flat(new.float())
    ring2, total2, avg = wa.wa_window_update(
        ring2, total2, new2, _scalar(idx, torch.int32, dev),
        _scalar(full_flag, torch.float32, dev),
        _scalar(inv_count, torch.float32, dev))
    return (ring2[:, :n].reshape(ring.shape), total2[:n].reshape(total.shape),
            avg[:n].reshape(total.shape))


def online_mean(stacked):
    """(K, *shape) -> the mean over the replicas, in ``stacked``'s dtype
    (the kernel reads an f32 or bf16 stack as it is)."""
    x2, n = _pad_flat(stacked, 1)
    return wa.online_mean(x2)[:n].reshape(stacked.shape[1:]) \
        .to(stacked.dtype)
