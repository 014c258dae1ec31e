"""Public wrappers around the port's kernels, shaped like
``repro.kernels.ops``.

Unlike the TPU wrapper, :func:`flash_attention` pads nothing: the CUDA
kernel masks its own ragged edge (rows >= S, keys >= T) and takes
head_dim 64 or 128 as it is.
"""
from __future__ import annotations

from repro_torch.kernels.flash_attention import flash_attention_fwd


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, window=None,
                    logit_softcap=0.0):
    """run_attention-compatible wrapper (training/prefill layout: positions
    are arange from 0; ``q_pos``/``k_pos`` accepted for API parity and
    ignored). Returns out (B,S,Hq,D)."""
    out, _ = flash_attention_fwd(q.contiguous(), k.contiguous(),
                                 v.contiguous(), window=window,
                                 logit_softcap=logit_softcap)
    return out
