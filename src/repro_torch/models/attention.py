"""Attention: GQA, causal, sliding-window, logit softcap.

Counterpart of ``repro.models.attention``. Implementations (selected by
``cfg.attn_impl``):

- ``naive``        — materializes the full score matrix. The oracle.
- ``flash_pallas`` — the flash-forward kernel of ``repro_torch.kernels``
                     (CUDA C++ on the card, its plain version on the CPU).
- ``flash_jnp``    — not ported yet: its recompute VJP belongs to the
                     training slice, so selecting it raises.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import softcap

NEG_INF = -1e30

#: the ROADMAP item that ports the blockwise-jnp flash path
FLASH_JNP_ITEM = "ROADMAP.md Queue A 5 (the blockwise flash_jnp path)"


def _mask(q_pos, k_pos, window):
    """(…, S, T) boolean mask: causal + optional sliding window + validity."""
    ok = (k_pos[..., None, :] <= q_pos[..., :, None]) & \
        (k_pos[..., None, :] >= 0)
    if window is not None:
        ok &= (q_pos[..., :, None] - k_pos[..., None, :]) < window
    return ok


def naive_attention(q, k, v, q_pos, k_pos, *, window=None, logit_softcap=0.0,
                    sm_scale=None):
    """q: (B,S,Hq,D); k/v: (B,T,Hkv,D); q_pos/k_pos: (B,S)/(B,T) or (S,)/(T,).
    Scores are scaled by 1/sqrt(D), or by ``sm_scale`` where given (a
    caller whose D is zero-padded passes the true one's).

    bf16 operands with f32 accumulation, as the JAX version does: the
    operands are widened exactly (bf16 -> f32 is lossless) and the
    products run in f32; the probabilities are rounded to ``v``'s dtype
    before the second product, as ``probs.astype(v.dtype)`` does there.
    The widening copies only the tensors of this call (eager PyTorch
    hoists nothing out of the layer loop).
    """
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, D).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float())
    scores = scores / math.sqrt(D) if sm_scale is None else scores * sm_scale
    scores = softcap(scores, logit_softcap)
    mask = _mask(q_pos, k_pos, window)
    if mask.ndim == 3:                      # (B,S,T) -> (B,1,1,S,T)
        mask = mask[:, None, None]
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, S, Hq, D).to(q.dtype)


def run_attention(impl: str, q, k, v, q_pos, k_pos, *, window=None,
                  logit_softcap=0.0):
    """Dispatch on implementation; decode (S==1) always uses naive."""
    if impl == "naive" or q.shape[1] == 1:
        qp = q_pos if q_pos.ndim == 2 else q_pos[None].expand(q.shape[0], -1)
        kp = k_pos if k_pos.ndim == 2 else k_pos[None].expand(k.shape[0], -1)
        return naive_attention(q, k, v, qp, kp, window=window,
                               logit_softcap=logit_softcap)
    if impl == "flash_pallas":
        from repro_torch.kernels import ops as kops
        return kops.flash_attention(q, k, v, q_pos, k_pos, window=window,
                                    logit_softcap=logit_softcap)
    if impl == "flash_jnp":
        raise NotImplementedError(
            "attn_impl='flash_jnp' has no port yet; it arrives with "
            f"{FLASH_JNP_ITEM}. Use 'flash_pallas' or 'naive'.")
    raise ValueError(f"unknown attn_impl {impl!r}")
