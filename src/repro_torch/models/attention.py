"""Attention: GQA, causal, sliding-window, logit softcap.

Counterpart of ``repro.models.attention``. Implementations (selected by
``cfg.attn_impl``):

- ``naive``        — materializes the full score matrix. The oracle.
- ``flash_jnp``    — the reference's blockwise online-softmax path in
                     plain PyTorch (:func:`flash_attention_jnp`): a
                     ``torch.autograd.Function`` that saves only (q, k, v,
                     O, lse) and recomputes the block scores in its
                     backward, banded under a sliding window. No kernel:
                     the reference's path is pure ``jnp``.
- ``flash_pallas`` — the flash-forward kernel of ``repro_torch.kernels``
                     (CUDA C++ on the card, its plain version on the CPU).
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import softcap

NEG_INF = -1e30


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


# ===================================================================
# flash (blockwise online softmax) with a recomputing backward
# ===================================================================


def _block_live(qs, qb, ks, kb, window) -> bool:
    """Whether any (query, key) pair of a q block and a k block is inside
    the causal (and window) mask. A block with none adds exactly nothing
    to the online softmax (its scores are -1e30 + s, so alpha = 1 and
    p = 0) nor to a gradient (p = 0), so both passes skip it."""
    if ks > qs + qb - 1:
        return False
    return window is None or qs - (ks + kb - 1) < window


def _fwd_pass(q, k, v, window, logit_softcap, q_block, k_block):
    """Returns (out (B,S,Hq,D) q.dtype, lse (B,Hkv,G,S) f32). Products
    take the operands widened to f32 (exact for bf16) with f32 sums; the
    probabilities are rounded to v's dtype before P·V, as the reference's
    ``p.astype(v_blk.dtype)``."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    dscale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, G, D)
    kf, vf = k.float(), v.float()
    band = None
    if window is not None:
        band = min(((window + q_block + k_block - 1) // k_block + 1)
                   * k_block, T)

    def accum(carry, q_blk, k_blk, v_blk, qp, kp):
        o, m, l = carry
        s = torch.einsum("bqkgd,btkd->bkgqt", q_blk, k_blk) * dscale
        s = softcap(s, logit_softcap)
        bias = torch.where(_mask(qp, kp, window),
                           torch.zeros((), device=dev),
                           torch.full((), NEG_INF, device=dev))
        s = s + bias
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = alpha * l + p.sum(-1)
        o_new = alpha[..., None] * o + torch.einsum(
            "bkgqt,btkd->bkgqd", p.to(v.dtype).float(), v_blk)
        return o_new, m_new, l_new

    outs, lses = [], []
    for qs in range(0, S, q_block):
        q_blk = qg[:, qs:qs + q_block].float()
        qp = qs + torch.arange(q_block, device=dev)
        carry = (torch.zeros((B, Hkv, G, q_block, D), device=dev),
                 torch.full((B, Hkv, G, q_block), NEG_INF, device=dev),
                 torch.zeros((B, Hkv, G, q_block), device=dev))
        if band is not None:
            start = min(max(qs + q_block - 1 - (band - 1), 0), T - band)
            kp = start + torch.arange(band, device=dev)
            carry = accum(carry, q_blk, kf[:, start:start + band],
                          vf[:, start:start + band], qp, kp)
        else:
            for ks in range(0, T, k_block):
                if not _block_live(qs, q_block, ks, k_block, None):
                    continue
                kp = ks + torch.arange(k_block, device=dev)
                carry = accum(carry, q_blk, kf[:, ks:ks + k_block],
                              vf[:, ks:ks + k_block], qp, kp)
        o, m, l = carry
        live = l > 0
        lc = torch.clamp(l, min=1e-30)
        outs.append(torch.where(live[..., None], o / lc[..., None],
                                torch.zeros((), device=dev)))
        lses.append(torch.where(live, m + torch.log(lc),
                                torch.full((), NEG_INF, device=dev)))
    out = torch.cat(outs, dim=3)                     # (B, Hkv, G, S, D)
    out = torch.einsum("bkgsd->bskgd", out).reshape(B, S, Hq, D).to(q.dtype)
    return out, torch.cat(lses, dim=3)


def _bwd_pass(window, logit_softcap, q_block, k_block, res, dout):
    """Flash backward: the block scores recomputed from (q, k, v, O, lse),
    in f32. dK/dV sum over the q blocks for each k block, dQ over the k
    blocks for each q block, in the reference's order."""
    q, k, v, out, lse = res
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dev = q.device
    dscale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, Hkv, G, D).float()
    og = out.reshape(B, S, Hkv, G, D).float()
    dog = dout.reshape(B, S, Hkv, G, D).float()
    kf, vf = k.float(), v.float()
    delta = torch.einsum("bskgd,bskgd->bkgs", dog, og)

    def block_grads(qs, ks):
        q_blk = qg[:, qs:qs + q_block]
        do_blk = dog[:, qs:qs + q_block]
        lse_blk = lse[..., qs:qs + q_block]
        dl_blk = delta[..., qs:qs + q_block]
        k_blk = kf[:, ks:ks + k_block]
        v_blk = vf[:, ks:ks + k_block]
        qp = qs + torch.arange(q_block, device=dev)
        kp = ks + torch.arange(k_block, device=dev)
        s_pre = torch.einsum("bqkgd,btkd->bkgqt", q_blk, k_blk) * dscale
        s_cap = softcap(s_pre, logit_softcap)
        bias = torch.where(_mask(qp, kp, window),
                           torch.zeros((), device=dev),
                           torch.full((), NEG_INF, device=dev))
        p = torch.exp(s_cap + bias - lse_blk[..., None])  # 0 where masked
        dp = torch.einsum("bqkgd,btkd->bkgqt", do_blk, v_blk)
        ds = p * (dp - dl_blk[..., None])
        if logit_softcap:
            # d softcap: 1 - tanh² (s_cap/cap ∈ [-1, 1])
            ds = ds * (1.0 - torch.square(s_cap / logit_softcap))
        ds = ds * dscale
        return ds, p, q_blk, do_blk, k_blk

    dk = torch.zeros((B, T, Hkv, D), device=dev)
    dv = torch.zeros((B, T, Hkv, D), device=dev)
    for ks in range(0, T, k_block):               # pass 1: dK, dV
        for qs in range(0, S, q_block):
            if not _block_live(qs, q_block, ks, k_block, window):
                continue
            ds, p, q_blk, do_blk, _ = block_grads(qs, ks)
            dv[:, ks:ks + k_block] += torch.einsum("bkgqt,bqkgd->btkd", p,
                                                   do_blk)
            dk[:, ks:ks + k_block] += torch.einsum("bkgqt,bqkgd->btkd", ds,
                                                   q_blk)
    dq = torch.zeros((B, S, Hkv, G, D), device=dev)
    for qs in range(0, S, q_block):               # pass 2: dQ
        for ks in range(0, T, k_block):
            if not _block_live(qs, q_block, ks, k_block, window):
                continue
            ds, _, _, _, k_blk = block_grads(qs, ks)
            dq[:, qs:qs + q_block] += torch.einsum("bkgqt,btkd->bqkgd", ds,
                                                   k_blk)
    return (dq.reshape(B, S, Hq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


class FlashJnp(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``_flash``: the forward saves only
    (q, k, v, O, lse); the backward recomputes the block scores. Plain
    PyTorch: it launches no kernel of the port."""

    @staticmethod
    def forward(ctx, q, k, v, window, logit_softcap, q_block, k_block):
        out, lse = _fwd_pass(q, k, v, window, logit_softcap, q_block,
                             k_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (window, logit_softcap, q_block, k_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = _bwd_pass(*ctx.opts, ctx.saved_tensors, dout)
        return dq, dk, dv, None, None, None, None


def _pick_block(n: int, target: int) -> int:
    """Largest divisor of n that is ≤ target, taking the first multiple of
    64 met from the top (the reference's rule, so the blocks and the
    order of accumulation are the same)."""
    best = 1
    for b in range(min(target, n), 0, -1):
        if n % b == 0:
            if b % 64 == 0:
                return b
            best = max(best, b)
            if b <= 64:
                break
    return best


def flash_attention_jnp(q, k, v, q_pos=None, k_pos=None, *, window=None,
                        logit_softcap=0.0, q_block=512, k_block=512):
    """Blockwise causal attention (training/prefill layout: positions are
    arange; ``q_pos``/``k_pos`` accepted for API parity and ignored).
    Differentiable through :class:`FlashJnp`."""
    S, T = q.shape[1], k.shape[1]
    return FlashJnp.apply(q, k, v, window, float(logit_softcap),
                          _pick_block(S, q_block), _pick_block(T, k_block))


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
        return flash_attention_jnp(q, k, v, q_pos, k_pos, window=window,
                                   logit_softcap=logit_softcap)
    raise ValueError(f"unknown attn_impl {impl!r}")


def select_kv_heads(k, v, first_q: int, n_q: int, n_q_total: int):
    """The K/V heads a block of ``n_q`` q heads starting at ``first_q``
    attends to, out of all ``k``/``v`` heads (GQA: q head h reads kv head
    h // G). A model rank whose q heads are split but whose kv heads are
    not (their rule fell through to ``head_dim``) computes every kv head
    and keeps these: one contiguous run when the block covers whole
    groups, else one kv head per q head (its grouping is then 1)."""
    G = n_q_total // k.shape[2]
    if G == 1 or (first_q % G == 0 and n_q % G == 0):
        lo, n = first_q // G, max(n_q // G, 1)
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = torch.arange(first_q, first_q + n_q, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)
