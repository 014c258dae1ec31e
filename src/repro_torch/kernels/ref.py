"""Plain PyTorch versions of the port's CUDA kernels.

They repeat each kernel's arithmetic in f32 on tensors of any device.
The CPU runs them whenever a kernel wrapper is handed CPU tensors; the
tests hold them against the JAX Pallas kernels (interpret mode), and
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.common.pytree import sum_axis0_f32
from repro_torch.common.quant import (SCALE_BLOCK, SLOT_CHUNK, decode_slot,
                                     encode_slot, fma_f32, kahan_add)
from repro_torch.models.attention import NEG_INF, naive_attention
from repro_torch.models.cache import paged_slot_pages
from repro_torch.models.common import softcap

#: query rows and keys per block of the blockwise flash loop
BLOCK = 64


def wa_window_update_ref(ring, total, new, idx, full_flag, inv_count):
    """Slide-window push of W̄ = ``new``. ring: (I, P) f32 and total: (P,)
    f32 are written IN PLACE (the reference donates both): ring row
    ``idx`` takes ``new``, total becomes (total + new) - ring[idx]·full,
    the reference's association. idx: 0-dim int tensor, full_flag and
    inv_count: 0-dim f32 tensors, all on the device (nothing is read back
    to the host). Returns (ring, total, avg = total·inv_count)."""
    row = idx.reshape(1).long()
    newf = new.float()
    old = ring.index_select(0, row)[0] * full_flag
    total.add_(newf).sub_(old)
    ring.index_copy_(0, row, newf[None])
    return ring, total, total * inv_count


def online_mean_ref(stacked, inv_k=None):
    """The K-replica mean of a (K, P) stack (f32 or bf16) as f32:
    sum·inv_k, the sum taken in f32 sequentially from k = 0 as the
    kernels take it, inv_k = f32(1/K) unless given (the partial mean of
    a sync whose replicas are spread over processes)."""
    K = stacked.shape[0]
    inv = torch.tensor(1.0 / K if inv_k is None else inv_k,
                       dtype=torch.float32)
    return sum_axis0_f32(stacked) * inv


def wa_sync_fused_ref(stacked, ring, total, idx, full_flag, inv_count):
    """The whole HWA sync (plain version of ``csrc/wa_update.cu``): the
    K-replica mean as sum·(1/K), the sum taken sequentially from k = 0 as
    the kernel takes it, then the window push. stacked: (K, P) f32.
    Returns (ring, total, avg), ring and total written in place; W̄ is
    ring[idx]."""
    return wa_window_update_ref(ring, total, online_mean_ref(stacked), idx,
                                full_flag, inv_count)


def wa_window_update_c_ref(ring, scales, total, comp, new, idx, full_flag,
                           inv_count):
    """Slide-window push into a compressed ring: ring (I, P) bf16
    (``scales`` None) or block-scaled fp8 (``scales`` (I, P/ALIGN) f32),
    total and comp (P,) f32 the Kahan pair. The total accumulates the
    DECODED value the slot will hold, so evicting it I pushes later
    removes exactly what was added:

        y = (decode(slot) - decode(ring[idx])·full) - comp
        total' = total + y;  comp' = (total' - total) - y

    For an fp8 slot, decode(slot) is a product (payload · scale), and the
    jitted reference (XLA on the CPU) contracts it with the eviction into
    one fused multiply-add: decode(slot) - old·full is rounded once. The
    port rounds it once too (``common.quant.fma_f32``), so that its fp8
    totals are the ones the reference's sync produces.

    ring, scales, total and comp are written IN PLACE, SLOT_CHUNK
    elements at a time (whole scale blocks, so the bits are those of one
    pass; the fp8 path's temporaries stay a chunk's). Returns
    (ring, scales, total, comp, avg = total'·inv_count)."""
    row = idx.reshape(1).long()
    # the row moves as integer bits: index_copy_ has no fp8 version
    bits = ring.view(torch.uint8 if ring.element_size() == 1
                     else torch.int16)
    for c in range(0, new.shape[-1], SLOT_CHUNK):
        n = min(SLOT_CHUNK, new.shape[-1] - c)
        part = bits.narrow(1, c, n)
        blk = None if scales is None else \
            scales.narrow(1, c // SCALE_BLOCK, -(-n // SCALE_BLOCK))
        slot, s_new = encode_slot(new[c:c + n].float(), ring.dtype)
        old = decode_slot(part.index_select(0, row)[0].view(ring.dtype),
                          None if blk is None else
                          blk.index_select(0, row)[0])
        if s_new is None:
            delta = decode_slot(slot) - old * full_flag
        else:
            blocks = (-1, SCALE_BLOCK)
            delta = fma_f32(slot.float().reshape(blocks), s_new[:, None],
                            -(old * full_flag).reshape(blocks)).reshape(-1)
        t, k = kahan_add(total[c:c + n], comp[c:c + n], delta)
        part.index_copy_(0, row, slot.view(bits.dtype)[None])
        if blk is not None:
            blk.index_copy_(0, row, s_new[None])
        total[c:c + n].copy_(t)
        comp[c:c + n].copy_(k)
    return ring, scales, total, comp, total * inv_count


def wa_sync_fused_c_ref(stacked, ring, scales, total, comp, idx, full_flag,
                        inv_count):
    """The whole sync over a compressed ring (plain version of
    ``csrc/wa_update.cu``'s bf16 sync): the K-mean as sum·(1/K), then
    :func:`wa_window_update_c_ref`. Returns (ring, scales, total, comp,
    avg); W̄ is the decoded ring[idx]."""
    return wa_window_update_c_ref(ring, scales, total, comp,
                                  online_mean_ref(stacked), idx, full_flag,
                                  inv_count)


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, window=None,
                            logit_softcap=0.0, sm_scale=None):
    """Recompute backward of causal GQA flash attention (the plain version
    of ``csrc/flash_bwd.cu``), over the full score matrix in f32.

    Same contract as the reference's ``_block_p_ds``: p = exp(capped s −
    lse) with a fully-masked row's lse (NEG_INF) swapped for 0, p
    re-masked to 0, dS = p·(dO·Vᵀ − δ) times the softcap derivative
    1 − (s/c)² (s the capped score) and dscale; δ = rowsum(dO⊙O). The G
    query heads of a GQA group sum into their kv head. Returns (dq, dk,
    dv) in the dtypes of q, k, v."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dscale = float(D) ** -0.5 if sm_scale is None else float(sm_scale)
    dev = q.device

    def heads(x):                                   # (B,S,Hq,D) -> (B,Hkv,G,S,D)
        return x.float().reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)

    qf, dof = heads(q), heads(dout)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]           # (B,Hkv,1,T,D)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    delta = (dout.float() * out.float()).sum(-1)             # (B,S,Hq)
    delta = delta.reshape(B, S, Hkv, G).permute(0, 2, 3, 1)[..., None]
    lse = lse.reshape(B, Hkv, G, S)[..., None]
    lse_safe = torch.where(lse > 0.5 * NEG_INF, lse, torch.zeros_like(lse))
    qp = torch.arange(S, device=dev)[:, None]
    kp = torch.arange(T, device=dev)[None, :]
    mask = kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    s = softcap((qf @ kf.transpose(-1, -2)) * dscale, logit_softcap)
    p = torch.where(mask, torch.exp(s - lse_safe), torch.zeros_like(s))
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - delta)
    if logit_softcap:
        ds = ds * (1.0 - torch.square(s / logit_softcap))
    ds = ds * dscale
    dq = (ds @ kf).permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)
    dk = (ds.transpose(-1, -2) @ qf).sum(2).permute(0, 2, 1, 3)
    dv = (p.transpose(-1, -2) @ dof).sum(2).permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_fwd_ref(q, k, v, *, window=None, logit_softcap=0.0,
                            sm_scale=None):
    """Blockwise causal GQA flash forward (the plain version of
    ``csrc/flash_fwd.cu``). q: (B,S,Hq,D); k/v: (B,T,Hkv,D); query row i
    and key j sit at positions i and j. Visits only the key blocks between
    the window's band start and the causal diagonal, re-masks p to 0 on
    masked entries, and gives a fully-masked row O = 0 and lse = NEG_INF.
    ``sm_scale`` defaults to D**-0.5. Returns (out (B,S,Hq,D) in q's
    dtype, lse (B,Hq,S) f32)."""
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    dscale = float(D) ** -0.5 if sm_scale is None else float(sm_scale)
    dev = q.device
    qf = q.float().reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # (B,Hkv,1,T,D)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    out = torch.zeros((B, Hkv, G, S, D), dtype=torch.float32, device=dev)
    lse = torch.full((B, Hkv, G, S), NEG_INF, dtype=torch.float32,
                     device=dev)
    for q0 in range(0, S, BLOCK):
        q1 = min(S, q0 + BLOCK)
        qb = qf[..., q0:q1, :]
        qp = torch.arange(q0, q1, device=dev)
        m = torch.full((B, Hkv, G, q1 - q0), NEG_INF, device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, G, q1 - q0, D), device=dev)
        k_lo = 0 if window is None else max(0, q0 - (window - 1))
        k_lo = (k_lo // BLOCK) * BLOCK
        for k0 in range(k_lo, min(T, q1), BLOCK):
            k1 = min(T, k0 + BLOCK)
            kp = torch.arange(k0, k1, device=dev)
            s = qb @ kf[..., k0:k1, :].transpose(-1, -2) * dscale
            s = softcap(s, logit_softcap)
            mask = kp[None, :] <= qp[:, None]
            if window is not None:
                mask &= (qp[:, None] - kp[None, :]) < window
            s = torch.where(mask, s, torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]),
                            torch.zeros_like(s))
            l = alpha * l + p.sum(dim=-1)
            acc = alpha[..., None] * acc + p @ vf[..., k0:k1, :]
            m = m_new
        live = l > 0
        safe = torch.where(live, l, torch.ones_like(l))
        out[..., q0:q1, :] = torch.where(live[..., None], acc / safe[..., None],
                                         torch.zeros_like(acc))
        lse[..., q0:q1] = torch.where(live, m + torch.log(safe),
                                      torch.full_like(m, NEG_INF))
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D).to(q.dtype)
    return out, lse.reshape(B, Hq, S)


def paged_attention_ref(q, k_pages, v_pages, tables, lens, *, window=None,
                        logit_softcap=0.0, sm_scale=None):
    """Gather-based decode attention (the plain version of
    ``csrc/paged_attention.cu``). q: (B, Hq, D) — the ONE current token per
    sequence (post-RoPE); k_pages/v_pages: (NP, ps, Hkv, D); tables: (B, TW)
    physical page per ring slot; lens: (B,) tokens written (query position
    = lens-1). ``sm_scale`` defaults to 1/sqrt(D). Returns (B, Hq, D).

    A slot with len 0 gives zeros, as the kernels (Pallas and CUDA) do;
    the JAX gather reference gives the mean of the trash page's values
    there, which no caller reads (the engine's lens are always >= 1).
    """
    B, Hq, D = q.shape
    ps = k_pages.shape[1]
    TW = tables.shape[1]
    lens = lens.long()
    tables = tables.long()
    cur_page = torch.div(lens - 1, ps, rounding_mode="floor")   # -1 if empty
    base = paged_slot_pages(TW, cur_page)                       # (B, TW)
    k_pos = base[..., None] * ps + torch.arange(ps, device=q.device)
    k_pos = torch.where(base[..., None] >= 0, k_pos, torch.full_like(k_pos, -1))
    k_pos = torch.where(k_pos <= (lens - 1)[:, None, None], k_pos,
                        torch.full_like(k_pos, -1))
    Hkv = k_pages.shape[2]
    k = k_pages[tables].reshape(B, TW * ps, Hkv, D)
    v = v_pages[tables].reshape(B, TW * ps, Hkv, D)
    q_pos = (lens - 1)[:, None]                                 # (B, 1)
    out = naive_attention(q[:, None], k, v, q_pos, k_pos.reshape(B, TW * ps),
                          window=window, logit_softcap=logit_softcap,
                          sm_scale=sm_scale)[:, 0]
    return torch.where((lens > 0)[:, None, None], out, torch.zeros_like(out))
