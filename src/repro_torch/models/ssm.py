"""Recurrent sequence-mixing cells: mLSTM + sLSTM (xLSTM) and Mamba heads
(Hymba's parallel-SSM branch).

Counterpart of ``repro.models.ssm``, in plain PyTorch as the reference
writes them in plain ``jnp`` (no Pallas kernel). Every cell has one
calling convention, so training, prefill and cached decode run the same
code:

    y, state_out = <cell>_scan(cfg, params, x, state_in)

with x: (B, T, ...) and constant-size state dicts; T = 1 with a carried
state is the decode step, and training passes the zero state.

Where the reference runs ``lax.scan`` over time, the port runs a Python
loop over time steps. Long sequences take the chunkwise-parallel forms
(``_mlstm_chunkwise``, ``_mamba_chunkwise``) under the reference's rule:
the chunk is the largest divisor of T not above 256 (``_pick_chunk``),
taken when T is at least twice the chunk; a different chunk would round
differently. Their cumulative sums add in XLA's order (``_prefix_sum``),
and their masked decay weights take -inf in the exponent (``_causal``;
the reference's overflow there turns every gradient into NaN). sLSTM
has no chunkwise form: its step loop runs with its backward written out
(``_SLSTMScan``), on the card as CUDA graphs.

With a model axis inside a replica (``models.parallel.Par``) the
training forms ``mlstm_train_par``, ``slstm_train_par`` and
``mamba_train_par`` run the rank's heads where they divide by tp (the
leaves that do not line up with heads gathered whole, ``cell_gathers``;
the output side row-parallel), or the whole cell from gathered leaves
where they do not; no collective runs inside a time loop.

Initializers return stacked parameters, ``n`` copies along a leading
layer axis, with the reference's leaf names, shapes (after that axis)
and dtypes: the gates' leaves (``w_if``, ``b_if``, ``r``, ``b``,
``w_dt``, ``dt_bias``, ``A_log``, ``D_skip``) are f32 beside weights of
the model's dtype, and the constant leaves have the reference's bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.common import activation, normal_init

MLSTM_CHUNK = 256
MAMBA_CHUNK = 256


def _softplus(x):
    """``jax.nn.softplus``: ``max(x, 0) + log1p(exp(-|x|))`` (torch's
    softplus takes another formula and rounds differently)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _silu_as(x, dtype):
    """silu computed in f32, returned in ``dtype``."""
    return F.silu(x.float()).to(dtype)


def _rms_head_norm(x, eps=1e-6):
    """Per-head RMS norm (GroupNorm-style) over the last dim, no params."""
    xf = x.float()
    return (xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
            ).to(x.dtype)


def _causal_conv(x, kernel, conv_state=None):
    """Depthwise causal 1-D conv. x: (B, T, C), kernel: (K, C).

    If ``conv_state`` (B, K-1, C) is given it is prepended (decode path) and
    the updated state is returned; otherwise zero left-padding (train path).
    """
    K, T = kernel.shape[0], x.shape[1]
    if conv_state is None:
        pad = torch.zeros(x.shape[:1] + (K - 1,) + x.shape[2:],
                          dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                             # (B, T+K-1, C)
    out = sum(xp[:, i:i + T] * kernel[i] for i in range(K))
    new_state = xp[:, -(K - 1):] if K > 1 else pad
    return out, new_state


def _pick_chunk(T: int, target: int) -> int:
    """Largest divisor of T <= target, or 0 below 64 tokens (sequences
    with meta-token prefixes are not powers of two: hymba trains at
    T = 640, chunk 160)."""
    if target <= 0 or T < 2 * 32:
        return 0
    for b in range(min(target, T), 31, -1):
        if T % b == 0:
            return b
    return 0


#: XLA's block length for a cumulative sum (its reduce-window rewriter)
_CUMSUM_BLOCK = 16


def _prefix_sum(x):
    """Inclusive prefix sums along the last dim, added in the order XLA
    adds ``jnp.cumsum``'s on the CPU: each block of 16 left to right, then
    the blocks' totals the same way (recursively), each block's exclusive
    prefix added to it. ``torch.cumsum`` adds in another order (in f64 on
    the CPU), which moved the chunkwise forms by up to 3e-5 at T = 512."""
    n, bs = x.shape[-1], _CUMSUM_BLOCK
    if n <= bs:
        cols = [x[..., 0]]
        for i in range(1, n):
            cols.append(cols[-1] + x[..., i])
        return torch.stack(cols, dim=-1)
    nb = -(-n // bs)
    xb = F.pad(x, (0, nb * bs - n)).reshape(*x.shape[:-1], nb, bs)
    inner = _prefix_sum(xb)
    excl = F.pad(_prefix_sum(inner[..., -1])[..., :-1], (1, 0))
    return (inner + excl[..., None]).reshape(*x.shape[:-1], nb * bs)[..., :n]


def _suffix_sum(x):
    """Inclusive suffix sums along the last dim in XLA's order for a
    reverse ``cumsum`` (the transpose of :func:`_prefix_sum`): blocks of
    16 from the start, each output the sum of its block's tail left to
    right, then the blocks' totals the same way."""
    n, bs = x.shape[-1], _CUMSUM_BLOCK
    if n <= bs:
        acc = x
        for k in range(1, n):
            acc = torch.cat([acc[..., :n - k] + x[..., k:], acc[..., n - k:]],
                            dim=-1)
        return acc
    nb = -(-n // bs)
    xb = F.pad(x, (0, nb * bs - n)).reshape(*x.shape[:-1], nb, bs)
    inner = _suffix_sum(xb)
    excl = F.pad(_suffix_sum(inner[..., 0])[..., 1:], (0, 1))
    return (inner + excl[..., None]).reshape(*x.shape[:-1], nb * bs)[..., :n]


class _Cumsum(torch.autograd.Function):
    """``jnp.cumsum`` over the last dim: :func:`_prefix_sum`, whose
    gradient is the reverse sum (:func:`_suffix_sum`), as JAX's."""

    @staticmethod
    def forward(ctx, x):
        return _prefix_sum(x)

    @staticmethod
    def backward(ctx, g):
        return _suffix_sum(g)


def _cumsum(x):
    return _Cumsum.apply(x)


def _causal(mask, log_w):
    """An exponent with -inf above the diagonal, so that exp gives the
    masked weights 0 and their gradient 0. The reference exponentiates
    first and masks after (``jnp.where(mask, exp(x), 0)``): the same
    values, but once a chunk's log-decay spans more than 88 the masked
    exp overflows to inf and its backward multiplies 0 by inf, so every
    gradient of the model is NaN (hymba at T = 512 and 640)."""
    return torch.where(mask, log_w, float("-inf"))


def _bmm_last(a, b):
    """``einsum("...pq,...q->...p")``, as a product and a sum: a batched
    matrix-vector product of these small shapes runs ~1,000x slower
    than that on the CPU."""
    return (a * b[..., None, :]).sum(-1)


def _dot_last(a, b):
    """``einsum("...p,...p->...")``."""
    return (a * b).sum(-1)


# ===================================================================
# mLSTM (matrix-memory LSTM) — xLSTM [arXiv:2405.04517] eq. (19)-(27)
# ===================================================================


#: logical dims of an mLSTM cell's leaves (``sharding.rules``), one layer
MLSTM_DIMS = {"w_up": ("embed", "mlp"), "conv": (None, "mlp"),
              "w_q": ("mlp", None), "w_k": ("mlp", None),
              "w_v": ("mlp", None), "w_if": ("mlp", None), "b_if": (None,),
              "w_out": ("mlp", "embed")}


def init_mlstm(cfg, n, gen, dtype, device):
    D, H = cfg.d_model, cfg.n_heads
    d_inner = 2 * D                       # proj_factor 2 (xLSTM default)
    f32 = torch.float32
    b_if = torch.cat([torch.zeros((H,), dtype=f32, device=device),
                      3.0 * torch.ones((H,), dtype=f32, device=device)])
    return {
        "w_up": normal_init(gen, (n, D, 2 * d_inner), dtype, fan_in=D,
                            device=device),
        "conv": normal_init(gen, (n, cfg.conv_kernel, d_inner), dtype,
                            fan_in=cfg.conv_kernel, device=device),
        "w_q": normal_init(gen, (n, d_inner, d_inner), dtype, fan_in=d_inner,
                           device=device),
        "w_k": normal_init(gen, (n, d_inner, d_inner), dtype, fan_in=d_inner,
                           device=device),
        "w_v": normal_init(gen, (n, d_inner, d_inner), dtype, fan_in=d_inner,
                           device=device),
        "w_if": normal_init(gen, (n, d_inner, 2 * H), f32, fan_in=d_inner,
                            device=device),
        "b_if": b_if.expand(n, -1).clone(),
        "w_out": normal_init(gen, (n, d_inner, D), dtype, fan_in=d_inner,
                             device=device),
    }


def init_mlstm_state(cfg, batch, dtype=torch.float32, device=None):
    D, H = cfg.d_model, cfg.n_heads
    d_inner = 2 * D
    P = d_inner // H
    f32 = torch.float32
    return {
        "C": torch.zeros((batch, H, P, P), dtype=f32, device=device),
        "n": torch.zeros((batch, H, P), dtype=f32, device=device),
        "m": torch.zeros((batch, H), dtype=f32, device=device),
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, d_inner),
                            dtype=dtype, device=device),
    }


def _mlstm_chunkwise(q, k, v, i_pre, f_pre, state, chunk: int):
    """Chunkwise-parallel mLSTM (xLSTM App. A parallel form + stabilizer).

    The matrix memory is carried only across chunk boundaries; inside a
    chunk the interactions are a masked (L x L) decay-score product.
    q/k/v: (B,T,H,P); i_pre/f_pre: (B,T,H). Returns (h (B,T,H,P) f32,
    state').
    """
    B, T, H, P = q.shape
    L = chunk
    nc = T // L
    f32 = torch.float32

    def to_chunks(a):            # (B,T,H[,P]) -> (nc, B, H, L[, P])
        a = a.reshape(B, nc, L, *a.shape[2:]).movedim(1, 0)
        return a.transpose(2, 3)

    qc, kc, vc = (to_chunks(a.to(f32)) for a in (q, k, v))
    ic = to_chunks(i_pre.to(f32))
    fc = to_chunks(-_softplus(-f_pre.to(f32)))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=q.device))

    C0, n0, m0 = state["C"], state["n"], state["m"]   # (B,H,P,P),(B,H,P),(B,H)
    hs = []
    for c in range(nc):
        qb, kb, vb, ib, fb = qc[c], kc[c], vc[c], ic[c], fc[c]
        b = _cumsum(fb)                   # (B,H,L)
        g = torch.cummax(ib - b, dim=-1).values
        m = b + torch.maximum(m0[..., None], g)        # (B,H,L)
        # intra-chunk decay scores: exp(b_t - m_t + i_s - b_s), s <= t
        logS = (b - m)[..., :, None] + (ib - b)[..., None, :]
        S = torch.exp(_causal(mask, logS))             # (B,H,L,L)
        qk = qb @ kb.transpose(-1, -2)
        num = (S * qk) @ vb
        den = (S * qk).sum(-1)
        decay0 = torch.exp(b + m0[..., None] - m)      # (B,H,L)
        num = num + decay0[..., None] * (qb @ C0.transpose(-1, -2))
        den = den + decay0 * _bmm_last(qb, n0)
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m))[..., None])
        # carry to the next chunk
        mL = m[..., -1]
        w = torch.exp(b[..., -1:] - b + ib - mL[..., None])    # (B,H,L)
        decayL = torch.exp(b[..., -1] + m0 - mL)
        C0 = decayL[..., None, None] * C0 + \
            (w[..., None] * vb).transpose(-1, -2) @ kb
        n0 = decayL[..., None] * n0 + _bmm_last(kb.transpose(-1, -2), w)
        m0 = mL
    # (nc, B, H, L, P) -> (B, T, H, P)
    h = torch.stack(hs).movedim(0, 1).transpose(2, 3).reshape(B, T, H, P)
    return h, {"C": C0, "n": n0, "m": m0}


def _mlstm_heads(q, k, v, i_pre, f_pre, state, dtype):
    """The mLSTM recurrence over (B, T, H, P) heads (chunkwise or a step
    loop, by T): (h (B, T, H·P) head-normed in ``dtype``, carry)."""
    B, T, H, P = q.shape
    chunk = _pick_chunk(T, MLSTM_CHUNK)
    if chunk and T >= 2 * chunk:
        hs_bthp, carry = _mlstm_chunkwise(q, k, v, i_pre, f_pre, state, chunk)
        return _rms_head_norm(hs_bthp).reshape(B, T, H * P).to(dtype), carry

    C, n, m = state["C"], state["n"], state["m"]
    log_fs = -_softplus(-f_pre)
    qf, kf, vf = q.float(), k.float(), v.float()
    hs = []
    for t in range(T):
        it, log_f = i_pre[:, t], log_fs[:, t]                     # (B,H)
        qt, kt, vt = qf[:, t], kf[:, t], vf[:, t]                 # (B,H,P)
        m_new = torch.maximum(log_f + m, it)
        i_g = torch.exp(it - m_new)
        f_g = torch.exp(log_f + m - m_new)
        C = f_g[..., None, None] * C + i_g[..., None, None] * (
            vt[..., :, None] * kt[..., None, :])                  # (B,H,P,P)
        n = f_g[..., None] * n + i_g[..., None] * kt
        num = _bmm_last(C, qt)
        # true-scale denominator max(|n.q|, 1) in stabilized space
        den = torch.maximum(_dot_last(n, qt).abs(), torch.exp(-m_new))
        m = m_new
        hs.append((num / den[..., None]).to(dtype))
    h = torch.stack(hs, dim=1)                                   # (B,T,H,P)
    return _rms_head_norm(h).reshape(B, T, H * P), {"C": C, "n": n, "m": m}


def _sqrt_as(P: int, dtype) -> float:
    """sqrt(P) rounded to f32 and then to ``dtype``, as jnp.sqrt(P) is."""
    return float(torch.tensor(float(P)).sqrt().to(dtype))


def mlstm_scan(cfg, p, x, state):
    """x: (B, T, D) -> (y: (B, T, D), state')."""
    B, T, D = x.shape
    H = cfg.n_heads
    d_inner = 2 * D
    P = d_inner // H
    up = x @ p["w_up"]
    xm, z = up.chunk(2, dim=-1)                                  # (B,T,d_inner)
    xc, conv_state = _causal_conv(xm, p["conv"], state["conv"])
    xc = _silu_as(xc, x.dtype)
    q = (xc @ p["w_q"]).reshape(B, T, H, P)
    k = (xc @ p["w_k"]).reshape(B, T, H, P) / _sqrt_as(P, x.dtype)
    v = (xm @ p["w_v"]).reshape(B, T, H, P)
    gates = xc.float() @ p["w_if"] + p["b_if"]                  # (B,T,2H)
    i_pre, f_pre = gates.chunk(2, dim=-1)                        # (B,T,H)
    h, carry = _mlstm_heads(q, k, v, i_pre, f_pre, state, x.dtype)
    y = (h * _silu_as(z, x.dtype)) @ p["w_out"]
    return y, {**carry, "conv": conv_state}


def _zero_heads_state(B, H, shapes, device):
    return {k: torch.zeros((B, H) + sh, dtype=torch.float32, device=device)
            for k, sh in shapes.items()}


def mlstm_train_par(cfg, p, x, par):
    """The mLSTM block's training forward from the zero state on one rank
    of a replica split over ``model`` (``models.parallel.Par``; the
    leaves as ``Par.gather_leaves`` leaves them, by
    :func:`cell_gathers`).

    Where the heads divide by tp the rank runs its H/tp heads: the input
    side reads every channel, so ``w_up`` (its column blocks at tp 2 are
    the branch and the gate halves, not heads), ``conv`` and the
    ``mlp``-split rows of ``w_q``, ``w_k``, ``w_v`` and ``w_if`` are
    gathered whole and the rank takes its heads' columns of the products
    (their gradients summed over ``model``, the input's too); ``b_if``
    is whole, its gradient summed over ``model``; the recurrence runs on
    the rank's heads; ``w_out``'s row block is the rank's heads' channels
    (row-parallel, summed over ``model``). Otherwise every leaf was
    gathered and the block runs whole on each rank."""
    if not par.splits(cfg.n_heads):
        B = x.shape[0]
        return mlstm_scan(cfg, p, x, init_mlstm_state(
            cfg, B, x.dtype, x.device))[0]
    B, T, D = x.shape
    H = cfg.n_heads
    P = 2 * D // H
    hl = H // par.tp
    h0 = par.tp_index * hl
    cols = slice(h0 * P, (h0 + hl) * P)
    xin = par.copy_to_model(x)
    xm, z = (xin @ p["w_up"]).chunk(2, dim=-1)
    xc, _ = _causal_conv(xm, p["conv"])
    xc = _silu_as(xc, x.dtype)
    q = (xc @ p["w_q"][:, cols]).reshape(B, T, hl, P)
    k = (xc @ p["w_k"][:, cols]).reshape(B, T, hl, P) / _sqrt_as(P, x.dtype)
    v = (xm @ p["w_v"][:, cols]).reshape(B, T, hl, P)
    gate_cols = torch.cat([torch.arange(h0, h0 + hl),
                           H + torch.arange(h0, h0 + hl)]).to(x.device)
    gates = (xc.float() @ p["w_if"].index_select(1, gate_cols)
             + par.copy_to_model(p["b_if"]).index_select(0, gate_cols))
    i_pre, f_pre = gates.chunk(2, dim=-1)                        # (B,T,hl)
    state = _zero_heads_state(B, hl, {"C": (P, P), "n": (P,), "m": ()},
                              x.device)
    h, _ = _mlstm_heads(q, k, v, i_pre, f_pre, state, x.dtype)
    y = (h * _silu_as(z[..., cols], x.dtype)) @ p["w_out"]
    return par.reduce_from_model(y)


# ===================================================================
# sLSTM (scalar-memory LSTM with exponential gating + recurrence)
# ===================================================================


#: logical dims of an sLSTM cell's leaves, one layer
SLSTM_DIMS = {"w_in": ("embed", "mlp"), "r": ("heads", None, None),
              "b": (None,), "w_out": ("embed", "embed2"),
              "ff_up": ("embed", "mlp"), "ff_down": ("mlp", "embed")}


def slstm_ff(D: int) -> int:
    """The width of the post-cell FFN xLSTM's sLSTM blocks carry."""
    return max(2 * D, 64)


def init_slstm(cfg, n, gen, dtype, device):
    D, H = cfg.d_model, cfg.n_heads
    P = D // H
    f32 = torch.float32
    b = torch.zeros((4 * D,), dtype=f32, device=device)
    b[2 * D:3 * D] = 3.0                                          # f-gate bias
    ff = slstm_ff(D)
    return {
        "w_in": normal_init(gen, (n, D, 4 * D), dtype, fan_in=D,
                            device=device),                      # z,i,f,o
        "r": normal_init(gen, (n, H, P, 4 * P), f32, fan_in=P, device=device),
        "b": b.expand(n, -1).clone(),
        "w_out": normal_init(gen, (n, D, D), dtype, fan_in=D, device=device),
        "ff_up": normal_init(gen, (n, D, ff), dtype, fan_in=D, device=device),
        "ff_down": normal_init(gen, (n, ff, D), dtype, fan_in=ff,
                               device=device),
    }


def init_slstm_state(cfg, batch, dtype=torch.float32, device=None):
    D, H = cfg.d_model, cfg.n_heads
    P = D // H
    return {k: torch.zeros((batch, H, P), dtype=torch.float32, device=device)
            for k in ("c", "n", "m", "h")}


def _slstm_forward(pre, r, c0, n0, m0, h0):
    """The sLSTM step loop, grad mode off. pre: (T, H, B, 4P) f32, each
    step's [z | i | f | o]; r: (H, P, 4P) f32; c0, n0, m0, h0: (H, B, P)
    f32. Returns the states at every step (T + 1, H, B, P): hs, cs, ns,
    ms, and each step's gates for the backward: a (the pre-activations),
    z, o, ig, fg and lfm = log f + m (T, H, B, P)."""
    T, P = pre.shape[0], r.shape[1]
    shape = (T + 1,) + h0.shape
    hs, cs, ns, ms = (pre.new_empty(shape) for _ in range(4))
    for buf, x0 in ((hs, h0), (cs, c0), (ns, n0), (ms, m0)):
        buf[0] = x0
    a = torch.empty_like(pre)
    z, o, ig, fg, lfm = (pre.new_empty((T,) + h0.shape) for _ in range(5))
    for t in range(T):
        torch.baddbmm(pre[t], hs[t], r, out=a[t])
        zp, ip, fp, op = a[t].split(P, dim=-1)
        torch.tanh(zp, out=z[t])
        torch.sigmoid(op, out=o[t])
        torch.add(F.logsigmoid(fp), ms[t], out=lfm[t])
        torch.maximum(lfm[t], ip, out=ms[t + 1])
        torch.exp(ip - ms[t + 1], out=ig[t])
        torch.exp(lfm[t] - ms[t + 1], out=fg[t])
        torch.addcmul(fg[t] * cs[t], ig[t], z[t], out=cs[t + 1])
        torch.addcmul(ig[t], fg[t], ns[t], out=ns[t + 1])
        torch.div(o[t] * cs[t + 1], torch.clamp_min(ns[t + 1], 1e-6),
                  out=hs[t + 1])
    return hs, cs, ns, ms, a, z, o, ig, fg, lfm


def _slstm_backward(r, hs, cs, ns, ms, a, z, o, ig, fg, lfm, dhs, dc, dn,
                    dm):
    """BPTT through :func:`_slstm_forward`'s steps, grad mode off: the
    derivatives ``jax.grad`` takes of the reference's step, through the
    stabilizer ``m`` too (``maximum`` splits a tie's gradient in half, as
    ``lax.max``'s does). dhs: (T, H, B, P); dc, dn, dm: the final states'
    cotangents. Returns (dpre, dr, dc0, dn0, dm0, dh0)."""
    T, P = a.shape[0], r.shape[1]
    dh = torch.zeros_like(hs[0])
    dpre = torch.empty_like(a)
    dr = torch.zeros_like(r)
    for t in reversed(range(T)):
        ip, fp = a[t, ..., P:2 * P], a[t, ..., 2 * P:3 * P]
        c, n = cs[t + 1], ns[t + 1]
        nc = torch.clamp_min(n, 1e-6)
        g = dhs[t] + dh
        # h = o * c / max(n, 1e-6)
        do = g * c / nc
        dc = dc + g * o[t] / nc
        dnc = -(g * (o[t] * c)) / (nc * nc)
        dn = dn + dnc * ((n > 1e-6) + 0.5 * (n == 1e-6))
        # c = fg * c' + ig * z;  n = fg * n' + ig
        dfg = dc * cs[t] + dn * ns[t]
        dig = dc * z[t] + dn
        dz = dc * ig[t]
        dc, dn = dc * fg[t], dn * fg[t]
        # ig = exp(i - m); fg = exp(lfm - m); m = max(lfm, i)
        di = dig * ig[t]
        dl = dfg * fg[t]
        dm_t = dm - di - dl
        take = (lfm[t] > ip) + 0.5 * (lfm[t] == ip)
        dl = dl + dm_t * take
        di = di + dm_t * (1 - take)
        dm = dl                                           # lfm = log f + m'
        dzp, dip, dfp, dop = dpre[t].split(P, dim=-1)
        torch.mul(dz, 1 - z[t] * z[t], out=dzp)
        dip.copy_(di)
        torch.mul(dl, torch.sigmoid(-fp), out=dfp)        # d log sigmoid
        torch.mul(do, o[t] * (1 - o[t]), out=dop)
        dr.baddbmm_(hs[t].transpose(1, 2), dpre[t])
        dh = torch.bmm(dpre[t], r.transpose(1, 2))
    return dpre, dr, dc, dn, dm, dh


#: CUDA graphs of the sLSTM loops, by (loop, device, shapes)
_GRAPHS = {}


def _run(fn, *inputs):
    """``fn(*inputs)``: eagerly on the CPU; on the card as the replay of a
    CUDA graph of ``fn``, captured at its first call for these shapes
    (the inputs are copied into the graph's own, the outputs are the
    graph's buffers, which the next replay overwrites). A step loop
    issues its ~12 (forward) or ~45 (backward) small kernels a step from
    the host at ~15 us each; replayed, the kernels run back to back (on
    xlstm-125m's training batch, 4 x 512 tokens, ~0.1 ms of device time
    a layer-step against 4 s of host time a replica's step)."""
    if inputs[0].device.type != "cuda":
        return fn(*inputs)
    key = (fn.__name__, inputs[0].device,
           tuple((tuple(x.shape), x.dtype) for x in inputs))
    if key not in _GRAPHS:
        static = [x.clone() for x in inputs]
        side = torch.cuda.Stream(inputs[0].device)
        side.wait_stream(torch.cuda.current_stream(inputs[0].device))
        with torch.cuda.stream(side):
            fn(*static)                                   # warm up
        torch.cuda.current_stream(inputs[0].device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outputs = fn(*static)
        _GRAPHS[key] = (graph, static, outputs)
    graph, static, outputs = _GRAPHS[key]
    for dst, x in zip(static, inputs):
        dst.copy_(x)
    graph.replay()
    return outputs


class _SLSTMScan(torch.autograd.Function):
    """The sLSTM recurrence over T steps, with its backward written out
    (:func:`_slstm_forward`, :func:`_slstm_backward`). Under autograd the
    step loop would record ~20 ops a step and replay them through the
    engine: xlstm-125m's training step took 720K kernels at ~29 us of
    host time each on the card. Both loops run with grad mode off, and on
    the card as CUDA graphs (:func:`_run`). Layout: heads lead, so the
    recurrent product is one batched matmul a step. Returns (hs (T, H, B,
    P), c, n, m) at step T."""

    @staticmethod
    def forward(ctx, pre, r, c0, n0, m0, h0):
        out = _run(_slstm_forward, pre, r, c0, n0, m0, h0)
        if any(ctx.needs_input_grad):
            out = [x.clone() for x in out]
            ctx.save_for_backward(r, *out)
        hs, cs, ns, ms = out[:4]
        T = pre.shape[0]
        return hs[1:].clone(), cs[T].clone(), ns[T].clone(), ms[T].clone()

    @staticmethod
    def backward(ctx, dhs, dc, dn, dm):
        r, hs, *rest = ctx.saved_tensors
        zero = torch.zeros_like(hs[0])
        dhs = torch.zeros_like(hs[1:]) if dhs is None else dhs
        dc, dn, dm = (zero if g is None else g for g in (dc, dn, dm))
        grads = _run(_slstm_backward, r, hs, *rest, dhs.contiguous(),
                     dc.contiguous(), dn.contiguous(), dm.contiguous())
        return tuple(g.clone() for g in grads)


def _slstm_heads(pre_in, r, state):
    """The sLSTM recurrence over H heads: ``pre_in`` (B, T, 4·H·P) f32,
    each step's [z | i | f | o] of (H, P); ``state`` (B, H, P) each.
    Returns (y (B, T, H, P) f32, state')."""
    B, T = pre_in.shape[:2]
    H, P = r.shape[0], r.shape[1]
    # to (T, H, B, 4P) for all steps at once (a permutation, no arithmetic)
    pre = pre_in.reshape(B, T, 4, H, P).permute(1, 3, 0, 2, 4).reshape(
        T, H, B, 4 * P)
    heads_first = [state[k].transpose(0, 1).contiguous()
                   for k in ("c", "n", "m", "h")]
    hs, c, n, m = _SLSTMScan.apply(pre, r, *heads_first)
    return hs.permute(2, 0, 1, 3), {                            # (B,T,H,P)
        "c": c.transpose(0, 1), "n": n.transpose(0, 1),
        "m": m.transpose(0, 1), "h": hs[-1].transpose(0, 1)}


def _slstm_ffn(p, y, dtype):
    ff = activation("gelu")((y @ p["ff_up"]).float()).to(dtype)
    return ff @ p["ff_down"]


def slstm_scan(cfg, p, x, state):
    B, T, D = x.shape
    pre_in = (x @ p["w_in"]).float() + p["b"]                   # (B,T,4D)
    y, state = _slstm_heads(pre_in, p["r"], state)
    y = _rms_head_norm(y).reshape(B, T, D).to(x.dtype)
    y = y @ p["w_out"]
    return y + _slstm_ffn(p, y, x.dtype), state


def slstm_train_par(cfg, p, x, par):
    """The sLSTM block's training forward from the zero state on one rank
    of a replica split over ``model`` (``Par.gather_leaves`` by
    :func:`cell_gathers`). Where the heads divide by tp the rank runs its
    H/tp heads: ``w_in`` (its column blocks are the z, i, f, o quarters,
    not heads) is gathered whole and the rank takes its heads' columns of
    each quarter (its gradient and the input's summed over ``model``),
    ``b`` likewise from the whole leaf; ``r`` is split over the heads
    (in place); the heads' outputs are all-gathered for ``w_out``, which
    stays whole over ``model`` (its gradient is then whole on each rank).
    Otherwise the cell runs whole from the gathered ``w_in``. The FFN is
    column- then row-parallel where its width divides (``ff_up``/
    ``ff_down`` in place, summed over ``model``), whole elsewhere."""
    B, T, D = x.shape
    H = cfg.n_heads
    P = D // H
    zero = {k: (P,) for k in ("c", "n", "m", "h")}
    if par.splits(H):
        hl = H // par.tp
        h0 = par.tp_index * hl
        xin = par.copy_to_model(x)
        w_in = p["w_in"].reshape(D, 4, H, P)[:, :, h0:h0 + hl].reshape(
            D, 4 * hl * P)
        b = par.copy_to_model(p["b"]).reshape(4, H, P)[:, h0:h0 + hl] \
            .reshape(-1)
        y, _ = _slstm_heads((xin @ w_in).float() + b, p["r"],
                            _zero_heads_state(B, hl, zero, x.device))
        y = _rms_head_norm(y).reshape(B, T, hl * P).to(x.dtype)
        y = par.gather_blocks(y, 2)
    else:
        y, _ = _slstm_heads((x @ p["w_in"]).float() + p["b"], p["r"],
                            _zero_heads_state(B, H, zero, x.device))
        y = _rms_head_norm(y).reshape(B, T, D).to(x.dtype)
    y = y @ p["w_out"]
    if par.splits(slstm_ff(D)):
        ff = par.reduce_from_model(_slstm_ffn(p, par.copy_to_model(y),
                                              x.dtype))
    else:
        ff = _slstm_ffn(p, y, x.dtype)
    return y + ff


# ===================================================================
# Mamba2-style selective-SSM heads (Hymba's parallel branch)
# ===================================================================


#: logical dims of a Mamba branch's leaves, one layer
MAMBA_DIMS = {"w_in": ("embed", "mlp"), "conv": (None, "mlp"),
              "w_bc": ("mlp", None), "w_dt": ("mlp", "ssm_heads"),
              "dt_bias": ("ssm_heads",), "A_log": ("ssm_heads",),
              "D_skip": ("ssm_heads",), "w_out": ("mlp", "embed")}


def init_mamba(cfg, n, gen, dtype, device):
    D = cfg.d_model
    H = cfg.ssm_heads or cfg.n_heads
    N = cfg.ssm_state
    d_inner = D                                # hymba: SSM branch width = D
    f32 = torch.float32

    def const(v):
        return torch.full((n, H), v, dtype=f32, device=device)
    return {
        "w_in": normal_init(gen, (n, D, 2 * d_inner), dtype, fan_in=D,
                            device=device),
        "conv": normal_init(gen, (n, cfg.conv_kernel, d_inner), dtype,
                            fan_in=cfg.conv_kernel, device=device),
        "w_bc": normal_init(gen, (n, d_inner, 2 * N), dtype, fan_in=d_inner,
                            device=device),
        "w_dt": normal_init(gen, (n, d_inner, H), f32, fan_in=d_inner,
                            device=device),
        "dt_bias": const(0.0),
        "A_log": torch.log(const(1.0)),
        "D_skip": const(1.0),
        "w_out": normal_init(gen, (n, d_inner, D), dtype, fan_in=d_inner,
                             device=device),
    }


def init_mamba_state(cfg, batch, dtype=torch.float32, device=None):
    D = cfg.d_model
    H = cfg.ssm_heads or cfg.n_heads
    N = cfg.ssm_state
    P = D // H
    return {"S": torch.zeros((batch, H, P, N), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, D), dtype=dtype,
                                device=device)}


def _mamba_chunkwise(xh, b_in, c_out, dt, a, state, chunk: int):
    """Chunkwise-parallel selective SSM (Mamba2 SSD form); no stabilizer:
    the decay exp(dt * a) is <= 1.
    xh: (B,T,H,P); b_in/c_out: (B,T,N); dt: (B,T,H); a: (H,).
    """
    B, T, H, P = xh.shape
    N = b_in.shape[-1]
    L = chunk
    nc = T // L
    la = dt * a                                        # (B,T,H) log-decay <= 0

    xc_ = xh.reshape(B, nc, L, H, P).movedim(1, 0).transpose(2, 3)
    dtc = dt.reshape(B, nc, L, H).movedim(1, 0).transpose(-1, -2)
    lac = la.reshape(B, nc, L, H).movedim(1, 0).transpose(-1, -2)
    bc_ = b_in.reshape(B, nc, L, N).movedim(1, 0)      # (nc,B,L,N)
    cc_ = c_out.reshape(B, nc, L, N).movedim(1, 0)
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=xh.device))

    S0 = state["S"]
    ys = []
    for c in range(nc):
        xb, dtb, lab, bb, cb = xc_[c], dtc[c], lac[c], bc_[c], cc_[c]
        cum = _cumsum(lab)                # (B,H,L)
        # intra: w[t,s] = exp(cum_t - cum_s) * dt_s   for s <= t
        w = torch.exp(_causal(mask, cum[..., :, None] - cum[..., None, :])) \
            * dtb[..., None, :]
        bcs = cb @ bb.transpose(-1, -2)                # (B,L,L)
        y = (w * bcs[:, None]) @ xb
        y = y + torch.exp(cum)[..., None] * (cb[:, None] @ S0.transpose(-1,
                                                                        -2))
        # carry
        wL = torch.exp(cum[..., -1:] - cum) * dtb      # (B,H,L)
        S0 = torch.exp(cum[..., -1])[..., None, None] * S0 + \
            (wL[..., None] * xb).transpose(-1, -2) @ bb[:, None]
        ys.append(y)
    y = torch.stack(ys).movedim(0, 1).transpose(2, 3).reshape(B, T, H, P)
    return y, S0


def _mamba_heads(xh, b_in, c_out, dt, a, S0):
    """The selective SSM over (B, T, H, P) heads (chunkwise or a step
    loop, by T): (y (B, T, H, P) f32, S')."""
    T = xh.shape[1]
    chunk = _pick_chunk(T, MAMBA_CHUNK)
    if chunk and T >= 2 * chunk:
        return _mamba_chunkwise(xh, b_in, c_out, dt, a, {"S": S0}, chunk)
    S = S0
    ys = []
    for t in range(T):
        xt, bt, ct, dtt = xh[:, t], b_in[:, t], c_out[:, t], dt[:, t]
        dA = torch.exp(dtt * a)                                  # (B,H)
        dBx = dtt[..., None, None] * (xt[..., :, None]
                                      * bt[:, None, None, :])
        S = dA[..., None, None] * S + dBx                        # (B,H,P,N)
        ys.append(_bmm_last(S, ct[:, None]))
    return torch.stack(ys, dim=1), S                             # (B,T,H,P)


def mamba_scan(cfg, p, x, state):
    B, T, D = x.shape
    H = cfg.ssm_heads or cfg.n_heads
    P = D // H
    xs, z = (x @ p["w_in"]).chunk(2, dim=-1)
    xc, conv_state = _causal_conv(xs, p["conv"], state["conv"])
    xc = _silu_as(xc, x.dtype)
    b_in, c_out = (xc @ p["w_bc"]).float().chunk(2, dim=-1)     # (B,T,N)
    dt = _softplus(xc.float() @ p["w_dt"] + p["dt_bias"])        # (B,T,H)
    a = -torch.exp(p["A_log"])                                   # (H,)
    xh = xc.reshape(B, T, H, P).float()
    y, S = _mamba_heads(xh, b_in, c_out, dt, a, state["S"])
    y = y + p["D_skip"][:, None] * xh
    y = _rms_head_norm(y).reshape(B, T, D).to(x.dtype)
    y = y * _silu_as(z, x.dtype)
    return y @ p["w_out"], {"S": S, "conv": conv_state}


def mamba_train_par(cfg, p, x, par):
    """Hymba's Mamba branch in training, from the zero state, on one rank
    of a replica split over ``model`` (``Par.gather_leaves`` by
    :func:`cell_gathers`). Where the ``ssm_heads`` divide by tp the rank
    runs its H/tp heads: the input side reads every channel, so ``w_in``
    (its column blocks at tp 2 are the branch and the gate halves),
    ``conv`` and the ``mlp``-split rows of ``w_bc`` and ``w_dt`` are
    gathered whole (their gradients summed over ``model``, the input's
    too) and the rank takes its heads' columns; ``dt_bias``, ``A_log``
    and ``D_skip`` are split over the heads (in place); ``w_out``'s row
    block is the rank's heads' channels (row-parallel, summed over
    ``model``). Otherwise (hymba-1.5b's 25 heads) every leaf was gathered
    and the branch runs whole on each rank."""
    B, T, D = x.shape
    H = cfg.ssm_heads or cfg.n_heads
    if not par.splits(H):
        return mamba_scan(cfg, p, x, init_mamba_state(
            cfg, B, x.dtype, x.device))[0]
    P = D // H
    hl = H // par.tp
    h0 = par.tp_index * hl
    cols = slice(h0 * P, (h0 + hl) * P)
    xin = par.copy_to_model(x)
    xs, z = (xin @ p["w_in"]).chunk(2, dim=-1)
    xc, _ = _causal_conv(xs, p["conv"])
    xc = _silu_as(xc, x.dtype)
    b_in, c_out = (xc @ p["w_bc"]).float().chunk(2, dim=-1)     # (B,T,N)
    dt = _softplus(xc.float() @ p["w_dt"][:, h0:h0 + hl] + p["dt_bias"])
    a = -torch.exp(p["A_log"])                                   # (hl,)
    xh = xc[..., cols].reshape(B, T, hl, P).float()
    S0 = torch.zeros((B, hl, P, cfg.ssm_state), dtype=torch.float32,
                     device=x.device)
    y, _ = _mamba_heads(xh, b_in, c_out, dt, a, S0)
    y = y + p["D_skip"][:, None] * xh
    y = _rms_head_norm(y).reshape(B, T, hl * P).to(x.dtype)
    y = y * _silu_as(z[..., cols], x.dtype)
    return par.reduce_from_model(y @ p["w_out"])


def cell_gathers(cfg, kind: str, par) -> dict:
    """The recurrent leaves a layer of ``kind`` all-gathers over
    ``model`` before it runs (``Par.gather_leaves``: sub-tree -> {leaf:
    partial}), for :func:`mlstm_train_par`, :func:`slstm_train_par` and
    :func:`mamba_train_par`. A leaf no rule splits over ``model`` is
    passed over."""
    if kind == "mlstm":
        if par.splits(cfg.n_heads):
            return {"cell": dict.fromkeys(
                ("w_up", "conv", "w_q", "w_k", "w_v", "w_if"), True)}
        return {"cell": dict.fromkeys(MLSTM_DIMS, False)}
    if kind == "slstm":
        return {"cell": {"w_in": par.splits(cfg.n_heads)}}
    if kind == "hybrid":
        if par.splits(cfg.ssm_heads or cfg.n_heads):
            return {"mamba": dict.fromkeys(("w_in", "conv", "w_bc",
                                            "w_dt"), True)}
        return {"mamba": dict.fromkeys(MAMBA_DIMS, False)}
    return {}
