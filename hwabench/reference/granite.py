"""Plain reference of the granite decoder (dense and MoE), in float32.

The model the configurations ``configs/granite-*.json`` describe, written
from their sizes alone: token embedding, then per layer RMSNorm (eps
1e-6, f32 scale), grouped-query attention with rotary positions (theta
``rope_theta``, the two halves of a head rotated, scores scaled by
1/sqrt(head_dim), causal), a residual add, RMSNorm and the SwiGLU MLP, or
for a MoE layer the f32 router (softmax, the top k renormalized, the
Switch load-balance loss E * sum_e f_e * P_e) over SwiGLU experts, a
residual add; then the final RMSNorm and an untied head, and the mean
token cross-entropy plus ``router_aux_coef`` times the router losses
summed over the layers. It imports no module of the program.

Every product runs in f32 with TF32 off. ``quant`` (the control) rounds
both operands of every product to float8 e4m3 with a per-tensor scale,
the precision below the bf16 the configurations state; gradients pass
the rounding straight through.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

RMS_EPS = 1e-6
F8_MAX = 448.0


def no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def sizes(cfg: dict) -> dict:
    """The model's sizes under short names, from a configuration file."""
    D = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    return dict(L=cfg["num_hidden_layers"], D=D, H=H,
                Kv=cfg["num_key_value_heads"], P=cfg.get("head_dim") or D // H,
                F=cfg["intermediate_size"], V=cfg["vocab_size"],
                E=cfg.get("num_local_experts", 0),
                k=cfg.get("num_experts_per_tok", 0),
                theta=float(cfg["rope_theta"]),
                aux=float(cfg.get("router_aux_loss_coef", 0.0)))


def param_shapes(cfg: dict) -> dict:
    """path -> (shape, kind, fan_in) of every weight: kind "w" in the
    model dtype, "w32" f32, "one" f32 ones. The tree the program takes:
    ``embed`` (V, D), ``head`` (D, V), ``ln_f``, and one stacked layer
    tree under ``stack`` whose leaves lead with the layer axis."""
    s = sizes(cfg)
    L, D, H, Kv, P, Fd, V, E = (s[n] for n in "L D H Kv P F V E".split())
    layer = {
        "ln1": {"scale": ((L, D), "one", 1)},
        "ln2": {"scale": ((L, D), "one", 1)},
        "attn": {"wq": ((L, D, H, P), "w", D), "wk": ((L, D, Kv, P), "w", D),
                 "wv": ((L, D, Kv, P), "w", D),
                 "wo": ((L, H, P, D), "w", H * P)},
    }
    if E:
        layer["moe"] = {"router": ((L, D, E), "w32", D),
                        "w_gate": ((L, E, D, Fd), "w", D),
                        "w_up": ((L, E, D, Fd), "w", D),
                        "w_down": ((L, E, Fd, D), "w", Fd)}
    else:
        layer["mlp"] = {"w_gate": ((L, D, Fd), "w", D),
                        "w_up": ((L, D, Fd), "w", D),
                        "w_down": ((L, Fd, D), "w", Fd)}
    return {"embed": ((V, D), "w", D), "head": ((D, V), "w", D),
            "ln_f": {"scale": ((D,), "one", 1)}, "stack": [layer]}


class _F8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / F8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _mm(a, b, quant):
    if quant:
        a, b = _F8.apply(a), _F8.apply(b)
    return a @ b


def _rms(x, scale):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + RMS_EPS) \
        * scale


def _rope(x, theta):
    """x (B, S, H, P): the halves rotated by position * theta^(-i/half)."""
    S, P = x.shape[1], x.shape[-1]
    half = P // 2
    freqs = 1.0 / torch.pow(theta, torch.arange(half, dtype=torch.float32,
                                                 device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _attention(s, p, h, quant):
    B, S, D = h.shape
    H, Kv, P = s["H"], s["Kv"], s["P"]
    q = _rope(_mm(h, p["wq"].reshape(D, H * P), quant).view(B, S, H, P),
              s["theta"])
    k = _rope(_mm(h, p["wk"].reshape(D, Kv * P), quant).view(B, S, Kv, P),
              s["theta"])
    v = _mm(h, p["wv"].reshape(D, Kv * P), quant).view(B, S, Kv, P)
    G = H // Kv
    q = q.view(B, S, Kv, G, P).permute(0, 2, 3, 1, 4)     # B Kv G S P
    k = k.permute(0, 2, 1, 3)[:, :, None]                 # B Kv 1 S P
    v = v.permute(0, 2, 1, 3)[:, :, None]
    scores = _mm(q, k.transpose(-1, -2), quant) / math.sqrt(P)
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = _mm(torch.softmax(scores, -1), v, quant)        # B Kv G S P
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * P)
    return _mm(out, p["wo"].reshape(H * P, D), quant)


def _mlp(p, h, quant):
    return _mm(F.silu(_mm(h, p["w_gate"], quant)) * _mm(h, p["w_up"], quant),
               p["w_down"], quant)


def _moe(s, p, h, quant):
    """The routed experts and the layer's load-balance loss."""
    B, S, D = h.shape
    E, k = s["E"], s["k"]
    x = h.reshape(B * S, D)
    N = x.shape[0]
    probs = torch.softmax(_mm(x, p["router"], quant), -1)
    top_p, top_i = torch.topk(probs, k, -1)
    top_p = top_p / top_p.sum(-1, keepdim=True)
    counts = torch.bincount(top_i.reshape(-1), minlength=E).float()
    aux = E * torch.sum(counts / (N * k) * probs.mean(0))
    rows_all, slots_all, outs = [], [], []
    for e in range(E):
        rows, slot = torch.nonzero(top_i == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        xe = x[rows]
        y = _mm(F.silu(_mm(xe, p["w_gate"][e], quant))
                * _mm(xe, p["w_up"][e], quant), p["w_down"][e], quant)
        rows_all.append(rows)
        slots_all.append(slot)
        outs.append(y * top_p[rows, slot, None])
    # each (token, slot) pair is written once: no accumulation order
    pairs = x.new_zeros(N, k, D).index_put(
        (torch.cat(rows_all), torch.cat(slots_all)), torch.cat(outs))
    return pairs.sum(1).view(B, S, D), aux


def _layer(s, p, x, quant):
    x = x + _attention(s, p["attn"], _rms(x, p["ln1"]["scale"]), quant)
    h = _rms(x, p["ln2"]["scale"])
    if "moe" in p:
        y, aux = _moe(s, p["moe"], h, quant)
    else:
        y, aux = _mlp(p["mlp"], h, quant), x.new_zeros(())
    return x + y, aux


def _layer_params(stack, n):
    def pick(t):
        if isinstance(t, dict):
            return {k: pick(v) for k, v in t.items()}
        return t[n]
    return pick(stack[0])


def hidden(cfg: dict, params, tokens, quant=False, remat=False):
    """The final normed hidden states (B, S, D) and the summed router
    losses. ``params`` f32; ``tokens`` (B, S) int64."""
    s = sizes(cfg)
    x = F.embedding(tokens, params["embed"])
    aux = x.new_zeros(())
    for n in range(s["L"]):
        lp = _layer_params(params["stack"], n)
        if remat and torch.is_grad_enabled():
            x, a = checkpoint(_layer, s, lp, x, quant, use_reentrant=False)
        else:
            x, a = _layer(s, lp, x, quant)
        aux = aux + a
    return _rms(x, params["ln_f"]["scale"]), aux


def loss(cfg: dict, params, tokens, targets, quant=False, remat=True):
    """Mean token cross-entropy + router_aux_loss_coef * router losses.
    The head and the cross-entropy run over blocks of 512 positions,
    each recomputed in the backward, so the f32 logits of a block are
    the only ones held."""
    s = sizes(cfg)
    x, aux = hidden(cfg, params, tokens, quant, remat)
    B, S, _ = x.shape

    def block(xb, tb, head):
        logits = _mm(xb, head, quant)
        return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                               tb.reshape(-1), reduction="sum")

    total = x.new_zeros(())
    for c in range(0, S, 512):
        xb, tb = x[:, c:c + 512], targets[:, c:c + 512]
        if torch.is_grad_enabled():
            total = total + checkpoint(block, xb, tb, params["head"],
                                       use_reentrant=False)
        else:
            total = total + block(xb, tb, params["head"])
    return total / (B * S) + s["aux"] * aux

