"""Shared building blocks: initializers, norms, RoPE, activations.

Counterpart of ``repro.models.common``. Initializers draw from an
explicit ``torch.Generator`` on the target device; the numbers differ
from JAX's threefry streams, so parity tests bridge the JAX parameters
instead of re-drawing them.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


#: the most elements one f32 draw of :func:`normal_init` holds (256 MiB)
DRAW_ELEMS = 1 << 26


def _draw_pieces(out):
    """The views of ``out`` that :func:`normal_init` draws one at a time,
    in memory order: a leaf of three or more axes (a stack of layers) one
    slice of its leading axis at a time, and any slice or 2-D leaf of more
    than DRAW_ELEMS elements in blocks of 16·k rows."""
    for s in (out.unbind(0) if out.dim() >= 3 else (out,)):
        if s.dim() < 2 or s.numel() <= DRAW_ELEMS:
            yield s
            continue
        yield from s.split(max(16, DRAW_ELEMS // s[0].numel() // 16 * 16))


def normal_init(generator: torch.Generator, shape, dtype, fan_in=None,
                device=None):
    """Normal init scaled by 1/sqrt(fan_in), drawn in f32 then cast.

    The result is allocated in ``dtype`` and filled piece by piece
    (:func:`_draw_pieces`), so the f32 transient is one piece, never the
    whole leaf: command-r-35b's stacked w_gate is 7.4B elements. On the
    CPU torch fills normals 16 at a time from one uniform stream, so where
    every piece but the last holds a multiple of 16 elements the bits
    equal those of one draw of the whole leaf; on the card each piece is
    a Philox draw of its own."""
    shape = tuple(shape)
    fan_in = fan_in if fan_in is not None else \
        shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    out = torch.empty(shape, dtype=dtype, device=device)
    for piece in _draw_pieces(out):
        x = torch.randn(piece.shape, generator=generator,
                        dtype=torch.float32, device=device)
        piece.copy_(x.mul_(scale))
    return out


# ---------------------------------------------------------------- norms


def init_norm(cfg, d=None, device=None):
    d = d or cfg.d_model
    params = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        params["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return params


def norm_dims(cfg) -> dict:
    """Logical dims of a norm's leaves (``sharding.rules``)."""
    d = {"scale": ("embed",)}
    if cfg.norm == "layernorm":
        d["bias"] = ("embed",)
    return d


def apply_norm(cfg, p, x, eps: float = 1e-6):
    """RMS or layer norm computed in f32, returned in ``x``'s dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    else:  # rmsnorm
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------- rope


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    exponent = torch.arange(half, dtype=torch.float32, device=device) / half
    # a Python-number base: a device tensor made from ``theta`` here would
    # be a host-to-device copy, which synchronizes the stream every call
    return 1.0 / torch.pow(float(theta), exponent)


def apply_rope(x, positions, theta: float):
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)      # (half,)
    angles = positions[..., None].float() * freqs                # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]                        # (..., seq, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- act


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def softcap(x, cap: float):
    if not cap:
        return x
    return cap * torch.tanh(x / cap)
