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


def normal_init(generator: torch.Generator, shape, dtype, fan_in=None,
                device=None):
    """Normal init scaled by 1/sqrt(fan_in), drawn in f32 then cast."""
    fan_in = fan_in if fan_in is not None else \
        shape[-2] if len(shape) >= 2 else shape[-1]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=device)
    return (x * scale).to(dtype)


# ---------------------------------------------------------------- norms


def init_norm(cfg, d=None, device=None):
    d = d or cfg.d_model
    params = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        params["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return params


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
