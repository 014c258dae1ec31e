"""Precision helpers for the compressed WA state.

Counterpart of ``repro.common.quant``. The slide-window ring (I, P) is
the largest part of the WA state; it can be stored in bf16, or in
fp8-e4m3 with one f32 scale per :data:`SCALE_BLOCK` elements, while the
running total stays f32 with compensated (Kahan) summation. This module
holds:

- the precision tokens (``f32`` / ``bf16`` / ``fp8``) and their storage
  dtypes;
- the block-scaled fp8 codec;
- :func:`kahan_add`, the compensated add of the f32 total;
- the ULP measures that the parity checks and the bf16/fp8 budgets are
  stated in.

Casts to bf16 and ``float8_e4m3fn`` round to nearest even, as the
reference's ``astype`` does, bit for bit. One difference from the
reference's eager form is deliberate: :func:`block_scales` multiplies by
f32(1/448) where the reference divides by 448. Under ``jax.jit`` (how
the reference's sync always runs) XLA rewrites that division into this
product, and the two differ by 1 ULP for some blocks; the port matches
what the jitted reference computes. The reference's checkpoint migration
runs eagerly and divides, so there the port divides too (``divide``).
"""
from __future__ import annotations

import torch

from repro_torch.common.packing import ALIGN

#: elements covered by one fp8 scale: one packed ALIGN block
SCALE_BLOCK = ALIGN

#: elements a plain compressed-ring update encodes at a time: whole
#: scale blocks, so chunking leaves the bits as they are
SLOT_CHUNK = 512 * SCALE_BLOCK

#: largest finite float8_e4m3fn value (e4m3fn has no inf)
FP8_MAX = 448.0

#: precision token -> storage dtype
WA_DTYPES = {
    "f32": torch.float32,
    "bf16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
}


def wa_dtype(token) -> torch.dtype:
    """The storage dtype of a precision token. A torch dtype passes
    through; a dtype name (``"bfloat16"``, as ``PackSpec.ring_dtype``
    holds it) is looked up on ``torch``."""
    if isinstance(token, torch.dtype):
        return token
    if token in WA_DTYPES:
        return WA_DTYPES[token]
    dt = getattr(torch, str(token), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a WA precision token or dtype: {token!r}")
    return dt


def wa_token(dtype) -> str:
    """The precision token of a storage dtype (tokens pass through)."""
    dt = wa_dtype(dtype)
    for tok, d in WA_DTYPES.items():
        if d == dt:
            return tok
    raise ValueError(f"no WA precision token for dtype {dt} (expected one "
                     f"of {sorted(WA_DTYPES)})")


def is_compressed(token) -> bool:
    return wa_token(token) != "f32"


def needs_scales(token) -> bool:
    """fp8 needs per-block scales; f32 and bf16 share f32's exponents."""
    return wa_token(token) == "fp8"


# ------------------------------------------------ block-scaled fp8 codec


def _blocks(x: torch.Tensor, block: int) -> torch.Tensor:
    return x.reshape(tuple(x.shape[:-1]) + (-1, block))


def block_scales(x: torch.Tensor, block: int = SCALE_BLOCK, *,
                 divide: bool = False) -> torch.Tensor:
    """Per-block f32 scales of ``x`` (..., P): amax·f32(1/448), as the
    jitted reference computes them, or amax/448 with ``divide`` (the
    reference run eagerly, as its checkpoint migration is); 1.0 for an
    all-zero block (so that zero decodes to zero)."""
    amax = _blocks(x, block).abs().amax(-1)
    if divide:
        scaled = amax / FP8_MAX
    else:
        scaled = amax * torch.tensor(1.0 / FP8_MAX, dtype=torch.float32,
                                     device=x.device)
    return torch.where(amax > 0, scaled,
                       torch.ones_like(amax)).to(torch.float32)


def quantize_fp8(x: torch.Tensor, scales: torch.Tensor,
                 block: int = SCALE_BLOCK) -> torch.Tensor:
    """f32 ``x`` (..., P) to fp8-e4m3 with per-block ``scales``
    (..., P/block). Values are clipped to ±FP8_MAX·scale first: e4m3fn
    has no inf, and an unclipped overflow would become NaN."""
    bx = _blocks(x, block) / scales[..., None].to(x.dtype)
    bx = torch.clamp(bx, -FP8_MAX, FP8_MAX)
    return bx.to(torch.float8_e4m3fn).reshape(x.shape)


def dequantize_fp8(q: torch.Tensor, scales: torch.Tensor,
                   block: int = SCALE_BLOCK) -> torch.Tensor:
    """fp8 payload times its per-block scale, in f32."""
    bq = _blocks(q.to(torch.float32), block)
    return (bq * scales[..., None]).reshape(q.shape)


def encode_slot(x: torch.Tensor, token, block: int = SCALE_BLOCK, *,
                divide: bool = False):
    """(slot, scales) of an f32 packed buffer in a ring of ``token``'s
    dtype: itself for f32, a cast for bf16, block-scaled fp8 (scales not
    None, ``divide`` as in :func:`block_scales`) for fp8."""
    tok = wa_token(token)
    if tok == "f32":
        return x.to(torch.float32), None
    if tok == "bf16":
        return x.to(torch.bfloat16), None
    s = block_scales(x, block, divide=divide)
    return quantize_fp8(x, s, block), s


def decode_slot(slot: torch.Tensor, scales=None,
                block: int = SCALE_BLOCK) -> torch.Tensor:
    """The f32 value of a ring slot: cast back, or fp8 times scales."""
    if scales is None:
        return slot.to(torch.float32)
    return dequantize_fp8(slot, scales, block)


def _two_sum(a, b):
    """Knuth's TwoSum: ``s = RN(a + b)`` and its exact error ``e``."""
    s = a + b
    z = s - a
    return s, (a - (s - z)) + (b - z)


def _split(x):
    """Veltkamp's split of an f32 into two halves of at most 12
    significant bits each (x = hi + lo exactly)."""
    t = x * 4097.0
    hi = t - (t - x)
    return hi, x - hi


def fma_f32(a, b, c):
    """``a·b + c`` for f32 tensors, rounded ONCE as a fused multiply-add,
    in f32 arithmetic only (Boldo and Melquiond's emulation with
    rounding to odd): Dekker's product gives a·b exactly as ph + pl; a
    TwoSum gives c + ph exactly as th + tl; tl + pl is rounded to odd (a
    TwoSum error moves an inexact, even result one step toward the exact
    value), and th plus it then rounds to nearest even correctly. Exact
    while no product or partial underflows, as the sync's operands (fp8
    payloads times block scales) never do."""
    ph = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = ((ah * bh - ph) + ah * bl + al * bh) + al * bl
    th, tl = _two_sum(c, ph)
    v, e = _two_sum(tl, pl)
    toward = torch.where(e > 0, torch.full_like(v, float("inf")),
                         torch.full_like(v, float("-inf")))
    even = (v.view(torch.int32) & 1) == 0
    v = torch.where((e != 0) & even, torch.nextafter(v, toward), v)
    # a zero v keeps th's sign (-0 + -0·x is -0)
    return torch.where(v == 0, th, th + v)


def kahan_add(total, comp, delta):
    """One compensated (Kahan) step: ``(total', comp')`` with ``total' +
    comp'`` carrying ``total + delta`` to about twice f32 precision. With
    ``comp == 0`` the total is bit-identical to ``total + delta``."""
    y = delta - comp
    t = total + y
    return t, (t - total) - y


# ------------------------------------------------------------ ULP ladder

_BITS = {torch.float32: (torch.int32, 32), torch.bfloat16: (torch.int16, 16),
         torch.float8_e4m3fn: (torch.uint8, 8)}


def _ulp_key(x: torch.Tensor) -> torch.Tensor:
    """Monotone int64 key of a float tensor: neighbouring representable
    values of its dtype differ by exactly 1, across the sign too (+0 and
    -0 share a key)."""
    view, bits = _BITS[x.dtype]
    u = x.view(view).to(torch.int64) & ((1 << bits) - 1)
    sign_bit = 1 << (bits - 1)
    mag = u & (sign_bit - 1)
    return torch.where(u >= sign_bit, sign_bit - mag, sign_bit + mag)


def ulp_distance(a, b, dtype=None) -> torch.Tensor:
    """Elementwise distance between ``a`` and ``b`` in steps of
    ``dtype``'s ladder of representable values, after rounding both into
    it. ``dtype=None`` takes the narrower operand's dtype. NaNs land far
    from everything, which a budget reads as a failure."""
    if dtype is None:
        dtype = a.dtype if torch.finfo(a.dtype).bits <= \
            torch.finfo(b.dtype).bits else b.dtype
    dtype = wa_dtype(dtype)
    return (_ulp_key(a.to(dtype)) - _ulp_key(b.to(dtype))).abs()


def max_ulp(a, b, dtype=None) -> int:
    """The largest :func:`ulp_distance` as an int (0 for empty)."""
    d = ulp_distance(a, b, dtype)
    return int(d.max()) if d.numel() else 0


def rel_ulp_error(ref, got, dtype, floor=None) -> float:
    """Worst error in ``dtype`` ULPs at the reference's working scale:
    ``max |got - ref| / (eps(dtype) · max(|ref|, floor))``, ``floor``
    defaulting to the RMS of ``ref``. This is the unit of the bf16 and
    fp8 budgets: a window average can land near zero, where the ladder
    is dense, while its error is set by the magnitudes that were
    averaged, and the floor pins the scale to the data."""
    ref = ref.to(torch.float32)
    got = got.to(torch.float32)
    if ref.numel() == 0:
        return 0.0
    if floor is None:
        floor = torch.sqrt(torch.mean(torch.square(ref)))
    floor = torch.clamp(torch.as_tensor(floor, dtype=torch.float32,
                                        device=ref.device),
                        min=torch.finfo(torch.float32).tiny)
    eps = torch.finfo(wa_dtype(dtype)).eps
    scale = torch.maximum(ref.abs(), floor)
    return float(((got - ref).abs() / (eps * scale)).max())
