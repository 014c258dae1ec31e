"""The benchmark's fixed arithmetic: the card's published peaks, the
parameters a token's products touch, and the operations and bytes each
of the port's kernels needs for one call at its shapes.

Frozen copies, so that a later change of the program cannot move the
yardstick. Each names its source in ``chip_smoke.py`` at commit 8e2c8df;
the copies take a configuration's sizes (``reference.granite.sizes``)
where the source took the program's ``ModelConfig``, and keep the dense
and MoE branches only.
"""
from __future__ import annotations

#: NVIDIA H100 SXM, dense, from its data sheet (chip_smoke.py PEAK_FLOPS
#: and PEAK_BYTES, 8e2c8df): bf16 tensor-core FLOP/s, HBM3 bytes/s
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_F32 = 67e12
PEAK_BYTES = 3.35e12


def ffn_param_count(s: dict, active: bool) -> int:
    """One layer's feed-forward parameters (chip_smoke.py
    ``_ffn_param_count``, 8e2c8df): the MLP's, or the MoE layer's router
    and experts (``active``: the top-k a token's products touch)."""
    D = s["D"]
    if not s["E"]:
        return 3 * D * s["F"]
    experts = s["k"] if active else s["E"]
    return D * s["E"] + experts * 3 * D * s["F"]


def train_matmul_param_count(s: dict) -> int:
    """The N of 6 * N * tokens (chip_smoke.py ``train_matmul_param_count``,
    8e2c8df): every parameter a token's products touch, so not the
    embedding table (a gather) nor the norm scales, and of a MoE layer
    the router and the top-k experts only."""
    D, H, Kv, P = s["D"], s["H"], s["Kv"], s["P"]
    per_layer = 2 * D * H * P + 2 * D * Kv * P + ffn_param_count(s, True)
    return s["V"] * D + s["L"] * per_layer


def least_seconds(flops: float, nbytes: float, peak_flops=PEAK_FLOPS_BF16):
    """The least time a call can take (chip_smoke.py ``_bound``,
    8e2c8df): the larger of its operations over the peak rate and its
    bytes over the peak bandwidth."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES)


def flash_fwd_cost(B, S, Hq, Hkv, D, elem=2):
    """One causal flash forward (chip_smoke.py ``phase_yardstick_train``,
    8e2c8df): two products over the S(S+1)/2 live (row, key) pairs; q, k,
    v read once, the output written once, the f32 row statistics
    written."""
    pairs = S * (S + 1) // 2
    prod = 2 * B * Hq * D * pairs
    q_bytes, kv_bytes = elem * B * S * Hq * D, elem * B * S * Hkv * D
    return 2 * prod, 2 * q_bytes + 2 * kv_bytes + 4 * B * Hq * S


def flash_bwd_cost(B, S, Hq, Hkv, D, elem=2):
    """The two backward sweeps of one causal attention (chip_smoke.py
    ``phase_yardstick_train``, 8e2c8df), as (dq, dk/dv) pairs of
    (FLOPs, bytes): dq recomputes the scores and takes two more
    products; dk/dv recomputes them and takes three more."""
    pairs = S * (S + 1) // 2
    prod = 2 * B * Hq * D * pairs
    q_bytes, kv_bytes = elem * B * S * Hq * D, elem * B * S * Hkv * D
    row = 4 * B * Hq * S
    return ((3 * prod, 3 * q_bytes + 2 * kv_bytes + 2 * row),
            (4 * prod, 2 * q_bytes + 4 * kv_bytes + 2 * row))


def paged_cost(lens, Hq, Hkv, D, TW, elem=2):
    """One paged decode call over sequences holding ``lens`` tokens
    (chip_smoke.py ``phase_yardstick``, 8e2c8df): one query a sequence,
    every held key and value read once, the block tables read."""
    tokens = int(sum(lens))
    B = len(lens)
    return (4 * Hq * D * tokens,
            elem * (2 * B * Hq * D + 2 * tokens * Hkv * D) + 4 * B * (TW + 1))


def wa_sync_cost(K, P):
    """One fused f32 sync over P packed parameters (chip_smoke.py
    ``phase_yardstick_train``, 8e2c8df): the K replicas, the ring slot
    and the total read, the slot, the total and W̿ written; K + 3 flops
    an element."""
    return (K + 3) * P, (K + 5) * 4 * P
