"""Helpers the per-layer readers share: the device time and the launch
count of the kernels whose name holds a given part, in the trace."""
from __future__ import annotations


def kernel_time(ctx: dict, part: str) -> tuple[int, float]:
    """(launches, device seconds) of the traced kernels named ``part``."""
    n, ns = 0, 0
    for name, _, dur in ctx["trace"]["kernels"]:
        if part in name:
            n += 1
            ns += dur
    return n, ns / 1e9
