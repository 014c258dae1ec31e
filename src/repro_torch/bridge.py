"""JAX parameter trees and HWA states, as numpy arrays, to the port's
tensors and back.

The port keeps the JAX package's parameter layout (nested dicts and
lists, stacked layers, the same leaf names), so a bridge is a leaf-for-
leaf copy. bf16 and fp8-e4m3 cross as 16- and 8-bit integer views, so
the bits are exact; both are recognised by itemsize and dtype name,
without importing the package that defines the numpy types.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


#: narrow float dtypes numpy lacks: (name, itemsize) -> (bits view, torch)
_VIEWS = {("bfloat16", 2): (np.int16, torch.bfloat16),
          ("float8_e4m3fn", 1): (np.uint8, torch.float8_e4m3fn)}


def _leaf_to_torch(arr, device) -> torch.Tensor:
    arr = np.array(arr, copy=True)        # writable and contiguous
    view = _VIEWS.get((arr.dtype.name, arr.dtype.itemsize))
    if view is not None:
        return torch.from_numpy(arr.view(view[0])).view(view[1]).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device=None):
    """Nested dicts/lists/tuples of numpy arrays -> the same structure of
    tensors on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return _leaf_to_torch(x, dev)

    return walk(tree)


def params_to_numpy(tree, bf16_dtype=None):
    """The reverse of :func:`params_from_numpy`. bf16 leaves come back as
    ``bf16_dtype`` (a numpy bf16 dtype the caller supplies) viewed from
    their bits, or as ``uint16`` bits when it is None; fp8 leaves come
    back as their ``uint8`` bits."""

    def leaf(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return bits if bf16_dtype is None else bits.view(bf16_dtype)
        if t.dtype == torch.float8_e4m3fn:
            return t.view(torch.uint8).numpy()
        return t.numpy()

    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(walk(v) for v in x)
        return leaf(x)

    return walk(tree)


def hwa_state_from_numpy(state, device=None):
    """A JAX ``HWAState`` whose leaves are numpy arrays (``jax.device_get``
    of one) -> the port's ``core.hwa.HWAState`` on ``device``: the stacked
    inner parameters and optimizer state, the window's kind, ring (None
    for the streaming window; f32, bf16 or fp8), total, Kahan comp, fp8
    scales, count and cursor, W̿ and the counters. Read by attribute, so
    nothing of the JAX package is imported."""
    from repro_torch.common.packing import pack_spec
    from repro_torch.core.hwa import HWAState
    from repro_torch.core.offline import WindowState

    def opt(x):
        return None if x is None else params_from_numpy(x, device)

    def int32(x):
        return params_from_numpy(x, device).to(torch.int32)

    ws = state.window_state
    wa = params_from_numpy(state.wa, device)
    ring = opt(ws.ring)
    spec = pack_spec(wa)
    if ring is not None:
        spec = spec.with_ring_dtype(ring.dtype)
    window_state = WindowState(
        ring=ring, total=params_from_numpy(ws.total, device),
        count=int32(ws.count), next_idx=int32(ws.next_idx),
        window=int(ws.window), kind=ws.kind, spec=spec,
        comp=opt(getattr(ws, "comp", None)),
        scales=opt(getattr(ws, "scales", None)))
    return HWAState(inner=params_from_numpy(state.inner, device),
                    inner_opt=params_from_numpy(state.inner_opt, device),
                    window_state=window_state, wa=wa,
                    cycle=int32(state.cycle), step=int32(state.step))
