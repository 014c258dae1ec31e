"""JAX parameter trees and HWA states, as numpy arrays, to the port's
tensors and back.

The port keeps the JAX package's parameter layout (nested dicts and
lists, stacked layers, the same leaf names), so a bridge is a leaf-for-
leaf copy. bf16 crosses as a 16-bit integer view, so the bits are exact;
bf16 is recognised by itemsize and dtype name, without importing the
package that defines the numpy bf16 type.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _is_bf16(arr: np.ndarray) -> bool:
    return arr.dtype.itemsize == 2 and arr.dtype.name == "bfloat16"


def _leaf_to_torch(arr, device) -> torch.Tensor:
    arr = np.array(arr, copy=True)        # writable and contiguous
    if _is_bf16(arr):
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
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
    their bits, or as ``uint16`` bits when it is None."""

    def leaf(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return bits if bf16_dtype is None else bits.view(bf16_dtype)
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
    inner parameters and optimizer state, the f32 window ring, total,
    count and cursor, W̿ and the counters. Read by attribute, so nothing
    of the JAX package is imported."""
    from repro_torch.common.packing import pack_spec
    from repro_torch.core.hwa import HWAState
    from repro_torch.core.offline import WindowState

    ws = state.window_state
    if ws.kind != "ring" or getattr(ws, "comp", None) is not None:
        raise NotImplementedError("only the f32 ring window is ported")
    wa = params_from_numpy(state.wa, device)
    window_state = WindowState(
        ring=params_from_numpy(ws.ring, device),
        total=params_from_numpy(ws.total, device),
        count=params_from_numpy(ws.count, device).to(torch.int32),
        next_idx=params_from_numpy(ws.next_idx, device).to(torch.int32),
        window=int(ws.window), kind=ws.kind, spec=pack_spec(wa))
    return HWAState(inner=params_from_numpy(state.inner, device),
                    inner_opt=params_from_numpy(state.inner_opt, device),
                    window_state=window_state, wa=wa,
                    cycle=params_from_numpy(state.cycle, device)
                    .to(torch.int32),
                    step=params_from_numpy(state.step, device)
                    .to(torch.int32))
