"""Offline WA module (paper §III-B, Algorithm 2): slide-window averaging.

    W̿_e = (1/I) Σ_{t=e-I+1..e} W̄_t

Counterpart of ``repro.core.offline``, f32 ring windows only: a ring of
the last I outer weights and their running f32 sum, both held
PERSISTENTLY PACKED (``common.packing``): ``ring`` is one (I, P) buffer
and ``total`` one (P,) buffer over the whole parameter set, so an update
is O(1) kernel launches however many leaves the tree has. The update
writes ``ring`` and ``total`` in place, where the reference donates
them. ``count`` and ``next_idx`` are 0-dim int32 tensors on the
parameters' device: no update reads them back to the host.

Not ported yet: the streaming window and the compressed (bf16/fp8)
rings raise (ROADMAP.md Queue A 10); :func:`window_update_packed` has no
kernel route until ``wa_window_update_2d`` is ported (Queue B 2).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.packing import PackSpec, pack_spec
from repro_torch.common.pytree import tree_leaves
from repro_torch.kernels.ref import wa_window_update_ref

#: ROADMAP items of what this module leaves to raise
COMPRESSED_ITEM = "ROADMAP.md Queue A 10 (compressed WindowState)"
STREAMING_ITEM = "ROADMAP.md Queue A 3 (streaming and sparse windows)"


@dataclasses.dataclass
class WindowState:
    ring: torch.Tensor        # (I, P) f32 packed outer weights
    total: torch.Tensor       # (P,) f32 running sum of the ring
    count: torch.Tensor       # 0-dim int32: filled slots (<= I)
    next_idx: torch.Tensor    # 0-dim int32: ring write cursor
    window: int
    kind: str = "ring"
    spec: PackSpec | None = None


def window_init(params_like, window: int, kind: str = "ring",
                ring_dtype=torch.float32) -> WindowState:
    """Pack the layout once; every later update runs on the packed
    buffers in place. Only the f32 ring is ported."""
    if kind != "ring":
        raise NotImplementedError(f"window kind {kind!r} is not ported yet: "
                                  f"{STREAMING_ITEM}")
    if ring_dtype != torch.float32:
        raise NotImplementedError(f"ring dtype {ring_dtype} is not ported "
                                  f"yet: {COMPRESSED_ITEM}")
    spec = pack_spec(params_like)
    dev = tree_leaves(params_like)[0].device
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return WindowState(
        ring=torch.zeros((window, spec.padded), dtype=torch.float32,
                         device=dev),
        total=torch.zeros((spec.padded,), dtype=torch.float32, device=dev),
        count=zero, next_idx=zero.clone(), window=window, kind=kind,
        spec=spec)


def window_scalars(state: WindowState):
    """(full_flag, new_count, inv_count) of the next push, on the device."""
    I = state.window
    full_flag = (state.count >= I).to(torch.float32)
    new_count = torch.clamp(state.count + 1, max=I).to(torch.int32)
    inv_count = 1.0 / new_count.to(torch.float32)
    return full_flag, new_count, inv_count


def window_update_packed(state: WindowState, new: torch.Tensor
                         ) -> tuple[WindowState, torch.Tensor]:
    """Packed-in/packed-out window update: ``new`` is a (P,) f32 buffer;
    returns (new state, packed W̿). ``state.ring`` and ``state.total`` are
    updated in place. Plain route only: the kernel route of the sync is
    the fused launch (``core.hwa._sync_fused``)."""
    full_flag, new_count, inv_count = window_scalars(state)
    idx = state.next_idx
    ring, total, avg = wa_window_update_ref(state.ring, state.total, new, idx,
                                            full_flag, inv_count)
    return WindowState(ring=ring, total=total, count=new_count,
                       next_idx=torch.remainder(idx + 1, state.window)
                       .to(torch.int32),
                       window=state.window, kind=state.kind,
                       spec=state.spec), avg


def window_average_packed(state: WindowState) -> torch.Tensor:
    """Current W̿ as the packed (P,) f32 buffer."""
    denom = torch.clamp(state.count, min=1).to(torch.float32)
    return state.total / denom
