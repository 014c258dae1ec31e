"""Offline WA module (paper §III-B, Algorithm 2): slide-window averaging.

    W̿_e = (1/I) Σ_{t=e-I+1..e} W̄_t

Counterpart of ``repro.core.offline``, with its two kinds of window:

- **ring** (exact): the last I outer weights and their running f32 sum,
  held PERSISTENTLY PACKED (``common.packing``): ``ring`` is one (I, P)
  buffer and ``total`` one (P,) buffer over the whole parameter set, so
  an update is one kernel launch however many leaves the tree has. The
  ring may be stored compressed (``ring_dtype`` bf16, or fp8 with one
  f32 scale per ALIGN block in ``scales``); the total then accumulates
  the decoded slots with a Kahan compensation ``comp``.
- **streaming** (O(1) memory): the running mean
  ``total += (W̄ - total) / min(count, I)``, no ring.

The sparse stride of §III-B is the caller's: it skips pushes
(``core.hwa.window_push_packed``).

The ring update writes ``ring``, ``total``, ``comp`` and ``scales`` in
place, where the reference donates them; the streaming update makes a
new total, as the reference does. ``count`` and ``next_idx`` are 0-dim
int32 tensors on the parameters' device: no update reads them back to
the host.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.common.packing import PackSpec, pack, pack_spec, unpack
from repro_torch.common.pytree import register_dataclass, tree_leaves
from repro_torch.common.quant import is_compressed, needs_scales, wa_dtype
from repro_torch.kernels import wa_update
from repro_torch.kernels.ref import wa_window_update_c_ref, \
    wa_window_update_ref


@dataclasses.dataclass
class WindowState:
    ring: torch.Tensor | None   # (I, P) packed outer weights (ring kind),
                                # stored in spec.ring_dtype
    total: torch.Tensor         # (P,) f32 running sum (ring) / mean
    count: torch.Tensor         # 0-dim int32: filled slots (<= I)
    next_idx: torch.Tensor      # 0-dim int32: ring write cursor
    window: int
    kind: str = "ring"          # ring | streaming
    spec: PackSpec | None = None
    comp: torch.Tensor | None = None    # (P,) f32 Kahan compensation of
                                        # the total (compressed rings)
    scales: torch.Tensor | None = None  # (I, P // ALIGN) f32 per-block
                                        # fp8 scales (fp8 rings)


register_dataclass(WindowState,
                   data_fields=["ring", "total", "count", "next_idx", "comp",
                                "scales"],
                   meta_fields=["window", "kind", "spec"])


def window_init(params_like, window: int, kind: str = "ring",
                ring_dtype=torch.float32) -> WindowState:
    """Pack the layout once; every later update runs on the packed
    buffers. ``ring_dtype`` (a dtype or a ``f32``/``bf16``/``fp8``
    token) selects the compressed ring: a narrow ring, a Kahan ``comp``
    beside the f32 total and, for fp8, per-block ``scales``. The f32
    default allocates neither."""
    if kind not in ("ring", "streaming"):
        raise ValueError(f"unknown window kind {kind!r}")
    ring_dtype = wa_dtype(ring_dtype)
    spec = pack_spec(params_like)
    dev = tree_leaves(params_like)[0].device
    ring = comp = scales = None
    if kind == "ring":
        ring = torch.zeros((window, spec.padded), dtype=ring_dtype,
                           device=dev)
        if is_compressed(ring_dtype):
            spec = spec.with_ring_dtype(ring_dtype)
            comp = torch.zeros((spec.padded,), dtype=torch.float32,
                               device=dev)
            if needs_scales(ring_dtype):
                scales = torch.ones((window, spec.scale_blocks),
                                    dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    return WindowState(
        ring=ring,
        total=torch.zeros((spec.padded,), dtype=torch.float32, device=dev),
        count=zero, next_idx=zero.clone(), window=window, kind=kind,
        spec=spec, comp=comp, scales=scales)


def window_scalars(state: WindowState):
    """(full_flag, new_count, inv_count) of the next push, on the device."""
    I = state.window
    full_flag = (state.count >= I).to(torch.float32)
    new_count = torch.clamp(state.count + 1, max=I).to(torch.int32)
    inv_count = 1.0 / new_count.to(torch.float32)
    return full_flag, new_count, inv_count


def window_update(state: WindowState, outer, *, use_kernel: bool = False):
    """Push W̄_e (a tree) into either kind of window; return (new state,
    W̿_e as a tree in W̄'s dtypes). The ring is never unpacked."""
    new_state, avg = window_update_packed(state, pack(outer, state.spec),
                                          use_kernel=use_kernel)
    return new_state, unpack(avg, state.spec, like=outer)


def window_update_packed(state: WindowState, new: torch.Tensor, *,
                         use_kernel: bool = False
                         ) -> tuple[WindowState, torch.Tensor]:
    """Packed-in/packed-out window update: ``new`` is a (P,) f32 buffer;
    returns (new state, packed W̿). With ``use_kernel`` an f32 or bf16
    ring takes its kernel (``kernels.wa_update``); an fp8 ring and the
    streaming window take the plain update on either setting, as in the
    reference."""
    if state.kind == "streaming":
        count = torch.clamp(state.count + 1, max=state.window) \
            .to(torch.int32)
        total = state.total + (new - state.total) / count.to(torch.float32)
        return WindowState(ring=None, total=total, count=count,
                           next_idx=state.next_idx, window=state.window,
                           kind="streaming", spec=state.spec), total
    I = state.window
    idx = state.next_idx
    full_flag, new_count, inv_count = window_scalars(state)
    comp, scales = state.comp, state.scales
    if state.ring.dtype == torch.float32:
        update = wa_update.wa_window_update if use_kernel \
            else wa_window_update_ref
        ring, total, avg = update(state.ring, state.total, new, idx,
                                  full_flag, inv_count)
    elif use_kernel and state.ring.dtype == torch.bfloat16:
        ring, total, comp, avg = wa_update.wa_window_update_c(
            state.ring, state.total, comp, new, idx, full_flag, inv_count)
    else:
        ring, scales, total, comp, avg = wa_window_update_c_ref(
            state.ring, scales, state.total, comp, new, idx, full_flag,
            inv_count)
    return WindowState(ring=ring, total=total, count=new_count,
                       next_idx=torch.remainder(idx + 1, I).to(torch.int32),
                       window=I, kind=state.kind, spec=state.spec,
                       comp=comp, scales=scales), avg


def window_average_packed(state: WindowState) -> torch.Tensor:
    """Current W̿ as the packed (P,) f32 buffer."""
    if state.kind == "streaming":
        return state.total
    denom = torch.clamp(state.count, min=1).to(torch.float32)
    return state.total / denom


def window_average(state: WindowState, like):
    """Current W̿ in the dtypes of ``like``."""
    return unpack(window_average_packed(state), state.spec, like=like)
