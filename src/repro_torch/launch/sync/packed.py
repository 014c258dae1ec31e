"""The per-rank sync bodies of mesh-native HWA (counterpart of
``repro.launch.sync.packed``'s ``_psum_composition``,
``_local_packed_sync``, ``_local_inner_sync`` and
``packed_sync_launch_budget``).

Each rank holds ONE replica (k_local = 1) and a whole copy of the window
state: the reference's layout when the data and model axes are 1, where
every replica block pushes the same W̄. The packed layout is the
single-device one (``common.packing``). A sync packs the rank's replica
into one f32 buffer, scales it by f32(1/K), reduces it through the
topology's composition (``launch.mesh.ReplicaMesh.psum``), pushes W̄ into
the window with the window-update kernel (``core.hwa.window_push_packed``)
and restarts the replica from W̄ in place. The sharded and grouped layouts
(a data or model axis inside a replica) are not ported.
"""
from __future__ import annotations

import torch

from repro_torch.common.packing import pack, unpack
from repro_torch.common.pytree import tree_leaves
from repro_torch.core.online import _f32_const, halving_sum_axis0


def _psum_composition(part: torch.Tensor, psum_axes, comms_dtype="f32", *,
                      mesh) -> torch.Tensor:
    """Sum ``part`` over each axis group of ``psum_axes`` in sequence (one
    group for Flat, inner then outer for TwoLevel); empty groups are
    skipped. Every level but the compressed one reduces in f32 through
    ``mesh.psum``.

    ``comms_dtype`` compresses the OUTERMOST non-empty level, the tree's
    cross-pod hop, while the pod-local levels stay f32:

    - ``bf16``: the partial is rounded to bf16 once, all-gathered, and
      summed locally in f32 in the halving order;
    - ``fp8``: the partial is block-scale quantized (``common.quant``),
      all-gathered beside its f32 per-block scales, dequantized and
      summed locally in f32 (an fp8 all-reduce would accumulate in fp8).

    Both payloads cross as their ``uint8`` byte view: ``gloo`` has no
    16-bit integer or fp8 type, NCCL no 16-bit integer type, and the
    bytes are what the wire carries (2 or 1 an element, plus the fp8
    scales)."""
    last = None
    if comms_dtype != "f32":
        non_empty = [i for i, axes in enumerate(psum_axes) if axes]
        last = non_empty[-1] if non_empty else None
    for i, axes in enumerate(psum_axes):
        if not axes:
            continue
        if i != last:
            part = mesh.psum(part, axes)
        elif comms_dtype == "bf16":
            q = part.to(torch.bfloat16).view(torch.uint8)
            qg = mesh.all_gather(q, axes).view(torch.bfloat16)
            part = halving_sum_axis0(qg.float())
        else:
            from repro_torch.common.quant import (block_scales,
                                                  dequantize_fp8,
                                                  quantize_fp8)
            s = block_scales(part)
            q = quantize_fp8(part, s).view(torch.uint8)
            qg = mesh.all_gather(q, axes).view(torch.float8_e4m3fn)
            sg = mesh.all_gather(s, axes)
            part = halving_sum_axis0(dequantize_fp8(qg, sg))
    return part


def _restart(params, spec, mean: torch.Tensor) -> None:
    """W^k ← W̄: the packed mean written into the rank's replica IN PLACE,
    each leaf cast to its dtype."""
    for x, ls in zip(tree_leaves(params), spec.leaves):
        x.copy_(mean[ls.offset:ls.offset + ls.size].reshape(ls.shape))


def _local_packed_sync(hwa_cfg, spec, K: int, psum_axes, params,
                       window_state, cycle, *, mesh, comms_dtype="f32"):
    """One rank's full sync: W̄ over the ranks of ``psum_axes`` (the
    topology's composition), pushed into this rank's window, the replica
    restarted from it.

    Partials are pre-scaled by f32(1/K), so for power-of-two K the
    composition is bit-equal to ``core.online.online_average_canonical``
    over the K replicas in rank order (and to the grouped mean for the
    two-level tree). The reference's two kernel shortcuts never apply
    here: the fused sync needs every replica on one device (no
    collective), the ``online_mean`` gate two replicas a device, and a
    rank holds one.

    With ``hwa_cfg.resilient`` the mean is the alive-masked elastic mean
    (``resilience.health``): the rank's health stats give its alive bit,
    the alive count crosses the levels through the same composition in
    f32, all dead drops the mask, and the weight partial is
    ``halving_sum(where(alive, sbuf, 0)) * renormalized_inv``: bit-equal
    to the plain path when every replica is alive.

    The window push is ``core.hwa.window_push_packed`` (the kernel for an
    f32 or bf16 ring when ``hwa_cfg.use_kernels``; the fp8 ring is plain
    PyTorch, as in the reference). After a compressed ring the replica
    restarts from the DECODED stored slot, the bits the ring holds.

    Returns ``(window_state, wa, cycle, alive, k_alive, mean)``: W̿ as a
    tree, this rank's (1,) alive mask, the alive count before the
    all-dead escape (an f32 scalar; K unless resilient) and the packed
    f32 W̄ the replica restarted from."""
    from repro_torch.common.quant import SLOT_CHUNK, decode_slot, encode_slot
    from repro_torch.core.hwa import window_push_packed

    ws = window_state
    dev = ws.total.device
    sbuf = pack(params, spec)[None]                   # (1, P) f32
    alive = torch.ones((1,), dtype=torch.bool, device=dev)
    k_alive = _f32_const(float(K), dev)
    if hwa_cfg.resilient:
        from repro_torch.resilience.health import (alive_from_stats,
                                                   packed_health_stats,
                                                   renormalized_inv)
        stats = packed_health_stats(sbuf)             # (1, 2) f32
        alive = alive_from_stats(stats, float(sbuf.shape[1]),
                                 hwa_cfg.max_param_rms)
        k_alive = _psum_composition(alive.to(torch.float32).sum(),
                                    psum_axes, mesh=mesh)
        # all dead: drop the mask and degrade to the plain mean (the run
        # is unsalvageable; k_alive 0 makes it observable)
        alive = alive | (k_alive == 0.0)
        k_eff = torch.where(k_alive > 0.0, k_alive,
                            _f32_const(float(K), dev))
        part = halving_sum_axis0(torch.where(
            alive[:, None], sbuf, torch.zeros((), device=dev))) \
            * renormalized_inv(k_eff, K)
    else:
        part = halving_sum_axis0(sbuf) * _f32_const(1.0 / K, dev)
    del sbuf
    mean = _psum_composition(part, psum_axes, comms_dtype, mesh=mesh)
    ws, avg, cycle = window_push_packed(hwa_cfg, mean, ws, cycle)
    if ws.ring is not None and ws.ring.dtype != torch.float32:
        # in place, whole scale blocks at a time: the bits of one pass
        for c in range(0, mean.numel(), SLOT_CHUNK):
            chunk = mean[c:c + SLOT_CHUNK]
            chunk.copy_(decode_slot(*encode_slot(chunk, ws.ring.dtype)))
    _restart(params, spec, mean)
    return ws, unpack(avg, spec), cycle, alive, k_alive, mean


def _local_inner_sync(spec, pod_size: int, psum_axes, params, *, mesh
                      ) -> torch.Tensor:
    """One rank's INNER (pod-local) sync of the two-level tree: the pod
    mean over the inner levels only (f32(1/pod_size)-pre-scaled, the
    halving composition), the replica restarted from it in place. No
    window state is touched (the window collects global W̄ only) and no
    kernel runs. Returns the packed f32 pod mean."""
    sbuf = pack(params, spec)[None]
    part = halving_sum_axis0(sbuf) * _f32_const(1.0 / pod_size,
                                                sbuf.device)
    del sbuf
    pod_mean = _psum_composition(part, psum_axes, mesh=mesh)
    _restart(params, spec, pod_mean)
    return pod_mean


def packed_sync_launch_budget(hwa_cfg, *, use_kernel: bool, n_groups: int,
                              k_local: int, collective: bool,
                              with_stride: bool, ring_dtype="f32",
                              resilient: bool | None = None) -> int:
    """Static kernel-launch count of a packed sync (the reference's
    function, unchanged): the fused path (f32 or bf16 ring, no
    collective, not resilient, stride 1 or no stride) is one launch per
    group; otherwise the mean kernel runs only in the ungrouped
    ``k_local == 2`` case and the window push costs one launch per group
    for a kernel ring dtype. The resilient sync keeps only the pushes."""
    from repro_torch.common.quant import wa_dtype
    from repro_torch.kernels.wa_update import KERNEL_RING_DTYPES
    if resilient is None:
        resilient = hwa_cfg.resilient
    if not use_kernel:
        return 0
    kernel_ring = wa_dtype(ring_dtype) in KERNEL_RING_DTYPES
    fused = (not collective and kernel_ring and not resilient
             and (not with_stride or hwa_cfg.window_stride == 1))
    if fused:
        return n_groups
    mean = 1 if (k_local == 2 and n_groups == 1 and not resilient) else 0
    push = n_groups if kernel_ring else 0
    return mean + push
