"""The per-rank sync bodies of mesh-native HWA and the packed-layout
chooser (counterpart of ``repro.launch.sync.packed``: the chooser,
``_psum_composition``, ``_push_window_groups``, ``_local_packed_sync``,
``_local_inner_sync`` and ``packed_sync_launch_budget``).

Each rank holds ONE replica's shard (k_local = 1): the whole replica when
the data and model axes are 1, else the leaves' blocks the sharding
rules give it (``sharding.rules``). The window state lives in the layout
:func:`choose_resident_spec` picks from those rules: one range when every
leaf agrees on one super-axis (the whole-replica case is the replicated
layout, ``((), all-None)``), else the grouped layout. A rank holds its
segment of every group (``spec.local_spec()``), packs it from its own
leaves with no collective, scales it by f32(1/K), reduces it over the
replica axes only (the topology's composition,
``launch.mesh.ReplicaMesh.psum``), pushes W̄ into the window once a group
(:func:`_push_window_groups`) with one shared set of counters, and
restarts its leaves from W̄ in place. No collective crosses a data or
model axis in a sync, but the resilient path's health stats (one psum
over the non-replica axes).
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.packing import pack, unpack
from repro_torch.common.pytree import tree_leaves
from repro_torch.core.online import _f32_const, halving_sum_axis0
from repro_torch.sharding.rules import entry_axes


def _mesh_resident_layout(mesh: dict, flat_specs, flat_shapes,
                          exclude: tuple[str, ...] = ()):
    """A packed super-axis aligning the leaves' tilings with packed
    ranges: ``(axes, shard_dims)`` such that every leaf has exactly ONE
    dim split over exactly ``axes`` (that dim its ``shard_dim``) or is
    split over no axis of size > 1 (copied into every segment).
    Candidates are the distinct spec entries the leaves use, largest
    device count first; ``((), all-None)`` for a tree split over nothing,
    ``(None, None)`` when no super-axis covers every leaf (mixed
    tilings). A zero-size leaf rules out every sharded candidate."""
    has_zero = any(not all(d > 0 for d in shape) for shape in flat_shapes)
    cands: list[tuple[str, ...]] = []
    for sp in flat_specs:
        for e in sp:
            t = entry_axes(e)
            if (t and not (set(t) & set(exclude)) and t not in cands
                    and math.prod(mesh[a] for a in t) > 1):
                cands.append(t)
    cands.sort(key=lambda t: -math.prod(mesh[a] for a in t))
    cands.append(())
    for cand in cands:
        S = math.prod(mesh[a] for a in cand) if cand else 1
        if S > 1 and has_zero:
            continue
        dims: list[int | None] = []
        ok = True
        for sp, shape in zip(flat_specs, flat_shapes):
            hot = []
            for i, e in enumerate(sp):
                t = entry_axes(e)
                if not t or math.prod(mesh[a] for a in t) == 1:
                    continue
                if t == cand:
                    hot.append(i)
                else:
                    ok = False
                    break
            if not ok or len(hot) > 1:
                ok = False
                break
            if not hot:
                dims.append(None)
            elif shape[hot[0]] % S == 0:
                dims.append(hot[0])
            else:
                ok = False
                break
        if ok:
            return (cand, dims) if S > 1 else ((), [None] * len(flat_specs))
    return None, None


def _grouped_resident_layout(mesh: dict, flat_specs, flat_shapes,
                             exclude: tuple[str, ...] = ()):
    """Per-leaf placements of the GROUPED layout, or None: a leaf may
    tile any number of dims over any axis sets but ``exclude`` (e.g.
    dim 1 over ``data`` and dim 2 over ``model``). None for a leaf split
    over an excluded axis, a tiled dim that does not divide, a zero-size
    leaf, or a tree split over nothing (the single-range chooser's
    case)."""
    placements = []
    any_hot = False
    for sp, shape in zip(flat_specs, flat_shapes):
        if not all(d > 0 for d in shape):
            return None
        pl = []
        for i, e in enumerate(sp):
            t = entry_axes(e)
            if not t or math.prod(mesh[a] for a in t) == 1:
                continue
            if set(t) & set(exclude):
                return None
            if shape[i] % math.prod(mesh[a] for a in t):
                return None
            pl.append((i, t))
        any_hot = any_hot or bool(pl)
        placements.append(tuple(pl))
    return tuple(placements) if any_hot else None


def choose_resident_spec(mesh: dict, params_abs, flat_specs, flat_shapes,
                         exclude: tuple[str, ...] = ()):
    """The layout the sync runs in: one super-axis when one aligns every
    leaf (the replicated layout included), else the grouped layout, else
    None (the reference then falls back to its GSPMD assembly, which the
    port has no counterpart of). ``mesh`` is ``{axis: size}``;
    ``params_abs`` a tree of tensors (``meta`` ones do)."""
    from repro_torch.common.packing import pack_spec, pack_spec_grouped
    axes, shard_dims = _mesh_resident_layout(mesh, flat_specs, flat_shapes,
                                             exclude=exclude)
    if axes is not None:
        S = math.prod(mesh[a] for a in axes) if axes else 1
        return pack_spec(params_abs, shards=S, shard_dims=shard_dims,
                         axes=axes)
    placements = _grouped_resident_layout(mesh, flat_specs, flat_shapes,
                                          exclude=exclude)
    if placements is None:
        return None
    return pack_spec_grouped(params_abs, placements=placements,
                             axis_sizes=dict(mesh))


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
    """W^k ← W̄: the packed mean written into the rank's leaves IN PLACE
    (``spec`` the rank's local layout), each leaf cast to its dtype."""
    gt = spec.group_table()
    for x, ls in zip(tree_leaves(params), spec.leaves):
        off = gt[ls.group].offset + ls.offset
        x.copy_(mean[off:off + ls.size].reshape(ls.shape))


def _group_bounds(spec) -> list[tuple[int, int]]:
    """Each group's range of a local (one segment a group) layout."""
    return [(g.offset, g.offset + g.seg_len) for g in spec.group_table()]


def _push_window_groups(hwa_cfg, bounds, window_state, mean, cycle):
    """The slide-window push of the packed W̄, once a group: the grouped
    form of ``core.hwa.window_push_packed``. A grouped window state holds
    per-group tuples of ring, total (and a compressed ring's comp and
    scales); each group's update is one kernel launch over its ``(I,
    seg_len)`` slice (``core.offline.window_update_packed``), all groups
    share one set of counters, and the stride decision is taken once.
    A single-range state goes through ``window_push_packed`` itself.
    Returns (window state, packed W̿, incremented cycle)."""
    from repro_torch.core.hwa import window_push_packed
    from repro_torch.core.offline import (WindowState,
                                          window_average_packed,
                                          window_update_packed)
    ws = window_state
    if not isinstance(ws.total, tuple):
        return window_push_packed(hwa_cfg, mean, ws, cycle)
    take = (hwa_cfg.window_stride == 1
            or int(cycle) % hwa_cfg.window_stride == 0)
    n = len(ws.total)
    none = (None,) * n
    outs = []
    for i, (lo, hi) in enumerate(bounds):
        part = WindowState(
            ring=ws.ring[i] if ws.ring is not None else None,
            total=ws.total[i], count=ws.count, next_idx=ws.next_idx,
            window=ws.window, kind=ws.kind,
            comp=(ws.comp or none)[i], scales=(ws.scales or none)[i])
        if take:
            outs.append(window_update_packed(part, mean[lo:hi],
                                             use_kernel=hwa_cfg.use_kernels))
        else:
            outs.append((part, window_average_packed(part)))
    new = [o[0] for o in outs]

    def field(name):
        vals = tuple(getattr(w, name) for w in new)
        return None if vals[0] is None else vals
    ws2 = WindowState(ring=field("ring"), total=field("total"),
                      count=new[0].count, next_idx=new[0].next_idx,
                      window=ws.window, kind=ws.kind, spec=ws.spec,
                      comp=field("comp"), scales=field("scales"))
    avg = torch.cat([o[1] for o in outs])
    avg = torch.where(ws2.count == 0, mean, avg)
    return ws2, avg, cycle + 1


def window_ring_dtype(window_state):
    """The ring's storage dtype (None for the streaming window)."""
    ring = window_state.ring
    if isinstance(ring, tuple):
        ring = ring[0]
    return None if ring is None else ring.dtype


def window_average_local(window_state) -> torch.Tensor:
    """The rank's packed W̿ (its local layout): the groups' totals
    concatenated, over the count."""
    from repro_torch.core.offline import WindowState, window_average_packed
    ws = window_state
    if not isinstance(ws.total, tuple):
        return window_average_packed(ws)
    return window_average_packed(WindowState(
        ring=None if ws.ring is None else ws.ring[0],
        total=torch.cat(ws.total), count=ws.count, next_idx=ws.next_idx,
        window=ws.window, kind=ws.kind))


def _local_packed_sync(hwa_cfg, spec, K: int, psum_axes, params,
                       window_state, cycle, *, mesh, comms_dtype="f32",
                       health_axes=(), health_scale: int = 1):
    """One rank's full sync: W̄ over the ranks of ``psum_axes`` (the
    topology's composition over the replica axes), pushed into this
    rank's window, the rank's leaves restarted from it. ``spec`` is the
    rank's local layout (``PackSpec.local_spec()``): its segment of
    every group, packed from its own leaves.

    Partials are pre-scaled by f32(1/K), so for power-of-two K the
    composition is bit-equal to ``core.online.online_average_canonical``
    over the K replicas in rank order (and to the grouped mean for the
    two-level tree), whatever the layout: packing is layout only. The
    reference's two kernel shortcuts never apply here: the fused sync
    needs every replica on one device (no collective), the
    ``online_mean`` gate two replicas a device, and a rank holds one.

    With ``hwa_cfg.resilient`` the mean is the alive-masked elastic mean
    (``resilience.health``): the rank's health stats, summed over its
    replica's shards by one psum over ``health_axes`` (the non-replica
    axes of size > 1; ``health_scale`` their device count, for the RMS
    denominator), give the replica's alive bit; the alive count crosses
    the replica levels through the same composition in f32; all dead
    drops the mask; and the weight partial is ``halving_sum(where(alive,
    sbuf, 0)) * renormalized_inv``, bit-equal to the plain path when
    every replica is alive.

    The window push is :func:`_push_window_groups` (the window-update
    kernel once a group for an f32 or bf16 ring when
    ``hwa_cfg.use_kernels``; the fp8 ring is plain PyTorch, as in the
    reference). After a compressed ring the leaves restart from the
    DECODED stored slot, the bits the ring holds.

    Returns ``(window_state, wa, cycle, alive, k_alive, mean)``: W̿ as the
    rank's local tree, this rank's (1,) alive mask, the alive count
    before the all-dead escape (an f32 scalar; K unless resilient) and
    the packed f32 W̄ the leaves restarted from."""
    from repro_torch.common.quant import SLOT_CHUNK, decode_slot, encode_slot

    ws = window_state
    dev = ws.total[0].device if isinstance(ws.total, tuple) \
        else ws.total.device
    sbuf = pack(params, spec)[None]                   # (1, P_local) f32
    alive = torch.ones((1,), dtype=torch.bool, device=dev)
    k_alive = _f32_const(float(K), dev)
    if hwa_cfg.resilient:
        from repro_torch.resilience.health import (alive_from_stats,
                                                   packed_health_stats,
                                                   renormalized_inv)
        stats = packed_health_stats(sbuf)             # (1, 2) f32
        if health_axes:
            # a replica's stats over its shards: the one collective of a
            # sync that crosses no replica axis
            stats = mesh.psum(stats, health_axes)
        alive = alive_from_stats(stats, float(sbuf.shape[1] * health_scale),
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
            .mul_(renormalized_inv(k_eff, K))
    else:
        # in place on the rank's packed row (the one row's sum is itself)
        part = halving_sum_axis0(sbuf).mul_(_f32_const(1.0 / K, dev))
    del sbuf
    mean = _psum_composition(part, psum_axes, comms_dtype, mesh=mesh)
    ws, avg, cycle = _push_window_groups(hwa_cfg, _group_bounds(spec), ws,
                                         mean, cycle)
    rd = window_ring_dtype(ws)
    if rd is not None and rd != torch.float32:
        # in place, whole scale blocks at a time (group ranges are ALIGN
        # multiples, so the blocks are the per-group slots' blocks)
        for c in range(0, mean.numel(), SLOT_CHUNK):
            chunk = mean[c:c + SLOT_CHUNK]
            chunk.copy_(decode_slot(*encode_slot(chunk, rd)))
    _restart(params, spec, mean)
    return ws, unpack(avg, spec), cycle, alive, k_alive, mean


def _local_inner_sync(spec, pod_size: int, psum_axes, params, *, mesh
                      ) -> torch.Tensor:
    """One rank's INNER (pod-local) sync of the two-level tree: the pod
    mean over the inner levels only (f32(1/pod_size)-pre-scaled, the
    halving composition), the rank's leaves restarted from it in place.
    No window state is touched (the window collects global W̄ only) and
    no kernel runs. ``spec`` is the rank's local layout. Returns the
    packed f32 pod mean."""
    sbuf = pack(params, spec)[None]
    part = halving_sum_axis0(sbuf).mul_(_f32_const(1.0 / pod_size,
                                                   sbuf.device))
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


def packed_sync_working_set(block_bytes: int, level_sizes, *,
                            comms_dtype="f32", ring_dtype="f32",
                            grouped: bool = False, push: bool = True
                            ) -> int:
    """The bytes one rank's sync holds at once above its start, at its
    largest phase, beside the state it writes in place
    (:func:`_local_packed_sync`; ``push=False``: the inner sync,
    :func:`_local_inner_sync`), plus ``analysis.contracts.PEAK_SLACK``:
    the sync's declared working set. ``block_bytes`` is the rank's packed
    f32 block, ``level_sizes`` the ranks of each level it reduces over,
    innermost first. In blocks:

    - the packed row, reduced in place into W̄ over a power-of-two
      level (1); a level of another size n gathers the n rows and sums
      them (1 + n + n - 1 at most, the halving sum's rounds);
    - a compressed outermost level of n ranks (w bytes an element): the
      partial, its wire view and the n gathered views (1 + (1 + n)·w/4)
      beside the rows widened to f32 and their sum (bf16: n + n - 1) or
      the rows dequantized, a cast and a product (fp8: 2n);
    - the push: W̄, the window's W̿ and its count-masked copy (3; a
      grouped layout's W̿ is its groups' concatenated: 4);
    - a narrow ring: W̄ and the masked W̿ beside a ``SLOT_CHUNK`` of the
      stored slot's encode and decode (1 + w/4 chunks), and the plain
      fp8 push's temporaries, 16 chunks beside W̄."""
    from repro_torch.analysis.contracts import PEAK_SLACK
    from repro_torch.common.quant import SLOT_CHUNK, wa_token
    from repro_torch.launch.mesh import _is_pow2
    comms, ring = wa_token(comms_dtype), wa_token(ring_dtype)
    sizes = [n for n in level_sizes if n > 1]
    phases = [1.0]
    for i, n in enumerate(sizes):
        if comms != "f32" and i == len(sizes) - 1:
            w = 2 if comms == "bf16" else 1
            wire = 1 + (1 + n) * w / 4
            phases.append(wire + (n + n - 1 if comms == "bf16" else 2 * n))
        elif not _is_pow2(n):
            phases.append(2.0 * n)
    if push:
        phases.append(4.0 if grouped else 3.0)
        chunk = min(1.0, SLOT_CHUNK * 4 / max(block_bytes, 1))
        if ring != "f32":
            w = 2 if ring == "bf16" else 1
            phases.append(2 + chunk * (1 + w / 4))
        if ring == "fp8":
            phases.append(1 + 16 * chunk)
    return int(max(phases) * block_bytes) + PEAK_SLACK
