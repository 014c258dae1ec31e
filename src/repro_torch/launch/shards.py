"""A replica's blocks across its ranks, gathered to one rank and back:
what checkpoints, probes and the final state need when a data or model
axis splits a replica (``launch.sync.bundles.replica_layout``).

Ranks are laid out row-major over the mesh axes (``launch.mesh``), the
replica axes first and then ``data`` and ``model``. A packed layout's
group ``g`` holds segment ``s`` on the ranks whose row-major coordinate
over ``g.axes`` is ``s`` (``common.packing``): concatenating each
group's segments in that order rebuilds the reference's global buffer,
which is what a checkpoint stores, and slicing it back gives a rank its
segment under any other mesh.
"""
from __future__ import annotations

import math

import torch

from repro_torch.common.packing import (pack, pack_spec_grouped,
                                        split_groups, unpack)
from repro_torch.common.pytree import tree_flatten, tree_map

#: the axes inside a replica
INNER = ("data", "model")


def replica_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in mesh.shape if a not in INNER)


def _row_major(mesh, coords: dict, axes) -> int:
    out = 0
    for a in axes:
        out = out * mesh.shape[a] + coords[a]
    return out


def replica_index(mesh, rank: int | None = None) -> int:
    """The replica a rank belongs to (pod-major under the tree)."""
    return _row_major(mesh, mesh.coords(rank), replica_axes(mesh))


def inner_key(mesh, rank: int | None = None) -> tuple:
    """A rank's coordinates inside its replica."""
    c = mesh.coords(rank)
    return tuple(c[a] for a in mesh.shape if a in INNER)


def replica_leads(mesh) -> list[int]:
    """The first rank of each replica, in replica order."""
    leads = {}
    for r in range(mesh.world):
        leads.setdefault(replica_index(mesh, r), r)
    return [leads[k] for k in sorted(leads)]


def _segment_rank(mesh, replica: int, axes, s: int) -> int:
    """A rank of ``replica`` whose row-major coordinate over ``axes`` is
    ``s`` (the first such)."""
    for r in range(mesh.world):
        if replica_index(mesh, r) != replica:
            continue
        if not axes or _row_major(mesh, mesh.coords(r), axes) == s:
            return r
    raise ValueError(f"no rank of replica {replica} at {s} over {axes}")


def assemble(bufs, spec, mesh, replica: int, unit: int = 1):
    """The global buffer of ``replica`` (``(..., spec.padded // unit)``)
    from every rank's local buffer ``bufs[r]`` (``spec.local_spec()``'s
    layout; ``unit`` = ``spec.align`` for the fp8 ring's block scales)."""
    lgt = spec.local_spec().group_table()
    lead = tuple(bufs[0].shape[:-1])
    out = torch.empty(lead + (spec.padded // unit,), dtype=bufs[0].dtype)
    for g, lg in zip(spec.group_table(), lgt):
        n = g.seg_len // unit
        for s in range(g.shards):
            r = _segment_rank(mesh, replica, g.axes, s)
            o = (g.offset + s * g.seg_len) // unit
            out[..., o:o + n] = bufs[r][..., lg.offset // unit:
                                         lg.offset // unit + n]
    return out


def segment_of(buf, spec, mesh, rank: int | None = None, unit: int = 1):
    """A rank's local buffer (``spec.local_spec()``'s layout) cut from
    the global one."""
    c = mesh.coords(rank)
    parts = []
    for g in spec.group_table():
        s = _row_major(mesh, c, g.axes) if g.axes else 0
        o, n = (g.offset + s * g.seg_len) // unit, g.seg_len // unit
        parts.append(buf[..., o:o + n])
    return torch.cat(parts, dim=-1)


def tree_layout(abs_tree, places, mesh) -> object:
    """A grouped packed layout of a whole tree (``meta`` tensors do)
    whose leaves tile as ``places`` (``models.parallel.LeafPlace``) says:
    the layout a rank's blocks of it are gathered and scattered in."""
    flat, _ = tree_flatten(abs_tree)
    pl, _ = tree_flatten(places)
    placements = []
    for x, p in zip(flat, pl):
        placements.append(tuple(
            (i, p.axes(i)) for i in range(x.dim())
            if p.axes(i) and math.prod(mesh.shape[a] for a in p.axes(i)) > 1))
    return pack_spec_grouped(abs_tree, placements=placements,
                             axis_sizes=dict(mesh.shape))


def gather_full(mesh, local_tree, spec, level: str):
    """Every replica's whole tree, stacked ``(K, ...)``, on rank 0's host
    (None elsewhere), from the ranks' blocks (``spec`` from
    :func:`tree_layout`; blocks packed in ``spec.local_spec()``)."""
    bufs = mesh.gather(pack(local_tree, spec.local_spec()), level,
                       out_device="cpu")
    if bufs is None:
        return None
    rows = torch.stack([assemble(bufs, spec, mesh, k)
                        for k in range(len(replica_leads(mesh)))])
    return unpack(rows, spec)


def local_rows(full_tree, mesh, places):
    """This rank's blocks of its replica's row of a stacked ``(K, ...)``
    tree, as fresh contiguous tensors."""
    from repro_torch.models.parallel import blocks_of
    k = replica_index(mesh)
    row = tree_map(lambda x: x[k], full_tree)
    return tree_map(lambda x: x.contiguous().clone(),
                    blocks_of(row, places, mesh))


def _cat(x):
    return torch.cat(x, dim=-1) if isinstance(x, tuple) else x


def gather_window(mesh, ws, level: str):
    """The window state of the replicas (every replica holds the same),
    in the global layout ``ws.spec``, on rank 0's host (None elsewhere):
    per-group tuples for a grouped layout, as the reference holds it."""
    from repro_torch.core.offline import WindowState
    spec = ws.spec

    def one(x, unit=1):
        if x is None:
            return None
        bufs = mesh.gather(_cat(x), level, out_device="cpu")
        if bufs is None:
            return None
        full = assemble(bufs, spec, mesh, 0, unit)
        if not spec.is_grouped:
            return full
        if unit == 1:
            return split_groups(full, spec)
        return tuple(full[..., g.offset // unit:(g.offset + g.padded) // unit]
                     for g in spec.group_table())
    ring, total, comp = one(ws.ring), one(ws.total), one(ws.comp)
    scales = one(ws.scales, spec.align)
    if mesh.rank != 0:
        return None
    return WindowState(ring=ring, total=total, count=ws.count.cpu(),
                       next_idx=ws.next_idx.cpu(), window=ws.window,
                       kind=ws.kind, spec=spec, comp=comp, scales=scales)


def local_window(ws, mesh, device):
    """This rank's window state cut from a global one (``ws.spec``'s
    layout), on ``device``: bare buffers for one range, per-group tuples
    for a grouped layout."""
    from repro_torch.core.offline import WindowState
    spec = ws.spec
    lgt = spec.local_spec().group_table()

    def one(x, unit=1):
        if x is None:
            return None
        mine = segment_of(_cat(x), spec, mesh, unit=unit).to(device)
        if not spec.is_grouped:
            return mine
        return tuple(mine[..., lg.offset // unit:
                          (lg.offset + lg.seg_len) // unit] .contiguous()
                     for lg in lgt)
    return WindowState(ring=one(ws.ring), total=one(ws.total),
                       count=ws.count.to(device),
                       next_idx=ws.next_idx.to(device), window=ws.window,
                       kind=ws.kind, spec=spec, comp=one(ws.comp),
                       scales=one(ws.scales, spec.align))


def global_window_template(ws):
    """A zeroed host window state of the global layout ``ws.spec`` (the
    template a checkpoint loads into), shaped as :func:`gather_window`
    returns one."""
    from repro_torch.common.packing import window_aux_buffers, \
        window_buffers
    from repro_torch.core.offline import WindowState
    spec = ws.spec
    rd = (ws.ring[0] if isinstance(ws.ring, tuple) else ws.ring).dtype
    ring, total = window_buffers(spec, ws.window, rd)
    scales, comp = window_aux_buffers(spec, ws.window, rd)
    zero = torch.zeros((), dtype=torch.int32)
    return WindowState(ring=ring, total=total, count=zero,
                       next_idx=zero.clone(), window=ws.window, kind=ws.kind,
                       spec=spec, comp=comp, scales=scales)
