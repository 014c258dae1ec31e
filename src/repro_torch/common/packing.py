"""Parameter packing: a parameter tree as ONE flat, ALIGN-padded buffer.

Counterpart of ``repro.common.packing``. The WA state (ring, total) lives
in this layout for the whole run, so one sync is one kernel launch over
the whole parameter set however many leaves the tree has. Leaves are
laid out in JAX's flatten order (``common.pytree``) at the same offsets,
and the tail is zero-padded to a multiple of :data:`ALIGN`, so a packed
buffer is byte-equal to the reference's. Packing copies values and never
computes with them: any elementwise update of the buffer is bit-identical
to the same update applied leaf by leaf.

**Shard-aware layout** (``shards > 1``), for a data or model axis inside
a replica: the buffer is ``shards`` equal segments of ``seg_len``
elements, and segment ``s`` holds, for every leaf in flatten order, the
leaf's shard ``s`` along its ``shard_dim`` (flattened row-major), or a
whole copy of a leaf that is not split. The rank at coordinate ``s`` of
the packed super-axis (``spec.axes``) owns segment ``s``, which it packs
from its own leaf shards alone: ``pack(local_tree, spec.local_spec())``
is its slice of the global ``pack(tree, spec)``, no collective needed.

**Grouped layout** (``spec.groups``), for mixed tilings (FSDP splits some
leaves over ``data``, some over ``model``, some over both): leaves with
the same placement key share a :class:`PackGroup`, a contiguous range
laid out like an independent segment-major pack over its own axes; the
leaves split over no axis form a ``shards == 1`` group stored once. A
leaf may tile several dims at once (``LeafSpec.tiles``); segment ``s`` of
its group holds the block at the row-major decomposition of ``s`` over
the tile parts, the block the rank at those coordinates holds. The
segments of every group concatenated in axis order are the reference's
global buffer: checkpoints store exactly those bytes.

A spec also names the storage dtype of the WA ring laid out by it
(``ring_dtype``: precision metadata, not layout) and, for an fp8 ring,
its number of per-block scales. :func:`spec_to_json` writes a layout in
the reference's JSON form, character for character, and
:func:`spec_from_json` reads it back; :func:`repack` moves a buffer
between two layouts of one leaf set.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Sequence

import torch

from repro_torch.common.pytree import tree_flatten, tree_unflatten

PyTree = Any

# The reference's packed alignment (one (8, 1024) f32 tile): kept so the
# two packages lay a tree out identically. The CUDA sync kernel needs only
# P % 4 == 0 (float4 loads), which this implies. Every segment of a
# sharded layout is an ALIGN multiple, so a rank's slice tiles exactly.
ALIGN = 8 * 1024


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Placement of one leaf inside the packed buffer. ``offset`` is the
    offset inside a segment of the leaf's group; ``shard_dim`` the leaf
    dim split over the group's axes (None: whole in every segment);
    ``tiles`` the multi-dim placement of a grouped layout, ``((dim,
    parts), ...)`` in ascending dim order (None: derived from
    ``shard_dim``)."""
    offset: int
    size: int
    shape: tuple[int, ...]
    dtype: torch.dtype
    shard_dim: int | None = None
    group: int = 0
    tiles: tuple[tuple[int, int], ...] | None = None


def _leaf_tiles(ls: LeafSpec, shards: int) -> tuple[tuple[int, int], ...]:
    """The leaf's tiling in a group of ``shards`` segments: () for a leaf
    held whole in every segment."""
    if ls.tiles is not None:
        return ls.tiles
    if ls.shard_dim is None or shards == 1:
        return ()
    return ((ls.shard_dim, shards),)


@dataclasses.dataclass(frozen=True)
class PackGroup:
    """One contiguous range ``[offset, offset + shards * seg_len)`` of a
    grouped layout: ``shards`` segments of ``seg_len`` elements (an
    ``align`` multiple each) over the mesh axes ``axes`` jointly. ``axes
    == ()`` with ``shards == 1`` is the group of leaves split over no
    axis, stored once."""
    shards: int
    axes: tuple[str, ...]
    seg_len: int
    offset: int

    @property
    def padded(self) -> int:
        return self.shards * self.seg_len


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Where every leaf of a tree lives in its packed buffer. ``treedef``
    is None for a spec read back from a checkpoint's JSON: it supports
    the leaf-level operations (:func:`pack_leaves`, :func:`repack`) but
    not the tree-level ones. ``axes`` names the mesh axes of a single
    range's packed super-axis; ``groups`` is the grouped layout (()
    for one range)."""
    treedef: Any
    leaves: tuple[LeafSpec, ...]
    size: int          # real elements (no per-segment duplicates)
    padded: int        # buffer length: shards * seg_len, or the groups'
    align: int = ALIGN
    shards: int = 1
    axes: tuple[str, ...] = ()
    groups: tuple[PackGroup, ...] = ()
    ring_dtype: str = "float32"   # WA ring storage dtype (not layout)

    @property
    def n_leaves(self) -> int:
        return len(self.leaves)

    @property
    def n_groups(self) -> int:
        return len(self.groups) if self.groups else 1

    @property
    def is_grouped(self) -> bool:
        return bool(self.groups)

    @property
    def is_sharded(self) -> bool:
        """Whether a rank holds only part of the buffer."""
        return any(g.shards > 1 for g in self.group_table())

    @property
    def seg_len(self) -> int:
        """The segment length of a single-range layout."""
        return self.padded // self.shards

    def group_table(self) -> tuple[PackGroup, ...]:
        """The layout as groups: a single range as its one group."""
        if self.groups:
            return self.groups
        return (PackGroup(shards=self.shards, axes=self.axes,
                          seg_len=self.padded // self.shards, offset=0),)

    @property
    def pad_waste(self) -> float:
        return 1.0 - self.size / self.padded

    @property
    def scale_blocks(self) -> int:
        """fp8 scales per ring row: one per ``align`` block."""
        return self.padded // self.align

    def group_scale_blocks(self, g: PackGroup) -> int:
        """fp8 scales per ring row of one group's range."""
        return g.padded // self.align

    def piece_size(self, ls: LeafSpec) -> int:
        """Elements of ``ls`` in one segment of its group."""
        tiles = _leaf_tiles(ls, self.group_table()[ls.group].shards)
        return ls.size // math.prod(p for _, p in tiles)

    def local_spec(self) -> "PackSpec":
        """A rank's view: one segment per group, local leaf shapes (each
        tiled dim divided by its parts), the same offsets inside a
        segment. ``pack(local_tree, spec.local_spec())`` is the rank's
        slice of ``pack(tree, spec)``: segment ``s`` of every group, ``s``
        its coordinate along the group's axes. A grouped layout keeps its
        groups (each ``shards == 1``, laid end to end)."""
        if not self.groups and self.shards == 1:
            return self
        gt = self.group_table()
        leaves = []
        for ls in self.leaves:
            tiles = _leaf_tiles(ls, gt[ls.group].shards)
            shape = list(ls.shape)
            for d, p in tiles:
                shape[d] //= p
            leaves.append(LeafSpec(
                offset=ls.offset, size=ls.size // math.prod(
                    p for _, p in tiles), shape=tuple(shape),
                dtype=ls.dtype, group=ls.group))
        if not self.groups:
            return PackSpec(treedef=self.treedef, leaves=tuple(leaves),
                            size=sum(l.size for l in leaves),
                            padded=self.seg_len, align=self.align,
                            ring_dtype=self.ring_dtype)
        lgroups, off = [], 0
        for g in gt:
            lgroups.append(PackGroup(shards=1, axes=(), seg_len=g.seg_len,
                                     offset=off))
            off += g.seg_len
        return PackSpec(treedef=self.treedef, leaves=tuple(leaves),
                        size=sum(l.size for l in leaves), padded=off,
                        align=self.align, groups=tuple(lgroups),
                        ring_dtype=self.ring_dtype)

    def same_layout(self, other: "PackSpec") -> bool:
        """Layout equality ignoring the treedef (a spec read from JSON
        has none) and ``ring_dtype`` (precision, not layout)."""
        return (self.leaves == other.leaves and self.padded == other.padded
                and self.shards == other.shards and self.align == other.align
                and self.groups == other.groups)

    def with_ring_dtype(self, dtype) -> "PackSpec":
        """This layout with its WA ring precision set (a dtype or a
        ``f32``/``bf16``/``fp8`` token); the layout is untouched."""
        from repro_torch.common.quant import wa_dtype
        name = str(wa_dtype(dtype)).removeprefix("torch.")
        if name == self.ring_dtype:
            return self
        return dataclasses.replace(self, ring_dtype=name)


def _numel(shape) -> int:
    return math.prod(shape) if shape else 1


def pack_spec(tree: PyTree, align: int = ALIGN, *, shards: int = 1,
              shard_dims: Sequence[int | None] | None = None,
              axes: tuple[str, ...] = ()) -> PackSpec:
    """The packed layout of ``tree`` (tensors, on any device or ``meta``:
    only shapes and dtypes are read). ``shards``/``shard_dims``/``axes``
    select the shard-aware layout: ``shard_dims`` gives, per leaf in
    flatten order, the dim split over the super-axis, or None to copy
    the leaf into every segment. Each named dim must divide by
    ``shards``."""
    flat, treedef = tree_flatten(tree)
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    sd_flat = [None] * len(flat) if shard_dims is None else list(shard_dims)
    if len(sd_flat) != len(flat):
        raise ValueError(f"shard_dims has {len(sd_flat)} entries for "
                         f"{len(flat)} leaves")
    leaves, offset = [], 0
    for leaf, sd in zip(flat, sd_flat):
        shape = tuple(int(d) for d in leaf.shape)
        size = _numel(shape)
        if shards == 1:
            sd = None
        if sd is not None and (not 0 <= sd < len(shape) or size == 0
                               or shape[sd] % shards):
            raise ValueError(f"leaf {shape} cannot shard dim {sd} "
                             f"{shards}-ways")
        leaves.append(LeafSpec(offset=offset, size=size, shape=shape,
                               dtype=leaf.dtype, shard_dim=sd))
        offset += size // shards if sd is not None else size
    seg_len = max(align, -(-offset // align) * align)
    return PackSpec(treedef=treedef, leaves=tuple(leaves),
                    size=sum(l.size for l in leaves),
                    padded=shards * seg_len, align=align, shards=shards,
                    axes=tuple(axes))


#: a leaf's placement in a grouped layout: ((dim, axes), ...) in ascending
#: dim order, leaf dim ``dim`` tiled over the mesh axes ``axes`` jointly;
#: () for a leaf split over no axis
Placement = tuple[tuple[int, tuple[str, ...]], ...]


def pack_spec_grouped(tree: PyTree, align: int = ALIGN, *,
                      placements: Sequence[Placement],
                      axis_sizes: dict[str, int]) -> PackSpec:
    """A GROUPED layout of ``tree`` for mixed tilings: ``placements``
    gives each leaf's tiling (flatten order), ``axis_sizes`` each axis's
    device count. Leaves with the same placement key (the ordered axes
    tuples) share a group; groups are laid out in first-appearance
    order, each segment-major over its own axes; leaves with an empty
    placement form a ``shards == 1`` group stored once."""
    flat, treedef = tree_flatten(tree)
    pls = [tuple(pl) for pl in placements]
    if len(pls) != len(flat):
        raise ValueError(f"placements has {len(pls)} entries for "
                         f"{len(flat)} leaves")
    keys: list = []
    for pl in pls:
        key = tuple(tuple(axes) for _, axes in pl)
        if key not in keys:
            keys.append(key)
    if not keys:
        keys.append(())
    offsets = [0] * len(keys)
    leaves = []
    for leaf, pl in zip(flat, pls):
        shape = tuple(int(d) for d in leaf.shape)
        size = _numel(shape)
        gi = keys.index(tuple(tuple(axes) for _, axes in pl))
        tiles = []
        for dim, axes in pl:
            parts = math.prod(axis_sizes[a] for a in axes)
            if not 0 <= dim < len(shape) or size == 0 or shape[dim] % parts:
                raise ValueError(f"leaf {shape} cannot tile dim {dim} "
                                 f"{parts}-ways over {tuple(axes)}")
            tiles.append((dim, parts))
        dims_used = [d for d, _ in tiles]
        if dims_used != sorted(set(dims_used)):
            raise ValueError(f"placement dims must be distinct and "
                             f"ascending, got {dims_used}")
        if len(tiles) == 1:
            ls = LeafSpec(offset=offsets[gi], size=size, shape=shape,
                          dtype=leaf.dtype, shard_dim=tiles[0][0], group=gi)
        else:
            ls = LeafSpec(offset=offsets[gi], size=size, shape=shape,
                          dtype=leaf.dtype, group=gi,
                          tiles=tuple(tiles) if tiles else None)
        leaves.append(ls)
        offsets[gi] += size // math.prod(p for _, p in tiles)
    groups, goff = [], 0
    for key, used in zip(keys, offsets):
        flat_axes = tuple(a for axes in key for a in axes)
        shards = math.prod(axis_sizes[a] for a in flat_axes)
        seg_len = max(align, -(-used // align) * align)
        groups.append(PackGroup(shards=shards, axes=flat_axes,
                                seg_len=seg_len, offset=goff))
        goff += shards * seg_len
    return PackSpec(treedef=treedef, leaves=tuple(leaves),
                    size=sum(l.size for l in leaves), padded=goff,
                    align=align, groups=tuple(groups))


def _tile_coords(tiles, s: int) -> list[int]:
    """Segment ``s``'s coordinate along each tiled dim: the row-major
    decomposition of ``s`` over the tile parts."""
    coords = []
    for _, p in reversed(tiles):
        coords.append(s % p)
        s //= p
    return coords[::-1]


def _piece(leaf: torch.Tensor, ls: LeafSpec, tiles, s: int, n_lead: int):
    """The block of ``leaf`` segment ``s`` holds (lead dims kept)."""
    for (d, p), c in zip(tiles, _tile_coords(tiles, s)):
        w = leaf.shape[d + n_lead] // p
        leaf = leaf.narrow(d + n_lead, c * w, w)
    return leaf


def pack_leaves(flat: Sequence[torch.Tensor], spec: PackSpec,
                dtype=torch.float32, n_lead: int = 0) -> torch.Tensor:
    """Pack already-flattened leaves (``n_lead`` shared leading dims per
    leaf, e.g. the K of :func:`pack_stacked`). Each piece is copied once
    into its slice of one preallocated buffer; padding is zero."""
    if len(flat) != spec.n_leaves:
        raise ValueError(f"{len(flat)} leaves for a spec of {spec.n_leaves}")
    lead = tuple(flat[0].shape[:n_lead]) if flat else ()
    device = flat[0].device if flat else None
    for leaf, ls in zip(flat, spec.leaves):
        if tuple(leaf.shape[n_lead:]) != ls.shape:
            raise ValueError(f"leaf shape {tuple(leaf.shape)} != spec "
                             f"{ls.shape}")
    if not spec.groups and spec.shards == 1:
        buf = torch.empty(lead + (spec.padded,), dtype=dtype, device=device)
        for leaf, ls in zip(flat, spec.leaves):
            buf[..., ls.offset:ls.offset + ls.size].copy_(
                leaf.detach().reshape(lead + (ls.size,)))
        buf[..., spec.size:].zero_()
        return buf
    buf = torch.zeros(lead + (spec.padded,), dtype=dtype, device=device)
    gt = spec.group_table()
    for leaf, ls in zip(flat, spec.leaves):
        g = gt[ls.group]
        tiles = _leaf_tiles(ls, g.shards)
        n = spec.piece_size(ls)
        for s in range(g.shards):
            off = g.offset + s * g.seg_len + ls.offset
            buf[..., off:off + n].copy_(
                _piece(leaf.detach(), ls, tiles, s, n_lead)
                .reshape(lead + (n,)))
    return buf


def pack(tree: PyTree, spec: PackSpec | None = None,
         dtype=torch.float32) -> torch.Tensor:
    """Flatten ``tree`` into one ``(spec.padded,)`` buffer of ``dtype``."""
    spec = spec or pack_spec(tree)
    flat, treedef = tree_flatten(tree)
    if treedef != spec.treedef:
        raise ValueError("tree structure does not match the PackSpec")
    return pack_leaves(flat, spec, dtype)


def pack_stacked(tree: PyTree, spec: PackSpec,
                 dtype=torch.float32) -> torch.Tensor:
    """Pack a tree whose leaves carry a leading stacked axis K into one
    ``(K, padded)`` buffer. ``spec`` describes the unstacked leaves."""
    flat, treedef = tree_flatten(tree)
    if treedef != spec.treedef:
        raise ValueError("stacked tree structure does not match PackSpec")
    if not flat:
        raise ValueError("pack_stacked needs at least one leaf to infer K")
    K = flat[0].shape[0]
    for leaf, ls in zip(flat, spec.leaves):
        if tuple(leaf.shape) != (K,) + ls.shape:
            raise ValueError(f"stacked leaf {tuple(leaf.shape)} != "
                             f"(K,)+{ls.shape}")
    return pack_leaves(flat, spec, dtype, n_lead=1)


def _unpack_one(buf: torch.Tensor, spec: PackSpec, ls: LeafSpec):
    """One leaf of the packed buffer (lead dims kept): a view where the
    leaf lies whole in one place, else its blocks concatenated."""
    lead = tuple(buf.shape[:-1])
    g = spec.group_table()[ls.group]
    tiles = _leaf_tiles(ls, g.shards)
    if not tiles:
        off = g.offset + ls.offset            # segment 0's copy
        return buf[..., off:off + ls.size].reshape(lead + ls.shape)
    n = spec.piece_size(ls)
    local = list(ls.shape)
    for d, p in tiles:
        local[d] //= p
    pieces = [buf[..., g.offset + s * g.seg_len + ls.offset:
                  g.offset + s * g.seg_len + ls.offset + n]
              .reshape(lead + tuple(local)) for s in range(g.shards)]

    def assemble(arrs, ts):
        d, p = ts[0]
        if len(ts) == 1:
            return torch.cat(arrs, dim=len(lead) + d)
        chunk = len(arrs) // p
        return torch.cat([assemble(arrs[i * chunk:(i + 1) * chunk], ts[1:])
                          for i in range(p)], dim=len(lead) + d)
    return assemble(pieces, tiles)


def unpack(buf: torch.Tensor, spec: PackSpec, like: PyTree | None = None
           ) -> PyTree:
    """Slice the packed buffer back into leaves (leading dims of ``buf``
    kept). Dtypes come from ``like`` when given, else from the spec. A
    leaf held whole in one place whose dtype is the buffer's is a view of
    ``buf``, not a copy."""
    like_flat = None
    if like is not None:
        like_flat, treedef = tree_flatten(like)
        if treedef != spec.treedef:
            raise ValueError("``like`` does not match the PackSpec")
    leaves = []
    for i, ls in enumerate(spec.leaves):
        dt = like_flat[i].dtype if like_flat is not None else ls.dtype
        leaves.append(_unpack_one(buf, spec, ls).to(dt))
    return tree_unflatten(spec.treedef, leaves)


def unpack_leaf(buf: torch.Tensor, spec: PackSpec, index: int,
                dtype=None) -> torch.Tensor:
    """One leaf (by flatten order) of the packed buffer."""
    ls = spec.leaves[index]
    return _unpack_one(buf, spec, ls).to(dtype or ls.dtype)


def repack(buf: torch.Tensor, src: PackSpec, dst: PackSpec) -> torch.Tensor:
    """A packed buffer moved from layout ``src`` to layout ``dst`` of the
    same leaf set, leading dims kept (bit-exact: packing never touches
    values). A checkpoint saved under one mesh's layout loads under
    another's through it."""
    if tuple(l.shape for l in src.leaves) != \
            tuple(l.shape for l in dst.leaves):
        raise ValueError("repack: leaf shapes differ between layouts")
    leaves = [_unpack_one(buf, src, ls) for ls in src.leaves]
    return pack_leaves(leaves, dst, buf.dtype, n_lead=buf.dim() - 1)


# -------------------------------------------------- grouped-buffer views
#
# A grouped layout is ONE logical buffer (checkpoints and repack see it
# so), but at run time each group's range splits over other axes, so the
# window state of a grouped layout is a tuple of per-group buffers. These
# two convert (slicing and concatenation: bit-exact both ways).


def split_groups(buf: torch.Tensor, spec: PackSpec) -> tuple:
    """Per-group sub-buffers of a packed buffer (lead dims kept)."""
    return tuple(buf[..., g.offset:g.offset + g.padded]
                 for g in spec.group_table())


def merge_groups(parts, spec: PackSpec) -> torch.Tensor:
    """Inverse of :func:`split_groups`: the per-group buffers
    concatenated into the one logical buffer (a bare tensor passes
    through)."""
    if not isinstance(parts, (tuple, list)):
        return parts
    parts = tuple(parts)
    if len(parts) != spec.n_groups:
        raise ValueError(f"{len(parts)} group buffers for a "
                         f"{spec.n_groups}-group layout")
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=-1)


def window_buffers(spec: PackSpec, window: int, ring_dtype=torch.float32,
                   device=None):
    """Zeroed ``(ring, total)`` window buffers of ``spec``: bare ``(I,
    padded)`` / ``(padded,)`` tensors for a single range, per-group tuples
    for a grouped layout. The total is always f32."""
    from repro_torch.common.quant import wa_dtype
    rd = wa_dtype(ring_dtype)
    if not spec.is_grouped:
        return (torch.zeros((window, spec.padded), dtype=rd, device=device),
                torch.zeros((spec.padded,), dtype=torch.float32,
                            device=device))
    gt = spec.group_table()
    return (tuple(torch.zeros((window, g.padded), dtype=rd, device=device)
                  for g in gt),
            tuple(torch.zeros((g.padded,), dtype=torch.float32,
                              device=device) for g in gt))


def window_aux_buffers(spec: PackSpec, window: int, ring_dtype, device=None):
    """A compressed ring's companions ``(scales, comp)``, shaped as
    :func:`window_buffers` shapes its buffers: ``scales`` the fp8 ring's
    per-block f32 scales ``(I, padded // align)``, ONES (an all-zero
    block's scale), None unless fp8; ``comp`` the Kahan compensation of
    the total, zeros, None for an f32 ring."""
    from repro_torch.common.quant import is_compressed, needs_scales, \
        wa_dtype
    rd = wa_dtype(ring_dtype)
    if not is_compressed(rd):
        return None, None
    f32 = torch.float32
    if not spec.is_grouped:
        scales = (torch.ones((window, spec.scale_blocks), dtype=f32,
                             device=device) if needs_scales(rd) else None)
        return scales, torch.zeros((spec.padded,), dtype=f32, device=device)
    gt = spec.group_table()
    scales = (tuple(torch.ones((window, spec.group_scale_blocks(g)),
                               dtype=f32, device=device) for g in gt)
              if needs_scales(rd) else None)
    return scales, tuple(torch.zeros((g.padded,), dtype=f32, device=device)
                         for g in gt)


# ------------------------------------------- layout (de)serialization


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def spec_to_json(spec: PackSpec) -> str:
    """The layout as the reference's JSON string, character for
    character: its keys in its order, each leaf a row ``[offset, size,
    shape, dtype name, shard_dim, group, tiles]``, ``groups`` rows
    ``[shards, axes, seg_len, offset]`` for a grouped layout, and
    ``ring_dtype`` only when it is not f32."""
    d = {"align": spec.align, "shards": spec.shards, "axes": list(spec.axes),
         "size": spec.size, "padded": spec.padded,
         "leaves": [[ls.offset, ls.size, list(ls.shape),
                     _dtype_name(ls.dtype), ls.shard_dim, ls.group,
                     [list(t) for t in ls.tiles] if ls.tiles is not None
                     else None] for ls in spec.leaves]}
    if spec.groups:
        d["groups"] = [[g.shards, list(g.axes), g.seg_len, g.offset]
                       for g in spec.groups]
    if spec.ring_dtype != "float32":
        d["ring_dtype"] = spec.ring_dtype
    return json.dumps(d)


def spec_from_json(s: str) -> PackSpec:
    """A layout written by :func:`spec_to_json` in either package (rows
    written before the grouped layout existed have five columns). The
    result has no treedef."""
    d = json.loads(s)
    leaves = []
    for row in d["leaves"]:
        o, n, shape, dt, shard_dim = row[:5]
        group = row[5] if len(row) > 5 else 0
        tiles = row[6] if len(row) > 6 else None
        leaves.append(LeafSpec(
            offset=o, size=n, shape=tuple(shape), dtype=getattr(torch, dt),
            shard_dim=shard_dim, group=group,
            tiles=tuple(tuple(t) for t in tiles) if tiles is not None
            else None))
    groups = tuple(PackGroup(shards=gs, axes=tuple(ax), seg_len=sl,
                             offset=go)
                   for gs, ax, sl, go in d.get("groups", []))
    return PackSpec(treedef=None, leaves=tuple(leaves), size=d["size"],
                    padded=d["padded"], align=d["align"],
                    shards=d["shards"], axes=tuple(d["axes"]),
                    groups=groups,
                    ring_dtype=d.get("ring_dtype", "float32"))
