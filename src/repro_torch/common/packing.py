"""Parameter packing: a parameter tree as ONE flat, ALIGN-padded buffer.

Counterpart of ``repro.common.packing``, single-device layout only
(``shards == 1``, no groups). The WA state (ring, total) lives in this
layout for the whole run, so one sync is one kernel launch over the
whole parameter set however many leaves the tree has. Leaves are laid
out in JAX's flatten order (``common.pytree``) at the same offsets, and
the tail is zero-padded to a multiple of :data:`ALIGN`, so a packed
buffer is byte-equal to the reference's. Packing copies values and
never computes with them: any elementwise update of the buffer is
bit-identical to the same update applied leaf by leaf.

A spec also names the storage dtype of the WA ring laid out by it
(``ring_dtype``: precision metadata, not layout) and, for an fp8 ring,
its number of per-block scales. :func:`spec_to_json` writes a layout in
the reference's JSON form (checkpoints store it beside the buffers) and
:func:`spec_from_json` reads it back; :func:`repack` moves a buffer
between two single-device layouts of one leaf set. The mesh-native sync
(``launch.sync``) keeps this layout: a rank holds one whole replica. The
sharded and grouped layouts (``shards > 1``, ``groups``) come with a
data or model axis inside a replica, ROADMAP.md Queue A 16: a stored
record of one raises.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Sequence

import torch

from repro_torch.common.pytree import tree_flatten, tree_unflatten

PyTree = Any

#: what a sharded or grouped layout waits for
MESH_ITEM = ("ROADMAP.md Queue A 16 (a data or model axis inside a "
             "replica: --tp, --fsdp and their packed layouts)")

# The reference's packed alignment (one (8, 1024) f32 tile): kept so the
# two packages lay a tree out identically. The CUDA sync kernel needs only
# P % 4 == 0 (float4 loads), which this implies.
ALIGN = 8 * 1024


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Placement of one leaf inside the packed buffer."""
    offset: int
    size: int
    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Where every leaf of a tree lives in its packed buffer. ``treedef``
    is None for a spec read back from a checkpoint's JSON: it supports
    the leaf-level operations (:func:`pack_leaves`, :func:`repack`) but
    not the tree-level ones."""
    treedef: Any
    leaves: tuple[LeafSpec, ...]
    size: int          # real elements
    padded: int        # buffer length, an ``align`` multiple
    align: int = ALIGN
    ring_dtype: str = "float32"   # WA ring storage dtype (not layout)

    @property
    def n_leaves(self) -> int:
        return len(self.leaves)

    @property
    def pad_waste(self) -> float:
        return 1.0 - self.size / self.padded

    @property
    def scale_blocks(self) -> int:
        """fp8 scales per ring row: one per ``align`` block."""
        return self.padded // self.align

    def same_layout(self, other: "PackSpec") -> bool:
        """Layout equality ignoring the treedef (a spec read from JSON
        has none) and ``ring_dtype`` (precision, not layout). Every spec
        of the port has one shard and no groups, the reference's other
        two terms."""
        return (self.leaves == other.leaves and self.padded == other.padded
                and self.align == other.align)

    def with_ring_dtype(self, dtype) -> "PackSpec":
        """This layout with its WA ring precision set (a dtype or a
        ``f32``/``bf16``/``fp8`` token); the layout is untouched."""
        from repro_torch.common.quant import wa_dtype
        name = str(wa_dtype(dtype)).removeprefix("torch.")
        if name == self.ring_dtype:
            return self
        return dataclasses.replace(self, ring_dtype=name)


def pack_spec(tree: PyTree, align: int = ALIGN) -> PackSpec:
    """The packed layout of ``tree`` (tensors; only shapes and dtypes are
    read)."""
    flat, treedef = tree_flatten(tree)
    leaves, offset = [], 0
    for leaf in flat:
        size = leaf.numel()
        leaves.append(LeafSpec(offset=offset, size=size,
                               shape=tuple(leaf.shape), dtype=leaf.dtype))
        offset += size
    padded = max(align, -(-offset // align) * align)
    return PackSpec(treedef=treedef, leaves=tuple(leaves), size=offset,
                    padded=padded, align=align)


def pack_leaves(flat: Sequence[torch.Tensor], spec: PackSpec,
                dtype=torch.float32, n_lead: int = 0) -> torch.Tensor:
    """Pack already-flattened leaves (``n_lead`` shared leading dims per
    leaf, e.g. the K of :func:`pack_stacked`). Each leaf is copied once
    into its slice of one preallocated buffer; the pad tail is zero."""
    if len(flat) != spec.n_leaves:
        raise ValueError(f"{len(flat)} leaves for a spec of {spec.n_leaves}")
    lead = tuple(flat[0].shape[:n_lead]) if flat else ()
    device = flat[0].device if flat else None
    buf = torch.empty(lead + (spec.padded,), dtype=dtype, device=device)
    for leaf, ls in zip(flat, spec.leaves):
        if tuple(leaf.shape[n_lead:]) != ls.shape:
            raise ValueError(f"leaf shape {tuple(leaf.shape)} != spec "
                             f"{ls.shape}")
        buf[..., ls.offset:ls.offset + ls.size].copy_(
            leaf.detach().reshape(lead + (ls.size,)))
    buf[..., spec.size:].zero_()
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


def unpack(buf: torch.Tensor, spec: PackSpec, like: PyTree | None = None
           ) -> PyTree:
    """Slice the packed buffer back into leaves (leading dims of ``buf``
    kept). Dtypes come from ``like`` when given, else from the spec. A
    leaf whose dtype is the buffer's is a view of ``buf``, not a copy."""
    like_flat = None
    if like is not None:
        like_flat, treedef = tree_flatten(like)
        if treedef != spec.treedef:
            raise ValueError("``like`` does not match the PackSpec")
    lead = tuple(buf.shape[:-1])
    leaves = []
    for i, ls in enumerate(spec.leaves):
        dt = like_flat[i].dtype if like_flat is not None else ls.dtype
        x = buf[..., ls.offset:ls.offset + ls.size].reshape(lead + ls.shape)
        leaves.append(x.to(dt))
    return tree_unflatten(spec.treedef, leaves)


def repack(buf: torch.Tensor, src: PackSpec, dst: PackSpec) -> torch.Tensor:
    """A packed buffer moved from layout ``src`` to layout ``dst`` of the
    same leaf set, leading dims kept (bit-exact: packing never touches
    values)."""
    if tuple(l.shape for l in src.leaves) != \
            tuple(l.shape for l in dst.leaves):
        raise ValueError("repack: leaf shapes differ between layouts")
    lead = tuple(buf.shape[:-1])
    leaves = [buf[..., ls.offset:ls.offset + ls.size].reshape(
        lead + ls.shape) for ls in src.leaves]
    return pack_leaves(leaves, dst, buf.dtype, n_lead=len(lead))


def split_groups(buf, spec: PackSpec):
    raise NotImplementedError(f"grouped layouts are not ported yet: "
                              f"{MESH_ITEM}")


def merge_groups(parts, spec: PackSpec):
    raise NotImplementedError(f"grouped layouts are not ported yet: "
                              f"{MESH_ITEM}")


# ------------------------------------------- layout (de)serialization


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def spec_to_json(spec: PackSpec) -> str:
    """The layout as the reference's JSON string, character for
    character: its keys in its order, each leaf a row ``[offset, size,
    shape, dtype name, shard_dim, group, tiles]`` (here always ``null,
    0, null``), and ``ring_dtype`` only when it is not f32."""
    d = {"align": spec.align, "shards": 1, "axes": [], "size": spec.size,
         "padded": spec.padded,
         "leaves": [[ls.offset, ls.size, list(ls.shape),
                     _dtype_name(ls.dtype), None, 0, None]
                    for ls in spec.leaves]}
    if spec.ring_dtype != "float32":
        d["ring_dtype"] = spec.ring_dtype
    return json.dumps(d)


def spec_from_json(s: str) -> PackSpec:
    """A layout written by :func:`spec_to_json` in either package (rows
    written before the grouped layout existed have five columns). The
    result has no treedef. A sharded or grouped layout raises."""
    d = json.loads(s)
    if d.get("shards", 1) != 1 or d.get("groups"):
        raise NotImplementedError(
            f"a sharded or grouped packed layout (shards "
            f"{d.get('shards')}, {len(d.get('groups', []))} groups) is not "
            f"ported yet: {MESH_ITEM}")
    leaves = []
    for row in d["leaves"]:
        o, n, shape, dt, shard_dim = row[:5]
        group = row[5] if len(row) > 5 else 0
        tiles = row[6] if len(row) > 6 else None
        if shard_dim is not None or group or tiles:
            raise NotImplementedError(f"a sharded leaf placement is not "
                                      f"ported yet: {MESH_ITEM}")
        leaves.append(LeafSpec(offset=o, size=n, shape=tuple(shape),
                               dtype=getattr(torch, dt)))
    return PackSpec(treedef=None, leaves=tuple(leaves), size=d["size"],
                    padded=d["padded"], align=d["align"],
                    ring_dtype=d.get("ring_dtype", "float32"))
