"""Tree checkpoints in ``.npz`` files, in the reference's format
(counterpart of ``repro.checkpoint.io``): a file either package writes,
the other reads.

A file holds ``leaf_<i>`` arrays in flatten order and three metadata
arrays: ``__keys__``, the JSON list of each leaf's key path (JAX's key
strings joined by ``|``: a dict key, a list index, ``.field`` of a
registered dataclass; ``common.pytree.tree_flatten_with_path``),
``__dtypes__``, the JSON list of their dtype names, and ``__treedef__``,
a description of the structure that neither reader uses. numpy has no
bf16 or fp8 types, so those leaves are stored as ``uint16``/``uint8``
views of their bits under their true name (``bfloat16``,
``float8_e4m3fn``); the port needs no package that defines them.
Writes are atomic: a unique temporary file, fsync, rename, then fsync of
the directory.

The packed slide-window state (``core.offline.WindowState``) is saved
as a tree plus its layout as JSON (``common.packing.spec_to_json``), and
loads in three cases, each bit-exact (packing never touches values):

  1. stored layout == template layout   -> direct load;
  2. stored layout != template layout   -> repack into the template's;
  3. a pre-packing checkpoint (one ring/total leaf PER PARAMETER)
     -> migrated by packing the stored leaves into the template layout.

A template whose ring dtype differs from the stored one migrates the
precision (decode, repack, re-encode; see :func:`load_window_state`).
A grouped layout's window state holds per-group buffer tuples at run
time; on disk it is always the one logical buffer (the groups' ranges
end to end), merged on save and split on load, as the reference does.
"""
from __future__ import annotations

import json
import os
import uuid
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.common.packing import (pack_leaves, repack,
                                        spec_from_json, spec_to_json,
                                        split_groups)
from repro_torch.common.pytree import (sum_axis0_f32,
                                       tree_flatten_with_path,
                                       tree_unflatten)
from repro_torch.common.quant import decode_slot, encode_slot

_SEP = "|"

#: narrow float dtypes numpy lacks: name -> (stored bits, torch dtype)
_VIEW = {"bfloat16": (np.uint16, torch.bfloat16),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
         "float8_e5m2": (np.uint8, torch.float8_e5m2)}


def _keystr(path) -> str:
    return _SEP.join(path)


def _to_stored(leaf) -> tuple[np.ndarray, str]:
    """(the array written to the file, the leaf's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        name = str(t.dtype).removeprefix("torch.")
        if name in _VIEW:
            bits = torch.int16 if t.element_size() == 2 else torch.uint8
            return t.view(bits).numpy().view(_VIEW[name][0]), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def crc_records(keys, dtypes, arrays) -> dict[str, dict]:
    """Per-array integrity records of stored arrays, keyed ``"i:key"``:
    the CRC32 of the logical bytes (a bf16 leaf's bits whether read as
    bf16 or as uint16), the logical dtype name and the shape, what both
    packages' checkpoint manifests record."""
    out: dict[str, dict] = {}
    for i, (key, name, arr) in enumerate(zip(keys, dtypes, arrays)):
        a = np.ascontiguousarray(arr)
        out[f"{i}:{key}"] = {
            "crc32": zlib.crc32(a.reshape(-1).view(np.uint8)) & 0xFFFFFFFF,
            "dtype": name,
            "shape": list(a.shape),
        }
    return out


def save_pytree(path: str, tree: Any) -> dict[str, dict]:
    """Write ``tree`` to ``path`` atomically; returns the
    :func:`crc_records` of the arrays written."""
    flat, treedef = tree_flatten_with_path(tree)
    arrays, keys, dtypes = {}, [], []
    for i, (kpath, leaf) in enumerate(flat):
        arr, name = _to_stored(leaf)
        arrays[f"leaf_{i}"] = arr
        dtypes.append(name)
        keys.append(_keystr(kpath))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    # a unique tmp name: a fixed one collides under concurrent writers;
    # fsync before the rename, or a crash right after it can publish a
    # name pointing at unflushed data
    tmp = f"{path}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, __keys__=np.asarray(json.dumps(keys)),
                     __dtypes__=np.asarray(json.dumps(dtypes)),
                     __treedef__=np.asarray(str(treedef)), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(os.path.abspath(path)))
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
    return crc_records(keys, dtypes, arrays.values())


def _fsync_dir(dirname: str) -> None:
    """Make a completed rename durable (the entry lives in the directory).
    Best effort: not every platform opens a directory."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _read_stored(path: str) -> tuple[list, list, list]:
    """(keys, dtype names, arrays as stored: bf16/fp8 as their bits)."""
    with np.load(path, allow_pickle=False) as data:
        keys = json.loads(str(data["__keys__"]))
        dtypes = json.loads(str(data["__dtypes__"]))
        arrays = [data[f"leaf_{i}"] for i in range(len(dtypes))]
    return keys, dtypes, arrays


def _to_leaf(arr: np.ndarray, name: str):
    """A stored array as a CPU tensor of its true dtype (numpy for a
    non-numeric array, such as a layout's JSON string)."""
    if name in _VIEW:
        bits = np.int16 if arr.dtype.itemsize == 2 else np.uint8
        return torch.from_numpy(arr.view(bits)).view(_VIEW[name][1])
    if arr.dtype.kind in "biuf":
        return torch.from_numpy(arr)
    return arr


def _read_raw(path: str) -> tuple[list, list]:
    """(keys, leaves) exactly as stored, the bit views undone: CPU
    tensors, or numpy arrays for non-numeric leaves."""
    keys, dtypes, arrays = _read_stored(path)
    return keys, [_to_leaf(a, n) for a, n in zip(arrays, dtypes)]


def _like(leaf, tmpl):
    """A loaded leaf in the template leaf's dtype (and device)."""
    if isinstance(tmpl, torch.Tensor):
        return leaf.to(device=tmpl.device, dtype=tmpl.dtype)
    if isinstance(leaf, torch.Tensor):
        return leaf.numpy().astype(np.asarray(tmpl).dtype)
    return np.asarray(leaf).astype(np.asarray(tmpl).dtype)


def load_pytree(path: str, like: Any) -> Any:
    """Load into the structure of ``like`` (checked against the stored
    keys and shapes); each leaf takes the template leaf's dtype and
    device."""
    keys, leaves = _read_raw(path)
    flat, treedef = tree_flatten_with_path(like)
    if len(flat) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, "
                         f"template has {len(flat)}")
    for (kpath, tmpl), key, leaf in zip(flat, keys, leaves):
        if _keystr(kpath) != key:
            raise ValueError(f"leaf mismatch: {key} vs {_keystr(kpath)}")
        if tuple(tmpl.shape) != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{tuple(leaf.shape)} vs {tuple(tmpl.shape)}")
    return tree_unflatten(treedef, [_like(l, t) for (_, t), l
                                    in zip(flat, leaves)])


# ------------------------------------------------- packed WA window state


def save_window_state(path: str, state: Any) -> dict[str, dict]:
    """Save a packed WindowState: ring/total buffers (and a compressed
    ring's ``comp`` and ``scales``), the counters, and the packed layout
    (so that a different layout can repack on load)."""
    ring, total, comp, scales = (state.ring, state.total, state.comp,
                                 state.scales)
    if state.spec is not None:
        # a grouped window's per-group tuples as the one logical buffer;
        # the groups' scale blocks line up with it (ALIGN multiples)
        ring, total, comp, scales = (
            None if x is None else
            x if not isinstance(x, tuple) else torch.cat(x, dim=-1)
            for x in (ring, total, comp, scales))
    tree = {"ring": ring, "total": total,
            "count": state.count, "next_idx": state.next_idx}
    if comp is not None:
        tree["comp"] = comp
    if scales is not None:
        tree["scales"] = scales
    if state.spec is not None:
        tree["spec_json"] = np.asarray(spec_to_json(state.spec))
    return save_pytree(path, tree)


def load_wa_snapshot(path: str):
    """W̿ for the serving tier: (packed f32 CPU buffer, PackSpec) straight
    from a window-state checkpoint, with NO template; the serving
    publisher repacks it into its own layout
    (``serve.publish.WeightPublisher``). A ring checkpoint stores the
    running sum (divided here by count); a streaming one the mean."""
    keys, leaves = _read_raw(path)
    tree = dict(zip(keys, leaves))
    if "spec_json" not in tree:
        raise ValueError(f"{path}: not a layout-described window-state "
                         f"checkpoint (keys: {keys})")
    spec = spec_from_json(str(tree["spec_json"]))
    total = tree["total"].to(torch.float32)
    if tuple(total.shape) != (spec.padded,):
        raise ValueError(f"{path}: packed total {tuple(total.shape)} does "
                         f"not match its stored layout ({spec.padded})")
    if "ring" in tree:
        total = total / max(int(tree["count"]), 1)   # ring: running sum
    return total, spec


def _split_scale_groups(scales, spec):
    """Per-group views of an fp8 scale buffer ``(..., padded // align)``:
    group ranges are ALIGN multiples, so their blocks line up."""
    return tuple(scales[..., g.offset // spec.align:
                        (g.offset + g.padded) // spec.align]
                 for g in spec.group_table())


def load_window_state(path: str, like: Any) -> Any:
    """Load a WindowState saved by :func:`save_window_state` (in either
    package) into the packed layout of ``like``, a WindowState template
    whose ``spec`` fixes offsets and treedef and whose buffers fix the
    device: repacking across layout changes, or migrating an old per-leaf
    checkpoint. A template holding per-group tuples (a grouped layout)
    gets per-group tuples back.

    **Precision migration.** The template's ring dtype wins. When it
    matches the stored ring (and, for fp8, the stored layout), the load
    is bit-exact: compressed rings travel as their bits. When it differs
    (an f32 checkpoint into a bf16 or fp8 window, or back), the stored
    ring is DECODED to f32, repacked, and re-encoded slot by slot in the
    template's dtype (fp8 scales as the reference computes them here,
    amax/448); the running total is then recomputed as the sum of the
    re-encoded slots and the Kahan compensation reset to zero, so that
    later evictions subtract exactly the bits a slot stores."""
    from repro_torch.core.offline import WindowState

    keys, leaves = _read_raw(path)
    spec = like.spec
    grouped = isinstance(like.total, tuple)
    dev = (like.total[0] if grouped else like.total).device
    by_group: dict[str, list] = {}
    for key, leaf in zip(keys, leaves):
        group, _, subkey = key.partition(_SEP)
        by_group.setdefault(group, []).append((subkey, leaf))

    stored_spec = None
    if "spec_json" in by_group:
        stored_spec = spec_from_json(str(by_group.pop("spec_json")[0][1]))

    # the key path of each packed leaf: a per-leaf migration matches the
    # stored keys against them (two same-shape leaves must not swap)
    dummy = tree_unflatten(spec.treedef, [0] * spec.n_leaves)
    expected_keys = [_keystr(p) for p, _ in tree_flatten_with_path(dummy)[0]]

    def grab(group):
        if group not in by_group:
            raise ValueError(f"window-state checkpoint missing '{group}' "
                             f"(stored keys: {keys})")
        return by_group[group]

    def restore(items, lead: tuple, dtype):
        if len(items) == 1:
            arr = items[0][1].to(dev)
            if stored_spec is not None and not spec.same_layout(stored_spec):
                if tuple(arr.shape) != lead + (stored_spec.padded,):
                    raise ValueError(f"packed buffer {tuple(arr.shape)} "
                                     f"does not match its stored layout "
                                     f"({stored_spec.padded})")
                return repack(arr.to(dtype), stored_spec, spec)
            if tuple(arr.shape) == lead + (spec.padded,):
                return arr.to(dtype)                  # layout unchanged
            raise ValueError(f"packed buffer shape {tuple(arr.shape)} does "
                             f"not match template "
                             f"({lead + (spec.padded,)})")
        # migration: one stored leaf per parameter, in flatten order
        if len(items) != spec.n_leaves:
            raise ValueError(
                f"cannot migrate: checkpoint has {len(items)} leaves, "
                f"packed template expects {spec.n_leaves} (or 1 packed)")
        parts = []
        for (subkey, arr), ls, want in zip(items, spec.leaves,
                                           expected_keys):
            if subkey != want:
                raise ValueError(f"migration key mismatch: stored leaf "
                                 f"'{subkey}' where template expects "
                                 f"'{want}'")
            if tuple(arr.shape) != lead + ls.shape:
                raise ValueError(f"migration shape mismatch: "
                                 f"{tuple(arr.shape)} vs {lead + ls.shape}")
            parts.append(arr.to(dev, torch.float32))
        return pack_leaves(parts, spec, n_lead=len(lead)).to(dtype)

    def split(x):
        return split_groups(x, spec) if grouped and x is not None else x

    count = grab("count")[0][1].to(dev, torch.int32)
    next_idx = grab("next_idx")[0][1].to(dev, torch.int32)
    if like.ring is None:                                      # streaming
        return WindowState(ring=None,
                           total=split(restore(grab("total"), (),
                                               torch.float32)),
                           count=count, next_idx=next_idx,
                           window=like.window, kind=like.kind, spec=spec)

    rd = (like.ring[0] if grouped else like.ring).dtype
    items = grab("ring")
    # per-leaf (pre-packing) checkpoints only ever stored f32
    stored_rd = items[0][1].dtype if len(items) == 1 else torch.float32
    stored_scales = by_group.get("scales")
    layout_same = stored_spec is None or spec.same_layout(stored_spec)

    if stored_rd == rd and (stored_scales is None or layout_same):
        ring = restore(items, (like.window,), rd)
        total = restore(grab("total"), (), torch.float32)
        comp = scales = None
        if like.comp is not None:
            comp = (restore(by_group["comp"], (), torch.float32)
                    if "comp" in by_group else torch.zeros_like(total))
        if like.scales is not None:
            if stored_scales is None:
                raise ValueError("fp8 window template but the checkpoint "
                                 "stores no 'scales'")
            scales = stored_scales[0][1].to(dev, torch.float32)
            if grouped:
                scales = _split_scale_groups(scales, spec)
        return WindowState(ring=split(ring), total=split(total),
                           count=count, next_idx=next_idx,
                           window=like.window, kind=like.kind, spec=spec,
                           comp=split(comp), scales=scales)

    # ---- precision migration: decode -> repack (f32) -> re-encode
    if grouped:
        raise ValueError("precision migration into a GROUPED window "
                         "layout is unsupported: load under the stored "
                         "ring dtype (or f32) and let the next syncs "
                         "refill the window")
    if len(items) == 1 and stored_scales is not None:
        # an fp8 checkpoint: decode under the STORED layout first (its
        # scales describe the stored blocks), then repack
        arr = items[0][1].to(dev)
        s_spec = stored_spec if stored_spec is not None else spec
        if tuple(arr.shape) != (like.window, s_spec.padded):
            raise ValueError(f"packed fp8 ring {tuple(arr.shape)} does not "
                             f"match its stored layout ({s_spec.padded})")
        f32_ring = decode_slot(arr, stored_scales[0][1].to(dev,
                                                           torch.float32))
        if not layout_same:
            f32_ring = repack(f32_ring, stored_spec, spec)
    else:
        f32_ring = restore(items, (like.window,), torch.float32)
    ring, scales = encode_slot(f32_ring, rd, divide=True)
    # the running total is the sum of the re-encoded slots (unfilled
    # slots are zeros), added in the reference's order
    total = sum_axis0_f32(decode_slot(ring, scales))
    comp = torch.zeros_like(total) if like.comp is not None else None
    if like.scales is None:
        scales = None
    return WindowState(ring=ring, total=total, count=count,
                       next_idx=next_idx, window=like.window,
                       kind=like.kind, spec=spec, comp=comp, scales=scales)
