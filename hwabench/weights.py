"""Seeded weights of a configuration, made by the benchmark itself.

The benchmark draws every weight from ``--seed`` on the device, in the
dtype the model is served and trained in, and hands the same tree to the
program and, widened to f32, to the reference. The tree follows the
layout the configuration's ``layout`` names (``reference/<name>.py``
``param_shapes``); :func:`make_params` checks nothing of the program.

The bf16 leaves are views of one flat buffer filled in pieces of
``PIECE`` elements, each piece from a generator of its own seeded from
(seed, piece): a few large calls, and any piece can be drawn again alone
(:func:`leaf_values`). Each leaf is then scaled by 1/sqrt(fan_in) in
place. f32 matrices (a MoE router) come from a second stream the same
way; norm scales are ones.
"""
from __future__ import annotations

import hashlib
import math

import torch

#: elements of one draw (256 MiB of bf16)
PIECE = 1 << 27


def derive(seed: int, *tags) -> int:
    """A 63-bit seed from ``seed`` and ``tags``: distinct streams for the
    weights, the data and the control, at any seed up to 2**64."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _leaves(tree, prefix=""):
    """(path, spec) of every leaf of a nested dict/list of specs, paths
    sorted as the program flattens a dict (keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def set_leaf(tree, path, value):
    """Put ``value`` at ``path`` (as :func:`leaves_of` names it)."""
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node[int(k)] if isinstance(node, list) else node[k]
    last = keys[-1]
    if isinstance(node, list):
        node[int(last)] = value
    else:
        node[last] = value


def _skeleton(shapes):
    if isinstance(shapes, dict):
        return {k: _skeleton(v) for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_skeleton(v) for v in shapes]
    return None


def _fill(buf, seed, stream, device):
    """Fill ``buf`` (flat) piece by piece from (seed, stream, piece)."""
    for i, start in enumerate(range(0, buf.numel(), PIECE)):
        piece = buf[start:start + PIECE]
        gen = torch.Generator(device=device).manual_seed(
            derive(seed, "weights", stream, i))
        piece.normal_(generator=gen)


def make_params(shapes, seed: int, device, dtype=torch.bfloat16):
    """The weight tree of ``shapes`` (path -> (shape, kind, fan_in) as
    ``param_shapes`` gives them; kind "w" in ``dtype``, "w32" f32, "one"
    f32 ones) drawn from ``seed`` on ``device``."""
    device = torch.device(device)
    leaves = list(_leaves(shapes))
    n = {"w": 0, "w32": 0}
    for _, (shape, kind, _) in leaves:
        if kind in n:
            n[kind] += math.prod(shape)
    bufs = {"w": torch.empty(n["w"], dtype=dtype, device=device),
            "w32": torch.empty(n["w32"], dtype=torch.float32, device=device)}
    for kind, buf in bufs.items():
        _fill(buf, seed, kind, device)
    tree = _skeleton(shapes)
    at = {"w": 0, "w32": 0}
    for path, (shape, kind, fan_in) in leaves:
        if kind == "one":
            set_leaf(tree, path, torch.ones(shape, dtype=torch.float32,
                                            device=device))
            continue
        size = math.prod(shape)
        leaf = bufs[kind][at[kind]:at[kind] + size].view(shape)
        at[kind] += size
        leaf.mul_(1.0 / math.sqrt(fan_in))
        set_leaf(tree, path, leaf)
    return tree


def leaves_of(tree):
    """(path, tensor) of every leaf, in the order of :func:`make_params`."""
    return list(_leaves(tree))


def map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)
