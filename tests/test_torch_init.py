"""The port's weight init draws a leaf a piece at a time.

``models.common.normal_init`` allocates each leaf in the model dtype and
fills it piece by piece: a stacked leaf (n_layers, ...) one layer slice at
a time, and any piece over ``DRAW_ELEMS`` elements in blocks of 16·k rows.
So the f32 transient is one piece, never a whole leaf (command-r-35b's
stacked w_gate is 7.4B elements). A spy on ``torch.randn`` and
``torch.empty`` inside ``models.common`` records every leaf and its draws
while ``init_lm`` builds a smoke config deepened to 8 layers, for the
dense, gemma2, command-r and MoE families, with the default piece size and
with one small enough to split every 2-D piece into row blocks. Each draw
must be f32 and no larger than one layer slice of its leaf; each leaf's
spread must be 1/sqrt(fan_in); and on the CPU the pieces must give the
bits of one whole draw of the leaf, as before the init drew in pieces
(torch fills normals 16 at a time from one uniform stream)."""
import math

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import common
from repro_torch.models.registry import init_lm
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["granite-3-2b", "gemma2-27b", "command-r-35b",
         "granite-moe-1b-a400m", "qwen2-moe-a2.7b"]


class _Spy:
    """Stands in for ``torch`` inside ``models.common``: records each
    leaf ``normal_init`` allocates and each f32 draw it makes."""

    def __init__(self):
        self.leaves = []          # [(leaf tensor, [draw (numel, dtype)])]

    def empty(self, *a, **kw):
        out = torch.empty(*a, **kw)
        self.leaves.append((out, []))
        return out

    def randn(self, *a, **kw):
        out = torch.randn(*a, **kw)
        self.leaves[-1][1].append((out.numel(), out.dtype))
        return out

    def __getattr__(self, name):
        return getattr(torch, name)


def _paths(tree, prefix=()):
    """{id(leaf): key path} of a nested dict of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, prefix + (i,)))
        return out
    return {id(tree): prefix}


def _fan_in(cfg, path):
    """The reference's fan-in of a drawn leaf, by its key path."""
    D, F = cfg.d_model, cfg.d_ff
    Fe = cfg.expert_d_ff or cfg.d_ff
    name = path[-1]
    if name == "wo":
        return cfg.n_heads * cfg.resolved_head_dim
    if name == "w_down":
        return Fe if "moe" in path else F
    if name == "sh_down":
        return cfg.n_shared_experts * Fe
    return D                      # embed, head, wq/wk/wv, w_gate/w_up,
    #                               router, sh_gate/sh_up/sh_route


def _init(arch, monkeypatch, draw_elems):
    cfg = get_smoke_config(arch).with_(n_layers=8)
    if draw_elems is not None:
        monkeypatch.setattr(common, "DRAW_ELEMS", draw_elems)
    spy = _Spy()
    monkeypatch.setattr(common, "torch", spy)
    params = init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    monkeypatch.undo()
    return cfg, params, spy.leaves


@pytest.mark.parametrize("draw_elems", [None, 1000])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_draws_a_layer_slice_at_a_time(arch, draw_elems, monkeypatch):
    cfg, params, leaves = _init(arch, monkeypatch, draw_elems)
    paths = _paths(params)
    assert leaves and all(id(leaf) in paths for leaf, _ in leaves)
    limit = common.DRAW_ELEMS if draw_elems is None else draw_elems
    stacked = 0
    for leaf, draws in leaves:
        shape = tuple(leaf.shape)
        piece = math.prod(shape[1:]) if leaf.dim() >= 3 else leaf.numel()
        row = math.prod(shape[2:]) if leaf.dim() >= 3 else shape[-1]
        assert sum(n for n, _ in draws) == leaf.numel(), paths[id(leaf)]
        for n, dtype in draws:
            assert dtype == torch.float32
            assert n <= piece, (paths[id(leaf)], n, piece)
            assert n <= max(limit, 16 * row), (paths[id(leaf)], n, limit)
        if leaf.dim() >= 3 and draw_elems is None:
            # one draw a layer at the default piece size
            assert len(draws) == shape[0], paths[id(leaf)]
            stacked += 1
    if draw_elems is None:
        assert stacked >= 4
    else:                         # row blocks: more draws than leaves
        assert sum(len(d) for _, d in leaves) > 2 * len(leaves)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_std_is_one_over_sqrt_fan_in(arch, monkeypatch):
    cfg, params, leaves = _init(arch, monkeypatch, None)
    paths = _paths(params)
    for leaf, _ in leaves:
        path = paths[id(leaf)]
        want = 1.0 / math.sqrt(_fan_in(cfg, path))
        got = float(leaf.float().std())
        tol = 0.1 if leaf.numel() >= 1024 else 0.25
        assert abs(got / want - 1.0) < tol, (path, got, want)
        assert abs(float(leaf.float().mean())) < 5 * want / math.sqrt(
            leaf.numel())


@pytest.mark.parametrize("draw_elems", [None, 1000])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_bits_equal_one_whole_draw(arch, draw_elems, monkeypatch):
    """On the CPU, where every piece but the last holds a multiple of 16
    elements (every leaf of these smoke configs), the pieces give the
    bits of ``(randn(shape) * scale).to(dtype)`` drawn whole, leaf after
    leaf from one generator: the init before it drew in pieces."""
    cfg, params, leaves = _init(arch, monkeypatch, draw_elems)
    paths = _paths(params)
    gen = torch.Generator().manual_seed(0)
    for leaf, _ in leaves:
        scale = 1.0 / math.sqrt(_fan_in(cfg, paths[id(leaf)]))
        want = (torch.randn(tuple(leaf.shape), generator=gen,
                            dtype=torch.float32) * scale).to(leaf.dtype)
        assert torch.equal(leaf, want), paths[id(leaf)]
