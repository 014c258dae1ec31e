"""The port's sharding of a replica over data and model axes against the
JAX package, on the CPU, with no process spawned:

- ``sharding.rules``: ``make_tp_rules`` and ``spec_for_dims`` give the
  reference's spec of every leaf of the LM configs over the meshes
  (replica, data, model) = (2, 2, 2), (2, 1, 2), (2, 2, 1) and (pod 2,
  replica 1, data 2, model 2), with and without FSDP; ``param_dims``
  equals the reference's ``lm.abstract()[1]``, leaf for leaf. The
  reference's rule functions read only ``mesh.shape``, so a stand-in
  object serves them.
- the layout chooser (``choose_resident_spec``) picks the reference's
  layout, JSON character for character, single range or grouped;
- sharded and grouped ``PackSpec``s: ``pack``/``unpack``, the local view,
  ``split_groups``/``merge_groups``, ``repack`` and the JSON, each
  0-difference from ``repro.common.packing`` on the same values (made
  with numpy from a seed);
- window-state checkpoints of a grouped layout both ways: written by the
  reference's ``save_window_state``, loaded by the port into per-group
  buffers, and back.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio
from repro.common import packing as jpk
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.offline import WindowState as JaxWindowState
from repro.launch.sync.packed import choose_resident_spec as jax_choose
from repro.models.registry import build_model as jax_build_model
from repro.sharding.rules import make_tp_rules as jax_rules
from repro_torch.checkpoint import io
from repro_torch.common import packing as pk
from repro_torch.common.pytree import tree_flatten
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core.offline import WindowState
from repro_torch.launch.sync.packed import choose_resident_spec
from repro_torch.models.registry import build_model, param_dims
from repro_torch.sharding.rules import flatten_dims, make_tp_rules
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LM_ARCHS = ["granite-3-2b", "gemma2-27b", "stablelm-12b", "command-r-35b",
            "granite-moe-1b-a400m", "qwen2-moe-a2.7b", "xlstm-125m",
            "hymba-1.5b"]

MESHES = {
    "2x2x2": ({"replica": 2, "data": 2, "model": 2}, "replica"),
    "2x1x2": ({"replica": 2, "data": 1, "model": 2}, "replica"),
    "2x2x1": ({"replica": 2, "data": 2, "model": 1}, "replica"),
    "tree": ({"pod": 2, "replica": 1, "data": 2, "model": 2},
             ("pod", "replica")),
}


def _stand_in(shape):
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _jax_abstract(cfg_jax):
    return jax_build_model(cfg_jax).abstract()


def _jax_flat_dims(dims):
    return jax.tree.leaves(dims, is_leaf=lambda t: isinstance(t, tuple)
                           and all(isinstance(e, (str, type(None)))
                                   for e in t))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_dims_match_reference(arch):
    """The dims tree of the published and the smoke config, leaf for leaf
    in the flatten order the packing uses, with the reference's shapes."""
    from repro.configs import get_config as jax_config
    for port_cfg, jcfg in ((get_smoke_config(arch), jax_smoke_config(arch)),
                           (get_config(arch), jax_config(arch))):
        shapes, dims = _jax_abstract(jcfg)
        abs_params, pdims = build_model(port_cfg).abstract()
        assert pdims == param_dims(port_cfg)
        assert flatten_dims(pdims) == _jax_flat_dims(dims)
        flat, _ = tree_flatten(abs_params)
        assert [tuple(x.shape) for x in flat] == \
            [tuple(s.shape) for s in jax.tree.leaves(shapes)]
        assert all(x.device.type == "meta" for x in flat)


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("fsdp", [False, True])
def test_rules_and_layout_match_reference(mesh_name, fsdp):
    """Every leaf's spec, and the layout the chooser picks from them
    (its JSON, character for character), for the eight LM configs at
    smoke size, and granite-3-2b and qwen2-moe at their published
    widths."""
    shape, rep = MESHES[mesh_name]
    exclude = (rep,) if isinstance(rep, str) else rep
    cases = [(get_smoke_config(a), jax_smoke_config(a)) for a in LM_ARCHS]
    from repro.configs import get_config as jax_config
    cases += [(get_config(a), jax_config(a))
              for a in ("granite-3-2b", "qwen2-moe-a2.7b")]
    n_grouped = 0
    for port_cfg, jcfg in cases:
        jshapes, jdims = _jax_abstract(jcfg)
        jr = jax_rules(_stand_in(shape), replica_axis=rep, fsdp=fsdp)
        abs_params, pdims = build_model(port_cfg).abstract()
        pr = make_tp_rules(shape, replica_axis=rep, fsdp=fsdp)
        assert pr.rules == jr.rules
        flat, _ = tree_flatten(abs_params)
        shapes = [tuple(x.shape) for x in flat]
        specs = pr.flat_specs(shapes, pdims)
        jspecs = [jr.spec(d, s.shape) for d, s in
                  zip(_jax_flat_dims(jdims), jax.tree.leaves(jshapes))]
        assert specs == [tuple(s) for s in jspecs]
        spec = choose_resident_spec(shape, abs_params, specs, shapes,
                                    exclude=exclude)
        jspec = jax_choose(_stand_in(shape), jshapes, jspecs, shapes,
                           exclude=exclude)
        assert pk.spec_to_json(spec) == jpk.spec_to_json(jspec)
        assert pk.spec_to_json(spec.local_spec()) == \
            jpk.spec_to_json(jspec.local_spec())
        n_grouped += spec.is_grouped
    if fsdp and shape.get("data", 1) > 1 and shape["model"] > 1:
        assert n_grouped        # FSDP's mixed tilings reach the groups


def _rand_tree(seed):
    """numpy leaves of mixed shapes and dtypes, handed to both packages."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"a": f(4, 6), "b": f(8), "c": [f(2, 4, 6), f(4, 4)],
            "d": f(6, 2, 4)}


def _both(tree):
    jt = jax.tree.map(jnp.asarray, tree)
    pt = jax.tree.map(lambda x: torch.from_numpy(x.copy()), tree)
    return jt, pt


LAYOUTS = {
    "sharded": dict(shards=2, shard_dims=[0, None, 1, 0, 2],
                    axes=("model",)),
    "grouped": dict(placements=[((0, ("data",)),), (),
                                ((1, ("data",)), (2, ("model",))),
                                ((0, ("model",)),),
                                ((0, ("data",)), (1, ("model",)))],
                    axis_sizes={"data": 2, "model": 2}),
}


def _specs(name, jt, pt):
    kw = LAYOUTS[name]
    if name == "grouped":
        return (jpk.pack_spec_grouped(jt, align=16, **kw),
                pk.pack_spec_grouped(pt, align=16, **kw))
    return jpk.pack_spec(jt, align=16, **kw), pk.pack_spec(pt, align=16, **kw)


def _eq(j, p):
    return np.array_equal(np.asarray(j), p.numpy())


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_sharded_and_grouped_packing_match_reference(name):
    jt, pt = _both(_rand_tree(0))
    jspec, pspec = _specs(name, jt, pt)
    assert pk.spec_to_json(pspec) == jpk.spec_to_json(jspec)
    back = pk.spec_from_json(jpk.spec_to_json(jspec))
    assert back.same_layout(pspec) and pk.spec_to_json(back) == \
        jpk.spec_to_json(jspec)
    assert jpk.spec_from_json(pk.spec_to_json(pspec)).same_layout(jspec)
    jb, pb = jpk.pack(jt, jspec), pk.pack(pt, pspec)
    assert _eq(jb, pb)
    for x, y in zip(jax.tree.leaves(jpk.unpack(jb, jspec)),
                    tree_flatten(pk.unpack(pb, pspec))[0]):
        assert _eq(x, y)
    # stacked rows (a ring's I) and the local view of each segment
    rows = np.stack([np.asarray(jb), np.asarray(jb) * 2])
    assert _eq(jpk.repack(jnp.asarray(rows), jspec, jpk.pack_spec(
        jt, align=16)), pk.repack(torch.from_numpy(rows), pspec,
                                  pk.pack_spec(pt, align=16)))
    for jg, pg in zip(jpk.split_groups(jb, jspec),
                      pk.split_groups(pb, pspec)):
        assert _eq(jg, pg)
    assert torch.equal(pk.merge_groups(pk.split_groups(pb, pspec), pspec),
                       pb)
    assert pk.spec_to_json(pspec.local_spec()) == \
        jpk.spec_to_json(jspec.local_spec())
    assert pspec.is_sharded and pspec.n_groups == jspec.n_groups


def test_local_segments_pack_from_local_blocks():
    """A rank's blocks packed in ``local_spec()`` are its segments of
    every group of the global buffer (the zero-collective invariant)."""
    from repro_torch.launch.shards import assemble, segment_of
    from repro_torch.models.parallel import LeafPlace, blocks_of
    jt, pt = _both(_rand_tree(1))
    _, spec = _specs("grouped", jt, pt)
    pl = LAYOUTS["grouped"]["placements"]
    flat, treedef = tree_flatten(pt)
    from repro_torch.common.pytree import tree_unflatten
    places = tree_unflatten(treedef, [
        LeafPlace(tuple(dict(p).get(i) for i in range(x.dim())),
                  (None,) * x.dim()) for x, p in zip(flat, pl)])
    shape = {"data": 2, "model": 2}

    class Mesh:
        world = 4
        def __init__(self):
            self.shape = shape
        def coords(self, r=None):
            return {"data": r // 2, "model": r % 2}
        def size(self, axes):
            return int(np.prod([shape[a] for a in axes]))
    mesh = Mesh()
    glob = pk.pack(pt, spec)
    lspec = spec.local_spec()
    bufs = []
    for r in range(4):
        local = blocks_of(pt, places, mesh, r)
        bufs.append(pk.pack(local, lspec))
        assert torch.equal(bufs[-1], segment_of(glob, spec, mesh, r))
    assert torch.equal(assemble(bufs, spec, mesh, 0), glob)


def _jax_grouped_window(ring_dtype, I=3):
    jt, pt = _both(_rand_tree(2))
    jspec, pspec = _specs("grouped", jt, pt)
    rng = np.random.default_rng(3)
    rd = jnp.dtype(ring_dtype)
    ring, total = jpk.window_buffers(jspec, I, rd)
    scales, comp = jpk.window_aux_buffers(jspec, I, rd)
    rnd = lambda x, dt: jnp.asarray(rng.standard_normal(x.shape)
                                    .astype(np.float32)).astype(dt)
    ring = tuple(rnd(r, rd) for r in ring)
    total = tuple(rnd(t, jnp.float32) for t in total)
    comp = None if comp is None else tuple(rnd(c, jnp.float32)
                                           for c in comp)
    if scales is not None:
        scales = tuple(jnp.abs(rnd(s, jnp.float32)) for s in scales)
    spec = jspec if rd == jnp.float32 else jspec.with_ring_dtype(rd)
    ws = JaxWindowState(ring=ring, total=total, count=jnp.int32(2),
                        next_idx=jnp.int32(2), window=I, kind="ring",
                        spec=spec, comp=comp, scales=scales)
    return ws, pspec if rd == jnp.float32 else \
        pspec.with_ring_dtype(str(rd))


def _bits(x):
    x = x.detach().contiguous()
    return x.view(torch.uint8).numpy() if x.dtype.itemsize == 1 else \
        x.view(torch.int16 if x.dtype.itemsize == 2 else torch.int32).numpy()


@pytest.mark.parametrize("ring", ["float32", "bfloat16", "float8_e4m3fn"])
def test_grouped_window_checkpoint_interop(tmp_path, ring):
    """A grouped window state, per-group tuples at run time, on disk the
    one logical buffer: the reference's file loads into the port's
    per-group template bit for bit, and the port's file into the
    reference's."""
    from repro_torch.common.packing import window_aux_buffers, \
        window_buffers
    jws, pspec = _jax_grouped_window(getattr(jnp, ring))
    path = str(tmp_path / "jax.npz")
    jio.save_window_state(path, jws)
    rd = getattr(torch, ring)
    r, t = window_buffers(pspec, 3, rd)
    s, c = window_aux_buffers(pspec, 3, rd)
    zero = torch.zeros((), dtype=torch.int32)
    like = WindowState(ring=r, total=t, count=zero, next_idx=zero.clone(),
                       window=3, spec=pspec, comp=c, scales=s)
    got = io.load_window_state(path, like)
    for name in ("ring", "total", "comp", "scales"):
        j, p = getattr(jws, name), getattr(got, name)
        assert (j is None) == (p is None)
        if j is None:
            continue
        assert isinstance(p, tuple) and len(p) == len(j)
        for a, b in zip(j, p):
            want = torch.from_numpy(np.array(a.astype(jnp.float32)))
            assert torch.equal(b.float(), want)
    assert int(got.count) == 2 and int(got.next_idx) == 2
    back = str(tmp_path / "port.npz")
    io.save_window_state(back, got)
    jlike = _jax_grouped_window(getattr(jnp, ring))[0]
    jgot = jio.load_window_state(back, jlike)
    for name in ("ring", "total", "comp", "scales"):
        j, p = getattr(jws, name), getattr(jgot, name)
        if j is None:
            continue
        for a, b in zip(j, p):
            assert np.array_equal(np.asarray(a).view(np.uint8),
                                  np.asarray(b).view(np.uint8))
