"""Checkpoint interop of the port with the JAX package, on the CPU: the
npz tree format both ways (keys, dtype names and stored arrays equal),
window states of every ring dtype and the streaming window both ways,
``load_wa_snapshot``, the precision migration, the layout JSON, the
outer-weight store, the fault injectors, checkpoint sessions (each
package verifies and loads the other's), the port's own bit-exact
resume, and a JAX run resumed by the port's Trainer.

Inputs are made with numpy from a seed and handed to both packages.
Everything but the resumed runs is compared bit for bit (packing and
file IO never touch values); the cross-resume holds the port's final W̿
within 1e-5 of the JAX run's, the Trainer tolerance of
tests/test_torch_train.py (the two packages' matmuls sum in different
orders)."""
import dataclasses
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import OuterWeightStore as JaxStore
from repro.checkpoint import io as jio
from repro.common.packing import pack_spec as jax_pack_spec
from repro.common.packing import repack as jax_repack
from repro.common.packing import spec_from_json as jax_spec_from_json
from repro.common.packing import spec_to_json as jax_spec_to_json
from repro.core.offline import WindowState as JaxWindowState
from repro.core.offline import window_init as jax_window_init
from repro.core.offline import window_update as jax_window_update
from repro.resilience import CheckpointSession as JaxSession
from repro_torch.bridge import params_from_numpy
from repro_torch.checkpoint import OuterWeightStore, io
from repro_torch.common.packing import pack_spec, repack, spec_from_json, \
    spec_to_json
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.core.offline import window_init
from repro_torch.resilience import (CheckpointSession, InjectedIOError,
                                    KillAt, SimulatedCrash, TransientIO,
                                    flip_bit, poison_replica, truncate_file)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

FP8 = jnp.float8_e4m3fn


def _jtree(seed=0):
    """A tree of every leaf kind the checkpoints carry: f32, bf16, fp8,
    int32, 0-dim, nested dicts, a list, and a None (no leaf)."""
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return {"stack": [{"w": jnp.asarray(f(3, 4))},
                      {"w": jnp.asarray(f(2, 4)), "none": None}],
            "b": jnp.asarray(f(5)).astype(jnp.bfloat16),
            "q": {"fp8": jnp.asarray(f(6) * 4).astype(FP8),
                  "i": jnp.asarray(rng.randint(-9, 9, (3,)), jnp.int32),
                  "s": jnp.asarray(np.float32(rng.randn()))}}


def _port(jtree):
    """The same tree on the port's side (a None stays None)."""
    def walk(x):
        if isinstance(x, dict):
            return {k: walk(v) for k, v in x.items()}
        if isinstance(x, list):
            return [walk(v) for v in x]
        if x is None:
            return None
        return params_from_numpy(jax.device_get(x), device="cpu")
    return walk(jtree)


def _bits(x):
    """Any leaf (a tensor, a numpy or JAX array) as its flat bytes."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().reshape(-1).view(torch.uint8) \
            .numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _same_bits(a, b):
    """Port leaves ``a`` (a tree or a list) bit-equal to JAX leaves
    ``b``, dtype names included."""
    la = a if isinstance(a, list) else tree_leaves(a)
    lb = b if isinstance(b, list) else jax.tree.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert str(x.dtype).removeprefix("torch.") == np.asarray(y).dtype.name
        assert tuple(x.shape) == tuple(np.shape(y))
        np.testing.assert_array_equal(_bits(x), _bits(y))


def _stored(path):
    """(keys, dtype names, stored arrays) of an npz, as the file holds
    them (bf16/fp8 as their integer bits)."""
    with np.load(path) as d:
        keys = str(d["__keys__"])
        dtypes = str(d["__dtypes__"])
        n = len([k for k in d.files if k.startswith("leaf_")])
        return keys, dtypes, [d[f"leaf_{i}"] for i in range(n)]


def _assert_same_file(a, b):
    ka, da, xa = _stored(a)
    kb, db, xb = _stored(b)
    assert ka == kb and da == db
    assert len(xa) == len(xb)
    for x, y in zip(xa, xb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- pytrees


def test_pytree_roundtrip(tmp_path):
    tree = _port(_jtree(0))
    path = str(tmp_path / "t.npz")
    io.save_pytree(path, tree)
    like = tree_map(torch.zeros_like, tree)
    back = io.load_pytree(path, like)
    assert back["stack"][1]["none"] is None
    for a, b in zip(tree_leaves(tree), tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(_bits(a), _bits(b))
    renamed = {("a" if k == "b" else k): v for k, v in like.items()}
    with pytest.raises(ValueError, match="leaf mismatch"):
        io.load_pytree(path, renamed)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pytree_interop(tmp_path, writer):
    """One package writes, the other reads: the same npz contents, and
    the reader's leaves bit-equal to the writer's."""
    jt, pt = _jtree(1), _port(_jtree(1))
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jio.save_pytree(jpath, jt)
    io.save_pytree(ppath, pt)
    _assert_same_file(jpath, ppath)
    if writer == "jax":
        back = io.load_pytree(jpath, tree_map(torch.zeros_like, pt))
        _same_bits(back, jt)
    else:
        back = jio.load_pytree(ppath, jax.tree.map(jnp.zeros_like, jt))
        _same_bits(pt, back)


def test_hwa_state_key_paths_match_jax(tmp_path):
    """A whole HWAState (registered dataclasses, a None comp) is stored
    under the reference's key paths, fields in its data-field order."""
    from repro.core.hwa import HWAConfig as JaxHWAConfig
    from repro.core.hwa import hwa_init as jax_hwa_init
    from repro.optim import sgd as jax_sgd
    from repro_torch.bridge import hwa_state_from_numpy

    jp = {"a": [jnp.ones((2,)), jnp.ones((3,))],
          "b": {"w": jnp.ones((2, 2), jnp.bfloat16)}}
    jst = jax_hwa_init(JaxHWAConfig(n_replicas=2, window=3), jp,
                       jax_sgd(momentum=0.9))
    pst = hwa_state_from_numpy(jax.device_get(jst), device="cpu")
    jio.save_pytree(str(tmp_path / "j.npz"), {"hwa": jst})
    io.save_pytree(str(tmp_path / "p.npz"), {"hwa": pst})
    _assert_same_file(str(tmp_path / "j.npz"), str(tmp_path / "p.npz"))
    keys = _stored(str(tmp_path / "p.npz"))[0]
    assert '"hwa|.inner|a|0"' in keys and '"hwa|.window_state|.ring"' in keys
    assert ".comp" not in keys


# ------------------------------------------------------- window states


def _params(seed):
    rng = np.random.RandomState(seed)
    return {"w": jnp.asarray(rng.randn(40, 30).astype(np.float32)),
            "b": jnp.asarray(rng.randn(7).astype(np.float32)),
            "e": jnp.asarray(rng.randn(9, 4).astype(np.float32)
                             ).astype(jnp.bfloat16)}


WINDOWS = {"f32": ("ring", jnp.float32, "f32"),
           "bf16": ("ring", jnp.bfloat16, "bf16"),
           "fp8": ("ring", FP8, "fp8"),
           "streaming": ("streaming", jnp.float32, "f32")}


def _jax_window(name, pushes=4, I=3):
    kind, jdt, _ = WINDOWS[name]
    ws = jax_window_init(_params(0), I, kind, ring_dtype=jdt)
    for t in range(pushes):
        ws, _ = jax_window_update(ws, _params(10 + t))
    return jax.device_get(ws)


def _port_template(name, I=3):
    kind, _, tok = WINDOWS[name]
    return window_init(_port(_params(0)), I, kind, ring_dtype=tok)


def _window_fields(ws):
    return [ws.ring, ws.total, ws.count, ws.next_idx, ws.comp, ws.scales]


def _assert_window_equal(pws, jws):
    for p, j in zip(_window_fields(pws), _window_fields(jws)):
        assert (p is None) == (j is None)
        if p is not None:
            _same_bits([p], [j])
    assert pws.window == jws.window and pws.kind == jws.kind
    assert spec_to_json(pws.spec) == jax_spec_to_json(jws.spec)


@pytest.mark.parametrize("name", list(WINDOWS))
def test_window_state_interop(tmp_path, name):
    """A window state of every kind and ring dtype: JAX writes, the port
    loads it bit for bit; the port writes it back, the file holds what
    JAX's holds, and JAX loads it bit for bit."""
    jws = _jax_window(name)
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jio.save_window_state(jpath, jws)
    pws = io.load_window_state(jpath, _port_template(name))
    _assert_window_equal(pws, jws)
    io.save_window_state(ppath, pws)
    _assert_same_file(jpath, ppath)
    kind, jdt, _ = WINDOWS[name]
    back = jio.load_window_state(
        ppath, jax_window_init(_params(0), 3, kind, ring_dtype=jdt))
    _assert_window_equal(pws, back)


@pytest.mark.parametrize("name", ["f32", "streaming"])
def test_load_wa_snapshot_interop(tmp_path, name):
    jws = _jax_window(name, pushes=2)
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jio.save_window_state(jpath, jws)
    buf, spec = io.load_wa_snapshot(jpath)
    jbuf, jspec = jio.load_wa_snapshot(jpath)
    _same_bits([buf], [jbuf])
    assert spec_to_json(spec) == jax_spec_to_json(jspec)
    io.save_window_state(ppath, io.load_window_state(jpath,
                                                     _port_template(name)))
    jbuf2, _ = jio.load_wa_snapshot(ppath)
    _same_bits([buf], [jbuf2])


@pytest.mark.parametrize("to", ["bf16", "fp8"])
def test_precision_migration_matches_jax(tmp_path, to):
    """An f32 checkpoint into a bf16 and an fp8 template: decoded,
    re-encoded, the total recomputed and comp zeroed, bit for bit as the
    reference migrates it."""
    path = str(tmp_path / "f32.npz")
    jio.save_window_state(path, _jax_window("f32"))
    kind, jdt, _ = WINDOWS[to]
    want = jio.load_window_state(
        path, jax_window_init(_params(0), 3, kind, ring_dtype=jdt))
    got = io.load_window_state(path, _port_template(to))
    _assert_window_equal(got, jax.device_get(want))
    assert not bool(got.comp.any())
    # and back: the compressed state into an f32 template
    cpath = str(tmp_path / "c.npz")
    io.save_window_state(cpath, got)
    want32 = jio.load_window_state(cpath, jax_window_init(_params(0), 3))
    _assert_window_equal(io.load_window_state(cpath, _port_template("f32")),
                         jax.device_get(want32))


def test_window_state_layout_repack_and_per_leaf_migration(tmp_path):
    """Case 2: a state saved under another single-device layout (JAX at
    align 16) is repacked into the template's; case 3: a pre-packing
    per-leaf checkpoint is packed into it. Both bit-exact, as JAX does."""
    jws = _jax_window("f32")
    spec16 = jax_pack_spec(_params(0), align=16)
    moved = JaxWindowState(ring=jax_repack(jws.ring, jws.spec, spec16),
                           total=jax_repack(jws.total, jws.spec, spec16),
                           count=jws.count, next_idx=jws.next_idx,
                           window=3, kind="ring", spec=spec16)
    path = str(tmp_path / "a16.npz")
    jio.save_window_state(path, moved)
    _assert_window_equal(io.load_window_state(path, _port_template("f32")),
                         jws)
    from repro.common.packing import unpack as jax_unpack
    f32 = jax.tree.map(lambda x: x.astype(jnp.float32), _params(0))
    old_ring = {k: np.stack([np.asarray(jax_unpack(jws.ring[r], jws.spec,
                                                   like=f32)[k])
                             for r in range(3)]) for k in f32}
    old_total = {k: np.asarray(v) for k, v in
                 jax_unpack(jws.total, jws.spec, like=f32).items()}
    lpath = str(tmp_path / "legacy.npz")
    jio.save_pytree(lpath, {"ring": old_ring, "total": old_total,
                            "count": jws.count, "next_idx": jws.next_idx})
    _assert_window_equal(io.load_window_state(lpath, _port_template("f32")),
                         jws)


def test_spec_json_interop():
    """The layout JSON is the reference's string, character for
    character, for an f32 and an fp8 layout; each package reads the
    other's into an equal layout."""
    for name in ("f32", "fp8"):
        jspec = _jax_window(name, pushes=0).spec
        pspec = _port_template(name).spec
        s = spec_to_json(pspec)
        assert s == jax_spec_to_json(jspec)
        assert spec_from_json(jax_spec_to_json(jspec)).same_layout(pspec)
        assert spec_from_json(s).ring_dtype == pspec.ring_dtype
        assert jax_spec_from_json(s).same_layout(jspec)
    buf = torch.arange(pspec.padded, dtype=torch.float32)
    moved = repack(buf, pspec, spec_from_json(spec_to_json(pspec)))
    assert torch.equal(moved[:pspec.size], buf[:pspec.size])
    assert not bool(moved[pspec.size:].any())


def test_sharded_layout_raises_naming_a13(tmp_path):
    """The sharded layout (a data or model axis inside a replica) reads
    back from the reference's JSON character for character, and a
    grouped layout's buffers split and merge bit for bit (they raised
    before the layouts were ported)."""
    spec_s = jax_pack_spec(_params(0), align=16, shards=2,
                           shard_dims=[None, None, 0], axes=("model",))
    s = jax_spec_to_json(spec_s)
    got = spec_from_json(s)
    assert spec_to_json(got) == s and got.shards == 2
    assert [ls.shard_dim for ls in got.leaves] == [None, None, 0]
    from repro_torch.common.packing import merge_groups, split_groups
    spec = _port_template("f32").spec
    buf = torch.arange(spec.padded, dtype=torch.float32)
    parts = split_groups(buf, spec)
    assert len(parts) == 1 and torch.equal(merge_groups(parts, spec), buf)


# --------------------------------------------------- outer-weight store


def _outer(seed):
    return _port({"stack": [{"w": _jtree(seed)["stack"][0]["w"]}],
                  "b": _jtree(seed)["b"]})


def _like_outer():
    return tree_map(torch.zeros_like, _outer(0))


def _mean(trees):
    """The reference's window mean of port trees: f32 sums in order,
    times 1/n, cast to each leaf's dtype."""
    acc = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                   trees[0])
    for t in trees:
        acc = tree_map(lambda a, x: a + x.float(), acc, t)
    return tree_map(lambda a, x: (a * (1.0 / len(trees))).to(x.dtype), acc,
                    trees[0])


def _same_port_bits(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(_bits(x), _bits(y))


def test_store_window_average_cycles_and_jax_files(tmp_path):
    """The store's window average equals the reference's arithmetic on
    the in-memory trees and a JAX store's average of the same files, bit
    for bit; its files are the reference's (a JAX store reads them)."""
    store = OuterWeightStore(str(tmp_path / "outer"))
    outers = [_outer(i) for i in range(6)]
    for e in (3, 1, 0, 2, 5, 4):
        store.save(e, outers[e])
    assert store.cycles() == list(range(6))
    wa = store.window_average(end_cycle=5, window=3, like=_like_outer())
    _same_port_bits(wa, _mean(outers[3:]))
    _same_port_bits(store.window_average(end_cycle=5, window=3,
                                         like=_like_outer(), stride=2),
                    _mean([outers[1], outers[3], outers[5]]))
    jwa = JaxStore(str(tmp_path / "outer")).window_average(
        end_cycle=5, window=3,
        like=jax.tree.map(jnp.zeros_like, {"stack": [{"w": jnp.zeros(
            (3, 4))}], "b": jnp.zeros((5,), jnp.bfloat16)}))
    _same_bits(wa, jwa)


def test_store_skips_partial_npz_and_verifies(tmp_path):
    store = OuterWeightStore(str(tmp_path / "outer"))
    outers = [_outer(i) for i in range(3)]
    for e, o in enumerate(outers):
        store.save(e, o)
    truncate_file(store._path(1), frac=0.5)
    assert list(store.verify()) == [1]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        wa = store.window_average(end_cycle=2, window=3, like=_like_outer())
    assert any("skipping unreadable" in str(w.message) for w in caught)
    _same_port_bits(wa, _mean([outers[0], outers[2]]))


def test_store_all_corrupt_raises(tmp_path):
    store = OuterWeightStore(str(tmp_path / "outer"))
    store.save(0, _outer(0))
    truncate_file(store._path(0), frac=0.3)
    with pytest.raises(ValueError, match="READABLE"):
        store.window_average(end_cycle=0, window=1, like=_like_outer())


def test_store_retention_keep_last(tmp_path):
    store = OuterWeightStore(str(tmp_path / "outer"), keep_last=2)
    for e in range(5):
        store.save(e, _outer(e))
    assert store.cycles() == [3, 4]
    with pytest.raises(ValueError, match="keep_last"):
        OuterWeightStore(str(tmp_path / "bad"), keep_last=0)


def test_save_killed_mid_write_keeps_old(tmp_path, monkeypatch):
    """A crash mid-write never clobbers the published file: the write
    goes to a unique tmp name and only a complete, fsynced file is
    renamed over the old one."""
    path = str(tmp_path / "ckpt.npz")
    old = _outer(0)
    io.save_pytree(path, old)
    real_fsync = os.fsync

    def dying_fsync(fd):
        real_fsync(fd)
        raise RuntimeError("simulated kill mid-save")

    monkeypatch.setattr(os, "fsync", dying_fsync)
    with pytest.raises(RuntimeError, match="mid-save"):
        io.save_pytree(path, _outer(1))
    monkeypatch.undo()
    for a, b in zip(tree_leaves(old),
                    tree_leaves(io.load_pytree(path, _like_outer()))):
        assert np.array_equal(_bits(a), _bits(b))
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == []


# ------------------------------------------------------ fault injectors


def test_kill_at_fires_on_nth_occurrence(tmp_path):
    p = str(tmp_path / "victim.bin")
    with open(p, "wb") as f:
        f.write(b"x" * 100)
    kill = KillAt("manifest_write", occurrence=2, truncate_frac=0.5)
    kill("array_write", p)
    kill("manifest_write", p)
    assert os.path.getsize(p) == 100
    with pytest.raises(SimulatedCrash):
        kill("manifest_write", p)
    assert os.path.getsize(p) == 50
    assert not issubclass(SimulatedCrash, Exception)


def test_transient_io_raises_then_clears():
    t = TransientIO("array_write", times=2)
    for _ in range(2):
        with pytest.raises(InjectedIOError):
            t("array_write", "whatever")
    t("array_write", "whatever")
    assert issubclass(InjectedIOError, OSError)


def test_truncate_and_flip_bit(tmp_path):
    p = str(tmp_path / "blob.bin")
    payload = bytes(range(256))
    with open(p, "wb") as f:
        f.write(payload)
    truncate_file(p, frac=0.25)
    assert os.path.getsize(p) == 64
    flip_bit(p)
    with open(p, "rb") as f:
        got = f.read()
    diff = [i for i in range(64) if got[i] != payload[i]]
    assert len(diff) == 1
    assert bin(got[diff[0]] ^ payload[diff[0]]).count("1") == 1


def test_poison_replica_targets_floating_leaves():
    tree = {"w": torch.randn(4, 3, 5), "b": torch.randn(4, 7).bfloat16(),
            "count": torch.full((4,), 3, dtype=torch.int32)}
    got = poison_replica(tree, 2)
    assert bool(torch.isnan(got["w"][2]).all())
    assert bool(torch.isnan(got["b"][2].float()).all())
    assert bool(torch.isfinite(got["w"][0]).all())
    assert bool(torch.isfinite(tree["w"]).all())      # a copy
    assert got["count"] is tree["count"]


# ----------------------------------------------------- checkpoint session


def _demo(seed=0):
    """tests/test_resilience.py's tree (numpy leaves)."""
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal((11,)).astype(np.float32)}


def _equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and np.array_equal(_bits(x), _bits(y))


def test_session_roundtrip_meta_and_gc(tmp_path):
    sess = CheckpointSession(str(tmp_path), keep=2)
    for step in (4, 8, 12):
        sess.save(step, {"state": _demo(step)},
                  meta={"step": step, "note": "hi"})
    assert sess.steps() == [8, 12]
    assert sess.latest_intact() == 12
    assert sess.meta(12)["step"] == 12
    _equal(sess.load(12, "state", _demo(0)), _demo(12))
    ok, problems = sess.verify(12)
    assert ok, problems


def _payload_offset(path, member="leaf_1.npy"):
    """A byte inside ``member``'s array data (past its local zip header
    and its 128-byte npy header): where a flipped bit must be caught."""
    import struct
    import zipfile
    info = zipfile.ZipFile(path).getinfo(member)
    with open(path, "rb") as f:
        f.seek(info.header_offset + 26)
        n, e = struct.unpack("<HH", f.read(4))
    return info.header_offset + 30 + n + e + 128 + 4


def test_session_falls_back_past_corruption(tmp_path):
    sess = CheckpointSession(str(tmp_path), keep=3)
    sess.save(4, {"state": _demo(4)})
    sess.save(8, {"state": _demo(8)})
    path = os.path.join(sess.step_dir(8), "state.npz")
    flip_bit(path, offset=_payload_offset(path))
    ok, problems = sess.verify(8)
    assert not ok and problems
    assert sess.latest_intact() == 4
    os.remove(os.path.join(sess.step_dir(4), "manifest.json"))
    assert sess.latest_intact() is None


def test_session_retries_transient_io(tmp_path):
    sess = CheckpointSession(str(tmp_path), retries=3, backoff=0.0,
                             fault_injector=TransientIO("array_write",
                                                        times=2),
                             sleep=lambda s: None)
    sess.save(4, {"state": _demo(1)})
    assert sess.io_retries == 2
    assert sess.latest_intact() == 4


def test_session_kill_mid_manifest_keeps_previous(tmp_path):
    sess = CheckpointSession(str(tmp_path),
                             fault_injector=KillAt("manifest_write",
                                                   occurrence=2,
                                                   truncate_frac=0.4))
    sess.save(4, {"state": _demo(4)})
    with pytest.raises(SimulatedCrash):
        sess.save(8, {"state": _demo(8)})
    fresh = CheckpointSession(str(tmp_path))
    assert fresh.latest_intact() == 4
    _equal(fresh.load(4, "state", _demo(0)), _demo(4))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_session_directory_verifies_across_packages(tmp_path, writer):
    """A session directory (a tree and a window state) written by either
    package verifies under both, with equal manifests, and loads bit for
    bit in the other."""
    jws = _jax_window("bf16")
    pws = io.load_window_state(_write_jax_window(tmp_path, jws),
                               _port_template("bf16"))
    jt, pt = _jtree(3), _port(_jtree(3))
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    JaxSession(jdir).save(4, {"t": jt}, window=jws, meta={"step": 4})
    CheckpointSession(pdir).save(4, {"t": pt}, window=pws,
                                 meta={"step": 4})
    jm = JaxSession(jdir).manifest(4)
    pm = CheckpointSession(pdir).manifest(4)
    for m in (jm, pm):
        for rec in m["files"].values():
            rec.pop("size")
    assert jm == pm
    d = jdir if writer == "jax" else pdir
    for sess in (JaxSession(d), CheckpointSession(d)):
        ok, problems = sess.verify(4)
        assert ok, problems
        assert sess.latest_intact() == 4
    if writer == "jax":
        _same_bits(CheckpointSession(d).load(4, "t", pt), jt)
        _assert_window_equal(CheckpointSession(d).load_window(
            4, _port_template("bf16")), jws)
    else:
        _same_bits(pt, JaxSession(d).load(
            4, "t", jax.tree.map(jnp.zeros_like, jt)))
        _assert_window_equal(pws, jax.device_get(JaxSession(d).load_window(
            4, jax_window_init(_params(0), 3, ring_dtype=jnp.bfloat16))))


def _write_jax_window(tmp_path, jws):
    path = str(tmp_path / "jw.npz")
    jio.save_window_state(path, jws)
    return path


# ---------------------------------------------------- trainer and resume


TINY = dict(name="tiny", family="dense", n_layers=2, d_model=32, n_heads=2,
            n_kv_heads=2, d_ff=64, vocab_size=32, attn_impl="naive",
            remat="none", dtype="float32")


def _port_trainer(ckpt=None, *, steps, resume=False, every=0,
                  pipeline=None, init=None):
    """tests/test_resilience.py's run on the port: a tiny f32 model, K=2,
    H=4, I=3, checkpoints every ``every`` steps."""
    from repro_torch.core.hwa import HWAConfig
    from repro_torch.data import DataPipeline, make_markov_lm_dataset
    from repro_torch.models.registry import build_model
    from repro_torch.models.types import ModelConfig
    from repro_torch.train.trainer import Task, TrainConfig, Trainer, \
        lm_task

    lm = build_model(ModelConfig(**TINY))
    if pipeline is None:
        ds = make_markov_lm_dataset(vocab=32, seq_len=32, n_train=256,
                                    n_test=64, seed=0, device="cpu")
        pipeline = DataPipeline(ds, batch_size=8, n_replicas=2, seed=0)
    task = lm_task(lm, pipeline, device="cpu")
    if init is not None:
        task = Task(init=init, loss_fn=task.loss_fn, pipeline=pipeline)
    tc = TrainConfig(method="hwa", total_steps=steps, batch_size=8,
                     base_lr=0.5, eval_every=8,
                     hwa=HWAConfig(n_replicas=2, sync_period=4, window=3),
                     checkpoint_dir=str(ckpt) if ckpt else "",
                     checkpoint_every=every, resume=resume)
    return Trainer(task, tc)


def test_trainer_resume_bit_exact(tmp_path):
    """N steps, checkpoint, corrupt the newest save, resume: the resumed
    run's final W̿ and history are bit-identical to the uninterrupted
    run's, and checkpointing does not touch the training math."""
    clean = _port_trainer(steps=16).run()
    first = _port_trainer(tmp_path, steps=16, every=8).run()
    _equal(clean["params"], first["params"])
    flip_bit(os.path.join(str(tmp_path), "step_00000016", "hwa.npz"))
    assert CheckpointSession(str(tmp_path)).latest_intact() == 8
    resumed = _port_trainer(tmp_path, steps=16, every=8, resume=True).run()
    _equal(clean["params"], resumed["params"])
    assert clean["history"] == resumed["history"]


def test_trainer_resume_config_validation(tmp_path):
    with pytest.raises(ValueError, match="resume"):
        _port_trainer(None, steps=4, resume=True).run()
    bad = _port_trainer(tmp_path, steps=4, every=4)
    bad.tc = dataclasses.replace(bad.tc, method="base")
    bad.is_parallel = False
    with pytest.raises(ValueError, match="K-replica"):
        bad.run()


def test_port_resumes_a_jax_run(tmp_path):
    """Cross-resume: the JAX Trainer checkpoints at step 8 of 16 (its
    step-16 save is corrupted), the port's Trainer resumes from that
    directory on the reference's batches, and its final W̿ is within 1e-5
    of JAX's uninterrupted run."""
    from repro.core import HWAConfig as JaxHWAConfig
    from repro.data import DataPipeline as JaxPipeline
    from repro.data import make_markov_lm_dataset as jax_markov
    from repro.models import build_model as jax_build_model
    from repro.models.types import ModelConfig as JaxModelConfig
    from repro.train import TrainConfig as JaxTrainConfig
    from repro.train import Trainer as JaxTrainer
    from repro.train import lm_task as jax_lm_task
    from test_torch_train import _Injected

    jlm = jax_build_model(JaxModelConfig(**TINY))
    jpipe = JaxPipeline(jax_markov(vocab=32, seq_len=32, n_train=256,
                                   n_test=64, seed=0),
                        batch_size=8, n_replicas=2, seed=0)

    def jax_trainer(steps, every=0):
        tc = JaxTrainConfig(method="hwa", total_steps=steps, batch_size=8,
                            base_lr=0.5, eval_every=8,
                            hwa=JaxHWAConfig(n_replicas=2, sync_period=4,
                                             window=3),
                            checkpoint_dir=str(tmp_path) if every else "",
                            checkpoint_every=every)
        return JaxTrainer(jax_lm_task(jlm, jpipe), tc)

    clean = jax_trainer(16).run()
    jax_trainer(16, every=8).run()
    flip_bit(os.path.join(str(tmp_path), "step_00000016", "hwa.npz"))
    assert CheckpointSession(str(tmp_path)).latest_intact() == 8
    jparams = jax.device_get(jlm.init(jax.random.key(0)))
    resumed = _port_trainer(
        tmp_path, steps=16, every=8, resume=True, pipeline=_Injected(jpipe),
        init=lambda: params_from_numpy(jparams, device="cpu")).run()
    for g, w in zip(tree_leaves(resumed["params"]),
                    jax.tree.leaves(clean["params"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert [h["step"] for h in resumed["history"]] == \
        [h["step"] for h in clean["history"]]
    np.testing.assert_allclose(resumed["history"][-1]["test_loss"],
                               clean["history"][-1]["test_loss"], rtol=1e-5)
