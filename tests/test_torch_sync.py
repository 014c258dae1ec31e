"""The port's mesh-native sync (``launch/sync/``, ``launch/mesh.py`` and
the grouped means of ``core/online.py``) against the JAX reference, on
the CPU.

- The canonical, grouped and pod means and the halving sum: bit for bit
  against ``repro.core.online``, K 2, 4 and 8 over every pod count, and
  odd pod counts of power-of-two size.
- ``Flat``/``TwoLevel``, ``SyncPlan``, ``_check_outer_every`` and
  ``packed_sync_launch_budget``: the same structure, the same refusals
  with the same messages, the same budget over the whole argument matrix.
- The sync across ``gloo`` ranks spawned through ``launch.mesh
  .spawn_ranks``, one spawn per mesh: a 2-rank flat sync and a 4-rank
  two-level sync (outer and inner) against the reference's own sync
  bodies (``_local_packed_sync``, ``_local_inner_sync``) run under nested
  ``vmap`` with the mesh's axis names (a two-way psum is one add there
  too), jitted as the reference's bundles are: restarted replicas, ring,
  total, Kahan comp, fp8 scales, count, cursor, cycle and W̿ at 0 ULP, for
  the f32, bf16 and fp8 rings, the bf16 and fp8 cross-pod payloads and the
  resilient sync with a NaN replica (k_alive and W̄ equal to
  ``resilience.health.masked_mean_axis0``'s too); the f32 W̄ equal to
  ``online_average_canonical``/``_grouped``/``pod_mean_grouped``. A
  3-rank flat sync (the all-gather branch) against
  ``online_average_canonical``. Every sync's ledger equals the
  collectives its bundle declares, and the compressed payloads are 2 and
  1 bytes an element (plus the fp8 scales).
"""
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.packing import pack_spec as jax_pack_spec
from repro.common.packing import pack as jax_pack
from repro.common.packing import unpack as jax_unpack
from repro.core import online as jon
from repro.core.hwa import HWAConfig as JaxHWAConfig
from repro.core.hwa import window_push_packed as jax_window_push_packed
from repro.core.offline import window_init as jax_window_init
from repro.core.offline import window_update as jax_window_update
from repro.launch.sync import bundles as jbundles
from repro.launch.sync import packed as jpacked
from repro.launch.sync import plan as jplan
from repro.launch.sync import topology as jtopo
from repro.resilience.health import masked_mean_axis0 as jax_masked_mean
from repro_torch.bridge import params_from_numpy, params_to_numpy
from repro_torch.common.packing import ALIGN, pack_spec
from repro_torch.common.quant import rel_ulp_error
from repro_torch.core import online as pon
from repro_torch.core.hwa import HWAConfig
from repro_torch.core.offline import WindowState
from repro_torch.launch import mesh as pmesh
from repro_torch.launch.sync import bundles as pbundles
from repro_torch.launch.sync import packed as ppacked
from repro_torch.launch.sync import plan as pplan
from repro_torch.launch.sync import topology as ptopo
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I = 3
JOB = "repro_torch.launch.sync.bundles:sync_cases"


def _bits(x):
    """The raw bits of a numpy array (bf16/fp8 included) as unsigned
    integers, so equality is to the bit (NaNs included)."""
    x = np.asarray(x)
    return x.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[x.dtype.itemsize])


def _np(t):
    """A port tensor as numpy: bf16 as uint16 bits, fp8 as uint8 bits."""
    return params_to_numpy(t)


def _same(port, ref):
    return np.array_equal(_bits(_np(port)), _bits(ref))


def _tree(seed, k, spread=None):
    """K replicas: independent normals, or with ``spread`` one shared
    normal plus ``spread``-scaled normals each (replicas diverged from one
    W̄ by a few steps, the state the reference's budgets are set on)."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (3, 5), "b": (300,)}
    if spread is None:
        return {n: rng.standard_normal((k,) + s).astype(np.float32)
                for n, s in shapes.items()}
    return {n: (rng.standard_normal(s)[None]
                + spread * rng.standard_normal((k,) + s)).astype(np.float32)
            for n, s in shapes.items()}


# ------------------------------------------------- grouped means (0 ULP)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_halving_sum_axis0_matches_reference(n):
    x = np.random.default_rng(n).standard_normal((n, 257)).astype(np.float32)
    got = pon.halving_sum_axis0(torch.from_numpy(x))
    assert _same(got, jon.halving_sum_axis0(jnp.asarray(x)))


def _check_means(k, pods_list):
    t = _tree(k, k)
    jt = jax.tree.map(jnp.asarray, t)
    pt = params_from_numpy(t, "cpu")
    flat = pon.online_average_canonical(pt)
    for name in t:
        assert _same(flat[name], jon.online_average_canonical(jt)[name])
    for pods in pods_list:
        got = pon.online_average_grouped(pt, pods)
        pod = pon.pod_mean_grouped(pt, pods)
        for name in t:
            assert _same(got[name], jon.online_average_grouped(jt,
                                                               pods)[name])
            assert _same(pod[name], jon.pod_mean_grouped(jt, pods)[name])
            if (k // pods) & (k // pods - 1) == 0:     # power-of-two pods
                assert _same(got[name], np.asarray(
                    jon.online_average_canonical(jt)[name]))


@pytest.mark.parametrize("k", [2, 4, 8])
def test_grouped_means_match_reference_0ulp(k):
    _check_means(k, [d for d in range(1, k + 1) if k % d == 0])


@pytest.mark.parametrize("pods,per", [(3, 4), (5, 2)])
def test_grouped_mean_0ulp_for_pow2_pods_of_any_count(pods, per):
    _check_means(pods * per, [pods])


def test_grouped_mean_rejects_bad_factorization():
    t = params_from_numpy(_tree(0, 6), "cpu")
    with pytest.raises(ValueError, match="do not divide"):
        pon.online_average_grouped(t, 4)
    with pytest.raises(ValueError, match="do not divide"):
        pon.pod_mean_grouped(t, 5)


# --------------------------------------------- structure and refusals


def _fake_mesh(shape):
    return types.SimpleNamespace(shape=dict(shape), axis_names=tuple(shape))


def _raises_same(port_fn, ref_fn):
    """Both raise ValueError, with the same message but for the name of
    what schedules the syncs ("the ... schedules off the topology")."""
    who = re.compile(r"the [a-z ]+ schedules off")
    with pytest.raises(ValueError) as p:
        port_fn()
    with pytest.raises(ValueError) as r:
        ref_fn()
    assert who.sub("", str(p.value)) == who.sub("", str(r.value))


def test_topologies_match_reference():
    mesh = _fake_mesh({"pod": 2, "replica": 4})
    for args in [((), {}), (("replica",), {}), ((("pod", "replica"),), {})]:
        p, r = ptopo.Flat(*args[0]), jtopo.Flat(*args[0])
        assert p.replica_axes == r.replica_axes and p.levels == r.levels
        assert p.psum_groups() == r.psum_groups()
        assert p.n_replicas(mesh) == r.n_replicas(mesh)
        p.validate(mesh, p.n_replicas(mesh))
        _raises_same(lambda: p.validate(mesh, 3),
                     lambda: r.validate(mesh, 3))
    _raises_same(lambda: ptopo.Flat("data").validate(mesh, 2),
                 lambda: jtopo.Flat("data").validate(mesh, 2))
    for h2 in (1, 2, 3):
        p = ptopo.TwoLevel("replica", "pod", outer_every=h2)
        r = jtopo.TwoLevel("replica", "pod", outer_every=h2)
        assert (p.replica_axes, p.levels, p.psum_groups(),
                p.inner_groups()) == (r.replica_axes, r.levels,
                                      r.psum_groups(), r.inner_groups())
        assert (p.pods(mesh), p.pod_size(mesh), p.n_replicas(mesh)) == \
            (r.pods(mesh), r.pod_size(mesh), r.n_replicas(mesh))
        assert [p.is_outer(i) for i in range(9)] == \
            [bool(r.is_outer(i)) for i in range(9)]
        p.validate(mesh, 8)
        _raises_same(lambda: p.validate(mesh, 4),
                     lambda: r.validate(mesh, 4))
    for kw in [dict(inner_axis="replica", outer_axis="replica"),
               dict(outer_every=0), dict(outer_axis="island")]:
        _raises_same(lambda: ptopo.TwoLevel(**kw).validate(mesh, 8),
                     lambda: jtopo.TwoLevel(**kw).validate(mesh, 8))


def test_sync_plan_refuses_the_reference_corners():
    tl = dict(port=ptopo.TwoLevel("replica", "pod"),
              ref=jtopo.TwoLevel("replica", "pod"))
    corners = [
        (dict(comms_dtype="bf16"), False, None),
        (dict(comms_dtype="fp8"), False, "flat"),
        (dict(comms_dtype="bf16"), True, "tree"),
        (dict(mesh_native=False), False, "tree"),
    ]
    for kw, resilient, topo in corners:
        def build(pkg):
            hwa = (HWAConfig if pkg == "port" else JaxHWAConfig)(
                n_replicas=4, resilient=resilient)
            mod = pplan if pkg == "port" else jplan
            top = (tl[pkg] if topo == "tree" else
                   (ptopo if pkg == "port" else jtopo).Flat()
                   if topo == "flat" else None)
            return mod.SyncPlan(hwa=hwa, topology=top, **kw)
        _raises_same(lambda: build("port"), lambda: build("ref"))
    ok = pplan.SyncPlan(hwa=HWAConfig(n_replicas=4), topology=tl["port"],
                        wa_dtype=torch.float8_e4m3fn, comms_dtype="bf16")
    assert (ok.wa_dtype, ok.comms_dtype, ok.is_tree) == ("fp8", "bf16", True)
    assert pplan.SyncPlan(hwa=HWAConfig()).resolved_topology == \
        ptopo.Flat("replica")


def test_check_outer_every_matches_reference():
    for h2_cfg, h2_topo in [(2, 3), (3, 1)]:
        for tree in (True, False):
            def run(pkg):
                mod = pbundles if pkg == "port" else jbundles
                top = (ptopo if pkg == "port" else jtopo)
                hwa = (HWAConfig if pkg == "port" else JaxHWAConfig)(
                    outer_every=h2_cfg)
                t = (top.TwoLevel(outer_every=h2_topo) if tree
                     else top.Flat())
                return mod._check_outer_every(hwa, t)
            _raises_same(lambda: run("port"), lambda: run("ref"))
    pbundles._check_outer_every(HWAConfig(outer_every=2),
                                ptopo.TwoLevel(outer_every=2))
    pbundles._check_outer_every(HWAConfig(), ptopo.Flat())


def test_launch_budget_matches_reference_over_its_matrix():
    n = 0
    for stride in (1, 2):
        for resilient_cfg in (False, True):
            pc = HWAConfig(window_stride=stride, resilient=resilient_cfg)
            jc = JaxHWAConfig(window_stride=stride, resilient=resilient_cfg)
            for kw in [dict(use_kernel=u, n_groups=g, k_local=k,
                            collective=c, with_stride=w, ring_dtype=d,
                            resilient=r)
                       for u in (False, True) for g in (1, 3)
                       for k in (1, 2, 4) for c in (False, True)
                       for w in (False, True)
                       for d in ("f32", "bf16", "fp8")
                       for r in (None, False, True)]:
                assert ppacked.packed_sync_launch_budget(pc, **kw) == \
                    jpacked.packed_sync_launch_budget(jc, **kw), kw
                n += 1
    assert n == 4 * 432


def test_mesh_layout_and_backend_rule():
    assert pmesh.backend_for("cpu", 4, 0) == "gloo"
    assert pmesh.backend_for("cuda", 4, 1) == "gloo"
    assert pmesh.backend_for("cuda", 4, 4) == "nccl"
    m = object.__new__(pmesh.ReplicaMesh)
    m.shape, m.world, m.rank = {"pod": 2, "replica": 4}, 8, 5
    assert m.coords() == {"pod": 1, "replica": 1}
    assert m.partition(("replica",)) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert m.partition(("pod",)) == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert m.partition(("pod", "replica")) == [list(range(8))]
    def budget(mesh, topology, **kw):
        return pbundles.sync_collective_contract(
            mesh, topology, launches={}, **kw).ledger(mesh.shape)
    tree = ptopo.TwoLevel(outer_every=2)
    assert budget(m, tree) == {"replica": {"all_reduce": 2},
                               "pod": {"all_reduce": 1}}
    assert budget(m, tree, inner_only=True) == {"replica": {"all_reduce": 2}}
    assert budget(m, tree, comms_dtype="fp8") == {
        "replica": {"all_reduce": 2}, "pod": {"all_gather": 2}}
    assert budget(m, ptopo.Flat(("pod", "replica")), resilient=True) == \
        {"pod+replica": {"all_reduce": 6}}
    m3 = object.__new__(pmesh.ReplicaMesh)
    m3.shape, m3.world = {"replica": 3}, 3
    assert budget(m3, ptopo.Flat()) == {"replica": {"all_gather": 1}}


# ------------------------------------------- the sync across processes


def _window(one, tok, seed):
    """A window holding 3 pushes (full, cursor back at 0) in both
    packages, from the same bits: the next push evicts."""
    jone = jax.tree.map(jnp.asarray, one)
    jws = jax_window_init(jone, I, ring_dtype=tok)
    rng = np.random.default_rng(seed)
    for _ in range(3):
        jws, _ = jax_window_update(jws, jax.tree.map(
            lambda x: jnp.asarray(rng.standard_normal(x.shape)
                                  .astype(np.float32)), jone))
    spec = pack_spec(params_from_numpy(one, "cpu"))
    if tok != "f32":
        spec = spec.with_ring_dtype(tok)
    opt = lambda a: None if a is None else params_from_numpy(  # noqa: E731
        np.asarray(a), "cpu")
    pws = WindowState(ring=opt(jws.ring), total=opt(jws.total),
                      count=opt(jws.count).to(torch.int32),
                      next_idx=opt(jws.next_idx).to(torch.int32), window=I,
                      spec=spec, comp=opt(jws.comp), scales=opt(jws.scales))
    return jws, pws


def _ref_on_mesh(fn, shape, stacked, *bcast, jit=True):
    """``fn`` (one rank's body over a (1, ...) stacked replica) run under
    nested vmaps named like the mesh axes, jitted unless ``jit`` is false;
    outputs with a leading K axis in rank order."""
    f = fn
    for name in reversed(list(shape)):
        f = jax.vmap(f, in_axes=(0,) + (None,) * len(bcast), axis_name=name)
    dims = tuple(shape.values())
    x = jax.tree.map(lambda a: jnp.asarray(a).reshape(dims + (1,)
                                                      + a.shape[1:]), stacked)
    out = (jax.jit(f) if jit else f)(x, *bcast)
    k = int(np.prod(dims))
    return jax.tree.map(lambda a: np.asarray(a).reshape(
        (k,) + a.shape[len(dims):]), out)


def _ref_sync(case, shape, jws):
    p = case["plan"]
    K = p.hwa.n_replicas
    jcfg = JaxHWAConfig(n_replicas=K, window=I, outer_every=p.hwa.outer_every,
                        resilient=p.hwa.resilient)
    one = jax.tree.map(lambda x: jnp.asarray(x[0]), case["np"])
    spec = jax_pack_spec(one)
    if p.wa_dtype != "f32":
        spec = spec.with_ring_dtype(p.wa_dtype)
    groups = (p.resolved_topology.inner_groups() if case.get("inner")
              else p.resolved_topology.psum_groups())
    if case.get("inner"):
        pod = K // p.resolved_topology.pods(_fake_mesh(shape))
        return _ref_on_mesh(
            lambda inner: jpacked._local_inner_sync(spec.local_spec(), pod,
                                                    groups, inner),
            shape, case["np"])

    def body(inner, ring, total, count, nidx, cycle, scales, comp):
        return jpacked._local_packed_sync(
            jcfg, spec.local_spec(), K, groups, False, True, inner, ring,
            total, count, nidx, cycle, scales, comp,
            comms_dtype=p.comms_dtype)
    # the resilient body runs eagerly: under jit XLA moves the 1/k_alive
    # scaling across the vmapped reduction (a rewrite no real all-reduce
    # admits; 2 ULP at k_alive 3), while each eager op is one IEEE op
    return _ref_on_mesh(body, shape, case["np"], jws.ring, jws.total,
                        jws.count, jws.next_idx, jnp.int32(3), jws.scales,
                        jws.comp, jit=not p.hwa.resilient)


def _case(plan, seed, K, *, inner=False, nan_rank=None, spread=None):
    t = _tree(seed, K, spread)
    if nan_rank is not None:
        t["w"][nan_rank] = np.nan
    one = {k: v[0] for k, v in t.items()}
    jws, pws = _window(one, plan.wa_dtype, seed + 1)
    case = {"plan": plan, "stacked": params_from_numpy(t, "cpu"),
            "window": pws, "cycle": torch.tensor(3, dtype=torch.int32),
            "inner": inner}
    return case, dict(case, np=t, jws=jws)


def _run(shape, cases, levels):
    ranks = pmesh.spawn_ranks(shape, JOB, [c for c, _ in cases],
                              levels=levels, timeout=240,
                              collective_timeout=60)
    return [[r["result"][i] for r in ranks] for i in range(len(cases))]


def _assert_matches_reference(shape, got, case):
    """Every rank's outputs bit-equal to the reference body's."""
    ref = _ref_sync(case, shape, case["jws"])
    if case.get("inner"):
        new_inner = ref
    else:
        new_inner, ring, scales, total, comp, count, nidx, wa, cycle, alive \
            = ref
    for r, g in enumerate(got):
        # the ledger holds the sync to what its bundle declares
        assert {lvl: {op: n for op, n in row.items()
                      if op in ("all_reduce", "all_gather") and n}
                for lvl, row in g["collectives"].items()} == g["declared"]
        for name in case["np"]:
            assert _same(g["params"][name], new_inner[name][r][0]), \
                (r, name)
        if case.get("inner"):
            continue
        ws = g["window"]
        assert _same(ws.ring, ring[r]) and _same(ws.total, total[r])
        assert int(ws.count) == int(count[r])
        assert int(ws.next_idx) == int(nidx[r])
        assert int(g["cycle"]) == int(cycle[r])
        if comp is not None:
            assert _same(ws.comp, comp[r])
        if scales is not None:
            assert _same(ws.scales, scales[r])
        for name in case["np"]:
            assert _same(g["wa"][name], wa[name][r]), (r, name)
        assert bool(g["alive"][0]) == bool(alive[r][0])


def _pod_bytes(g, P, tok):
    return {"bf16": 2 * P, "fp8": P + 4 * (P // ALIGN)}[tok]


def _plan(K, *, tree=False, wa="f32", comms="f32", resilient=False):
    topo = ptopo.TwoLevel("replica", "pod", outer_every=2) if tree else None
    return pplan.SyncPlan(
        hwa=HWAConfig(n_replicas=K, window=I, use_kernels=True,
                      outer_every=2 if tree else 1, resilient=resilient),
        topology=topo, wa_dtype=wa, comms_dtype=comms)


def test_flat_sync_two_ranks_matches_reference_0ulp():
    shape = {"replica": 2}
    cases = [_case(_plan(2), 10, 2),
             _case(_plan(2, resilient=True), 11, 2, nan_rank=1),
             _case(_plan(2, wa="bf16"), 12, 2),
             _case(_plan(2, wa="fp8"), 13, 2),
             _case(_plan(2), 14, 2, spread=0.01),
             _case(_plan(2, wa="bf16"), 14, 2, spread=0.01)]
    group = _tree(15, 2)
    got = _run(shape, cases + [({"group": True, "stacked": params_from_numpy(
        group, "cpu")}, None)], [("replica",)])
    # core.online's process-group mean and divergence
    jg = jax.tree.map(jnp.asarray, group)
    for g in got.pop():
        for name in group:
            assert _same(g["mean"][name],
                         jon.online_average_canonical(jg)[name])
        np.testing.assert_allclose(float(g["divergence"]),
                                   float(jon.replica_divergence(jg)),
                                   rtol=1e-6)
    P = cases[0][0]["window"].spec.padded
    for g, (_, case) in zip(got, cases):
        _assert_matches_reference(shape, g, case)
    # the f32 W̄ is the canonical mean; the resilient one the masked mean
    jt = jax.tree.map(jnp.asarray, cases[0][1]["np"])
    spec0 = jax_pack_spec(jax.tree.map(lambda x: x[0], jt))
    want = jax_pack(jon.online_average_canonical(jt), spec0)
    assert all(_same(g["mean"], want) for g in got[0])
    jt = jax.tree.map(jnp.asarray, cases[1][1]["np"])
    alive = jnp.asarray([True, False])
    want = jax_pack(jax_masked_mean(jt, alive), spec0)
    assert all(_same(g["mean"], want) for g in got[1])
    assert [float(g["k_alive"]) for g in got[1]] == [1.0, 1.0]
    assert [bool(g["alive"][0]) for g in got[1]] == [True, False]
    # the reference's bf16 budget: the restart is the bf16 rounding of
    # the f32 restart, W̿ within 4 relative bf16 ULPs of the f32 leg's
    for f, b in zip(got[4], got[5]):
        for name in f["params"]:
            assert torch.equal(b["params"][name], f["params"][name]
                               .to(torch.bfloat16).float())
            assert rel_ulp_error(f["wa"][name], b["wa"][name],
                                 "bf16") <= 4.0
    # the ledger: one two-way all-reduce of the packed f32 buffer; two
    # resilient (the alive count first)
    for g in got[0] + got[2] + got[3] + got[4] + got[5]:
        assert g["collectives"] == {"replica": {
            "all_reduce": 1, "all_gather": 0, "gather": 0, "barrier": 0,
            "bytes": 4 * P, "staged_bytes": 0}}
    for g in got[1]:
        assert g["collectives"]["replica"]["all_reduce"] == 2
        assert g["collectives"]["replica"]["bytes"] == 4 * P + 4


def test_two_level_sync_four_ranks_matches_reference_0ulp():
    shape = {"pod": 2, "replica": 2}
    cases = [_case(_plan(4, tree=True), 20, 4),
             _case(_plan(4, tree=True), 21, 4, inner=True),
             _case(_plan(4, tree=True, wa="bf16", comms="bf16"), 22, 4),
             _case(_plan(4, tree=True, wa="fp8", comms="fp8"), 23, 4),
             _case(_plan(4, tree=True, resilient=True), 24, 4, nan_rank=2),
             _case(_plan(4, tree=True), 25, 4, spread=0.01),
             _case(_plan(4, tree=True, wa="fp8", comms="fp8"), 25, 4,
                   spread=0.01)]
    got = _run(shape, cases, [("replica",), ("pod",)])
    P = cases[0][0]["window"].spec.padded
    for g, (_, case) in zip(got, cases):
        _assert_matches_reference(shape, g, case)
    jt = jax.tree.map(jnp.asarray, cases[0][1]["np"])
    spec0 = jax_pack_spec(jax.tree.map(lambda x: x[0], jt))
    want = jax_pack(jon.online_average_grouped(jt, 2), spec0)
    assert all(_same(g["mean"], want) for g in got[0])
    jt = jax.tree.map(jnp.asarray, cases[1][1]["np"])
    pods = jon.pod_mean_grouped(jt, 2)
    for r, g in enumerate(got[1]):
        assert _same(g["mean"], jax_pack(jax.tree.map(
            lambda x: x[r // 2], pods), spec0))
    # the reference's fp8 budget: the fp8 ring and fp8 cross-pod payload
    # keep W̿ within 4 relative fp8 ULPs of the f32 tree's
    for f, q in zip(got[5], got[6]):
        for name in f["wa"]:
            assert rel_ulp_error(f["wa"][name], q["wa"][name], "fp8") <= 4.0
    assert [float(g["k_alive"]) for g in got[4]] == [3.0] * 4
    assert got[1][0]["declared"] == {"replica": {"all_reduce": 1}}
    inner_lvl = {"all_reduce": 1, "all_gather": 0, "gather": 0,
                 "barrier": 0, "bytes": 4 * P, "staged_bytes": 0}
    for g in got[0] + got[5]:
        assert g["collectives"] == {"replica": inner_lvl, "pod": inner_lvl}
    for g in got[1]:              # inner: nothing crosses pods
        assert g["collectives"] == {"replica": inner_lvl}
    for i, tok in ((2, "bf16"), (3, "fp8"), (6, "fp8")):
        for g in got[i]:
            pod = g["collectives"]["pod"]
            assert g["collectives"]["replica"] == inner_lvl
            assert pod["all_reduce"] == 0
            assert pod["all_gather"] == (2 if tok == "fp8" else 1)
            assert pod["bytes"] == _pod_bytes(g, P, tok)
    for g in got[4]:
        assert g["collectives"]["replica"]["all_reduce"] == 2
        assert g["collectives"]["pod"]["all_reduce"] == 2


def test_flat_sync_three_ranks_takes_the_all_gather_branch():
    shape = {"replica": 3}
    case, full = _case(_plan(3), 30, 3)
    (got,) = _run(shape, [(case, full)], [("replica",)])
    jt = jax.tree.map(jnp.asarray, full["np"])
    spec0 = jax_pack_spec(jax.tree.map(lambda x: x[0], jt))
    canon = jon.online_average_canonical(jt)
    want = jax_pack(canon, spec0)
    jws, wa_buf, _ = jax_window_push_packed(
        JaxHWAConfig(n_replicas=3, window=I), want, full["jws"],
        jnp.int32(3))
    wa = jax_unpack(wa_buf, spec0)
    P = spec0.padded
    for g in got:
        assert _same(g["mean"], want)
        assert _same(g["window"].ring, jws.ring)
        assert _same(g["window"].total, jws.total)
        for name in full["np"]:
            assert _same(g["params"][name], canon[name])
            assert _same(g["wa"][name], wa[name])
        assert g["collectives"] == {"replica": {
            "all_reduce": 0, "all_gather": 1, "gather": 0, "barrier": 0,
            "bytes": 4 * P, "staged_bytes": 0}}
        assert g["declared"] == {"replica": {"all_gather": 1}}


@pytest.mark.parametrize("tok", ["bf16", "fp8"])
def test_chunked_compressed_update_keeps_the_bits(tok, monkeypatch):
    """The plain compressed-ring update works SLOT_CHUNK elements at a
    time (whole scale blocks): with a chunk of two blocks over five, the
    ring, scales, total, comp and W̿ are the bits of one pass."""
    from repro_torch.kernels import ref
    P = 5 * ALIGN
    one = {"x": np.zeros(P, np.float32)}
    new = torch.from_numpy(np.random.default_rng(7).standard_normal(P)
                           .astype(np.float32))

    def push(chunk):
        monkeypatch.setattr(ref, "SLOT_CHUNK", chunk)
        _, ws = _window(one, tok, 3)
        out = ref.wa_window_update_c_ref(
            ws.ring, ws.scales, ws.total, ws.comp, new, torch.tensor(1),
            torch.tensor(1.0), torch.tensor(1 / 3))
        return [x for x in out if x is not None]
    for a, b in zip(push(P), push(2 * ALIGN)):
        assert _same(a, _np(b))


@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_local_inner_step_leaf_at_a_time(optimizer):
    """``core.hwa.hwa_local_inner_step`` (a rank's train step) steps the
    optimizer one leaf at a time in place: two steps of the smoke
    granite-3-2b (f32) give the bits of the whole tree's update (SGD's
    momentum, AdamW's moments and count). With SGD they stay within 1e-5
    of the reference's ``hwa_local_inner_step``; AdamW's first steps are
    about lr times the gradients' signs, so a near-zero gradient that
    differs in its last bits moves its element by up to 2 lr, and only
    its first loss is held to the reference."""
    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.core.hwa import hwa_local_inner_step as jax_local_step
    from repro.models.registry import build_model as jax_build_model
    from repro.optim import adamw as jax_adamw
    from repro.optim import sgd as jax_sgd
    from repro_torch.common.pytree import (tree_flatten, tree_leaves,
                                           tree_map, tree_unflatten)
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.hwa import hwa_local_inner_step
    from repro_torch.launch.train import mesh_batch
    from repro_torch.models.registry import build_model
    from repro_torch.optim import apply_updates
    lm = build_model(get_smoke_config("granite-3-2b"))
    jlm = jax_build_model(jax_smoke_config("granite-3-2b"))
    opt = pbundles._mk_optimizer(optimizer)
    jopt = (jax_sgd(momentum=0.9, weight_decay=5e-4) if optimizer == "sgd"
            else jax_adamw(weight_decay=0.1))
    params = lm.init(torch.Generator().manual_seed(0), device="cpu")
    # copied: the port's step writes its parameters in place
    jparams = jax.tree.map(lambda x: jnp.asarray(np.array(x)),
                           params_to_numpy(params))
    state, jstate = opt.init(params), jopt.init(jparams)
    ref_p, ref_s = tree_map(torch.clone, params), tree_map(torch.clone,
                                                           state)
    for step in range(2):
        b = {k: v[0] for k, v in mesh_batch(0, step, 1, 4, 16, 128).items()}
        tb = {k: torch.from_numpy(v) for k, v in b.items()}
        # the whole tree's update, on copies
        live = tree_map(lambda x: x.detach().requires_grad_(True), ref_p)
        loss, _ = lm.loss(live, tb)
        grads = torch.autograd.grad(loss, tree_leaves(live))
        with torch.no_grad():
            _, treedef = tree_flatten(ref_p)
            upd, ref_s = opt.update(tree_unflatten(treedef, list(grads)),
                                    ref_s, ref_p, 0.1)
            ref_p = apply_updates(ref_p, upd)
        params, state, got_loss, _ = hwa_local_inner_step(
            params, state, tb, lm.loss, opt, 0.1)
        jparams, jstate, jloss, _ = jax_local_step(
            jparams, jstate, {k: jnp.asarray(v, jnp.int32)
                              for k, v in b.items()}, jlm.loss, jopt, 0.1)
        assert float(got_loss) == float(loss.detach())
        if optimizer == "sgd" or step == 0:
            np.testing.assert_allclose(float(got_loss), float(jloss),
                                       rtol=1e-5)
    for a, b in zip(tree_leaves((params, state)), tree_leaves((ref_p,
                                                                ref_s))):
        assert torch.equal(a, b)
    if optimizer == "sgd":
        for a, b in zip(tree_leaves((params, state)),
                        jax.tree.leaves((jparams, jstate))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
