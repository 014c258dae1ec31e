"""hwa-lint for the port: build the bundle matrix, run each bundle once
under the recorder and check every declarative contract (counterpart of
``repro.analysis.lint`` and ``tools/hwa_lint.py``)::

    python -m repro_torch.analysis.lint [--smoke] [--json PATH]
        [--only SUBSTR] [--device cuda|cpu]

The matrix is the reference's 17 cases, under its names and smoke flags:
the flat, two-level and grouped-FSDP syncs, the tree's inner sync, the
train steps and the paged decode step, on a (replica 2, data 2, model 2)
mesh, the pod-carved (pod 2, replica 2, model 2) tree mesh and one
device. A mesh case runs in spawned ranks (``launch.mesh.spawn_ranks``),
one spawn a mesh shape running all of that shape's cases; the passes
run in each rank and a case holds where it holds on every rank. The
``@1dev`` cases run in this process. The reference builds three cases
as GSPMD programs (``mesh_native=False``), which the port leaves
unported (XLA's partitioner has no PyTorch counterpart):
``train/hwa-vmap``, ``sync/flat-vmap-k4-kernel`` and
``sync/legacy-kernel@1dev`` run the port's one-process stacked
``core.hwa`` step instead, in this process, held to the reference's
contract formulas for a process-local replica stack (no collectives,
the f32 payload and argument discipline). Their launch budgets are the
port's: the stacked sync is ONE fused launch (``wa_sync_fused``) where
the reference's sharded stack counts 2 (mean and push).

The default device is the card; without one the run fails unless
``--device cpu`` is given (it does not fall back). On the CPU no kernel
launches (a wrapper given a CPU tensor runs its plain version), so the
launch budgets report ``skipped``; on the card they are exact. The exit
status is 0 only if the report is ok. ``REPRO_LINT_SMOKE=1`` (or
``--smoke``) runs the smoke subset, the reference's 8.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Any, Callable

#: env var selecting the smoke subset
SMOKE_ENV = "REPRO_LINT_SMOKE"

#: the matrix: "module:function" of a ``(cfg) -> [LintCase]`` factory,
#: resolved by name in this process and in every spawned rank
CASES = "repro_torch.analysis.lint:default_cases"

#: the reference's test meshes (``make_test_mesh((2, 2, 2), ...)`` and
#: ``make_tree_test_mesh()``), as rank meshes
MESH_222 = {"replica": 2, "data": 2, "model": 2}
MESH_TREE = {"pod": 2, "replica": 2, "model": 2}
#: the reference's batch (``InputShape("tiny", seq_len=16,
#: global_batch=8)``), a replica's rows, and the state's seed
SEQ_LEN = 16
BATCH = 8
SEED = 0
#: the decode bundle's engine (the reference's defaults)
DECODE = dict(max_batch=2, max_seq_len=64, max_new=4, page_size=4)


@dataclasses.dataclass
class LintCase:
    """One bundle×mesh configuration of the matrix: ``build(ctx)`` gives
    ``(bundle, args)`` for a context (:class:`Ctx`: the rank's mesh, or
    none, and the device); ``mesh`` the rank-mesh shape it runs on (None:
    in this process)."""
    name: str
    build: Callable[["Ctx"], tuple]
    smoke: bool = False
    mesh: dict | None = None


@dataclasses.dataclass
class Ctx:
    device: Any
    mesh: Any = None


def _replica(ctx) -> int:
    from repro_torch.launch import shards
    return 0 if ctx.mesh is None else shards.replica_index(ctx.mesh)


def _batch(cfg, K: int, ctx, rep=None):
    """The (K, BATCH, SEQ_LEN) batch of step 0 (``launch.train
    .mesh_batch``): replica ``rep``'s rows, or all K stacked."""
    import torch

    from repro_torch.launch.train import mesh_batch
    b = mesh_batch(SEED, 0, K, BATCH, SEQ_LEN, cfg.vocab_size)
    return {k: torch.from_numpy(v if rep is None else v[rep]).to(ctx.device)
            for k, v in b.items()}


def _init(lm, ctx):
    import torch
    return lm.init(torch.Generator(device=ctx.device).manual_seed(SEED),
                   device=ctx.device)


def _mesh_bundles(lm, ctx, plan, fsdp=False, train=False):
    """The rank's bundles and its state, as ``launch.train.mesh_rank``
    builds them: the parameters whole or as the rank's blocks."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.launch.sync import build_hwa_bundles
    from repro_torch.models.parallel import blocks_of
    full = _init(lm, ctx)
    bundles = build_hwa_bundles(lm, ctx.mesh, plan, full, fsdp=fsdp,
                                seq_len=SEQ_LEN if train else None,
                                train=train)
    lay = bundles.layout
    if lay.whole or not lay.split:
        return bundles, full
    return bundles, tree_map(lambda x: x.contiguous().clone(),
                             blocks_of(full, lay.places, ctx.mesh))


def _mesh_train(lm, hwa):
    from repro_torch.launch.sync import SyncPlan
    from repro_torch.launch.sync.bundles import _mk_optimizer

    def build(ctx):
        plan = SyncPlan(hwa=hwa, optimizer="sgd")
        bundles, params = _mesh_bundles(lm, ctx, plan, train=True)
        opt = _mk_optimizer(plan.optimizer)
        return bundles.train, (params, opt.init(params),
                               _batch(lm.cfg, hwa.n_replicas, ctx,
                                      _replica(ctx)))
    return build


def _mesh_sync(lm, hwa, *, fsdp=False, inner=False, **plan_kw):
    from repro_torch.launch.sync import SyncPlan, window_state_args

    def build(ctx):
        plan = SyncPlan(hwa=hwa, **plan_kw)
        bundles, params = _mesh_bundles(lm, ctx, plan, fsdp=fsdp)
        if inner:
            return bundles.inner_sync, (params,)
        ws, cycle = window_state_args(bundles, device=ctx.device)
        return bundles.sync, (params, ws, cycle)
    return build


def stacked_train_bundle(lm, hwa):
    """The stand-in for the reference's GSPMD vmap train step: the K
    stacked replicas' steps in this process (``core.hwa
    .hwa_inner_step``), ``fn(inner, inner_opt, batches) -> (inner,
    inner_opt, loss)``, both written in place. Its launches: the flash
    forward and both sweeps once a layer a replica under
    ``flash_pallas`` with remat off, none without ``flash_pallas``. Its
    working set (activations, gradients) is not bounded."""
    from repro_torch.analysis.contracts import train_contract
    from repro_torch.core.hwa import HWAState, hwa_inner_step
    from repro_torch.launch.sync.bundles import StepBundle, _mk_optimizer
    opt = _mk_optimizer("sgd")
    cfg = lm.cfg
    K = hwa.n_replicas

    def fn(inner, inner_opt, batches):
        import torch
        zero = torch.zeros((), dtype=torch.int32)
        state = HWAState(inner=inner, inner_opt=inner_opt,
                         window_state=None, wa=None, cycle=zero, step=zero)
        state, m = hwa_inner_step(hwa, state, batches, lm.loss, opt, 3e-4)
        return state.inner, state.inner_opt, m["loss"]
    if cfg.attn_impl == "flash_pallas":
        exact = cfg.remat == "none" and cfg.family in ("dense", "moe")
        launches = (dict.fromkeys(("flash_fwd", "flash_bwd_dq",
                                   "flash_bwd_dkv"), K * cfg.n_layers)
                    if exact else None)
    else:
        launches = {}
    return StepBundle(fn=fn, donate_argnums=(0, 1),
                      carry=lambda a, o: (o[0], o[1], a[2]),
                      contract=train_contract(
                          launches=launches,
                          notes="one-process stacked HWA inner step (the "
                                "GSPMD vmap step's stand-in)"))


def stacked_sync_bundle(hwa, params):
    """The stand-in for the reference's GSPMD stacked syncs (the vmap
    path and the legacy one): ``core.hwa.hwa_sync`` over the K replicas
    stacked in this process, ``fn(inner, inner_opt, window_state, wa,
    cycle)`` returning the same, the replicas, ring and total written in
    place. With ``use_kernels`` and an f32 ring it is ONE fused launch.
    Contract: the reference's formula for a process-local stack (no
    collectives anywhere, f32 payloads and arguments); on the fused
    route (``core.hwa._sync_fused``) its working set is the larger of
    its two phases, in f32 bytes of ``params``: the replicas' divergence
    (the leaves' mean, one packed block, beside a leaf's K deviations
    and their squares, 2K of its largest leaf), then the K replicas
    packed and W̿ (K + 1 blocks)."""
    from repro_torch.analysis.contracts import PEAK_SLACK, sync_contract
    from repro_torch.common.packing import pack_spec
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.core.hwa import HWAState, hwa_sync
    from repro_torch.launch.sync.bundles import StepBundle, _float_tokens
    fused = (hwa.use_kernels and hwa.window_kind == "ring"
             and hwa.window_stride == 1 and not hwa.resilient)
    block = 4 * pack_spec(params).padded
    leaf = 4 * max(x.numel() for x in tree_leaves(params))
    K = hwa.n_replicas

    def fn(inner, inner_opt, window_state, wa, cycle):
        state = HWAState(inner=inner, inner_opt=inner_opt,
                         window_state=window_state, wa=wa, cycle=cycle,
                         step=cycle)
        state, _ = hwa_sync(hwa, state)
        return (state.inner, state.inner_opt, state.window_state, state.wa,
                state.cycle)
    return StepBundle(fn=fn, donate_argnums=(0, 1, 2),
                      carry=lambda a, o: o,
                      contract=sync_contract(
                          (), n_collectives=0,
                          launches={"wa_sync_fused": 1}
                          if hwa.use_kernels else {},
                          float_args=_float_tokens(params),
                          peak_bytes=max((K + 1) * block,
                                         block + 2 * K * leaf)
                          + PEAK_SLACK if fused else None,
                          notes="one-process stacked HWA sync (the GSPMD "
                                "stacked sync's stand-in)"))


def _stacked_train(lm, hwa):
    def build(ctx):
        from repro_torch.core.hwa import hwa_init
        from repro_torch.launch.sync.bundles import _mk_optimizer
        state = hwa_init(hwa, _init(lm, ctx), _mk_optimizer("sgd"))
        return stacked_train_bundle(lm, hwa), (
            state.inner, state.inner_opt, _batch(lm.cfg, hwa.n_replicas,
                                                 ctx))
    return build


def _stacked_sync(lm, hwa):
    def build(ctx):
        from repro_torch.core.hwa import hwa_init
        from repro_torch.launch.sync.bundles import _mk_optimizer
        params = _init(lm, ctx)
        state = hwa_init(hwa, params, _mk_optimizer("sgd"))
        return stacked_sync_bundle(hwa, params), (
            state.inner, state.inner_opt, state.window_state, state.wa,
            state.cycle)
    return build


def decode_args(lm, params, ctx, *, max_batch, max_seq_len, max_new,
                page_size):
    """A decode step's arguments from a fresh ``PagedDecodeEngine``'s
    state: slot 0 fed its prompt token at position 5 (its recurrent state
    reset, its sample to the scratch column), slot 1 its last sample at
    position 9 (to column 0), each over its own pages."""
    import torch

    from repro_torch.serve.engine import PagedDecodeEngine
    eng = PagedDecodeEngine(lm, params, max_batch, max_seq_len, max_new,
                            page_size=page_size, device=ctx.device)
    B, TW = max_batch, eng.table_width
    dev = ctx.device
    cb = (lm.cfg.n_codebooks,) if lm.cfg.family == "audio" else ()
    ctrl = {
        "tables": (1 + torch.arange(B * TW, dtype=torch.int32,
                                    device=dev)).reshape(B, TW),
        "pos": torch.tensor([5 + 4 * b for b in range(B)],
                            dtype=torch.int32, device=dev),
        "use_prompt": torch.arange(B, device=dev) == 0,
        "prompt_tok": torch.full((B,) + cb, 7, dtype=torch.int32,
                                 device=dev),
        "out_idx": torch.tensor([eng.scratch_idx] + [0] * (B - 1),
                                dtype=torch.int32, device=dev),
        "reset": torch.arange(B, device=dev) == 0}
    s = eng.state
    return (params, s["caches"], s["last"], s["out"], s["generator"], ctrl)


def _decode(lm):
    def build(ctx):
        from repro_torch.serve.engine import make_paged_decode_bundle
        params = _init(lm, ctx)
        return make_paged_decode_bundle(lm, **DECODE), decode_args(
            lm, params, ctx, **DECODE)
    return build


def default_cases(cfg=None, train_attn: str | None = None
                  ) -> list[LintCase]:
    """The reference's matrix (``repro.analysis.lint.default_cases``),
    its names and smoke flags, on the port's bundles. ``cfg`` is the
    model (default: granite-3-2b's smoke config, the reference's);
    ``train_attn`` sets the stacked train step's ``attn_impl`` (the card
    leg runs it under ``flash_pallas``)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.hwa import HWAConfig
    from repro_torch.launch.sync.topology import TwoLevel
    from repro_torch.models.registry import build_model

    cfg = cfg or get_smoke_config("granite-3-2b")
    lm = build_model(cfg)
    lm_fp = build_model(cfg.with_(attn_impl="flash_pallas"))
    lm_st = lm if train_attn is None else build_model(
        cfg.with_(attn_impl=train_attn))

    hwa2 = HWAConfig(n_replicas=2, window=3)
    hwa2k = HWAConfig(n_replicas=2, window=3, use_kernels=True)
    hwa4k = HWAConfig(n_replicas=4, window=3, use_kernels=True)
    hwa4t = HWAConfig(n_replicas=4, window=3, use_kernels=True,
                      outer_every=2)
    hwa2r = HWAConfig(n_replicas=2, window=3, resilient=True)
    hwa4tr = HWAConfig(n_replicas=4, window=3, outer_every=2,
                       resilient=True)
    topo = TwoLevel("replica", "pod", outer_every=2)
    m, t = MESH_222, MESH_TREE
    return [
        LintCase("train/mesh-native@2x2x2", _mesh_train(lm, hwa2),
                 smoke=True, mesh=m),
        # flash_pallas: the replica whole on each rank (the model axis
        # repeats the step, as in the reference), one forward and two
        # recompute sweeps an attention layer
        LintCase("train/mesh-native-flash-pallas@2x2x2",
                 _mesh_train(lm_fp, hwa2), smoke=True, mesh=m),
        LintCase("train/hwa-vmap@2x2x2", _stacked_train(lm_st, hwa2)),
        LintCase("sync/flat-resident@2x2x2", _mesh_sync(lm, hwa2),
                 smoke=True, mesh=m),
        LintCase("sync/flat-resident-kernel@2x2x2", _mesh_sync(lm, hwa2k),
                 smoke=True, mesh=m),
        LintCase("sync/flat-vmap-k4-kernel@2x2x2", _stacked_sync(lm, hwa4k)),
        LintCase("sync/fsdp-grouped-kernel@2x2x2",
                 _mesh_sync(lm, hwa2k, fsdp=True), mesh=m),
        LintCase("sync/two-level-outer-kernel@tree",
                 _mesh_sync(lm, hwa4t, topology=topo), mesh=t),
        # compressed precision corners: the bf16 ring keeps its kernel;
        # bf16 comms cross the pods as the uint8 view of a bf16 payload,
        # fp8 comms as the uint8 view of fp8 beside f32 block scales
        LintCase("sync/flat-resident-bf16-ring@2x2x2",
                 _mesh_sync(lm, hwa2k, wa_dtype="bf16"), smoke=True, mesh=m),
        LintCase("sync/two-level-outer-bf16-comms@tree",
                 _mesh_sync(lm, hwa4t, topology=topo, wa_dtype="bf16",
                            comms_dtype="bf16"), mesh=t),
        LintCase("sync/two-level-outer-fp8@tree",
                 _mesh_sync(lm, hwa4t, topology=topo, wa_dtype="fp8",
                            comms_dtype="fp8"), mesh=t),
        # resilient: two replica-level reductions (the alive count, the
        # masked weights) and the health stats' one over the other axes
        LintCase("sync/flat-resident-resilient@2x2x2",
                 _mesh_sync(lm, hwa2r), smoke=True, mesh=m),
        LintCase("sync/fsdp-grouped-resilient@2x2x2",
                 _mesh_sync(lm, hwa2r, fsdp=True), mesh=m),
        LintCase("sync/two-level-outer-resilient@tree",
                 _mesh_sync(lm, hwa4tr, topology=topo), mesh=t),
        LintCase("sync/two-level-inner@tree",
                 _mesh_sync(lm, hwa4t, topology=topo, inner=True), mesh=t),
        LintCase("sync/legacy-kernel@1dev", _stacked_sync(lm, hwa2k),
                 smoke=True),
        # the paged decode step: no collectives, the paged kernel once an
        # attention layer, its state written in place
        LintCase("serve/paged-decode@1dev", _decode(lm_fp), smoke=True),
    ]


def _levels(shape: dict) -> list[tuple[str, ...]]:
    """Every level a case on ``shape`` reduces over: each axis, the
    inner axes together (the health stats), the replica axes together."""
    axes = tuple(shape)
    inner = tuple(a for a in axes if a in ("data", "model"))
    rep = tuple(a for a in axes if a in ("pod", "replica"))
    return [(a,) for a in axes] + [inner, rep]


def _lint_one(case: LintCase, ctx: Ctx) -> dict:
    """Build and record one case; returns its pass results, its census
    (``analysis.passes.census``), its contract and declared launches, or
    its error."""
    from repro_torch.analysis.passes import census, record_call, run_passes
    try:
        bundle, args = case.build(ctx)
        _, art = record_call(bundle, args, mesh=ctx.mesh)
        contract = bundle.contract
        results = run_passes(art, contract)
    except Exception as e:                      # noqa: BLE001
        return {"error": f"{type(e).__name__}: {e}"}
    launch = contract.launch
    return {"results": results, "census": census(art), "contract": contract,
            "declared_launches": None if launch is None else launch.counts}


def _factory(name: str) -> Callable:
    from repro_torch.launch.mesh import _resolve
    return _resolve(name)


def lint_rank(mesh, payload) -> list[dict]:
    """One rank of a mesh spawn (``launch.mesh.spawn_ranks`` target): each
    named case of ``payload["cases"]`` (from the ``payload["factory"]``
    matrix, :data:`CASES` in the parent) built and recorded here."""
    by_name = {c.name: c for c in _factory(payload["factory"])(
        payload["cfg"])}
    ctx = Ctx(device=mesh.device, mesh=mesh)
    return [_lint_one(by_name[n], ctx) for n in payload["cases"]]


def _entry(name: str, per_rank: list[dict], facts: dict | None) -> dict:
    from repro_torch.analysis.passes import merge_ranks
    from repro_torch.analysis.report import bundle_entry
    errors = [r["error"] for r in per_rank if "error" in r]
    if errors:
        return bundle_entry([], error=errors[0])
    results = merge_ranks([r["results"] for r in per_rank])
    if facts is not None:
        facts[name] = {"census": per_rank[0]["census"],
                       "declared_launches": per_rank[0]["declared_launches"],
                       "contract": per_rank[0]["contract"],
                       "ranks": len(per_rank)}
    return bundle_entry(results)


def run_lint(cases: list[LintCase] | None = None, smoke: bool = False,
             device: str = "cuda", log=print, facts: dict | None = None,
             cfg=None) -> dict:
    """Lint ``cases`` (default: the whole matrix of :data:`CASES` for
    ``cfg``) on ``device``: each mesh shape's cases in one spawn, whose
    ranks rebuild them by name from :data:`CASES`, the others here. A
    build or call that raises, or a spawn that fails, becomes an
    ``error`` entry. ``facts``, when given, receives each case's census,
    contract and declared launches."""
    import torch

    from repro_torch.analysis.report import build_report
    from repro_torch.launch.mesh import spawn_ranks
    cases = _factory(CASES)(cfg) if cases is None else cases
    if smoke:
        cases = [c for c in cases if c.smoke]
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("hwa-lint runs on the card by default and this "
                           "machine has none; pass --device cpu")
    entries: dict[str, dict] = {}
    shapes: dict[tuple, list[LintCase]] = {}
    for c in cases:
        if c.mesh is not None:
            shapes.setdefault(tuple(c.mesh.items()), []).append(c)
    for shape, group in shapes.items():
        names = [c.name for c in group]
        log(f"lint: {len(names)} case(s) on {dict(shape)} ...")
        try:
            ranks = spawn_ranks(dict(shape), "repro_torch.analysis.lint:"
                                "lint_rank", {"cases": names, "cfg": cfg,
                                              "factory": CASES},
                                device=device, levels=_levels(dict(shape)),
                                collective_timeout=120.0)
        except Exception as e:                  # noqa: BLE001
            for n in names:
                entries[n] = {"ok": False, "passes": {},
                              "error": f"{type(e).__name__}: {e}"}
            continue
        for i, n in enumerate(names):
            entries[n] = _entry(n, [r["result"][i] for r in ranks], facts)
    ctx = Ctx(device=dev)
    for c in cases:
        if c.mesh is None:
            log(f"lint: {c.name} ...")
            entries[c.name] = _entry(c.name, [_lint_one(c, ctx)], facts)
    return build_report({c.name: entries[c.name] for c in cases},
                        smoke=smoke)


def main(argv: list[str] | None = None) -> int:
    from repro_torch.analysis.report import report_ok, summarize, to_json

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Declarative contract checker over the port's bundle "
                    "matrix (collectives, launch budgets, in-place state, "
                    "dtype discipline).")
    ap.add_argument("--smoke", action="store_true",
                    help=f"the smoke subset (also via {SMOKE_ENV}=1)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the machine-readable report here")
    ap.add_argument("--only", metavar="SUBSTR", default=None,
                    help="run only cases whose name contains SUBSTR")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the bundles run (default: the card)")
    ap.add_argument("--list", action="store_true",
                    help="list the matrix's case names and exit")
    args = ap.parse_args(argv)

    smoke = args.smoke or os.environ.get(SMOKE_ENV) == "1"
    cases = _factory(CASES)(None)
    if args.list:
        for c in cases:
            print(("[smoke] " if c.smoke else "        ") + c.name)
        return 0
    if args.only:
        cases = [c for c in cases if args.only in c.name]
        if not cases:
            print(f"no lint case matches {args.only!r}", file=sys.stderr)
            return 2
    try:
        report = run_lint(cases, smoke=smoke, device=args.device)
    except RuntimeError as e:
        print(f"hwa-lint: {e}", file=sys.stderr)
        return 2
    if args.json:
        with open(args.json, "w") as f:
            f.write(to_json(report) + "\n")
        print(f"report written to {args.json}")
    print(summarize(report))
    return 0 if report_ok(report) else 1


if __name__ == "__main__":
    sys.exit(main())
