"""The mesh-native HWA step builders (counterpart of the reference's
``_make_mesh_hwa_train_step``, ``_make_mesh_hwa_sync_step`` and
``_make_mesh_hwa_inner_sync_step`` in ``repro.launch.sync.bundles``).

Each builder returns a :class:`StepBundle`: a plain callable on one
rank's tensors, the packed layout its window state lives in, and its
declared contract (kernel launches on the card and collectives a call).
The GSPMD builders (``make_train_step``, ``make_prefill_step``,
``make_decode_step``) and ``legacy.py`` are not ported: they exist for
XLA's partitioner.

A replica spans ``data × model`` ranks (1 × 1: one rank holds it whole).
:func:`replica_layout` resolves the reference's rules
(``sharding.rules.make_tp_rules``) over the rank mesh into each leaf's
place and the packed layout of the sync (``packed.choose_resident_spec``).
The train step has the reference's two forms:

- ``flash_pallas`` (the reference's fully manual step): the replica's
  parameters whole on each of its ranks, each rank stepping ``B / data``
  rows, the gradients and the loss averaged over ``data`` (one sum);
- every other ``attn_impl`` (the reference's GSPMD step): each rank holds
  its blocks of the leaves and runs the model with a ``par``
  (``models.parallel``): tensor parallelism over ``model``, FSDP's
  gathers over ``data``, the data mean of the other leaves' gradients.

Neither crosses a replica axis. The sync step is
``packed._local_packed_sync`` over the topology's composition, on the
rank's segment of the layout; the inner-sync step (two-level tree only)
is ``packed._local_inner_sync``. Where the parameters rest whole but the
layout splits them (``flash_pallas`` with ``--fsdp``), the rank syncs its
block in place and the rest step all-gathers the replica's blocks back,
outside the sync.

:func:`sync_collective_contract` declares what a sync issues, per level
(``launch.mesh.LEDGER``'s names), as an ``analysis.contracts``
``BundleContract``: the one declaration that ``launch.train.mesh_rank``
records beside each call's record (``analysis.passes.record_call``), that
``analysis.passes`` checks it against, and whose
``BundleContract.ledger`` view the tests hold the ledger's counts to.
:func:`sync_collective_audit` gives each sync the reference's per-level
verdicts over the rank groups its collectives ran on.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable

import torch

from repro_torch.analysis.contracts import (DEFAULT_CONTRACT, PEAK_SLACK,
                                            BundleContract,
                                            CollectiveContract,
                                            DonationPolicy, LaunchBudget,
                                            sync_contract, train_contract)
from repro_torch.common.packing import pack_spec
from repro_torch.common.pytree import tree_leaves
from repro_torch.core.hwa import HWAConfig, hwa_local_inner_step
from repro_torch.launch.mesh import _is_pow2, level_name
from repro_torch.launch.sync.packed import (_local_inner_sync,
                                            _local_packed_sync,
                                            choose_resident_spec,
                                            packed_sync_launch_budget,
                                            packed_sync_working_set)
from repro_torch.launch.sync.topology import Flat, SyncTopology, TwoLevel
from repro_torch.optim import adamw, sgd


@dataclasses.dataclass(frozen=True)
class StepBundle:
    """A step callable with what it declares: ``pack_spec`` (the packed
    layout its window state lives in; None for a train step),
    ``contract`` (an ``analysis.contracts.BundleContract``: the
    collectives a call issues a level, the kernels it launches on the
    card, its dtype and in-place discipline), ``donate_argnums`` (the
    arguments whose every leaf it writes in place and returns as the
    state the caller carries on) and ``carry``:
    ``carry(args, out)`` gives the arguments the caller passes to the
    next call, the state it carries on (``args`` itself when None)."""
    fn: Callable
    pack_spec: Any = None
    contract: BundleContract = DEFAULT_CONTRACT
    donate_argnums: tuple = ()
    carry: Callable | None = None

    def __call__(self, *args, **kwargs):
        return self.fn(*args, **kwargs)

    def next_args(self, args, out) -> tuple:
        return tuple(args) if self.carry is None \
            else tuple(self.carry(args, out))


def _mk_optimizer(name: str):
    if name == "sgd":
        return sgd(momentum=0.9, weight_decay=5e-4)
    return adamw(weight_decay=0.1)


def _check_outer_every(hwa_cfg: HWAConfig, topology: SyncTopology) -> None:
    """One source of truth for H₂: the training loop schedules off
    ``topology.is_outer`` while ``HWAConfig.outer_every`` rides along in
    config records and checkpoints; refuse silently-disagreeing values
    with the reference's messages."""
    if isinstance(topology, TwoLevel):
        if hwa_cfg.outer_every != topology.outer_every:
            raise ValueError(
                f"HWAConfig.outer_every={hwa_cfg.outer_every} disagrees "
                f"with TwoLevel.outer_every={topology.outer_every}; set "
                "both from the same value (the training loop schedules off "
                "the topology)")
    elif hwa_cfg.outer_every != 1:
        raise ValueError(
            f"HWAConfig.outer_every={hwa_cfg.outer_every} would be "
            "silently ignored: this sync path is flat (every sync is "
            "outer). Use make_mesh_hwa_sync_step with a TwoLevel "
            "topology for the H·H₂ hierarchy, or leave outer_every at 1")


#: the axes inside a replica, in the reference's mesh order
INNER_AXES = ("data", "model")


@dataclasses.dataclass(frozen=True)
class ReplicaLayout:
    """How a replica splits over its ranks: the rule table, each leaf's
    place (``models.parallel.LeafPlace`` tree), the packed layout of the
    sync (global; a rank holds ``spec.local_spec()``) and whether the
    parameters rest whole on each rank (the ``flash_pallas`` step)."""
    rules: Any
    places: Any
    spec: Any
    whole: bool = False

    @property
    def split(self) -> bool:
        """Whether a rank's sync holds only part of the replica."""
        return self.spec.is_sharded


def _level_op(n: int) -> str:
    """The collective one ``ReplicaMesh.psum`` over a level of ``n`` ranks
    is, as ``launch.mesh.record_groups`` logs it: one all-reduce (its
    two-way chain), or an all-gather."""
    return "all_reduce" if _is_pow2(n) else "all_gather"


def inner_axes(mesh) -> tuple[str, ...]:
    """The replica's inner axes of size > 1, in mesh order."""
    return tuple(a for a in mesh.shape if a in INNER_AXES
                 and mesh.shape[a] > 1)


def replica_layout(lm, mesh, topology: SyncTopology, *, fsdp=False,
                   params=None, expert_parallel: bool = False
                   ) -> ReplicaLayout:
    """The reference's sharding of a replica over the rank mesh
    (``make_tp_rules(mesh, replica_axis=..., fsdp=...,
    expert_parallel=...)``), each leaf's place and the layout the chooser
    picks, from ``lm.abstract()``. ``expert_parallel`` (the reference's
    rules-carrying builders, on a config with ``expert_parallel=True``)
    splits the MoE experts over ``model``, whose layer is then
    ``moe.moe_forward_ep``; it needs a model axis that divides the
    experts. With no ``lm`` (a sync on its own) the replica is whole on
    each rank: the layout of ``params``."""
    from repro_torch.common.pytree import tree_flatten
    from repro_torch.models.parallel import places_tree
    from repro_torch.sharding.rules import flatten_dims, make_tp_rules
    if expert_parallel:
        cfg = lm.cfg if lm is not None else None
        tp = mesh.shape.get("model", 1)
        if cfg is None or not cfg.expert_parallel or cfg.family != "moe":
            raise ValueError("expert_parallel needs an MoE config with "
                             "expert_parallel=True")
        if tp == 1 or cfg.n_experts % tp:
            raise ValueError(f"expert_parallel splits {cfg.n_experts} "
                             f"experts over a model axis of {tp}: needs "
                             f"tp > 1 dividing them")
    rules = make_tp_rules(mesh.shape, replica_axis=topology.replica_axes,
                          fsdp=fsdp, expert_parallel=expert_parallel)
    if lm is None:
        flat, _ = tree_flatten(params)
        return ReplicaLayout(rules=rules, places=places_tree(
            params, [()] * len(flat), [(None,) * x.dim() for x in flat]),
            spec=pack_spec(params))
    params_abs, dims = lm.abstract()
    flat, _ = tree_flatten(params_abs)
    shapes = [tuple(x.shape) for x in flat]
    flat_specs = rules.flat_specs(shapes, dims)
    spec = choose_resident_spec(mesh.shape, params_abs, flat_specs, shapes,
                                exclude=topology.replica_axes)
    if spec is None:
        raise ValueError("no packed layout aligns this model's tilings "
                         "(a zero-size leaf split over a rank axis)")
    return ReplicaLayout(
        rules=rules, places=places_tree(params_abs, flat_specs,
                                        flatten_dims(dims)),
        spec=spec, whole=lm.cfg.attn_impl == "flash_pallas")


def sync_collective_contract(mesh, topology: SyncTopology, *, launches,
                             comms_dtype: str = "f32", resilient=False,
                             inner_only: bool = False,
                             float_args=("f32",),
                             peak_bytes: int | None = None, notes: str = ""
                             ) -> BundleContract:
    """The sync's contract (``analysis.contracts.sync_contract`` over the
    rank mesh). Its collectives, as a process logs them
    (``launch.mesh.record_groups``): a level's psum one all-reduce (one
    all-gather where its size is not a power of two), two resilient (the
    alive count, then the weights); the compressed outer level of the
    tree one all-gather (bf16) or two (fp8: payload and scales); a level
    of one rank nothing; a resilient full sync of a replica split over
    inner axes one psum of the health stats over them, the one budgeted
    non-level collective. ``launches``: the kernels a call launches on
    the card. Payloads are f32 but for a compressed outer level, which
    crosses as the ``uint8`` view of its narrow float
    (``packed._psum_composition``) beside f32 (the fp8 scales).
    ``peak_bytes``: the declared working set
    (``packed.packed_sync_working_set``)."""
    groups = (topology.inner_groups() if inner_only
              else topology.psum_groups())
    non_empty = [i for i, axes in enumerate(groups) if axes]
    last = non_empty[-1] if non_empty else None
    rows = []
    for i, axes in enumerate(groups):
        n = mesh.size(axes) if axes else 1
        if n == 1:
            rows.append({})
        elif comms_dtype != "f32" and i == last:
            rows.append({"all_gather": 2 if comms_dtype == "fp8" else 1})
        else:
            rows.append({_level_op(n): 2 if resilient else 1})
    other = {}
    health = inner_axes(mesh)
    if resilient and not inner_only and health:
        other[level_name(health)] = {_level_op(mesh.size(health)): 1}
    payloads = ("f32",)
    if comms_dtype != "f32":
        payloads = ("f32", "bf16" if comms_dtype == "bf16" else "f8e4m3fn",
                    "u8")
    ((op, n),) = rows[0].items() or (("all_reduce", 0),)
    return sync_contract(
        groups[0], launches=launches, n_collectives=n, op=op,
        outer_axis=(topology.outer_axis if isinstance(topology, TwoLevel)
                    else None),
        outer_ops=rows[1] if len(rows) > 1 else {}, other_ops=other,
        collective_dtypes=payloads, float_args=tuple(float_args),
        peak_bytes=peak_bytes, notes=notes)


def _layer_sums(cfg, spec, par, fwd: int, seq_len) -> tuple[int, int,
                                                             int]:
    """The model-axis (sums, all-gathers, all-to-alls) one layer of
    ``spec`` issues a step inside its block (the gathers of its leaves
    before it are :func:`par_step_collectives`'s): a copy to ``model``
    one sum in the backward, a reduction from it one sum in each forward
    (``fwd``: 2 under remat), an activation's gather one all-gather a
    forward, a scatter one in the backward, an exchange one a forward and
    one in the backward."""
    H = cfg.n_heads
    if spec.kind == "mlstm":
        # the input's and b_if's copies, w_out's reduction
        return (2 + fwd, 0, 0) if par.splits(H) else (0, 0, 0)
    if spec.kind == "slstm":
        from repro_torch.models.ssm import slstm_ff
        # the input's and b's copies, the heads' outputs gathered; the
        # split FFN's copy and reduction
        sums, gathers = (2, fwd) if par.splits(H) else (0, 0)
        if par.splits(slstm_ff(cfg.d_model)):
            sums += 1 + fwd
        return sums, gathers, 0
    hidden = cfg.expert_d_ff or cfg.d_ff
    split = [par.heads_split]                      # the attention
    if spec.kind == "hybrid":
        split.append(par.splits(cfg.ssm_heads or H))       # the Mamba heads
    sums = gathers = a2a = 0
    if spec.use_moe and par.expert_parallel:
        a2a = 2 * fwd + 2                # dispatch and return, each way
        if seq_len % par.tp == 0:
            gathers = fwd + 1            # the output's; the scatter's
        else:
            sums += 1                    # the replicated input's copy
        sums += bool(cfg.n_shared_experts)        # sh_route's copy
    elif spec.use_moe:
        split += [par.splits(hidden), bool(cfg.n_shared_experts)
                  and par.splits(cfg.n_shared_experts * hidden)]
    else:
        split.append(par.splits(cfg.d_ff))
    return sums + (1 + fwd) * sum(split), gathers, a2a


def par_step_collectives(par, dtypes, skip, seq_len: int) -> dict:
    """The collectives one train step of ``lm_loss`` with ``par``
    (``models.parallel.Par``) issues a level, counted from the leaves'
    places and the model's layers as the model code issues them: each
    sum one ``ReplicaMesh.psum`` (:func:`_level_op`), each gather one
    all-gather, each exchange one all-to-all, as a process logs them
    (``launch.mesh.record_groups``; the ledger's per-round counts are
    ``analysis.contracts.CollectiveContract.ledger``'s view).

    - ``Par.prepare``, a layer's leaves before the layer and the others
      once: a dim split over ``data`` a gather and, in the backward, a
      sum; a ``head_dim`` split over ``model`` a gather, and a backward
      sum where the heads are split;
    - ``Par.gather_leaves`` (``transformer.model_gathers``), a layer's
      recurrent or expert-parallel leaves before the layer: a dim split
      over ``model`` a gather, and a backward sum where the use is
      partial;
    - with a model axis, a layer's own (:func:`_layer_sums`): the
      head-parallel attention's sums (its input's gradient, ``wo``'s
      output) and those of the split MLP, experts, shared experts or
      Mamba heads, two each, those of the recurrent cells and the
      expert-parallel exchange; the forward's twice under remat (the
      backward runs the layer's forward again). The expert-parallel
      layer's depend on the sequence length ``seq_len`` (the tokens
      split over ``model`` only when it divides);
    - with the vocab split: the embedding's sum, the cross-entropy's
      three sums (the input's gradient, the exponentials, the target's
      logit) and its gather of the maxima;
    - ``Par.data_mean``: one sum a dtype of the leaves it averages."""
    from repro_torch.models.transformer import block_pattern, model_gathers
    mesh, cfg = par.mesh, par.cfg
    sums, gathers, a2a = {}, {}, {}

    def add(into, axes, n=1):
        lvl = level_name(tuple(a for a in mesh.shape if a in axes))
        into[lvl] = into.get(lvl, 0) + n

    def prepared(places, times):
        for p in tree_leaves(places):
            for i in range(len(p.spec)):
                axes = p.axes(i)
                if not axes or mesh.size(axes) == 1:
                    continue
                if set(axes) <= set(par.data_axes):
                    add(gathers, axes, times)
                    add(sums, axes, times)
                elif p.dims[i] == "head_dim":
                    add(gathers, axes, times)
                    if par.heads_split:
                        add(sums, axes, times)

    pattern = block_pattern(cfg)
    n_blocks = cfg.n_layers // len(pattern)
    prepared({k: v for k, v in par.places.items() if k != "stack"}, 1)
    for pl in par.places["stack"]:
        prepared([p.unstacked() for p in tree_leaves(pl)], n_blocks)
    if par.tp > 1:
        model = par.model_axes
        fwd = 1 if cfg.remat == "none" else 2
        for spec, pl in zip(pattern, par.places["stack"]):
            for sub, names in model_gathers(cfg, spec, par).items():
                for name, partial in names.items():
                    if name not in pl.get(sub, {}):
                        continue
                    n = par.model_split_dims(pl[sub][name].unstacked())
                    add(gathers, model, n_blocks * n)
                    if partial:
                        add(sums, model, n_blocks * n)
            s_, g_, a_ = _layer_sums(cfg, spec, par, fwd, seq_len)
            add(sums, model, n_blocks * s_)
            add(gathers, model, n_blocks * g_)
            add(a2a, model, n_blocks * a_)
        if par.splits(cfg.vocab_size):
            add(sums, model, 4)
            add(gathers, model)
    if par.dp > 1:
        add(sums, par.data_axes, par.data_mean_groups(dtypes, skip))
    out = {}
    for lvl in sorted(set(sums) | set(gathers) | set(a2a)):
        n = mesh.size(tuple(lvl.split("+")))
        row = {_level_op(n): sums[lvl]} if sums.get(lvl) else {}
        if gathers.get(lvl):
            row["all_gather"] = row.get("all_gather", 0) + gathers[lvl]
        if a2a.get(lvl):
            row["all_to_all"] = a2a[lvl]
        out[lvl] = row
    return out


def _make_mesh_hwa_train_step(lm, mesh, hwa_cfg: HWAConfig,
                              optimizer: str = "sgd", lr: float = 3e-4,
                              replica_axis="replica",
                              layout: ReplicaLayout | None = None, *,
                              seq_len: int) -> StepBundle:
    """The mesh-native inner step: ``fn(params, opt_state, batch) ->
    (params, opt_state, loss)``, ``batch`` the replica's whole batch
    (the rank takes its rows), the parameters and their optimizer state
    written in place. With the replica whole on one rank it is the
    collective-free step. With a data axis the ``flash_pallas`` form
    steps the whole replica on the rank's rows and averages gradients
    and loss over ``data`` (a model axis, as in the reference, holds
    the replica whole again: its ranks repeat the step); the other form
    runs the model on the rank's blocks with a ``models.parallel.Par``
    (expert-parallel where the layout's rules split the experts).
    Neither crosses a replica axis. With ``flash_pallas`` and remat off
    it launches the flash forward once and each backward sweep once a
    layer. Its contract pins the data and model collectives of a step
    exactly (``seq_len``: the batch's sequence length, on which the
    expert-parallel layer's depend; the reference leaves them to
    GSPMD). Its working set (activations, gradients) is not bounded."""
    from repro_torch.launch.sync.topology import _norm_axes
    from repro_torch.models.parallel import Par, batch_rows
    rep_axes = _norm_axes(replica_axis)
    K = hwa_cfg.n_replicas
    rep_size = math.prod(mesh.shape[a] for a in rep_axes)
    if K != rep_size:
        raise ValueError(f"mesh-native path needs K == replica-axes size "
                         f"({K} != {rep_size} over {rep_axes})")
    opt = _mk_optimizer(optimizer)
    cfg = lm.cfg
    inner = inner_axes(mesh)
    par = Par(mesh, cfg, layout.places) if inner else None
    dtypes = [x.dtype for x in tree_leaves(lm.abstract()[0])]
    colls = {}
    if par is None:
        def step(params, opt_state, batch):
            params, opt_state, loss, _ = hwa_local_inner_step(
                params, opt_state, batch, lm.loss, opt, lr)
            return params, opt_state, loss
    elif layout.whole:
        def step(params, opt_state, batch):
            params, opt_state, loss, _ = hwa_local_inner_step(
                params, opt_state, batch_rows(batch, par), lm.loss, opt,
                lr, grad_hook=par.data_mean)
            return params, opt_state, loss
        if par.dp > 1:
            colls[level_name(par.data_axes)] = {_level_op(par.dp): (
                par.data_mean_groups(dtypes, [False] * len(dtypes)))}
    else:
        skip = par.data_sharded()

        def step(params, opt_state, batch):
            params, opt_state, loss, _ = hwa_local_inner_step(
                params, opt_state, batch_rows(batch, par),
                functools.partial(lm.loss, par=par), opt, lr,
                grad_hook=functools.partial(par.data_mean, skip=skip))
            return params, opt_state, loss
        colls = par_step_collectives(par, dtypes, skip, seq_len)

    exact = (cfg.attn_impl == "flash_pallas" and cfg.remat == "none"
             and cfg.family in ("dense", "moe"))    # every layer attends
    launches = (dict.fromkeys(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                              cfg.n_layers) if exact
                else {} if cfg.attn_impl != "flash_pallas" else None)
    contract = train_contract(
        replica_axes=rep_axes, launches=launches,
        other_ops=colls,
        notes="mesh-native HWA inner step"
              + (", flash_pallas attention" if layout is not None
                 and layout.whole else ""))
    return StepBundle(fn=step, contract=contract, donate_argnums=(0, 1),
                      carry=lambda args, out: (out[0], out[1], args[2]))


def _make_mesh_hwa_sync_step(lm, mesh, hwa_cfg: HWAConfig, params,
                             ring_dtype=torch.float32,
                             replica_axis: str = "replica",
                             topology: SyncTopology | None = None,
                             comms_dtype: str = "f32",
                             layout: ReplicaLayout | None = None
                             ) -> StepBundle:
    """The mesh-native sync, the once-per-H-steps collective(s):
    ``fn(params, window_state, cycle) -> (window_state, wa, cycle, alive,
    k_alive, mean)``, the rank's leaves restarted in place
    (``packed._local_packed_sync``). ``topology`` selects where the mean
    reduces: ``Flat`` (default, over ``replica_axis``) or ``TwoLevel``,
    for which this is the OUTER sync. ``layout`` (:func:`replica_layout`;
    by default the whole-replica layout of ``params``) fixes the packed
    layout, ``pack_spec`` (global: the rank's window state holds
    ``pack_spec.local_spec()``, per group); W̿ and W̄ come back in the
    rank's local layout. Where the parameters rest whole but the layout
    splits them, the rank syncs its block of them in place.

    ``comms_dtype`` compresses the tree's cross-pod hop only; it needs a
    TwoLevel topology and is refused with ``resilient`` (the alive-masked
    mean renormalizes by k_alive after the reduction, so the quantized
    payload would be scaled before the mask is known)."""
    from repro_torch.common.quant import is_compressed, wa_dtype, wa_token
    from repro_torch.models.parallel import blocks_of
    K = hwa_cfg.n_replicas
    ring_dtype = wa_dtype(ring_dtype)
    tok = wa_token(ring_dtype)
    comms_tok = wa_token(comms_dtype)
    topology = topology if topology is not None else Flat(replica_axis)
    topology.validate(mesh, K)
    if comms_tok != "f32":
        if not isinstance(topology, TwoLevel):
            raise ValueError(
                "compressed comms quantize the two-level tree's cross-pod "
                "hop; a Flat sync has no outer level to compress (its one "
                "all-reduce IS the mean — quantizing it would quantize "
                f"the paper's W̄). Got comms_dtype={comms_tok!r} with "
                f"topology {topology!r}")
        if hwa_cfg.resilient:
            raise ValueError(
                "resilient + compressed comms is unsupported: the "
                "alive-masked mean renormalizes by k_alive after the "
                "psum, so the quantized payload would be scaled before "
                "the mask is known")
    _check_outer_every(hwa_cfg, topology)
    layout = layout or replica_layout(None, mesh, topology, params=params)
    psum_groups = topology.psum_groups()
    spec = layout.spec
    if is_compressed(tok):
        spec = spec.with_ring_dtype(ring_dtype)
    lspec = spec.local_spec()
    health = inner_axes(mesh)
    body = functools.partial(
        _local_packed_sync, hwa_cfg, lspec, K, psum_groups, mesh=mesh,
        comms_dtype=comms_tok, health_axes=health,
        health_scale=mesh.size(health))
    if layout.whole and layout.split:
        def fn(params, window_state, cycle):
            return body(blocks_of(params, layout.places, mesh),
                        window_state, cycle)
    else:
        fn = body
    budget = packed_sync_launch_budget(
        hwa_cfg, use_kernel=hwa_cfg.use_kernels, n_groups=spec.n_groups,
        k_local=1, collective=any(psum_groups), with_stride=True,
        ring_dtype=tok)
    # the pushes are the kernels a rank's sync launches, once a group (K =
    # 1 included: the fused sync never runs here)
    kernel = {"f32": "wa_window_update", "bf16": "wa_window_update_c"}
    contract = sync_collective_contract(
        mesh, topology, launches={kernel[tok]: budget} if budget else {},
        comms_dtype=comms_tok, resilient=hwa_cfg.resilient,
        float_args=_float_tokens(params if params is not None
                                 else lm.abstract()[0], tok),
        peak_bytes=packed_sync_working_set(
            4 * lspec.padded, _level_sizes(mesh, psum_groups),
            comms_dtype=comms_tok, ring_dtype=tok,
            grouped=spec.is_grouped),
        notes="mesh-native " + ("two-level outer" if isinstance(
            topology, TwoLevel) else "flat") + " sync"
              + (", resilient" if hwa_cfg.resilient else ""))
    # the window state is the one argument whose carried state the sync
    # returns; the parameters it restarts in place it does not
    return StepBundle(fn=fn, pack_spec=spec, contract=contract,
                      donate_argnums=(1,),
                      carry=lambda args, out: (args[0], out[0], out[2]))


def _level_sizes(mesh, groups) -> list[int]:
    return [mesh.size(axes) if axes else 1 for axes in groups]


def _float_tokens(params, ring_tok: str = "f32") -> tuple[str, ...]:
    """The floating dtypes a sync's arguments may hold: f32 (the total,
    the compensation, the scales), the ring's and the parameters' own."""
    from repro_torch.analysis.contracts import dtype_token
    toks = {"f32", {"bf16": "bf16", "fp8": "f8e4m3fn"}.get(ring_tok, "f32")}
    toks |= {dtype_token(x.dtype) for x in tree_leaves(params)
             if x.is_floating_point()}
    return tuple(sorted(toks))


def _make_mesh_hwa_inner_sync_step(lm, mesh, hwa_cfg: HWAConfig, params,
                                   topology: TwoLevel,
                                   layout: ReplicaLayout | None = None
                                   ) -> StepBundle:
    """The two-level tree's INNER sync, run on the ``outer_every - 1`` of
    every ``outer_every`` syncs that are not outer: each pod averages its
    own members, ``fn(params) -> pod mean`` (the rank's leaves restarted
    in place, the pod mean in its local layout). Zero cross-pod traffic,
    no window traffic, no kernel."""
    from repro_torch.models.parallel import blocks_of
    K = hwa_cfg.n_replicas
    if not isinstance(topology, TwoLevel):
        raise ValueError("inner-only sync exists only for the TwoLevel "
                         f"topology, got {topology!r}")
    topology.validate(mesh, K)
    _check_outer_every(hwa_cfg, topology)
    layout = layout or replica_layout(None, mesh, topology, params=params)
    pod_size = K // topology.pods(mesh)
    body = functools.partial(_local_inner_sync, layout.spec.local_spec(),
                             pod_size, topology.inner_groups(), mesh=mesh)
    if layout.whole and layout.split:
        def fn(params):
            return body(blocks_of(params, layout.places, mesh))
    else:
        fn = body
    return StepBundle(fn=fn, pack_spec=layout.spec,
                      contract=sync_collective_contract(
                          mesh, topology, launches={}, inner_only=True,
                          float_args=_float_tokens(
                              params if params is not None
                              else lm.abstract()[0]),
                          peak_bytes=packed_sync_working_set(
                              4 * layout.spec.local_spec().padded,
                              _level_sizes(mesh, topology.inner_groups()),
                              push=False),
                          notes="two-level inner sync"))


def _make_rest_step(mesh, layout: ReplicaLayout) -> StepBundle:
    """After a sync of a replica that rests whole on each rank but whose
    layout splits it (``flash_pallas`` with ``--fsdp``): ``fn(params,
    mean)`` writes the other ranks' synced blocks into the rank's whole
    leaves (its own were restarted in place), from one all-gather of the
    packed W̄ over the replica's inner axes: the reference's reshard at
    the next step's boundary. Its working set: the gathered blocks."""
    from repro_torch.common.packing import unpack
    from repro_torch.models.parallel import blocks_of
    axes = inner_axes(mesh)
    lspec = layout.spec.local_spec()

    def fn(params, mean):
        got = mesh.all_gather(mean, axes)
        with torch.no_grad():
            for r, buf in zip(mesh.level(axes).ranks, got):
                if r == mesh.rank:
                    continue
                for x, b in zip(tree_leaves(blocks_of(
                        params, layout.places, mesh, r)),
                        tree_leaves(unpack(buf, lspec))):
                    x.copy_(b)
        return params
    return StepBundle(fn=fn, contract=BundleContract(
        collectives=CollectiveContract(other_ops={
            level_name(axes): {"all_gather": 1}}),
        launch=LaunchBudget.exact({}),
        donation=DonationPolicy(peak_bytes=mesh.size(axes) * 4
                                * lspec.padded + PEAK_SLACK),
        notes="the rest step's all-gather"))


def sync_collective_audit(records, mesh, replica_axis: str = "replica",
                          outer_axis: str | None = None,
                          n_groups: int | None = None) -> dict:
    """The reference's structural audit of an HWA sync's collectives, per
    level (``repro.analysis.collectives.sync_collective_audit``), over the
    rank groups the sync's collectives ran on rather than over lowered
    HLO: ``records`` is a list of ``(op, groups)``, ``groups`` lists of
    ranks of ``mesh`` (a ``launch.mesh.MeshLayout``); a rank's
    ``launch.mesh.record_groups`` log gives one group a record, the one
    it ran on, and a hypercube chain of two-way all-reduces one
    all-reduce over the ranks its rounds joined. A collective *crosses*
    an axis when the ranks of one of its groups sit at different
    coordinates along it: the counterpart of the reference's
    ``collectives_crossing_axis`` over ``replica_groups``. A group that
    is not a whole level of the axes it crosses (a chain cut short, a
    miswired group) is listed with its op marked ``partial_``, which no
    verdict counts as a level's all-reduce.

    **Flat** (``outer_axis=None``): exactly one all-reduce over the
    replica axis, and nothing crossing any other axis.
    **Grouped** (``n_groups`` set): the same traffic contract
    (``grouped_sync_ok``); the groups change the launches, not the
    collectives. **Two-level** (``outer_axis`` set): each collective is
    inner-only (crosses ``replica_axis`` only), outer-only (crosses
    ``outer_axis`` only) or *mixed* (both: a miswired joint grouping);
    ``inner_sync_ok``: one inner-only all-reduce, nothing crossing the
    outer axis, assembly-free; ``outer_sync_ok``: one inner-only and one
    outer-only all-reduce, nothing mixed, assembly-free. A compressed
    outer level moves all-gathers, which no verdict counts as its
    all-reduce (as in the reference).

    Returns the reference's keys: ``replica``, ``outer``, ``mixed`` (lists
    of ``(op, level)``, ``level`` the axes the group spans joined by
    ``+``), ``other`` (axis -> such a list), ``replica_allreduce_only``,
    ``assembly_free``, ``inner_sync_ok``, ``outer_sync_ok`` and, with
    ``n_groups``, ``n_groups`` and ``grouped_sync_ok``."""
    coords = [mesh.coords(r) for r in range(mesh.world)]

    def spans(groups) -> tuple[str, ...]:
        return tuple(a for a in mesh.shape
                     if any(len({coords[r][a] for r in g}) > 1
                            for g in groups))

    def whole(op, groups, sp):
        blocks = mesh.partition(sp)
        return op if all(sorted(g) in blocks for g in groups) \
            else "partial_" + op

    hits = []
    for i, (op, groups) in enumerate(records):
        sp = spans(groups)
        hits.append((i, whole(op, groups, sp), sp))

    def crossing(axis):
        return [(i, op, level_name(sp)) for i, op, sp in hits if axis in sp]

    replica = crossing(replica_axis)
    outer = crossing(outer_axis) if outer_axis is not None else []
    outer_ids = {i for i, _, _ in outer}
    replica_ids = {i for i, _, _ in replica}
    mixed = [h for h in replica if h[0] in outer_ids]
    inner_only = [h for h in replica if h[0] not in outer_ids]
    outer_only = [h for h in outer if h[0] not in replica_ids]
    other = {ax: crossing(ax) for ax in mesh.shape
             if ax not in (replica_axis, outer_axis)}
    assembly_free = not any(other.values())

    def one_ar(h):
        return len(h) == 1 and h[0][1] == "all_reduce"

    def bare(h):
        return [(op, lvl) for _, op, lvl in h]
    out = {
        "replica": bare(replica), "outer": bare(outer), "mixed": bare(mixed),
        "other": {ax: bare(h) for ax, h in other.items()},
        "replica_allreduce_only": one_ar(replica),
        "assembly_free": assembly_free,
        "inner_sync_ok": one_ar(inner_only) and not outer and assembly_free,
        "outer_sync_ok": (one_ar(inner_only) and one_ar(outer_only)
                          and not mixed and assembly_free),
    }
    if n_groups is not None:
        out["n_groups"] = n_groups
        out["grouped_sync_ok"] = (out["replica_allreduce_only"]
                                  and assembly_free)
    return out


def sync_cases(mesh, cases) -> list[dict]:
    """Run one sync per case on this rank (a ``launch.mesh.spawn_ranks``
    target: the parity tests' way in, and a direct way to drive a single
    sync). A case is a dict: ``plan`` (a ``SyncPlan``), ``stacked`` (a
    tree of (K, ...) CPU tensors: rank r's replica is row r), ``window``
    (a ``WindowState`` on the CPU) and ``cycle`` for a full sync, or
    ``inner: True`` for the two-level tree's inner sync, or ``group:
    True`` for ``core.online``'s process-group mean and divergence over
    the whole mesh. Returns, per case, the rank's restarted replica, the
    packed mean (or the group mean and divergence), the collectives the
    sync issued and those its bundle declares and, for a full sync, the
    window state, W̿, the cycle, the alive mask and the alive count, all
    on the CPU."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.core.online import (online_average_group,
                                         replica_divergence_group)
    from repro_torch.launch.mesh import ledger_delta, ledger_snapshot
    from repro_torch.launch.sync.plan import build_hwa_bundles

    dev = mesh.device
    results = []
    for case in cases:
        params = tree_map(lambda x: x[mesh.rank].clone().to(dev),
                          case["stacked"])
        if case.get("group"):
            axes = tuple(mesh.shape)
            results.append(tree_map(lambda x: x.cpu(), {
                "mean": online_average_group(params, mesh, axes),
                "divergence": replica_divergence_group(params, mesh,
                                                       axes)}))
            continue
        bundles = build_hwa_bundles(None, mesh, case["plan"], params,
                                    train=False)
        step = bundles.inner_sync if case.get("inner") else bundles.sync
        before = ledger_snapshot()
        if case.get("inner"):
            out = {"mean": step(params)}
        else:
            ws = tree_map(lambda x: x.clone().to(dev), case["window"])
            ws, wa, cycle, alive, k_alive, mean = step(
                params, ws, case["cycle"].to(dev))
            out = {"window": ws, "wa": wa, "cycle": cycle, "alive": alive,
                   "k_alive": k_alive, "mean": mean}
        out["params"] = params
        out = tree_map(lambda x: x.cpu(), out)
        out["collectives"] = ledger_delta(before, ledger_snapshot())
        out["declared"] = step.contract.ledger(mesh.shape)
        results.append(out)
    return results
