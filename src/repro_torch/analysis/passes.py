"""The passes: each checks one facet of a recorded bundle call against
its declarative contract (counterpart of ``repro.analysis.passes``).

The reference reads a compiled XLA module; the port has none, so it
runs the bundle once under a recorder (:func:`record_call`) and checks
what the call did (:class:`BundleArtifacts`):

- ``collectives``   — the rank groups its collectives ran on
  (``launch.mesh.record_groups``) against the
  :class:`~repro_torch.analysis.contracts.CollectiveContract`: exact
  counts a level and op, the non-level traffic equal to ``other_ops``, no
  group spanning both tree levels, no group that is only part of a level;
- ``launch_budget`` — each kernel wrapper's launch delta against the
  :class:`~repro_torch.analysis.contracts.LaunchBudget` (on the card: a
  wrapper given a CPU tensor runs its plain version and counts nothing);
- ``donation``      — every leaf of ``StepBundle.donate_argnums`` keeps
  its storage into the state the caller carries on (``StepBundle
  .next_args``): the port's counterpart of XLA's input-output aliasing.
  A bundle donates only the arguments whose carried state it returns
  (the window state, the train step's parameters and optimizer state,
  the decode step's caches, tokens and output); the leaves a call
  writes in place and does not return (a sync's parameters) are held by
  the API, not by this check. On the card the call's peak allocation
  above its start stays within the working set its builder declares
  (``DonationPolicy.peak_bytes``);
- ``dtype``         — no op produces a forbidden dtype (a
  ``TorchDispatchMode`` over the call, inside the lint only), every
  collective payload (``launch.mesh.record_payloads``) and floating
  argument leaf in its allowed set;
- ``manual_hazard`` — always ``skipped``: the XLA 0.4.x fatal it guards
  needs an SPMD partitioner, which the port does not have.

:class:`BundleArtifacts` is plain data, so a spawned rank records a call
and the parent process runs the passes on it.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

from repro_torch.analysis.contracts import (DEFAULT_CONTRACT, BundleContract,
                                            dtype_token, level_of)

#: canonical pass order in reports
PASS_NAMES = ("collectives", "launch_budget", "donation", "dtype",
              "manual_hazard")

_EVIDENCE_CAP = 8

HAZARD_SKIP = ("the port has no SPMD partitioner: a loop under a "
               "partial-auto shard_map, the XLA 0.4.x fatal this pass "
               "guards, cannot arise")


@dataclasses.dataclass
class PassResult:
    """Verdict of one pass on one bundle."""
    name: str
    ok: bool
    violations: list
    evidence: list
    skipped: bool = False

    def as_json(self) -> dict:
        return {"ok": bool(self.ok), "skipped": bool(self.skipped),
                "violations": list(self.violations),
                "evidence": list(self.evidence)}


def _skipped(name: str, why: str) -> PassResult:
    return PassResult(name=name, ok=True, violations=[], evidence=[why],
                      skipped=True)


@dataclasses.dataclass
class BundleArtifacts:
    """What one recorded call did. ``shape`` is the rank mesh's ``{axis:
    size}`` (None: one process, no mesh); ``groups`` the ``(op, ranks)``
    log, ``payloads`` the ``(op, level, token)`` log; ``ledger`` and
    ``launches`` the call's deltas (``launches`` None off the card);
    ``arg_dtypes`` the ``(arg, leaf, token)`` of every floating argument
    leaf; ``op_dtypes`` the count of op outputs a dtype token (None where
    ops were not recorded: a timed call) with ``op_names`` a few op names
    a token; ``inplace`` per donated leaf ``(arg, leaf, ndim, nbytes,
    storage before, storage in the carried state)``; on the card
    ``peak_above_start``, the bytes the call's peak allocation rose
    above its start."""
    shape: dict | None = None
    groups: list = dataclasses.field(default_factory=list)
    payloads: list = dataclasses.field(default_factory=list)
    ledger: dict = dataclasses.field(default_factory=dict)
    launches: dict | None = None
    arg_dtypes: list = dataclasses.field(default_factory=list)
    op_dtypes: dict | None = None
    op_names: dict = dataclasses.field(default_factory=dict)
    inplace: list = dataclasses.field(default_factory=list)
    inplace_mismatch: str | None = None
    peak_above_start: int | None = None


def _op_mode():
    """A ``TorchDispatchMode`` counting every op's output dtypes (built
    here: the lint's recorder only, never a timed path)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves as leaves

    class OpDtypes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts: dict[str, int] = {}
            self.names: dict[str, list] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for x in leaves(out):
                if isinstance(x, torch.Tensor):
                    tok = dtype_token(x.dtype)
                    self.counts[tok] = self.counts.get(tok, 0) + 1
                    names = self.names.setdefault(tok, [])
                    if len(names) < _EVIDENCE_CAP and str(func) not in names:
                        names.append(str(func))
            return out
    return OpDtypes()


def _storage(x) -> int:
    return x.untyped_storage().data_ptr()


def record_call(bundle, args, *, mesh=None, ops: bool = True):
    """Run ``bundle(*args)`` once under the recorders; returns ``(out,
    BundleArtifacts)``. ``mesh`` (a ``launch.mesh.ReplicaMesh``) names
    the rank; ``ops`` records every op's output dtypes (a
    ``TorchDispatchMode``: the lint's, never on a timed call). On the
    card the peak-allocation counter is reset for the call."""
    import torch

    from repro_torch.common.pytree import tree_leaves
    from repro_torch.launch.mesh import (kernel_counts, ledger_delta,
                                         ledger_snapshot, record_groups,
                                         record_payloads)
    args = tuple(args)
    leaves = [tree_leaves(a) for a in args]
    tensors = [x for lv in leaves for x in lv if torch.is_tensor(x)]
    dev = (mesh.device if mesh is not None else
           tensors[0].device if tensors else torch.device("cpu"))
    cuda = dev.type == "cuda"
    art = BundleArtifacts(shape=dict(mesh.shape) if mesh is not None
                          else None)
    art.arg_dtypes = [(i, j, dtype_token(x.dtype))
                      for i, lv in enumerate(leaves)
                      for j, x in enumerate(lv)
                      if torch.is_tensor(x) and x.is_floating_point()]
    donated = {i: [(x.dim(), x.numel() * x.element_size(), _storage(x))
                   for x in leaves[i]] for i in bundle.donate_argnums}
    mode = _op_mode() if ops else None
    before, launched = ledger_snapshot(), kernel_counts()
    if cuda:
        torch.cuda.synchronize(dev)
        start = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    with record_groups() as groups, record_payloads() as payloads, \
            mode or contextlib.nullcontext():
        out = bundle(*args)
    if cuda:
        torch.cuda.synchronize(dev)
        art.peak_above_start = torch.cuda.max_memory_allocated(dev) - start
        art.launches = {k: v - launched[k]
                        for k, v in kernel_counts().items()
                        if v != launched[k]}
    art.ledger = ledger_delta(before, ledger_snapshot())
    art.groups = [(op, list(r)) for op, r in groups]
    art.payloads = [(op, lvl, dtype_token(dt)) for op, lvl, dt in payloads]
    if mode is not None:
        art.op_dtypes, art.op_names = mode.counts, mode.names
    nxt = bundle.next_args(args, out)
    for i, rows in donated.items():
        after = tree_leaves(nxt[i])
        if len(after) != len(rows):
            art.inplace_mismatch = (f"arg {i}: {len(rows)} leaves in, "
                                    f"{len(after)} carried on")
            continue
        for j, ((nd, nb, ptr), y) in enumerate(zip(rows, after)):
            art.inplace.append((i, j, nd, nb, ptr,
                                _storage(y) if torch.is_tensor(y) else None))
    return out, art


# ------------------------------------------------------------ the passes


def _groups(art: BundleArtifacts):
    """Each logged collective as ``(op, ranks, spans, whole)``: the mesh
    axes its group spans (its level's axes, in mesh order) and whether
    the group is a whole block of them (not a chain cut short, not a
    miswired group)."""
    from repro_torch.launch.mesh import MeshLayout
    if not art.groups:
        return []
    lay = MeshLayout(art.shape)
    coords = [lay.coords(r) for r in range(lay.world)]
    out = []
    for op, ranks in art.groups:
        spans = tuple(a for a in lay.shape
                      if len({coords[r][a] for r in ranks}) > 1)
        out.append((op, ranks, spans,
                    sorted(ranks) in lay.partition(spans)))
    return out


def collectives_pass(art: BundleArtifacts,
                     contract: BundleContract) -> PassResult:
    cc = contract.collectives
    if cc is None:
        return _skipped("collectives", "no collective contract declared")
    order = tuple(art.shape or ())
    violations: list[str] = []
    evidence: list[str] = []
    inner: dict[str, int] = {}
    outer: dict[str, int] = {}
    other: dict[str, dict[str, int]] = {}
    level_axes = set(cc.axes) | ({cc.outer_axis} if cc.outer_axis else set())
    for op, ranks, spans, whole in _groups(art):
        lvl = level_of(spans, order)
        if len(evidence) < _EVIDENCE_CAP:
            evidence.append(f"{op} over ranks {ranks} ({lvl})")
        if not whole:
            violations.append(f"{op} over ranks {ranks} is not a whole "
                              f"{lvl} level (a chain cut short, or a "
                              f"miswired group)")
            continue
        hit_in = bool(set(spans) & set(cc.axes))
        hit_out = cc.outer_axis is not None and cc.outer_axis in spans
        rest = set(spans) - level_axes
        if hit_in and hit_out:
            violations.append(f"miswired grouping: {op} spans both "
                              f"{cc.axes} and {cc.outer_axis}")
        elif (hit_in or hit_out) and rest and cc.assembly_free:
            violations.append(f"assembly traffic: {op} crosses both the "
                              f"level axes and {sorted(rest)}")
        elif hit_in:
            inner[op] = inner.get(op, 0) + 1
        elif hit_out:
            outer[op] = outer.get(op, 0) + 1
        else:
            row = other.setdefault(lvl, {})
            row[op] = row.get(op, 0) + 1

    def match(where, got, want):
        for op in sorted(set(got) | set(want)):
            g, w = got.get(op, 0), want.get(op, 0)
            if g != w:
                violations.append(f"{where}: expected {w} × {op}, found {g}")
    match(f"level {level_of(cc.axes, order) or '()'}", inner, dict(cc.ops))
    if cc.outer_axis is not None:
        match(f"outer level {cc.outer_axis}", outer, dict(cc.outer_ops))
    if cc.assembly_free:
        want = {level_of(k.split("+"), order) if order else k: dict(v)
                for k, v in cc.other_ops.items()}
        for lvl in sorted(set(other) | set(want)):
            match(f"non-level {lvl}", other.get(lvl, {}), want.get(lvl, {}))
    return PassResult(name="collectives", ok=not violations,
                      violations=violations,
                      evidence=evidence or ["no collectives"])


def launch_budget_pass(art: BundleArtifacts,
                       contract: BundleContract) -> PassResult:
    budget = contract.launch
    if budget is None:
        return _skipped("launch_budget", "no launch budget declared")
    counts = budget.counts if budget.counts is not None else budget
    declared = f"declared {counts}"
    if art.launches is None:
        return _skipped("launch_budget", "no kernel launches on the CPU (a "
                        "wrapper given a CPU tensor runs its plain "
                        f"version); {declared}")
    violations = budget.violations(art.launches)
    return PassResult(name="launch_budget", ok=not violations,
                      violations=violations,
                      evidence=[f"launched {art.launches}; {declared}"])


def donation_pass(art: BundleArtifacts,
                  contract: BundleContract) -> PassResult:
    policy = contract.donation
    if policy is None or not policy.check:
        return _skipped("donation", "donation check disabled")
    violations = []
    if art.inplace_mismatch:
        violations.append(f"the carried state changed shape: "
                          f"{art.inplace_mismatch}")
    leaves = [r for r in art.inplace
              if not (policy.ignore_scalar_leaves and r[2] == 0)]
    kept = 0
    for i, j, nd, nb, ptr, after in leaves:
        if after != ptr:
            violations.append(f"in place dropped: arg {i} leaf {j} "
                              f"({nb} B) was rebound to a fresh tensor")
        else:
            kept += 1
    evidence = [f"{kept} of {len(leaves)} in-place leaves kept their "
                "storage"]
    peak, bound = art.peak_above_start, policy.peak_bytes
    if peak is None:
        evidence.append("peak allocation not measured (off the card)")
    else:
        evidence.append(f"peak allocation {peak} B above the start; "
                        + ("working set unbounded" if bound is None else
                           f"declared working set {bound} B"))
        if bound is not None and peak > bound:
            violations.append(f"peak allocation {peak} B above the start "
                              f"exceeds the declared working set {bound} "
                              f"B by {peak - bound} B: a buffer made and "
                              "dropped inside the call (an in-place write "
                              "done out of place?)")
    return PassResult(name="donation", ok=not violations,
                      violations=violations, evidence=evidence)


def dtype_pass(art: BundleArtifacts,
               contract: BundleContract) -> PassResult:
    policy = contract.dtypes
    if policy is None:
        return _skipped("dtype", "no dtype policy declared")
    violations: list[str] = []
    evidence: list[str] = []
    forbid = set(policy.forbid)
    if art.op_dtypes is None:
        evidence.append("ops not recorded (a timed call): forbid held on "
                        "the payloads and arguments")
        seen = ({t for _, _, t in art.payloads}
                | {t for _, _, t in art.arg_dtypes})
        for t in sorted(seen & forbid):
            violations.append(f"forbidden dtype {t} in a payload or an "
                              "argument")
    else:
        for t in sorted(set(art.op_dtypes) & forbid):
            violations.append(f"forbidden dtype {t} produced by "
                              f"{art.op_dtypes[t]} op output(s)")
            evidence.append(f"{t}: {art.op_names.get(t, [])}")
    if policy.collective_dtypes is not None:
        allowed = set(policy.collective_dtypes)
        for op, lvl, t in art.payloads:
            if t not in allowed:
                violations.append(f"collective payload dtype {t} not in "
                                  f"allowed {sorted(allowed)} ({op} over "
                                  f"{lvl})")
    if policy.float_args is not None:
        allowed = set(policy.float_args)
        for i, j, t in art.arg_dtypes:
            if t not in allowed:
                violations.append(f"floating arg leaf (arg {i} leaf {j}) "
                                  f"is {t}, allowed {sorted(allowed)}")
    by_level: dict[str, set] = {}
    for _, lvl, t in art.payloads:
        by_level.setdefault(lvl, set()).add(t)
    if by_level:
        evidence.append("payloads: " + ", ".join(
            f"{lvl} {sorted(ts)}" for lvl, ts in sorted(by_level.items())))
    if not violations and not evidence:
        evidence = ["no forbidden dtypes; payloads/args within policy"]
    return PassResult(name="dtype", ok=not violations,
                      violations=_dedupe(violations),
                      evidence=evidence[:_EVIDENCE_CAP])


def manual_hazard_pass(art: BundleArtifacts,
                       contract: BundleContract) -> PassResult:
    return _skipped("manual_hazard", HAZARD_SKIP)


_PASSES = {"collectives": collectives_pass,
           "launch_budget": launch_budget_pass,
           "donation": donation_pass, "dtype": dtype_pass,
           "manual_hazard": manual_hazard_pass}


def _dedupe(items: list) -> list:
    return list(dict.fromkeys(items))


def run_passes(art: BundleArtifacts, contract: BundleContract | None = None,
               names=PASS_NAMES) -> list[PassResult]:
    """Every pass named in ``names`` on one recorded call, in the
    canonical order (``contract`` defaults to the universal baseline)."""
    contract = contract if contract is not None else DEFAULT_CONTRACT
    return [_PASSES[n](art, contract) for n in PASS_NAMES if n in names]


def merge_ranks(per_rank: list[list[PassResult]]) -> list[PassResult]:
    """One case's verdicts over its ranks: a pass holds where it holds on
    every rank; each violation names its rank; rank 0's evidence."""
    out = []
    for results in zip(*per_rank):
        first = results[0]
        violations = _dedupe([f"rank {r}: {v}" if len(per_rank) > 1 else v
                             for r, res in enumerate(results)
                             for v in res.violations])
        out.append(PassResult(
            name=first.name, ok=all(r.ok for r in results),
            violations=violations, evidence=list(first.evidence),
            skipped=all(r.skipped for r in results)))
    return out


def census(art: BundleArtifacts) -> dict[str, Any]:
    """A recorded call's collectives a level and op (the levels its
    groups span) and its payload dtypes a level: what the tests hold
    against the reference's compiled module."""
    order = tuple(art.shape or ())
    counts: dict[str, dict[str, int]] = {}
    for op, _, spans, _ in _groups(art):
        row = counts.setdefault(level_of(spans, order), {})
        row[op] = row.get(op, 0) + 1
    payloads: dict[str, list] = {}
    for _, lvl, t in art.payloads:
        payloads[lvl] = sorted(set(payloads.get(lvl, [])) | {t})
    return {"collectives": counts, "payloads": payloads}
