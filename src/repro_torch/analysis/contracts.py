"""Declarative per-bundle contracts: pure data (counterpart of
``repro.analysis.contracts``, kept as the port's own copy).

A :class:`BundleContract` states what one call of a ``StepBundle`` must
do; the passes in ``analysis.passes`` check each piece against what a
recorded call did, and ``analysis.lint`` runs the whole matrix. The
builders attach a contract to the bundles they assemble
(``StepBundle.contract``) when they build them: the builder knows the
topology, kernel gating and pack layout it chose, so the declaration is
exact without a second source of truth. Every field set to ``None``
means "unchecked".

The port's spellings are the ledger's (``launch.mesh.LEDGER``): op names
``all_reduce``, ``all_gather``, ``all_to_all``, ``gather``; a level is
the mesh axes a collective's rank group spans, in mesh order, joined by
``+`` (``replica``, ``pod``, ``data+model``, ...). A collective is
counted as the process logs it (``launch.mesh.record_groups``): one
``ReplicaMesh.psum`` is one ``all_reduce`` over its level (the hypercube
chain of two-way rounds counts once, as the reference's one all-reduce
does), or one ``all_gather`` on a level of a size that is not a power of
two; :meth:`CollectiveContract.ledger` turns that census into the
ledger's per-round counts.

Two departures from the reference, both stricter: ``other_ops`` names
the level of each budgeted non-level collective (the reference pools
them), and :class:`LaunchBudget` counts each kernel apart, keyed like
``launch.mesh.kernel_counts()`` (the port launches a kernel once a layer
where the reference counts one ``pallas_call`` inside its layer scan).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping


#: torch dtype names -> the reference's HLO dtype tokens
_TOKENS = {"float64": "f64", "float32": "f32", "float16": "f16",
           "bfloat16": "bf16", "float8_e4m3fn": "f8e4m3fn",
           "float8_e5m2": "f8e5m2", "int64": "s64", "int32": "s32",
           "int16": "s16", "int8": "s8", "uint64": "u64", "uint32": "u32",
           "uint16": "u16", "uint8": "u8", "bool": "pred",
           "complex64": "c64", "complex128": "c128"}


def dtype_token(dtype) -> str:
    """The reference's token for a torch dtype (``f32``, ``bf16``, ``u8``,
    ...; the dtype's own name where the reference has none)."""
    name = str(dtype).removeprefix("torch.")
    return _TOKENS.get(name, name)


def _axes(axis) -> tuple[str, ...]:
    if axis is None:
        return ()
    return (axis,) if isinstance(axis, str) else tuple(axis)


def level_of(axes, order) -> str:
    """The level name of ``axes``: in the mesh's axis ``order``, joined by
    ``+`` (``launch.mesh.level_name`` of the sorted axes)."""
    axes = set(_axes(axes))
    return "+".join(a for a in order if a in axes)


@dataclasses.dataclass(frozen=True)
class CollectiveContract:
    """What one call's collectives must be, per level.

    ``axis`` names the replica-population axes (one name, or a tuple for
    a joint population such as a flat sync over ``("pod", "replica")``);
    ``ops`` maps op -> EXACT count of the collectives crossing them (ops
    not listed must not appear). With ``outer_axis`` set, ``ops``
    constrains the inner-only crossings, ``outer_ops`` the outer-only
    ones, and a group spanning both levels is a miswired composition,
    always a violation. ``assembly_free`` demands that the collectives
    crossing only the other axes match ``other_ops`` exactly, level by
    level (``{level: {op: n}}``; the default ``{}`` is the zero-assembly
    claim); a group spanning a level axis and another axis is always a
    violation. ``axis=()`` with ``assembly_free`` and no ``other_ops``
    means "no collectives anywhere"."""
    axis: str | tuple[str, ...] = ()
    ops: Mapping[str, int] = dataclasses.field(default_factory=dict)
    outer_axis: str | None = None
    outer_ops: Mapping[str, int] = dataclasses.field(default_factory=dict)
    assembly_free: bool = True
    other_ops: Mapping[str, Mapping[str, int]] = dataclasses.field(
        default_factory=dict)

    @property
    def axes(self) -> tuple[str, ...]:
        return _axes(self.axis)

    def census(self, order) -> dict[str, dict[str, int]]:
        """The declared collectives a level (``{level: {op: n}}``, zero
        counts left out), the levels named in the mesh's axis ``order``.
        The non-level levels appear only where ``assembly_free`` pins
        them."""
        out: dict[str, dict[str, int]] = {}

        def add(level, ops):
            row = {op: n for op, n in ops.items() if n}
            if level and row:
                into = out.setdefault(level, {})
                for op, n in row.items():
                    into[op] = into.get(op, 0) + n
        add(level_of(self.axes, order), self.ops)
        if self.outer_axis is not None:
            add(level_of((self.outer_axis,), order), self.outer_ops)
        if self.assembly_free:
            for lvl, ops in self.other_ops.items():
                add(level_of(lvl.split("+"), order), ops)
        return out

    def ledger(self, shape: Mapping[str, int]) -> dict[str, dict[str, int]]:
        """The census as ``launch.mesh.LEDGER`` counts it, ``shape`` the
        mesh's ``{axis: size}``: an all-reduce over a level of 2^m ranks
        is m two-way rounds; every other op is one entry. A level of one
        rank issues nothing."""
        out = {}
        for lvl, row in self.census(tuple(shape)).items():
            n = math.prod(shape[a] for a in lvl.split("+"))
            if n == 1:
                continue
            out[lvl] = {op: c * (n.bit_length() - 1) if op == "all_reduce"
                        else c for op, c in row.items()}
        return out


@dataclasses.dataclass(frozen=True)
class LaunchBudget:
    """Kernel launches of one call, per kernel (``launch.mesh
    .kernel_counts()``'s names): each kernel's count within [``min[k]``,
    ``max[k]``], a kernel not named 0. Launches happen on the card only:
    a wrapper given a CPU tensor runs its plain version."""
    min: Mapping[str, int] = dataclasses.field(default_factory=dict)
    max: Mapping[str, int] = dataclasses.field(default_factory=dict)

    @classmethod
    def exact(cls, counts: Mapping[str, int]) -> "LaunchBudget":
        counts = {k: int(v) for k, v in counts.items() if v}
        return cls(min=dict(counts), max=dict(counts))

    @property
    def counts(self) -> dict[str, int] | None:
        """The exact counts, or None where the budget is a range."""
        return dict(self.max) if dict(self.min) == dict(self.max) else None

    def violations(self, got: Mapping[str, int]) -> list[str]:
        bad = []
        for k in sorted(set(got) | set(self.min) | set(self.max)):
            n, lo, hi = got.get(k, 0), self.min.get(k, 0), self.max.get(k, 0)
            if not lo <= n <= hi:
                bad.append(f"{k} launched {n} time(s), budget [{lo}, {hi}]")
        return bad


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Precision discipline of one call. ``forbid``: dtype tokens no op
    may produce (f64 leaks: a stray Python float in the sync math
    silently doubles comm bytes). ``collective_dtypes``: allowed payload
    dtypes of every collective (None = unchecked); the sync bundles pin
    ``("f32",)``, the compressed-comms bundles their exact payload set,
    the narrow float plus its wire view. ``float_args``: allowed tokens
    of every floating leaf of the call's arguments (None = unchecked)."""
    forbid: tuple[str, ...] = ("f64",)
    collective_dtypes: tuple[str, ...] | None = None
    float_args: tuple[str, ...] | None = None


#: bytes a declared working set allows above its named buffers: the
#: small ones (counters, scales, the alive mask), the allocator's 512 B
#: rounding, and a plain compressed-ring push's temporaries a
#: ``SLOT_CHUNK`` at a time beyond what the builder counts
PEAK_SLACK = 8 << 20


@dataclasses.dataclass(frozen=True)
class DonationPolicy:
    """The in-place discipline of ``StepBundle.donate_argnums``: every
    leaf of those arguments must be written in place, keeping its
    storage into the state the caller carries to the next call (a leaf
    rebound to a fresh tensor is the port's dropped donation: the window
    HBM doubles while both live). ``ignore_scalar_leaves`` skips rank-0
    leaves (step counters: byte-free). ``peak_bytes`` is the call's
    declared working set: on the card its peak allocation above its
    start may not exceed it (None: unbounded). The builder counts the
    temporaries it knows the call holds at once (a sync's packed W̄, W̿
    and gathered payloads; the decode step's logits) and adds
    :data:`PEAK_SLACK`, so a buffer as large as the state written in
    place, made and dropped inside the call, shows where it lands on the
    call's largest phase."""
    check: bool = True
    ignore_scalar_leaves: bool = True
    peak_bytes: int | None = None


@dataclasses.dataclass(frozen=True)
class HazardPolicy:
    """The reference's manual-subgroup loop hazard (an XLA 0.4.x fatal on
    a ``while`` under a partial-auto ``shard_map``). The port has no SPMD
    partitioner, so the hazard cannot arise; the field keeps the
    reference's schema and the pass reports ``skipped``."""
    check: bool = True
    include_fully_manual: bool = True


@dataclasses.dataclass(frozen=True)
class BundleContract:
    """The full declarative contract of one StepBundle. ``collectives``
    and ``launch`` default to None (unchecked) because only the builder
    knows them; ``dtypes``, ``donation`` and ``hazard`` default to the
    discipline every bundle keeps (no f64, in-place state)."""
    collectives: CollectiveContract | None = None
    launch: LaunchBudget | None = None
    dtypes: DtypePolicy | None = DtypePolicy()
    donation: DonationPolicy | None = DonationPolicy()
    hazard: HazardPolicy | None = HazardPolicy()
    notes: str = ""

    def ledger(self, shape: Mapping[str, int]) -> dict:
        """The collectives a call adds to the ledger (``{}`` when none are
        declared)."""
        if self.collectives is None:
            return {}
        return self.collectives.ledger(shape)


#: the universal baseline for bundles with no builder-attached contract
DEFAULT_CONTRACT = BundleContract()

#: strict f32 discipline of the WA sync bundles
SYNC_DTYPES_F32 = DtypePolicy(collective_dtypes=("f32",),
                              float_args=("f32",))


def sync_contract(axis, *, launches: Mapping[str, int], outer_axis=None,
                  n_collectives: int = 1, outer_collectives: int = 0,
                  outer_ops: Mapping[str, int] | None = None,
                  other_ops: Mapping[str, Mapping[str, int]] | None = None,
                  op: str = "all_reduce",
                  collective_dtypes: tuple[str, ...] = ("f32",),
                  float_args: tuple[str, ...] = ("f32",),
                  peak_bytes: int | None = None,
                  notes: str = "") -> BundleContract:
    """Contract factory for WA sync bundles: ``n_collectives`` weight
    reductions over ``axis`` (0 where the replica stack is
    process-local; 2 for the resilient sync: the alive count, then the
    masked weights), each one ``op`` (``all_reduce``; ``all_gather`` on
    a level whose size is not a power of two), optionally
    ``outer_collectives`` all-reduces one level up over ``outer_axis``
    (``outer_ops`` overrides that census: the compressed outer level's
    all-gathers), non-level crossings pinned to ``other_ops`` (default:
    zero assembly traffic), an exact launch budget, strict payload
    dtypes and the window state in place within ``peak_bytes``."""
    if outer_ops is None:
        outer_ops = ({"all_reduce": outer_collectives}
                     if outer_collectives else {})
    return BundleContract(
        collectives=CollectiveContract(
            axis=axis, ops={op: n_collectives} if n_collectives else {},
            outer_axis=outer_axis, outer_ops=dict(outer_ops),
            assembly_free=True,
            other_ops={k: dict(v) for k, v in (other_ops or {}).items()}),
        launch=LaunchBudget.exact(launches),
        dtypes=DtypePolicy(collective_dtypes=collective_dtypes,
                           float_args=float_args),
        donation=DonationPolicy(peak_bytes=peak_bytes), notes=notes)


def decode_contract(*, launches: Mapping[str, int],
                    peak_bytes: int | None = None,
                    notes: str = "") -> BundleContract:
    """Contract factory for serving decode steps: no collectives anywhere
    (the paged engine is a one-device fixed-shape step: a collective
    means the serving mesh leaked into the hot path), an exact launch
    budget (the paged kernel once an attention layer), the caches, token
    and output written in place within ``peak_bytes``, no f64."""
    return BundleContract(
        collectives=CollectiveContract(axis=(), ops={}, assembly_free=True),
        launch=LaunchBudget.exact(launches),
        donation=DonationPolicy(peak_bytes=peak_bytes), notes=notes)


def train_contract(replica_axes=None, *,
                   launches: Mapping[str, int] | None = None,
                   other_ops: Mapping[str, Mapping[str, int]] | None = None,
                   notes: str = "") -> BundleContract:
    """Contract factory for train steps: collective-free over the replica
    axes when given (the H-fold amortization guarantee), no f64. The
    data and model traffic is unchecked unless ``other_ops`` pins it
    level by level (the port's builders count it exactly; the
    reference leaves it to GSPMD). ``launches`` pins the exact kernel
    launches where the builder knows them (the ``flash_pallas`` step
    with remat off: the forward and both backward sweeps once an
    attention layer)."""
    collectives = None
    if replica_axes is not None:
        collectives = CollectiveContract(
            axis=replica_axes, ops={}, assembly_free=other_ops is not None,
            other_ops={k: dict(v) for k, v in (other_ops or {}).items()})
    launch = LaunchBudget.exact(launches) if launches is not None else None
    return BundleContract(collectives=collectives, launch=launch,
                          notes=notes)
