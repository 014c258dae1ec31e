"""The port's rank mesh: HWA replicas on ``torch.distributed``
processes (counterpart of ``repro.launch.mesh``, whose mesh is a grid of
devices in one process).

A :class:`ReplicaMesh` names its axes: the replica axes (``{"replica":
K}``, or ``{"pod": G, "replica": K // G}`` for the two-level sync tree),
then, where a replica spans several ranks, the reference's ``data`` and
``model`` axes inside it (``launch.sync.bundles.replica_layout``). It
lays the ranks out row-major over them (so pods are contiguous rank
blocks, and a replica's ranks too) and builds its process groups once,
at start: one set a level, for the replica levels of the sync, for
``data`` and ``model`` (the train step's collectives) and for both (the
resilient sync's health stats). A reduction over a set of axes (a
*level*) reduces within the ranks that differ only along those axes:

- a level of 2^m ranks is m two-way ``all_reduce``s over the hypercube
  pairs of the level (rank positions i and i XOR 2^j in round j). A
  two-way sum is one IEEE add, so the chain gives every rank the bits of
  ``core.online.halving_sum_axis0`` over the level in rank order;
- a level of any other size is one ``all_gather`` and a local halving
  sum, exact by construction.

**Backend rule** (printed by the launcher): ``nccl`` when every rank has
a card of its own, ``gloo`` when ranks share a card and on the CPU. Rank
r runs on ``cuda:{r % device_count}``. NCCL refuses two ranks on one
card; ``gloo`` takes CPU tensors here, so every ``gloo`` collective of a
CUDA tensor is staged through host memory in one function
(:meth:`ReplicaMesh._collective`), which counts the staged bytes. Every
process group gets an explicit timeout, so a hang fails instead of
waiting forever.

**Ledger.** Each collective wrapper adds to :data:`LEDGER`, per level
name (the level's axes joined by ``+``: ``replica``, ``pod``, ``data``,
``model``, ``data+model``, or a label such as ``probe`` or
``checkpoint``) and op: its count and the bytes
this rank put in (an all-reduce's tensor, an all-gather's or a gather's
one contribution, an all-to-all's whole send buffer), and
``staged_bytes``, the bytes copied to the host and back for ``gloo``.
Nothing else touches it, as nothing but a kernel's wrapper touches its
launch count. Inside :func:`record_groups` the wrappers also log the
rank group each collective ran on (``launch.sync.bundles
.sync_collective_audit`` and ``analysis.passes`` read it), and inside
:func:`record_payloads` each collective's level and payload dtype as it
crosses (``analysis.passes``' dtype pass), outside the ledger's rows.

:func:`spawn_ranks` starts the K processes (``spawn``), runs a named
function in each with its mesh and collects what each returns.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import importlib
import math
import multiprocessing as mp
import os
import shutil
import subprocess
import tempfile
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist

#: collectives issued by this process: level -> {op or "bytes" or
#: "staged_bytes": int}
LEDGER: dict[str, dict[str, int]] = {}

_OPS = ("all_reduce", "all_gather", "all_to_all", "gather", "barrier")


#: while :func:`record_groups` is open: ``(op, ranks)`` a collective this
#: process ran, ``ranks`` the group it ran on, sorted
GROUPS: list | None = None


@contextlib.contextmanager
def record_groups():
    """Log the rank group of every collective this process runs inside
    the block into the list it yields: one entry a collective, except
    that a hypercube chain of two-way all-reduces (``ReplicaMesh.psum``)
    is one all-reduce over the ranks its rounds joined, so a chain cut
    short names fewer ranks than its level."""
    global GROUPS
    outer, GROUPS = GROUPS, []
    try:
        yield GROUPS
    finally:
        GROUPS = outer


def _log_group(op: str, ranks) -> None:
    if GROUPS is not None:
        GROUPS.append((op, sorted(ranks)))


#: while :func:`record_payloads` is open: ``(op, level, dtype)`` of every
#: collective this process runs, ``dtype`` its payload's as it crosses
#: (a compressed payload's ``uint8`` view, not the float it carries)
PAYLOADS: list | None = None


@contextlib.contextmanager
def record_payloads():
    """Log the level and payload dtype of every collective this process
    runs inside the block into the list it yields: one entry a
    collective call, a hypercube chain's rounds one each."""
    global PAYLOADS
    outer, PAYLOADS = PAYLOADS, []
    try:
        yield PAYLOADS
    finally:
        PAYLOADS = outer


def _log_payload(op: str, level: str, dtype) -> None:
    if PAYLOADS is not None:
        PAYLOADS.append((op, level, dtype))


def ledger_snapshot() -> dict[str, dict[str, int]]:
    return {lvl: dict(row) for lvl, row in LEDGER.items()}


def ledger_delta(before: dict, after: dict) -> dict[str, dict[str, int]]:
    """What ``after`` adds to ``before``, levels with nothing left out."""
    out = {}
    for lvl, row in after.items():
        base = before.get(lvl, {})
        d = {k: v - base.get(k, 0) for k, v in row.items()}
        if any(d.values()):
            out[lvl] = d
    return out


def level_name(axes) -> str:
    return "+".join(axes)


def _tally(level: str, op: str, nbytes: int, staged: int) -> None:
    # a level's row lists every op but the exchange, which only the
    # expert-parallel MoE issues: its key appears where it was used
    row = LEDGER.setdefault(level, dict.fromkeys(
        tuple(o for o in _OPS if o != "all_to_all")
        + ("bytes", "staged_bytes"), 0))
    row[op] = row.get(op, 0) + 1
    row["bytes"] += nbytes
    row["staged_bytes"] += staged


def kernel_counts() -> dict[str, int]:
    """Every kernel wrapper's launch count in this process."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import wa_update as wa
    return {"flash_fwd": fa.LAUNCHES, "paged_attention": pa.LAUNCHES,
            "wa_sync_fused": wa.LAUNCHES, "flash_bwd_dq": fab.DQ_LAUNCHES,
            "flash_bwd_dkv": fab.DKV_LAUNCHES,
            "wa_window_update": wa.WINDOW_UPDATE_LAUNCHES,
            "online_mean": wa.ONLINE_MEAN_LAUNCHES,
            "wa_window_update_c": wa.WINDOW_UPDATE_C_LAUNCHES,
            "wa_sync_fused_c": wa.SYNC_FUSED_C_LAUNCHES}


# ----------------------------------------------------- placement rules


def backend_for(device_type: str, world: int, n_cards: int) -> str:
    """``nccl`` when every rank has a card of its own, else ``gloo``."""
    if device_type == "cuda" and n_cards >= world:
        return "nccl"
    return "gloo"


def device_for(rank: int, device: str) -> torch.device:
    """Rank r runs on ``cuda:{r % device_count}``, or on the CPU."""
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


def check_compute_mode() -> None:
    """Several ranks on one card need its compute mode ``Default``: an
    exclusive-process card admits one context."""
    proc = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True)
    modes = [m.strip() for m in proc.stdout.splitlines() if m.strip()]
    if any(m != "Default" for m in modes):
        raise RuntimeError(f"ranks share a card, but its compute mode is "
                           f"{modes} (needs Default): an exclusive card "
                           f"admits one process")


def _is_pow2(n: int) -> bool:
    return n >= 1 and n & (n - 1) == 0


@dataclasses.dataclass
class _Level:
    """This rank's process groups for one level."""
    axes: tuple[str, ...]
    ranks: list[int]          # the level group holding this rank, sorted
    rounds: list[Any]         # (two-way group, its ranks): the chain
    group: Any                # the whole level group (None: one rank)


class MeshLayout:
    """The rank layout of a mesh, no process group: ``shape`` (axis ->
    size, in layout order), ranks laid out row-major over it. ``rank`` is
    the rank :meth:`coords` reads by default."""

    def __init__(self, shape: dict[str, int], rank: int = 0):
        self.shape = dict(shape)
        self.world = math.prod(self.shape.values())
        self.rank = rank

    def coords(self, rank: int | None = None) -> dict[str, int]:
        r = self.rank if rank is None else rank
        out = {}
        for axis in reversed(self.shape):
            out[axis] = r % self.shape[axis]
            r //= self.shape[axis]
        return {a: out[a] for a in self.shape}

    def size(self, axes) -> int:
        return math.prod(self.shape[a] for a in axes)

    def partition(self, axes) -> list[list[int]]:
        """The rank groups of a level: ranks equal off ``axes``."""
        groups: dict[tuple, list[int]] = {}
        for r in range(self.world):
            c = self.coords(r)
            key = tuple(c[a] for a in self.shape if a not in axes)
            groups.setdefault(key, []).append(r)
        return list(groups.values())


class ReplicaMesh(MeshLayout):
    """One rank's view of the replica mesh: its layout
    (:class:`MeshLayout`), rank, backend and device, and its process
    groups for ``levels`` (axis tuples) and the whole world. Construct it
    in every rank, in the same order: group creation is collective."""

    def __init__(self, shape: dict[str, int], rank: int, backend: str,
                 device: torch.device, levels=(), timeout: float = 60.0):
        super().__init__(shape, rank)
        self.backend = backend
        self.device = torch.device(device)
        self._timeout = datetime.timedelta(seconds=timeout)
        self._levels: dict[tuple[str, ...], _Level] = {}
        for axes in (tuple(self.shape),) + tuple(levels):
            self._build(tuple(axes))

    def _new_group(self, ranks):
        return dist.new_group(sorted(ranks), timeout=self._timeout)

    def _build(self, axes) -> None:
        axes = tuple(a for a in self.shape if a in axes)   # layout order
        if axes in self._levels:
            return
        parts = self.partition(axes)
        n = len(parts[0])
        mine = next(p for p in parts if self.rank in p)
        rounds, whole = [], None
        if n > 1:
            for p in parts:                  # every rank, same order
                g = self._new_group(p)
                if p is mine:
                    whole = g
            if _is_pow2(n):
                for j in range(n.bit_length() - 1):
                    for p in parts:
                        for i in range(n):
                            if i & (1 << j):
                                continue
                            pair = [p[i], p[i | (1 << j)]]
                            g = self._new_group(pair)
                            if self.rank in pair:
                                rounds.append((g, pair))
        self._levels[axes] = _Level(axes=axes, ranks=mine, rounds=rounds,
                                    group=whole)

    def level(self, axes) -> _Level:
        key = tuple(a for a in self.shape if a in axes)
        if key not in self._levels:
            raise KeyError(f"no process groups built for level {key}; "
                           f"pass it in ReplicaMesh(levels=...)")
        return self._levels[key]

    # ------------------------------------------------- collectives

    def _collective(self, op: str, level: str, x: torch.Tensor,
                    run: Callable[[torch.Tensor], Any], out_device=None,
                    ranks=None):
        """Run ``run`` on the tensor the backend takes for ``x``: ``x``
        itself, or for ``gloo`` and a CUDA tensor a host copy (the one
        place the port stages through host memory). Tallies the ledger,
        and logs ``ranks``, the group ``run`` uses (:func:`record_groups`;
        None: the caller logs). Returns what ``run`` returns, on
        ``out_device`` (``x``'s device unless given); a reduction in place
        writes ``x`` itself."""
        x = x.contiguous()
        staged = self.backend == "gloo" and x.is_cuda
        nbytes = x.numel() * x.element_size()
        _tally(level, op, nbytes, 2 * nbytes if staged else 0)
        _log_payload(op, level, x.dtype)
        if ranks is not None:
            _log_group(op, ranks)
        dst = x.device if out_device is None else torch.device(out_device)
        if not staged:
            out = run(x)
            return out if out is None or out is x else out.to(dst)
        host = x.cpu()
        out = run(host)
        if out is host:
            x.copy_(host)
            return x
        return None if out is None else out.to(dst)

    def psum(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The sum of ``x`` over a level, every rank receiving it: the
        hypercube chain of two-way all-reduces (power-of-two levels; ``x``
        is reduced IN PLACE and returned) or an all-gather and a local
        halving sum (a new tensor)."""
        from repro_torch.core.online import halving_sum_axis0
        lv = self.level(axes)
        name = level_name(lv.axes)
        n = len(lv.ranks)
        if n == 1:
            return x
        if not _is_pow2(n):
            return halving_sum_axis0(self.all_gather(x, axes))
        shape = x.shape
        flat = x.reshape(-1)
        # the ranks the chain's rounds join: a round's partner differs
        # from this rank in one bit of its level index, the same offset
        # for every rank joined so far
        joined = [self.rank]
        for g, pair in lv.rounds:
            def reduce(t, g=g):
                dist.all_reduce(t, group=g)
                return t
            flat = self._collective("all_reduce", name, flat, reduce)
            step = sum(pair) - 2 * self.rank
            joined += [r + step for r in joined]
        _log_group("all_reduce", joined)
        return flat.reshape(shape)

    def all_gather(self, x: torch.Tensor, axes, level: str | None = None
                   ) -> torch.Tensor:
        """``(n, *x.shape)``: every rank's ``x`` over a level, in rank
        order."""
        lv = self.level(axes)
        name = level or level_name(lv.axes)
        if len(lv.ranks) == 1:
            return x[None].clone()

        def gather(t):
            outs = [torch.empty_like(t) for _ in lv.ranks]
            dist.all_gather(outs, t, group=lv.group)
            return torch.stack(outs)
        return self._collective("all_gather", name, x, gather,
                                ranks=lv.ranks)

    def all_to_all(self, x: torch.Tensor, axes) -> torch.Tensor:
        """The exchange over a level: ``x`` is ``(n, ...)``, one block a
        rank of the level in rank order; the result is ``(n, ...)`` with
        block i the block rank i sent this rank (its ``x[index]``). Its
        own transpose: the backward of an exchange is the same
        exchange."""
        lv = self.level(axes)
        n = len(lv.ranks)
        if x.shape[0] != n:
            raise ValueError(f"all_to_all over {n} ranks needs a leading "
                             f"dim of {n}, got {tuple(x.shape)}")
        if n == 1:
            return x.clone()

        def exchange(t):
            out = torch.empty_like(t)
            dist.all_to_all_single(out, t, group=lv.group)
            return out
        return self._collective("all_to_all", level_name(lv.axes), x,
                                exchange, ranks=lv.ranks)

    def gather(self, x: torch.Tensor, level: str, dst: int = 0,
               out_device=None, axes=None) -> torch.Tensor | None:
        """``(world, *x.shape)`` of every rank's ``x`` on rank ``dst``, on
        ``out_device`` (``x``'s device unless given), None on the other
        ranks: checkpoints, the final state, probes. With ``axes``, over
        that level's group holding this rank only (``(n, *x.shape)`` in
        rank order on its first rank)."""
        lv = self.level(axes) if axes is not None else None
        ranks = lv.ranks if lv is not None else list(range(self.world))
        if len(ranks) == 1:
            return x[None].clone().to(out_device or x.device)
        if lv is not None:
            dst = ranks[0]

        def gather(t):
            outs = ([torch.empty_like(t) for _ in ranks]
                    if self.rank == dst else None)
            dist.gather(t, outs, dst=dst,
                        group=None if lv is None else lv.group)
            return torch.stack(outs) if outs is not None else None
        return self._collective("gather", level, x, gather, out_device,
                                ranks=ranks)

    def barrier(self, level: str) -> None:
        if self.world > 1:
            _tally(level, "barrier", 0, 0)
            _log_group("barrier", range(self.world))
            dist.barrier()


# ------------------------------------------------------------ spawning


def _resolve(target: str) -> Callable:
    mod, _, name = target.partition(":")
    return getattr(importlib.import_module(mod), name)


def _rank_entry(rank: int, shape: dict, backend: str, device: str,
                init_method: str, target: str, payload: Any, workdir: str,
                levels: tuple, timeout: float) -> None:
    """One rank: the process group, the mesh, ``target(mesh, payload)``;
    its return value, ledger and kernel counts land in
    ``workdir/rank{r}.pt`` (a traceback in ``rank{r}.err`` on failure)."""
    world = math.prod(shape.values())
    try:
        dev = device_for(rank, device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
        try:
            mesh = ReplicaMesh(shape, rank, backend, dev, levels=levels,
                               timeout=timeout)
            result = _resolve(target)(mesh, payload)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            torch.save({"result": result, "ledger": ledger_snapshot(),
                        "launches": kernel_counts()},
                       os.path.join(workdir, f"rank{rank}.pt"))
        finally:
            dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(workdir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise SystemExit(1)


def spawn_ranks(shape: dict[str, int], target: str, payload: Any = None, *,
                device: str = "cpu", levels=(), timeout: float = 1800.0,
                collective_timeout: float = 60.0) -> list[dict]:
    """Run ``target`` ("module:function", called as ``fn(mesh,
    payload)``) in one spawned process per rank of a mesh of ``shape``.
    Returns, per rank, ``{"result", "ledger", "launches"}``. The ranks
    meet through a ``file://`` store in a fresh temporary directory (no
    port to share), removed at the end. A rank that fails ends the others
    at once and raises here with its traceback; the whole run is ended
    at ``timeout`` seconds."""
    world = math.prod(shape.values())
    dev_type = torch.device(device).type
    n_cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    backend = backend_for(dev_type, world, n_cards)
    if dev_type == "cuda" and n_cards < world:
        check_compute_mode()
    workdir = tempfile.mkdtemp(prefix="repro_mesh_")
    store = os.path.join(workdir, "store")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry, args=(
        r, dict(shape), backend, device, f"file://{store}", target, payload,
        workdir, tuple(tuple(lv) for lv in levels), collective_timeout))
        for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
    try:
        errors = []
        for r, p in enumerate(procs):
            err = os.path.join(workdir, f"rank{r}.err")
            if os.path.exists(err):
                errors.append(f"--- rank {r}\n{open(err).read()}")
            elif p.exitcode != 0:
                errors.append(f"--- rank {r} ended with exit code "
                              f"{p.exitcode}")
        if errors:
            raise RuntimeError(f"{target} failed on {len(errors)} of "
                               f"{world} ranks:\n" + "\n".join(errors))
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
