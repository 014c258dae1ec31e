"""Deterministic fault injectors for the resilience harness
(counterpart of ``repro.resilience.faults``).

An *injector* is a callable ``(point: str, path: str) -> None`` that
:class:`~repro_torch.resilience.session.CheckpointSession` fires at named IO
points (``"array_write"``, ``"window_write"``, ``"manifest_write"``)
right after the corresponding file write, inside the retried region.
Two exception classes split the failure modes:

- :class:`InjectedIOError` subclasses :class:`OSError` — the class the
  session's capped-backoff retry loop catches — so a
  :class:`TransientIO` fault exercises the retry path and the save
  ultimately succeeds.
- :class:`SimulatedCrash` subclasses :class:`BaseException` so it
  ESCAPES the retry loop (and any stray ``except Exception``),
  modelling a preemption/SIGKILL: the save is torn exactly where the
  fault fired and the process would be gone.

Everything here is deterministic (occurrence counters, fixed byte
offsets), so a fault run is reproducible.
"""
from __future__ import annotations

import dataclasses
import os


class SimulatedCrash(BaseException):
    """Process death mid-save (preemption). BaseException on purpose:
    it must not be swallowed by IO retry loops."""


class InjectedIOError(OSError):
    """A transient IO failure (flaky NFS, throttled object store)."""


@dataclasses.dataclass
class KillAt:
    """Raise :class:`SimulatedCrash` at the Nth firing of ``point``,
    optionally truncating the just-written file first (a torn write
    the crash then publishes nothing for — the manifest-last protocol
    means the checkpoint is left without a valid manifest)."""
    point: str
    occurrence: int = 1
    truncate_frac: float | None = None
    seen: int = 0

    def __call__(self, point: str, path: str) -> None:
        if point != self.point:
            return
        self.seen += 1
        if self.seen == self.occurrence:
            if (self.truncate_frac is not None and path
                    and os.path.exists(path)):
                truncate_file(path, self.truncate_frac)
            raise SimulatedCrash(
                f"injected kill at {point!r} #{self.occurrence} ({path})")


@dataclasses.dataclass
class TransientIO:
    """Raise :class:`InjectedIOError` on the first ``times`` firings of
    ``point``; subsequent firings pass (the retry loop wins)."""
    point: str
    times: int = 1
    seen: int = 0

    def __call__(self, point: str, path: str) -> None:
        if point != self.point:
            return
        self.seen += 1
        if self.seen <= self.times:
            raise InjectedIOError(
                f"injected transient IO error at {point!r} "
                f"#{self.seen}/{self.times} ({path})")


def truncate_file(path: str, frac: float = 0.5) -> int:
    """Truncate ``path`` to ``frac`` of its size (torn write). Returns
    the new size."""
    size = os.path.getsize(path)
    new = max(0, int(size * frac))
    with open(path, "r+b") as f:
        f.truncate(new)
    return new


def flip_bit(path: str, offset: int | None = None, bit: int = 0) -> int:
    """Flip one bit of the byte at ``offset`` (default: mid-file —
    deterministically inside the payload of any non-trivial npz).
    Returns the offset flipped. Either the zip structure breaks (load
    fails) or an array's bytes change (CRC32 mismatch) — both must be
    caught by :meth:`CheckpointSession.verify`."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"flip_bit: {path} is empty")
    off = size // 2 if offset is None else offset
    with open(path, "r+b") as f:
        f.seek(off)
        b = f.read(1)
        f.seek(off)
        f.write(bytes([b[0] ^ (1 << bit)]))
    return off


def poison_replica(tree, replica: int, value: float = float("nan")):
    """A copy of ``tree`` with replica ``replica``'s slice of every
    floating stacked leaf set to ``value`` (default NaN): the
    deterministic 'replica went insane' injection. Other leaves are
    returned as they are."""
    from repro_torch.common.pytree import tree_map

    def one(x):
        if not x.is_floating_point():
            return x
        x = x.clone()
        x[replica] = value
        return x

    return tree_map(one, tree)
