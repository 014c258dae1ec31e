"""Preemption-safe checkpoint sessions: manifest-last, CRC-verified,
retained, resumable (counterpart of ``repro.resilience.session``; a
session directory either package writes, the other verifies and
loads).

Layout of a session directory::

    <dir>/
      step_00000040/
        inner.npz           # one npz per named pytree (atomic writes)
        window.npz          # packed WindowState (optional)
        manifest.json       # written LAST, atomically — the commit point
      step_00000080/ ...
      latest                # text hint: newest step (never trusted)

The **manifest-last protocol** is what makes a kill at ANY point safe:
array files are written first (each itself atomic via the hardened
``checkpoint.io.save_pytree`` — unique tmp + fsync + rename), and the
manifest — carrying per-array CRC32s, shapes, dtypes and file sizes —
is published last. A checkpoint without a valid, matching manifest is
simply not a checkpoint; :meth:`latest_intact` scans steps newest-first
and falls back past torn (no manifest) and corrupted (CRC/size/load
mismatch) directories to the newest one that verifies.

Transient IO errors (``OSError``) during a save are retried with capped
exponential backoff; :class:`~repro_torch.resilience.faults.SimulatedCrash`
is a ``BaseException`` precisely so it escapes this loop. ``gc()`` runs
only after a successful manifest publish, so the newest surviving
checkpoint is always intact.

What "resume bit-exactly" needs from the trainer: params, optimizer
state, the packed window ring/total/counters, and the step counter —
the data pipeline is a stateless function of ``(seed, step)``, so
restoring the step IS restoring the data pipeline's position.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Mapping

from repro_torch.checkpoint.io import (_read_stored, crc_records,
                                       load_pytree, load_window_state,
                                       save_pytree, save_window_state)

MANIFEST = "manifest.json"
MANIFEST_VERSION = 1
_STEP_RE = "step_"


def _crc_entries(path: str) -> dict[str, dict]:
    """Per-array integrity records of an npz written by either package,
    keyed by stored leaf key (``checkpoint.io.crc_records`` of what the
    file holds), as both packages record them."""
    return crc_records(*_read_stored(path))


class CheckpointSession:
    """A versioned, preemption-safe checkpoint directory (module doc).

    ``fault_injector`` is a ``(point, path) -> None`` callable fired
    after each file write *inside the retried region* — the hook the
    fault-injection harness uses; ``None`` in production.
    """

    def __init__(self, directory: str, *, keep: int = 3, retries: int = 3,
                 backoff: float = 0.05, max_backoff: float = 1.0,
                 fault_injector: Callable[[str, str], None] | None = None,
                 sleep: Callable[[float], None] = time.sleep):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = directory
        self.keep = keep
        self.retries = retries
        self.backoff = backoff
        self.max_backoff = max_backoff
        self.fault_injector = fault_injector
        self._sleep = sleep
        self.io_retries = 0          # total retried OSErrors (observability)
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ paths

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def steps(self) -> list[int]:
        """All step numbers with a checkpoint directory (intact or not)."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith(_STEP_RE) and name[len(_STEP_RE):].isdigit():
                if os.path.isdir(os.path.join(self.directory, name)):
                    out.append(int(name[len(_STEP_RE):]))
        return sorted(out)

    # ------------------------------------------------------------- save

    def _fire(self, point: str, path: str) -> None:
        if self.fault_injector is not None:
            self.fault_injector(point, path)

    def _write(self, point: str, path: str, write: Callable[[], None]) -> None:
        """Run one file write with capped-backoff retry on OSError. The
        fault hook fires after the write, inside the retried region, so
        an injected transient error forces a clean rewrite."""
        delay = self.backoff
        for attempt in range(self.retries + 1):
            try:
                write()
                self._fire(point, path)
                return
            except OSError:
                if attempt == self.retries:
                    raise
                self.io_retries += 1
                self._sleep(min(delay, self.max_backoff))
                delay *= 2.0

    def save(self, step: int, trees: Mapping[str, Any], *,
             window: Any = None, meta: Mapping[str, Any] | None = None
             ) -> str:
        """Write one checkpoint; returns its directory. Commit point is
        the manifest publish — a crash anywhere before it leaves a torn,
        ignorable directory and the previous checkpoint authoritative."""
        d = self.step_dir(step)
        os.makedirs(d, exist_ok=True)
        files: dict[str, dict] = {}

        crcs: dict[str, dict] = {}

        def record(fname: str) -> None:
            # the records of the arrays as written (computed from them in
            # memory: the same bytes a read-back would give, not read
            # back); ``verify`` reads the file
            path = os.path.join(d, fname)
            files[fname] = {"size": os.path.getsize(path),
                            "arrays": crcs.pop(fname)}

        def write(fname, save, *args):
            crcs[fname] = save(*args)

        for name in sorted(trees):
            if not name.isidentifier():
                raise ValueError(f"tree name {name!r} is not a plain "
                                 f"identifier")
            fname = f"{name}.npz"
            path = os.path.join(d, fname)
            self._write("array_write", path,
                        lambda f=fname, p=path, t=trees[name]: write(
                            f, save_pytree, p, t))
            record(fname)
        if window is not None:
            path = os.path.join(d, "window.npz")
            self._write("window_write", path, lambda: write(
                "window.npz", save_window_state, path, window))
            record("window.npz")

        manifest = {"version": MANIFEST_VERSION, "step": step,
                    "files": files, "meta": dict(meta or {})}
        mpath = os.path.join(d, MANIFEST)
        tmp = f"{mpath}.tmp.{os.getpid()}"

        def write_manifest() -> None:
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            self._fire("manifest_write", tmp)
            os.replace(tmp, mpath)

        try:
            self._write("manifest_publish", mpath, write_manifest)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        # hint only — latest_intact() never trusts it
        with open(os.path.join(self.directory, "latest"), "w",
                  encoding="utf-8") as f:
            f.write(f"{step}\n")
        self.gc()
        return d

    # ----------------------------------------------------------- verify

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.step_dir(step), MANIFEST),
                  encoding="utf-8") as f:
            return json.load(f)

    def meta(self, step: int) -> dict:
        return self.manifest(step).get("meta", {})

    def verify(self, step: int, first: bool = False
               ) -> tuple[bool, list[str]]:
        """Deep-check one checkpoint: manifest present/parsable, every
        file present with the recorded size, loadable, and every array
        matching its recorded CRC32/dtype/shape. With ``first`` the check
        ends at the first file with a problem (the files after it are
        not read)."""
        problems: list[str] = []
        d = self.step_dir(step)
        try:
            manifest = self.manifest(step)
        except Exception as e:
            return False, [f"manifest unreadable: {type(e).__name__}: {e}"]
        if manifest.get("version") != MANIFEST_VERSION:
            return False, [f"manifest version "
                           f"{manifest.get('version')!r} != "
                           f"{MANIFEST_VERSION}"]
        for fname, rec in manifest.get("files", {}).items():
            if first and problems:
                break
            path = os.path.join(d, fname)
            if not os.path.exists(path):
                problems.append(f"{fname}: missing")
                continue
            size = os.path.getsize(path)
            if size != rec.get("size"):
                problems.append(f"{fname}: size {size} != recorded "
                                f"{rec.get('size')}")
                continue
            try:
                got = _crc_entries(path)
            except Exception as e:
                problems.append(f"{fname}: unreadable: "
                                f"{type(e).__name__}: {e}")
                continue
            want = rec.get("arrays", {})
            if set(got) != set(want):
                problems.append(f"{fname}: array keys changed")
                continue
            for key, w in want.items():
                g = got[key]
                for field in ("crc32", "dtype", "shape"):
                    if g[field] != w[field]:
                        problems.append(
                            f"{fname}:{key}: {field} {g[field]!r} != "
                            f"recorded {w[field]!r}")
        return not problems, problems

    def latest_intact(self) -> int | None:
        """Newest step whose checkpoint verifies; ``None`` when no
        intact checkpoint exists. Scans newest-first, so a torn newest
        save falls back to the previous intact one; a step is left at
        its first bad file."""
        for step in reversed(self.steps()):
            ok, _ = self.verify(step, first=True)
            if ok:
                return step
        return None

    # ------------------------------------------------------------- load

    def load(self, step: int, name: str, like: Any) -> Any:
        return load_pytree(os.path.join(self.step_dir(step),
                                        f"{name}.npz"), like)

    def load_window(self, step: int, like: Any) -> Any:
        return load_window_state(os.path.join(self.step_dir(step),
                                              "window.npz"), like)

    # --------------------------------------------------------------- gc

    def gc(self) -> list[int]:
        """Drop all but the newest ``keep`` checkpoint directories.
        Called only after a successful save (so the newest survivor is
        intact by construction). Returns the removed steps."""
        removed = []
        for step in self.steps()[:-self.keep]:
            try:
                shutil.rmtree(self.step_dir(step))
                removed.append(step)
            except OSError:          # pragma: no cover - racey FS
                pass
        return removed
