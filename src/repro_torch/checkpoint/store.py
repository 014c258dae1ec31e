"""Disk-backed store of outer-weight checkpoints (counterpart of
``repro.checkpoint.store``; paper Algorithm 2 input).

The HWA offline module consumes the outer weights W̄_e saved at each
synchronization cycle. In training the window lives on the device
(``core.offline``); the store is the paper's file path (Algorithm 2
reads "Checkpoints of Outer Weights") and allows post-hoc window sweeps
(trying several I, §III-B) without retraining.
"""
from __future__ import annotations

import os
import re
import warnings
from typing import Any

import torch

from repro_torch.checkpoint.io import _read_raw, load_pytree, save_pytree
from repro_torch.common.pytree import tree_map


class OuterWeightStore:
    """``keep_last`` bounds the store: after every save, cycles older
    than the newest N are deleted (a long run would otherwise keep one
    parameter set per sync cycle). ``None`` keeps everything (the
    post-hoc window sweep needs the history)."""

    def __init__(self, directory: str, keep_last: int | None = None):
        if keep_last is not None and keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        self.directory = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    def _path(self, cycle: int) -> str:
        return os.path.join(self.directory, f"outer_{cycle:06d}.npz")

    def save(self, cycle: int, outer_weights: Any) -> None:
        save_pytree(self._path(cycle), outer_weights)
        if self.keep_last is not None:
            for old in self.cycles()[:-self.keep_last]:
                try:
                    os.remove(self._path(old))
                except OSError as e:          # pragma: no cover - racy FS
                    warnings.warn(f"retention: could not remove outer "
                                  f"checkpoint {old}: {e}")

    def verify(self) -> dict[int, str]:
        """``{cycle: problem}`` for every stored checkpoint that cannot
        be read back (a truncated or corrupted npz). Empty: all good."""
        bad: dict[int, str] = {}
        for c in self.cycles():
            try:
                _read_raw(self._path(c))
            except Exception as e:       # any unreadable file is reported
                bad[c] = f"{type(e).__name__}: {e}"
        return bad

    def load(self, cycle: int, like: Any) -> Any:
        return load_pytree(self._path(cycle), like)

    def cycles(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"outer_(\d+)\.npz", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def window_average(self, end_cycle: int, window: int, like: Any,
                       stride: int = 1) -> Any:
        """W̿_e = the mean of W̄_t over the slide window ending at e, in
        the dtypes of ``like``.

        ``stride`` is the paper's sparse window (§III-B): only cycles at
        multiples of ``stride`` from ``end_cycle`` are averaged. A
        partial or unreadable ``outer_*.npz`` inside the window (a torn
        write, bit rot) is skipped with a warning and the average is
        taken over the cycles that loaded; only a window with NO readable
        cycle raises.
        """
        cycles = [c for c in self.cycles()
                  if end_cycle - window * stride < c <= end_cycle
                  and (c - end_cycle) % stride == 0]
        if not cycles:
            raise ValueError(f"no checkpoints in window ending at {end_cycle}")
        acc = tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                       like)
        n_used = 0
        for c in cycles:
            try:
                w = self.load(c, like)
            except Exception as e:       # a damaged file is skipped
                warnings.warn(f"skipping unreadable outer checkpoint "
                              f"{c} ({self._path(c)}): "
                              f"{type(e).__name__}: {e}")
                continue
            acc = tree_map(lambda a, x: a + x.to(torch.float32), acc, w)
            n_used += 1
        if not n_used:
            raise ValueError(f"no READABLE checkpoints in window ending at "
                             f"{end_cycle} ({len(cycles)} present, all "
                             f"corrupt — see warnings)")
        return tree_map(lambda a, t: (a * (1.0 / n_used)).to(t.dtype), acc,
                        like)
