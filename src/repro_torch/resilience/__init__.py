"""Fault tolerance for HWA (counterpart of ``repro.resilience``; the part
ported so far):

- :mod:`repro_torch.resilience.session` — :class:`CheckpointSession`: a
  versioned checkpoint directory (per-step subdirectories, a manifest
  written last with per-array CRC32s, retention, a ``latest`` hint) on
  the atomic npz writers of ``checkpoint/io.py``; ``latest_intact()``
  falls back past torn or corrupted checkpoints.
- :mod:`repro_torch.resilience.faults` — deterministic fault injectors
  (NaN-poisoned replicas, kill mid-save, bit flips, transient IO
  errors).

The replica health probes and the alive-masked mean (``health.py``,
``check.py``, ``HWAConfig.resilient``) wait for ROADMAP.md Queue A 12.
"""
from repro_torch.resilience.faults import (InjectedIOError, KillAt,
                                           SimulatedCrash, TransientIO,
                                           flip_bit, poison_replica,
                                           truncate_file)
from repro_torch.resilience.session import CheckpointSession

__all__ = [
    "CheckpointSession",
    "InjectedIOError",
    "KillAt",
    "SimulatedCrash",
    "TransientIO",
    "flip_bit",
    "poison_replica",
    "truncate_file",
]
