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
- :mod:`repro_torch.resilience.health` — replica health probes and the
  alive-masked K-mean that ``HWAConfig(resilient=True)`` syncs with.
- :mod:`repro_torch.resilience.check` — the fault-check harness's legs
  that need no mesh (``python -m repro_torch.resilience.check``).
"""
from repro_torch.resilience.faults import (InjectedIOError, KillAt,
                                           SimulatedCrash, TransientIO,
                                           flip_bit, poison_replica,
                                           truncate_file)
from repro_torch.resilience.health import (alive_from_stats,
                                           masked_mean_axis0,
                                           packed_health_stats,
                                           quarantine_opt_state,
                                           renormalized_inv,
                                           replica_alive_mask)
from repro_torch.resilience.session import CheckpointSession

__all__ = [
    "CheckpointSession",
    "InjectedIOError",
    "KillAt",
    "SimulatedCrash",
    "TransientIO",
    "alive_from_stats",
    "flip_bit",
    "masked_mean_axis0",
    "packed_health_stats",
    "poison_replica",
    "quarantine_opt_state",
    "renormalized_inv",
    "replica_alive_mask",
    "truncate_file",
]
