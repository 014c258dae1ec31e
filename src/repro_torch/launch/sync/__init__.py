"""The sync-topology subsystem of mesh-native HWA (counterpart of
``repro.launch.sync``):

- ``topology``: WHERE and WHEN the replica mean reduces, ``Flat`` or
  ``TwoLevel``;
- ``packed``: the packed-layout chooser and the per-rank sync bodies
  over the rank mesh (``launch.mesh``);
- ``bundles``: the replica's layout and the mesh-native step builders;
- ``plan``: ``SyncPlan`` and ``build_hwa_bundles``, the one constructor.

The reference's GSPMD builders and ``legacy.py`` have no counterpart:
they exist for XLA's partitioner.
"""
from repro_torch.launch.sync.bundles import StepBundle
from repro_torch.launch.sync.plan import (HWABundles, SyncPlan,
                                          build_hwa_bundles,
                                          window_state_args)
from repro_torch.launch.sync.topology import Flat, SyncTopology, TwoLevel

__all__ = ["Flat", "HWABundles", "StepBundle", "SyncPlan", "SyncTopology",
           "TwoLevel", "build_hwa_bundles", "window_state_args"]
