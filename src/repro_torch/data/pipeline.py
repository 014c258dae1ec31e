"""Per-replica data pipeline (counterpart of ``repro.data.pipeline``).

The paper (Alg. 1, line 6) needs each of the K replicas to see batches
"with different sampling orders": replica k at step i takes a slice of
a permutation of the train set drawn for (seed, k, epoch), so within an
epoch each replica does without-replacement SGD in its own order. The
indices are a pure function of (seed, replica, step): a generator is
seeded from that triple for every call, so nothing carries state.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.data.synthetic import SyntheticDataset

_MIX = 0x9E3779B97F4A7C15       # 64-bit golden-ratio constant


def _stream_seed(seed: int, replica: int, epoch: int) -> int:
    h = seed & 0xFFFFFFFFFFFFFFFF
    for v in (replica, epoch):
        h = ((h ^ (v & 0xFFFFFFFFFFFFFFFF)) * _MIX + 0x632BE59BD9B4E019) \
            & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 31
    return h & 0x7FFFFFFFFFFFFFFF


def replica_batch_indices(seed: int, replica_id: int, step: int,
                          n_train: int, batch_size: int,
                          device=None) -> torch.Tensor:
    """Deterministic without-replacement batch indices for one replica."""
    steps_per_epoch = max(n_train // batch_size, 1)
    epoch, pos = divmod(int(step), steps_per_epoch)
    gen = torch.Generator(device=device or "cpu").manual_seed(
        _stream_seed(seed, int(replica_id), epoch))
    perm = torch.randperm(n_train, generator=gen, device=device)
    return perm[pos * batch_size:(pos + 1) * batch_size]


@dataclasses.dataclass
class DataPipeline:
    """Batches a :class:`SyntheticDataset` for K replicas, on the
    dataset's device."""
    dataset: SyntheticDataset
    batch_size: int
    n_replicas: int = 1
    seed: int = 0

    @property
    def steps_per_epoch(self) -> int:
        return max(self.dataset.n_train // self.batch_size, 1)

    def replica_batch(self, replica_id, step):
        """(inputs, targets) for one replica at one step."""
        ds = self.dataset
        idx = replica_batch_indices(self.seed, replica_id, step, ds.n_train,
                                    self.batch_size,
                                    device=ds.train_inputs.device)
        return ds.train_inputs[idx], ds.train_targets[idx]

    def stacked_batch(self, step):
        """Batches for all K replicas, stacked on axis 0: (K, B, ...)."""
        rows = [self.replica_batch(r, step) for r in range(self.n_replicas)]
        return (torch.stack([r[0] for r in rows]),
                torch.stack([r[1] for r in rows]))

    def eval_batches(self, batch_size: int | None = None):
        """Iterator over the test split (drops the remainder)."""
        bs = batch_size or self.batch_size
        ds = self.dataset
        n = (ds.n_test // bs) * bs
        for i in range(0, n, bs):
            yield ds.test_inputs[i:i + bs], ds.test_targets[i:i + bs]
