"""Deterministic synthetic-but-learnable data (counterpart of
``repro.data.synthetic``): the Markov LM set and the prototype image set.

LM sequences come from a fixed random first-order Markov chain over the
vocabulary, whose transition rows are Dirichlet(concentration) draws: a
model must learn the transition structure, a finite train set can be
memorized, fresh test sequences cannot. Everything is drawn from one
explicit ``torch.Generator`` seeded with ``seed`` on the target device;
torch's Philox and JAX's threefry differ, so the data matches the
reference in distribution, not in bits (parity tests inject the
reference's batches, and hold the port's own sets to their properties).

The V x V transition matrix (9.7 GB in f32 at a 49k vocabulary) lives
only while the sequences are sampled; only the tokens are kept.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class SyntheticDataset:
    """A finite train split plus a held-out test split."""
    train_inputs: torch.Tensor
    train_targets: torch.Tensor
    test_inputs: torch.Tensor
    test_targets: torch.Tensor
    kind: str = "lm"

    @property
    def n_train(self) -> int:
        return int(self.train_inputs.shape[0])

    @property
    def n_test(self) -> int:
        return int(self.test_inputs.shape[0])


def _standard_gamma(alpha: float, shape, gen, device) -> torch.Tensor:
    """Gamma(alpha, 1) draws from ``gen`` (Marsaglia-Tsang on alpha + 1,
    then the alpha < 1 boost u**(1/alpha))."""
    a = alpha + 1.0 if alpha < 1.0 else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    out = torch.empty(shape, dtype=torch.float32, device=device)
    todo = torch.ones(shape, dtype=torch.bool, device=device)
    while bool(todo.any()):
        x = torch.randn(shape, generator=gen, device=device)
        u = torch.rand(shape, generator=gen, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo &= ~ok
    if alpha < 1.0:
        u = torch.rand(shape, generator=gen, device=device)
        out = out * u ** (1.0 / alpha)
    return out


def _transitions(vocab: int, concentration: float, gen, device,
                 rows_per_chunk: int = 4096) -> torch.Tensor:
    """(V, V) row-stochastic matrix, rows ~ Dirichlet(concentration),
    drawn in row chunks so the temporaries stay small."""
    trans = torch.empty((vocab, vocab), dtype=torch.float32, device=device)
    for r0 in range(0, vocab, rows_per_chunk):
        g = _standard_gamma(concentration,
                            (min(rows_per_chunk, vocab - r0), vocab), gen,
                            device)
        trans[r0:r0 + g.shape[0]] = g / g.sum(-1, keepdim=True)
    return trans


def _sample_markov(trans, n_seq: int, seq_len: int, gen) -> torch.Tensor:
    """``n_seq`` sequences of a first-order chain: the first token
    uniform, then categorical draws with logits log(trans + 1e-9), as the
    reference draws them (sampled here in probability space, the same
    distribution)."""
    vocab = trans.shape[0]
    dev = trans.device
    seqs = torch.empty((n_seq, seq_len), dtype=torch.int64, device=dev)
    seqs[:, 0] = torch.randint(0, vocab, (n_seq,), generator=gen, device=dev)
    for t in range(1, seq_len):
        probs = trans[seqs[:, t - 1]] + 1e-9
        seqs[:, t] = torch.multinomial(probs, 1, generator=gen)[:, 0]
    return seqs


def make_markov_lm_dataset(vocab: int = 256, seq_len: int = 128,
                           n_train: int = 2048, n_test: int = 512,
                           seed: int = 0, concentration: float = 0.3,
                           device=None) -> SyntheticDataset:
    """LM dataset on ``device`` (the card unless "cpu"): inputs are tokens,
    targets the next tokens (int32)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    trans = _transitions(vocab, concentration, gen, dev)
    train = _sample_markov(trans, n_train, seq_len + 1, gen).to(torch.int32)
    test = _sample_markov(trans, n_test, seq_len + 1, gen).to(torch.int32)
    del trans
    return SyntheticDataset(
        train_inputs=train[:, :-1].contiguous(),
        train_targets=train[:, 1:].contiguous(),
        test_inputs=test[:, :-1].contiguous(),
        test_targets=test[:, 1:].contiguous(), kind="lm")


def make_prototype_image_dataset(n_classes: int = 10, image_size: int = 16,
                                 channels: int = 3, n_train: int = 4096,
                                 n_test: int = 1024, noise: float = 0.7,
                                 label_noise: float = 0.05, seed: int = 0,
                                 device=None) -> SyntheticDataset:
    """Image classification on ``device`` (the card unless "cpu"): one
    N(0, 1) prototype image per class, each sample its class's prototype
    plus ``noise`` x N(0, 1), NHWC f32, int32 labels; a ``label_noise``
    share of the TRAIN labels is replaced by a uniform draw (hard samples
    a model can only memorize)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (image_size, image_size, channels)
    protos = torch.randn((n_classes,) + shape, generator=gen, device=dev)

    def split(n):
        y = torch.randint(0, n_classes, (n,), generator=gen, device=dev)
        x = protos[y] + noise * torch.randn((n,) + shape, generator=gen,
                                            device=dev)
        return x, y.to(torch.int32)

    xtr, ytr = split(n_train)
    xte, yte = split(n_test)
    if label_noise > 0:
        flip = torch.rand((n_train,), generator=gen, device=dev) < label_noise
        rand_y = torch.randint(0, n_classes, (n_train,), generator=gen,
                               device=dev).to(torch.int32)
        ytr = torch.where(flip, rand_y, ytr)
    return SyntheticDataset(train_inputs=xtr, train_targets=ytr,
                            test_inputs=xte, test_targets=yte, kind="image")
