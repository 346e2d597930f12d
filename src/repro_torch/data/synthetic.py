"""Deterministic synthetic-but-learnable datasets.

A copy of the JAX package's ``repro/data/synthetic.py`` (numpy only), so the
port feeds the same batches from the same seeds.

The fig4 statistical-efficiency experiments need a task with a real loss
floor and a meaningful "epochs to converge" — a fixed-seed order-2 Markov
chain LM provides both: the optimal loss is its conditional entropy, and a
model must actually learn the transition table to reach it.  Epoch semantics
(a finite dataset iterated in a shuffled order) follow the paper's setup.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class MarkovLM:
    """Order-2 Markov chain over `vocab` symbols; dataset of `n_items`
    sequences of `seq_len` tokens."""

    vocab: int = 64
    seq_len: int = 64
    n_items: int = 4096
    seed: int = 0
    temperature: float = 1.2

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        logits = rng.normal(size=(self.vocab, self.vocab, self.vocab)) \
            * self.temperature
        self.trans = np.exp(logits)
        self.trans /= self.trans.sum(-1, keepdims=True)
        self._data = self._generate(rng)

    def _generate(self, rng) -> np.ndarray:
        n, t, v = self.n_items, self.seq_len + 1, self.vocab
        seqs = np.zeros((n, t), dtype=np.int32)
        seqs[:, 0] = rng.integers(0, v, n)
        seqs[:, 1] = rng.integers(0, v, n)
        for i in range(2, t):
            p = self.trans[seqs[:, i - 2], seqs[:, i - 1]]
            cum = p.cumsum(-1)
            u = rng.random((n, 1))
            seqs[:, i] = (u > cum).sum(-1)
        return seqs

    @property
    def entropy(self) -> float:
        """Conditional entropy = the optimal achievable loss (nats/token)."""
        h = -(self.trans * np.log(self.trans + 1e-12)).sum(-1)
        return float(h.mean())

    def epoch(self, epoch_idx: int, global_batch: int) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + 1000 + epoch_idx)
        order = rng.permutation(self.n_items)
        for i in range(0, self.n_items - global_batch + 1, global_batch):
            idx = order[i:i + global_batch]
            seqs = self._data[idx]
            yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}

    def steps_per_epoch(self, global_batch: int) -> int:
        return self.n_items // global_batch


@dataclasses.dataclass
class SyntheticSeq2Seq:
    """Learnable copy-with-vocab-map task for GNMT-style models."""

    vocab: int = 64
    seq_len: int = 24
    n_items: int = 2048
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.perm = rng.permutation(self.vocab)
        self.src = rng.integers(2, self.vocab, (self.n_items, self.seq_len),
                                dtype=np.int32)
        self.tgt = self.perm[self.src].astype(np.int32)

    def epoch(self, epoch_idx: int, global_batch: int) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + 1000 + epoch_idx)
        order = rng.permutation(self.n_items)
        for i in range(0, self.n_items - global_batch + 1, global_batch):
            idx = order[i:i + global_batch]
            tgt_in = np.concatenate(
                [np.ones((len(idx), 1), np.int32), self.tgt[idx][:, :-1]], 1)
            yield {"src": self.src[idx], "tgt": tgt_in,
                   "labels": self.tgt[idx]}


@dataclasses.dataclass
class SyntheticImageDataset:
    """Class-conditional Gaussian blobs for the Inception-V3 convergence runs."""

    n_classes: int = 16
    image_size: int = 64
    n_items: int = 2048
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.protos = rng.normal(size=(self.n_classes, 8, 8, 3)).astype(np.float32)
        self.labels = rng.integers(0, self.n_classes, self.n_items).astype(np.int32)

    def _images(self, idx, rng) -> np.ndarray:
        base = self.protos[self.labels[idx]]
        up = np.repeat(np.repeat(base, self.image_size // 8, 1),
                       self.image_size // 8, 2)
        noise = rng.normal(
            scale=0.7, size=(len(idx), self.image_size, self.image_size, 3))
        return (up + noise).astype(np.float32)

    def epoch(self, epoch_idx: int, global_batch: int) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + 1000 + epoch_idx)
        order = rng.permutation(self.n_items)
        for i in range(0, self.n_items - global_batch + 1, global_batch):
            idx = order[i:i + global_batch]
            yield {"images": self._images(idx, rng),
                   "labels": self.labels[idx]}


def make_lm_dataset(vocab: int = 64, seq_len: int = 64, n_items: int = 4096,
                    seed: int = 0) -> MarkovLM:
    return MarkovLM(vocab=vocab, seq_len=seq_len, n_items=n_items, seed=seed)
