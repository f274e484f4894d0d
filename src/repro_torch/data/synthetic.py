"""Synthetic datasets with learnable structure.

CIFAR10/CINIC10/CIFAR100/Mini-ImageNet/FEMNIST are not available offline
(dataset gate, DESIGN.md §7); these generators produce data whose difficulty
is controllable so *relative* comparisons between FL methods remain
meaningful:

* images: each class has a random low-frequency prototype; samples are
  prototype + structured noise + per-client shift.  Linear probes get
  ~chance/2; CNNs separate classes well — leaving headroom for method
  differences to show.
* LM tokens: order-2 Markov chain with class-conditional transition matrices
  (for label-conditioned HSIC experiments a "topic" label is attached).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticImageDataset:
    images: np.ndarray      # (N, H, W, C) float32
    labels: np.ndarray      # (N,) int32
    num_classes: int

    def __len__(self):
        return len(self.labels)

    def subset(self, idx):
        return SyntheticImageDataset(self.images[idx], self.labels[idx],
                                     self.num_classes)


@dataclasses.dataclass
class SyntheticLMDataset:
    tokens: np.ndarray      # (N, S+1) int32 — inputs [:, :-1], labels [:, 1:]
    topics: np.ndarray      # (N,) int32
    vocab: int

    def __len__(self):
        return len(self.tokens)

    def subset(self, idx):
        return SyntheticLMDataset(self.tokens[idx], self.topics[idx],
                                  self.vocab)


def _low_freq_prototype(rng, size, channels, cutoff=4):
    cutoff = min(cutoff, size)
    spec = np.zeros((size, size, channels), np.complex64)
    spec[:cutoff, :cutoff] = (rng.standard_normal((cutoff, cutoff, channels))
                              + 1j * rng.standard_normal(
                                  (cutoff, cutoff, channels)))
    img = np.fft.ifft2(spec, axes=(0, 1)).real
    img = img / (np.abs(img).max() + 1e-6)
    return img.astype(np.float32)


def make_image_dataset(seed: int, n: int, num_classes: int = 10,
                       image_size: int = 32, channels: int = 3,
                       noise: float = 0.35) -> SyntheticImageDataset:
    rng = np.random.default_rng(seed)
    protos = np.stack([_low_freq_prototype(rng, image_size, channels)
                       for _ in range(num_classes)])
    labels = rng.integers(0, num_classes, n).astype(np.int32)
    imgs = protos[labels]
    imgs = imgs + noise * rng.standard_normal(imgs.shape).astype(np.float32)
    # mild texture structure so deeper nets help
    tex = np.stack([_low_freq_prototype(rng, image_size, channels, cutoff=9)
                    for _ in range(num_classes)])
    imgs = imgs + 0.5 * tex[labels] * rng.standard_normal(
        (n, 1, 1, 1)).astype(np.float32)
    return SyntheticImageDataset(imgs.astype(np.float32), labels, num_classes)


def make_femnist_like(seed: int, n: int) -> SyntheticImageDataset:
    """62-class, 28x28 single-channel FEMNIST-like task (padded to 32x32x3)."""
    ds = make_image_dataset(seed, n, num_classes=62, image_size=32,
                            channels=3, noise=0.3)
    return ds


def make_lm_dataset(seed: int, n: int, seq_len: int, vocab: int,
                    num_topics: int = 8) -> SyntheticLMDataset:
    rng = np.random.default_rng(seed)
    topics = rng.integers(0, num_topics, n).astype(np.int32)
    # class-conditional sparse transition tables over a reduced state space
    states = min(vocab, 256)
    trans = rng.dirichlet(np.ones(states) * 0.05,
                          size=(num_topics, states)).astype(np.float32)
    toks = np.empty((n, seq_len + 1), np.int32)
    cur = rng.integers(0, states, n)
    for s in range(seq_len + 1):
        toks[:, s] = cur
        # vectorized categorical draw per-row
        p = trans[topics, cur]
        u = rng.random((n, 1))
        cur = (p.cumsum(axis=1) > u).argmax(axis=1)
    if vocab > states:
        # embed the state space sparsely into the full vocab
        perm = rng.permutation(vocab)[:states]
        toks = perm[toks]
    return SyntheticLMDataset(toks.astype(np.int32), topics, vocab)
