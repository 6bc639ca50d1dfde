"""numpy copy of ``repro.data.synthetic`` (a test pins the two equal).

Synthetic datasets standing in for the paper's MNIST/FMNIST/EMNIST/
Cifar/Wikitext (no network access in this container). Each generator yields
a *learnable but non-trivial* task so relative comparisons (CFL vs DeFTA vs
DeFL, malicious vs clean) are meaningful.
"""
from __future__ import annotations

from typing import List

import numpy as np


def make_classification(n: int, dim: int, num_classes: int,
                        rng: np.random.Generator, noise: float = 0.6):
    """Gaussian class clusters on the unit sphere + noise."""
    means = rng.normal(size=(num_classes, dim))
    means /= np.linalg.norm(means, axis=1, keepdims=True)
    y = rng.integers(0, num_classes, size=n)
    x = means[y] * 2.0 + noise * rng.normal(size=(n, dim))
    return x.astype(np.float32), y.astype(np.int32)


def make_image_classification(n: int, hw: int, channels: int,
                              num_classes: int, rng: np.random.Generator,
                              noise: float = 0.5):
    """Class-specific low-frequency templates + noise ("synthetic MNIST")."""
    yy, xx = np.meshgrid(np.linspace(-1, 1, hw), np.linspace(-1, 1, hw))
    templates = []
    for c in range(num_classes):
        fx, fy = rng.uniform(0.5, 3.0, 2)
        ph = rng.uniform(0, 2 * np.pi, 2)
        t = np.sin(fx * np.pi * xx + ph[0]) * np.cos(fy * np.pi * yy + ph[1])
        templates.append(np.stack([t] * channels, -1))
    templates = np.stack(templates)
    y = rng.integers(0, num_classes, size=n)
    x = templates[y] + noise * rng.normal(size=(n, hw, hw, channels))
    return x.reshape(n, -1).astype(np.float32), y.astype(np.int32)


def make_lm_stream(n_seqs: int, seq: int, vocab: int,
                   rng: np.random.Generator, order: int = 1):
    """Markov-chain token sequences (learnable bigram structure)."""
    trans = rng.dirichlet([0.1] * vocab, size=vocab)
    seqs = np.empty((n_seqs, seq), np.int32)
    state = rng.integers(0, vocab, size=n_seqs)
    for t in range(seq):
        seqs[:, t] = state
        u = rng.random((n_seqs, 1))
        state = (trans[state].cumsum(axis=1) > u).argmax(axis=1)
    return seqs


def federated_dataset(kind: str, num_workers: int, rng: np.random.Generator,
                      *, n_per_worker: int = 200, alpha: float = 0.5,
                      num_classes: int = 10, dim: int = 32, hw: int = 14,
                      vocab: int = 64, seq: int = 16,
                      size_spread: float = 0.5):
    """Build a non-iid federated dataset.

    Returns dict with per-worker padded arrays:
      x [W, Nmax, ...], y [W, Nmax], mask [W, Nmax], sizes [W],
      test_x, test_y (global iid test set).
    Worker dataset sizes vary by ±size_spread (Assumption 3.1's |D_i|
    binomial variation) — this is what makes defta vs defl differ.
    """
    from repro_torch.data.partition import dirichlet_partition

    n_total = n_per_worker * num_workers * 2
    if kind == "vector":
        x, y = make_classification(n_total, dim, num_classes, rng)
    elif kind == "image":
        x, y = make_image_classification(n_total, hw, 1, num_classes, rng)
    elif kind == "lm":
        seqs = make_lm_stream(n_total, seq, vocab, rng)
        x, y = seqs, np.zeros(n_total, np.int32)
    else:
        raise ValueError(kind)

    if kind == "lm":
        parts = np.array_split(rng.permutation(n_total // 2), num_workers)
    else:
        parts = dirichlet_partition(y[:n_total // 2], num_workers, alpha, rng)

    # heterogeneous |D_i|
    sizes = []
    for w in range(num_workers):
        cap = int(n_per_worker * (1 + size_spread * (2 * rng.random() - 1)))
        sizes.append(max(8, min(cap, len(parts[w]))))
    nmax = max(sizes)

    xw = np.zeros((num_workers, nmax) + x.shape[1:], x.dtype)
    yw = np.zeros((num_workers, nmax), np.int32)
    mask = np.zeros((num_workers, nmax), np.float32)
    for w in range(num_workers):
        ix = parts[w][:sizes[w]]
        xw[w, :len(ix)] = x[ix]
        yw[w, :len(ix)] = y[ix]
        mask[w, :len(ix)] = 1.0

    test_slice = slice(n_total // 2, n_total // 2 + 2000)
    return {
        "x": xw, "y": yw, "mask": mask,
        "sizes": np.asarray(sizes, np.int64),
        "test_x": x[test_slice], "test_y": y[test_slice],
    }
