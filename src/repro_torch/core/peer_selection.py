"""Peer-selection strategies (paper §5.4): DTS cuts connections between
workers whose data distributions differ too much; the paper's stated fix is
"a peer selection strategy that selects workers with similar local dataset
features as peers". This module implements it (beyond-paper: the paper
leaves it as future work).

``similarity_topology`` builds the directed graph by connecting each worker
to the k peers with the closest label distribution (cosine similarity of
label histograms) — standing in for "prior knowledge"; the exhaustive-trial
alternative is exactly what DTS already does online.
"""
from __future__ import annotations

import numpy as np


def label_histograms(y: np.ndarray, mask: np.ndarray,
                     num_classes: int) -> np.ndarray:
    """y: [W, N]; mask: [W, N] -> [W, C] normalized label histograms."""
    w = y.shape[0]
    out = np.zeros((w, num_classes))
    for i in range(w):
        valid = y[i][mask[i] > 0]
        if len(valid):
            out[i] = np.bincount(valid, minlength=num_classes)[:num_classes]
            out[i] /= max(out[i].sum(), 1)
    return out


def similarity_topology(hists: np.ndarray, k: int,
                        rng: np.random.Generator | None = None,
                        explore: float = 0.0) -> np.ndarray:
    """adj[i, j]=True iff j is among i's top-k most similar peers.
    ``explore`` swaps that fraction of edges for random ones (keeps the
    graph irreducible when clusters are disjoint)."""
    w = len(hists)
    norm = np.linalg.norm(hists, axis=1, keepdims=True) + 1e-12
    sim = (hists / norm) @ (hists / norm).T
    np.fill_diagonal(sim, -np.inf)
    adj = np.zeros((w, w), bool)
    for i in range(w):
        top = np.argsort(sim[i])[::-1][:k]
        adj[i, top] = True
    if explore and rng is not None:
        for i in range(w):
            if rng.random() < explore:
                on = np.where(adj[i])[0]
                off = [j for j in range(w) if j != i and not adj[i, j]]
                if len(on) and len(off):
                    adj[i, rng.choice(on)] = False
                    adj[i, rng.choice(off)] = True
    return adj
