"""Model-aggregation formulas and their Markov analysis (paper §3.2).

The gossip round is ``W <- P W`` over stacked worker params. Three weight
schemes for ``p_{i,j}``:

* ``defta``  — outdegree-corrected:  p_{i,j} = (|D_j|/d_j) / Σ_k (|D_k|/d_k)
               (Corollary 3.3.2 — unbiased w.r.t. FedAvg's global average)
* ``defl``   — naive dataset-size:   p_{i,j} = |D_j| / Σ_k |D_k|
               (Corollary 3.3.1 — biased; ≈ prior decentralized FL work)
* ``uniform``— p_{i,j} = 1/|N_i| (plain gossip averaging)

All sums run over the *effective* peer set N_i ∪ {i}: every worker keeps a
self-edge (it trivially "receives" its own model), and outdegrees count that
self-loop, so d_j = 1 + (# receivers of j).

These are the host-side (static, np.float64) references. The engine's
``transport`` stage builds its traced per-round P either from the same
weights baked at build time (static topology) or via
``core.gossip.dynamic_mixing_matrix`` (the traced re-derivation of the
same formulas under per-epoch churn/link masks and time-varying
topologies); ``tests/test_engine.py`` pins the two against each other.
"""
from __future__ import annotations

import numpy as np


def _with_self(adj: np.ndarray) -> np.ndarray:
    adj = adj.copy()
    np.fill_diagonal(adj, True)
    return adj


def mixing_matrix(adj: np.ndarray, sizes: np.ndarray,
                  scheme: str = "defta") -> np.ndarray:
    """Row-stochastic P [W, W]: P[i, j] = weight of j's model in i's
    aggregation. ``adj[i, j]``: i receives from j. Self-edges added."""
    a = _with_self(adj).astype(np.float64)
    sizes = np.asarray(sizes, np.float64)
    d = a.sum(axis=0)                       # outdegree incl. self-loop
    if scheme == "defta":
        w = sizes / d
    elif scheme == "defl":
        w = sizes
    elif scheme == "uniform":
        w = np.ones_like(sizes)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    P = a * w[None, :]
    return P / P.sum(axis=1, keepdims=True)


def sampled_mixing_matrix(adj: np.ndarray, sizes: np.ndarray,
                          sampled: np.ndarray, scheme: str = "defta"):
    """Like ``mixing_matrix`` but restricted to sampled peers S_i (plus the
    self edge). ``sampled[i, j]``: j ∈ S_i^t."""
    mask = (sampled & adj)
    return mixing_matrix_from_mask(_with_self(mask), adj, sizes, scheme)


def mixing_matrix_from_mask(mask, adj, sizes, scheme="defta"):
    sizes = np.asarray(sizes, np.float64)
    d = _with_self(adj).sum(axis=0).astype(np.float64)   # full outdegrees
    if scheme == "defta":
        w = sizes / d
    elif scheme == "defl":
        w = sizes
    else:
        w = np.ones_like(sizes)
    P = mask.astype(np.float64) * w[None, :]
    return P / np.maximum(P.sum(axis=1, keepdims=True), 1e-12)


# ---------------------------------------------------------------------------
# Markov analysis (Assumption 3.2 / Lemma 3.2 / Theorem 3.3)
# ---------------------------------------------------------------------------

def fedavg_pi(sizes: np.ndarray) -> np.ndarray:
    sizes = np.asarray(sizes, np.float64)
    return sizes / sizes.sum()


def stationary(P: np.ndarray, iters: int = 10_000, tol: float = 1e-12):
    """lim P^t (row-wise stationary distribution if ergodic)."""
    Q = P.copy()
    for _ in range(iters):
        Q2 = Q @ Q
        if np.abs(Q2 - Q).max() < tol:
            return Q2
        Q = Q2
    return Q


def aggregation_bias(adj: np.ndarray, sizes: np.ndarray,
                     scheme: str) -> float:
    """|| lim Ω^t − π_fedavg ||_∞ — how far the long-run model composition
    is from FedAvg's dataset-proportional mixture (Theorem 3.3's quantity).
    Ω^0 = I so lim Ω^t = lim P^t."""
    P = mixing_matrix(adj, sizes, scheme)
    pi = stationary(P)
    return float(np.abs(pi - fedavg_pi(sizes)[None, :]).max())


def theorem_3_3_residual(adj: np.ndarray, sizes: np.ndarray,
                         scheme: str) -> np.ndarray:
    """Per-column residual of Theorem 3.3's condition
    Σ_{i∈N_j} (|D_i|/|D_j|) p_{i,j} − 1 (0 ⇔ unbiased)."""
    P = mixing_matrix(adj, sizes, scheme)
    a = _with_self(adj)
    sizes = np.asarray(sizes, np.float64)
    resid = np.empty(adj.shape[0])
    for j in range(adj.shape[0]):
        receivers = np.where(a[:, j])[0]
        resid[j] = sum(sizes[i] / sizes[j] * P[i, j] for i in receivers) - 1.0
    return resid
