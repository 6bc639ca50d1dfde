"""Directed p2p topologies for DeFTA: a numpy copy of
``repro.core.topology`` (a test pins the two equal).

A topology is a boolean adjacency matrix ``adj[i, j] = True`` iff worker j is
a peer of worker i (i *receives* models from j, i.e. there is an edge
j -> i). Outdegree d_j = number of workers that receive from j = column sum.

The paper's setting: connections are directional, outdegrees independent
(Assumption 3.1); experiments use randomly selected peers with average
outdegree 4.
"""
from __future__ import annotations

import numpy as np


def ring(n: int, k: int = 1) -> np.ndarray:
    """Each worker receives from its k predecessors."""
    adj = np.zeros((n, n), bool)
    for i in range(n):
        for d in range(1, k + 1):
            adj[i, (i - d) % n] = True
    return adj


def dense(n: int) -> np.ndarray:
    """Fully connected (BrainTorrent-style; the impractical baseline)."""
    adj = np.ones((n, n), bool)
    np.fill_diagonal(adj, False)
    return adj


def random_kout(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """Every worker picks k random peers to RECEIVE from (paper's setup:
    'peers of a given worker are randomly selected', average degree k)."""
    adj = np.zeros((n, n), bool)
    for i in range(n):
        choices = rng.choice([j for j in range(n) if j != i],
                             size=min(k, n - 1), replace=False)
        adj[i, choices] = True
    return adj


def erdos(n: int, p: float, rng: np.random.Generator) -> np.ndarray:
    adj = rng.random((n, n)) < p
    np.fill_diagonal(adj, False)
    # guarantee every worker has at least one in-edge and out-edge
    for i in range(n):
        if not adj[i].any():
            # resample excluding i: j uniform over [0, n-1] \ {i}. (The
            # old draw could land ON i, and the subsequent diagonal clear
            # left row i empty — a worker with no peers at all.)
            j = int(rng.integers(0, n - 1))
            adj[i, j if j < i else j + 1] = True
        if not adj[:, i].any():
            # same uniform exclusion resample as the row repair (the old
            # remap of j==i onto (j+1)%n double-weighted worker i+1 and
            # could never pick n-1)
            j = int(rng.integers(0, n - 1))
            adj[j if j < i else j + 1, i] = True
    return adj


def make_topology(kind: str, n: int, avg_peers: int,
                  seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ring":
        return ring(n, avg_peers)
    if kind == "dense":
        return dense(n)
    if kind == "random_kout":
        return random_kout(n, avg_peers, rng)
    if kind == "erdos":
        return erdos(n, avg_peers / max(n - 1, 1), rng)
    raise ValueError(f"unknown topology {kind!r}")


def outdegrees(adj: np.ndarray) -> np.ndarray:
    """d_j = number of workers receiving from j (column sums). The paper's
    aggregation divides |D_j| by d_j. Workers nobody listens to get d=1 to
    avoid division by zero (their weight never matters)."""
    d = adj.sum(axis=0).astype(np.int64)
    return np.maximum(d, 1)


def is_strongly_connected(adj: np.ndarray) -> bool:
    """P irreducible <=> graph strongly connected (Lemma 3.2 precondition)."""
    n = adj.shape[0]
    reach = np.eye(n, dtype=bool) | adj
    for _ in range(int(np.ceil(np.log2(max(n, 2))))):
        reach = reach | (reach @ reach)
    return bool(reach.all() and reach.T.all())
