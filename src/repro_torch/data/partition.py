"""Non-i.i.d. federated partitioning: numpy copies of
``repro.data.partition``'s ``dirichlet_partition`` and ``shard_partition``
(tests pin them equal).
"""
from __future__ import annotations

import numpy as np


def dirichlet_partition(labels: np.ndarray, num_workers: int, alpha: float,
                        rng: np.random.Generator, min_size: int = 2,
                        max_tries: int = 5):
    """Returns list of index arrays, one per worker: a per-class
    Dirichlet(α) split (smaller α = more non-iid).

    Retries are BOUNDED: after ``max_tries`` draws the best attempt is
    topped up deterministically — starved workers take indices from the
    largest ones. Runs that satisfy ``min_size`` on a retry keep the exact
    historical output.
    """
    classes = np.unique(labels)
    best, best_min = None, -1
    for _ in range(max_tries):
        idx_per_worker = [[] for _ in range(num_workers)]
        for c in classes:
            idx_c = np.where(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet([alpha] * num_workers)
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for w, part in enumerate(np.split(idx_c, cuts)):
                idx_per_worker[w].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_worker]
        if min(sizes) >= min_size:
            return [np.asarray(sorted(ix)) for ix in idx_per_worker]
        if min(sizes) > best_min:
            best, best_min = idx_per_worker, min(sizes)
    # top up starved workers from the richest ones (stable, rng-free)
    sizes = np.asarray([len(ix) for ix in best])
    for w in np.flatnonzero(sizes < min_size):
        while sizes[w] < min_size:
            donor = int(np.argmax(sizes))
            best[w].append(best[donor].pop())
            sizes[w] += 1
            sizes[donor] -= 1
    return [np.asarray(sorted(ix)) for ix in best]


def shard_partition(labels: np.ndarray, num_workers: int,
                    shards_per_worker: int, rng: np.random.Generator):
    order = np.argsort(labels, kind="stable")
    num_shards = num_workers * shards_per_worker
    shards = np.array_split(order, num_shards)
    assign = rng.permutation(num_shards)
    out = []
    for w in range(num_workers):
        ids = assign[w * shards_per_worker:(w + 1) * shards_per_worker]
        out.append(np.concatenate([shards[s] for s in ids]))
    return out
