"""Classical Byzantine-robust aggregation rules, the Table 3 baselines (port
of ``repro.scenarios.robust_agg``), in plain torch.

* ``trimmed_mean`` — coordinate-wise: drop the ⌊trim·n⌋ lowest and
  highest values per coordinate (at most (n − 1) // 2 each side),
  average the rest.
* ``median``       — coordinate-wise median: the mean of ranks
  (n − 1) // 2 and n // 2.
* ``krum``         — adopt the single peer model whose summed squared
  distance to its closest ``n − f − 2`` neighbours is smallest
  (``f = ⌊trim·n⌋``), the first index on ties.

Each rule runs over every receiver's candidate set under a [W, W] mask
(the sampled peers, the receiver itself included). The reference computes
them in jnp outside any Pallas kernel, as O(W²·F) baselines beside the
production gossip mix, so they have no kernel here either: a robust round
launches no mix. Run them with ``use_dts=False`` and ``time_machine=False``,
as ``benchmarks/port_table3.py`` does (the classical one-shot rules).
"""
from __future__ import annotations

import torch

ROBUST_RULES = ("trimmed_mean", "median", "krum")


def _masked_sorted(mask, x):
    """[W, W, F] peer values per receiver, sorted along the senders with
    +inf in the invalid slots. mask: [W(recv), W(sender)]; x: [W, F]."""
    inf = torch.tensor(float("inf"), device=x.device)
    vals = torch.where(mask[:, :, None], x[None, :, :].float(), inf)
    return vals.sort(dim=1).values


def trimmed_mean_leaf(mask, x, trim: float):
    w = mask.shape[0]
    cnt = mask.sum(dim=1)                                # [W] int64
    b = torch.floor(trim * cnt.float()).long()
    # never trim the window empty (trim >= 0.5 on a small candidate set)
    b = torch.minimum(b, (cnt - 1) // 2)
    srt = _masked_sorted(mask, x)
    ranks = torch.arange(w, device=x.device)[None, :, None]
    keep = (ranks >= b[:, None, None]) & (ranks < (cnt - b)[:, None, None])
    total = torch.where(keep, srt, torch.zeros_like(srt)).sum(dim=1)
    n_kept = (cnt - 2 * b).clamp_min(1)
    return total / n_kept[:, None].float()


def median_leaf(mask, x):
    cnt = mask.sum(dim=1)
    srt = _masked_sorted(mask, x)
    f = x.shape[1]
    take = lambda i: srt.gather(1, i[:, None, None].expand(-1, 1, f))[:, 0]
    return 0.5 * (take((cnt - 1) // 2) + take(cnt // 2))


def krum_select(mask, stacked: dict, trim: float):
    """[W] index of the Krum-selected sender per receiver."""
    w = mask.shape[0]
    flat = torch.cat([stacked[k].reshape(w, -1).float()
                      for k in sorted(stacked)], dim=1)
    sq = (flat * flat).sum(dim=1)
    d2 = (sq[:, None] + sq[None, :] - 2.0 * (flat @ flat.T)).clamp_min(0.0)
    eye = torch.eye(w, dtype=torch.bool, device=mask.device)
    inf = torch.tensor(float("inf"), device=flat.device)
    # [recv, candidate j, peer k]: distances within the receiver's set
    dm = torch.where(mask[:, None, :] & mask[:, :, None] & ~eye[None],
                     d2[None, :, :], inf)
    srt = dm.sort(dim=2).values
    cnt = mask.sum(dim=1)
    f = torch.floor(trim * cnt.float()).long()
    m = (cnt - f - 2).clamp_min(1)                           # neighbours
    ranks = torch.arange(w, device=flat.device)[None, None, :]
    score = torch.where(ranks < m[:, None, None], srt,
                        torch.zeros_like(srt)).sum(dim=2)
    score = torch.where(mask, score, inf)
    # argmin's first index on ties, as jnp.argmin
    sel = torch.argmin(score, dim=1)
    # a receiver whose candidate set is only itself has no finite score:
    # it keeps its own model
    return torch.where(torch.isfinite(score.min(dim=1).values), sel,
                       torch.arange(w, device=flat.device))


def robust_mix(rule: str, mask, stacked: dict, *, trim: float = 0.25) -> dict:
    """Aggregate the stacked worker dict under ``mask`` [W, W] (bool,
    ``mask[i, j]``: receiver i considers sender j; self-edges expected).
    Every row must have >= 1 True. Returns the stacked aggregate."""
    if rule == "krum":
        sel = krum_select(mask, stacked, trim)
        return {k: x[sel] for k, x in stacked.items()}
    if rule not in ROBUST_RULES:
        raise ValueError(f"unknown robust rule {rule!r} "
                         f"(one of {ROBUST_RULES})")
    out = {}
    for k, x in stacked.items():
        flat = x.reshape(x.shape[0], -1)
        if rule == "trimmed_mean":
            agg = trimmed_mean_leaf(mask, flat, trim)
        else:
            agg = median_leaf(mask, flat)
        out[k] = agg.reshape(x.shape).to(x.dtype)
    return out
