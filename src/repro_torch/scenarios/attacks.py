"""What malicious workers send (port of the part of
``repro.scenarios.attacks`` the static sync round runs): ``tree_select``
and the paper's ``noise`` attack. The rest of the zoo is a later item of
the port (ROADMAP.md, queue 1a, item 2)."""
from __future__ import annotations

import torch


def tree_select(flag, a: dict, b: dict) -> dict:
    """Per-worker select: flag [W] bool; a/b dicts of stacked [W, ...]."""
    out = {}
    for name, y in b.items():
        x = a[name]
        f = flag.reshape((-1,) + (1,) * (x.ndim - 1))
        out[name] = torch.where(f, x.to(y.dtype), y)
    return out


def noise(draws: dict, agg: dict, trained: dict, scale) -> dict:
    """agg + scale·N(0,1), one full [W, ...] standard-normal draw per leaf
    (``draws[name]``, from the round's ``rng.RoundDraws.noise``)."""
    del trained
    out = {}
    for name, x in agg.items():
        s = scale.reshape((-1,) + (1,) * (x.ndim - 1)).to(x.dtype)
        out[name] = x + s * draws[name]
    return out
