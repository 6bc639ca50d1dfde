"""The attack zoo (port of ``repro.scenarios.attacks``): transforms of
what malicious workers *send*, over dicts of worker-stacked tensors.

Model attacks replace an attacker's outgoing model after local training
(``noise``, ``sign_flip``, ``scaling``, ``alie``, and the adaptive
``dts_dodge``, ``theta_aware`` and ``alie_decor``); ``label_flip`` acts on
the data (``flip_labels``). ``poison_sends`` applies every kind present,
each selected per worker by the compiled scenario's ``attack_kind`` and
this epoch's ``attack_on``. The reference's docstrings describe each
attack; the numerics here are the same:

* ``alie`` and ``alie_decor`` take the population standard deviation
  (``correction=0``, as ``jnp.std``) over all W rows, dead workers and
  other attackers included.
* ``dts_dodge`` takes the median of W norms as ``jnp.median`` does: the
  mean of the two middle values for an even W.
* The random kinds (``noise``, ``alie_decor``) take one N(0, 1) tensor per
  leaf, ``draws[name]``, from the round's ``rng.RoundDraws`` (``noise`` on
  the static path, ``kind_noise[kind]`` under a scenario); the others take
  ``None``.
"""
from __future__ import annotations

import torch

from repro_torch.scenarios.compile import ATTACK_CODE

LABEL_FLIP_CODE = ATTACK_CODE["label_flip"]
DECOR_FRAC = 0.5         # alie_decor noise std as a fraction of stack std
DODGE_MARGIN = 0.9       # dts_dodge ships at 90% of the observed margin
THETA_FLOOR = 0.5        # theta_aware attacks while θ ≥ floor × uniform


def tree_select(flag, a: dict, b: dict) -> dict:
    """Per-worker select: flag [W] bool; a/b dicts of stacked [W, ...]."""
    out = {}
    for name, y in b.items():
        x = a[name]
        f = flag.reshape((-1,) + (1,) * (x.ndim - 1))
        out[name] = torch.where(f, x.to(y.dtype), y)
    return out


def _per_worker(scale, like):
    """Broadcast a [W] scale against a stacked [W, ...] leaf."""
    return scale.reshape((-1,) + (1,) * (like.ndim - 1)).to(like.dtype)


def noise(draws: dict, agg: dict, trained: dict, scale) -> dict:
    """agg + scale·N(0,1), one full [W, ...] standard-normal draw per leaf
    (``draws[name]``)."""
    del trained
    return {name: x + _per_worker(scale, x) * draws[name]
            for name, x in agg.items()}


def sign_flip(draws, agg: dict, trained: dict, scale) -> dict:
    """agg − scale·(trained − agg): the inverted local update."""
    del draws
    return {k: a - _per_worker(scale, a) * (trained[k].to(a.dtype) - a)
            for k, a in agg.items()}


def scaling(draws, agg: dict, trained: dict, scale) -> dict:
    """agg + scale·(trained − agg): the boosted local update."""
    del draws
    return {k: a + _per_worker(scale, a) * (trained[k].to(a.dtype) - a)
            for k, a in agg.items()}


def _pop_std(t):
    return t.std(dim=0, keepdim=True, correction=0)


def alie(draws, agg: dict, trained: dict, scale) -> dict:
    """All colluders emit the same mean − z·std of the worker stack."""
    del draws, agg
    out = {}
    for k, t in trained.items():
        row = t.mean(dim=0, keepdim=True) - _per_worker(scale, t) * _pop_std(t)
        out[k] = row.expand(t.shape).to(t.dtype)
    return out


def alie_decor(draws: dict, agg: dict, trained: dict, scale) -> dict:
    """ALIE plus per-attacker decorrelation noise: the shared payload plus
    an independent ``DECOR_FRAC·std·N(0,1)`` draw per attacker
    (``draws[name]``)."""
    base = alie(None, agg, trained, scale)
    return {k: b + DECOR_FRAC * _pop_std(trained[k].to(b.dtype)) * draws[k]
            for k, b in base.items()}


def _update_norms(agg: dict, trained: dict):
    """Per-worker L2 norm of the full-tree local update trained − agg, the
    leaves summed in sorted order (the reference's tree order)."""
    sq = None
    for k in sorted(agg):
        d = trained[k].float() - agg[k].float()
        s = (d * d).reshape(d.shape[0], -1).sum(dim=1)
        sq = s if sq is None else sq + s
    return sq.sqrt()


def _median(x):
    """``jnp.median`` of a 1-D tensor: the mean of the two middle values
    when the count is even (``torch.median`` returns the lower one)."""
    srt = x.sort().values
    n = srt.shape[0]
    return 0.5 * (srt[(n - 1) // 2] + srt[n // 2])


def dts_dodge(draws, agg: dict, trained: dict, scale) -> dict:
    """Norm-capped inverted update: sign_flip rescaled to ``min(‖delta‖,
    scale·DODGE_MARGIN·median ‖delta‖)``."""
    del draws
    n = _update_norms(agg, trained)                       # [W]
    cap = scale * DODGE_MARGIN * _median(n)
    factor = torch.where(n > 0, torch.clamp(cap / (n + 1e-12), max=1.0),
                         torch.zeros_like(n))
    return {k: a - _per_worker(factor, a) * (trained[k].to(a.dtype) - a)
            for k, a in agg.items()}


def theta_aware(draws, agg: dict, trained: dict, scale, theta=None) -> dict:
    """sign_flip while the attacker's mean observed sampling weight θ,
    relative to each listener's uniform weight, is ≥ ``THETA_FLOOR``; the
    honest trained model otherwise. ``theta=None`` (no DTS running) →
    plain sign_flip."""
    poison = sign_flip(draws, agg, trained, scale)
    if theta is None:
        return poison
    on = theta > 0
    deg = on.sum(dim=1, keepdim=True)                     # [W, 1] peers/rcv
    rel = torch.where(on, theta * deg, torch.zeros_like(theta))
    listeners = on.sum(dim=0)                             # [W] per sender
    rel_mean = rel.sum(dim=0) / listeners.clamp_min(1)
    return tree_select(rel_mean >= THETA_FLOOR, poison, trained)


# model attacks only — label_flip acts on the data, not the payload
MODEL_ATTACKS = {"noise": noise, "sign_flip": sign_flip, "scaling": scaling,
                 "alie": alie, "dts_dodge": dts_dodge,
                 "theta_aware": theta_aware, "alie_decor": alie_decor}

# attacks that additionally observe the round's θ matrix
THETA_ATTACKS = {"theta_aware"}

# attacks that consume one N(0, 1) draw per leaf
RANDOM_ATTACKS = ("noise", "alie_decor")


def poison_sends(kind_noise, kinds_present, attack_kind, attack_scale,
                 attack_on, agg: dict, trained: dict, theta=None) -> dict:
    """Replace attackers' outgoing models. Every kind present is computed
    from the same ``trained`` stack, in ``ATTACK_KINDS`` order, and selected
    where ``attack_kind == code ∧ attack_on``. ``kind_noise``: {kind:
    {leaf: N(0, 1)}} for the kinds in ``RANDOM_ATTACKS``; ``theta``: the
    round's [W, W] DTS sampling weights (None when DTS is off). Returns
    the stacked dict that goes on the wire."""
    sends = trained
    for kind in kinds_present:
        if kind not in MODEL_ATTACKS:
            continue                      # data attacks handled upstream
        code = ATTACK_CODE[kind]
        kw = {"theta": theta} if kind in THETA_ATTACKS else {}
        draws = kind_noise[kind] if kind in RANDOM_ATTACKS else None
        poisoned = MODEL_ATTACKS[kind](draws, agg, trained, attack_scale,
                                       **kw)
        sends = tree_select((attack_kind == code) & attack_on, poisoned,
                            sends)
    return sends


def flip_labels(y, active, num_classes: int):
    """Label-flip data poisoning: y → (C−1) − y for workers with
    ``active`` True. y: [W, N] int; active: [W] bool."""
    return torch.where(active[:, None], (num_classes - 1) - y, y)
