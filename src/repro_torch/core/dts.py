"""Decentralized Trust System (port of ``repro.core.dts``, paper §3.3,
Algorithm 3).

Worker i keeps a confidence c_{i→j} per peer, samples peers by
θ_i = softmax(cRELU(c_i)) with a Gumbel top-k, and after each round
updates c_i ← c_i − m_i ∘ p_i · signal. The time machine restores the
backup when a round's aggregate is damaged (``is_damaged``).

The signal is the loss delta (the paper's, ``dts_signal="loss"``), or a
fusion with two more channels scored on each peer's local-update delta:

* update geometry (DTS v2, ``geom_scores``): cosine distance, clipped
  |log| norm ratio and sign disagreement against a self-anchored
  trust-weighted median direction, centred over the receiver's peers;
* cross-round correlation (DTS v3, ``colluder_scores``): a ring buffer of
  count-sketch sign codes of the deltas (``update_sketch``), whose
  pairwise correlation, calibrated by median + MAD and clustered by one
  power-iteration step, singles out colluders that hide inside the honest
  variance in any one round.

Under an aggregate-only secure-aggregation wire (``secagg_mode=
"masked_geom"``) a receiver sees no per-peer delta, and ``masked_geom_trust``
scores the pooled aggregate-minus-own-contribution direction instead.

The reference computes all of it in plain ``jnp`` (no Pallas kernel), so
the port is plain torch. The count-sketch plan is drawn with numpy
(``_sketch_plan``, a verbatim copy) and applied as a fixed dense [D, S]
matrix, a product whose order does not vary between runs where the
reference's ``segment_sum`` would be an atomic scatter on the card.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

DAMAGE_PENALTY = 1e3       # finite stand-in for the paper's +inf loss_trust
EXPLOSION_FACTOR = 10.0    # loss > factor * best  => damaged


def crelu(x, slope: float = 0.2):
    """Paper Eq. 13 (piecewise: identity for x<=0, gentle slope above)."""
    return torch.where(x <= 0, x, slope * x)


def sample_weights(conf, peer_mask, slope: float = 0.2):
    """θ_i = softmax(cRELU(c_i)) over actual peers. conf: [..., W]; mask:
    [..., W] bool. Non-peers get 0; a row with no peers at all returns the
    all-zero row (not softmax's NaN)."""
    z = crelu(conf, slope)
    z = torch.where(peer_mask, z, torch.full_like(z, float("-inf")))
    t = torch.softmax(z, dim=-1)
    return torch.where(peer_mask.any(dim=-1, keepdim=True), t,
                       torch.zeros_like(t))


def topk_mask(score, k: int):
    """Boolean mask of the (≤ k) largest FINITE entries of ``score`` along
    the last axis. Ties go to the lower index, as with ``jax.lax.top_k``
    (``torch.topk`` promises no order on ties, so a stable descending sort
    breaks them explicitly); −inf entries are never selected."""
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    hit = torch.zeros_like(score, dtype=torch.bool)
    return hit.scatter(-1, idx, torch.isfinite(vals))


def sample_peers(gumbel, theta, num_sampled: int):
    """Gumbel top-k sample without replacement by weights θ. theta: [..., W]
    and its Gumbel draws ``gumbel`` of the same shape; returns the boolean
    mask with ≤ num_sampled True entries per row (fewer only if the peer
    set is smaller)."""
    score = torch.where(theta > 0, torch.log(theta + 1e-20) + gumbel,
                        torch.full_like(theta, float("-inf")))
    k = min(num_sampled, theta.shape[-1])
    return topk_mask(score, k) & (theta > 0)


def is_damaged(loss, best_loss):
    return ~torch.isfinite(loss) | (loss > EXPLOSION_FACTOR *
                                    best_loss.clamp_min(1e-8) + 10.0)


# ---------------------------------------------------------------------------
# Geometric trust signals (DTS v2)
# ---------------------------------------------------------------------------

GEOM_NORM_CLIP = 4.0       # |log norm-ratio| saturation (e^4 ≈ 55x outlier)


def flatten_stacked(stacked):
    """Flatten a stacked [W, ...] parameter dict to one [W, D] fp32 matrix,
    the leaves in ``jax.tree.leaves`` order: keys sorted (the MLP's ``b1,
    b2, w1, w2``, not its insertion order). The order places each
    coordinate along D, and the count-sketch plan hashes coordinates by
    position."""
    return torch.cat([stacked[k].reshape(stacked[k].shape[0], -1).float()
                      for k in sorted(stacked)], dim=1)


def weighted_median(vals, wts):
    """Per-receiver coordinate-wise weighted median of a SHARED stack.

    vals: [P, D], one stack of peer values shared by every receiver; wts:
    [R, P] per-receiver weights (>= 0, zero = excluded). Returns [R, D]:
    per (receiver, coordinate) the smallest value whose cumulative weight
    reaches half the receiver's total; an all-zero weight row returns 0.
    The values are sorted once (stably, as ``jnp.argsort``); each receiver
    adds a weight gather and a cumsum."""
    order = torch.argsort(vals, dim=0, stable=True)        # [P, D]
    sv = torch.take_along_dim(vals, order, dim=0)           # [P, D]
    sw = wts[:, order]                                      # [R, P, D]
    cw = torch.cumsum(sw, dim=1)
    total = wts.sum(dim=1)
    # the first index where the cumulative weight reaches half (argmax on
    # an integer tensor: torch's argmax takes no bool, and returns the
    # first maximum, as JAX does)
    pick = torch.argmax((cw >= total[:, None, None] * 0.5).to(torch.int32),
                        dim=1)                              # [R, D]
    med = sv[pick, torch.arange(vals.shape[1], device=vals.device)]
    return torch.where(total[:, None] > 0, med, torch.zeros_like(med))


def _masked_weights(mask, weights, eye):
    """The receiver-peer weights of the scoring functions: ``weights``
    (uniform when None) on ``mask`` minus the diagonal, 0 elsewhere,
    clamped at 0. Returns (mask without the diagonal, weights)."""
    mask = mask & ~eye
    src = weights if weights is not None else torch.ones(
        mask.shape, device=mask.device)
    wts = torch.where(mask, src, torch.zeros_like(src)).clamp_min(0.0)
    return mask, wts


def _centre(score, mask, wts, eps):
    """Each row's score minus its ``wts``-weighted mean over the peer set;
    0 off the mask."""
    tot = wts.sum(1, keepdim=True)
    mean_s = (wts * score).sum(1, keepdim=True) / tot.clamp_min(eps)
    return torch.where(mask, score - mean_s, torch.zeros_like(score))


def geom_scores(deltas, mask, weights=None, *,
                norm_clip: float = GEOM_NORM_CLIP, eps: float = 1e-12):
    """Update-geometry suspicion scores per (receiver i, peer j).

    deltas: [W, D] per-peer local-update deltas (``trained − start``);
    mask: [W, W] bool, i listens to j (the diagonal is ignored); weights:
    [W, W] trust weights (θ; uniform over the mask when None).

    The reference direction r_i is the weighted coordinate-wise median over
    i's peers and i itself, with i carrying half the mass; at exactly half
    the lower weighted median is ``min(self, max over positive-weight
    peers)`` per coordinate, computed in that closed form. Each peer scores
    cosine distance to r_i + clipped |log| norm ratio against the
    self-anchored weighted-median norm + sign-disagreement rate against
    r_i, centred over the receiver's peers under ``weights``. Returns [W,
    W]; rows with no peers are all-zero."""
    w = deltas.shape[0]
    eye = torch.eye(w, dtype=torch.bool, device=deltas.device)
    mask, wts = _masked_weights(mask, weights, eye)
    # self-anchor: the receiver's own delta carries the whole peer mass
    wts_ref = wts + eye * wts.sum(1, keepdim=True)
    neg_inf = torch.full((), float("-inf"), device=deltas.device)
    peer_max = torch.where(wts[:, :, None] > 0, deltas[None, :, :],
                           neg_inf).amax(dim=1)
    ref = torch.minimum(deltas, peer_max)      # row r's self is deltas[r]
    ref = torch.where(torch.isfinite(ref), ref, torch.zeros_like(ref))
    dn = torch.sqrt((deltas * deltas).sum(-1))              # [P]
    rn = torch.sqrt((ref * ref).sum(-1))                    # [R]

    cos = (ref @ deltas.T) / (dn[None, :] * rn[:, None] + eps)
    cos_score = 1.0 - cos                                   # [0, 2]

    med_n = weighted_median(dn[:, None], wts_ref)[:, 0]     # [R]
    norm_score = torch.abs(torch.log((dn[None, :] + eps)
                                     / (med_n[:, None] + eps)))
    norm_score = norm_score.clamp(0.0, norm_clip) / norm_clip

    # sign agreement by a sign product: same-sign minus differing-sign
    # coordinates (exact zeros count as half-agree)
    agree = 0.5 * (1.0 + (torch.sign(ref) @ torch.sign(deltas).T)
                   / deltas.shape[1])
    sign_score = 1.0 - agree                                # [0, 1]
    return _centre(cos_score + norm_score + sign_score, mask, wts, eps)


# ---------------------------------------------------------------------------
# Cross-round correlation trust (DTS v3)
# ---------------------------------------------------------------------------

SKETCH_ROUNDS = 8          # default ring-buffer depth R (rounds of history)
SKETCH_DIM = 64            # default count-sketch width S per round


@lru_cache(maxsize=32)
def _sketch_plan(seed: int, dim: int, sketch_dim: int):
    """Count-sketch hash plan: bucket assignment h [D] and Rademacher
    signs s [D], drawn with numpy (the reference's, bit for bit); the
    sketches take no draw from the round's provider."""
    rng = np.random.default_rng(seed * 1_000_003 + 0xC0DE)
    bucket = rng.integers(0, sketch_dim, size=dim)
    sign = rng.integers(0, 2, size=dim) * 2 - 1
    return (np.asarray(bucket, np.int32), np.asarray(sign, np.float32))


@lru_cache(maxsize=32)
def _sketch_matrix(seed: int, dim: int, sketch_dim: int,
                   device: torch.device):
    """The count-sketch plan as a dense [D, S] fp32 matrix on ``device``:
    ``sign[d]`` at ``(d, bucket[d])``, zero elsewhere (707 KB at D = 2,762,
    S = 64). ``deltas @ M`` is the reference's signed bucket sum. Built
    once per (seed, D, S, device); the cache keeps up to 32 on their
    devices for the life of the process."""
    bucket, sign = _sketch_plan(seed, dim, sketch_dim)
    m = np.zeros((dim, sketch_dim), np.float32)
    m[np.arange(dim), bucket] = sign
    return torch.from_numpy(m).to(device)


def sketch_deltas(deltas, sketch_dim: int, *, seed: int = 0):
    """Sign-sketch of per-worker update deltas: the count-sketch projection
    [W, D] → [W, S] (signed bucket sums), then ``sign``, the {−1, 0, +1}
    codes whose cross-round product is the correlation estimator of
    ``colluder_scores``."""
    m = _sketch_matrix(seed, deltas.shape[1], sketch_dim, deltas.device)
    return torch.sign(deltas @ m)


def update_sketch(hist, deltas, *, seed: int = 0):
    """Rotate the sketch ring buffer: drop the oldest round, append this
    round's sign-sketch. hist: [W, R, S]; deltas: [W, D]. Shift-based, so
    a frozen worker's whole row is kept by a plain ``where``."""
    new = sketch_deltas(deltas, hist.shape[2], seed=seed)
    return torch.cat([hist[:, 1:, :], new[:, None, :]], dim=1)


def correlation_matrix(hist, *, eps: float = 1e-12):
    """Pairwise cross-round correlation: cosine similarity of the flattened
    [W, R·S] sign-sketch histories by one product. Zero rows (unfilled
    history) correlate 0 with everything; the diagonal is zeroed."""
    w = hist.shape[0]
    flat = hist.reshape(w, -1)
    n = torch.sqrt((flat * flat).sum(-1))
    corr = (flat @ flat.T) / (n[:, None] * n[None, :] + eps)
    eye = torch.eye(w, dtype=torch.bool, device=hist.device)
    return torch.where(eye, torch.zeros_like(corr), corr)


def colluder_scores(hist, mask, weights=None, *, eps: float = 1e-12):
    """Cluster-membership suspicion per (receiver i, peer j) from the
    cross-round correlation of the sketch history ``hist`` [W, R, S];
    ``mask`` and ``weights`` as in ``geom_scores``. Returns [W, W]
    (conforming peers ≲ 0, cluster members > 0, rows with no peers
    all-zero)."""
    corr = correlation_matrix(hist, eps=eps)
    return correlation_suspicion(corr, mask, weights=weights, eps=eps)


def _nanmedian(x):
    """The median of the non-NaN entries of ``x``, as ``jnp.nanmedian``
    takes it: the two middle values of the sorted entries averaged as
    ``(lo + hi) * 0.5`` (``torch.nanmedian`` returns the lower one); NaN
    when every entry is NaN. Reads no value back to the host (the middle
    indices stay on the device)."""
    v = torch.sort(x.reshape(-1)).values            # NaNs sort last
    n = (~torch.isnan(v)).sum()
    q = 0.5 * (n - 1).float()
    lo = torch.floor(q).clamp(max=n - 1).clamp_min(0).long()
    hi = torch.ceil(q).clamp(max=n - 1).clamp_min(0).long()
    return ((v[lo.reshape(1)] + v[hi.reshape(1)]) * 0.5).reshape(())


def correlation_suspicion(corr, mask, weights=None, *, valid=None,
                          eps: float = 1e-12):
    """The median + MAD calibration and power-iteration clustering tail of
    ``colluder_scores``, shared with the stamped (cross-device)
    correlation. ``valid`` (optional [W, W] bool) marks the entries backed
    by enough common observations: invalid entries join neither the
    baseline nor the excess graph, and with none valid every score is 0.
    """
    w = corr.shape[0]
    eye = torch.eye(w, dtype=torch.bool, device=corr.device)
    nan = torch.full((), float("nan"), device=corr.device)
    offd = torch.where(eye, nan, corr)
    if valid is not None:
        offd = torch.where(valid, offd, nan)
    base = _nanmedian(offd)
    spread = _nanmedian(torch.abs(offd - base))
    if valid is not None:
        base = torch.nan_to_num(base, nan=0.0)
        spread = torch.nan_to_num(spread, nan=0.0)
    excess = torch.where(eye, torch.zeros_like(corr),
                         torch.relu(corr - base - spread))
    if valid is not None:
        excess = torch.where(valid & ~eye, excess, torch.zeros_like(excess))
    v = excess.mean(dim=1)                          # [W] first pass
    s = excess @ v                                  # [W] cluster mass

    mask, wts = _masked_weights(mask, weights, eye)
    return _centre(s[None, :].expand(w, w), mask, wts, eps)


def stamped_correlation(hist, stamps, *, min_obs: int = 2,
                        eps: float = 1e-12):
    """Observation-aligned cross-round correlation for sparsely observed
    peers: the mean per-slot-pair cosine over slots whose global-round
    stamps match (−1 = never filled). hist: [W, R, S]; stamps: [W, R]
    int. Returns ``(corr [W, W], valid [W, W])``, ``valid`` True where a
    pair shares ≥ ``min_obs`` stamped rounds; pairs never co-observed get
    corr 0."""
    filled = stamps >= 0                                   # [W, R]
    match = (stamps[:, None, :, None] == stamps[None, :, None, :]) \
        & filled[:, None, :, None] & filled[None, :, None, :]
    dots = torch.einsum("irs,jps->ijrp", hist, hist)        # [W, W, R, R]
    n = torch.sqrt((hist * hist).sum(-1))                   # [W, R]
    cos = dots / (n[:, None, :, None] * n[None, :, None, :] + eps)
    m = match.to(hist.dtype)
    nmatch = m.sum((2, 3))                                  # [W, W]
    corr = (m * cos).sum((2, 3)) / nmatch.clamp_min(1.0)
    valid = nmatch >= min_obs
    w = hist.shape[0]
    eye = torch.eye(w, dtype=torch.bool, device=hist.device)
    return torch.where(eye, torch.zeros_like(corr), corr), valid & ~eye


def fused_trust_signal(dts_signal: str, loss_trust, geom, damaged,
                       lam: float, corr=None, lam_corr: float = 0.0):
    """The trust_update stage's fused per-(receiver, peer) signal [W, W].
    ``"loss"`` is Algorithm 3's broadcast; ``"geom"`` / ``"corr"`` keep
    only the damage penalty of the loss channel plus their own score;
    ``"both"`` is loss + λ·geom; ``"all"`` loss + λg·geom + λc·corr."""
    if dts_signal == "loss":
        return loss_trust[:, None]
    if dts_signal == "geom":
        damage_only = damaged.float() * DAMAGE_PENALTY
        return damage_only[:, None] + lam * geom
    if dts_signal == "both":
        return loss_trust[:, None] + lam * geom
    if dts_signal == "corr":
        damage_only = damaged.float() * DAMAGE_PENALTY
        return damage_only[:, None] + lam_corr * corr
    if dts_signal == "all":
        return loss_trust[:, None] + lam * geom + lam_corr * corr
    raise ValueError(f"unknown dts_signal {dts_signal!r} "
                     f"(one of: loss, geom, both, corr, all)")


def geom_confidence_update(dts_signal: str, lam: float, conf, sampled, P,
                           loss_trust, damaged, deltas, mask, weights,
                           sketch=None, lam_corr: float = 0.0):
    """The geometric/correlation trust update: score the deltas (geometry)
    and/or the already-rotated sketch ring buffer (correlation, needed by
    ``"corr"`` / ``"all"``), fuse with the loss channel and apply
    ``c ← c − m ∘ p · signal``."""
    gs = (geom_scores(deltas, mask, weights=weights)
          if dts_signal in ("geom", "both", "all") else None)
    cs = (colluder_scores(sketch, mask, weights=weights)
          if dts_signal in ("corr", "all") else None)
    signal = fused_trust_signal(dts_signal, loss_trust, gs, damaged, lam,
                                corr=cs, lam_corr=lam_corr)
    return conf - sampled * P * signal


def masked_geom_trust(deltas, P, mask=None, *, eps: float = 1e-12):
    """The aggregate-only trust signal under ``secagg_mode="masked_geom"``:
    per RECEIVER i, ``−cos(pooled_i, δ_i)`` with ``pooled_i = Σ_{j≠i} P_ij
    δ_j / Σ_{j≠i} P_ij``, the aggregate minus its own contribution,
    renormalized. Negative (trust-raising) when the pooled neighbourhood
    moves with the receiver, positive when against it; the round
    broadcasts it over the receiver's sampled row, since the receiver
    cannot tell which peer moved the pool. ``mask``: [W, W] bool live-peer
    gate (non-firing peers' deltas were never in the aggregate). Rows with
    no off-diagonal mass return 0."""
    w = P.shape[0]
    off = P.float() * (1.0 - torch.eye(w, device=P.device))
    if mask is not None:
        off = off * mask.float()
    tot = off.sum(dim=1, keepdim=True)
    pooled = (off / torch.clamp(tot, min=eps)) @ deltas      # [W, D]
    num = (pooled * deltas).sum(dim=1)
    den = torch.linalg.norm(pooled, dim=1) \
        * torch.linalg.norm(deltas, dim=1) + eps
    return torch.where(tot[:, 0] > 0, -num / den, torch.zeros_like(num))
