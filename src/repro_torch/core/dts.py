"""Decentralized Trust System, loss channel (port of ``repro.core.dts``,
paper §3.3, Algorithm 3).

Worker i keeps a confidence c_{i→j} per peer, samples peers by
θ_i = softmax(cRELU(c_i)) with a Gumbel top-k, and after each round
updates c_i ← c_i − m_i ∘ p_i · loss_trust. The time machine restores the
backup when a round's aggregate is damaged (``is_damaged``). The geometry
and correlation channels (DTS v2/v3) are later items of the port.
"""
from __future__ import annotations

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
