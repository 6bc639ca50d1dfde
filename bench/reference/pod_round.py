"""Plain reference of one DeFTA gossip round across pods (arXiv:2204.02632,
Algorithms 2 and 3, with DTS peer sampling and the loss trust signal).

With W pods on a topology ``adj`` (no self loops), confidences c [W, W],
the last round's losses and this round's:

    theta_i   = softmax over peers j of cRELU(c_ij)    (cRELU(x) = x for
                x <= 0, slope x above)
    S_i       = the ``num_sampled`` peers of largest log(theta_ij) + g_ij,
                g the round's Gumbel draws (the lower index first on a tie)
    P_ij      ∝ [j in S_i or j = i] |D_j| / d_j     (d_j: j's outdegree
                with its self loop; rows normalised)
    w_i'      = sum_j P_ij w_j                    (every leaf, in float32,
                stored back in the leaf's type)
    c_i'      = c_i - [j in S_i] P_ij (loss_i - last_loss_i)

The round's input parameters, and its losses, are the program's: this
checks the stage by itself, as the training steps are checked by
themselves.
"""
from __future__ import annotations

import torch


def crelu(x, slope):
    return torch.where(x <= 0, x, slope * x)


def mixing(conf, adj, gumbel, sizes, num_sampled: int, slope: float):
    """(P [W, W] float32, sampled [W, W] bool) of one round."""
    w = adj.shape[0]
    z = torch.where(adj, crelu(conf, slope), torch.full_like(conf,
                                                             float("-inf")))
    theta = torch.softmax(z, dim=-1)
    score = torch.where(theta > 0, torch.log(theta + 1e-20) + gumbel,
                        torch.full_like(theta, float("-inf")))
    order = torch.sort(score, dim=-1, descending=True, stable=True).indices
    sampled = torch.zeros_like(adj)
    sampled.scatter_(1, order[:, :num_sampled], True)
    sampled &= adj & (theta > 0)
    eye = torch.eye(w, dtype=torch.bool, device=adj.device)
    outdeg = (adj | eye).sum(0).float()
    P = ((sampled | eye).float() * (sizes / outdeg)[None, :])
    return P / P.sum(1, keepdim=True), sampled


def round_(pre: dict, conf, last_loss, losses, adj, gumbel, sizes,
           num_sampled: int, slope: float):
    """pre: {leaf: [W, n] values of each pod (a sample of the leaf)}.
    Returns (mixed {leaf: [W, n] in pre's type}, conf', last_loss')."""
    P, sampled = mixing(conf, adj, gumbel, sizes, num_sampled, slope)
    mixed = {k: (P @ v.float()).to(v.dtype) for k, v in pre.items()}
    conf = conf - sampled.float() * P * (losses - last_loss)[:, None]
    return mixed, conf, losses.clone()
