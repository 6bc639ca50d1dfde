"""Plain PyTorch versions of the port's kernels (the contracts of
``repro.kernels.ref``). The wrappers in ``ops`` run these for CPU tensors;
``chip_smoke.py`` holds each CUDA kernel against them on the card. The
gossip mixes return float32 (they accumulate in fp32 whatever the
payload); attention returns q's dtype; the router fp32 gates and int32
indices; the SSD intra-chunk term x's dtype."""
from __future__ import annotations

import math

import torch


def gossip_mix_ref(P, w):
    """P: [W, W] mixing; w: [W, F] f32, bf16 or int8 payload."""
    return P.float() @ w.float()


def gossip_mix_sparse_ref(idx, val, w):
    """Padded-CSR gossip: idx [W, K] int, val [W, K] (0 on padding),
    w [W, F]. out[i] = sum_k val[i, k] * w[idx[i, k]]."""
    gathered = w.float()[idx.long()]                          # [W, K, F]
    return torch.einsum("wk,wkf->wf", val.float(), gathered)


def gossip_mix_quant_ref(idx, val, scale, q):
    """Quantized padded-CSR gossip: scale [W] f32 per-row dequant scales,
    q [W, F] int8. out[i] = sum_k val[i, k] * scale[idx[i, k]] *
    q[idx[i, k]]."""
    deq = q.float() * scale.float().reshape(-1, 1)            # [W, F]
    return torch.einsum("wk,wkf->wf", val.float(), deq[idx.long()])


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q, k, v: [B, H, S, D] (same S). Full-matrix attention with scale
    1/sqrt(D), computed in fp32 and returned in q's dtype. Keys at
    ``k > q`` are masked when ``causal``, keys at ``k <= q - window`` when
    ``window > 0``."""
    s, d = q.shape[2], q.shape[3]
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(d)
    qpos = torch.arange(s, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v.float()).to(q.dtype)


def moe_router_topk_ref(logits, k: int):
    """logits: [T, E] -> (gates [T, k] fp32, idx [T, k] int32): the fp32
    softmax (exp(x - max) / sum), its k largest entries in descending order
    with the lower expert index first on a tie (a stable sort; torch.topk
    promises no tie order), renormalized by their sum + 1e-9."""
    x = logits.float()
    ex = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    probs = ex / ex.sum(dim=-1, keepdim=True)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    gates = vals / (vals.sum(dim=-1, keepdim=True) + 1e-9)
    return gates, idx.to(torch.int32)


def ssd_chunk_ref(C, B, acum, dt, x):
    """Mamba2 SSD intra-chunk term (``models.ssm.ssd_scan``'s y_diag in the
    chunk-local view). C, B: [G, T, N]; acum, dt: [G, H, T]; x: [G, H, T,
    P] -> y [G, H, T, P], computed in fp32:
    y[g, h, q] = sum_{k <= q} (C[g, q] . B[g, k]) * exp(acum[g, h, q] -
    acum[g, h, k]) * dt[g, h, k] * x[g, h, k]. The causal mask is applied
    to the exponent's argument before the exponent, so the differences
    above the diagonal (positive, up to thousands in the real model) never
    overflow to inf."""
    t = C.shape[1]
    scores = torch.einsum("gqn,gkn->gqk", C.float(), B.float())
    acum = acum.float()
    causal = torch.ones((t, t), dtype=torch.bool, device=C.device).tril()
    diff = (acum[..., :, None] - acum[..., None, :]).masked_fill(
        ~causal, float("-inf"))
    w = scores[:, None] * torch.exp(diff) * dt.float()[..., None, :]
    return torch.einsum("ghqk,ghkp->ghqp", w, x.float()).to(x.dtype)
