"""Plain PyTorch versions of the port's kernels (the contracts of
``repro.kernels.ref``). The wrappers in ``ops`` run these for CPU tensors;
``chip_smoke.py`` holds each CUDA kernel against them on the card. The
gossip mixes return float32 (they accumulate in fp32 whatever the
payload); attention returns q's dtype; the router fp32 gates and int32
indices; the SSD intra-chunk term x's dtype."""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


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


def flash_tc_limit(q, k, v, want, *, causal: bool = True, window: int = 0):
    """Per-element limit of the tensor-core flash kernel against the plain
    version's output ``want``: |want| * 2**-6 + 2**-8 * (P.|v|) + 1e-5,
    where P.|v| = sum_k p_k |v_k| / l is this plain version applied to |v|
    in f32. The kernel rounds p to bf16 before P.V (8 significant bits:
    each term moves by at most 2**-8 relative) and sums l from the fp32 p
    as this version does; got and want are each rounded once to bf16
    (half an ulp each, ulp(x) <= |x| * 2**-7). Derivation in
    csrc/flash_attention_tc.cu."""
    pv_abs = flash_attention_ref(q.float(), k.float(), v.float().abs(),
                                 causal=causal, window=window)
    return want.float().abs() * 2.0 ** -6 + 2.0 ** -8 * pv_abs + 1e-5


# kind -> (S, causal, window) of ``flash_adversarial``
FLASH_ADVERSARIAL = {"diagonal": (300, True, 0),
                     "window_edge": (300, True, 64),
                     "ragged_negative": (1000, False, 0),
                     "growing": (512, True, 0)}


def flash_adversarial(kind: str, d: int, seed: int = 0, device=None):
    """f32 q, k, v [1, 2, S, D] (from numpy with ``seed``) on which a mask
    or rescaling fault moves the output far beyond ``flash_tc_limit``, and
    the case's (causal, window) (``FLASH_ADVERSARIAL``):

    - ``diagonal``: the key just past the diagonal (k = q + 1) dominates
      each row's scores by ~13.5 (natural log), so a causal mask that is
      one key late takes v[q + 1] for the output;
    - ``window_edge``: the same for the key at q - window, the first one
      the window hides;
    - ``ragged_negative``: no causal mask and S = 1000 (not a multiple of
      128); every visible score is about -20, so a key past S left
      unmasked (score 0, v = 0) would take almost all the weight; v has
      mean 1;
    - ``growing``: scores rise by 0.05 a key, ~6.4 over a 128-key tile, so
      a missing rescale of earlier tiles by alpha shows.
    Returns (q, k, v, causal, window)."""
    s, causal, window = FLASH_ADVERSARIAL[kind]
    rng = np.random.default_rng(seed)
    shape = (1, 2, s, d)
    u = rng.normal(size=shape)
    v = rng.normal(size=shape)
    if kind in ("diagonal", "window_edge"):
        a = 1.3
        q = a * u
        k = a * rng.normal(size=shape)
        if kind == "diagonal":           # k[j] = a u[j - 1]: q . k[q + 1]
            k[:, :, 1:] = a * u[:, :, :-1]
        else:                            # k[j] = a u[j + window]
            k[:, :, :s - window] = a * u[:, :, window:]
    elif kind == "ragged_negative":
        w = rng.normal(size=(1, 2, 1, d))
        c = math.sqrt(20.0 / math.sqrt(d))
        q = -c * w + 0.3 * u
        k = c * w + 0.3 * rng.normal(size=shape)
        v = v + 1.0
    elif kind == "growing":
        w = rng.normal(size=(1, 2, 1, d))
        w *= math.sqrt(d) / np.linalg.norm(w, axis=-1, keepdims=True)
        q = np.broadcast_to(w, shape).copy()
        pos = np.arange(s).reshape(1, 1, s, 1)
        # q . k[j] / sqrt(D) = 0.05 j + noise
        k = 0.05 * pos * w / math.sqrt(d) + 0.1 * rng.normal(size=shape)
    else:
        raise ValueError(f"unknown adversarial case {kind!r}")
    q, k, v = (torch.tensor(x, dtype=torch.float32, device=device)
               for x in (q, k, v))
    return q, k, v, causal, window


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


def route_slots_ref(idx, num_experts: int, cap: int):
    """The grouped dispatch's slots for the experts idx [T, k] that each
    token chose, by the reference's one-hot cumsum (repro/models/moe.py
    :94-100): slot [T, k] int32, the pair's rank among the pairs routed to
    its expert in flattened order t*k + j where that rank is below
    ``cap``, else ``cap``; and the inverse map src [E*cap] int32, the token
    in slot s of expert e at e*cap + s, or T where that slot stays empty."""
    t, k = idx.shape
    flat = idx.reshape(-1).long()
    rank = torch.cumsum(F.one_hot(flat, num_experts), dim=0) - 1
    rank = rank.gather(1, flat[:, None])[:, 0]
    keep = rank < cap
    slot = torch.where(keep, rank, torch.full_like(rank, cap))
    # the dropped pairs all land in one extra bin, cut off at the end
    src = torch.full((num_experts * cap + 1,), t, dtype=torch.int64,
                     device=idx.device)
    src[torch.where(keep, flat * cap + rank, num_experts * cap)] = \
        torch.arange(t, device=idx.device).repeat_interleave(k)
    return slot.to(torch.int32).reshape(t, k), \
        src[:-1].to(torch.int32)


def moe_route_slots_ref(logits, k: int, cap: int):
    """logits [T, E] -> (gates, idx) of ``moe_router_topk_ref`` and (slot,
    src) of ``route_slots_ref`` on those indices."""
    gates, idx = moe_router_topk_ref(logits, k)
    return (gates, idx, *route_slots_ref(idx, logits.shape[1], cap))


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
