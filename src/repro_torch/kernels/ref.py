"""Plain PyTorch versions of the three gossip-mix kernels (the contracts of
``repro.kernels.ref``). The wrappers in ``ops`` run these for CPU tensors;
``chip_smoke.py`` holds each CUDA kernel against them on the card. Every
output is float32 (the mix accumulates in fp32 whatever the payload)."""
from __future__ import annotations

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
