"""Mixture-of-Experts FFN: shared + routed experts, top-k router with a
load-balance auxiliary loss (the port of ``repro.models.moe``).

The router's gates and expert indices come from the fused router kernel
(fp32 softmax, top-k with the lower index first on a tie, renormalisation)
on the fp32 router logits; the aux loss takes the softmax itself, as the
reference does.

Two dispatch strategies, as in the reference:

* ``dense``   — every token through every expert (exact; decode default).
                Routed by ``kernels.ops.moe_router_topk``.
* ``grouped`` — capacity dispatch: tokens are packed into an [E, C, D]
                buffer by (expert, rank within expert), batch-multiplied
                against the expert stack and gathered back. Overflow
                tokens are dropped, empty slots are zero. Routed by
                ``kernels.ops.moe_route_slots``, which also gives each
                (token, choice) its slot and each slot its token, so the
                pack is one gather and the combine another, with no host
                synchronisation.

``eplocal`` (expert parallelism across devices) is not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Builder


def init_moe(b: Builder, cfg: ModelConfig):
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.num_experts
    b.normal("router", (d, e))
    b.normal("wi", (e, d, f))
    b.normal("wg", (e, d, f))
    b.normal("wo", (e, f, d))
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        b.normal("shared_wi", (d, fs))
        b.normal("shared_wg", (d, fs))
        b.normal("shared_wo", (fs, d))


def router_logits(params, x):
    """x: [T, D] -> router logits [T, E] (fp32)."""
    return x.float() @ params["router"].float()


def router_probs(params, x):
    """x: [T, D] -> (router probabilities [T, E], logits [T, E]), fp32."""
    logits = router_logits(params, x)
    return torch.softmax(logits, dim=-1), logits


def load_balance_loss(probs, expert_index, num_experts):
    """Switch-transformer aux loss: E * sum_e f_e * P_e."""
    t = probs.shape[0]
    onehot = F.one_hot(expert_index, num_experts).float()
    f = onehot.sum(dim=(0, 1)) / t             # fraction routed per expert
    p = probs.mean(dim=0)                      # mean router prob per expert
    return num_experts * torch.sum(f * p)


def _route(params, cfg: ModelConfig, x, cap=None):
    """(gates [T, k] fp32, expert indices [T, k] int64, aux loss, slots):
    without ``cap`` by ``ops.moe_router_topk`` and slots None; with it by
    ``ops.moe_route_slots``, and slots are its (slot [T, k], src [E*cap])
    int32."""
    logits = router_logits(params, x)
    if cap is None:
        gates, idx = ops.moe_router_topk(logits, cfg.moe.top_k)
        slots = None
    else:
        gates, idx, *slots = ops.moe_route_slots(logits, cfg.moe.top_k, cap)
    idx = idx.long()
    aux = load_balance_loss(torch.softmax(logits, dim=-1), idx,
                            cfg.moe.num_experts)
    return gates, idx, aux, slots


def _shared(params, x):
    h = x @ params["shared_wi"]
    g = x @ params["shared_wg"]
    return (F.silu(g) * h) @ params["shared_wo"]


def moe_dense(params, cfg: ModelConfig, x):
    """Exact all-experts formulation. x: [T, D] -> ([T, D], aux_loss)."""
    gates, idx, aux, _ = _route(params, cfg, x)
    xe = x[None].expand(cfg.moe.num_experts, *x.shape)     # [E, T, D]
    h = torch.bmm(xe, params["wi"])                          # [E, T, F]
    g = torch.bmm(xe, params["wg"])
    y_all = torch.bmm(F.silu(g) * h, params["wo"])           # [E, T, D]
    combine = torch.zeros((x.shape[0], cfg.moe.num_experts), dtype=x.dtype,
                          device=x.device)
    combine.scatter_(1, idx, gates.to(x.dtype))
    y = torch.einsum("te,etd->td", combine, y_all)
    if cfg.moe.num_shared_experts:
        y = y + _shared(params, x)
    return y, aux


def grouped_capacity(t: int, e: int, k: int,
                     capacity_factor: float = 1.25) -> int:
    """Slots per expert of the grouped dispatch for T tokens, E experts and
    top-k: capacity_factor * k * T / E, at least 1, rounded up to the
    reference's multiple of 8."""
    cap = max(int(capacity_factor * k * t / e), 1)
    return (cap + 7) // 8 * 8


def moe_grouped(params, cfg: ModelConfig, x, capacity_factor: float = 1.25):
    """Capacity-packed dispatch. x: [T, D] -> ([T, D], aux_loss)."""
    m = cfg.moe
    t, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = grouped_capacity(t, e, k, capacity_factor)

    gates, idx, aux, (slot, src) = _route(params, cfg, x, cap)

    # pack: buf[e, s] = x[src[e*cap + s]]; an empty slot reads the zero row
    # appended at T
    buf = F.pad(x, (0, 0, 0, 1)).index_select(0, src).view(e, cap, d)

    h = torch.bmm(buf, params["wi"])
    g = torch.bmm(buf, params["wg"])
    y_buf = torch.bmm(F.silu(g) * h, params["wo"])               # [E, cap, D]

    # gather each pair's row back and combine with its gate (a dropped
    # pair, slot = cap, reads a kept row and weighs it 0)
    keep = slot < cap
    at = idx * cap + slot.clamp(max=cap - 1)                     # [T, k]
    y_tok = y_buf.view(e * cap, d).index_select(0, at.view(-1))
    w = (gates * keep).to(x.dtype)
    y = (y_tok.view(t, k, d) * w[..., None]).sum(dim=1)
    if m.num_shared_experts:
        y = y + _shared(params, x)
    return y, aux


def moe_ffn(params, cfg: ModelConfig, x, strategy: str = "grouped"):
    """x: [B, S, D] -> ([B, S, D], aux_loss). strategies: dense | grouped."""
    if strategy.startswith("eplocal"):
        raise NotImplementedError(
            "moe_strategy='eplocal*' (expert parallelism) is not ported yet: "
            "ROADMAP.md queue 1a, item 9")
    b_, s, d = x.shape
    flat = x.reshape(b_ * s, d)
    if strategy == "dense":
        y, aux = moe_dense(params, cfg, flat)
    elif strategy == "grouped":
        y, aux = moe_grouped(params, cfg, flat)
    else:
        raise ValueError(f"unknown moe_strategy {strategy!r}")
    return y.reshape(b_, s, d), aux
