"""Mixture-of-Experts FFN: shared + routed experts, top-k router with a
load-balance auxiliary loss (the port of ``repro.models.moe``).

The router's gates and expert indices come from the fused router kernel
(``kernels.ops.moe_router_topk``: fp32 softmax, top-k with the lower index
first on a tie, renormalisation) on the fp32 router logits; the aux loss
takes the softmax itself, as the reference does.

Two dispatch strategies, as in the reference:

* ``dense``   — every token through every expert (exact; decode default).
* ``grouped`` — capacity dispatch: tokens are scatter-packed into an
                [E, C, D] buffer by (expert, rank within expert), batch-
                multiplied against the expert stack and gathered back.
                Overflow tokens are dropped, empty slots are zero.

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


def _route(params, cfg: ModelConfig, x):
    """(gates [T, k] fp32, expert indices [T, k] int64, aux loss)."""
    logits = router_logits(params, x)
    gates, idx = ops.moe_router_topk(logits, cfg.moe.top_k)
    idx = idx.long()
    aux = load_balance_loss(torch.softmax(logits, dim=-1), idx,
                            cfg.moe.num_experts)
    return gates, idx, aux


def _shared(params, x):
    h = x @ params["shared_wi"]
    g = x @ params["shared_wg"]
    return (F.silu(g) * h) @ params["shared_wo"]


def moe_dense(params, cfg: ModelConfig, x):
    """Exact all-experts formulation. x: [T, D] -> ([T, D], aux_loss)."""
    gates, idx, aux = _route(params, cfg, x)
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


def moe_grouped(params, cfg: ModelConfig, x, capacity_factor: float = 1.25):
    """Capacity-packed dispatch. x: [T, D] -> ([T, D], aux_loss)."""
    m = cfg.moe
    t, d = x.shape
    e, k = m.num_experts, m.top_k
    cap = max(int(capacity_factor * k * t / e), 1)
    cap = (cap + 7) // 8 * 8          # the reference's multiple of 8

    gates, idx, aux = _route(params, cfg, x)

    # rank of each (token, k) within its expert
    flat_e = idx.reshape(-1)                                     # [T*k]
    rank = torch.cumsum(F.one_hot(flat_e, e), dim=0) - 1         # [T*k, E]
    rank = rank.gather(1, flat_e[:, None])[:, 0]
    keep = rank < cap
    slot = torch.where(keep, rank, torch.full_like(rank, cap))   # drop -> pad

    # scatter-pack into [E, cap+1, D]; the last slot is the trash bin, the
    # only place two rows collide, so the accumulate is exact on kept slots
    tok = torch.arange(t, device=x.device).repeat_interleave(k)
    buf = torch.zeros((e, cap + 1, d), dtype=x.dtype, device=x.device)
    buf.index_put_((flat_e, slot), x[tok], accumulate=True)
    buf = buf[:, :cap]

    h = torch.bmm(buf, params["wi"])
    g = torch.bmm(buf, params["wg"])
    y_buf = torch.bmm(F.silu(g) * h, params["wo"])               # [E, cap, D]

    # gather back and combine with gate weights (dropped tokens get 0)
    y_tok = y_buf[flat_e, slot.clamp(max=cap - 1)]               # [T*k, D]
    w = (gates.reshape(-1) * keep).to(x.dtype)
    y = torch.zeros((t, d), dtype=x.dtype, device=x.device)
    y.index_add_(0, tok, y_tok * w[:, None])
    if m.num_shared_experts:
        y = y + _shared(params, x)
    return y, aux


def moe_ffn(params, cfg: ModelConfig, x, strategy: str = "grouped"):
    """x: [B, S, D] -> ([B, S, D], aux_loss). strategies: dense | grouped."""
    if strategy.startswith("eplocal"):
        raise NotImplementedError(
            "moe_strategy='eplocal*' (expert parallelism) is not ported yet: "
            "ROADMAP.md queue 1, item 17")
    b_, s, d = x.shape
    flat = x.reshape(b_ * s, d)
    if strategy == "dense":
        y, aux = moe_dense(params, cfg, flat)
    elif strategy == "grouped":
        y, aux = moe_grouped(params, cfg, flat)
    else:
        raise ValueError(f"unknown moe_strategy {strategy!r}")
    return y.reshape(b_, s, d), aux
