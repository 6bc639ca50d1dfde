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

``eplocal`` / ``eplocal_fp8`` — expert parallelism over the ("data",
"model") mesh of the active sharding context (``models.moe_eplocal``; the
fp8 variant quantizes the dispatch).

Under tensor parallelism (``moe_ffn_tp``) eplocal reads its expert blocks
from the placement (experts -> "data", expert_mlp -> "model") and returns
the whole output; the grouped and dense dispatches run on each model
shard with its F columns of every expert (gathered over "data") and its
shared-expert columns (mlp -> "model"), giving partial sums.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Builder
from repro_torch.sharding import Act, Placed, axes_of


def init_moe(b: Builder, cfg: ModelConfig):
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_expert, m.num_experts
    b.normal("router", (d, e), ("embed", "experts_r"))
    b.normal("wi", (e, d, f), ("experts", "embed", "expert_mlp"))
    b.normal("wg", (e, d, f), ("experts", "embed", "expert_mlp"))
    b.normal("wo", (e, f, d), ("experts", "expert_mlp", "embed"))
    if m.num_shared_experts:
        fs = f * m.num_shared_experts
        b.normal("shared_wi", (d, fs), ("embed", "mlp"))
        b.normal("shared_wg", (d, fs), ("embed", "mlp"))
        b.normal("shared_wo", (fs, d), ("mlp", "embed"))


def router_logits(params, x):
    """x: [T, D] -> router logits [T, E] (fp32)."""
    return x.float() @ params["router"].float()


def router_probs(params, x):
    """x: [T, D] -> (router probabilities [T, E], logits [T, E]), fp32."""
    logits = router_logits(params, x)
    return torch.softmax(logits, dim=-1), logits


def expert_counts(expert_index, num_experts):
    """Pairs routed to each expert, fp32 [E]: the one-hot sum over tokens
    and choices. Written as a comparison with ``arange`` rather than
    ``F.one_hot``, whose ops differ by device (the CPU checks the index
    range, meta and CUDA do not), so that every device runs one
    program."""
    e = torch.arange(num_experts, device=expert_index.device)
    return (expert_index[..., None] == e).float().sum(dim=(0, 1))


def load_balance_loss(probs, expert_index, num_experts):
    """Switch-transformer aux loss: E * sum_e f_e * P_e."""
    t = probs.shape[0]
    f = expert_counts(expert_index, num_experts) / t   # fraction per expert
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
    """x: [B, S, D] -> ([B, S, D], aux_loss). strategies: dense | grouped |
    eplocal | eplocal_fp8 (expert parallelism; needs a mesh context)."""
    if strategy.startswith("eplocal"):
        from repro_torch.models.moe_eplocal import moe_eplocal
        return moe_eplocal(params, cfg, x, a2a_fp8=strategy.endswith("fp8"))
    # placed leaves (split over the data axis) are read whole
    params = {k: v.read((), x.device) if isinstance(v, Placed) else v
              for k, v in params.items()}
    b_, s, d = x.shape
    flat = x.reshape(b_ * s, d)
    if strategy == "dense":
        y, aux = moe_dense(params, cfg, flat)
    elif strategy == "grouped":
        y, aux = moe_grouped(params, cfg, flat)
    else:
        raise ValueError(f"unknown moe_strategy {strategy!r}")
    return y.reshape(b_, s, d), aux


def moe_ffn_tp(tp, params, cfg: ModelConfig, x, strategy: str = "grouped"):
    """``moe_ffn`` under tensor parallelism (``sharding.TensorParallel``;
    ``params`` one layer's placed MoE leaves, x an ``Act`` whole on each
    shard) -> (an ``Act``, aux). eplocal's output is whole on each shard;
    the grouped and dense dispatches give partial sums over the F columns
    (a part that does not split over "model" enters shard 0's only)."""
    if strategy.startswith("eplocal"):
        from repro_torch.models.moe_eplocal import moe_eplocal
        y, aux = moe_eplocal(params, cfg, x.parts[0],
                             a2a_fp8=strategy.endswith("fp8"))
        return Act([y.to(d) for d in tp.devices]), aux
    m = cfg.moe
    split = "model" in axes_of(params["wi"].spec[-1])
    shared = m.num_shared_experts and "model" in axes_of(
        params["shared_wi"].spec[-1])
    routed_cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(m, num_shared_experts=0))
    f = params["wi"].shape[-1] // (tp.size if split else 1)
    auxes = []

    def one(j):
        dev = tp.devices[j]
        cols = slice(j * f, (j + 1) * f) if split else slice(None)
        p = {"router": tp.read(params["router"], j),
             "wi": params["wi"].read((slice(None), slice(None), cols), dev),
             "wg": params["wg"].read((slice(None), slice(None), cols), dev),
             "wo": params["wo"].read((slice(None), cols), dev)}
        xj = x.parts[j]
        y, aux = moe_ffn(p, routed_cfg, xj, strategy=strategy)
        auxes.append(aux)
        if j and shared and not split:
            y = torch.zeros_like(y)     # the whole routed part: shard 0's
        if m.num_shared_experts and (shared or j == 0 or not split):
            loc = tp.params(params, j)
            y = y + _shared(loc, xj.reshape(-1, xj.shape[-1])).view(
                xj.shape)
        return y
    return Act(tp.each(one), partial=bool(split or shared)), auxes[0]
