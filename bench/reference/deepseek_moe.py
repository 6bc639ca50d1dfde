"""Plain reference of DeepSeekMoE (arXiv:2401.06066): pre-norm decoder
blocks of multi-head causal attention with rotary positions and a SwiGLU
FFN, dense in the leading ``first_dense`` layers and a mixture of experts
after them.

    x = x + Attn(RMSNorm(x));  x = x + FFN(RMSNorm(x))

Attention: q, k, v = h W_q, h W_k, h W_v per head; rotary positions on
q and k (pairs (i, i + d/2), angles t / theta^(2i/d)); softmax(q k^T /
sqrt(d)) over keys at or before the query; out W_o. Whole [S, S] scores,
no blocking, no kernel.

MoE FFN: router probabilities p = softmax(h W_r) in float32; each token's
``top_k`` experts by p (the lower index first on a tie), gates = their p
renormalised by their sum + 1e-9; the output is sum_j gate_j E_j(h) plus
the shared experts (one SwiGLU of ``num_shared_experts`` x d_expert
columns). Departures from the published model, which are the deployed
program's semantics: (1) the gates are renormalised over the top k; (2)
each expert takes at most ``capacity`` = ceil8(floor(1.25 k T / E))
(token, choice) pairs, kept in order t k + j, and a pair past it adds
nothing; (3) the loss adds ``router_aux_weight`` x the Switch load-balance
loss E sum_e f_e P_e (f_e the share of pairs routed to e, P_e the mean
probability).

Parameters are a flat dict of float32 leaves in the layout the
configuration is served in (``layout``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.lm import Precision, next_token_loss, rms_norm, swiglu

CAPACITY_FACTOR = 1.25


def _block_names(cfg: dict, i: int) -> str:
    # the leading dense layers and the one MoE layer after them are
    # served unstacked: the dense ones under prefix/, the rest under layers/
    return f"prefix/{i}" if i < cfg["first_dense"] else f"layers/{i}"


def layout(cfg: dict) -> dict:
    d, h, hd = cfg["d_model"], cfg["num_heads"], cfg["head_dim"]
    kv = cfg["num_kv_heads"]
    m = cfg["moe"]
    e, f = m["num_experts"], m["d_expert"]
    fs = f * m["num_shared_experts"]
    if cfg["num_layers"] - cfg["first_dense"] > 1:
        raise ValueError("the reference's layout holds one MoE layer after "
                         "the dense ones (a longer stack is served stacked)")
    out = {"embedding": ((cfg["vocab_size"], d), "normal"),
           "lm_head": ((d, cfg["vocab_size"]), "normal"),
           "ln_f": ((d,), "ones")}
    for i in range(cfg["num_layers"]):
        b = _block_names(cfg, i)
        out.update({
            f"{b}/ln1": ((d,), "ones"),
            f"{b}/attn/wq": ((d, h, hd), "normal"),
            f"{b}/attn/wk": ((d, kv, hd), "normal"),
            f"{b}/attn/wv": ((d, kv, hd), "normal"),
            f"{b}/attn/wo": ((h, hd, d), "normal"),
            f"{b}/ln2": ((d,), "ones")})
        if i < cfg["first_dense"]:
            out.update({f"{b}/mlp/wi": ((d, cfg["d_ff"]), "normal"),
                        f"{b}/mlp/wg": ((d, cfg["d_ff"]), "normal"),
                        f"{b}/mlp/wo": ((cfg["d_ff"], d), "normal")})
        else:
            out.update({f"{b}/moe/router": ((d, e), "normal"),
                        f"{b}/moe/wi": ((e, d, f), "normal"),
                        f"{b}/moe/wg": ((e, d, f), "normal"),
                        f"{b}/moe/wo": ((e, f, d), "normal"),
                        f"{b}/moe/shared_wi": ((d, fs), "normal"),
                        f"{b}/moe/shared_wg": ((d, fs), "normal"),
                        f"{b}/moe/shared_wo": ((fs, d), "normal")})
    return out


def rope(x, theta: float):
    """x [b, S, H, d]; pairs (i, i + d/2) rotated by t / theta^(2i/d)."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32,
                                       device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(p: dict, cfg: dict, h, prec: Precision):
    q = prec.einsum("bsd,dhk->bshk", h, p["wq"])
    k = prec.einsum("bsd,dhk->bshk", h, p["wk"])
    v = prec.einsum("bsd,dhk->bshk", h, p["wv"])
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    rep = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(rep, 2), v.repeat_interleave(rep, 2)
    s = h.shape[1]
    scores = prec.einsum("bqhk,bshk->bhqs", q, k) / math.sqrt(q.shape[-1])
    causal = torch.ones(s, s, dtype=torch.bool, device=h.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), -1)
    out = prec.einsum("bhqs,bshk->bqhk", probs, v)
    return prec.einsum("bqhk,hkd->bqd", out, p["wo"])


def capacity(t: int, e: int, k: int) -> int:
    cap = max(int(CAPACITY_FACTOR * k * t / e), 1)
    return -(-cap // 8) * 8


def moe(p: dict, cfg: dict, h, prec: Precision):
    """h [b, S, D] -> (y [b, S, D], load-balance loss)."""
    m = cfg["moe"]
    e, k = m["num_experts"], m["top_k"]
    x = h.reshape(-1, h.shape[-1])
    t = x.shape[0]
    probs = torch.softmax(prec.mm(x, p["router"]), dim=-1)
    idx = torch.sort(probs.detach(), dim=-1, descending=True,
                     stable=True).indices[:, :k]                  # [T, k]
    top = probs.gather(1, idx)
    gates = top / (top.sum(-1, keepdim=True) + 1e-9)
    onehot = F.one_hot(idx.reshape(-1), e)                        # [T*k, E]
    rank = (torch.cumsum(onehot, 0) - 1).gather(
        1, idx.reshape(-1, 1)).reshape(t, k)
    keep = rank < capacity(t, e, k)
    y = torch.zeros_like(x)
    for ex in range(e):
        tok, j = torch.nonzero((idx == ex) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(x[tok], p["wi"][ex], p["wg"][ex], p["wo"][ex], prec)
        y = y.index_add(0, tok, out * gates[tok, j, None])
    y = y + swiglu(x, p["shared_wi"], p["shared_wg"], p["shared_wo"], prec)
    frac = onehot.float().sum(0) / t
    aux = e * torch.sum(frac * probs.mean(0))
    return y.reshape(h.shape), aux


class Model:
    def __init__(self, cfg: dict, precision: str = "fp32"):
        self.cfg = cfg
        self.prec = Precision(precision)

    def loss(self, params: dict, tokens):
        cfg, prec = self.cfg, self.prec
        eps = cfg["norm_eps"]
        x = params["embedding"][tokens]
        aux = torch.zeros((), device=x.device)
        for i in range(cfg["num_layers"]):
            b = _block_names(cfg, i)
            blk = {k[len(b) + 1:]: v for k, v in params.items()
                   if k.startswith(b + "/")}
            attn = {k[5:]: v for k, v in blk.items() if k.startswith("attn/")}
            x = x + attention(attn, cfg, rms_norm(x, blk["ln1"], eps), prec)
            hn = rms_norm(x, blk["ln2"], eps)
            if i < cfg["first_dense"]:
                x = x + swiglu(hn, blk["mlp/wi"], blk["mlp/wg"],
                               blk["mlp/wo"], prec)
            else:
                y, a = moe({k[4:]: v for k, v in blk.items()
                            if k.startswith("moe/")}, cfg, hn, prec)
                x, aux = x + y, aux + a
        x = rms_norm(x, params["ln_f"], eps)
        logits = prec.mm(x, params["lm_head"])
        return next_token_loss(logits, tokens) + \
            cfg["moe"]["router_aux_weight"] * aux
