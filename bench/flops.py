"""Model FLOPs of one training step, counted from the configuration: the
work the forward and backward need, with nothing recomputed.

A forward costs 2 flops a multiply-add: every matrix parameter a token
passes through (projections, the experts it is routed to and the shared
ones, the router, the unembedding; not the embedding lookup, the norms or
the depthwise conv), causal attention (q k^T and p v over the visible
pairs) and Mamba2's SSD as its chunked algorithm computes it (the
intra-chunk scores C B^T over the causal pairs, their weights times x a
head, the chunk states and the inter-chunk output). A training step is
three forwards (the backward two).
"""
from __future__ import annotations


def _ssd_layer(cfg: dict, seq: int) -> float:
    s = cfg["ssm"]
    heads = s["expand"] * cfg["d_model"] // s["head_dim"]
    n, p, q = s["d_state"], s["head_dim"], min(s["chunk_size"], seq)
    chunks = -(-seq // q)
    pairs = q * (q + 1) // 2
    intra = pairs * (2 * n + 2 * heads * p)
    states = 2 * (2 * heads * p * n * q)          # chunk states + y_off
    return chunks * (intra + states)


def forward_flops(cfg: dict, batch: int, seq: int) -> float:
    """Forward flops of ``batch`` sequences of ``seq`` tokens."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    tokens = batch * seq
    matmul = d * v                                   # unembedding
    extra = 0.0                                      # per sequence
    for i in range(cfg["num_layers"]):
        if cfg["family"] == "ssm":
            s = cfg["ssm"]
            d_inner = s["expand"] * d
            heads = d_inner // s["head_dim"]
            d_proj = 2 * d_inner + 2 * s["d_state"] + heads
            matmul += d * d_proj + d_inner * d
            extra += _ssd_layer(cfg, seq)
            continue
        h, kv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
        matmul += 2 * d * h * hd + 2 * d * kv * hd
        extra += 4 * h * hd * seq * (seq + 1) // 2
        if i < cfg.get("first_dense", 0) or cfg.get("moe") is None:
            matmul += 3 * d * cfg["d_ff"]
        else:
            m = cfg["moe"]
            matmul += d * m["num_experts"] + 3 * d * m["d_expert"] * (
                m["top_k"] + m["num_shared_experts"])
    return 2.0 * matmul * tokens + batch * extra


def train_flops(cfg: dict, batch: int, seq: int) -> float:
    return 3.0 * forward_flops(cfg, batch, seq)
