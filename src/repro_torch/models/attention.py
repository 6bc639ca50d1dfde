"""Attention: GQA/MQA/MHA with RoPE, qk_norm, QKV bias, causal and
sliding-window masks, KV-cache decode with a ring buffer for a sliding
window, and whisper's cross and bidirectional attention (the port of
``repro.models.attention``).

Prefill attention runs the flash kernel (``kernels.ops.flash_attention``)
at every sequence length: it computes what the reference's ``_sdpa`` (up to
S = 2048) and ``blocked_attention_sdpa`` (above) compute. So do the
encoder's bidirectional attention and the decoder's cross-attention at
prefill, unmasked, the latter with k and v of the encoder's length. One-
token decode attention, over the cache and over the encoder states, stays
plain torch (``_sdpa``), as the reference computes it outside any kernel;
like the reference, decode re-projects the encoder states to k and v at
every step.

**Tensor parallelism** (``attention_tp`` and the decode forms;
``sharding.TensorParallel``). Model shard j projects q for its query
heads and runs the flash kernel on [B, H / tp, S, D], k and v on the kv
heads its q heads read, and ``wo`` is row-parallel over the heads: the
shards' outputs are partial sums. Where the model axis does not divide the
kv heads (granite-20b's one) the resolve chain puts "head_dim" on it for
``wk`` and ``wv``: k and v are all-gathered along head_dim after their
projection, before k_norm, RoPE and the kernel (a rotation pair (i, i +
hd / 2) lies on two shards, the kernel needs the whole head). Where it
does not divide the heads (whisper's 6 at tp 4) q is gathered the same
way and every shard runs every head (replicated work, counted so), ``wo``
row-parallel over head_dim. At decode a cache split along head_dim is
never gathered: each shard's partial scores q . k^T over its head_dim
block are all-reduced ([B, H, 1, C]), its probabilities read its v block,
and ``wo`` sums the rest.
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (Builder, apply_rope, head_rms_norm,
                                       torch_dtype)
from repro_torch.sharding import Act


def init_attention(b: Builder, cfg: ModelConfig, cross: bool = False):
    """One attention's leaves; ``cross`` (the reference's flag) gives a
    cross-attention the same ones."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    b.normal("wq", (d, nq, hd), ("embed", "heads", "head_dim"))
    b.normal("wk", (d, nkv, hd), ("embed", "kv_heads", "head_dim"))
    b.normal("wv", (d, nkv, hd), ("embed", "kv_heads", "head_dim"))
    b.normal("wo", (nq, hd, d), ("heads", "head_dim", "embed"))
    if cfg.qkv_bias:
        b.zeros("bq", (nq, hd), ("heads", "head_dim"))
        b.zeros("bk", (nkv, hd), ("kv_heads", "head_dim"))
        b.zeros("bv", (nkv, hd), ("kv_heads", "head_dim"))
    if cfg.qk_norm:
        b.ones("q_norm", (hd,), ("head_dim",))
        b.ones("k_norm", (hd,), ("head_dim",))


def _qkv(params, cfg: ModelConfig, x, kv_x):
    """The projections (and biases) of q from ``x`` and of k, v from
    ``kv_x``, on the heads and head_dim columns ``params`` holds."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q, k, v


def _norm_rope(cfg: ModelConfig, q, k, q_norm, k_norm, positions,
               kv_positions, rope: bool):
    """qk-norm where the config has it, then RoPE at the given positions
    when ``rope`` and the config has it (whole heads)."""
    if cfg.qk_norm:
        q = head_rms_norm(q, q_norm, cfg.norm_eps)
        k = head_rms_norm(k, k_norm, cfg.norm_eps)
    if rope and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
    return q, k


def _project_qkv(params, cfg: ModelConfig, x, kv_x, positions, kv_positions,
                 rope: bool):
    """q from ``x``, k and v from ``kv_x`` ([B, S, D] each); RoPE at the
    given positions when ``rope`` and the config has it."""
    q, k, v = _qkv(params, cfg, x, kv_x)
    q, k = _norm_rope(cfg, q, k, params.get("q_norm"), params.get("k_norm"),
                      positions, kv_positions, rope)
    return q, k, v


def _sdpa(q, k, v, mask):
    """q: [B,Sq,Hq,hd] k,v: [B,Sk,Hkv,hd] mask: [B,1,Sq,Sk] bool or None
    (every key visible). Query head i reads kv head i // (Hq / Hkv)."""
    b_, sq, hq, hd = q.shape
    hkv = k.shape[2]
    q = q.reshape(b_, sq, hkv, hq // hkv, hd)
    scores = torch.einsum("bqhgk,bshk->bhgqs", q, k).float() / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask[:, :, None], -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqs,bshk->bqhgk", probs, v)
    return out.reshape(b_, sq, hq, hd)


def _flash_heads(q, k, v, *, causal: bool, window: int = 0):
    """q [B, Sq, Hq, hd] over k, v [B, Sk, Hkv, hd] through the flash
    kernel -> [B, Sq, Hq, hd]. k and v are expanded to the query heads
    (``repeat_interleave``, the reference's (kv head, group) order) and the
    kernel reads q, k, v in their [B, S, H, hd] layout through a
    transposed view."""
    group = q.shape[2] // k.shape[2]
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    q, k, v = (t.contiguous().transpose(1, 2) for t in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    return out.transpose(1, 2)


def _flash(params, cfg: ModelConfig, q, k, v, *, causal: bool,
           window: int = 0):
    """``_flash_heads`` projected by ``wo`` to [B, Sq, D]."""
    out = _flash_heads(q, k, v, causal=causal, window=window)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def attention(params, cfg: ModelConfig, x, positions, *, window: int = 0):
    """Prefill self-attention. x: [B,S,D], positions: [B,S]."""
    q, k, v = _project_qkv(params, cfg, x, x, positions, positions,
                           rope=True)
    return _flash(params, cfg, q, k, v, causal=True, window=window)


def cross_attention(params, cfg: ModelConfig, x, enc_out):
    """Prefill cross-attention of the decoder states x [B, S, D] over the
    encoder states enc_out [B, F, D]: no mask, no rope; the flash kernel
    with k and v of length F."""
    q, k, v = _project_qkv(params, cfg, x, enc_out, None, None, rope=False)
    return _flash(params, cfg, q, k, v, causal=False)


def decode_cross_attention(params, cfg: ModelConfig, x, enc_out):
    """``cross_attention`` for one decode step (x [B, 1, D]): plain
    ``_sdpa``, as the port's decode self-attention."""
    q, k, v = _project_qkv(params, cfg, x, enc_out, None, None, rope=False)
    out = _sdpa(q, k, v, None)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"])


def bidirectional_attention(params, cfg: ModelConfig, x):
    """Encoder self-attention (whisper's encoder): no mask, no rope."""
    q, k, v = _project_qkv(params, cfg, x, x, None, None, rope=False)
    return _flash(params, cfg, q, k, v, causal=False)


# ---------------------------------------------------------------------------
# Decode path with KV cache
# ---------------------------------------------------------------------------

def kv_cache_axes():
    # kv_heads -> model when divisible, else head_dim picks up the model
    # axis (resolve_spec fallback chain) — critical for decode cache memory.
    ax = ("batch", "seq", "kv_heads", "head_dim")
    return {"k": ax, "v": ax}


def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, window: int,
                  device):
    """One layer's cache on ``device``. Sliding-window layers use a ring
    buffer of size ``window``."""
    cache_len = min(seq_len, window) if window > 0 else seq_len
    shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    dt = torch_dtype(cfg.dtype)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attention(params, cfg: ModelConfig, x, cache, pos: int, *,
                     window: int = 0):
    """One-token decode. x: [B,1,D]; cache k/v: [B,C,Hkv,hd]; pos: the
    current absolute position. Writes the new k and v into ``cache`` in
    place (the reference returns an updated copy) and returns
    (out [B,1,D], cache)."""
    b_ = x.shape[0]
    positions = torch.full((b_, 1), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, cfg, x, x, positions, positions,
                                   rope=True)
    slot, mask = _cache_slot(pos, cache["k"].shape[1], window, x.device)
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    out = _sdpa(q, cache["k"], cache["v"], mask)
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache


def _cache_slot(pos: int, cache_len: int, window: int, device):
    """The cache slot position ``pos`` writes (a ring buffer for a sliding
    window) and the [1, 1, 1, C] mask of the entries its query reads:
    written so far and inside the window."""
    if window == 0 and pos >= cache_len:
        raise IndexError(f"decode position {pos} past the cache ({cache_len})")
    slot = pos % cache_len if window > 0 else pos
    idx = torch.arange(cache_len, device=device)
    if window > 0:
        valid = (idx <= pos % cache_len) | (pos >= cache_len)
    else:
        valid = idx <= pos
    return slot, valid[None, None, None, :]


# ---------------------------------------------------------------------------
# Tensor parallelism (``sharding.TensorParallel``; ``params`` one layer's
# placed attention leaves, x and kv_x ``Act``s whole on each shard)
# ---------------------------------------------------------------------------

def _project_tp(tp, params, cfg: ModelConfig, x, kv_x, positions,
                kv_positions, rope: bool):
    """Each shard's q, k, v as ``Act``s: q on the shard's query heads
    (split along dim 2) or on every head (whole), whole head_dim; k, v on
    the shard's kv heads (split along dim 2) or every kv head, whole
    head_dim (gathered along it after the projection where ``wk`` splits
    it)."""
    hd = cfg.head_dim
    qkv = tp.each(lambda j: _qkv(tp.params(params, j), cfg, x.parts[j],
                                 kv_x.parts[j]))

    def act(i, full_heads):
        parts = [t[i] for t in qkv]
        if parts[0].shape[-1] < hd:                  # head_dim on the axis
            return tp.all_gather(Act(parts, split=3))
        return Act(parts, split=2 if parts[0].shape[2] < full_heads
                   else None)
    q = act(0, cfg.num_heads)
    k = act(1, cfg.num_kv_heads)
    v = act(2, cfg.num_kv_heads)
    def norm_rope(j):
        return _norm_rope(
            cfg, q.parts[j], k.parts[j],
            tp.read(params["q_norm"], j) if cfg.qk_norm else None,
            tp.read(params["k_norm"], j) if cfg.qk_norm else None,
            None if positions is None else positions.to(tp.devices[j]),
            None if kv_positions is None else kv_positions.to(
                tp.devices[j]), rope)
    qk = tp.each(norm_rope)
    return (Act([t[0] for t in qk], q.split),
            Act([t[1] for t in qk], k.split), v)


def _kv_for(cfg: ModelConfig, q, k, j):
    """Shard j's k (or v) for its query heads: its own kv heads where both
    split (each q head's kv head is local), else the kv head of each of
    its q heads (index h // group)."""
    if k.split == 2:
        return k.parts[j]
    hq = q.parts[j].shape[2]
    h0 = j * hq if q.split == 2 else 0
    g = cfg.num_heads // cfg.num_kv_heads
    if k.parts[j].shape[2] == 1:
        return k.parts[j]
    idx = torch.arange(h0, h0 + hq, device=k.parts[j].device) // g
    return k.parts[j].index_select(2, idx)


def _out_tp(tp, params, cfg: ModelConfig, out):
    """``wo`` on each shard's attention output (a list): row-parallel over
    the heads or over head_dim (a partial sum), or whole (replicated)."""
    hd = cfg.head_dim

    def one(j):
        wo = tp.params(params, j)["wo"]
        o = out[j]
        if wo.shape[1] < hd:
            o = o[..., j * wo.shape[1]:(j + 1) * wo.shape[1]]
        return torch.einsum("bshk,hkd->bsd", o, wo)
    parts = tp.each(one)
    wo = tp.params(params, 0)["wo"]
    partial = wo.shape[0] < cfg.num_heads or wo.shape[1] < hd
    return Act(parts, partial=partial)


def _attend_tp(tp, params, cfg: ModelConfig, x, kv_x, positions,
               kv_positions, rope, core):
    q, k, v = _project_tp(tp, params, cfg, x, kv_x, positions, kv_positions,
                          rope)
    out = tp.each(lambda j: core(q.parts[j], _kv_for(cfg, q, k, j),
                                 _kv_for(cfg, q, v, j)))
    return _out_tp(tp, params, cfg, out)


def attention_tp(tp, params, cfg: ModelConfig, x, positions, *,
                 window: int = 0):
    """``attention`` by model shard: partial sums (an ``Act``), or whole
    outputs where the heads and head_dim stay replicated."""
    return _attend_tp(tp, params, cfg, x, x, positions, positions, True,
                      lambda q, k, v: _flash_heads(q, k, v, causal=True,
                                                   window=window))


def cross_attention_tp(tp, params, cfg: ModelConfig, x, enc_out):
    return _attend_tp(tp, params, cfg, x, enc_out, None, None, False,
                      lambda q, k, v: _flash_heads(q, k, v, causal=False))


def bidirectional_attention_tp(tp, params, cfg: ModelConfig, x):
    return _attend_tp(tp, params, cfg, x, x, None, None, False,
                      lambda q, k, v: _flash_heads(q, k, v, causal=False))


def decode_cross_attention_tp(tp, params, cfg: ModelConfig, x, enc_out):
    return _attend_tp(tp, params, cfg, x, enc_out, None, None, False,
                      lambda q, k, v: _sdpa(q, k, v, None))


def decode_attention_tp(tp, params, cfg: ModelConfig, x, caches, pos: int,
                        *, window: int = 0):
    """``decode_attention`` by model shard over each shard's cache block
    (``caches[j]``: k, v [B, C, Hkv / tp, hd] or [B, C, Hkv, hd / tp] or
    whole), written in place. A head_dim block's partial scores are
    all-reduced; the cache is never gathered. Returns an ``Act`` of
    partial sums (or whole outputs)."""
    hd = cfg.head_dim
    b_ = x.parts[0].shape[0]
    positions = torch.full((b_, 1), pos, dtype=torch.long,
                           device=x.parts[0].device)
    q, k_new, v_new = _project_tp(tp, params, cfg, x, x, positions,
                                  positions, True)
    slot, mask = _cache_slot(pos, caches[0]["k"].shape[1], window,
                             x.parts[0].device)
    hd_loc = caches[0]["k"].shape[3]

    def write(j):
        for name, new in (("k", k_new), ("v", v_new)):
            t = new.parts[j][:, 0]
            if hd_loc < hd:
                t = t[..., j * hd_loc:(j + 1) * hd_loc]
            caches[j][name][:, slot] = t
    tp.each(write)
    if hd_loc == hd:
        out = tp.each(lambda j: _sdpa(q.parts[j], _cache_for(
            cfg, q, caches[j]["k"], j), _cache_for(cfg, q, caches[j]["v"],
                                                   j), mask))
        return _out_tp(tp, params, cfg, out)

    # the cache's head_dim is split: partial scores, all-reduced
    if q.split == 2:
        q = tp.all_gather(q)
    hkv, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads

    def scores(j):
        qj = q.parts[j][..., j * hd_loc:(j + 1) * hd_loc]
        qj = qj.reshape(b_, 1, hkv, g, hd_loc)
        return torch.einsum("bqhgk,bshk->bhgqs", qj,
                            caches[j]["k"]).float()
    s = tp.all_reduce(Act(tp.each(scores), partial=True))

    def attend(j):
        sc = s.parts[j] / math.sqrt(hd)
        sc = sc.masked_fill(~mask.to(sc.device)[:, :, None], -1e30)
        probs = torch.softmax(sc, dim=-1).to(caches[j]["v"].dtype)
        o = torch.einsum("bhgqs,bshk->bqhgk", probs, caches[j]["v"])
        return o.reshape(b_, 1, cfg.num_heads, hd_loc)
    o = Act(tp.each(attend), split=3)
    wo = tp.params(params, 0)["wo"]
    if wo.shape[1] < hd:                       # wo row-parallel on head_dim
        return Act(tp.each(lambda j: torch.einsum(
            "bshk,hkd->bsd", o.parts[j], tp.params(params, j)["wo"])),
            partial=True)
    o = tp.all_gather(o)
    hq = wo.shape[0]

    def proj(j):
        oj = o.parts[j][:, :, j * hq:(j + 1) * hq] if hq < cfg.num_heads \
            else o.parts[j]
        return torch.einsum("bshk,hkd->bsd", oj, tp.params(params, j)["wo"])
    return Act(tp.each(proj), partial=hq < cfg.num_heads)


def _cache_for(cfg: ModelConfig, q, cache, j):
    """Shard j's cache block for its query heads (``_kv_for`` on a cache
    whose head_dim is whole)."""
    split = 2 if cache.shape[2] < cfg.num_kv_heads else None
    return _kv_for(cfg, q, Act([cache] * len(q.parts), split=split), j) \
        if split is None else cache
