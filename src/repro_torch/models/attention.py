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
"""
from __future__ import annotations

import math

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (Builder, apply_rope, head_rms_norm,
                                       torch_dtype)


def init_attention(b: Builder, cfg: ModelConfig, cross: bool = False):
    """One attention's leaves; ``cross`` (the reference's flag) gives a
    cross-attention the same ones."""
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    b.normal("wq", (d, nq, hd))
    b.normal("wk", (d, nkv, hd))
    b.normal("wv", (d, nkv, hd))
    b.normal("wo", (nq, hd, d))
    if cfg.qkv_bias:
        b.zeros("bq", (nq, hd))
        b.zeros("bk", (nkv, hd))
        b.zeros("bv", (nkv, hd))
    if cfg.qk_norm:
        b.ones("q_norm", (hd,))
        b.ones("k_norm", (hd,))


def _project_qkv(params, cfg: ModelConfig, x, kv_x, positions, kv_positions,
                 rope: bool):
    """q from ``x``, k and v from ``kv_x`` ([B, S, D] each); RoPE at the
    given positions when ``rope`` and the config has it."""
    q = torch.einsum("bsd,dhk->bshk", x, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", kv_x, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", kv_x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        q = head_rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = head_rms_norm(k, params["k_norm"], cfg.norm_eps)
    if rope and cfg.rope_theta > 0:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, kv_positions, cfg.rope_theta)
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


def _flash(params, cfg: ModelConfig, q, k, v, *, causal: bool,
           window: int = 0):
    """q [B, Sq, Hq, hd] over k, v [B, Sk, Hkv, hd] through the flash
    kernel, projected by ``wo`` to [B, Sq, D]. k and v are expanded to the
    query heads (``repeat_interleave``, the reference's (kv head, group)
    order) and the kernel reads q, k, v in their [B, S, H, hd] layout
    through a transposed view."""
    group = cfg.num_heads // cfg.num_kv_heads
    if group > 1:
        k = k.repeat_interleave(group, dim=2)
        v = v.repeat_interleave(group, dim=2)
    q, k, v = (t.contiguous().transpose(1, 2) for t in (q, k, v))
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    return torch.einsum("bshk,hkd->bsd", out.transpose(1, 2), params["wo"])


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
    cache_len = cache["k"].shape[1]
    if window == 0 and pos >= cache_len:
        raise IndexError(f"decode position {pos} past the cache ({cache_len})")
    slot = pos % cache_len if window > 0 else pos
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    # valid: ring-buffer entries written so far and inside the window
    idx = torch.arange(cache_len, device=x.device)
    if window > 0:
        valid = (idx <= pos % cache_len) | (pos >= cache_len)
    else:
        valid = idx <= pos
    out = _sdpa(q, cache["k"], cache["v"], valid[None, None, None, :])
    return torch.einsum("bshk,hkd->bsd", out, params["wo"]), cache
