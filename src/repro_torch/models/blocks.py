"""Block assembly: pre-norm residual blocks of four kinds (attention +
dense MLP, attention + MoE, mamba, mamba + MoE) and the layer stack (the
port of ``repro.models.blocks``).

The parameter tree is the reference's: the schedule is factored into
``prefix + pattern * repeats``; prefix layers live under ``prefix``, the
repeated pattern's parameters under ``scan`` with a leading layer axis
(when ``cfg.scan_layers``), and the rest under ``layers``. The reference's
``lax.scan`` over the stacked axis becomes a Python loop that indexes it,
which takes views, not copies; the decode caches are stacked the same way
and every layer updates its views in place. With ``cfg.remat`` each repeat
of the scanned pattern runs under ``torch.utils.checkpoint`` when a
gradient is taken (the reference's ``jax.checkpoint`` of the scan body):
its activations are recomputed in the backward, so its kernels launch
again there. With ``cross`` (whisper's decoder) every block also holds
``ln_x`` and a cross-attention ``xattn`` over the encoder states
``enc_out``, applied between its attention and its FFN.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding
from repro_torch.config import ATTN_DENSE, ATTN_MOE, MAMBA_MOE, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (Builder, gelu_mlp, init_gelu_mlp,
                                       init_mlp, mlp, rms_norm)

ATTN_KINDS = (ATTN_DENSE, ATTN_MOE)
MOE_KINDS = (ATTN_MOE, MAMBA_MOE)


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


# ---------------------------------------------------------------------------
# Schedule factoring
# ---------------------------------------------------------------------------

def factor_schedule(schedule: Tuple[str, ...]):
    """Return (prefix_len, pattern, repeats) with schedule ==
    schedule[:prefix] + pattern * repeats, minimizing prefix then pattern."""
    n = len(schedule)
    best = (n, tuple(schedule), 1)          # fallback: all prefix... repeats 1
    for prefix in range(0, min(n, 4)):
        rem = schedule[prefix:]
        m = len(rem)
        if m == 0:
            continue
        for p in range(1, m + 1):
            if m % p:
                continue
            if rem == rem[:p] * (m // p):
                cand = (prefix, rem[:p], m // p)
                # prefer more repeats (smaller pattern), then smaller prefix
                if (len(cand[1]), cand[0]) < (len(best[1]), best[0]):
                    best = cand
                break
    return best


def _scanned(cfg: ModelConfig, repeats: int) -> bool:
    return cfg.scan_layers and repeats > 1


# ---------------------------------------------------------------------------
# Single block init / apply
# ---------------------------------------------------------------------------

def init_block(b: Builder, cfg: ModelConfig, kind: str, cross: bool = False):
    b.ones("ln1", (cfg.d_model,))
    if kind in ATTN_KINDS:
        attn_mod.init_attention(b.sub("attn"), cfg)
    else:
        ssm_mod.init_ssm(b.sub("ssm"), cfg)
    if cross:
        b.ones("ln_x", (cfg.d_model,))
        attn_mod.init_attention(b.sub("xattn"), cfg, cross=True)
    if kind in MOE_KINDS:
        b.ones("ln2", (cfg.d_model,))
        moe_mod.init_moe(b.sub("moe"), cfg)
    elif cfg.d_ff > 0:
        b.ones("ln2", (cfg.d_model,))
        if cfg.mlp_gelu:
            init_gelu_mlp(b.sub("mlp"), cfg.d_model, cfg.d_ff)
        else:
            init_mlp(b.sub("mlp"), cfg.d_model, cfg.d_ff)


def _ffn(params, cfg: ModelConfig, kind: str, x, moe_strategy: str):
    """The block's second residual branch: (x + ffn(norm(x)), aux)."""
    if kind in MOE_KINDS:
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        h, aux = moe_mod.moe_ffn(params["moe"], cfg, h, strategy=moe_strategy)
        return x + h, aux
    if cfg.d_ff > 0:
        h = rms_norm(x, params["ln2"], cfg.norm_eps)
        ffn = gelu_mlp if cfg.mlp_gelu else mlp
        x = x + ffn(params["mlp"], h)
    return x, None


def block_apply(params, cfg: ModelConfig, kind: str, x, positions, aux,
                *, window: int = 0, enc_out=None, moe_strategy="grouped"):
    """Prefill. x: [B,S,D] -> (x, aux); ``enc_out`` [B,F,D] runs the
    block's cross-attention."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        h = attn_mod.attention(params["attn"], cfg, h, positions,
                               window=window)
    else:
        h = ssm_mod.ssm_block(params["ssm"], cfg, h)
    x = x + h
    if enc_out is not None:
        h = rms_norm(x, params["ln_x"], cfg.norm_eps)
        x = x + attn_mod.cross_attention(params["xattn"], cfg, h, enc_out)
    x, moe_aux = _ffn(params, cfg, kind, x, moe_strategy)
    return x, aux if moe_aux is None else aux + moe_aux


def block_decode(params, cfg: ModelConfig, kind: str, x, cache, pos: int,
                 *, window: int = 0, enc_out=None, moe_strategy="dense"):
    """One-token decode. x: [B,1,D] -> (x, cache), the cache updated in
    place."""
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if kind in ATTN_KINDS:
        h, cache = attn_mod.decode_attention(params["attn"], cfg, h, cache,
                                             pos, window=window)
    else:
        h, cache = ssm_mod.ssm_decode_step(params["ssm"], cfg, h, cache)
    x = x + h
    if enc_out is not None:
        h = rms_norm(x, params["ln_x"], cfg.norm_eps)
        x = x + attn_mod.decode_cross_attention(params["xattn"], cfg, h,
                                                enc_out)
    x, _ = _ffn(params, cfg, kind, x, moe_strategy)
    return x, cache


# ---------------------------------------------------------------------------
# Stack init: prefix blocks + per-position stacked pattern params
# ---------------------------------------------------------------------------

def init_stack(b: Builder, cfg: ModelConfig, cross: bool = False):
    schedule = cfg.block_schedule()
    prefix_len, pattern, repeats = factor_schedule(schedule)
    pb = b.sub("prefix")
    for i in range(prefix_len):
        init_block(pb.sub(str(i)), cfg, schedule[i], cross)
    if _scanned(cfg, repeats):
        # allocate each stacked leaf once, then draw one layer's slice at a
        # time into it (peak memory: the model plus one slice's fp32 draw)
        sb = b.sub("scan")
        for pos, kind in enumerate(pattern):
            shapes = Builder(None, b.dtype, abstract=True)
            init_block(shapes, cfg, kind, cross)
            stacked = tree_map(lambda t: b.empty((repeats,) + t.shape),
                               shapes.params)
            if not b.abstract:
                for r in range(repeats):
                    init_block(Builder(b.gen, b.dtype, b.device,
                                       into=tree_map(lambda t: t[r],
                                                     stacked)), cfg, kind,
                               cross)
            sb.params[str(pos)] = stacked
    else:
        lb = b.sub("layers")
        for i in range(prefix_len, len(schedule)):
            init_block(lb.sub(str(i)), cfg, schedule[i], cross)
    return prefix_len, pattern, repeats


def _layers(params, cfg: ModelConfig):
    """(params, kind) of every layer in order; a scanned layer's params are
    views into the stacked leaves."""
    schedule = cfg.block_schedule()
    prefix_len, pattern, repeats = factor_schedule(schedule)
    out = [(params["prefix"][str(i)], schedule[i]) for i in range(prefix_len)]
    if _scanned(cfg, repeats):
        for r in range(repeats):
            for pos, kind in enumerate(pattern):
                out.append((tree_map(lambda t: t[r], params["scan"][str(pos)]),
                            kind))
    else:
        out += [(params["layers"][str(i)], schedule[i])
                for i in range(prefix_len, len(schedule))]
    return out


def stack_apply(params, cfg: ModelConfig, x, positions, *, window: int = 0,
                enc_out=None, moe_strategy="grouped"):
    """Apply the whole layer stack. Returns (x, aux_loss).

    With ``cfg.remat`` on a scanned stack, while grad is enabled, each
    repeat of the pattern runs under ``checkpoint(..., use_reentrant=False)``
    (the reference checkpoints its scan body); the prefix layers run
    outside it, as in the reference. No random op runs in a block, so no
    RNG state is kept for the recompute."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    schedule = cfg.block_schedule()
    prefix_len, pattern, repeats = factor_schedule(schedule)
    if not (cfg.remat and _scanned(cfg, repeats)
            and torch.is_grad_enabled()):
        for p, kind in _layers(params, cfg):
            x, aux = block_apply(p, cfg, kind, x, positions, aux,
                                 window=window, enc_out=enc_out,
                                 moe_strategy=moe_strategy)
        return x, aux
    for i in range(prefix_len):
        x, aux = block_apply(params["prefix"][str(i)], cfg, schedule[i], x,
                             positions, aux, window=window, enc_out=enc_out,
                             moe_strategy=moe_strategy)

    # the recompute runs in the backward, which the autograd engine runs on
    # a thread of its own for a card: it takes the forward's sharding
    # context (expert parallelism's mesh) with it
    ctx = sharding._ctx()
    mesh, rules = ctx.mesh, ctx.rules

    def body(r, x, aux):
        with sharding.logical_rules(mesh, rules):
            for pos, kind in enumerate(pattern):
                p = tree_map(lambda t: t[r], params["scan"][str(pos)])
                x, aux = block_apply(p, cfg, kind, x, positions, aux,
                                     window=window, enc_out=enc_out,
                                     moe_strategy=moe_strategy)
        return x, aux
    for r in range(repeats):
        x, aux = checkpoint(body, r, x, aux, use_reentrant=False,
                            preserve_rng_state=False)
    return x, aux


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, seq_len: int,
                     window: int, device):
    if kind in ATTN_KINDS:
        return attn_mod.init_kv_cache(cfg, batch, seq_len, window, device)
    return ssm_mod.init_ssm_cache(cfg, batch, device)


def init_stack_cache(cfg: ModelConfig, batch: int, seq_len: int,
                     window: int, device):
    """Every layer's cache by its kind (a KV cache or the conv window and
    SSD state), stacked per pattern position for a scanned stack."""
    schedule = cfg.block_schedule()
    prefix_len, pattern, repeats = factor_schedule(schedule)

    def one(kind):
        return init_block_cache(cfg, kind, batch, seq_len, window, device)
    cache = {"prefix": {str(i): one(schedule[i]) for i in range(prefix_len)}}
    if _scanned(cfg, repeats):
        cache["scan"] = {str(pos): tree_map(
            lambda t: torch.stack([t] * repeats), one(kind))
            for pos, kind in enumerate(pattern)}
    else:
        cache["layers"] = {str(i): one(schedule[i])
                           for i in range(prefix_len, len(schedule))}
    return cache


def _layer_caches(cache, cfg: ModelConfig):
    """Every layer's cache in order, matching ``_layers``; a scanned
    layer's cache is a view into the stacked buffers."""
    schedule = cfg.block_schedule()
    prefix_len, pattern, repeats = factor_schedule(schedule)
    out = [cache["prefix"][str(i)] for i in range(prefix_len)]
    if _scanned(cfg, repeats):
        for r in range(repeats):
            for pos in range(len(pattern)):
                out.append(tree_map(lambda t: t[r], cache["scan"][str(pos)]))
    else:
        out += [cache["layers"][str(i)]
                for i in range(prefix_len, len(schedule))]
    return out


def stack_decode(params, cfg: ModelConfig, x, cache, pos: int, *,
                 window: int = 0, enc_out=None, moe_strategy="dense"):
    """One-token decode through every layer; ``cache`` is updated in place
    and returned."""
    for (p, kind), c in zip(_layers(params, cfg), _layer_caches(cache, cfg)):
        x, _ = block_decode(p, cfg, kind, x, c, pos, window=window,
                            enc_out=enc_out, moe_strategy=moe_strategy)
    return x, cache
