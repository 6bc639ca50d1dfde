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

The ``*_axes`` functions give the reference's logical-axes trees (the
scanned stack's leaves with "layers" leading); ``*_layouts`` the mixer's
per-head column layouts (``ssm.head_layout``). Under tensor parallelism
(``stack_apply_tp``, ``stack_decode_tp``; ``sharding.TensorParallel``) the
residual stream is an ``Act`` in the layout of ("batch", "act_seq",
"embed"): split along the sequence where "act_seq" resolves to "model"
(sequence parallelism: each block's norms run on sequence shards, the
branch input is all-gathered and its partial sums reduce-scattered, the
reference's sites :88 and :102), else whole on every shard with the
partial sums all-reduced. Decode has no sequence axis: all-reduces.
Under remat the recompute carries the mesh, the rules and the placement
into the autograd engine's thread.
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
from repro_torch.models.layers import (Builder, gelu_mlp, gelu_mlp_tp,
                                       init_gelu_mlp, init_mlp, mlp, mlp_tp,
                                       rms_norm, rms_norm_tp)
from repro_torch.sharding import Act, Placed

ATTN_KINDS = (ATTN_DENSE, ATTN_MOE)
MOE_KINDS = (ATTN_MOE, MAMBA_MOE)


def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of equal structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _at(t, r: int):
    """Layer r of a stacked leaf (a tensor or a ``Placed``)."""
    return t.select(r) if isinstance(t, Placed) else t[r]


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
    b.ones("ln1", (cfg.d_model,), ("embed",))
    if kind in ATTN_KINDS:
        attn_mod.init_attention(b.sub("attn"), cfg)
    else:
        ssm_mod.init_ssm(b.sub("ssm"), cfg)
    if cross:
        b.ones("ln_x", (cfg.d_model,), ("embed",))
        attn_mod.init_attention(b.sub("xattn"), cfg, cross=True)
    if kind in MOE_KINDS:
        b.ones("ln2", (cfg.d_model,), ("embed",))
        moe_mod.init_moe(b.sub("moe"), cfg)
    elif cfg.d_ff > 0:
        b.ones("ln2", (cfg.d_model,), ("embed",))
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
            sb.axes[str(pos)] = tree_map(lambda a: ("layers",) + a,
                                         shapes.axes)
            sb.layouts[str(pos)] = shapes.layouts
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
                out.append((tree_map(lambda t: _at(t, r),
                                     params["scan"][str(pos)]), kind))
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
    # context (the mesh expert parallelism and the placement read) with it
    ctx = sharding._ctx()
    mesh, rules = ctx.mesh, ctx.rules

    def body(r, x, aux):
        with sharding.logical_rules(mesh, rules):
            for pos, kind in enumerate(pattern):
                p = tree_map(lambda t: _at(t, r), params["scan"][str(pos)])
                x, aux = block_apply(p, cfg, kind, x, positions, aux,
                                     window=window, enc_out=enc_out,
                                     moe_strategy=moe_strategy)
        return x, aux
    for r in range(repeats):
        x, aux = checkpoint(body, r, x, aux, use_reentrant=False,
                            preserve_rng_state=False)
    return x, aux


def block_cache_axes(kind: str):
    if kind in ATTN_KINDS:
        return attn_mod.kv_cache_axes()
    return ssm_mod.ssm_cache_axes()


def _block_cache_layouts(cfg: ModelConfig, kind: str):
    return {} if kind in ATTN_KINDS else ssm_mod.ssm_cache_layouts(cfg)


def _stack_tree(cfg: ModelConfig, one, stacked):
    """A per-layer tree by kind (``one(kind)``) over the stack's layout,
    ``stacked`` applied to each scanned position's."""
    schedule = cfg.block_schedule()
    prefix_len, pattern, repeats = factor_schedule(schedule)
    out = {"prefix": {str(i): one(schedule[i]) for i in range(prefix_len)}}
    if _scanned(cfg, repeats):
        out["scan"] = {str(pos): stacked(one(kind))
                       for pos, kind in enumerate(pattern)}
    else:
        out["layers"] = {str(i): one(schedule[i])
                         for i in range(prefix_len, len(schedule))}
    return out


def stack_cache_axes(cfg: ModelConfig):
    return _stack_tree(cfg, block_cache_axes, lambda t: tree_map(
        lambda a: ("layers",) + a, t))


def stack_cache_layouts(cfg: ModelConfig):
    return _stack_tree(cfg, lambda k: _block_cache_layouts(cfg, k),
                       lambda t: t)


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
                out.append(tree_map(lambda t: _at(t, r),
                                    cache["scan"][str(pos)]))
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


# ---------------------------------------------------------------------------
# Tensor parallelism (``sharding.TensorParallel``)
# ---------------------------------------------------------------------------

def _add(x, y):
    return Act([a + b.to(a.device) for a, b in zip(x.parts, y.parts)],
               split=x.split)


def _ffn_tp(tp, params, cfg: ModelConfig, kind: str, h, moe_strategy):
    """The FFN branch on h (whole on each shard): (an ``Act``, aux)."""
    if kind in MOE_KINDS:
        return moe_mod.moe_ffn_tp(tp, params["moe"], cfg, h,
                                  strategy=moe_strategy)
    ps = [tp.params(params["mlp"], j) for j in range(tp.size)]
    if cfg.mlp_gelu:
        return gelu_mlp_tp(tp, ps, h, cfg.d_ff), None
    return mlp_tp(tp, ps, h, cfg.d_ff), None


def _norm(tp, params, name, x, cfg):
    return rms_norm_tp(tp, x, [tp.params(params, j) for j in range(tp.size)],
                       name, cfg.norm_eps)


def block_apply_tp(tp, params, cfg: ModelConfig, kind: str, x, positions,
                   aux, *, window: int = 0, enc_out=None,
                   moe_strategy="grouped"):
    """``block_apply`` on each model shard. x: an ``Act`` in the residual
    layout ("batch", "act_seq", "embed"); ``enc_out`` an ``Act`` whole on
    each shard."""
    def resid(x, y):
        return _add(x, tp.constrain(y, "batch", "act_seq", "embed"))
    h = tp.whole(_norm(tp, params, "ln1", x, cfg))
    if kind in ATTN_KINDS:
        y = attn_mod.attention_tp(tp, params["attn"], cfg, h, positions,
                                  window=window)
    else:
        y = ssm_mod.ssm_block_tp(tp, params["ssm"], cfg, h)
    x = resid(x, y)
    if enc_out is not None:
        h = tp.whole(_norm(tp, params, "ln_x", x, cfg))
        x = resid(x, attn_mod.cross_attention_tp(tp, params["xattn"], cfg,
                                                 h, enc_out))
    if kind in MOE_KINDS or cfg.d_ff > 0:
        h = tp.whole(_norm(tp, params, "ln2", x, cfg))
        y, moe_aux = _ffn_tp(tp, params, cfg, kind, h, moe_strategy)
        x = resid(x, y)
        if moe_aux is not None:
            aux = aux + moe_aux.to(aux.device)
    return x, aux


def block_decode_tp(tp, params, cfg: ModelConfig, kind: str, x, caches,
                    pos: int, *, window: int = 0, enc_out=None,
                    moe_strategy="dense"):
    """``block_decode`` on each model shard; x an ``Act`` whole on each,
    ``caches[j]`` shard j's blocks of the layer's cache (written in
    place)."""
    h = _norm(tp, params, "ln1", x, cfg)
    if kind in ATTN_KINDS:
        y = attn_mod.decode_attention_tp(tp, params["attn"], cfg, h, caches,
                                         pos, window=window)
    else:
        y = ssm_mod.ssm_decode_step_tp(tp, params["ssm"], cfg, h, caches)
    x = _add(x, tp.whole(y))
    if enc_out is not None:
        h = _norm(tp, params, "ln_x", x, cfg)
        x = _add(x, tp.whole(attn_mod.decode_cross_attention_tp(
            tp, params["xattn"], cfg, h, enc_out)))
    if kind in MOE_KINDS or cfg.d_ff > 0:
        h = _norm(tp, params, "ln2", x, cfg)
        y, _ = _ffn_tp(tp, params, cfg, kind, h, moe_strategy)
        x = _add(x, tp.whole(y))
    return x


def stack_apply_tp(tp, params, cfg: ModelConfig, x, positions, *,
                   window: int = 0, enc_out=None, moe_strategy="grouped"):
    """``stack_apply`` under tensor parallelism (x an ``Act``): the same
    layers, prefix and remat."""
    aux = torch.zeros((), dtype=torch.float32, device=tp.devices[0])
    schedule = cfg.block_schedule()
    prefix_len, pattern, repeats = factor_schedule(schedule)
    kw = dict(window=window, enc_out=enc_out, moe_strategy=moe_strategy)
    if not (cfg.remat and _scanned(cfg, repeats)
            and torch.is_grad_enabled()):
        for p, kind in _layers(params, cfg):
            x, aux = block_apply_tp(tp, p, cfg, kind, x, positions, aux, **kw)
        return x, aux
    for i in range(prefix_len):
        x, aux = block_apply_tp(tp, params["prefix"][str(i)], cfg,
                                schedule[i], x, positions, aux, **kw)
    ctx = sharding._ctx()
    mesh, rules = ctx.mesh, ctx.rules

    def body(r, parts, aux):
        with sharding.logical_rules(mesh, rules):
            y = Act(parts, split=x.split)
            for pos, kind in enumerate(pattern):
                p = tree_map(lambda t: _at(t, r), params["scan"][str(pos)])
                y, aux = block_apply_tp(tp, p, cfg, kind, y, positions, aux,
                                        **kw)
        return tuple(y.parts), aux
    for r in range(repeats):
        parts, aux = checkpoint(body, r, list(x.parts), aux,
                                use_reentrant=False, preserve_rng_state=False)
        x = Act(list(parts), split=x.split)
    return x, aux


def stack_decode_tp(tp, params, cfg: ModelConfig, x, cache, pos: int, *,
                    window: int = 0, enc_out=None, moe_strategy="dense"):
    """``stack_decode`` under tensor parallelism over a placed cache."""
    for (p, kind), c in zip(_layers(params, cfg), _layer_caches(cache, cfg)):
        caches = [sharding.local(c, tp.coord(j)) for j in range(tp.size)]
        x = block_decode_tp(tp, p, cfg, kind, x, caches, pos, window=window,
                            enc_out=enc_out, moe_strategy=moe_strategy)
    return x
