"""Top-level models: the causal LM of the dense, moe, ssm, hybrid and vlm
families and the whisper-style encoder-decoder (the port of
``repro.models.model``):

    params = init_params(gen, cfg)          # gen: a torch.Generator
    shapes = abstract_params(cfg)           # meta tensors, no storage
    axes   = param_axes(cfg)                # logical axes, same structure
    logits, aux = forward(params, cfg, batch)
    loss, metrics = loss_fn(params, cfg, batch)   # batch with labels
    cache  = init_cache(cfg, batch, seq_len, device)  # None: the card
    enc_out = encode(params, cfg, frame_embeds)       # encoder-decoder
    logits, cache = decode_step(params, cfg, tokens, cache, pos,
                                enc_out=enc_out)

``batch`` is a dict with ``tokens`` [B, S], plus ``vision_embeds`` [B, V, D]
for the vlm family (the stubbed vision tower's patch embeddings, projected
and prepended to the text; the logits cover the text positions only) and
``frame_embeds`` [B, F, D] for the encoder-decoder (the stubbed conv
frontend's frames). The cache holds a KV cache per attention layer and a
conv window and SSD state per mamba layer. Decode is token-only for the vlm
family, as the reference's.

A placed parameter tree (``place_params``; ``sharding.Placed`` leaves) on
the active mesh runs tensor-parallel over its "model" axis
(``sharding.TensorParallel``): a vocabulary-parallel embedding (each
shard looks up its rows, the shards' sums reduce-scattered into the
residual layout), the blocks by shard (``blocks.stack_apply_tp``), a
vocabulary-parallel unembedding, tied or not, and in ``loss_fn`` a
parallel cross-entropy whose max, sum of exponents and target logit are
all-reduced over the shards: the [B, S, V] logits are never gathered.
``forward`` and ``decode_step`` gather their logits whole (the serve loop
and the tests read them). A vocabulary the model axis does not divide
(whisper's 51,865, granite-3-2b's 49,155, InternVL2-2B's 92,553) is
replicated, as the reference demotes it. On a mesh whose model axis is 1
the blocks run as the unplaced model does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.attention import (bidirectional_attention,
                                          bidirectional_attention_tp,
                                          init_attention)
from repro_torch.models.layers import (Builder, embed, embed_tp, gelu_mlp,
                                       gelu_mlp_tp, init_embed,
                                       init_gelu_mlp, rms_norm, rms_norm_tp,
                                       sinusoidal_at, sinusoidal_positions,
                                       torch_dtype, unembed, unembed_tp)
from repro_torch.sharding import Act


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_encoder(b: Builder, cfg: ModelConfig):
    """Whisper-style encoder: bidirectional attention + GELU MLP blocks over
    the (stubbed) conv frame embeddings."""
    for i in range(cfg.num_encoder_layers):
        lb = b.sub(str(i))
        lb.ones("ln1", (cfg.d_model,), ("embed",))
        init_attention(lb.sub("attn"), cfg)
        lb.ones("ln2", (cfg.d_model,), ("embed",))
        init_gelu_mlp(lb.sub("mlp"), cfg.d_model, cfg.d_ff)
    b.ones("ln_post", (cfg.d_model,), ("embed",))


def _init_vlm_projector(b: Builder, cfg: ModelConfig):
    """MLP projector from the (stubbed) vision embeddings, which arrive
    patch-embedded at d_model width, to the LM's space."""
    b.normal("w1", (cfg.d_model, cfg.d_model), ("embed", "mlp"))
    b.normal("w2", (cfg.d_model, cfg.d_model), ("mlp", "embed"))
    b.ones("ln", (cfg.d_model,), ("embed",))


def _build(gen, cfg: ModelConfig, abstract: bool = False):
    device = None if abstract else gen.device
    b = Builder(gen, torch_dtype(cfg.dtype), device, abstract)
    init_embed(b, cfg)
    if cfg.is_encoder_decoder:
        _init_encoder(b.sub("encoder"), cfg)
    if cfg.family == "vlm":
        _init_vlm_projector(b.sub("projector"), cfg)
    blocks.init_stack(b, cfg, cross=cfg.is_encoder_decoder)
    b.ones("ln_f", (cfg.d_model,), ("embed",))
    return b


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters drawn from ``gen``, on ``gen``'s device, in
    ``cfg.dtype``."""
    return _build(gen, cfg).params


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta tensors (shape and dtype, no storage)."""
    return _build(None, cfg, abstract=True).params


def param_axes(cfg: ModelConfig):
    """The logical-axes tree of the parameters (no allocation)."""
    return _build(None, cfg, abstract=True).axes


def param_layouts(cfg: ModelConfig):
    """The parameters' column layouts (the mixer's per-head columns,
    ``ssm.head_layout``), a tree of dicts holding only such leaves."""
    return _build(None, cfg, abstract=True).layouts


def cache_axes(cfg: ModelConfig):
    return blocks.stack_cache_axes(cfg)


def place_params(params, cfg: ModelConfig, mesh, rules):
    """A parameter tree placed by its logical axes on ``mesh`` under
    ``rules`` (``sharding.place_tree``)."""
    return sharding.place_tree(params, param_axes(cfg), mesh, rules,
                               layouts=param_layouts(cfg))


def place_cache(cache, cfg: ModelConfig, mesh, rules):
    """A decode cache placed by ``cache_axes``: cut along "model" only (the
    batch stays whole; its data axis is the counting pass's share)."""
    batch = sharding.axes_of(rules.get("batch"))
    return sharding.place_tree(cache, cache_axes(cfg), mesh, rules,
                               layouts=blocks.stack_cache_layouts(cfg),
                               skip=batch)


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _positions_table(s: int, cfg: ModelConfig, like):
    """The first ``s`` rows of the sinusoidal table in ``like``'s dtype, on
    its device."""
    return sinusoidal_positions(s, cfg.d_model, like.device, like.dtype)


def encode(params, cfg: ModelConfig, frames):
    """The encoder: frames [B, F, D] (the stubbed conv outputs, cast to
    the model's dtype) -> encoder states [B, F, D]. The serve loop runs it
    once per request batch and hands the states to every decode step."""
    tp = _tp(params)
    if tp is not None:
        return _encode_tp(tp, params, cfg, frames).parts[0]
    params = _plain(params)
    dt = params["embedding"].dtype
    x = frames.to(dt)
    x = x + _positions_table(x.shape[1], cfg, x)
    for i in range(cfg.num_encoder_layers):
        p = params["encoder"][str(i)]
        h = rms_norm(x, p["ln1"], cfg.norm_eps)
        x = x + bidirectional_attention(p["attn"], cfg, h)
        h = rms_norm(x, p["ln2"], cfg.norm_eps)
        x = x + gelu_mlp(p["mlp"], h)
    return rms_norm(x, params["encoder"]["ln_post"], cfg.norm_eps)


def _vlm_prefix(params, cfg: ModelConfig, vision_embeds):
    """The projector: norm, GELU (the tanh form, as ``jax.nn.gelu``)
    MLP."""
    p = params["projector"]
    h = rms_norm(vision_embeds, p["ln"], cfg.norm_eps)
    return F.gelu(h @ p["w1"], approximate="tanh") @ p["w2"]


def _embed_inputs(params, cfg: ModelConfig, batch):
    """Returns (x [B,S',D], positions [B,S'], text_offset, enc_out)."""
    tokens = batch["tokens"]
    x = embed(params, tokens)
    enc_out = None
    offset = 0
    if cfg.family == "vlm" and "vision_embeds" in batch:
        vis = _vlm_prefix(params, cfg, batch["vision_embeds"].to(x.dtype))
        x = torch.cat([vis, x], dim=1)
        offset = vis.shape[1]
    if cfg.is_encoder_decoder:
        enc_out = encode(params, cfg, batch["frame_embeds"])
        x = x + _positions_table(x.shape[1], cfg, x)[None]
    b_, s = x.shape[:2]
    positions = torch.arange(s, device=x.device).expand(b_, s)
    return x, positions, offset, enc_out


def forward(params, cfg: ModelConfig, batch, *, moe_strategy="grouped",
            whole_logits: bool = True):
    """Prefill forward. Returns (logits [B,S,V] of the text positions,
    aux_loss). Tensor-parallel with ``whole_logits=False`` the logits stay
    in their shards' layout (an ``Act`` over every position, prefix
    included: split along the vocabulary, or along the sequence where the
    vocabulary is replicated), as the reference's constraint leaves them;
    the dry run's prefill step reads them so."""
    tp = _tp(params)
    if tp is not None:
        logits, aux, offset = _forward_tp(tp, params, cfg, batch,
                                          moe_strategy)
        if not whole_logits:
            return logits, aux
        logits = tp.gather(logits)
        return (logits[:, offset:] if offset else logits), aux
    params = _plain(params)
    x, positions, offset, enc_out = _embed_inputs(params, cfg, batch)
    x, aux = blocks.stack_apply(params, cfg, x, positions,
                                window=cfg.sliding_window, enc_out=enc_out,
                                moe_strategy=moe_strategy)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(params, x, cfg.tie_embeddings)
    if offset:
        logits = logits[:, offset:]
    return logits, aux


def loss_fn(params, cfg: ModelConfig, batch, *, moe_strategy="grouped"):
    """Next-token cross-entropy (+ the MoE aux loss). ``batch`` holds
    ``tokens`` and ``labels`` [B, S]; labels below 0 are masked out.
    Returns (loss, {"ce", "aux"}).

    On the card every kernel runs under autograd as its forward with the
    plain version's gradient (``ops.flash_attention``, ``ops.ssd_chunk``;
    the routers' gates differentiated at the kernel's own picks,
    ``ops.moe_route_slots`` and ``ops.moe_router_topk``). On the CPU every
    family trains through the plain versions."""
    tp = _tp(params)
    if tp is not None:
        logits, aux, offset = _forward_tp(tp, params, cfg, batch,
                                          moe_strategy)
        ce = _parallel_ce(tp, logits, batch["labels"], offset)
        aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
        return ce + aux_w * aux, {"ce": ce, "aux": aux}
    logits, aux = forward(params, cfg, batch, moe_strategy=moe_strategy)
    logits = logits[:, :-1].float()
    targets = batch["labels"][:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    ll = logp.gather(-1, targets.clamp_min(0)[..., None])[..., 0]
    mask = (targets >= 0).float()
    ce = -(ll * mask).sum() / mask.sum().clamp_min(1.0)
    aux_w = cfg.moe.router_aux_weight if cfg.moe is not None else 0.0
    loss = ce + aux_w * aux
    return loss, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """The stack's decode cache (KV per attention layer, conv window and
    SSD state per mamba layer); ``device=None`` means the card (raises
    without one)."""
    return blocks.init_stack_cache(cfg, batch, seq_len,
                                   window=cfg.sliding_window,
                                   device=resolve_device(device))


def decode_step(params, cfg: ModelConfig, tokens, cache, pos: int, *,
                enc_out=None, batch=None, moe_strategy="dense"):
    """One-token decode. tokens: [B, 1]; pos: the absolute position. An
    encoder-decoder takes the encoder states ``enc_out`` (``encode``), or
    ``batch`` with ``frame_embeds`` to encode at this step. Returns
    (logits [B,1,V], cache), the cache updated in place. Tensor-parallel
    (a placed tree) over a placed cache (``place_cache``)."""
    tp = _tp(params)
    if tp is not None:
        return _decode_tp(tp, params, cfg, tokens, cache, pos, enc_out,
                          batch, moe_strategy), cache
    params = _plain(params)
    placed, cache = cache, _plain_cache(cache)
    x = embed(params, tokens)
    if cfg.is_encoder_decoder:
        if enc_out is None:
            enc_out = encode(params, cfg, batch["frame_embeds"])
        x = x + sinusoidal_at(pos, cfg.d_model, x.device).to(x.dtype)
    x, cache = blocks.stack_decode(params, cfg, x, cache, pos,
                                   window=cfg.sliding_window,
                                   enc_out=enc_out,
                                   moe_strategy=moe_strategy)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = unembed(params, x, cfg.tie_embeddings)
    return logits, (placed if sharding.is_placed(placed) else cache)


# ---------------------------------------------------------------------------
# Tensor parallelism (``sharding.TensorParallel``)
# ---------------------------------------------------------------------------

def _tp(params):
    """The ``TensorParallel`` of a placed tree whose model axis is > 1 and
    splits some parameter, else None. Where no parameter splits over the
    model axis (``pure_dp``) every shard would run the same whole step:
    the model axis is then a batch split like the data axis, and the step
    runs once on the whole batch, the counting pass giving a device its
    share (``costing.batch_split`` over the axes the rules put the batch
    on)."""
    tp = sharding.tensor_parallel(params)
    if tp is None or tp.size == 1:
        return None
    if not any(sharding.splits_over(p, "model")
               for _, p in sharding.placed_leaves(params)):
        return None
    return tp


def _plain(params):
    """A placed tree on a model axis of 1 as the device's blocks (leaves
    split over the data axis stay placed for expert parallelism); a plain
    tree as it is."""
    tp = sharding.tensor_parallel(params)
    return params if tp is None else tp.params(params, 0)


def _plain_cache(cache):
    """A placed decode cache whose blocks are whole (the model axis a
    batch split, ``_tp``) as its tensors, which the decode updates in
    place; a plain cache as it is."""
    leaves = sharding.placed_leaves(cache)
    if not leaves:
        return cache
    return sharding.local(cache, next(iter(leaves[0][1].owners)))


def _ps(tp, params):
    return [tp.params(params, j) for j in range(tp.size)]


def _encode_tp(tp, params, cfg: ModelConfig, frames):
    dt = tp.params(params, 0)["embedding"].dtype
    x0 = frames.to(tp.devices[0], dt)
    x0 = x0 + _positions_table(x0.shape[1], cfg, x0)
    x = Act([x0.to(d) for d in tp.devices])
    for i in range(cfg.num_encoder_layers):
        p = params["encoder"][str(i)]
        h = rms_norm_tp(tp, x, _ps(tp, p), "ln1", cfg.norm_eps)
        y = tp.whole(bidirectional_attention_tp(tp, p["attn"], cfg, h))
        x = Act([a + b for a, b in zip(x.parts, y.parts)])
        h = rms_norm_tp(tp, x, _ps(tp, p), "ln2", cfg.norm_eps)
        y = tp.whole(gelu_mlp_tp(tp, _ps(tp, p["mlp"]), h, cfg.d_ff))
        x = Act([a + b for a, b in zip(x.parts, y.parts)])
    return rms_norm_tp(tp, x, _ps(tp, params["encoder"]), "ln_post",
                       cfg.norm_eps)


def _vlm_prefix_tp(tp, params, cfg: ModelConfig, vis):
    ps = _ps(tp, params["projector"])

    def one(j):
        p = ps[j]
        h = rms_norm(vis.to(tp.devices[j]), p["ln"], cfg.norm_eps)
        return F.gelu(h @ p["w1"], approximate="tanh") @ p["w2"]
    return Act(tp.each(one), partial=ps[0]["w1"].shape[-1] < cfg.d_model)


def _embed_tp(tp, params, cfg: ModelConfig, batch):
    """(x in the residual layout, positions, text offset, enc_out)."""
    tokens = batch["tokens"]
    x = embed_tp(tp, _ps(tp, params), tokens, cfg.vocab_size)
    offset, enc_out = 0, None
    if cfg.family == "vlm" and "vision_embeds" in batch:
        vis = _vlm_prefix_tp(tp, params, cfg,
                             batch["vision_embeds"].to(x.parts[0].dtype))
        if vis.partial != x.partial:
            vis, x = tp.whole(vis), tp.whole(x)
        x = Act([torch.cat([v, t], dim=1) for v, t in
                 zip(vis.parts, x.parts)], partial=x.partial)
        offset = vis.parts[0].shape[1]
    if cfg.is_encoder_decoder:
        enc_out = _encode_tp(tp, params, cfg, batch["frame_embeds"])
        table = _positions_table(x.parts[0].shape[1], cfg, x.parts[0])[None]
        # into shard 0's partial sum only (or every whole copy)
        x = Act([t + table.to(t.device) if (j == 0 or not x.partial) else t
                 for j, t in enumerate(x.parts)], partial=x.partial)
    x = tp.constrain(x, "batch", "act_seq", "embed")
    b_, s = tokens.shape[0], x.parts[0].shape[1] * (
        tp.size if x.split == 1 else 1)
    positions = torch.arange(s, device=tp.devices[0]).expand(b_, s)
    return x, positions, offset, enc_out


def _forward_tp(tp, params, cfg: ModelConfig, batch, moe_strategy):
    """(logits as an ``Act`` over every position, aux, text offset): split
    along the vocabulary from the whole final states, or, where the
    vocabulary is replicated, each shard's logits of its own positions
    (split along the sequence under sequence parallelism, else whole)."""
    x, positions, offset, enc_out = _embed_tp(tp, params, cfg, batch)
    x, aux = blocks.stack_apply_tp(tp, params, cfg, x, positions,
                                   window=cfg.sliding_window,
                                   enc_out=enc_out,
                                   moe_strategy=moe_strategy)
    x = rms_norm_tp(tp, x, _ps(tp, params), "ln_f", cfg.norm_eps)
    if _ps(tp, params)[0]["embedding"].shape[0] < cfg.vocab_size:
        x = tp.whole(x)
    logits = unembed_tp(tp, _ps(tp, params), x, cfg.tie_embeddings,
                        cfg.vocab_size)
    if logits.split is None and x.split is not None:
        logits = Act(logits.parts, split=x.split)
    return logits, aux, offset


def _parallel_ce(tp, logits, labels, offset: int = 0):
    """The mean next-token cross-entropy of the text positions (from
    ``offset``): from vocabulary-split logits the max, the sum of
    exponents and the target's logit all-reduced over the shards ([B, S -
    1] each); from sequence-split logits each shard's own positions, the
    sums of their log-likelihoods and counts all-reduced; whole logits
    (a replicated vocabulary without sequence parallelism) on shard 0's
    copy. The [B, S, V] logits are never gathered."""
    targets = labels[:, 1:].long()
    n_text = labels.shape[1]
    last = logits.parts[0].dim() - 1
    if logits.split == 1:
        rows = logits.parts[0].shape[1]

        def part(j):
            dev = tp.devices[j]
            g = torch.arange(j * rows, (j + 1) * rows, device=dev) - offset
            use = (g >= 0) & (g < n_text - 1)
            t = targets.to(dev)[:, g.clamp(0, n_text - 2)]
            lp = torch.log_softmax(logits.parts[j].float(), dim=-1)
            ll = lp.gather(-1, t.clamp_min(0)[..., None])[..., 0]
            m = ((t >= 0) & use).float()
            return torch.stack([(ll * m).sum(), m.sum()])
        tot = tp.all_reduce(Act(tp.each(part), partial=True)).parts[0]
        return -tot[0] / tot[1].clamp_min(1.0)
    mask = (targets >= 0).float().to(tp.devices[0])
    if logits.split is None:
        def whole(j):
            lp = torch.log_softmax(
                logits.parts[j][:, offset:][:, :-1].float(), dim=-1)
            t = targets.clamp_min(0).to(lp.device)
            return lp.gather(-1, t[..., None])[..., 0]
        ll = tp.each(whole)[0]
    else:
        assert logits.split == last
        lp = tp.each(lambda j: logits.parts[j][:, offset:][:, :-1].float())
        v = lp[0].shape[-1]
        m = tp.all_reduce_max(Act(tp.each(
            lambda j: lp[j].detach().amax(dim=-1)), partial=True))
        se = tp.all_reduce(Act(tp.each(lambda j: torch.exp(
            lp[j] - m.parts[j][..., None]).sum(dim=-1)), partial=True))

        def target(j):
            t = targets.to(lp[j].device).clamp_min(0) - j * v
            inside = (t >= 0) & (t < v)
            got = lp[j].gather(-1, t.clamp(0, v - 1)[..., None])[..., 0]
            return got * inside
        tl = tp.all_reduce(Act(tp.each(target), partial=True))
        ll = tl.parts[0] - (m.parts[0] + torch.log(se.parts[0]))
    return -(ll * mask).sum() / mask.sum().clamp_min(1.0)


def _decode_tp(tp, params, cfg: ModelConfig, tokens, cache, pos, enc_out,
               batch, moe_strategy):
    x = embed_tp(tp, _ps(tp, params), tokens, cfg.vocab_size)
    enc = None
    if cfg.is_encoder_decoder:
        if enc_out is None:
            enc = _encode_tp(tp, params, cfg, batch["frame_embeds"])
        else:
            enc = Act([enc_out.to(d) for d in tp.devices])
        at = sinusoidal_at(pos, cfg.d_model, tp.devices[0]).to(
            x.parts[0].dtype)
        x = Act([t + at.to(t.device) if (j == 0 or not x.partial) else t
                 for j, t in enumerate(x.parts)], partial=x.partial)
    x = tp.constrain(x, "batch", None, "embed")
    x = blocks.stack_decode_tp(tp, params, cfg, x, cache, pos,
                               window=cfg.sliding_window, enc_out=enc,
                               moe_strategy=moe_strategy)
    x = rms_norm_tp(tp, x, _ps(tp, params), "ln_f", cfg.norm_eps)
    logits = unembed_tp(tp, _ps(tp, params), x, cfg.tie_embeddings,
                        cfg.vocab_size)
    return tp.gather(logits)
