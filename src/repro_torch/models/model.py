"""Top-level models: the causal LM of the dense, moe, ssm, hybrid and vlm
families and the whisper-style encoder-decoder (the port of
``repro.models.model``):

    params = init_params(gen, cfg)          # gen: a torch.Generator
    shapes = abstract_params(cfg)           # meta tensors, no storage
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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.attention import bidirectional_attention, \
    init_attention
from repro_torch.models.layers import (Builder, embed, gelu_mlp, init_embed,
                                       init_gelu_mlp, rms_norm, sinusoidal_at,
                                       sinusoidal_positions, torch_dtype,
                                       unembed)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_encoder(b: Builder, cfg: ModelConfig):
    """Whisper-style encoder: bidirectional attention + GELU MLP blocks over
    the (stubbed) conv frame embeddings."""
    for i in range(cfg.num_encoder_layers):
        lb = b.sub(str(i))
        lb.ones("ln1", (cfg.d_model,))
        init_attention(lb.sub("attn"), cfg)
        lb.ones("ln2", (cfg.d_model,))
        init_gelu_mlp(lb.sub("mlp"), cfg.d_model, cfg.d_ff)
    b.ones("ln_post", (cfg.d_model,))


def _init_vlm_projector(b: Builder, cfg: ModelConfig):
    """MLP projector from the (stubbed) vision embeddings, which arrive
    patch-embedded at d_model width, to the LM's space."""
    b.normal("w1", (cfg.d_model, cfg.d_model))
    b.normal("w2", (cfg.d_model, cfg.d_model))
    b.ones("ln", (cfg.d_model,))


def _build(gen, cfg: ModelConfig, abstract: bool = False):
    device = None if abstract else gen.device
    b = Builder(gen, torch_dtype(cfg.dtype), device, abstract)
    init_embed(b, cfg)
    if cfg.is_encoder_decoder:
        _init_encoder(b.sub("encoder"), cfg)
    if cfg.family == "vlm":
        _init_vlm_projector(b.sub("projector"), cfg)
    blocks.init_stack(b, cfg, cross=cfg.is_encoder_decoder)
    b.ones("ln_f", (cfg.d_model,))
    return b


def init_params(gen: torch.Generator, cfg: ModelConfig):
    """Random parameters drawn from ``gen``, on ``gen``'s device, in
    ``cfg.dtype``."""
    return _build(gen, cfg).params


def abstract_params(cfg: ModelConfig):
    """The parameter tree as meta tensors (shape and dtype, no storage)."""
    return _build(None, cfg, abstract=True).params


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


def forward(params, cfg: ModelConfig, batch, *, moe_strategy="grouped"):
    """Prefill forward. Returns (logits [B,S,V] of the text positions,
    aux_loss)."""
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
    (logits [B,1,V], cache), the cache updated in place."""
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
    return unembed(params, x, cfg.tie_embeddings), cache
