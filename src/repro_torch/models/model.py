"""Top-level causal LM for the dense, moe, ssm and hybrid families (the
port of ``repro.models.model``):

    params = init_params(gen, cfg)          # gen: a torch.Generator
    shapes = abstract_params(cfg)           # meta tensors, no storage
    logits, aux = forward(params, cfg, batch)
    cache  = init_cache(cfg, batch, seq_len, device)  # None: the card
    logits, cache = decode_step(params, cfg, tokens, cache, pos)

``batch`` is a dict with ``tokens`` [B, S]. The cache holds a KV cache per
attention layer and a conv window and SSD state per mamba layer. The vlm
prefix, the whisper encoder-decoder and ``loss_fn`` (training) are not
ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.layers import (Builder, embed, init_embed, rms_norm,
                                       torch_dtype, unembed)


def check_supported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` for the parts of the zoo the port
    does not carry yet: the whisper encoder-decoder and the vlm prefix."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder (cross and bidirectional "
            f"attention) is not ported yet: ROADMAP.md queue 1a, item 8")
    if cfg.family == "vlm":
        raise NotImplementedError(
            f"{cfg.name}: the vlm prefix is not ported yet: ROADMAP.md "
            f"queue 1a, item 8")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _build(gen, cfg: ModelConfig, abstract: bool = False):
    check_supported(cfg)
    device = None if abstract else gen.device
    b = Builder(gen, torch_dtype(cfg.dtype), device, abstract)
    init_embed(b, cfg)
    blocks.init_stack(b, cfg)
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

def forward(params, cfg: ModelConfig, batch, *, moe_strategy="grouped"):
    """Prefill forward. Returns (logits [B,S,V], aux_loss)."""
    check_supported(cfg)
    tokens = batch["tokens"]
    x = embed(params, tokens)
    b_, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b_, s)
    x, aux = blocks.stack_apply(params, cfg, x, positions,
                                window=cfg.sliding_window,
                                moe_strategy=moe_strategy)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params, x, cfg.tie_embeddings), aux


def loss_fn(*args, **kwargs):
    raise NotImplementedError("training (loss_fn, train step, optim) is not "
                              "ported yet: ROADMAP.md queue 1a, item 11")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device=None):
    """The stack's decode cache (KV per attention layer, conv window and
    SSD state per mamba layer); ``device=None`` means the card (raises
    without one)."""
    check_supported(cfg)
    return blocks.init_stack_cache(cfg, batch, seq_len,
                                   window=cfg.sliding_window,
                                   device=resolve_device(device))


def decode_step(params, cfg: ModelConfig, tokens, cache, pos: int, *,
                moe_strategy="dense"):
    """One-token decode. tokens: [B, 1]; pos: the absolute position.
    Returns (logits [B,1,V], cache), the cache updated in place."""
    check_supported(cfg)
    x = embed(params, tokens)
    x, cache = blocks.stack_decode(params, cfg, x, cache, pos,
                                   window=cfg.sliding_window,
                                   moe_strategy=moe_strategy)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return unembed(params, x, cfg.tie_embeddings), cache
