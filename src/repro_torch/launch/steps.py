"""Serving step builders (the port of ``repro.launch.steps``'
``build_prefill_step`` and ``build_decode_step``). The reference's train,
gossip and sharding builders are not ported yet (ROADMAP.md queue 1a,
items 7 and 11)."""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import model as model_mod


def build_prefill_step(cfg: ModelConfig, *, moe_strategy="grouped"):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = model_mod.forward(params, cfg, batch,
                                      moe_strategy=moe_strategy)
        return logits
    return prefill_step


def build_decode_step(cfg: ModelConfig, *, moe_strategy="dense"):
    @torch.no_grad()
    def decode_step(params, tokens, cache, pos: int):
        return model_mod.decode_step(params, cfg, tokens, cache, pos,
                                     moe_strategy=moe_strategy)
    return decode_step
