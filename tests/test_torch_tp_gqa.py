"""Tensor parallelism with grouped kv heads that the model axis splits,
against the reference unsharded, live JAX in the process, through the
checks of ``test_torch_tp_models.py`` (logits and loss within 1e-5,
gradients within 1e-4 of their max, 8 greedy decode steps within 2e-3
with equal tokens, Adam and Adafactor on the placed state within 1e-6).

Reduced qwen3-0.6b with 8 query heads over 4 kv heads: each model shard
holds its own kv heads and two query heads read each, at tp 2 and at tp
4 (full-width qwen3-0.6b's 16 over 8 at tp 4); and over 2 kv heads: four
query heads a kv head at tp 2, and at tp 4, where the kv heads do not
divide, k and v gathered along head_dim and each shard's query heads
picking their kv head.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch import sharding
from repro_torch.core import pods
from repro_torch.launch.sharding_rules import base_rules
from repro_torch.models import model
from test_torch_tp_models import (MESHES, check_forward_loss_and_gradients,
                                  check_greedy_decode, check_optimizer_step,
                                  mesh_of, port_cfg)
from torch_threads import one_torch_thread  # noqa: F401

HERE = ("qwen3_gqa4", "qwen3_gqa2")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", HERE)
def test_the_model_axis_places_the_kv_heads(case, shape):
    """wk's blocks: the shard's kv heads where tp divides them, else the
    head_dim split (the resolve chain's fallback)."""
    cfg = port_cfg(case)
    tp = shape[1]
    mesh, rules = mesh_of(shape), base_rules(False)
    params = model.init_params(torch.Generator().manual_seed(0), cfg)
    with sharding.logical_rules(mesh, rules):
        wk = pods.flatten(model.place_params(params, cfg, mesh,
                                             rules))["layers/0/attn/wk"]
    blocks = {tuple(t.shape) for t in wk.parts}
    if cfg.num_kv_heads % tp == 0:
        assert blocks == {(cfg.d_model, cfg.num_kv_heads // tp,
                           cfg.head_dim)}
        assert cfg.num_heads // cfg.num_kv_heads > 1
    else:
        assert blocks == {(cfg.d_model, cfg.num_kv_heads,
                           cfg.head_dim // tp)}


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", HERE)
def test_forward_loss_and_gradients(case, shape):
    check_forward_loss_and_gradients(case, shape)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", HERE)
def test_greedy_decode(case, shape):
    check_greedy_decode(case, shape)


@pytest.mark.parametrize("name", ["adam", "adafactor"])
@pytest.mark.parametrize("case", HERE)
def test_optimizer_step_on_the_placed_state(case, name):
    check_optimizer_step(case, name)
