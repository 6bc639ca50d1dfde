"""Tensor-parallel models (``sharding.TensorParallel`` over a placed
tree) against the reference unsharded, live JAX in the process, f32, on
``["cpu"] * 4`` as a (2, 2) mesh and ``["cpu"] * 8`` as (2, 4). This file
runs the attention models' cases; ``test_torch_tp_mixers.py`` runs the
mixer, MoE and hybrid ones through the same checks.

Reduced qwen3-0.6b (qk-norm, tied), granite-20b (one kv head: k, v
gathered along head_dim), whisper-tiny (6 heads: split at tp 2, demoted
and replicated at 4; the encoder and cross-attention), mamba2-780m (the
per-head mixer), deepseek-moe-16b (grouped, and eplocal against the
port's eplocal on the whole tree), jamba (hybrid) and one odd vocabulary
(1,023, replicated; also InternVL2-2B's vision prefix on it, whose
logits split along the sequence): logits and the loss within 1e-5,
gradients within 1e-4 of their max, 8 greedy decode steps' logits within
2e-3 with equal tokens, and Adam and Adafactor steps on the reference's
gradients within 1e-6 of the reference's update.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.models import model as jmodel
from repro.optim import make_optimizer as jmake

from repro_torch import sharding
from repro_torch.config import reduced
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.launch import steps
from repro_torch.launch.sharding_rules import base_rules
from repro_torch.models import model
from repro_torch.optim import make_optimizer
from torch_threads import one_torch_thread  # noqa: F401

CASES = {
    "qwen3": ("qwen3-0.6b", {}),
    "granite20b": ("granite-20b", {}),
    "whisper": ("whisper-tiny", {}),
    "mamba2": ("mamba2-780m", {}),
    "deepseek": ("deepseek-moe-16b", {}),
    "jamba": ("jamba-v0.1-52b", {}),
    "odd_vocab": ("qwen3-0.6b", {"vocab_size": 1023}),
    # a replicated vocabulary under sequence parallelism: each shard's
    # logits of its own positions, the vision prefix's offset
    "vlm_odd_vocab": ("internvl2-2b", {"vocab_size": 1023}),
    # grouped kv heads (test_torch_tp_gqa.py): 8 query heads over 4 kv
    # heads, and over 2
    "qwen3_gqa4": ("qwen3-0.6b", {"num_kv_heads": 4}),
    "qwen3_gqa2": ("qwen3-0.6b", {"num_kv_heads": 2}),
}
MESHES = [(2, 2), (2, 4)]
# this file's cases; the mixers' (mamba2, deepseek, jamba) are
# test_torch_tp_mixers.py's
HERE = ("qwen3", "granite20b", "whisper", "odd_vocab", "vlm_odd_vocab")
B, S, STEPS = 2, 32, 8


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@functools.lru_cache(maxsize=None)
def reference(case):
    """The reference's f32 run of a case: params, batch, logits, loss,
    gradients, 8 greedy decode steps and one Adam and one Adafactor
    update on its gradients."""
    arch, over = CASES[case]
    jcfg = dataclasses.replace(jreduced(jget_config(arch)), **over)
    params = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    if jcfg.is_encoder_decoder:
        batch["frame_embeds"] = rng.standard_normal(
            (B, jcfg.encoder_seq_len, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, jcfg.num_vision_tokens, jcfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logits, _ = jax.jit(lambda p, b: jmodel.forward(p, jcfg, b))(params, jb)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, jcfg, b), has_aux=True))(params, jb)
    cache = jmodel.init_cache(jcfg, B, STEPS)
    tok = jnp.asarray(tokens[:, :1])
    dec, toks = [], []
    frames = {"frame_embeds": jb["frame_embeds"]} \
        if jcfg.is_encoder_decoder else None
    step = jax.jit(lambda p, t, c, pos, b: jmodel.decode_step(
        p, jcfg, t, c, pos, batch=b))
    for pos in range(STEPS):
        lg, cache = step(params, tok, cache, jnp.int32(pos), frames)
        dec.append(np.asarray(lg))
        tok = jnp.argmax(lg, axis=-1).astype(jnp.int32)
        toks.append(np.asarray(tok))
    opt = {}
    for name in ("adam", "adafactor"):
        o = jmake(name, 1e-2)
        st = o.init(params)
        newp, news = o.update(params, grads, st, jnp.zeros((), jnp.int32))
        opt[name] = (_np(newp), _np(news))
    return dict(params=_np(params), batch=batch, logits=np.asarray(logits),
                loss=float(loss), grads=_np(grads), decode=dec, tokens=toks,
                opt=opt)


def port_cfg(case):
    arch, over = CASES[case]
    return dataclasses.replace(reduced(get_config(arch)), **over)


def mesh_of(shape):
    return sharding.make_mesh(shape, ("data", "model"),
                              ["cpu"] * (shape[0] * shape[1]))


def torch_batch(ref):
    return {k: torch.as_tensor(v).long() if v.dtype.kind == "i"
            else torch.as_tensor(v) for k, v in ref["batch"].items()}


def check_forward_loss_and_gradients(case, shape):
    ref = reference(case)
    cfg = port_cfg(case)
    mesh, rules = mesh_of(shape), base_rules(False)
    params = model_params_from_jax(ref["params"], "cpu")
    batch = torch_batch(ref)
    with sharding.logical_rules(mesh, rules):
        placed = model.place_params(params, cfg, mesh, rules)
        logits, _ = model.forward(placed, cfg, batch)
        loss, grads = steps.placed_grads(cfg, placed, batch, "grouped")
    np.testing.assert_allclose(logits.numpy(), ref["logits"], rtol=0,
                               atol=1e-5)
    assert abs(float(loss) - ref["loss"]) < 1e-5
    got, want = _flat(sharding.unplace(grads)), _flat(ref["grads"])
    assert got.keys() == want.keys()
    top = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-4 * top, err_msg=k)


def check_greedy_decode(case, shape):
    ref = reference(case)
    cfg = port_cfg(case)
    mesh, rules = mesh_of(shape), base_rules(False)
    params = model_params_from_jax(ref["params"], "cpu")
    with sharding.logical_rules(mesh, rules):
        placed = model.place_params(params, cfg, mesh, rules)
        cache = model.place_cache(model.init_cache(cfg, B, STEPS, "cpu"),
                                  cfg, mesh, rules)
        enc = None
        if cfg.is_encoder_decoder:
            enc = model.encode(placed, cfg, torch.as_tensor(
                ref["batch"]["frame_embeds"]))
        tok = torch.as_tensor(ref["batch"]["tokens"][:, :1]).long()
        for pos in range(STEPS):
            lg, cache = model.decode_step(placed, cfg, tok, cache, pos,
                                          enc_out=enc)
            np.testing.assert_allclose(lg.numpy(), ref["decode"][pos],
                                       rtol=0, atol=2e-3)
            tok = lg.argmax(dim=-1)
            np.testing.assert_array_equal(tok.numpy(), ref["tokens"][pos])


def check_optimizer_step(case, name):
    """The update per block (Adafactor's statistics summed across the
    blocks) on the reference's gradients at (2, 4), and at (2, 2) under
    ZeRO-1 (the moments split over the data axis too)."""
    ref = reference(case)
    cfg = port_cfg(case)
    want_p, want_s = ref["opt"][name]
    for shape, variant in (((2, 4), "baseline"), ((2, 2), "zero1")):
        mesh, rules = mesh_of(shape), base_rules(False, variant=variant)
        params = model_params_from_jax(ref["params"], "cpu")
        grads = model_params_from_jax(ref["grads"], "cpu")
        opt = make_optimizer(name, 1e-2)
        with sharding.logical_rules(mesh, rules):
            pp, ps = steps.place_state(cfg, params, opt.init(params), name,
                                       mesh, rules)
            pg = model.place_params(grads, cfg, mesh, rules)
            newp, news = opt.update(pp, pg, ps, torch.zeros(
                (), dtype=torch.int64))
        got, want = _flat(sharding.unplace(newp)), _flat(want_p)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                       atol=1e-6, err_msg=(variant, k))
        got_s, want_s_ = _flat(sharding.unplace(news)), _flat(want_s)
        assert got_s.keys() == want_s_.keys()
        for k in want_s_:
            scale = max(1.0, float(np.abs(want_s_[k]).max()))
            np.testing.assert_allclose(got_s[k].numpy(), want_s_[k], rtol=0,
                                       atol=1e-6 * scale,
                                       err_msg=(variant, k))


def check_eplocal_placement(shape):
    """DeepSeekMoE's loss and gradients through eplocal on a placed tree
    (expert blocks read where they lie, the blocks' gradients) equal the
    port's eplocal on the whole tree on the same mesh."""
    ref = reference("deepseek")
    cfg = port_cfg("deepseek")
    mesh, rules = mesh_of(shape), base_rules(False)
    params = model_params_from_jax(ref["params"], "cpu")
    batch = torch_batch(ref)
    with sharding.logical_rules(mesh, rules):
        placed = model.place_params(params, cfg, mesh, rules)
        loss, grads = steps.placed_grads(cfg, placed, batch, "eplocal")
        leaves = {k: v.detach().requires_grad_()
                  for k, v in _flat(params).items()}
        tree = _unflat(leaves)
        want, _ = model.loss_fn(tree, cfg, batch, moe_strategy="eplocal")
        wg = torch.autograd.grad(want, list(leaves.values()))
    assert abs(float(loss) - float(want)) < 1e-5
    got = _flat(sharding.unplace(grads))
    top = max(float(g.abs().max()) for g in wg)
    for (k, _), g in zip(leaves.items(), wg):
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=0,
                                   atol=1e-4 * top, err_msg=k)


def _unflat(flat):
    out = {}
    for path, v in flat.items():
        keys = path.strip("/").split("/")
        d = out
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = v
    return out


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
