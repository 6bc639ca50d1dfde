"""The port's model-zoo serving path (``repro_torch.models``,
``repro_torch.launch``) on the CPU against the JAX package's, module by
module and for the whole slice.

Parameters are drawn by the reference's own init and carried across with
``convert.model_params_from_jax`` (every leaf perturbed by numpy noise where
an init would leave biases at 0 and norms at 1); activations and tokens come
from numpy with a seed. Everything runs in float32 on reduced configs
(``config.reduced``: 2 layers, d_model 256, at most 4 experts), so the
tolerance is summation order only: rtol = atol = 1e-4 (measured: at most
1.0e-6 on forward logits of magnitude up to 1.5). The port's kernels run their
plain versions here (the tensors lie on the CPU); the reference runs its
jnp model path, as its own tests do.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models import moe as jmoe

from repro_torch.config import reduced
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax, model_params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import attention, layers, model, moe

TOL = dict(rtol=1e-4, atol=1e-4)


def configs(arch, **replace):
    """The reduced config of ``arch`` on both sides, with ``replace``."""
    return (dataclasses.replace(jreduced(jget_config(arch)), **replace),
            dataclasses.replace(reduced(get_config(arch)), **replace))


def perturbed(tree, seed):
    """The numpy tree of a reference parameter tree, every leaf moved by
    noise (so zero biases and unit norms are exercised too)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32), tree)


def jax_init(init_fn, jcfg, seed):
    b = jlayers.Builder(jax.random.PRNGKey(seed), jnp.float32)
    init_fn(b, jcfg)
    return perturbed(b.params, seed)


def both(np_tree):
    """A numpy tree as (jax tree, torch tree)."""
    return jax.tree.map(jnp.asarray, np_tree), \
        model_params_from_jax(np_tree, "cpu")


def close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 4, 32)).astype(np.float32)
    w = rng.normal(size=(32,)).astype(np.float32)
    close(layers.rms_norm(torch.tensor(x), torch.tensor(w), 1e-6),
          jlayers.rms_norm(x, w, 1e-6))
    close(layers.head_rms_norm(torch.tensor(x), torch.tensor(w), 1e-6),
          jlayers.head_rms_norm(x, w, 1e-6))
    pos = np.tile(np.arange(3, 8), (2, 1)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        close(layers.apply_rope(torch.tensor(x), torch.tensor(pos), theta),
              jlayers.apply_rope(x, pos, theta))
    np.testing.assert_array_equal(layers.rope_frequencies(32, 1e4),
                                  jlayers.rope_frequencies(32, 1e4))

    jcfg, cfg = configs("granite-20b")            # the GELU MLP's config
    for init, jinit, fn, jfn in (
            (layers.init_mlp, jlayers.init_mlp, layers.mlp, jlayers.mlp),
            (layers.init_gelu_mlp, jlayers.init_gelu_mlp, layers.gelu_mlp,
             jlayers.gelu_mlp)):
        jp, tp = both(jax_init(lambda b, c: jinit(b, c.d_model, c.d_ff),
                               jcfg, 1))
        h = rng.normal(size=(3, 7, cfg.d_model)).astype(np.float32)
        close(fn(tp, torch.tensor(h)), jfn(jp, h))

    for arch in ("deepseek-moe-16b", "qwen3-0.6b"):      # untied, tied
        jcfg, cfg = configs(arch)
        jp, tp = both(jax_init(jlayers.init_embed, jcfg, 2))
        tokens = rng.integers(0, cfg.vocab_size, (2, 6))
        e = layers.embed(tp, torch.tensor(tokens))
        close(e, jlayers.embed(jp, jnp.asarray(tokens)), rtol=0, atol=0)
        close(layers.unembed(tp, e, cfg.tie_embeddings),
              jlayers.unembed(jp, e.numpy(), jcfg.tie_embeddings))


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

ATTN_CASES = [
    ("deepseek-moe-16b", {}),                          # MHA
    ("qwen3-0.6b", {"num_kv_heads": 2}),               # GQA + qk_norm
    ("qwen2.5-32b", {"num_kv_heads": 4}),              # GQA + QKV bias
]


@pytest.mark.parametrize("arch,replace", ATTN_CASES)
@pytest.mark.parametrize("window", [0, 16])
def test_attention_prefill_matches_jax(arch, replace, window):
    jcfg, cfg = configs(arch, **replace)
    jp, tp = both(jax_init(jattn.init_attention, jcfg, 3))
    rng = np.random.default_rng(4)
    b_, s = 2, 40
    x = rng.normal(size=(b_, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s), (b_, 1)).astype(np.int32)
    want = jattn.attention(jp, jcfg, x, pos, window=window)
    got = attention.attention(tp, cfg, torch.tensor(x), torch.tensor(pos),
                              window=window)
    close(got, want)


@pytest.mark.parametrize("arch,replace", ATTN_CASES)
@pytest.mark.parametrize("window", [0, 16])
def test_decode_attention_matches_jax(arch, replace, window):
    """24 decode steps; with a window of 16 the ring buffer wraps."""
    jcfg, cfg = configs(arch, **replace)
    jp, tp = both(jax_init(jattn.init_attention, jcfg, 5))
    rng = np.random.default_rng(6)
    b_, steps = 2, 24
    jcache = jattn.init_kv_cache(jcfg, b_, steps, window)
    cache = attention.init_kv_cache(cfg, b_, steps, window, "cpu")
    assert cache["k"].shape == jcache["k"].shape
    for t in range(steps):
        x = rng.normal(size=(b_, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jattn.decode_attention(jp, jcfg, x, jcache,
                                              jnp.int32(t), window=window)
        got, cache = attention.decode_attention(tp, cfg, torch.tensor(x),
                                                cache, t, window=window)
        close(got, want)
    close(cache["k"], jcache["k"])
    close(cache["v"], jcache["v"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = [{}, {"num_experts": 8, "top_k": 3, "num_shared_experts": 0}]


def moe_configs(moe_replace):
    jcfg, cfg = configs("deepseek-moe-16b")
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, **moe_replace)),
        dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, **moe_replace)))


@pytest.mark.parametrize("moe_replace", MOE_CASES)
@pytest.mark.parametrize("strategy,capacity", [("dense", None),
                                               ("grouped", 1.25),
                                               ("grouped", 0.25)])
def test_moe_matches_jax(moe_replace, strategy, capacity):
    """moe_dense, moe_grouped, and moe_grouped with a capacity that drops
    tokens (capacity factor 0.25)."""
    jcfg, cfg = moe_configs(moe_replace)
    jp, tp = both(jax_init(jmoe.init_moe, jcfg, 7))
    x = np.random.default_rng(8).normal(
        size=(96, cfg.d_model)).astype(np.float32)
    if strategy == "dense":
        want, jaux = jmoe.moe_dense(jp, jcfg, x)
        got, aux = moe.moe_dense(tp, cfg, torch.tensor(x))
    else:
        want, jaux = jmoe.moe_grouped(jp, jcfg, x, capacity_factor=capacity)
        got, aux = moe.moe_grouped(tp, cfg, torch.tensor(x),
                                   capacity_factor=capacity)
    if capacity == 0.25:                # the case must really drop tokens
        _, idx = jax.lax.top_k(jmoe.router_probs(jp, x)[0],
                               jcfg.moe.top_k)
        counts = np.bincount(np.asarray(idx).ravel(),
                             minlength=jcfg.moe.num_experts)
        assert counts.max() > 8 * ((int(0.25 * jcfg.moe.top_k * 96 /
                                        jcfg.moe.num_experts) + 7) // 8)
    close(got, want)
    close(aux, jaux)


def test_moe_ffn_strategies_and_guard():
    jcfg, cfg = moe_configs({})
    jp, tp = both(jax_init(jmoe.init_moe, jcfg, 9))
    x = np.random.default_rng(10).normal(
        size=(2, 12, cfg.d_model)).astype(np.float32)
    for strategy in ("dense", "grouped"):
        want, _ = jmoe.moe_ffn(jp, jcfg, x, strategy=strategy)
        got, _ = moe.moe_ffn(tp, cfg, torch.tensor(x), strategy=strategy)
        close(got, want)
    probs, logits = moe.router_probs(tp, torch.tensor(x[0]))
    jprobs, jlogits = jmoe.router_probs(jp, x[0])
    close(probs, jprobs)
    close(logits, jlogits)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        moe.moe_ffn(tp, cfg, torch.tensor(x), strategy="eplocal_fp8")


# ---------------------------------------------------------------------------
# The whole model: forward, teacher-forced decode, greedy serving
# ---------------------------------------------------------------------------

MODEL_CASES = [
    ("deepseek-moe-16b", {}),
    ("qwen3-0.6b", {}),
    # prefix layer + two scanned repeats: stacked params and stacked cache
    ("deepseek-moe-16b", {"num_layers": 3, "scan_layers": True}),
]


def model_pair(arch, replace, seed):
    jcfg, cfg = configs(arch, **replace)
    jp = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, cfg, jp, model_params_from_jax(
        jax.tree.map(np.asarray, jp), "cpu")


@pytest.mark.parametrize("arch,replace", MODEL_CASES)
def test_forward_and_decode_match_jax(arch, replace):
    jcfg, cfg, jp, tp = model_pair(arch, replace, 11)
    if replace.get("scan_layers"):
        assert tp["scan"]["0"]["moe"]["wi"].shape[0] == 2
    b_, s = 2, 10
    tokens = np.random.default_rng(12).integers(0, cfg.vocab_size, (b_, s))
    batch, jbatch = {"tokens": torch.tensor(tokens)}, \
        {"tokens": jnp.asarray(tokens, jnp.int32)}
    got = {}
    for strategy in ("dense", "grouped"):
        want, jaux = jmodel.forward(jp, jcfg, jbatch, moe_strategy=strategy)
        got[strategy], aux = model.forward(tp, cfg, batch,
                                           moe_strategy=strategy)
        close(got[strategy], want)
        close(aux, jaux)
    torch.testing.assert_close(build_prefill_step(cfg)(tp, batch),
                               got["grouped"], rtol=0, atol=0)

    jdecode = jax.jit(lambda p, tk, c, pos: jmodel.decode_step(p, jcfg, tk,
                                                               c, pos))
    jcache = jmodel.init_cache(jcfg, b_, s)
    cache = model.init_cache(cfg, b_, s, device="cpu")
    decode = build_decode_step(cfg)
    for t in range(s):
        jl, jcache = jdecode(jp, jbatch["tokens"][:, t:t + 1], jcache,
                             jnp.int32(t))
        lg, cache = decode(tp, batch["tokens"][:, t:t + 1], cache, t)
        close(lg, jl)
        # teacher-forced decode equals the parallel forward (the reference's
        # own bound, tests/test_arch_smoke.py)
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   got["dense"][:, t].numpy(), atol=2e-3)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-0.6b"])
def test_greedy_serving_matches_jax(arch):
    """The reference's serve loop (prefill by stepping the cache, then
    greedy steps) and the port's ``serve.generate`` take the same 8
    tokens from the same parameters and prompts."""
    jcfg, cfg, jp, tp = model_pair(arch, {}, 13)
    b_, plen, new = 3, 6, 8
    prompts = np.random.default_rng(14).integers(0, cfg.vocab_size,
                                                 (b_, plen))
    decode = jax.jit(lambda p, t, c, pos: jmodel.decode_step(p, jcfg, t, c,
                                                             pos))
    cache = jmodel.init_cache(jcfg, b_, plen + new)
    jprompts = jnp.asarray(prompts, jnp.int32)
    for t in range(plen):
        logits, cache = decode(jp, jprompts[:, t:t + 1], cache, jnp.int32(t))
    want = []
    for t in range(plen, plen + new):
        nxt = jnp.argmax(logits[:, -1], axis=-1)
        want.append(np.asarray(nxt))
        logits, cache = decode(jp, nxt[:, None], cache, jnp.int32(t))
    got, stats = serve.generate(tp, cfg, torch.tensor(prompts), new)
    np.testing.assert_array_equal(got.numpy(), np.stack(want, axis=1))
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}


def test_serving_goes_through_the_kernel_wrappers(monkeypatch):
    """Per prefill call every layer runs flash attention once and every MoE
    layer the router once; a decode step runs the router once per MoE
    layer and no flash attention."""
    calls = {"flash_attention": 0, "moe_router_topk": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    cfg = dataclasses.replace(reduced(get_config("deepseek-moe-16b")),
                              num_layers=4, scan_layers=True)
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 5), generator=gen)
    build_prefill_step(cfg)(params, {"tokens": tokens})
    assert calls == {"flash_attention": 4, "moe_router_topk": 3}
    cache = model.init_cache(cfg, 2, 5, device="cpu")
    build_decode_step(cfg)(params, tokens[:, :1], cache, 0)
    assert calls == {"flash_attention": 4, "moe_router_topk": 6}


# ---------------------------------------------------------------------------
# Parameters: the full-size tree, init, carrying across
# ---------------------------------------------------------------------------

def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-0.6b"])
def test_abstract_params_full_config_equal_to_jax(arch):
    """The full-width, full-depth tree, leaf by leaf, without allocating
    (meta tensors on the port's side)."""
    ours = flat(model.abstract_params(get_config(arch)))
    theirs = flat(jmodel.abstract_params(jget_config(arch)))
    assert sorted(ours) == sorted(theirs)
    for k, t in ours.items():
        assert t.device.type == "meta", k
        assert tuple(t.shape) == tuple(theirs[k].shape), k
        assert str(t.dtype).removeprefix("torch.") == str(theirs[k].dtype), k
    n = sum(t.numel() for t in ours.values())
    if arch == "deepseek-moe-16b":
        assert n == 16_375_728_128
        assert tuple(ours["scan/0/moe/wi"].shape) == (27, 64, 2048, 1408)


def test_init_params_draws_each_stacked_slice_from_the_generator():
    cfg = dataclasses.replace(reduced(get_config("deepseek-moe-16b")),
                              num_layers=3, scan_layers=True,
                              dtype="bfloat16")
    trees = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(3)
        trees.append(flat(model.init_params(gen, cfg)))
    a, b = trees
    assert sorted(a) == sorted(flat(model.abstract_params(cfg)))
    for k in a:
        assert a[k].dtype == torch.bfloat16
        assert torch.equal(a[k], b[k]), k       # same seed, same draws
    wi = a["scan/0/moe/wi"].float()
    assert not torch.equal(wi[0], wi[1])        # repeats differ
    assert abs(float(wi.std()) - 0.02) < 2e-3   # normal(0, 0.02)
    assert torch.all(a["scan/0/ln1"] == 1)
    assert float(a["embedding"].float().std()) == pytest.approx(0.01,
                                                                rel=0.1)


def test_convert_round_trips_bf16():
    tree = jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0), dataclasses.replace(
            jreduced(jget_config("qwen3-0.6b")), dtype="bfloat16")))
    got = model_params_from_jax(tree, "cpu")
    leaf = flat(got)["embedding"]
    assert leaf.dtype == torch.bfloat16
    back = flat(model_params_to_numpy(got))
    for k, a in flat(tree).items():
        np.testing.assert_array_equal(back[k], a.astype(np.float32))
    f32 = model_params_from_jax(tree, "cpu", dtype=torch.float32)
    assert flat(f32)["embedding"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["mamba2-780m", "jamba-v0.1-52b",
                                  "whisper-tiny", "internvl2-2b"])
def test_unported_families_raise(arch):
    gen = torch.Generator()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        model.init_params(gen, reduced(get_config(arch)))
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1"):
        model.loss_fn()
