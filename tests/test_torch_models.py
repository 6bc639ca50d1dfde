"""The port's model-zoo serving path (``repro_torch.models``,
``repro_torch.launch``) on the CPU against the JAX package's, module by
module and for the whole slice.

Parameters are drawn by the reference's own init and carried across with
``convert.model_params_from_jax`` (every leaf perturbed by numpy noise where
an init would leave biases at 0 and norms at 1; the Mamba2 blocks' D,
dt_bias and conv_b, which the init leaves at 0, are drawn anew in the
whole-model cases too); activations and tokens come from numpy with a seed.
Everything runs in float32 on reduced configs (``config.reduced``: 2
layers unless a case says more, d_model 256, at most 4 experts), so the
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
from repro.models import ssm as jssm

from repro_torch.config import reduced
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax, model_params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import attention, blocks, layers, model, moe, ssm
from torch_threads import one_torch_thread  # noqa: F401


TOL = dict(rtol=1e-4, atol=1e-4)


def configs(arch, layers=2, **replace):
    """The reduced config of ``arch`` (``reduced(..., num_layers=layers)``)
    on both sides, with ``replace``."""
    return (dataclasses.replace(jreduced(jget_config(arch),
                                         num_layers=layers), **replace),
            dataclasses.replace(reduced(get_config(arch), num_layers=layers),
                                **replace))


def perturbed(tree, seed):
    """The numpy tree of a reference parameter tree, every leaf moved by
    noise (so zero biases and unit norms are exercised too)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: (np.asarray(a) + 0.05 * rng.normal(size=a.shape))
        .astype(np.float32), tree)


def nonzero_ssm_leaves(tree, seed):
    """The numpy tree with every Mamba2 block's D, dt_bias and conv_b (0 at
    init) drawn from a normal, so the D skip, the dt bias and the conv
    bias are exercised."""
    rng = np.random.default_rng(seed)
    scale = {"D": 0.5, "dt_bias": 0.5, "conv_b": 0.1}
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(size=a.shape) * scale[path[-1].key])
        .astype(a.dtype) if path[-1].key in scale else a, tree)


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


@pytest.mark.parametrize("moe_replace", MOE_CASES)
def test_moe_grouped_overflowing_router_matches_jax(moe_replace):
    """A router skewed towards expert 0 (inputs offset by 1, its column
    raised by 4/D), so nearly every token picks it and it overflows the
    capacity of factor 1.25: the dropped pairs, the empty slots of the
    other experts and the combine all against live JAX."""
    jcfg, cfg = moe_configs(moe_replace)
    tree = jax_init(jmoe.init_moe, jcfg, 11)
    tree["router"][:, 0] += 4.0 / cfg.d_model
    jp, tp = both(tree)
    x = (np.random.default_rng(12).normal(size=(96, cfg.d_model))
         + 1.0).astype(np.float32)
    _, idx = jax.lax.top_k(jmoe.router_probs(jp, x)[0], jcfg.moe.top_k)
    cap = (int(1.25 * jcfg.moe.top_k * 96 / jcfg.moe.num_experts) + 7) \
        // 8 * 8
    assert (np.asarray(idx) == 0).sum() > cap
    want, jaux = jmoe.moe_grouped(jp, jcfg, x)
    got, aux = moe.moe_grouped(tp, cfg, torch.tensor(x))
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
    # eplocal needs a mesh context (tests/test_torch_eplocal.py runs it)
    with pytest.raises(AssertionError,
                       match="moe_eplocal requires a mesh context"):
        moe.moe_ffn(tp, cfg, torch.tensor(x), strategy="eplocal_fp8")


# ---------------------------------------------------------------------------
# The whole model: forward, teacher-forced decode, greedy serving
# ---------------------------------------------------------------------------

MODEL_CASES = [
    ("deepseek-moe-16b", {}),
    ("qwen3-0.6b", {}),
    # prefix layer + two scanned repeats: stacked params and stacked cache
    ("deepseek-moe-16b", {"num_layers": 3, "scan_layers": True}),
    ("mamba2-780m", {}),
    # three scanned repeats: the SSD caches are views updated in place
    ("mamba2-780m", {"num_layers": 3, "scan_layers": True}),
    # mamba, mamba_moe, mamba, attn_moe: every kind jamba uses
    ("jamba-v0.1-52b", {"layers": 4}),
    # that period scanned twice: stacked KV and SSD caches side by side
    ("jamba-v0.1-52b", {"layers": 4, "num_layers": 8, "scan_layers": True}),
]


def model_pair(arch, replace, seed):
    jcfg, cfg = configs(arch, **replace)
    tree = nonzero_ssm_leaves(jax.tree.map(
        np.asarray, jmodel.init_params(jax.random.PRNGKey(seed), jcfg)), seed)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), \
        model_params_from_jax(tree, "cpu")


@pytest.mark.parametrize("arch,replace", MODEL_CASES)
def test_forward_and_decode_match_jax(arch, replace):
    """Mamba cases run S = 40 against the reduced chunk of 32, so the
    prefill pads to a chunk multiple."""
    jcfg, cfg, jp, tp = model_pair(arch, replace, 11)
    if replace.get("scan_layers"):
        _, _, repeats = blocks.factor_schedule(cfg.block_schedule())
        assert repeats > 1 and all(t.shape[0] == repeats
                                   for t in flat(tp["scan"]).values())
    b_, s = 2, 40 if cfg.ssm else 10
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
    # every layer's cache (KV, conv window, SSD state) as the reference's
    ours, theirs = flat(cache), flat(jax.tree.map(np.asarray, jcache))
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        close(ours[k], theirs[k])


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-0.6b",
                                  "mamba2-780m", "jamba-v0.1-52b"])
def test_greedy_serving_matches_jax(arch):
    """The reference's serve loop (prefill by stepping the cache, then
    greedy steps) and the port's ``serve.generate`` take the same 8
    tokens from the same parameters and prompts (jamba at 4 layers: all
    three of its block kinds)."""
    jcfg, cfg, jp, tp = model_pair(
        arch, {"layers": 4} if arch.startswith("jamba") else {}, 13)
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
    layer the fused route-and-slot kernel once (the grouped dispatch); a
    decode step runs the router once per MoE layer (the dense dispatch)
    and no flash attention."""
    calls = {"flash_attention": 0, "moe_router_topk": 0,
             "moe_route_slots": 0}
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
    assert calls == {"flash_attention": 4, "moe_router_topk": 0,
                     "moe_route_slots": 3}
    cache = model.init_cache(cfg, 2, 5, device="cpu")
    build_decode_step(cfg)(params, tokens[:, :1], cache, 0)
    assert calls == {"flash_attention": 4, "moe_router_topk": 3,
                     "moe_route_slots": 3}


def test_ssm_serving_goes_through_the_kernel_wrappers(monkeypatch):
    """Jamba at 4 layers (mamba, mamba_moe, mamba, attn_moe): a prefill
    call runs ssd_chunk once per mamba layer, flash once per attention
    layer and the fused route-and-slot kernel once per MoE layer; a decode
    step runs only the router (the SSD recurrence is plain torch)."""
    calls = {"ssd_chunk": 0, "flash_attention": 0, "moe_router_topk": 0,
             "moe_route_slots": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    cfg = reduced(get_config("jamba-v0.1-52b"), num_layers=4)
    assert cfg.block_schedule() == ("mamba", "mamba_moe", "mamba",
                                    "attn_moe")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init_params(gen, cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 37), generator=gen)
    build_prefill_step(cfg)(params, {"tokens": tokens})
    assert calls == {"ssd_chunk": 3, "flash_attention": 1,
                     "moe_router_topk": 0, "moe_route_slots": 2}
    cache = model.init_cache(cfg, 2, 37, device="cpu")
    build_decode_step(cfg)(params, tokens[:, :1], cache, 0)
    assert calls == {"ssd_chunk": 3, "flash_attention": 1,
                     "moe_router_topk": 2, "moe_route_slots": 2}


# ---------------------------------------------------------------------------
# Mamba2 blocks
# ---------------------------------------------------------------------------

SSM_ARCHS = ["mamba2-780m", "jamba-v0.1-52b"]


def ssm_pair(jcfg, seed):
    return both(nonzero_ssm_leaves(jax_init(jssm.init_ssm, jcfg, seed),
                                   seed))


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("s", [64, 40, 20])
def test_ssm_block_matches_jax(arch, s):
    """S = 64: two chunks of 32; S = 40: padded to 64; S = 20: one chunk
    of 20 (chunk = min(chunk_size, S))."""
    jcfg, cfg = configs(arch)
    jp, tp = ssm_pair(jcfg, 15)
    assert all(float(np.abs(np.asarray(jp[k])).min()) > 0
               for k in ("D", "dt_bias"))
    x = np.random.default_rng(16).normal(
        size=(2, s, cfg.d_model)).astype(np.float32)
    close(ssm.ssm_block(tp, cfg, torch.tensor(x)),
          jssm.ssm_block(jp, jcfg, x))


@pytest.mark.parametrize("nc", [1, 3])
def test_ssd_scan_matches_jax(nc):
    """The chunked scan with the model's steep decays (A_log = log(1..H)):
    y and the final state."""
    rng = np.random.default_rng(nc)
    b_, t, h, p, n = 2, 32, 16, 32, 16
    x = rng.normal(size=(b_, nc * t, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b_, nc * t, h)))).astype(
        np.float32)
    A = np.log(np.arange(1, h + 1, dtype=np.float32))
    Bm, Cm = (rng.normal(size=(b_, nc * t, n)).astype(np.float32)
              for _ in range(2))
    D = rng.normal(size=(h,)).astype(np.float32)
    args = (x, dt, A, Bm, Cm, D)
    y, final = ssm.ssd_scan(*map(torch.tensor, args), t)
    jy, jfinal = jssm.ssd_scan(*map(jnp.asarray, args), t)
    close(y, jy)
    close(final, jfinal)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decode_step_matches_jax(arch):
    """12 recurrent steps, output and cache each step; the port updates
    the cache tensors in place."""
    jcfg, cfg = configs(arch)
    jp, tp = ssm_pair(jcfg, 17)
    rng = np.random.default_rng(18)
    jcache = jssm.init_ssm_cache(jcfg, 2)
    cache = ssm.init_ssm_cache(cfg, 2, "cpu")
    ptrs = {k: v.data_ptr() for k, v in cache.items()}
    for k in cache:
        assert cache[k].shape == jcache[k].shape
        assert str(cache[k].dtype)[6:] == str(jcache[k].dtype), k
    for _ in range(12):
        x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
        want, jcache = jssm.ssm_decode_step(jp, jcfg, x, jcache)
        got, cache = ssm.ssm_decode_step(tp, cfg, torch.tensor(x), cache)
        close(got, want)
        for k in cache:
            close(cache[k], jcache[k])
    assert {k: v.data_ptr() for k, v in cache.items()} == ptrs


def test_init_ssm_full_width_and_const_rounding():
    """``init_ssm`` at Mamba2-780M's and Jamba's full widths in bf16:
    names, shapes and dtypes as the reference's, A_log = log(1..H)
    rounded to bf16 exactly as JAX rounds it (``Builder.const``), D and
    dt_bias 0, norm 1; ``const`` in abstract mode gives a meta tensor and
    with ``into=`` fills the given slice."""
    for arch in SSM_ARCHS:
        cfg = dataclasses.replace(get_config(arch), dtype="bfloat16")
        jb = jlayers.Builder(jax.random.PRNGKey(0), jnp.bfloat16)
        jssm.init_ssm(jb, jcfg := dataclasses.replace(jget_config(arch),
                                                      dtype="bfloat16"))
        gen = torch.Generator()
        gen.manual_seed(0)
        tb = layers.Builder(gen, torch.bfloat16, "cpu")
        ssm.init_ssm(tb, cfg)
        assert sorted(tb.params) == sorted(jb.params)
        for k, t in tb.params.items():
            assert tuple(t.shape) == jb.params[k].shape, k
            assert t.dtype == torch.bfloat16, k
        h = jcfg.ssm.expand * jcfg.d_model // jcfg.ssm.head_dim
        assert tb.params["A_log"].shape == (h,)
        np.testing.assert_array_equal(
            tb.params["A_log"].float().numpy(),
            np.asarray(jb.params["A_log"].astype(jnp.float32)))
        for k, v in (("D", 0), ("dt_bias", 0), ("norm", 1), ("conv_b", 0)):
            assert torch.all(tb.params[k] == v), k
    value = torch.log(torch.arange(1, 49, dtype=torch.float32))
    meta = layers.Builder(None, torch.bfloat16, abstract=True)
    assert meta.const("A_log", value).device.type == "meta"
    stacked = torch.zeros(3, 48, dtype=torch.bfloat16)
    layers.Builder(None, torch.bfloat16, "cpu",
                   into={"A_log": stacked[1]}).const("A_log", value)
    assert torch.equal(stacked[1], value.to(torch.bfloat16))
    assert not stacked[0].any() and not stacked[2].any()


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


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "qwen3-0.6b",
                                  "mamba2-780m", "jamba-v0.1-52b",
                                  "whisper-tiny", "internvl2-2b"])
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
    if arch == "mamba2-780m":
        assert n == 780_148_992
        assert tuple(ours["scan/0/ssm/in_proj"].shape) == (48, 1536, 6448)
    if arch == "jamba-v0.1-52b":
        assert n == 51_460_000_640
    if arch == "whisper-tiny":         # 4 encoder + 4 scanned decoder layers
        assert n == 36_455_040
        assert tuple(ours["scan/0/xattn/wk"].shape) == (4, 384, 6, 64)
    if arch == "internvl2-2b":
        assert n == 1_897_537_536
        assert tuple(ours["projector/w1"].shape) == (2048, 2048)


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


def test_convert_carries_ssm_leaves():
    """A scanned bf16 Mamba2 tree: every SSM leaf arrives with its name,
    stacked shape, dtype and values."""
    jcfg = dataclasses.replace(jreduced(jget_config("mamba2-780m")),
                               num_layers=3, scan_layers=True,
                               dtype="bfloat16")
    tree = nonzero_ssm_leaves(jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(1), jcfg)), 1)
    got = flat(model_params_from_jax(tree, "cpu"))
    want = flat(tree)
    assert sorted(got) == sorted(want)
    for leaf in ("A_log", "D", "dt_bias", "conv_w", "conv_b", "norm",
                 "in_proj", "out_proj"):
        t, a = got[f"scan/0/ssm/{leaf}"], want[f"scan/0/ssm/{leaf}"]
        assert t.dtype == torch.bfloat16 and a.dtype.name == "bfloat16"
        assert t.shape[0] == 3 and tuple(t.shape) == a.shape, leaf
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))
    assert sorted(flat(model.abstract_params(
        dataclasses.replace(reduced(get_config("mamba2-780m")),
                            num_layers=3, scan_layers=True)))) == sorted(got)
