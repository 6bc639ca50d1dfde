"""The reference's memory-linear self-attention above S = 2,048
(``models.attention.blocked_attention_sdpa``) in the port, held against
live JAX on the CPU: the schedule's forward (f32 within 1e-5 of max|out|,
bf16 within ``ref.flash_tc_limit``), the gradients of ``attention`` at S =
2,100 against ``jax.grad`` of the reference's ``attention`` (each within
1e-4 of its max), the call sites that pick it (S <= 2,048 and cross,
bidirectional attention keep the whole plain version, bit for bit),
``attention_tp`` on four CPU shards against unsharded, and the counting
pass on meta: no op output of S x S elements in the blocked backward and a
lower peak than the whole recompute's.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.config import reduced as jreduced
from repro.configs import get_config as jget_config
from repro.models import attention as jattn
from repro.models import layers as jlayers

from repro_torch import counting, sharding
from repro_torch.config import reduced
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch.sharding_rules import base_rules
from repro_torch.models import attention
from repro_torch.models import layers
from repro_torch.sharding import Act, TensorParallel
from torch_threads import one_torch_thread  # noqa: F401

# (S, window, Hq, Hkv): ragged (2,100 pads to 2,560 queries and 3,072
# keys) and whole tiles, causal, a window of 512 and a GQA group of 2
FORWARD_CASES = [(2100, 0, 2, 2), (2100, 512, 4, 2), (3072, 0, 4, 2),
                 (3072, 512, 2, 2)]
HD = 16


def qkv(s, hq, hkv, seed, b=1):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, s, hq, HD)).astype(np.float32),
            rng.normal(size=(b, s, hkv, HD)).astype(np.float32),
            rng.normal(size=(b, s, hkv, HD)).astype(np.float32))


@pytest.fixture(scope="module")
def jax_forward():
    """The reference's blocked outputs, each case run once a module."""
    cache = {}

    def run(case, dtype):
        if (case, dtype) not in cache:
            s, window, hq, hkv = case
            q, k, v = (jnp.asarray(t, dtype) for t in qkv(s, hq, hkv, s))
            out = jattn.blocked_attention_sdpa(q, k, v, causal=True,
                                               window=window)
            cache[case, dtype] = np.asarray(out.astype(jnp.float32))
        return cache[case, dtype]
    return run


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_blocked_forward_matches_jax_f32(case, jax_forward):
    s, window, hq, hkv = case
    want = jax_forward(case, jnp.float32)
    q, k, v = (torch.tensor(t) for t in qkv(s, hq, hkv, s))
    got = attention.blocked_attention_sdpa(q, k, v, causal=True,
                                           window=window)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", FORWARD_CASES[1:3])
def test_blocked_forward_matches_jax_bf16(case, jax_forward):
    """bf16 q, k, v: both sides score and accumulate in fp32 and round the
    output to bf16 once; limit ``ref.flash_tc_limit`` (k and v repeated to
    the query heads, the kernel's layout)."""
    s, window, hq, hkv = case
    want = torch.tensor(jax_forward(case, jnp.bfloat16))
    q, k, v = (torch.tensor(t).to(torch.bfloat16)
               for t in qkv(s, hq, hkv, s))
    got = attention.blocked_attention_sdpa(q, k, v, causal=True,
                                           window=window)
    assert got.dtype == torch.bfloat16
    g = hq // hkv
    heads = [t.transpose(1, 2) for t in
             (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2))]
    lim = ref.flash_tc_limit(*heads, want.transpose(1, 2), causal=True,
                             window=window).transpose(1, 2)
    assert bool(((got.float() - want).abs() <= lim).all())


@pytest.mark.parametrize("case", FORWARD_CASES)
def test_blocked_gradients_match_jax_grad(case):
    """The direct backward of ``blocked_attention_sdpa`` (GQA kv heads not
    repeated, ragged and whole tiles, a window) against ``jax.grad`` of the
    reference's, which differentiates through its checkpointed kv steps:
    f32 dq, dk, dv each within 1e-4 of its max."""
    s, window, hq, hkv = case
    q, k, v = qkv(s, hq, hkv, s + 1)
    go = np.random.default_rng(s + 2).normal(size=q.shape).astype(
        np.float32)

    def jloss(q, k, v):
        return (jattn.blocked_attention_sdpa(q, k, v, causal=True,
                                             window=window) * go).sum()
    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [torch.tensor(t).requires_grad_() for t in (q, k, v)]
    out = attention.blocked_attention_sdpa(*leaves, causal=True,
                                           window=window)
    got = torch.autograd.grad(out, leaves, torch.tensor(go))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("window", [0, 512])
def test_blocked_bf16_gradients_within_the_limit_of_the_whole(window):
    """bf16 q, k, v [1, 2, 2,100, 16] (the kernel's layout) through the
    flash wrapper on the CPU: dq, dk, dv of the blocked schedule against
    the whole recompute's within ``ref.grad_bf16_limit``, chip_smoke's
    limit at the [10] shard shape."""
    q, k, v = (torch.tensor(t).to(torch.bfloat16).transpose(1, 2)
               for t in qkv(2100, 2, 2, 21))
    go = torch.randn(q.shape, generator=torch.Generator().manual_seed(22)
                     ).to(torch.bfloat16)

    def grads(plain):
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        out = ops.flash_attention(*leaves, causal=True, window=window,
                                  plain=plain)
        return torch.autograd.grad(out, leaves, go)
    got = grads(attention._self_plain(2100, window))
    want = grads(None)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        assert bool(((g.float() - w.float()).abs()
                     <= ref.grad_bf16_limit(w)).all())


@pytest.mark.parametrize("sq,sk,window,offset", [(5, 7, 0, 2), (40, 40, 16,
                                                                0)])
def test_causal_mask_matches_jax(sq, sk, window, offset):
    got = attention.causal_mask(sq, sk, window, offset)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jattn.causal_mask(sq, sk, window, offset)))


# ---------------------------------------------------------------------------
# Gradients of ``attention`` through the seam
# ---------------------------------------------------------------------------

def configs(**replace):
    """Tiny qwen3 (GQA 2 over 1, qk_norm, RoPE) on both sides."""
    kw = dict(num_layers=1, d_model=64)
    return (dataclasses.replace(jreduced(jget_config("qwen3-0.6b"), **kw),
                                **replace),
            dataclasses.replace(reduced(get_config("qwen3-0.6b"), **kw),
                                **replace))


def attn_params(jcfg, seed):
    b = jlayers.Builder(jax.random.PRNGKey(seed), jnp.float32)
    jattn.init_attention(b, jcfg)
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.normal(
        size=a.shape)).astype(np.float32), b.params)


def attn_inputs(cfg, s, seed, b=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s), (b, 1)).astype(np.int32)
    go = rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)
    return x, pos, go


def port_grads(fn, tp, x, go):
    """``fn(params, x)``'s output and the gradients of <out, go> for every
    parameter and x."""
    leaves = {k: v.detach().clone().requires_grad_() for k, v in tp.items()}
    xt = torch.tensor(x, requires_grad=True)
    out = fn(leaves, xt)
    grads = torch.autograd.grad(out, [*leaves.values(), xt],
                                torch.tensor(go))
    return out.detach(), dict(zip([*leaves, "x"], grads))


@pytest.mark.parametrize("window", [0, 512])
def test_attention_gradients_match_jax_above_threshold(window):
    """S = 2,100: the port's CPU forward and backward run the blocked
    schedule; the reference's ``attention`` takes its blocked path."""
    jcfg, cfg = configs(num_kv_heads=1)
    np_p = attn_params(jcfg, 7)
    x, pos, go = attn_inputs(cfg, 2100, 8)

    def jloss(p, xx):
        return jnp.sum(jattn.attention(p, jcfg, xx, pos, window=window)
                       * go)
    jp = jax.tree.map(jnp.asarray, np_p)
    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    want = {**{k: np.asarray(v) for k, v in gp.items()}, "x": np.asarray(gx)}
    tp = model_params_from_jax(np_p, "cpu")
    _, got = port_grads(lambda p, xx: attention.attention(
        p, cfg, xx, torch.tensor(pos), window=window), tp, x, go)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=0,
                                   atol=1e-4 * np.abs(want[k]).max(),
                                   err_msg=k)


def whole_attention(p, cfg, x, pos, window=0):
    """``attention`` with the whole plain version at any S (the schedule
    every length ran before the blocked one)."""
    q, k, v = attention._project_qkv(p, cfg, x, x, pos, pos, rope=True)
    return attention._flash(p, cfg, q, k, v, causal=True, window=window)


@pytest.fixture
def blocked_calls(monkeypatch):
    """Counts the calls of ``blocked_attention_sdpa``."""
    calls = []
    real = attention.blocked_attention_sdpa

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(attention, "blocked_attention_sdpa", spy)
    return calls


@pytest.mark.parametrize("s,blocked", [(2048, False), (2049, True)])
def test_the_threshold_picks_the_schedule(s, blocked, blocked_calls):
    """At S = 2,048 the output and every gradient equal the whole
    recompute's bit for bit and the blocked schedule never runs; one key
    past it, the blocked schedule runs in the forward and the backward."""
    jcfg, cfg = configs(num_kv_heads=1)
    tp = model_params_from_jax(attn_params(jcfg, 9), "cpu")
    x, pos, go = attn_inputs(cfg, s, 10)
    pos = torch.tensor(pos)
    out, got = port_grads(lambda p, xx: attention.attention(p, cfg, xx, pos),
                          tp, x, go)
    assert len(blocked_calls) == (2 if blocked else 0)
    if blocked:
        return
    w_out, want = port_grads(lambda p, xx: whole_attention(p, cfg, xx, pos),
                             tp, x, go)
    assert torch.equal(out, w_out)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("site", ["cross", "bidirectional"])
def test_cross_and_bidirectional_keep_the_whole_schedule(site,
                                                         blocked_calls):
    """Above the threshold too: the reference runs ``_sdpa`` there."""
    jcfg, cfg = configs(num_kv_heads=1)
    tp = model_params_from_jax(attn_params(jcfg, 11), "cpu")
    x, _, go = attn_inputs(cfg, 2100, 12)
    enc = torch.tensor(attn_inputs(cfg, 2100, 13)[0])
    if site == "cross":
        fn = lambda p, xx: attention.cross_attention(p, cfg, xx, enc)
    else:
        fn = lambda p, xx: attention.bidirectional_attention(p, cfg, xx)
    out, _ = port_grads(fn, tp, x, go)
    assert out.shape == x.shape and not blocked_calls


# ---------------------------------------------------------------------------
# Tensor parallelism
# ---------------------------------------------------------------------------

@pytest.mark.filterwarnings("ignore:sharding. logical axis")
@pytest.mark.parametrize("kv_heads", [4, 2])
def test_attention_tp_matches_unsharded_above_threshold(kv_heads):
    """``attention_tp`` on ("data", "model") = (1, 4) of ["cpu"] * 4 at S =
    2,100: 4 query heads, one a shard; 4 kv heads split with them, or 2,
    which 4 does not divide (kept whole on each shard, which reads its
    query head's kv head). The output and x's gradient within 1e-5 of
    unsharded's max."""
    jcfg, cfg = configs(num_heads=4, num_kv_heads=kv_heads, head_dim=16)
    b = layers.Builder(torch.Generator().manual_seed(14), torch.float32,
                       "cpu")
    attention.init_attention(b, cfg)
    params, axes = b.params, b.axes
    x, pos, go = attn_inputs(cfg, 2100, 15)
    pos = torch.tensor(pos)
    want, wg = port_grads(lambda p, xx: attention.attention(p, cfg, xx, pos),
                          params, x, go)
    mesh = sharding.make_mesh((1, 4), ("data", "model"), ["cpu"] * 4)
    rules = base_rules(False)
    placed = sharding.place_tree(params, axes, mesh, rules)
    tpar = TensorParallel(mesh, rules)
    xt = torch.tensor(x, requires_grad=True)
    with sharding.logical_rules(mesh, rules):
        out = tpar.gather(attention.attention_tp(
            tpar, placed, cfg, Act([xt] * 4), pos))
    (gx,) = torch.autograd.grad(out, [xt], torch.tensor(go))
    for got, ref_ in ((out.detach(), want), (gx, wg["x"])):
        lim = 1e-5 * float(ref_.abs().max())
        assert float((got - ref_).abs().max()) <= lim


# ---------------------------------------------------------------------------
# The counting pass on meta
# ---------------------------------------------------------------------------

class _Outputs(TorchDispatchMode):
    """The largest op output (elements) seen under it."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


def counted_backward(plain):
    """The flash kernel's forward and recomputed backward at [2, 4, 4096,
    64] bf16 (causal) on meta under a ``counting.Counter``: (the largest op
    output of the backward, the peak bytes)."""
    b, h, s, d = 2, 4, 4096, 64
    with counting.Counter() as c:
        q, k, v = (torch.empty(b, s, h, d, dtype=torch.bfloat16,
                               device="meta").transpose(1, 2)
                   .requires_grad_() for _ in range(3))
        out = ops.flash_attention(q, k, v, causal=True, plain=plain)
        go = torch.empty_like(out)
        with _Outputs() as seen:
            torch.autograd.grad(out, (q, k, v), go)
    return seen.largest, c.peak_bytes, b * h * s * s


def test_counted_blocked_backward_holds_no_s_by_s_tensor():
    largest, peak, s_by_s = counted_backward(attention._self_plain(4096, 0))
    w_largest, w_peak, _ = counted_backward(None)
    assert w_largest >= s_by_s          # the whole recompute holds [S, S]
    assert largest < s_by_s // 4        # a [512, 1024] tile a head
    assert peak < w_peak
