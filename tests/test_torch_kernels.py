"""The port's kernel ops on the CPU (their plain versions, reached through
the ``repro_torch.kernels.ops`` wrappers) against the JAX package's
``ops.*`` Pallas kernels in interpret mode and its ``ref.*`` oracles: the
three gossip mixes, plus the int8 wire encode and ``mix_pytree`` across
backends and wires, flash attention, the MoE router and the Mamba2 SSD
intra-chunk term.

Inputs come from numpy with a seed. W in {4, 13}, ragged F (not a multiple
of any block size) and topologies whose rows have unequal degree, so the
padded-CSR support has pad slots. Tolerances: fp32 results at rtol = atol
= 1e-6 (summation order only); bf16 payloads are rounded once from the
same fp32 values on both sides (both round to nearest even) and compared
in fp32 at the same tolerance; int8 q and scale are bit-equal. Flash
attention at atol 5e-5 in fp32 (the JAX package's own bound; 3e-2 for bf16
outputs, one bf16 rounding of values below 4); the router's indices equal,
its gates within atol 1e-6. The SSD intra-chunk term in fp32 at rtol =
atol = 1e-5 relative to max|y| of the case (summation order only).
"""
from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jgossip
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core import gossip
from repro_torch.kernels import ops, ref

TOL = dict(rtol=1e-6, atol=1e-6)


def ragged_world(w: int, f: int, seed: int):
    """adjacency with row degrees 1..3 (pad slots), row-stochastic P on
    its support with some zero (unsampled) entries, an fp32 [W, F] stack."""
    rng = np.random.default_rng(seed)
    adj = np.zeros((w, w), bool)
    for i in range(w):
        deg = 1 + i % 3
        peers = rng.choice([j for j in range(w) if j != i], size=deg,
                           replace=False)
        adj[i, peers] = True
    keep = (adj & (rng.random((w, w)) < 0.7)) | np.eye(w, dtype=bool)
    P = (keep * rng.uniform(0.5, 1.5, (w, w))).astype(np.float32)
    P /= P.sum(1, keepdims=True)
    x = (rng.normal(size=(w, f)) * 2.0).astype(np.float32)
    return adj, P, x


def as_bf16_pair(x):
    """The same fp32 values rounded to bf16 by each framework."""
    return jnp.asarray(x).astype(jnp.bfloat16), \
        torch.tensor(x).to(torch.bfloat16)


CASES = [(4, 37, 0), (13, 1000, 1), (13, 5, 2)]


@pytest.mark.parametrize("w,f,seed", CASES)
def test_sparse_support_and_weights_match_jax(w, f, seed):
    adj, P, _ = ragged_world(w, f, seed)
    j_idx, j_valid = jgossip.sparse_support(adj)
    idx, valid = gossip.sparse_support(adj)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(valid, j_valid)
    assert not valid.all(), "the world must have pad slots"
    j_idx_t, j_val = jgossip.sparse_weights(jnp.asarray(P), adj)
    idx_t, val = gossip.sparse_weights(torch.tensor(P), adj)
    assert idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(j_idx_t))
    np.testing.assert_array_equal(val.numpy(), np.asarray(j_val))


@pytest.mark.parametrize("w,f,seed", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_gossip_mix_matches_jax(w, f, seed, dtype):
    _, P, x = ragged_world(w, f, seed)
    if dtype == "bfloat16":
        jw, tw = as_bf16_pair(x)
    elif dtype == "int8":
        q = np.clip(np.round(x * 20), -127, 127).astype(np.int8)
        jw, tw = jnp.asarray(q), torch.tensor(q)
    else:
        jw, tw = jnp.asarray(x), torch.tensor(x)
    got = ops.gossip_mix(torch.tensor(P), tw)
    assert got.dtype == torch.float32 and got.shape == (w, f)
    want = jops.gossip_mix(jnp.asarray(P), jw, out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = jref.gossip_mix_ref(jnp.asarray(P), jw.astype(jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("w,f,seed", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gossip_mix_sparse_matches_jax(w, f, seed, dtype):
    adj, P, x = ragged_world(w, f, seed)
    j_idx, j_val = jgossip.sparse_weights(jnp.asarray(P), adj)
    idx, val = gossip.sparse_weights(torch.tensor(P), adj)
    jw, tw = as_bf16_pair(x) if dtype == "bfloat16" \
        else (jnp.asarray(x), torch.tensor(x))
    got = ops.gossip_mix_sparse(idx, val, tw)
    assert got.dtype == torch.float32 and got.shape == (w, f)
    want = jops.gossip_mix_sparse(j_idx, j_val, jw, out_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = jref.gossip_mix_sparse_ref(j_idx, j_val,
                                        jw.astype(jnp.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    # the sparse mix is the dense mix on P's support
    np.testing.assert_allclose(got.numpy(),
                               ref.gossip_mix_ref(torch.tensor(P),
                                                  tw).numpy(), **TOL)


@pytest.mark.parametrize("w,f,seed", CASES)
def test_gossip_mix_quant_matches_jax(w, f, seed):
    adj, P, x = ragged_world(w, f, seed)
    jq, jscale = jgossip.quantize_rows_int8(jnp.asarray(x))
    q, scale = gossip.quantize_rows_int8(torch.tensor(x))
    j_idx, j_val = jgossip.sparse_weights(jnp.asarray(P), adj)
    idx, val = gossip.sparse_weights(torch.tensor(P), adj)
    got = ops.gossip_mix_quant(idx, val, scale, q)
    assert got.dtype == torch.float32 and got.shape == (w, f)
    want = jops.gossip_mix_quant(j_idx, j_val, jscale, jq)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = jref.gossip_mix_quant_ref(j_idx, j_val, jscale, jq)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rows_int8_bit_equal_to_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(7, 301)) * 10.0 ** rng.uniform(-6, 3, (7, 1))) \
        .astype(np.float32)
    # exact round-half ties: max|row| = 127 makes scale 1.0, so the
    # scaled values are exactly k + 0.5 (half to even on both sides)
    x[0, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -3.5]
    x[1] = 0.0                                  # all-zero row: 1e-12 floor
    jq, jscale = jgossip.quantize_rows_int8(jnp.asarray(x))
    q, scale = gossip.quantize_rows_int8(torch.tensor(x))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(scale.numpy().view(np.uint32),
                                  np.asarray(jscale).view(np.uint32))
    np.testing.assert_array_equal(q.numpy()[0, 1:6], [0, 2, 2, 0, -4])
    np.testing.assert_array_equal(
        gossip.dequantize_rows_int8(q, scale).numpy(),
        np.asarray(jgossip.dequantize_rows_int8(jq, jscale)))


@pytest.mark.parametrize("wire", ["bf16", "int8"])
def test_encode_rows_with_residual_bit_equal_to_jax(wire):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(5, 77)).astype(np.float32)
    r = (rng.normal(size=(5, 77)) * 1e-2).astype(np.float32)
    jp, js, jr = jgossip._encode_rows(jnp.asarray(x), jnp.asarray(r), wire)
    p, s, nr = gossip._encode_rows(torch.tensor(x), torch.tensor(r), wire)
    np.testing.assert_array_equal(p.float().numpy(),
                                  np.asarray(jp.astype(jnp.float32)))
    np.testing.assert_array_equal(nr.numpy(), np.asarray(jr))
    if wire == "int8":
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    else:
        assert s is None and js is None


def _leaves(w, seed):
    rng = np.random.default_rng(seed)
    return {"w1": rng.normal(size=(w, 6, 7)).astype(np.float32),
            "b1": rng.normal(size=(w, 7)).astype(np.float32),
            "b2": (rng.normal(size=(w, 3)) * 50).astype(np.float32)}


@pytest.mark.parametrize("backend", ["einsum", "pallas", "sparse", "auto"])
@pytest.mark.parametrize("wire", [None, "bf16", "int8"])
def test_mix_pytree_matches_jax(backend, wire):
    """The transport module as a whole, leaf by leaf, with EF21 residuals
    on the lossy wires. W=13 with row degrees 1..3 has density 0.23, so
    ``auto`` resolves to sparse on both sides."""
    adj, P, _ = ragged_world(13, 4, 4)
    assert gossip._resolve_backend("auto", adj, 13) == "sparse"
    leaves = _leaves(13, 5)
    res = {k: (np.random.default_rng(6).normal(size=v.shape) * 1e-2)
           .astype(np.float32) for k, v in leaves.items()}
    jres = {k: jnp.asarray(v) for k, v in res.items()} if wire else None
    tres = {k: torch.tensor(v) for k, v in res.items()} if wire else None
    want = jgossip.mix_pytree(jnp.asarray(P),
                              {k: jnp.asarray(v) for k, v in leaves.items()},
                              backend=backend, adjacency=adj, wire=wire,
                              residual=jres)
    got = gossip.mix_pytree(torch.tensor(P),
                            {k: torch.tensor(v) for k, v in leaves.items()},
                            backend=backend, adjacency=adj, wire=wire,
                            residual=tres)
    if wire is not None:
        (want, want_r), (got, got_r) = want, got
        for k in leaves:
            np.testing.assert_array_equal(got_r[k].numpy(),
                                          np.asarray(want_r[k]))
    assert sorted(got) == sorted(want)
    for k in leaves:
        assert got[k].shape == leaves[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-5)


def test_wrappers_check_inputs_and_count_only_kernel_launches():
    adj, P, x = ragged_world(4, 9, 0)
    idx, val = gossip.sparse_weights(torch.tensor(P), adj)
    before = dict(ops.LAUNCHES)
    ops.gossip_mix(torch.tensor(P), torch.tensor(x))
    ops.gossip_mix_sparse(idx, val, torch.tensor(x))
    assert ops.LAUNCHES == before            # plain versions: no launches
    with pytest.raises(TypeError):
        ops.gossip_mix_sparse(idx.long(), val, torch.tensor(x))
    with pytest.raises(TypeError):
        ops.gossip_mix_quant(idx, val, torch.ones(4),
                             torch.tensor(x))          # not int8
    with pytest.raises(ValueError):
        ops.gossip_mix(torch.tensor(P)[:3], torch.tensor(x))
    with pytest.raises(ValueError):
        ops.gossip_mix(torch.tensor(P), torch.tensor(x).t().contiguous()
                       .t())


# ---------------------------------------------------------------------------
# Flash attention and the MoE router
# ---------------------------------------------------------------------------

def qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(dtype) for _ in range(3)]


@pytest.mark.parametrize("b,h,s,d", [(2, 4, 256, 64), (1, 2, 128, 32),
                                     (1, 2, 200, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
def test_flash_attention_matches_jax(b, h, s, d, causal, window):
    """The shapes of the JAX package's kernel tests, S <= 256. At S = 200
    (not a block multiple) without the causal mask the JAX wrapper's
    zero-padded keys enter the softmax (repro/kernels/ops.py:89-91), so
    that case is held against the JAX oracle only; the port masks
    ``kpos < S`` instead of padding."""
    q, k, v = qkv((b, h, s, d), b + h + s + d)
    got = ops.flash_attention(*map(torch.tensor, (q, k, v)), causal=causal,
                              window=window)
    want = jref.flash_attention_ref(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    if causal or s % 128 == 0:
        kern = jops.flash_attention(q, k, v, causal=causal, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(kern), atol=5e-5)


def test_flash_attention_bf16_and_strided_layout():
    q, k, v = qkv((1, 2, 256, 64), 7)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    tq, tk, tv = (torch.tensor(x).to(torch.bfloat16) for x in (q, k, v))
    got = ops.flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    want = jops.flash_attention(jq, jk, jv)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)
    # a [B, S, H, D] tensor read through its transposed view
    f = [torch.tensor(x).transpose(1, 2).contiguous().transpose(1, 2)
         for x in (q, k, v)]
    np.testing.assert_allclose(
        ops.flash_attention(*f, window=32).numpy(),
        np.asarray(jref.flash_attention_ref(q, k, v, window=32)), atol=5e-5)


def router_logits(t, e, seed, ties: bool):
    """Normal logits; with ``ties``, every third row repeats values (an
    exact tie at the top and inside the top-k)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, e)).astype(np.float32)
    if ties:
        x[::3, : e // 2] = 6.0          # above every normal draw
        x[1::3, ::4] = np.round(x[1::3, ::4])
    return x


@pytest.mark.parametrize("t,e,k", [(64, 8, 2), (100, 64, 6), (512, 384, 8),
                                   (33, 16, 2), (4, 64, 6)])
@pytest.mark.parametrize("ties", [False, True])
def test_moe_router_topk_matches_jax(t, e, k, ties):
    x = router_logits(t, e, t + e, ties)
    gates, idx = ops.moe_router_topk(torch.tensor(x), k)
    assert gates.dtype == torch.float32 and idx.dtype == torch.int32
    for jg, ji in (jops.moe_router_topk(jnp.asarray(x), k),
                   jref.moe_router_topk_ref(jnp.asarray(x), k)):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
        np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=0,
                                   atol=1e-6)
    if ties:                    # the lower index first on an exact tie
        np.testing.assert_array_equal(idx.numpy()[0, :k], np.arange(k))
    gates_bf, idx_bf = ops.moe_router_topk(
        torch.tensor(x).to(torch.bfloat16), k)
    want_g, want_i = ref.moe_router_topk_ref(
        torch.tensor(x).to(torch.bfloat16).float(), k)
    torch.testing.assert_close(idx_bf, want_i, rtol=0, atol=0)
    torch.testing.assert_close(gates_bf, want_g, rtol=0, atol=0)


def test_new_wrappers_check_inputs_and_count_only_kernel_launches():
    q, k, v = (torch.tensor(x) for x in qkv((1, 2, 16, 32), 0))
    logits = torch.tensor(router_logits(8, 16, 0, False))
    before = dict(ops.LAUNCHES)
    ops.flash_attention(q, k, v)
    ops.moe_router_topk(logits, 2)
    assert ops.LAUNCHES == before            # plain versions: no launches
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(q[..., :16], k[..., :16], v[..., :16])
    with pytest.raises(TypeError):
        ops.flash_attention(q, k.double(), v)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="strides"):
        ops.flash_attention(q, k.transpose(1, 2).contiguous().transpose(
            1, 2), v)
    with pytest.raises(ValueError):
        ops.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=-1)
    with pytest.raises(ValueError):
        ops.moe_router_topk(logits, 17)                   # k > E
    with pytest.raises(ValueError):
        ops.moe_router_topk(torch.zeros(4, 513), 2)       # E > 512
    with pytest.raises(ValueError):
        ops.moe_router_topk(torch.zeros(4, 64), 33)       # k > 32
    with pytest.raises(TypeError):
        ops.moe_router_topk(logits.double(), 2)
    with pytest.raises(ValueError):
        ops.moe_router_topk(logits.t(), 2)                # not contiguous


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_side_checks_and_launch_arguments(monkeypatch, dtype):
    """The wrappers' card-side branch, driven on the CPU with the launch
    stubbed: the C entry receives B*H (SIMT) or B (tensor cores), H, S,
    D, q's and out's (b, h, s) element strides of a [B, S, H, D] tensor
    read through its transposed view, the mask flags and, for the SIMT
    kernel, the dtype code; bf16 at D = 64 goes to the tensor-core kernel;
    misaligned input is refused before any launch."""
    calls = []
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops, "_launch",
                        lambda name, out, *args: calls.append(
                            (name, args)) or out)
    b, s, h, d = 2, 40, 3, 64
    q, k, v = (torch.zeros(b, s, h, d, dtype=dtype).transpose(1, 2)
               for _ in range(3))
    out = ops.flash_attention(q, k, v, causal=False, window=7)
    assert out.shape == q.shape and out.stride() == q.stride()
    name, args = calls.pop()
    if dtype == torch.bfloat16:
        assert name == "flash_attention_tc"
        assert args[4:] == (b, h, s, d, s * h * d, d, h * d, s * h * d, d,
                            h * d, 0, 7)
    else:
        assert name == "flash_attention"
        assert args[4:] == (b * h, h, s, d, s * h * d, d, h * d, s * h * d,
                            d, h * d, 0, 7, ops._DTYPE_CODE[dtype])
    gates, idx = ops.moe_router_topk(torch.zeros(5, 64, dtype=dtype), 6)
    assert gates.shape == idx.shape == (5, 6) and idx.dtype == torch.int32
    name, args = calls.pop()
    assert name == "moe_router" and args[3:] == (5, 64, 6,
                                                 ops._DTYPE_CODE[dtype])
    odd = torch.zeros(b * h * s * d + 1, dtype=dtype)[1:].view(b, h, s, d)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(odd, odd, odd)
    assert calls == []



# ---------------------------------------------------------------------------
# The tensor-core flash kernel: dispatch, launch arguments, numerics
# ---------------------------------------------------------------------------

def stub_launches(monkeypatch):
    """Drive the card-side branch on the CPU: every launch is recorded as
    (name, args) and returns its output unfilled."""
    calls = []
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops, "_launch",
                        lambda name, out, *args: calls.append(
                            (name, args)) or out)
    return calls


@pytest.mark.parametrize("dtype,d,name", [
    (torch.float32, 32, "flash_attention"),
    (torch.float32, 64, "flash_attention"),
    (torch.float32, 128, "flash_attention"),
    (torch.bfloat16, 32, "flash_attention"),
    (torch.bfloat16, 64, "flash_attention_tc"),
    (torch.bfloat16, 128, "flash_attention_tc")])
def test_flash_attention_dispatch_by_dtype_and_head_dim(monkeypatch, dtype,
                                                        d, name):
    """On the card the kernel follows from dtype and D alone: bf16 at D in
    {64, 128} launches the tensor-core kernel, f32 at any D and bf16 at
    D = 32 the SIMT kernel; one launch per call."""
    calls = stub_launches(monkeypatch)
    q, k, v = (torch.zeros(2, 3, 40, d, dtype=dtype) for _ in range(3))
    out = ops.flash_attention(q, k, v)
    assert out.dtype == dtype and out.shape == q.shape
    assert [c[0] for c in calls] == [name]
    assert ops.FLASH_TC_HEAD_DIMS == (64, 128)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("layout", ["bshd", "bhsd", "bshd-b1"])
def test_flash_attention_tc_launch_arguments(monkeypatch, d, layout):
    """The tensor-core entry gets B, H, S, D, the (b, h, s) element strides
    of the tensor maps (the tensor's own; a size-1 dim's, never used, as
    D) and out's, and the mask flags: for the main path's [B, S, H, D]
    view and for a contiguous [B, H, S, D] tensor, read in place."""
    calls = stub_launches(monkeypatch)
    b, s, h = (1 if layout == "bshd-b1" else 2), 40, 3
    if layout == "bhsd":
        q, k, v = (torch.zeros(b, h, s, d, dtype=torch.bfloat16)
                   for _ in range(3))
        strides = (h * s * d, s * d, d)
    else:
        q, k, v = (torch.zeros(b, s, h, d, dtype=torch.bfloat16)
                   .transpose(1, 2) for _ in range(3))
        strides = (s * h * d if b > 1 else d, d, h * d)
    out = ops.flash_attention(q, k, v, causal=True, window=5)
    assert out.stride() == q.stride()
    (name, args), = calls
    assert name == "flash_attention_tc"
    assert args[:4] == (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr())
    assert args[4:] == (b, h, s, d) + strides + out.stride()[:3] + (1, 5)


def test_flash_attention_tc_refuses_what_tma_cannot_read(monkeypatch):
    """TMA reads 16-byte aligned bases and strides of whole 16 bytes: a
    row stride of D + 4 bf16 (136 bytes at D = 64) and a base 2 bytes off
    are refused with a ValueError before any launch; f32 with the same
    strides still goes to the SIMT kernel."""
    calls = stub_launches(monkeypatch)
    b, h, s, d = 2, 3, 40, 64
    padded = [torch.zeros(b, h, s, d + 4, dtype=torch.bfloat16)[..., :d]
              for _ in range(3)]
    with pytest.raises(ValueError, match="16 bytes"):
        ops.flash_attention(*padded)
    flat = torch.zeros(b * h * s * d + 1, dtype=torch.bfloat16)
    odd = flat[1:].view(b, h, s, d)
    with pytest.raises(ValueError, match="aligned"):
        ops.flash_attention(odd, odd, odd)
    assert calls == []
    ops.flash_attention(*(t.float() for t in padded))
    assert [c[0] for c in calls] == ["flash_attention"]


def tc_emulation(q, k, v, causal, window, *, causal_shift=0,
                 window_shift=0, rescale=True, mask_ragged=True, bk=128):
    """The tensor-core kernel's numerics in plain torch: 128-key tiles,
    running max and sum in fp32 (exp2 domain), p rounded to bf16 before
    P.V, l summed from the fp32 p, the output rounded to bf16. The
    keywords make faulty variants: a causal mask ``causal_shift`` keys
    late, a window edge ``window_shift`` keys early, no alpha rescale of
    the earlier tiles, keys past S (zero-filled) left unmasked."""
    q, k, v = (x.float() for x in (q, k, v))
    s, d = q.shape[2], q.shape[3]
    n = -(-s // bk)
    pad = (0, 0, 0, n * bk - s)
    kp, vp = torch.nn.functional.pad(k, pad), torch.nn.functional.pad(v, pad)
    c = math.log2(math.e) / math.sqrt(d)
    m = torch.full(q.shape[:3], -math.inf)
    l = torch.zeros(q.shape[:3])
    acc = torch.zeros(q.shape)
    qpos = torch.arange(s)[:, None]
    for t in range(n):
        kt, vt = kp[:, :, t * bk:(t + 1) * bk], vp[:, :, t * bk:(t + 1) * bk]
        kpos = torch.arange(t * bk, (t + 1) * bk)[None, :]
        ok = torch.ones(s, bk, dtype=torch.bool)
        if mask_ragged:
            ok &= kpos < s
        if causal:
            ok &= kpos <= qpos + causal_shift
        if window > 0:
            ok &= kpos > qpos - window - window_shift
        sc = (q @ kt.transpose(-1, -2)).masked_fill(~ok, -math.inf)
        m_new = torch.maximum(m, sc.amax(-1) * c)
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        p = torch.exp2(sc * c - m_use[..., None])
        if rescale:
            alpha = torch.exp2(m - m_use)
            l, acc = l * alpha, acc * alpha[..., None]
        l = l + p.sum(-1)
        acc = acc + p.bfloat16().float() @ vt
        m = m_new
    return (acc / l.clamp_min(1e-20)[..., None]).bfloat16()


def tc_worst_ratio(got, q, k, v, causal, window, want=None):
    """max |got - want| / ref.flash_tc_limit over the elements; ``want``
    defaults to the port's plain version."""
    if want is None:
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    lim = ref.flash_tc_limit(q, k, v, want, causal=causal, window=window)
    return float(((got.float() - want.float()).abs() / lim).max())


@pytest.mark.parametrize("s", [17, 64, 200, 300])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128),
                                           (False, 0)])
def test_tc_numerics_stay_inside_the_stated_limit(s, d, causal, window):
    """The kernel's numerics (``tc_emulation``) on bf16 inputs from numpy
    stay inside ``ref.flash_tc_limit`` against the JAX package's oracle
    over shapes, masks and two seeds. The oracle gets the same bf16 values
    in f32 and its f32 output is rounded to bf16 (on bf16 arrays it rounds
    the scores and probabilities to bf16 itself, a coarser contract than
    the plain version's fp32)."""
    for seed in (0, 1):
        tq, tk, tv = (torch.tensor(x).to(torch.bfloat16)
                      for x in qkv((2, 2, s, d), seed + s + d))
        jq, jk, jv = (jnp.asarray(x.float().numpy()) for x in (tq, tk, tv))
        want = torch.tensor(np.asarray(jref.flash_attention_ref(
            jq, jk, jv, causal=causal, window=window))).to(torch.bfloat16)
        got = tc_emulation(tq, tk, tv, causal, window)
        assert tc_worst_ratio(got, tq, tk, tv, causal, window, want) <= 1.0


@pytest.mark.parametrize("kind", sorted(ref.FLASH_ADVERSARIAL))
@pytest.mark.parametrize("d", [64, 128])
def test_tc_numerics_hold_on_the_adversarial_cases(kind, d):
    """The emulation stays inside the limit on every adversarial case."""
    q, k, v, causal, window = (x.to(torch.bfloat16) if torch.is_tensor(x)
                               else x for x in ref.flash_adversarial(kind, d))
    assert tc_worst_ratio(tc_emulation(q, k, v, causal, window), q, k, v,
                          causal, window) <= 1.0


@pytest.mark.parametrize("kind,fault", [
    ("diagonal", {"causal_shift": 1}),
    ("window_edge", {"window_shift": 1}),
    ("ragged_negative", {"mask_ragged": False}),
    ("growing", {"rescale": False}),
    ("diagonal", {"rescale": False}),
    ("window_edge", {"causal_shift": 1})])
@pytest.mark.parametrize("d", [64, 128])
def test_adversarial_cases_catch_mask_and_rescale_faults(kind, fault, d):
    """A mask one key off, keys past a ragged S left in, or a missing alpha
    rescale move the output on its adversarial case by more than 20 times
    the limit, so the card check would catch each."""
    q, k, v, causal, window = (x.to(torch.bfloat16) if torch.is_tensor(x)
                               else x for x in ref.flash_adversarial(kind, d))
    got = tc_emulation(q, k, v, causal, window, **fault)
    assert tc_worst_ratio(got, q, k, v, causal, window) > 20.0


# ---------------------------------------------------------------------------
# The Mamba2 SSD intra-chunk term
# ---------------------------------------------------------------------------

def ssd_case(g, h, t, n, p, seed, steep):
    """C, B [G, T, N]; acum, dt [G, H, T]; x [G, H, T, P] from numpy.
    ``steep``: the real model's decays, A = -exp(log(1..H)) * 48 / H so
    the last head reaches A = -48, dt = softplus(normal) (acum falls by
    up to ~33 a step); else the JAX package's own mild draws."""
    rng = np.random.default_rng(seed)
    C = rng.normal(size=(g, t, n)).astype(np.float32)
    B = rng.normal(size=(g, t, n)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(g, h, t)))).astype(np.float32)
    if steep:
        A = -np.arange(1, h + 1, dtype=np.float32) * (48.0 / h)
        acum = np.cumsum(dt * A[None, :, None], axis=-1).astype(np.float32)
    else:
        acum = -np.abs(rng.normal(size=(g, h, t))).cumsum(-1).astype(
            np.float32)
    x = rng.normal(size=(g, h, t, p)).astype(np.float32)
    return C, B, acum, dt, x


def ssd_close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("t", [32, 64, 200])
@pytest.mark.parametrize("n,p", [(16, 16), (16, 32), (32, 16), (32, 32)])
@pytest.mark.parametrize("steep", [False, True])
def test_ssd_chunk_matches_jax(t, n, p, steep):
    """The wrapper's plain version against the JAX package's Pallas kernel
    (interpret mode) and its oracle; the steep case must reach decays
    whose exp(acum[q]) * exp(-acum[k]) would overflow."""
    args = ssd_case(2, 3, t, n, p, t + n + p, steep)
    if steep:
        assert args[2].min() < -88.0       # exp(88.7) is fp32's largest
    got = ops.ssd_chunk(*map(torch.tensor, args))
    assert got.dtype == torch.float32 and got.shape == (2, 3, t, p)
    assert torch.isfinite(got).all()
    ssd_close(got, jops.ssd_chunk(*map(jnp.asarray, args)))
    ssd_close(got, jref.ssd_chunk_ref(*map(jnp.asarray, args)))


def test_ssd_chunk_is_the_y_diag_of_jax_ssd_scan():
    """On the chunk views that ``models.ssm.ssd_chunk_inputs`` builds (x a
    transposed view, not a copy) the op computes the JAX model's y_diag
    (``repro.models.ssm.ssd_scan``, the einsum with ``_segsum``)."""
    from repro.models.ssm import _segsum
    from repro_torch.models import ssm
    rng = np.random.default_rng(9)
    b_, nc, t, hh, n, p = 2, 3, 32, 4, 16, 32
    x = rng.normal(size=(b_, nc * t, hh, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b_, nc * t, hh)))) \
        .astype(np.float32)
    A_log = np.log(np.arange(1, hh + 1, dtype=np.float32))
    Bm = rng.normal(size=(b_, nc * t, n)).astype(np.float32)
    Cm = rng.normal(size=(b_, nc * t, n)).astype(np.float32)
    args, _ = ssm.ssd_chunk_inputs(*map(torch.tensor, (x, dt, A_log, Bm, Cm)),
                                   t)
    xg = args[4]
    assert xg.shape == (b_ * nc, hh, t, p) and not xg.is_contiguous()
    assert xg.stride() == (t * hh * p, p, hh * p, 1)
    got = ops.ssd_chunk(*args).transpose(1, 2).reshape(b_, nc, t, hh, p)

    xc = jnp.asarray(x).reshape(b_, nc, t, hh, p)
    dtc = jnp.asarray(dt).reshape(b_, nc, t, hh)
    Cc = jnp.asarray(Cm).reshape(b_, nc, t, n)
    Bc = jnp.asarray(Bm).reshape(b_, nc, t, n)
    dA = jnp.moveaxis(dtc * (-jnp.exp(A_log))[None, None, None, :], -1, 2)
    L = jnp.exp(_segsum(dA))
    scores = jnp.einsum("bcqn,bckn->bcqk", Cc, Bc)
    want = jnp.einsum("bcqk,bchqk,bckh,bckhp->bcqhp", scores, L, dtc, xc)
    ssd_close(got, want)


def test_ssd_chunk_wrapper_checks_and_counts_only_launches():
    C, B, acum, dt, x = map(torch.tensor, ssd_case(2, 3, 40, 16, 32, 0,
                                                   False))
    before = dict(ops.LAUNCHES)
    ops.ssd_chunk(C, B, acum, dt, x)
    assert ops.LAUNCHES == before            # plain version: no launch
    with pytest.raises(TypeError):
        ops.ssd_chunk(C.double(), B, acum, dt, x)
    with pytest.raises(TypeError):
        ops.ssd_chunk(C, B, acum, dt, x.to(torch.bfloat16))
    with pytest.raises(ValueError, match="N = 8"):
        ops.ssd_chunk(C[..., :8].contiguous(), B[..., :8].contiguous(),
                      acum, dt, x)
    with pytest.raises(ValueError, match="P = 24"):
        ops.ssd_chunk(C, B, acum, dt, x[..., :24].contiguous())
    with pytest.raises(ValueError, match="T = 300"):
        big = ssd_case(1, 1, 300, 16, 16, 1, False)
        ops.ssd_chunk(*map(torch.tensor, big))
    with pytest.raises(ValueError):
        ops.ssd_chunk(C, B[:, :39], acum, dt, x)           # T differs
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_chunk(C.transpose(1, 2).contiguous().transpose(1, 2), B,
                      acum, dt, x)
    with pytest.raises(ValueError, match="head dim"):
        ops.ssd_chunk(C, B, acum, dt,
                      x.transpose(2, 3).contiguous().transpose(2, 3))


def test_ssd_chunk_card_side_launch_arguments(monkeypatch):
    """The card-side branch with the launch stubbed: the C entry (at
    P = 64 the tensor-core kernel's, ``ops.ssd_kernel``) gets G, H, T, N,
    P and x's and y's (g, h, t) element strides of the model's [G, T, H, P]
    view; y keeps x's layout; a misaligned x is refused before any
    launch."""
    calls = []
    monkeypatch.setattr(ops, "_on_card", lambda *ts: True)
    monkeypatch.setattr(ops, "_launch",
                        lambda name, out, *args: calls.append(
                            (name, args)) or out)
    g, t, h, n, p = 3, 200, 5, 32, 64
    C, B = torch.zeros(g, t, n), torch.zeros(g, t, n)
    acum, dt = torch.zeros(g, h, t), torch.zeros(g, h, t)
    x = torch.zeros(g, t, h, p).transpose(1, 2)
    y = ops.ssd_chunk(C, B, acum, dt, x)
    assert y.shape == x.shape and y.stride() == x.stride()
    name, args = calls.pop()
    assert name == "ssd_chunk_tc"
    assert args[6:] == (g, h, t, n, p, t * h * p, p, h * p, t * h * p, p,
                        h * p)
    odd = torch.zeros(g * t * h * p + 1)[1:].view(g, t, h, p).transpose(1, 2)
    with pytest.raises(ValueError, match="aligned"):
        ops.ssd_chunk(C, B, acum, dt, odd)
    with pytest.raises(ValueError, match="aligned"):        # rows of 6 words
        ops.ssd_chunk(C, B, acum, dt,
                      torch.zeros(g, t, h, p + 2)[..., :p].transpose(1, 2))
    assert calls == []


# ---------------------------------------------------------------------------
# The tensor-core SSD kernel: dispatch, launch arguments, numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 32, 64, 128])
@pytest.mark.parametrize("p", [16, 32, 64])
def test_ssd_kernel_choice_by_state_and_head_dim(monkeypatch, n, p):
    """On the card the kernel follows from N and P alone: P in {32, 64}
    launches the tensor-core kernel, P = 16 the SIMT kernel, at every N
    the wrapper takes; one launch per call, of the kernel ``ssd_kernel``
    names."""
    want = "ssd_chunk_tc" if p in (32, 64) else "ssd_chunk"
    assert ops.ssd_kernel(n, p) == want
    assert ops.SSD_TC_HEAD_DIMS == (32, 64)
    calls = stub_launches(monkeypatch)
    g, h, t = 2, 3, 40
    y = ops.ssd_chunk(torch.zeros(g, t, n), torch.zeros(g, t, n),
                      torch.zeros(g, h, t), torch.zeros(g, h, t),
                      torch.zeros(g, h, t, p))
    assert y.shape == (g, h, t, p) and [c[0] for c in calls] == [want]


@pytest.mark.parametrize("layout", ["model", "contiguous", "model-g1"])
@pytest.mark.parametrize("n,p", [(128, 64), (16, 64), (16, 32)])
def test_ssd_chunk_tc_launch_arguments(monkeypatch, layout, n, p):
    """The tensor-core entry at the main paths' (N, P) gets the six
    pointers in order (C, B, acum, dt, x, y), G, H, T, N, P and x's and
    y's (g, h, t) element strides, for the model's [G, T, H, P] view and
    a contiguous x, both read in place; y keeps x's layout. Misaligned
    bases and rows that are not whole 16 bytes are refused before any
    launch."""
    calls = stub_launches(monkeypatch)
    g, t, h = (1 if layout == "model-g1" else 3), 200, 5
    C, B = torch.zeros(g, t, n), torch.zeros(g, t, n)
    acum, dt = torch.zeros(g, h, t), torch.zeros(g, h, t)
    x = torch.zeros(g, h, t, p) if layout == "contiguous" \
        else torch.zeros(g, t, h, p).transpose(1, 2)
    y = ops.ssd_chunk(C, B, acum, dt, x)
    assert y.shape == x.shape and y.stride() == x.stride()
    (name, args), = calls
    assert name == "ssd_chunk_tc"
    assert args[:6] == (C.data_ptr(), B.data_ptr(), acum.data_ptr(),
                        dt.data_ptr(), x.data_ptr(), y.data_ptr())
    assert args[6:11] == (g, h, t, n, p)
    assert args[11:] == tuple(x.stride()[:3]) + tuple(y.stride()[:3])
    calls.clear()
    odd = torch.zeros(g * t * h * p + 1)[1:].view(g, t, h, p).transpose(1, 2)
    with pytest.raises(ValueError, match="aligned"):
        ops.ssd_chunk(C, B, acum, dt, odd)
    with pytest.raises(ValueError, match="aligned"):        # rows of p + 2
        ops.ssd_chunk(C, B, acum, dt,
                      torch.zeros(g, t, h, p + 2)[..., :p].transpose(1, 2))
    oddC = torch.zeros(g * t * n + 1)[1:].view(g, t, n)
    with pytest.raises(ValueError, match="aligned"):
        ops.ssd_chunk(oddC, B, acum, dt, x)
    assert calls == []


def tf32_round(v):
    """fp32 -> the nearest TF32 value (10 mantissa bits), ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds: on the magnitude bits, which a
    carry into the exponent handles."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_truncate(v):
    """The TF32 value the tensor cores read from fp32 bits: the top 19."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def tf32_product(a, b, passes=3):
    """a @ b as the kernel's mma.sync products form it: each operand split
    into hi = tf32_round(v) and lo = v - hi (exact), which the tensor
    cores read truncated to TF32; lo.hi + hi.lo + hi.hi summed in fp32
    (``passes=1``: one TF32 product, hi.hi)."""
    ah, bh = tf32_round(a), tf32_round(b)
    if passes == 1:
        return ah @ bh
    al, bl = tf32_truncate(a - ah), tf32_truncate(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def ssd_tc_emulation(C, B, acum, dt, x, *, passes=3, causal_shift=0,
                     zero_fill=True):
    """The tensor-core SSD kernel's numerics in plain torch: the chunk
    padded to whole 64-key tiles as the kernel stages it (C, B and x past T
    zero-filled; acum and dt past T hold NaN, as unwritten shared memory
    may), S = C.B^T and Y = W.X in 3xTF32 (``tf32_product``). W = S *
    exp(acum[q] - acum[k]) * dt[k]: below the diagonal tile as the product
    of exp(acum[q] - c) and exp(c - acum[k]) * dt[k], with c = acum at the
    last key of k's tile; on the diagonal tile selected for k <= q (the
    masked difference is -inf) and 0 elsewhere; key tiles above it are
    never visited. Rows at or past T are cut off. Faulty variants: one
    TF32 product (``passes=1``), the mask ``causal_shift`` keys late, x
    past a ragged T not zero-filled (NaN, as memory past the chunk may
    hold)."""
    g, t, n = C.shape
    tp = -(-t // 64) * 64
    pad = tp - t
    nan = float("nan")
    Cp = torch.nn.functional.pad(C, (0, 0, 0, pad))
    Bp = torch.nn.functional.pad(B, (0, 0, 0, pad))
    ap = torch.nn.functional.pad(acum, (0, pad), value=nan)
    dp = torch.nn.functional.pad(dt, (0, pad), value=nan)
    xp = torch.nn.functional.pad(x, (0, 0, 0, pad),
                                 value=0.0 if zero_fill else nan)
    S = tf32_product(Cp, Bp.transpose(1, 2), passes)[:, None]  # [G,1,TP,TP]
    q = torch.arange(tp)[:, None]
    k = torch.arange(tp)[None, :]
    below = k // 64 < q // 64
    diag = (k // 64 == q // 64) & (k <= q + causal_shift)
    last = k[0] | 63                                   # c's key, per k
    aq, ak = ap[..., :, None], ap[..., None, :]
    row = torch.exp(aq - ap[..., None, last])
    key = (torch.exp(ap[..., last] - ap) * dp)[..., None, :]
    w_below = S * row * key
    diff = (aq - ak).masked_fill(~diag, float("-inf"))
    w_diag = S * torch.exp(diff) * dp[..., None, :]
    zero = torch.zeros(())
    W = torch.where(below, w_below, torch.where(diag, w_diag, zero))
    return tf32_product(W, xp, passes)[:, :, :t]


def ssd_limit_ratio(got, want):
    """max |got - want| / (1e-5 * max|want|): chip_smoke's limit (NaN, as a
    fault may give, compares as a failure)."""
    err = float((got - want).abs().max())
    return err / (1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("t", [40, 100, 200, 256])
@pytest.mark.parametrize("n,p", [(128, 64), (16, 64), (16, 32)])
@pytest.mark.parametrize("steep", [False, True])
def test_ssd_tc_numerics_stay_inside_the_limit(t, n, p, steep):
    """The tensor-core kernel's numerics (``ssd_tc_emulation``) stay inside
    1e-5 * max|y| against the port's plain version and against the JAX
    package's Pallas kernel in interpret mode, at the main paths' (N, P),
    ragged T and the real model's steep decays."""
    args = ssd_case(2, 3, t, n, p, 7 * t + n + p, steep)
    got = ssd_tc_emulation(*map(torch.tensor, args))
    assert torch.isfinite(got).all()
    want = ref.ssd_chunk_ref(*map(torch.tensor, args))
    assert ssd_limit_ratio(got, want) <= 1.0
    jax_want = torch.tensor(np.asarray(jops.ssd_chunk(*map(jnp.asarray,
                                                           args))))
    assert ssd_limit_ratio(got, jax_want) <= 1.0


SSD_TC_FAULTS = [(fault, t) for fault in ({"passes": 1}, {"causal_shift": 1})
                 for t in (40, 100, 200, 256)] + \
    [({"zero_fill": False}, t) for t in (40, 100, 200)]   # ragged T only


@pytest.mark.parametrize("fault,t", SSD_TC_FAULTS)
@pytest.mark.parametrize("n,p", [(128, 64), (16, 32)])
def test_ssd_tc_limit_rejects_faulty_numerics(fault, t, n, p):
    """The limit separates right from wrong: one TF32 product in place of
    three, the mask one key late, or x past a ragged T left unfilled each
    move the output by more than 20 times 1e-5 * max|y| (or to NaN), on
    mild and steep decays alike."""
    for steep in (False, True):
        args = map(torch.tensor, ssd_case(2, 3, t, n, p, t + n, steep))
        C, B, acum, dt, x = args
        want = ref.ssd_chunk_ref(C, B, acum, dt, x)
        ratio = ssd_limit_ratio(ssd_tc_emulation(C, B, acum, dt, x, **fault),
                                want)
        assert not ratio <= 20.0, (fault, steep, ratio)
