"""The port's three gossip-mix ops on the CPU (their plain versions, reached
through the ``repro_torch.kernels.ops`` wrappers) against the JAX package's
``ops.*`` Pallas kernels in interpret mode and its ``ref.*`` oracles, plus
the int8 wire encode and ``mix_pytree`` across backends and wires.

Inputs come from numpy with a seed. W in {4, 13}, ragged F (not a multiple
of any block size) and topologies whose rows have unequal degree, so the
padded-CSR support has pad slots. Tolerances: fp32 results at rtol = atol
= 1e-6 (summation order only); bf16 payloads are rounded once from the
same fp32 values on both sides (both round to nearest even) and compared
in fp32 at the same tolerance; int8 q and scale are bit-equal.
"""
from __future__ import annotations

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
