"""The port's DTS v2 (update geometry) and v3 (sketch ring buffer,
cross-round correlation) functions, and their fusion, against the live
JAX ones on shared numpy inputs drawn from a seed, at small W and D.

Limit 1e-6 (the functions are fp32; only summation order differs). The
one exception is the count-sketch sign: the port takes the projection as
a product with a fixed [D, S] matrix where the reference sums segments,
so a bucket whose projection is within 1e-5 of its row's norm of 0 may
take the other sign; every other bucket must be equal.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dts as jdts

from repro_torch.core import dts

TOL = dict(rtol=1e-6, atol=1e-6)


def t(a):
    return torch.from_numpy(np.array(a))


def j(a):
    return jnp.asarray(np.asarray(a))


def close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or TOL))


def world(w, d, seed, *, empty_rows=(0,)):
    """Deltas [W, D], a mask with the given rows empty and θ-like weights
    (softmax rows over the mask)."""
    rng = np.random.default_rng(seed)
    deltas = (rng.normal(size=(w, d)) * rng.uniform(0.1, 3.0, (w, 1))
              ).astype(np.float32)
    deltas[:, :5] = 0.0                         # dead coordinates
    mask = rng.random((w, w)) < 0.5
    for r in empty_rows:
        mask[r] = False
    theta = np.asarray(jdts.sample_weights(
        j(rng.normal(size=(w, w)).astype(np.float32)), j(mask)))
    return deltas, mask, theta


def test_flatten_stacked_takes_the_sorted_key_order():
    """The MLP's insertion order is w1, b1, w2, b2; JAX's leaves sort the
    keys (b1, b2, w1, w2), and the sketch hashes coordinates by that
    position."""
    rng = np.random.default_rng(0)
    tree = {"w1": rng.normal(size=(3, 4, 5)), "b1": rng.normal(size=(3, 5)),
            "w2": rng.normal(size=(3, 5, 2)), "b2": rng.normal(size=(3, 2))}
    tree = {k: v.astype(np.float32) for k, v in tree.items()}
    got = dts.flatten_stacked({k: t(v) for k, v in tree.items()})
    want = jdts.flatten_stacked({k: j(v) for k, v in tree.items()})
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 37)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[:, :5].numpy(), tree["b1"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_median_with_zero_weights_and_ties(seed):
    rng = np.random.default_rng(seed)
    p, r, d = 7, 5, 40
    vals = rng.integers(-3, 4, size=(p, d)).astype(np.float32)   # ties
    wts = rng.uniform(0.0, 1.0, size=(r, p)).astype(np.float32)
    wts[rng.random((r, p)) < 0.4] = 0.0
    wts[0] = 0.0                                  # no weight: returns 0
    wts[1, :] = 1.0                               # equal weights
    got = dts.weighted_median(t(vals), t(wts))
    want = jdts.weighted_median(j(vals), j(wts))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[0].any()


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("w,d,seed", [(4, 30, 0), (9, 120, 1),
                                      (12, 300, 2)])
def test_geom_scores_match_jax(w, d, seed, weighted):
    deltas, mask, theta = world(w, d, seed, empty_rows=(0, w - 1))
    weights = theta if weighted else None
    got = dts.geom_scores(t(deltas), t(mask),
                          None if weights is None else t(weights))
    want = jdts.geom_scores(j(deltas), j(mask),
                            None if weights is None else j(weights))
    close(got, want)
    assert not got[0].any() and not got[w - 1].any()     # no-peer rows
    assert not np.diag(got.numpy()).any()


def test_geom_scores_flag_a_scaled_and_a_flipped_peer():
    """A boosted and a sign-flipped update score above the honest peers
    (both packages agree on the scores)."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=64).astype(np.float32)
    deltas = base + 0.3 * rng.normal(size=(6, 64)).astype(np.float32)
    deltas[4] *= 40.0
    deltas[5] *= -1.0
    mask = ~np.eye(6, dtype=bool)
    got = dts.geom_scores(t(deltas), t(mask)).numpy()
    close(got, jdts.geom_scores(j(deltas), j(mask)))
    assert (got[0, 4:] > got[0, 1:4].max()).all()


def test_sketch_plan_is_the_references_bit_for_bit():
    for args in ((0, 2762, 64), (3, 300, 16), (7, 10, 64)):
        ours, theirs = dts._sketch_plan(*args), jdts._sketch_plan(*args)
        for a, b in zip(ours, theirs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,d,s", [(0, 300, 64), (1, 120, 16),
                                      (4, 257, 8)])
def test_sketch_deltas_match_jax_outside_near_zero_buckets(seed, d, s):
    deltas, _, _ = world(10, d, seed)
    deltas[3] = 0.0                               # an all-zero row
    got = dts.sketch_deltas(t(deltas), s, seed=seed).numpy()
    want = np.asarray(jdts.sketch_deltas(j(deltas), s, seed=seed))
    bucket, sign = jdts._sketch_plan(seed, d, s)
    proj = np.zeros((10, s))
    np.add.at(proj.T, bucket, (deltas.astype(np.float64) * sign).T)
    near_zero = np.abs(proj) < 1e-5 * np.linalg.norm(deltas, axis=1,
                                                     keepdims=True)
    assert set(np.unique(got)) <= {-1.0, 0.0, 1.0}
    np.testing.assert_array_equal(got[~near_zero], want[~near_zero])
    assert not got[3].any()
    assert near_zero.sum() <= near_zero[3].sum() + 2


def test_update_sketch_rotates_the_ring_buffer():
    rng = np.random.default_rng(3)
    w, r, s, d = 6, 4, 16, 90
    hist = np.sign(rng.normal(size=(w, r, s))).astype(np.float32)
    deltas = rng.normal(size=(w, d)).astype(np.float32)
    got = dts.update_sketch(t(hist), t(deltas), seed=2).numpy()
    want = np.asarray(jdts.update_sketch(j(hist), j(deltas), seed=2))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :-1], hist[:, 1:])
    np.testing.assert_array_equal(
        got[:, -1], dts.sketch_deltas(t(deltas), s, seed=2).numpy())


def planted_history(w, r, s, seed, colluders=()):
    """A sign-sketch history where ``colluders`` share one sketch per round
    (the alie signature) and the rest are independent; one unfilled
    row."""
    rng = np.random.default_rng(seed)
    hist = np.sign(rng.normal(size=(w, r, s))).astype(np.float32)
    shared = np.sign(rng.normal(size=(r, s))).astype(np.float32)
    for c in colluders:
        hist[c] = shared
    hist[0, :2] = 0.0                              # partly unfilled
    return hist


@pytest.mark.parametrize("colluders", [(), (5, 6, 7, 9)])
def test_correlation_matrix_and_colluder_scores_match_jax(colluders):
    w = 11
    hist = planted_history(w, 8, 16, 1, colluders)
    _, mask, theta = world(w, 20, 4)
    close(dts.correlation_matrix(t(hist)),
          jdts.correlation_matrix(j(hist)))
    got = dts.colluder_scores(t(hist), t(mask), t(theta)).numpy()
    close(got, jdts.colluder_scores(j(hist), j(mask), j(theta)))
    assert not got[0].any()                        # no peers
    if colluders:
        row = 2
        col = np.array(colluders)
        peers = np.flatnonzero(mask[row] & ~np.isin(np.arange(w), col))
        peers = peers[peers != row]
        hit = col[mask[row, col]]
        if hit.size and peers.size:
            assert got[row, hit].min() > got[row, peers].max()
    else:
        # a clean run: the median + MAD baseline leaves little excess
        assert np.abs(got).max() < 0.05


def test_nanmedian_averages_the_two_middle_values_like_jax():
    x = np.array([[np.nan, 1, 2], [3, np.nan, 4], [5, 6, np.nan]],
                 np.float32)
    assert float(dts._nanmedian(t(x))) == 3.5 == float(jnp.nanmedian(j(x)))
    assert float(torch.nanmedian(t(x))) == 3.0      # the lower one
    rng = np.random.default_rng(0)
    for n in (1, 2, 7, 30):
        v = rng.normal(size=n).astype(np.float32)
        v[rng.random(n) < 0.3] = np.nan
        got, want = float(dts._nanmedian(t(v))), float(jnp.nanmedian(j(v)))
        assert got == want or (np.isnan(got) and np.isnan(want)), (got, want)
    assert np.isnan(float(dts._nanmedian(t(np.full(4, np.nan,
                                                     np.float32)))))


@pytest.mark.parametrize("valid", ["none", "all_false", "partly"])
def test_correlation_suspicion_matches_jax(valid):
    w = 10
    hist = planted_history(w, 6, 16, 2, (3, 4, 8))
    corr = np.asarray(jdts.correlation_matrix(j(hist)))
    _, mask, theta = world(w, 20, 6)
    v = None
    if valid == "all_false":
        v = np.zeros((w, w), bool)
    elif valid == "partly":
        v = np.random.default_rng(1).random((w, w)) < 0.6
    got = dts.correlation_suspicion(t(corr), t(mask), t(theta),
                                    valid=None if v is None else t(v))
    want = jdts.correlation_suspicion(j(corr), j(mask), j(theta),
                                      valid=None if v is None else j(v))
    close(got, want)
    if valid == "all_false":
        assert not got.numpy().any()


@pytest.mark.parametrize("min_obs", [1, 2, 3])
def test_stamped_correlation_matches_jax(min_obs):
    rng = np.random.default_rng(min_obs)
    w, r, s = 8, 5, 16
    hist = np.sign(rng.normal(size=(w, r, s))).astype(np.float32)
    stamps = rng.integers(0, 9, size=(w, r)).astype(np.int32)
    stamps[rng.random((w, r)) < 0.3] = -1
    stamps[2] = -1                                 # never filled
    hist[stamps < 0] = 0.0
    corr, valid = dts.stamped_correlation(t(hist), t(stamps),
                                          min_obs=min_obs)
    jcorr, jvalid = jdts.stamped_correlation(j(hist), j(stamps),
                                             min_obs=min_obs)
    close(corr, jcorr)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert not valid[2].any() and not corr[2].any()


@pytest.mark.parametrize("signal", ["loss", "geom", "both", "corr", "all"])
def test_fused_trust_signal_matches_jax(signal):
    rng = np.random.default_rng(3)
    w = 7
    loss_trust = rng.normal(size=w).astype(np.float32)
    damaged = rng.random(w) < 0.3
    loss_trust[damaged] = jdts.DAMAGE_PENALTY
    geom = rng.normal(size=(w, w)).astype(np.float32)
    corr = rng.normal(size=(w, w)).astype(np.float32)
    got = dts.fused_trust_signal(signal, t(loss_trust), t(geom), t(damaged),
                                 0.7, corr=t(corr), lam_corr=4.0)
    want = jdts.fused_trust_signal(signal, j(loss_trust), j(geom),
                                   j(damaged), 0.7, corr=j(corr),
                                   lam_corr=4.0)
    close(np.broadcast_to(got.numpy(), (w, w)),
          np.broadcast_to(np.asarray(want), (w, w)))


def test_fused_trust_signal_rejects_an_unknown_signal():
    x = torch.zeros(3)
    with pytest.raises(ValueError, match="unknown dts_signal") as ours:
        dts.fused_trust_signal("bogus", x, None, x > 0, 1.0)
    with pytest.raises(ValueError) as theirs:
        jdts.fused_trust_signal("bogus", jnp.zeros(3), None,
                                jnp.zeros(3, bool), 1.0)
    assert str(ours.value) == str(theirs.value)


@pytest.mark.parametrize("signal", ["geom", "both", "corr", "all"])
def test_geom_confidence_update_matches_jax(signal):
    w, d = 9, 150
    deltas, mask, theta = world(w, d, 7)
    rng = np.random.default_rng(8)
    conf = rng.normal(size=(w, w)).astype(np.float32)
    sampled = rng.random((w, w)) < 0.3
    P = (rng.random((w, w)) * sampled).astype(np.float32)
    loss_trust = rng.normal(size=w).astype(np.float32)
    damaged = np.zeros(w, bool)
    damaged[2] = True
    loss_trust[2] = jdts.DAMAGE_PENALTY
    hist = planted_history(w, 8, 64, 3, (6, 7, 8))
    args = (signal, 1.0)
    got = dts.geom_confidence_update(
        *args, t(conf), t(sampled), t(P), t(loss_trust), t(damaged),
        t(deltas), t(mask), t(theta), sketch=t(hist), lam_corr=4.0)
    want = jdts.geom_confidence_update(
        *args, j(conf), j(sampled), j(P), j(loss_trust), j(damaged),
        j(deltas), j(mask), j(theta), sketch=j(hist), lam_corr=4.0)
    close(got, want)
