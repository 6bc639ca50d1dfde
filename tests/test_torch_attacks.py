"""The port's attack zoo, robust rules, per-epoch mixing matrix and
stochastic int8 rounding against the reference's, on random stacks.

The random kinds take the reference's own draws, replayed from its keys
(one N(0, 1) per leaf from ``split(key, n_leaves)`` in sorted leaf order;
the wire's uniforms the same way). Each trap named in the port's
docstrings has a case that a wrong port fails, and the case checks that
the wrong version does fail it: population vs sample std (``alie``), the
median of an even count (``dts_dodge``), Krum's outlier and lone
receivers, trims at and above one half."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as jgossip
from repro.scenarios import attacks as jattacks
from repro.scenarios import robust_agg as jrobust
from repro.scenarios.compile import ATTACK_CODE

from repro_torch.core import gossip
from repro_torch.scenarios import attacks, robust_agg

SHAPES = {"w1": (4, 3), "b1": (3,), "w2": (3, 2)}
TOL = dict(rtol=1e-5, atol=1e-5)


def stacks(w, seed):
    rng = np.random.default_rng(seed)
    agg = {k: rng.normal(size=(w,) + s).astype(np.float32)
           for k, s in SHAPES.items()}
    trained = {k: (v + 0.3 * rng.normal(size=v.shape)).astype(np.float32)
               for k, v in agg.items()}
    scale = rng.uniform(0.5, 2.0, w).astype(np.float32)
    return agg, trained, scale


def t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def replay_normal(key, like):
    """The reference's per-leaf N(0, 1): ``split(key, n)`` in sorted leaf
    order."""
    names = sorted(like)
    keys = jax.random.split(key, len(names))
    return {n: torch.tensor(np.asarray(jax.random.normal(
        k, like[n].shape, jnp.float32))) for n, k in zip(names, keys)}


def close(got, want, **tol):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **(tol or TOL))


def random_theta(w, seed):
    rng = np.random.default_rng(seed)
    th = rng.uniform(0, 1, (w, w)) * (rng.random((w, w)) < 0.5)
    th /= np.maximum(th.sum(1, keepdims=True), 1e-9)
    return th.astype(np.float32)


@pytest.mark.parametrize("kind", sorted(attacks.MODEL_ATTACKS))
@pytest.mark.parametrize("w", [5, 6])
@pytest.mark.parametrize("with_theta", [False, True])
def test_model_attack_matches_jax(kind, w, with_theta):
    if with_theta and kind not in attacks.THETA_ATTACKS:
        with_theta = None                  # θ only reaches theta_aware
    agg, trained, scale = stacks(w, w + len(kind))
    key = jax.random.PRNGKey(w)
    kw, tkw = {}, {}
    if kind in attacks.THETA_ATTACKS:
        th = random_theta(w, w) if with_theta else None
        kw = {"theta": None if th is None else jnp.asarray(th)}
        tkw = {"theta": None if th is None else torch.tensor(th)}
    want = jattacks.MODEL_ATTACKS[kind](key, j(agg), j(trained),
                                        jnp.asarray(scale), **kw)
    draws = replay_normal(key, agg) if kind in attacks.RANDOM_ATTACKS \
        else None
    got = attacks.MODEL_ATTACKS[kind](draws, t(agg), t(trained),
                                      torch.tensor(scale), **tkw)
    close(got, want)


def test_alie_uses_the_population_std():
    """W = 3: ``torch.std``'s default ``correction=1`` is 22 % off."""
    agg, trained, scale = stacks(3, 0)
    want = jattacks.alie(None, j(agg), j(trained), jnp.asarray(scale))
    close(attacks.alie(None, t(agg), t(trained), torch.tensor(scale)), want)
    tt = torch.tensor(trained["w1"])
    wrong = tt.mean(0, keepdim=True) - torch.tensor(scale).reshape(-1, 1, 1) \
        * tt.std(0, keepdim=True)
    assert not np.allclose(wrong.numpy(), np.asarray(want["w1"]), **TOL)


def test_dts_dodge_median_of_an_even_count():
    """W = 6: ``jnp.median`` averages the two middle norms;
    ``torch.median`` would take the lower one."""
    agg, trained, scale = stacks(6, 3)
    # spread the update norms so the two middle ones differ clearly
    for i, k in enumerate(sorted(trained)):
        trained[k] = (agg[k] + (trained[k] - agg[k]) * np.arange(
            1, 7, dtype=np.float32).reshape((-1,) + (1,) * len(SHAPES[k]))
        ).astype(np.float32)
    scale = np.ones(6, np.float32)            # the cap binds rows 4-6
    want = jattacks.dts_dodge(None, j(agg), j(trained), jnp.asarray(scale))
    close(attacks.dts_dodge(None, t(agg), t(trained), torch.tensor(scale)),
          want)
    n = attacks._update_norms(t(agg), t(trained))
    assert float(attacks._median(n)) != float(n.median())
    lower = attacks._median
    try:
        attacks._median = lambda x: x.median()
        wrong = attacks.dts_dodge(None, t(agg), t(trained),
                                  torch.tensor(scale))
    finally:
        attacks._median = lower
    assert not all(np.allclose(wrong[k].numpy(), np.asarray(want[k]), **TOL)
                   for k in want)


@pytest.mark.parametrize("with_theta", [False, True])
def test_poison_sends_matches_jax(with_theta):
    """Every model kind present at once, intermittently on: each computed
    from the same trained stack, in ATTACK_KINDS order."""
    w = 12
    agg, trained, scale = stacks(w, 7)
    rng = np.random.default_rng(8)
    kinds = ("noise", "sign_flip", "scaling", "alie", "label_flip",
             "dts_dodge", "theta_aware", "alie_decor")
    code = np.array([0, 0, 0, 0] + [ATTACK_CODE[k] for k in kinds],
                    np.int32)
    on = rng.random(w) < 0.7
    th = random_theta(w, 9) if with_theta else None
    key = jax.random.PRNGKey(3)
    want = jattacks.poison_sends(
        key, kinds, jnp.asarray(code), jnp.asarray(scale), jnp.asarray(on),
        j(agg), j(trained), theta=None if th is None else jnp.asarray(th))
    kind_noise = {k: replay_normal(jax.random.fold_in(key, ATTACK_CODE[k]),
                                   agg) for k in attacks.RANDOM_ATTACKS}
    got = attacks.poison_sends(
        kind_noise, kinds, torch.tensor(code), torch.tensor(scale),
        torch.tensor(on), t(agg), t(trained),
        theta=None if th is None else torch.tensor(th))
    close(got, want)
    # the honest rows and the inactive attackers send what they trained
    keep = (code == 0) | ~on
    for k in trained:
        np.testing.assert_array_equal(got[k].numpy()[keep], trained[k][keep])


def test_flip_labels_matches_jax():
    rng = np.random.default_rng(0)
    y = rng.integers(0, 10, (6, 9)).astype(np.int32)
    active = np.array([0, 1, 0, 1, 1, 0], bool)
    want = jattacks.flip_labels(jnp.asarray(y), jnp.asarray(active), 10)
    got = attacks.flip_labels(torch.tensor(y), torch.tensor(active), 10)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def random_mask(w, seed, p=0.5):
    rng = np.random.default_rng(seed)
    m = rng.random((w, w)) < p
    m |= np.eye(w, dtype=bool)
    m[2] = np.eye(w, dtype=bool)[2]           # a receiver alone
    m[1, :] = True                            # one that hears everyone
    return m


@pytest.mark.parametrize("rule", ["trimmed_mean", "median"])
@pytest.mark.parametrize("trim", [0.0, 0.25, 0.5, 0.75])
@pytest.mark.parametrize("w", [7, 8])
def test_coordinate_rules_match_jax(rule, trim, w):
    mask = random_mask(w, w)
    x = {k: np.random.default_rng(w).normal(size=(w,) + s).astype(np.float32)
         for k, s in SHAPES.items()}
    want = jrobust.robust_mix(rule, jnp.asarray(mask), j(x), trim=trim)
    got = robust_agg.robust_mix(rule, torch.tensor(mask), t(x), trim=trim)
    close(got, want)
    for k in x:                               # the lone receiver keeps its own
        np.testing.assert_allclose(got[k].numpy()[2], x[k][2], **TOL)


def test_trimmed_mean_never_trims_the_window_empty():
    """trim 0.75 on a 3-member set: floor(2.25) = 2 would eat every rank;
    the cap (cnt − 1) // 2 = 1 keeps the middle value."""
    mask = np.zeros((3, 3), bool)
    mask[0] = True
    mask |= np.eye(3, dtype=bool)
    x = np.array([[1.0], [5.0], [3.0]], np.float32)
    got = robust_agg.trimmed_mean_leaf(torch.tensor(mask), torch.tensor(x),
                                       0.75)
    want = jrobust.trimmed_mean_leaf(jnp.asarray(mask), jnp.asarray(x), 0.75)
    np.testing.assert_allclose(got.numpy(), np.asarray(want))
    assert float(got[0, 0]) == 3.0


@pytest.mark.parametrize("w", [6, 9])
@pytest.mark.parametrize("trim", [0.0, 0.25, 0.5])
def test_krum_selection_is_exact(w, trim):
    mask = random_mask(w, 10 + w, p=0.6)
    rng = np.random.default_rng(w)
    x = {k: rng.normal(size=(w,) + s).astype(np.float32)
         for k, s in SHAPES.items()}
    out = w - 1                                # a far outlier
    for k in x:
        x[k][out] += 50.0
    want = np.asarray(jrobust.krum_select(jnp.asarray(mask), j(x), trim))
    got = robust_agg.krum_select(torch.tensor(mask), t(x), trim).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[2] == 2                         # alone: keeps its own model
    for i in range(w):
        if i != out and mask[i].sum() >= 3:
            assert got[i] != out, i
    mixed = robust_agg.robust_mix("krum", torch.tensor(mask), t(x),
                                  trim=trim)
    close(mixed, jrobust.robust_mix("krum", jnp.asarray(mask), j(x),
                                    trim=trim))


def test_krum_ties_take_the_first_index():
    w = 5
    x = {"a": np.zeros((w, 3), np.float32)}   # every distance 0: all tie
    mask = np.ones((w, w), bool)
    want = np.asarray(jrobust.krum_select(jnp.asarray(mask), j(x), 0.25))
    got = robust_agg.krum_select(torch.tensor(mask), t(x), 0.25).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).all()


def test_unknown_robust_rule_raises():
    with pytest.raises(ValueError, match="unknown robust rule"):
        robust_agg.robust_mix("mean", torch.ones(2, 2, dtype=torch.bool),
                              {"a": torch.zeros(2, 1)})


@pytest.mark.parametrize("scheme", ["defta", "defl", "uniform"])
def test_dynamic_mixing_matrix_matches_jax_with_dead_rows(scheme):
    w = 9
    rng = np.random.default_rng(2)
    adj = rng.random((w, w)) < 0.4
    np.fill_diagonal(adj, False)
    alive = np.ones(w, bool)
    alive[[2, 5]] = False
    eff = adj & alive[None, :] & alive[:, None]
    sampled = rng.random((w, w)) < 0.5
    sizes = rng.integers(10, 100, w).astype(np.float32)
    want = np.asarray(jgossip.dynamic_mixing_matrix(
        jnp.asarray(sampled), jnp.asarray(eff), jnp.asarray(sizes), scheme))
    got = gossip.dynamic_mixing_matrix(
        torch.tensor(sampled), torch.tensor(eff), torch.tensor(sizes),
        scheme).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    for i in (2, 5):                           # dead rows: the identity
        np.testing.assert_array_equal(got[i], np.eye(w, dtype=np.float32)[i])
    np.testing.assert_allclose(got.sum(1), 1.0, rtol=1e-6)


def test_stochastic_rounding_matches_jax_for_equal_uniforms():
    rng = np.random.default_rng(4)
    flat = (rng.normal(size=(6, 257)) * rng.uniform(0.1, 10, (6, 1))
            ).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want_q, want_s = jgossip.quantize_rows_int8(
        jnp.asarray(flat), rounding="stochastic", key=key)
    u = torch.tensor(np.asarray(jax.random.uniform(key, flat.shape,
                                                   jnp.float32)))
    q, s = gossip.quantize_rows_int8(torch.tensor(flat),
                                     rounding="stochastic", u=u)
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(s.numpy(), np.asarray(want_s))
    near, _ = gossip.quantize_rows_int8(torch.tensor(flat))
    assert (q != near).any()                   # it is not round-to-nearest
    with pytest.raises(ValueError, match="uniforms"):
        gossip.quantize_rows_int8(torch.tensor(flat), rounding="stochastic")


@pytest.mark.parametrize("backend", ["einsum", "sparse"])
@pytest.mark.parametrize("ef", [False, True])
def test_stochastic_wire_mix_matches_jax(backend, ef):
    """mix_pytree on the int8 stochastic wire: one uniform stack per leaf,
    in sorted leaf order, as ``split(wire_key, n_leaves)`` assigns them."""
    w = 8
    rng = np.random.default_rng(5)
    adj = rng.random((w, w)) < 0.3
    P = (adj | np.eye(w, dtype=bool)) * rng.uniform(0.5, 1, (w, w))
    P = (P / P.sum(1, keepdims=True)).astype(np.float32)
    x = {k: rng.normal(size=(w,) + s).astype(np.float32)
         for k, s in SHAPES.items()}
    res = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32)
           for k, v in x.items()} if ef else None
    key = jax.random.PRNGKey(6)
    want = jgossip.mix_pytree(
        jnp.asarray(P), j(x), backend="einsum", wire="int8",
        residual=None if res is None else j(res), wire_round="stochastic",
        wire_key=key)
    names = sorted(x)
    u = {n: torch.tensor(np.asarray(jax.random.uniform(
        k, (w, int(np.prod(SHAPES[n]))), jnp.float32)))
        for n, k in zip(names, jax.random.split(key, len(names)))}
    got = gossip.mix_pytree(
        torch.tensor(P), t(x), backend=backend, adjacency=adj, wire="int8",
        residual=None if res is None else t(res), wire_round="stochastic",
        wire_u=u)
    if ef:
        close(got[0], want[0])
        close(got[1], want[1])
    else:
        close(got, want)
    with pytest.raises(ValueError, match="int8-wire option"):
        gossip.mix_pytree(torch.tensor(P), t(x), wire="bf16",
                          wire_round="stochastic", wire_u=u)
