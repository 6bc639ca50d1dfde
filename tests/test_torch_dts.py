"""The port's loss-channel trust (``core.dts``), attack injection
(``scenarios.attacks``), the config validation and the guards of what the
port does not carry yet, against the reference. The random draws are the reference's own
(``jax.random``), handed to the port as tensors."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import dts as jdts
from repro.scenarios import attacks as jattacks

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.core import dts, engine, gossip
from repro_torch.core.defta import run_defta
from repro_torch.core.tasks import mlp_task
from repro_torch.data import federated_dataset
from repro_torch.scenarios import attacks


def conf_and_mask(w, seed):
    rng = np.random.default_rng(seed)
    conf = (rng.normal(size=(w, w)) * 2).astype(np.float32)
    mask = rng.random((w, w)) < 0.4
    mask[0] = False                             # an isolated worker
    return conf, mask


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_weights_and_crelu_match_jax(seed):
    conf, mask = conf_and_mask(9, seed)
    got = dts.sample_weights(torch.tensor(conf), torch.tensor(mask), 0.2)
    want = jdts.sample_weights(jnp.asarray(conf), jnp.asarray(mask), 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)
    assert float(got[0].abs().sum()) == 0.0      # no peers: zero row
    np.testing.assert_array_equal(
        dts.crelu(torch.tensor(conf)).numpy(),
        np.asarray(jdts.crelu(jnp.asarray(conf))))


def test_topk_mask_breaks_ties_to_the_lower_index_like_jax():
    score = np.array([[1.0, 3.0, 3.0, 3.0, 0.0],
                      [2.0, 2.0, 2.0, 2.0, 2.0],
                      [-np.inf, 5.0, -np.inf, -np.inf, -np.inf],
                      [-np.inf] * 5], np.float32)
    for k in (1, 2, 3):
        got = dts.topk_mask(torch.tensor(score), k).numpy()
        want = np.asarray(jdts.topk_mask(jnp.asarray(score), k))
        np.testing.assert_array_equal(got, want)
        assert (got.sum(-1) <= k).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("num_sampled", [1, 2])
def test_sample_peers_matches_jax_on_the_same_gumbel_draws(seed,
                                                           num_sampled):
    conf, mask = conf_and_mask(11, seed)
    theta = jdts.sample_weights(jnp.asarray(conf), jnp.asarray(mask))
    keys = jax.random.split(jax.random.PRNGKey(seed), 11)
    want = jax.vmap(lambda k, t: jdts.sample_peers(k, t, num_sampled))(
        keys, theta)
    gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (11,)))(keys)
    got = dts.sample_peers(torch.tensor(np.asarray(gumbel)),
                           torch.tensor(np.asarray(theta)), num_sampled)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_is_damaged_matches_jax():
    loss = np.array([1.0, np.nan, np.inf, 30.0, 9.0, 5.0], np.float32)
    best = np.array([np.inf, 1.0, 1.0, 1.0, 0.0, 2.0], np.float32)
    np.testing.assert_array_equal(
        dts.is_damaged(torch.tensor(loss), torch.tensor(best)).numpy(),
        np.asarray(jdts.is_damaged(jnp.asarray(loss), jnp.asarray(best))))


def test_noise_attack_and_tree_select_match_jax():
    rng = np.random.default_rng(0)
    agg = {"w": rng.normal(size=(4, 3, 2)).astype(np.float32),
           "b": rng.normal(size=(4, 2)).astype(np.float32)}
    trained = {k: v + 1 for k, v in agg.items()}
    scale = np.full(4, 200.0, np.float32)
    key = jax.random.PRNGKey(3)
    want = jattacks.noise(key, {k: jnp.asarray(v) for k, v in agg.items()},
                          None, jnp.asarray(scale))
    names = sorted(agg)
    draws = {n: torch.tensor(np.asarray(jax.random.normal(
        k, agg[n].shape, jnp.float32)))
        for n, k in zip(names, jax.random.split(key, len(names)))}
    got = attacks.noise(draws, {k: torch.tensor(v) for k, v in agg.items()},
                        None, torch.tensor(scale))
    for k in agg:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-5)
    flag = np.array([True, False, False, True])
    sel = attacks.tree_select(torch.tensor(flag), got,
                              {k: torch.tensor(v) for k, v in
                               trained.items()})
    jsel = jattacks.tree_select(jnp.asarray(flag), want,
                                {k: jnp.asarray(v) for k, v in
                                 trained.items()})
    for k in agg:
        np.testing.assert_allclose(sel[k].numpy(), np.asarray(jsel[k]),
                                   rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("change,match", [
    (dict(dp_clip=1.0), "DP-SGD"),
    (dict(dp_sigma=0.5), "update DP"),
    (dict(secagg="pairwise"), "secagg"),
])
def test_configs_the_slice_does_not_carry_raise(change, match):
    """DP-SGD, update DP and secagg, which earlier slices refused, run
    since the privacy wire was ported: no refusal names them, and a round
    ends with finite losses."""
    cfg = dataclasses.replace(DeFTAConfig(num_workers=4), **change)
    data = federated_dataset("vector", 4, np.random.default_rng(0),
                             n_per_worker=16)
    st, *_ = run_defta(0, mlp_task(32, 10), cfg, TrainConfig(), data,
                       epochs=1, device="cpu")
    assert st.epoch.tolist() == [1] * 4, match
    assert bool(torch.isfinite(st.last_loss).all())


@pytest.mark.parametrize("change", [
    dict(aggregation="krum", use_dts=False, time_machine=False),
    dict(aggregation="trimmed_mean"),
    dict(max_staleness=2),
    dict(gossip_dtype="int8", gossip_wire_round="stochastic"),
    dict(dts_signal="geom"),
    dict(dts_signal="all"),
])
def test_configs_the_scenario_slice_lifted_run(change):
    """The robust rules, max_staleness, the stochastic int8 wire and the
    DTS v2/v3 trust signals no longer raise: each runs a round."""
    cfg = dataclasses.replace(DeFTAConfig(num_workers=4, avg_peers=2,
                                          local_epochs=1), **change)
    data = federated_dataset("vector", 4, np.random.default_rng(0),
                             n_per_worker=16)
    st, *_ = run_defta(0, mlp_task(32, 10), cfg, TrainConfig(batch_size=8),
                       data, epochs=2, num_malicious=1, device="cpu")
    assert st.epoch.tolist() == [2] * 5
    assert bool(torch.isfinite(st.last_loss).all())


def build_both(change):
    """Build the reference's and the port's round for one config change;
    returns the exception class each raised (None: it built)."""
    from repro.config import DeFTAConfig as JDeFTAConfig
    from repro.config import TrainConfig as JTrainConfig
    from repro.core import engine as jengine
    from repro.core.tasks import mlp_task as jmlp_task
    adj = np.ones((4, 4), bool) & ~np.eye(4, dtype=bool)
    raised = []
    for eng, cfg_cls, train_cls, task, kw in (
            (jengine, JDeFTAConfig, JTrainConfig, jmlp_task(32, 10), {}),
            (engine, DeFTAConfig, TrainConfig, mlp_task(32, 10),
             dict(draws=None, device="cpu"))):
        cfg = dataclasses.replace(cfg_cls(num_workers=4), **change)
        try:
            eng.build_defta_round(task, cfg, train_cls(), adj, np.ones(4),
                                  np.zeros(4, bool), **kw)
            raised.append(None)
        except Exception as e:          # the class is what is compared
            raised.append(type(e))
    return raised


@pytest.mark.parametrize("change", [
    dict(dts_signal="bogus", use_dts=False),
    dict(dts_signal="bogus"),
    dict(secagg="bogus"),
    dict(secagg_mode="bogus"),
    dict(secagg="pairwise", aggregation="krum", use_dts=False),
], ids=["dts_signal_dts_off", "dts_signal_dts_on", "secagg", "secagg_mode",
        "secagg_under_krum"])
def test_config_validation_raises_the_references_exception(change):
    """A config the reference rejects is rejected by the port with the
    same exception class (``ValueError``), before any not-ported
    refusal."""
    want, got = build_both(change)
    assert want is ValueError and got is ValueError


def test_unknown_aggregation_is_stricter_than_the_reference():
    """The reference builds a uniform mix for an unknown ``aggregation``;
    the port refuses it (a config is never silently ignored)."""
    assert build_both(dict(aggregation="bogus")) == [None, ValueError]


def test_scenario_shards_telemetry_and_later_gossip_parts_raise():
    """Shards still raise and name their item (telemetry, item 6, is
    ported: ``test_torch_telemetry_slice``); a scenario runs, but not
    beside num_malicious; the stochastic rounding asks for its uniforms;
    the secure-aggregation wire asks for its topology."""
    data = federated_dataset("vector", 4, np.random.default_rng(0),
                             n_per_worker=16)
    cfg = DeFTAConfig(num_workers=4)
    with pytest.raises(NotImplementedError, match="item 7"):
        run_defta(0, mlp_task(32, 10), cfg, TrainConfig(), data, epochs=1,
                  device="cpu", shards=2)
    with pytest.raises(ValueError, match="not num_malicious"):
        run_defta(0, mlp_task(32, 10), cfg, TrainConfig(), data, epochs=1,
                  device="cpu", scenario="churn_signflip", num_malicious=1)
    x = torch.zeros(3, 4)
    with pytest.raises(ValueError, match="uniforms"):
        gossip.quantize_rows_int8(x, rounding="stochastic")
    with pytest.raises(ValueError, match="adjacency"):
        gossip.mix_pytree(torch.eye(3), {"a": x}, secagg=5)


def test_round_stage_names_follow_the_reference_pipeline():
    cfg = DeFTAConfig(num_workers=4, avg_peers=2, num_sampled=1,
                      local_epochs=1)
    adj = np.zeros((4, 4), bool)
    rnd = engine.build_defta_round(
        mlp_task(32, 10), cfg, TrainConfig(), adj, np.ones(4),
        np.zeros(4, bool), draws=None, device="cpu")
    assert engine.stage_names(rnd) == (
        "split_draws", "scenario_view", "peer_sample", "transport",
        "damage_check", "local_train", "attack_inject", "trust_update",
        "finalize")


def test_scenario_round_ends_in_the_fire_merge():
    from repro_torch.scenarios.compile import compile_scenario
    from repro_torch.scenarios.spec import get_scenario
    cfg = DeFTAConfig(num_workers=4, avg_peers=2, num_sampled=1,
                      local_epochs=1)
    sc = compile_scenario(get_scenario("storm", 4), 4, 3, device="cpu")
    w = sc.num_workers
    rnd = engine.build_defta_round(
        mlp_task(32, 10), cfg, TrainConfig(), np.zeros((w, w), bool),
        np.ones(w), sc.malicious, draws=None, device="cpu", scenario=sc)
    assert engine.stage_names(rnd)[-1] == "fire_merge"
    assert engine.stage_names(rnd)[:-1] == (
        "split_draws", "scenario_view", "peer_sample", "transport",
        "damage_check", "local_train", "attack_inject", "trust_update")
