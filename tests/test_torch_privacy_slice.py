"""The privacy wire on the port's four rounds against live JAX: pairwise
secure aggregation, ``masked_geom`` trust, DP-SGD and update DP through
``run_defta`` (static and scenario), ``run_async_defta`` and
``run_cross_device``.

Both packages start from one initial state and consume one draw stream:
``JaxScenarioDraws`` replays ``split_round_keys(key, stochastic,
dp_update)`` with the round's real update-DP flag (update DP lengthens the
split, which under the CI's jax moves every draw of the round), DP-SGD's
per-step keys under ``k_train`` and update DP's ``split(k_dp,
n_leaves)``. The
secagg pads are the port's own (Threefry in torch); they cancel word for
word, so they do not enter the comparison. Every state field agrees
within 1e-4 (the int8 worlds' models within one quantization step),
epochs and ticks exactly; under ``masked_geom`` the sketch ring buffer
stays as it was. Worlds: 10 vanilla workers, MLP; the cross-device world
12 enrolled, k = 4.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.scenarios.spec as jspec
import test_torch_slice as slice_helpers
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import engine as jengine
from repro.core.async_defta import run_async_defta as jrun_async_defta
from repro.core.cross_device import run_cross_device as jrun_cross_device
from repro.core.defta import run_defta as jrun_defta
from repro.core.gossip import uses_error_feedback as juses_ef
from repro.core.tasks import mlp_task as jmlp_task
from repro.scenarios.cross_device import CrossDeviceSpec as JSpec
from test_torch_async import JaxTickDraws
from test_torch_cross_device_slice import small_data
from test_torch_scenario_slice import (CFG, TRAIN, JaxScenarioDraws,
                                       scenario_for, world_data)

import repro_torch.scenarios.spec as tspec
from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import (cross_device_state_from_jax,
                                 cross_device_state_to_numpy,
                                 state_from_jax, state_to_numpy)
from repro_torch.core import engine
from repro_torch.core.async_defta import run_async_defta
from repro_torch.core.cross_device import run_cross_device
from repro_torch.core.defta import run_defta
from repro_torch.core.tasks import mlp_task
from repro_torch.core.topology import make_topology
from repro_torch.rng import RoundDraws, TorchDraws
from repro_torch.scenarios.cross_device import CrossDeviceSpec
from repro_torch.sharding import WorkerShards
from repro_torch.telemetry import RunLedger
from torch_threads import one_torch_thread  # noqa: F401


EPOCHS = 6
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
SECAGG = dict(secagg="pairwise")
MASKED = dict(secagg="pairwise", secagg_mode="masked_geom")

# name: (config change, scenario or None for the static world with one
# noise attacker)
WORLDS = {
    "secagg_fp32_storm": (SECAGG, "storm"),
    "secagg_bf16_ef_static": (dict(SECAGG, gossip_dtype="bfloat16"), None),
    "masked_geom_geom": (dict(MASKED, dts_signal="geom"), "churn_signflip"),
    "masked_geom_all": (dict(MASKED, dts_signal="all"), "churn_signflip"),
    "dp_sgd_static": (dict(dp_clip=1.0, dp_sigma=0.5), None),
    "dp_sgd_storm": (dict(dp_clip=0.5, dp_sigma=1.0), "storm"),
    "update_dp_storm": (dict(dp_sigma=1.0), "storm"),
    "update_dp_secagg_static": (dict(SECAGG, dp_sigma=1.0,
                                     dp_update_clip=0.5), None),
    "update_dp_masked_geom_all": (dict(MASKED, dts_signal="all",
                                       dp_sigma=0.5), "churn_signflip"),
}
INT8_WORLD = (dict(SECAGG, gossip_dtype="int8",
                   gossip_wire_round="stochastic"), "storm")


def draws_for(jcfg, key):
    return JaxScenarioDraws(key, jengine.make_transport(jcfg).stochastic,
                            jengine.uses_update_dp(jcfg))


def init_fields(key, jcfg, w):
    init = jengine.init_state(key, jmlp_task(32, 10), w,
                              wire_error=juses_ef(jcfg),
                              sketch=jengine.sketch_shape(jcfg))
    return init, {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
                  for f in dataclasses.fields(init) if f.name != "key"}


def numpy_fields(st):
    return {f.name: jax.tree.map(np.asarray, getattr(st, f.name))
            for f in dataclasses.fields(st) if f.name != "key"}


def run_both(change, scenario, *, epochs=EPOCHS):
    """One world through both packages from one initial state and draw
    stream; returns (reference fields, port fields, draws)."""
    cfg_kw = dict(CFG, **change)
    data = world_data()
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**cfg_kw)
    kw = dict(num_malicious=1) if scenario is None else {}
    jst, _, jmal, _ = jrun_defta(
        key, jmlp_task(32, 10), jcfg, JTrainConfig(**TRAIN), data,
        epochs=epochs, scenario=scenario_for(scenario, jspec)
        if scenario else None, **kw)
    init, fields = init_fields(key, jcfg, len(jmal))
    draws = draws_for(jcfg, init.key)
    st, _, mal, _ = run_defta(
        0, mlp_task(32, 10), DeFTAConfig(**cfg_kw), TrainConfig(**TRAIN),
        data, epochs=epochs, scenario=scenario_for(scenario, tspec)
        if scenario else None, device="cpu",
        init=state_from_jax(fields, device="cpu"), draws=draws, **kw)
    np.testing.assert_array_equal(mal, jmal)
    assert draws.calls == epochs
    np.testing.assert_array_equal(np.asarray(draws.key), np.asarray(jst.key))
    return numpy_fields(jst), state_to_numpy(st), fields


def assert_same(want, got):
    np.testing.assert_array_equal(got["epoch"], want["epoch"])
    slice_helpers.assert_fields_close(want, got, **FP32_TOL)


def assert_bf16_close(want, got):
    """Every field within 1e-4 but the EF21 residuals, which hold what the
    bf16 encode lost: where the two packages' sends (1e-7 apart) straddle
    a rounding boundary the residual moves by one bf16 step, 2^-7 of the
    row's largest magnitude at most."""
    assert_same({f: v for f, v in want.items() if f != "wire_err"},
                {f: v for f, v in got.items() if f != "wire_err"})
    for leaf, p in want["params"].items():
        rows = p.reshape(p.shape[0], -1)
        step = np.abs(rows).max(axis=1, keepdims=True) * 2.0 ** -7
        err = np.abs(got["wire_err"][leaf] - want["wire_err"][leaf])
        assert (err.reshape(rows.shape) - step).max() <= 0, leaf


def assert_int8_close(want, got):
    """Epochs exact, losses and conf at rtol 1e-3, params, backup and
    residuals within one quantization step (as the scenario slice's int8
    world)."""
    np.testing.assert_array_equal(got["epoch"], want["epoch"])
    for field in ("best_loss", "last_loss", "conf"):
        np.testing.assert_allclose(got[field], want[field], rtol=1e-3,
                                   atol=1e-5, err_msg=field)
    for leaf, p in want["params"].items():
        rows = p.reshape(p.shape[0], -1)
        step = np.abs(rows).max(axis=1, keepdims=True) / 127.0
        for field, bound in (("params", step), ("backup", step),
                             ("wire_err", step.max())):
            err = np.abs(got[field][leaf] - want[field][leaf])
            excess = err.reshape(rows.shape) - bound
            assert excess.max() <= 0, (f"{field}.{leaf}: error exceeds one "
                                       f"step by {excess.max()}")


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_sync_world_matches_jax(name):
    change, scenario = WORLDS[name]
    want, got, init = run_both(change, scenario)
    if change.get("gossip_dtype") == "bfloat16":
        assert_bf16_close(want, got)
    else:
        assert_same(want, got)
    if change.get("secagg_mode") == "masked_geom" \
            and change["dts_signal"] == "all":
        # the receiver sketches nothing it never saw: the ring stays empty
        assert not got["sketch"].any() and not init["sketch"].any()


def test_int8_ef_stochastic_secagg_matches_jax():
    """storm over the int8 + EF21 wire with stochastic rounding and secagg
    (the scale channel padded on its own tag)."""
    want, got, _ = run_both(*INT8_WORLD)
    assert_int8_close(want, got)


def test_async_storm_secagg_update_dp_matches_jax():
    """AsyncDeFTA under storm with secagg and update DP: the tick keys the
    pads on t; ticks run counted by the reference's final round key."""
    cfg_kw = dict(CFG, secagg="pairwise", dp_sigma=0.5)
    data = world_data()
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**cfg_kw)
    ticks = 8
    jst, _, jmal, jspeeds = jrun_async_defta(
        key, jmlp_task(32, 10), jcfg, JTrainConfig(**TRAIN), data,
        scenario=scenario_for("storm", jspec), ticks=ticks)
    init, fields = init_fields(key, jcfg, len(jmal))
    draws = draws_for(jcfg, init.key)
    tick_draws = JaxTickDraws(key, ticks)
    led = RunLedger()
    st, _, mal, speeds = run_async_defta(
        0, mlp_task(32, 10), DeFTAConfig(**cfg_kw), TrainConfig(**TRAIN),
        data, scenario=scenario_for("storm", tspec), ticks=ticks,
        device="cpu", ledger=led, init=state_from_jax(fields, device="cpu"),
        draws=draws, tick_draws=tick_draws)
    np.testing.assert_array_equal(mal, jmal)
    np.testing.assert_array_equal(speeds, np.asarray(jspeeds, np.float32))
    np.testing.assert_array_equal(np.asarray(draws.key), np.asarray(jst.key))
    assert draws.calls == tick_draws.calls == led.rounds_done == ticks
    assert_same(numpy_fields(jst), state_to_numpy(st))


CD_WORLDS = {
    "secagg_masked_geom_update_dp": dict(MASKED, dts_signal="all",
                                         dp_sigma=0.5),
    "secagg_edge_update_dp_all": dict(SECAGG, dts_signal="all",
                                      dp_sigma=1.0),
    "dp_sgd_geom": dict(dts_signal="geom", dp_clip=1.0, dp_sigma=0.5),
}


@pytest.mark.parametrize("name", sorted(CD_WORLDS))
def test_cross_device_world_matches_jax(name):
    """12 enrolled, k = 4, label_flip + alie: the cohort's secagg support
    is all-ones [k, k]; under ``masked_geom`` the sketches and stamps pass
    through unchanged."""
    enrolled, k, rounds = 12, 4, 10
    cfg_kw = dict(num_workers=enrolled, avg_peers=2, num_sampled=2,
                  local_epochs=1, seed=0, **CD_WORLDS[name])
    spec_kw = dict(enrolled=enrolled, sample_k=k, avg_peers=3, seed=1,
                   attacks=(("label_flip", 0.2), ("alie", 0.2)))
    data = small_data(enrolled)
    task_kw = dict(hidden=16)
    train = dict(learning_rate=0.05, batch_size=8)
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**cfg_kw)
    jst, jhist = jrun_cross_device(
        key, jmlp_task(8, 4, **task_kw), jcfg, JTrainConfig(**train), data,
        world=JSpec(**spec_kw), epochs=rounds, eval_every=5,
        test_x=data["test_x"], test_y=data["test_y"], probe=6)
    init = jengine.init_cross_device_state(
        key, jmlp_task(8, 4, **task_kw), enrolled, wire_error=juses_ef(jcfg),
        sketch=jengine.sketch_shape(jcfg))
    fields = numpy_fields(init)
    draws = draws_for(jcfg, init.key)
    st, hist = run_cross_device(
        0, mlp_task(8, 4, **task_kw), DeFTAConfig(**cfg_kw),
        TrainConfig(**train), data, world=CrossDeviceSpec(**spec_kw),
        epochs=rounds, eval_every=5, test_x=data["test_x"],
        test_y=data["test_y"], probe=6, device="cpu",
        init=cross_device_state_from_jax(fields, device="cpu"), draws=draws)
    assert draws.calls == rounds
    np.testing.assert_array_equal(np.asarray(draws.key), np.asarray(jst.key))
    want, got = numpy_fields(jst), cross_device_state_to_numpy(st)
    exact = ("epoch", "obs", "last_part", "sketch", "sketch_round")
    for f in exact:
        if want[f] is None:
            assert got[f] is None, f
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    if cfg_kw.get("secagg_mode") == "masked_geom":
        np.testing.assert_array_equal(got["sketch"], fields["sketch"])
        np.testing.assert_array_equal(got["sketch_round"],
                                      fields["sketch_round"])
    floats = {f: v for f, v in want.items() if f not in exact}
    slice_helpers.assert_fields_close(floats, {f: got[f] for f in floats},
                                      **FP32_TOL)
    assert [h[0] for h in hist] == [int(h[0]) for h in jhist]
    np.testing.assert_array_equal([h[1:] for h in hist],
                                  np.asarray([h[1:] for h in jhist],
                                             np.float64))


# ---------------------------------------------------------------------------
# The seam, the stage list and the refusals
# ---------------------------------------------------------------------------

class Recording:
    """A provider that records the keywords each round asks with."""

    def __init__(self, inner):
        self.inner, self.asked = inner, []

    def __call__(self, *args, **kw):
        self.asked.append(sorted(kw))
        return self.inner(*args, **kw)


def seeded_draws(seed=4):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return TorchDraws(gen)


@pytest.mark.parametrize("change,scenario,want", [
    ({}, "storm", ["kind_noise"]),
    (dict(SECAGG, gossip_dtype="int8", gossip_wire_round="stochastic"),
     "storm", ["kind_noise", "wire_shapes"]),
    (dict(MASKED, dts_signal="all"), None, []),
    (dict(dp_clip=1.0, dp_sigma=0.5), None, ["dp_sgd_shapes"]),
    (dict(dp_sigma=0.5), "storm", ["dp_update_shapes", "kind_noise"]),
])
def test_rounds_ask_for_dp_draws_only_when_they_need_them(change, scenario,
                                                          want):
    rec = Recording(seeded_draws())
    run_defta(0, mlp_task(32, 10), DeFTAConfig(**dict(CFG, **change)),
              TrainConfig(**TRAIN), world_data(), epochs=2,
              scenario=scenario, num_malicious=0 if scenario else 1,
              device="cpu", draws=rec)
    assert rec.asked == [want, want]


def test_a_round_without_dp_draws_what_it_drew_before():
    """``TorchDraws`` with no DP keyword draws the pre-DP stream: Gumbel,
    permutations, legacy noise, per-kind noise, wire uniforms, in that
    order and nothing after; the DP draws come after all of them."""
    w, e, n = 5, 2, 12
    shapes = {"a": (w, 3), "b": (w, 2, 2)}
    kinds = {"noise": shapes}
    wire = {"a": (w, 3), "b": (w, 4)}
    got = seeded_draws()(w, e, n, shapes, kind_noise=kinds,
                         wire_shapes=wire)
    g = torch.Generator()
    g.manual_seed(4)
    gumbel = -torch.empty(w, w).exponential_(generator=g).log()
    perm = torch.rand(w, e, n, generator=g).argsort(dim=-1)
    noise = {k: torch.randn(s, generator=g) for k, s in sorted(shapes.items())}
    kind = {k: torch.randn(s, generator=g) for k, s in sorted(shapes.items())}
    wire_u = {k: torch.rand(s, generator=g) for k, s in sorted(wire.items())}
    after = torch.rand(4, generator=g)
    assert torch.equal(got.gumbel, gumbel) and torch.equal(got.perm, perm)
    for mine, theirs in ((got.noise, noise), (got.kind_noise["noise"], kind),
                         (got.wire_u, wire_u)):
        assert all(torch.equal(mine[k], theirs[k]) for k in theirs)
    assert got.dp_sgd is None and got.dp_update is None
    with_dp = seeded_draws()(w, e, n, shapes, kind_noise=kinds,
                             wire_shapes=wire, dp_update_shapes=shapes)
    assert torch.equal(with_dp.wire_u["b"], wire_u["b"])
    assert with_dp.dp_update["a"].flatten()[0] != after[0]


def test_update_dp_replay_draws_from_k_dp():
    """Update DP's noise is ``split(k_dp, n_leaves)`` of the round's
    ``split_round_keys(key, stochastic, True)``. (Under the CI's jax the
    longer split moves every draw of the round; under a partitionable
    threefry, as in jax 0.9, the first four keys keep their values and
    only ``k_dp`` is new.)"""
    key = jax.random.PRNGKey(0)
    shapes = {"a": (4, 3), "b": (4, 2)}
    dp = JaxScenarioDraws(key, False, True)(4, 1, 8, None,
                                            dp_update_shapes=shapes)
    k_dp = jengine.split_round_keys(key, False, True)["k_dp"]
    for nm, k in zip(sorted(shapes), jax.random.split(k_dp, 2)):
        np.testing.assert_array_equal(
            dp.dp_update[nm].numpy(),
            np.asarray(jax.random.normal(k, shapes[nm])))
    assert isinstance(dp, RoundDraws) and dp.dp_sgd is None


def test_dp_noise_stage_gated():
    adj = make_topology("random_kout", 10, 2, 0)
    common = (mlp_task(32, 10), None, TrainConfig(**TRAIN), adj,
              np.full(10, 48), np.zeros(10, bool))

    def names(**change):
        args = list(common)
        args[1] = DeFTAConfig(**dict(CFG, **change))
        return engine.stage_names(engine.build_defta_round(
            *args, draws=seeded_draws(), device="cpu"))
    off = names()
    on = names(dp_sigma=0.5)
    assert on[on.index("local_train") + 1] == "dp_noise"
    assert tuple(s for s in on if s != "dp_noise") == off
    assert "dp_noise" not in names(dp_sigma=0.5, dp_clip=1.0)
    assert "dp_noise" not in names(**SECAGG)


@pytest.mark.parametrize("change", [
    dict(dp_clip=1.0, dp_sigma=0.5), dict(dp_sigma=1.0), SECAGG, MASKED,
    dict(MASKED, dts_signal="all", dp_sigma=1.0, gossip_dtype="int8")])
def test_check_supported_takes_the_privacy_wire(change):
    cfg = DeFTAConfig(**dict(CFG, **change))
    engine.check_supported(cfg)
    # the sharded transport carries the privacy wire too (item 7)
    engine.check_supported(cfg, shard=WorkerShards((torch.device("cpu"),)
                                                   * 2))


@pytest.mark.parametrize("change", [
    dict(secagg="bogus"), dict(secagg="pairwise", secagg_mode="bogus"),
    dict(secagg="pairwise", aggregation="krum"),
    dict(secagg="pairwise", secagg_mode="masked_geom",
         aggregation="median")])
def test_privacy_refusals_raise_the_references_value_error(change):
    def build(pkg):
        if pkg == "jax":
            jengine.make_transport(JDeFTAConfig(**dict(CFG, **change)),
                                   robust="aggregation" in change)
        else:
            engine.check_supported(DeFTAConfig(**dict(CFG, **change)))
    for pkg in ("jax", "torch"):
        with pytest.raises(ValueError, match="secagg"):
            build(pkg)
