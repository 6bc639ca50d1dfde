"""The port's ``run_defta`` under scenarios against a live JAX
``run_defta``.

Both start from one initial state (``convert.state_from_jax``) and consume
the same randomness: ``JaxScenarioDraws`` replays the reference's per-round
key layout, ``split_round_keys(key, stochastic, False)`` (five keys on the
stochastic int8 wire, four otherwise), the Gumbel rows, the minibatch
permutations, each random attack kind's noise from ``fold_in(k_noise,
ATTACK_CODE[kind])`` split over the leaves, and the wire's uniforms from
``split(k_wire, n_leaves)``. The reference runs the backend named beside
each world (``einsum`` unless the world is about a kernel; its Pallas
kernels in interpret mode), the port ``auto`` (the plain version of the
kernel ``auto`` picks). Worlds: 10 vanilla workers, MLP, 8 epochs.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.scenarios.spec as jspec
import test_torch_slice as slice_helpers
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import engine as jengine
from repro.core.defta import run_defta as jrun_defta
from repro.core.gossip import uses_error_feedback as juses_ef
from repro.core.tasks import mlp_task as jmlp_task
from repro.data.synthetic import federated_dataset as jfederated_dataset
from repro.scenarios.compile import ATTACK_CODE
from repro.scenarios.compile import compile_scenario as jcompile

import repro_torch.scenarios.spec as tspec
from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.core import gossip
from repro_torch.core.defta import run_defta
from repro_torch.core.tasks import mlp_task
from repro_torch.core.topology import make_topology
from repro_torch.rng import RoundDraws, TorchDraws
from repro_torch.scenarios.compile import compile_scenario

EPOCHS = 8
CFG = dict(num_workers=10, avg_peers=2, num_sampled=1, local_epochs=1)
TRAIN = dict(learning_rate=0.05, batch_size=16)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)


def world_data(num_workers=10):
    return jfederated_dataset("vector", num_workers,
                              np.random.default_rng(1), n_per_worker=48,
                              alpha=0.5)


class JaxScenarioDraws:
    """The reference's per-round draws under a scenario: ``JaxDraws``'s
    layout with the stochastic wire's fifth key, the per-kind attack noise
    and the wire's uniforms."""

    def __init__(self, key, stochastic: bool):
        self.key, self.stochastic, self.calls = key, stochastic, 0

    def __call__(self, w, local_epochs, n, noise_shapes, *, kind_noise=None,
                 wire_shapes=None):
        assert (wire_shapes is not None) == self.stochastic
        self.calls += 1
        ks = jengine.split_round_keys(self.key, self.stochastic, False)
        self.key = ks["key"]
        gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (w,)))(
            jax.random.split(ks["k_sample"], w))
        d = RoundDraws(
            gumbel=torch.tensor(np.asarray(gumbel)),
            perm=slice_helpers.replay_perm(ks["k_train"], w, local_epochs, n),
            noise=slice_helpers.replay_noise(ks["k_noise"], noise_shapes))
        if kind_noise is not None:
            d.kind_noise = {k: slice_helpers.replay_noise(
                jax.random.fold_in(ks["k_noise"], ATTACK_CODE[k]), shapes)
                for k, shapes in kind_noise.items()}
        if wire_shapes is not None:
            names = sorted(wire_shapes)
            keys = jax.random.split(ks["k_wire"], len(names))
            d.wire_u = {nm: torch.tensor(np.asarray(jax.random.uniform(
                k, wire_shapes[nm], jnp.float32)))
                for nm, k in zip(names, keys)}
        return d


def scenario_for(scenario, module):
    """A preset name passes as is; a builder is called with the package's
    own spec module."""
    return scenario if isinstance(scenario, str) else scenario(module)


def run_both(scenario, *, cfg=None, jbackend="einsum", backend="auto",
             epochs=EPOCHS):
    """Both packages from one initial state and one draw stream; returns
    (reference fields, port fields, port malicious, draws)."""
    cfg_kw = dict(CFG, **(cfg or {}))
    data = world_data(cfg_kw["num_workers"])
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**cfg_kw)
    jst, _, jmal, _ = jrun_defta(
        key, jmlp_task(32, 10), jcfg, JTrainConfig(**TRAIN), data,
        epochs=epochs, scenario=scenario_for(scenario, jspec),
        gossip_backend=jbackend)
    init = jengine.init_state(key, jmlp_task(32, 10), len(jmal),
                              wire_error=juses_ef(jcfg),
                              sketch=jengine.sketch_shape(jcfg))
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init)
              if f.name != "key"}
    stochastic = jengine.make_transport(jcfg).stochastic
    draws = JaxScenarioDraws(init.key, stochastic)
    st, _, mal, _ = run_defta(
        0, mlp_task(32, 10), DeFTAConfig(**cfg_kw), TrainConfig(**TRAIN),
        data, epochs=epochs, scenario=scenario_for(scenario, tspec),
        gossip_backend=backend, device="cpu",
        init=state_from_jax(fields, device="cpu"), draws=draws)
    np.testing.assert_array_equal(mal, jmal)
    # one provider call per round: the replayed key ends on the reference's
    np.testing.assert_array_equal(np.asarray(draws.key), np.asarray(jst.key))
    want = {f.name: jax.tree.map(np.asarray, getattr(jst, f.name))
            for f in dataclasses.fields(jst)
            if f.name != "key"}
    return want, state_to_numpy(st), mal


def assert_same(want, got, **tol):
    np.testing.assert_array_equal(got["epoch"], want["epoch"])
    slice_helpers.assert_fields_close(want, got, **(tol or FP32_TOL))


@pytest.mark.parametrize("backend", ["einsum", "auto"])
def test_storm_matches_jax(backend):
    """Churn, a partition, a straggler and three attack kinds (one
    intermittent); W = 13, so ``auto`` picks the sparse mix on both
    sides."""
    want, got, _ = run_both("storm", jbackend=backend, backend=backend)
    adj = make_topology("random_kout", 13, CFG["avg_peers"], 0)
    assert gossip._resolve_backend("auto", adj, 13) == "sparse"
    assert got["epoch"].min() < EPOCHS              # churn and straggler
    assert_same(want, got)


def test_churn_signflip_matches_jax():
    want, got, _ = run_both("churn_signflip")
    assert got["epoch"][0] == 6 and got["epoch"][1] == EPOCHS - 3
    assert_same(want, got)


@pytest.mark.parametrize("kind", jspec.ATTACK_KINDS)
def test_each_attack_kind_matches_jax(kind):
    """Two attackers of one kind, DTS on (theta_aware reads θ); the
    label-flippers train on y -> C-1-y with C = max(y) + 1."""
    def build(m):
        return m.ScenarioSpec(attacks=(m.AttackSpec(kind),
                                       m.AttackSpec(kind, period=4)))
    want, got, mal = run_both(build)
    assert mal.sum() == 2
    assert_same(want, got)


def test_theta_aware_goes_quiet_under_dts_matches_jax():
    """theta_aware at scale 20: DTS distrusts the attackers within a few
    rounds, so their θ falls below the floor and they send honest models;
    the round must hand them θ (they read none without DTS)."""
    def build(m):
        return m.ScenarioSpec(attacks=tuple(
            m.AttackSpec("theta_aware", scale=20.0) for _ in range(3)))
    want, got, _ = run_both(build, cfg=dict(num_sampled=2))
    assert_same(want, got)


@pytest.mark.parametrize("vanilla,every,pick", [(10, 3, "pallas"),
                                                (30, 4, "sparse")])
def test_time_varying_topology_matches_jax(vanilla, every, pick):
    """A topology re-drawn every few epochs and at a churn boundary: the
    padded-CSR support is the union over segments (a segment's masked
    slots ride at weight 0), and ``auto`` picks the kernel by the union's
    density, on both sides: the dense mix above 0.25, the sparse mix at
    or below it."""
    def build(m):
        return m.ScenarioSpec(
            attacks=(m.AttackSpec("noise"),),
            churn=(m.ChurnSpec(worker=3, leave=5),),
            topology=m.TopologySpec("random_kout", avg_peers=2, every=every),
            seed=2)
    w = vanilla + 1
    sc = compile_scenario(build(tspec), vanilla, EPOCHS, device="cpu")
    assert sc.num_segments >= 3
    assert gossip._resolve_backend("auto", sc.adj_union, w) == pick
    jsc = jcompile(build(jspec), vanilla, EPOCHS)
    np.testing.assert_array_equal(sc.adj_union, jsc.adj_union)
    want, got, _ = run_both(build, cfg=dict(num_workers=vanilla),
                            jbackend="auto")
    assert_same(want, got)


@pytest.mark.parametrize("rule", ["trimmed_mean", "median", "krum"])
def test_robust_rule_matches_jax(rule):
    """A robust rule with noise attackers, DTS and the time machine off (the
    Table 3 defenses): no mix runs; the fields, Krum's picks among them,
    follow the reference."""
    want, got, _ = run_both("paper_noise@3", cfg=dict(
        aggregation=rule, use_dts=False, time_machine=False))
    assert_same(want, got)


def test_int8_stochastic_ef_matches_jax():
    """storm on ``auto`` over the int8 + EF21 wire with stochastic
    rounding (the quant mix): epochs exactly, losses and conf at rtol
    1e-3, params, backup and residuals within one quantization step (as
    ``test_torch_slice.test_int8_ef_world_matches_jax``)."""
    want, got, _ = run_both("storm", cfg=dict(
        gossip_dtype="int8", gossip_wire_round="stochastic"),
        jbackend="auto")
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


def test_max_staleness_with_stragglers_matches_jax():
    """S = 1 with two slow workers: edges from peers more than one epoch
    behind the receiver are dropped."""
    def build(m):
        return m.ScenarioSpec(
            attacks=(m.AttackSpec("sign_flip"),),
            stragglers=(m.StragglerSpec(worker=1, speed=0.3),
                        m.StragglerSpec(worker=4, speed=0.5)))
    want, got, _ = run_both(build, cfg=dict(max_staleness=1))
    assert got["epoch"][1] < EPOCHS - 1             # it fell behind
    assert_same(want, got)


def test_empty_scenario_equals_the_static_run():
    """``ScenarioSpec()`` (no event) runs the scenario stages (the
    per-epoch mixing matrix, the fire merge) and gives the static run's
    state bit for bit."""
    data = world_data()
    res = []
    for sc in (None, tspec.ScenarioSpec()):
        gen = torch.Generator()
        gen.manual_seed(3)
        st, _, mal, _ = run_defta(
            0, mlp_task(32, 10), DeFTAConfig(**CFG), TrainConfig(**TRAIN),
            data, epochs=4, scenario=sc, device="cpu",
            draws=TorchDraws(gen))
        res.append(state_to_numpy(st))
    slice_helpers.assert_fields_close(res[0], res[1], rtol=0, atol=0)


def test_value_errors_match_the_reference():
    """A robust rule on a lossy wire, a horizon shorter than the run and
    attackers given twice raise the reference's ValueErrors."""
    data = world_data()
    cases = [
        (dict(aggregation="krum", gossip_dtype="int8"), {},
         "robust aggregation"),
        ({}, {"scenario": "compiled4"}, "horizon 4 is shorter"),
        ({}, {"scenario": "storm", "num_malicious": 1},
         "not num_malicious"),
    ]
    for change, kw, match in cases:
        for pkg in ("jax", "torch"):
            kw2 = dict(kw)
            if kw2.get("scenario") == "compiled4":
                kw2["scenario"] = (
                    jcompile(jspec.ScenarioSpec(), 10, 4) if pkg == "jax"
                    else compile_scenario(tspec.ScenarioSpec(), 10, 4,
                                          device="cpu"))
            kw2.setdefault("scenario", "paper_noise@1")
            with pytest.raises(ValueError, match=match):
                if pkg == "jax":
                    jrun_defta(jax.random.PRNGKey(0), jmlp_task(32, 10),
                               JDeFTAConfig(**dict(CFG, **change)),
                               JTrainConfig(**TRAIN), data, epochs=6, **kw2)
                else:
                    run_defta(0, mlp_task(32, 10),
                              DeFTAConfig(**dict(CFG, **change)),
                              TrainConfig(**TRAIN), data, epochs=6,
                              device="cpu", **kw2)
