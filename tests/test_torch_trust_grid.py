"""Trust-grid cells at full size, the port against the JAX package on one
draw stream: the world of ``benchmarks/table_trust.py`` (20 vanilla
workers + 8 attackers, W = 28, non-iid α = 0.5, 3 local epochs, seed 0),
40 epochs. The card's ``port_table_trust.py`` and the JAX sweep draw
different random numbers, so their cells differ by the seed-to-seed
spread; here both packages start from the reference's initial state and
the port replays the reference's draws (``JaxScenarioDraws``), so a
cell's honest accuracy, confidences and sketch ring buffer must agree.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

import repro.scenarios.spec as jspec
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import engine as jengine
from repro.core.defta import evaluate as jevaluate
from repro.core.defta import run_defta as jrun_defta
from repro.core.tasks import mlp_task as jmlp_task
from repro.data.synthetic import federated_dataset
from test_torch_scenario_slice import JaxScenarioDraws

import repro_torch.scenarios.spec as tspec
from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.core.defta import evaluate, run_defta
from repro_torch.core.tasks import mlp_task

EPOCHS = 40


@pytest.mark.parametrize("attack,signal", [("alie", "corr"),
                                           ("alie", "all"),
                                           ("label_flip", "loss")])
def test_trust_grid_cell_matches_jax_on_equal_draws(attack, signal):
    data = federated_dataset("vector", 20, np.random.default_rng(0),
                             n_per_worker=120, alpha=0.5)
    cfg_kw = dict(num_workers=20, avg_peers=4, num_sampled=2,
                  local_epochs=3, dts_signal=signal, seed=0)
    train_kw = dict(learning_rate=0.05, batch_size=32)

    def spec(m):
        return m.ScenarioSpec(attacks=tuple(m.AttackSpec(attack)
                                            for _ in range(8)))
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**cfg_kw)
    jst, _, jmal, _ = jrun_defta(key, jmlp_task(32, 10), jcfg,
                                 JTrainConfig(**train_kw), data,
                                 epochs=EPOCHS, scenario=spec(jspec))
    init = jengine.init_state(key, jmlp_task(32, 10), len(jmal),
                              sketch=jengine.sketch_shape(jcfg))
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init) if f.name != "key"}
    st, _, mal, _ = run_defta(
        0, mlp_task(32, 10), DeFTAConfig(**cfg_kw), TrainConfig(**train_kw),
        data, epochs=EPOCHS, scenario=spec(tspec), device="cpu",
        init=state_from_jax(fields, device="cpu"),
        draws=JaxScenarioDraws(init.key, False))
    np.testing.assert_array_equal(mal, jmal)
    want = jevaluate(jmlp_task(32, 10), jst, data["test_x"],
                     data["test_y"], jmal)[0]
    got = evaluate(mlp_task(32, 10), st, data["test_x"], data["test_y"],
                   mal)[0]
    # one flipped test prediction of one worker moves the mean by 1/(20 N)
    assert abs(got - want) <= 1.0 / (20 * len(data["test_y"])), (got, want)
    port = state_to_numpy(st)
    np.testing.assert_allclose(port["conf"], np.asarray(jst.conf),
                               rtol=1e-4, atol=1e-4)
    if jst.sketch is None:
        assert port["sketch"] is None
    else:
        np.testing.assert_array_equal(port["sketch"], np.asarray(jst.sketch))
