"""Krum in the paper's Table 3 world on equal draws: the port's
``run_defta`` against a live JAX ``run_defta``.

``port_table3.py``'s sweep put Krum's ``scaling`` and ``label_flip`` cells
more than 0.05 from the JAX run's (ROADMAP queue 3). The two runs drew
different random streams; here both start from one initial state and
consume one draw stream (``JaxScenarioDraws``), in the sweep's world (20
vanilla workers of ``make_setup`` + 40 attackers of one kind, W = 60,
Krum, no DTS, no time machine). Each round's Krum picks are recorded on
both sides (``jax.debug.callback`` in the reference's scan) and must be
equal; every state field must agree within 1e-4.

``label_flip`` runs 6 epochs, ``scaling`` 5: in the 6th epoch of the
scaling cell one honest worker (2) holds a hidden pre-activation of
4.8e-8 during local training, inside the packages' 7e-8 drift of its
parameters, so the ReLU's side flips and one step's gradient moves 3 of
its 122,880 w1 entries 1.6e-4 apart (every other entry stays within
1.7e-5, and the 6th epoch's picks are still equal). That is a float
rounding at a kink, not a difference of Krum.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

import repro.scenarios.robust_agg as jrobust
import repro.scenarios.spec as jspec
import test_torch_slice as slice_helpers
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import engine as jengine
from repro.core.defta import run_defta as jrun_defta
from repro.core.tasks import mlp_task as jmlp_task
from repro.data.synthetic import federated_dataset as jfederated_dataset
from test_torch_scenario_slice import JaxScenarioDraws

import repro_torch.scenarios.robust_agg as trobust
import repro_torch.scenarios.spec as tspec
from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.core.defta import run_defta
from repro_torch.core.tasks import mlp_task

EPOCHS = {"label_flip": 6, "scaling": 5}
K = 40
# benchmarks/common.make_setup("mlp_vector", 20) with the sweep's Krum
CFG = dict(num_workers=20, avg_peers=4, num_sampled=2, local_epochs=5,
           seed=0, aggregation="krum", use_dts=False, time_machine=False)
TRAIN = dict(learning_rate=0.05, batch_size=32)


@pytest.mark.parametrize("attack", ["scaling", "label_flip"])
def test_krum_table3_cell_matches_jax_on_equal_draws(monkeypatch, attack):
    data = jfederated_dataset("vector", 20, np.random.default_rng(0),
                              n_per_worker=150)
    picks = {"jax": [], "torch": []}
    jselect, tselect = jrobust.krum_select, trobust.krum_select

    def jrecord(mask, stacked, trim):
        sel = jselect(mask, stacked, trim)
        jax.debug.callback(lambda s: picks["jax"].append(np.asarray(s)),
                           sel, ordered=True)
        return sel

    def trecord(mask, stacked, trim):
        sel = tselect(mask, stacked, trim)
        picks["torch"].append(sel.numpy())
        return sel
    monkeypatch.setattr(jrobust, "krum_select", jrecord)
    monkeypatch.setattr(trobust, "krum_select", trecord)

    def spec(m):
        return m.ScenarioSpec(name=f"{attack}_k{K}", attacks=tuple(
            m.AttackSpec(attack) for _ in range(K)))
    key = jax.random.PRNGKey(0)
    jst, _, jmal, _ = jrun_defta(key, jmlp_task(32, 10),
                                 JDeFTAConfig(**CFG), JTrainConfig(**TRAIN),
                                 data, epochs=EPOCHS[attack],
                                 scenario=spec(jspec))
    init = jengine.init_state(key, jmlp_task(32, 10), len(jmal))
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init) if f.name != "key"}
    draws = JaxScenarioDraws(init.key, False)
    st, _, mal, _ = run_defta(
        0, mlp_task(32, 10), DeFTAConfig(**CFG), TrainConfig(**TRAIN), data,
        epochs=EPOCHS[attack], scenario=spec(tspec), device="cpu",
        init=state_from_jax(fields, device="cpu"), draws=draws)
    assert len(mal) == 60 and mal.sum() == K
    np.testing.assert_array_equal(mal, jmal)
    np.testing.assert_array_equal(np.asarray(draws.key), np.asarray(jst.key))
    assert len(picks["jax"]) == len(picks["torch"]) == EPOCHS[attack]
    for t, (a, b) in enumerate(zip(picks["jax"], picks["torch"])):
        np.testing.assert_array_equal(b, a, err_msg=f"epoch {t} picks")
    # the attackers win some receivers' picks: the comparison is not of
    # an honest-only selection
    assert any(np.isin(p, np.flatnonzero(mal)).any() for p in picks["torch"])
    want = {f.name: jax.tree.map(np.asarray, getattr(jst, f.name))
            for f in dataclasses.fields(jst) if f.name != "key"}
    got = state_to_numpy(st)
    np.testing.assert_array_equal(got["epoch"], want["epoch"])
    slice_helpers.assert_fields_close(want, got, rtol=1e-4, atol=1e-4)
