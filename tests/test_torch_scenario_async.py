"""The port's ``run_async_defta`` under a scenario against a live JAX
``run_async_defta``: the scenario is compiled over the tick budget and
replayed with the tick index as its epoch, and a target waits only for the
vanilla workers whose fire opportunities reach it (all of them when none
can). Draws replayed as in ``test_torch_scenario_slice`` and
``test_torch_async``; ticks run are counted by the reference's final round
key."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

import repro.scenarios.spec as jspec
import test_torch_slice as slice_helpers
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import engine as jengine
from repro.core.async_defta import run_async_defta as jrun_async_defta
from repro.core.tasks import mlp_task as jmlp_task
from test_torch_async import JaxTickDraws
from test_torch_scenario_slice import (CFG, TRAIN, JaxScenarioDraws,
                                       scenario_for, world_data)

import repro_torch.scenarios.spec as tspec
from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.core.async_defta import run_async_defta
from repro_torch.core.tasks import mlp_task
from repro_torch.telemetry import RunLedger


def early_leaver(m):
    """storm's attacks, partition and straggler, with worker 0 leaving at
    tick 3: it can fire at most 3 times, below a target of 4."""
    s = m.get_scenario("storm", 10)
    return dataclasses.replace(s, churn=(m.ChurnSpec(worker=0, leave=3),))


# (scenario, run keywords, whether the target exits early)
SETTINGS = {
    "storm_untargeted": ("storm", dict(ticks=10), False),
    "early_leaver_target4": (early_leaver, dict(ticks=40, target_epochs=4,
                                                check_every=4), True),
    "unreachable_target": ("storm", dict(ticks=8, target_epochs=9,
                                         check_every=4), False),
}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_scenario_async_matches_jax(setting):
    scenario, kw, exits_early = SETTINGS[setting]
    data = world_data()
    key = jax.random.PRNGKey(0)
    jst, _, jmal, jspeeds = jrun_async_defta(
        key, jmlp_task(32, 10), JDeFTAConfig(**CFG), JTrainConfig(**TRAIN),
        data, scenario=scenario_for(scenario, jspec), **kw)
    init = jengine.init_state(key, jmlp_task(32, 10), len(jmal))
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init)
              if f.name != "key"}
    draws = JaxScenarioDraws(init.key, False)
    tick_draws = JaxTickDraws(key, kw["ticks"])
    led = RunLedger()
    st, _, mal, speeds = run_async_defta(
        0, mlp_task(32, 10), DeFTAConfig(**CFG), TrainConfig(**TRAIN), data,
        scenario=scenario_for(scenario, tspec), device="cpu", ledger=led,
        init=state_from_jax(fields, device="cpu"), draws=draws,
        tick_draws=tick_draws, **kw)
    np.testing.assert_array_equal(mal, jmal)
    np.testing.assert_array_equal(speeds, np.asarray(jspeeds, np.float32))
    # the same ticks ran: one round key split per live tick on both sides
    np.testing.assert_array_equal(np.asarray(draws.key), np.asarray(jst.key))
    ran = led.rounds_done
    assert draws.calls == tick_draws.calls == ran
    assert (ran < kw["ticks"]) == exits_early, ran
    if exits_early:
        ep = st.epoch.numpy()
        assert ep[0] < kw["target_epochs"] <= ep[1:10].min(), ep
    want = {f.name: jax.tree.map(np.asarray, getattr(jst, f.name))
            for f in dataclasses.fields(jst)
            if f.name != "key"}
    got = state_to_numpy(st)
    np.testing.assert_array_equal(got["epoch"], want["epoch"])
    slice_helpers.assert_fields_close(want, got, rtol=1e-4, atol=1e-4)
