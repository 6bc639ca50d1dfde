"""The port's DTS v2 and v3 trust channels end to end: ``run_defta`` and
``run_async_defta`` against live JAX runs.

Both packages start from one initial state, the sketch ring buffer
included (``convert.state_from_jax``), and consume one draw stream
(``JaxScenarioDraws``; the geometry and correlation channels draw
nothing). The worlds are the reference's headline cells for these
channels (``benchmarks/table_trust.py``), cut to 10 vanilla workers + 3
attackers (``alie`` colluders or ``label_flip``), with a straggler so the
fire merge gates the sketch rows, 4 epochs. Every state field, the sketch
included, is held within 1e-4; epochs and ticks run are exact.
"""
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
                                       assert_same, run_both, world_data)

import repro_torch.scenarios.spec as tspec
from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.core.async_defta import run_async_defta
from repro_torch.core.tasks import mlp_task
from repro_torch.telemetry import RunLedger

EPOCHS = 4


def attacked(kind):
    """Three attackers of ``kind`` and a half-speed straggler, worker 0,
    which four workers listen to (its idle rounds' deltas must not be
    scored)."""
    def build(m):
        return m.ScenarioSpec(
            attacks=tuple(m.AttackSpec(kind) for _ in range(3)),
            stragglers=(m.StragglerSpec(worker=0, speed=0.5),))
    return build


def filled_rounds(sketch):
    """Per worker, the ring-buffer slots holding a sketch."""
    return (np.abs(sketch).max(axis=2) > 0).sum(axis=1)


@pytest.mark.parametrize("kind", ["alie", "label_flip"])
@pytest.mark.parametrize("signal", ["geom", "both", "corr", "all"])
def test_run_defta_trust_channels_match_jax(signal, kind):
    want, got, mal = run_both(attacked(kind), epochs=EPOCHS,
                              cfg=dict(dts_signal=signal, num_sampled=2))
    assert mal.sum() == 3
    assert_same(want, got)
    if signal in ("corr", "all"):
        # a ring buffer rotates only on the rounds its worker fired
        np.testing.assert_array_equal(filled_rounds(got["sketch"]),
                                      got["epoch"])
        assert got["epoch"][0] < EPOCHS
    else:
        assert got["sketch"] is None


def test_run_async_defta_all_channels_under_a_straggler_match_jax():
    cfg_kw = dict(CFG, dts_signal="all", num_sampled=2)
    kw = dict(ticks=6)
    data = world_data()
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**cfg_kw)
    jst, _, jmal, jspeeds = jrun_async_defta(
        key, jmlp_task(32, 10), jcfg, JTrainConfig(**TRAIN), data,
        scenario=attacked("alie")(jspec), **kw)
    init = jengine.init_state(key, jmlp_task(32, 10), len(jmal),
                              sketch=jengine.sketch_shape(jcfg))
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init) if f.name != "key"}
    draws = JaxScenarioDraws(init.key, False)
    tick_draws = JaxTickDraws(key, kw["ticks"])
    led = RunLedger()
    st, _, mal, speeds = run_async_defta(
        0, mlp_task(32, 10), DeFTAConfig(**cfg_kw), TrainConfig(**TRAIN),
        data, scenario=attacked("alie")(tspec), device="cpu", ledger=led,
        init=state_from_jax(fields, device="cpu"), draws=draws,
        tick_draws=tick_draws, **kw)
    np.testing.assert_array_equal(mal, jmal)
    np.testing.assert_array_equal(speeds, np.asarray(jspeeds, np.float32))
    np.testing.assert_array_equal(np.asarray(draws.key), np.asarray(jst.key))
    assert led.rounds_done == draws.calls == tick_draws.calls == kw["ticks"]
    want = {f.name: jax.tree.map(np.asarray, getattr(jst, f.name))
            for f in dataclasses.fields(jst) if f.name != "key"}
    got = state_to_numpy(st)
    assert_same(want, got)
    # the tick and the scenario gate the sketch rows: a row rotates only
    # when its worker completed a round
    np.testing.assert_array_equal(filled_rounds(got["sketch"]),
                                  got["epoch"])
    assert got["epoch"].min() < got["epoch"].max()


def test_state_from_jax_carries_the_sketch():
    """A reference state with a sketch ring buffer arrives intact, and a
    world whose config needs a sketch rejects an init without one."""
    jcfg = JDeFTAConfig(**dict(CFG, dts_signal="corr"))
    shape = jengine.sketch_shape(jcfg)
    assert shape == (jcfg.dts_sketch_rounds, jcfg.dts_sketch_dim)
    init = jengine.init_state(jax.random.PRNGKey(1), jmlp_task(32, 10), 10,
                              sketch=shape)
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init) if f.name != "key"}
    fields["sketch"] = np.sign(np.random.default_rng(0).normal(
        size=fields["sketch"].shape)).astype(np.float32)
    st = state_from_jax(fields, device="cpu")
    assert tuple(st.sketch.shape) == (10,) + shape
    back = state_to_numpy(st)
    assert back["sketch"].dtype == np.float32
    np.testing.assert_array_equal(back["sketch"], fields["sketch"])
    slice_helpers.assert_fields_close(fields, back, rtol=0, atol=0)

    from repro_torch.core.defta import run_defta
    without = state_from_jax(dict(fields, sketch=None), device="cpu")
    cfg = DeFTAConfig(**dict(CFG, dts_signal="corr"))
    with pytest.raises(ValueError, match="sketch"):
        run_defta(0, mlp_task(32, 10), cfg, TrainConfig(**TRAIN),
                  world_data(), epochs=1, device="cpu", init=without)
