"""The port's probe series against a live JAX run with a ledger, on the
reference's draws, and the port's telemetry on against off.

Each world runs once through the reference with a ``RunLedger`` and once
through the port with one, from the reference's initial state and on its
replayed draws (``JaxDraws``, ``JaxScenarioDraws``, ``JaxTickDraws``,
``JaxFedAvgDraws``; the cross-device world replays ``JaxScenarioDraws`` on
the cohort as ``test_torch_cross_device_slice`` does). Worlds: the static
sync world (W = 4 + 1 attacker), ``churn_signflip``, the int8 + EF21 wire
(W = 12 + 1, for ``ef_norm``), async with a target that exits early, CFL-F
and cross-device with ``label_flip`` + ``alie`` under ``all``.

Tolerances: ``round``, ``t``, the integer counts (edges, occupancy,
dropout, straggler and scatter-write counts), ``cohort``, the bool masks
and ``wire_bytes`` (an integer count times a whole-byte payload) exact;
float probes within rtol and atol 1e-4, the limit the state fields of these
worlds are held to. The int8 world's ``ef_norm`` is the norm of a residual
whose every element the port holds within one quantization step of the
reference's (``test_torch_slice.test_int8_ef_world_matches_jax``): a
round-half tie that flips moves one element by one step ``s = max|row| /
127`` of the row sent, so ``|Δ ef_norm| ≤ ‖Δe‖ ≤ s · sqrt(flips)``. The
test holds it to rtol and atol 1e-4 plus one step of the worker's largest
sent row (a single flip), ``max|params| / 127`` of its final models.

The JSONL round rows carry the reference's keys in its order (``type``,
``t``, then the probes sorted by name, as the reference's scan returns
them) and its stamps, one row per round or tick run.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_torch_slice as slice_helpers
from capture_engine_goldens import setup as golden_setup
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import engine as jengine
from repro.core import fedavg as jfedavg
from repro.core.async_defta import run_async_defta as jrun_async_defta
from repro.core.cross_device import run_cross_device as jrun_cross_device
from repro.core.defta import run_defta as jrun_defta
from repro.core.gossip import uses_error_feedback as juses_ef
from repro.core.tasks import mlp_task as jmlp_task
from repro.data.synthetic import federated_dataset as jfederated_dataset
from repro.scenarios.cross_device import CrossDeviceSpec as JSpec
from repro.telemetry import RunLedger as JRunLedger
from test_torch_async import JaxTickDraws
from test_torch_fedavg import JaxFedAvgDraws
from test_torch_scenario_slice import JaxScenarioDraws

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import (cross_device_state_from_jax,
                                 cross_device_state_to_numpy,
                                 fedavg_state_from_jax,
                                 fedavg_state_to_numpy, state_from_jax,
                                 state_to_numpy)
from repro_torch.core.async_defta import run_async_defta
from repro_torch.core.cross_device import run_cross_device
from repro_torch.core.defta import run_defta
from repro_torch.core.fedavg import run_fedavg
from repro_torch.core.tasks import mlp_task
from repro_torch.rng import TorchDraws, TorchFedAvgDraws, TorchTickDraws
from repro_torch.scenarios.cross_device import CrossDeviceSpec
from repro_torch.telemetry import RunLedger

EXACT = ("round", "edges", "wire_bytes", "damaged", "alive", "fire",
         "fired", "cohort", "occupancy", "dropout_count", "straggler_count",
         "scatter_writes")
TOL = dict(rtol=1e-4, atol=1e-4)


class ListSink:
    def __init__(self):
        self.rows = []

    def write(self, row):
        self.rows.append(row)


def ledgers():
    return (JRunLedger(sink=ListSink(), meta={"m": 1}),
            RunLedger(sink=ListSink(), meta={"m": 1}))


def fields_of(st):
    return {f.name: jax.tree.map(np.asarray, getattr(st, f.name))
            for f in dataclasses.fields(st) if f.name != "key"}


def static_world(jled, led, *, int8=False):
    """The golden world (W = 4 + 1 attacker, 6 epochs in one chunk) or
    the W = 12 + 1 world on the int8 + EF21 wire (4 epochs). The reference
    runs its einsum mix (its backends are pinned equal), the port ``auto``
    (the plain versions of the dense and the quant mix)."""
    if int8:
        data = jfederated_dataset("vector", 12, np.random.default_rng(1),
                                  n_per_worker=48, alpha=0.5)
        cfg_kw = dict(num_workers=12, avg_peers=2, num_sampled=1,
                      local_epochs=1, gossip_dtype="int8")
        train_kw = dict(learning_rate=0.05, batch_size=32)
        run_kw = dict(epochs=4, num_malicious=1)
    else:
        data, _, jcfg, jtrain = golden_setup()
        cfg_kw, train_kw = dataclasses.asdict(jcfg), dataclasses.asdict(jtrain)
        run_kw = dict(epochs=6, num_malicious=1)
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**cfg_kw)
    jst, *_ = jrun_defta(key, jmlp_task(32, 10), jcfg,
                         JTrainConfig(**train_kw), data, ledger=jled,
                         gossip_backend="einsum", **run_kw)
    init = jengine.init_state(key, jmlp_task(32, 10), jcfg.num_workers + 1,
                              wire_error=juses_ef(jcfg))
    st, *_ = run_defta(0, mlp_task(32, 10), DeFTAConfig(**cfg_kw),
                       TrainConfig(**train_kw), data, device="cpu",
                       ledger=led, init=state_from_jax(fields_of(init),
                                                       device="cpu"),
                       draws=slice_helpers.JaxDraws(init.key), **run_kw)
    return fields_of(jst), state_to_numpy(st)


def churn_world(jled, led):
    """``churn_signflip`` on 10 vanilla workers, 6 epochs."""
    from test_torch_scenario_slice import CFG, TRAIN, world_data
    data = world_data()
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**CFG)
    jst, _, jmal, _ = jrun_defta(key, jmlp_task(32, 10), jcfg,
                                 JTrainConfig(**TRAIN), data, epochs=6,
                                 scenario="churn_signflip", ledger=jled)
    init = jengine.init_state(key, jmlp_task(32, 10), len(jmal))
    st, *_ = run_defta(0, mlp_task(32, 10), DeFTAConfig(**CFG),
                       TrainConfig(**TRAIN), data, epochs=6,
                       scenario="churn_signflip", device="cpu", ledger=led,
                       init=state_from_jax(fields_of(init), device="cpu"),
                       draws=JaxScenarioDraws(init.key, False))
    return fields_of(jst), state_to_numpy(st)


def async_world(jled, led):
    """test_gossip_quant.py's async world (W = 5): a target of 6 epochs
    reached at the chunk boundary 20 of a 21-tick budget."""
    from test_torch_async import async_setup_world
    data, cfg_kw, train_kw = async_setup_world()
    kw = dict(ticks=21, target_epochs=6, check_every=4)
    key = jax.random.PRNGKey(0)
    jst, *_ = jrun_async_defta(key, jmlp_task(32, 10),
                               JDeFTAConfig(**cfg_kw),
                               JTrainConfig(**train_kw), data, ledger=jled,
                               **kw)
    init = jengine.init_state(key, jmlp_task(32, 10), 5)
    st, *_ = run_async_defta(
        0, mlp_task(32, 10), DeFTAConfig(**cfg_kw), TrainConfig(**train_kw),
        data, device="cpu", ledger=led,
        init=state_from_jax(fields_of(init), device="cpu"),
        draws=slice_helpers.JaxDraws(init.key),
        tick_draws=JaxTickDraws(key, kw["ticks"]), **kw)
    return fields_of(jst), state_to_numpy(st)


def fedavg_world(jled, led):
    """CFL-F on the golden world, 4 epochs."""
    data, jtask, jcfg, jtrain = golden_setup()
    key = jax.random.PRNGKey(0)
    kw = dict(epochs=4)
    jst = jfedavg.run_fedavg(key, jtask, jcfg, jtrain, data, ledger=jled,
                             **kw)
    jinit = jfedavg.init_state(key, jtask, "none")
    init = fedavg_state_from_jax({"server": jax.tree.map(np.asarray,
                                                         jinit.server),
                                  "opt": None}, "cpu")
    st, _ = run_fedavg(0, mlp_task(32, 10),
                       DeFTAConfig(**dataclasses.asdict(jcfg)),
                       TrainConfig(**dataclasses.asdict(jtrain)), data,
                       device="cpu", ledger=led, init=init,
                       draws=JaxFedAvgDraws(jinit.key), **kw)
    return ({"server": jax.tree.map(np.asarray, jst.server)},
            {"server": fedavg_state_to_numpy(st)["server"]})


def cross_device_world(jled, led):
    """12 enrolled, k = 4, ``label_flip`` + ``alie`` under ``all``, 8
    rounds (``test_torch_cross_device_slice``'s attacked world)."""
    from test_torch_cross_device_slice import ATTACKED, TRAIN, small_data
    cfg_kw = dict(num_workers=12, avg_peers=2, num_sampled=2,
                  local_epochs=1, seed=0, dts_signal="all")
    spec_kw = dict(enrolled=12, sample_k=4, avg_peers=3, seed=1,
                   attacks=ATTACKED)
    data = small_data(12)
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**cfg_kw)
    task = lambda m: m(8, 4, hidden=16)          # noqa: E731
    jst, _ = jrun_cross_device(key, task(jmlp_task), jcfg,
                               JTrainConfig(**TRAIN), data,
                               world=JSpec(**spec_kw), epochs=8,
                               ledger=jled)
    init = jengine.init_cross_device_state(
        key, task(jmlp_task), 12, sketch=jengine.sketch_shape(jcfg))
    st, _ = run_cross_device(
        0, task(mlp_task), DeFTAConfig(**cfg_kw), TrainConfig(**TRAIN),
        data, world=CrossDeviceSpec(**spec_kw), epochs=8, device="cpu",
        ledger=led,
        init=cross_device_state_from_jax(fields_of(init), device="cpu"),
        draws=JaxScenarioDraws(init.key, False))
    return fields_of(jst), cross_device_state_to_numpy(st)


WORLDS = {"static": static_world, "churn_signflip": churn_world,
          "int8_ef": lambda j, p: static_world(j, p, int8=True),
          "async_early_exit": async_world, "cfl_f": fedavg_world,
          "cross_device_all": cross_device_world}
ROUNDS = {"static": 6, "churn_signflip": 6, "int8_ef": 4,
          "async_early_exit": 20, "cfl_f": 4, "cross_device_all": 8}
_RUNS: dict = {}


def both(name):
    """(reference ledger, port ledger, reference state fields, port state
    fields) of world ``name``, run once per test process."""
    if name not in _RUNS:
        jled, led = ledgers()
        want, got = WORLDS[name](jled, led)
        _RUNS[name] = jled, led, want, got
    return _RUNS[name]


def ef_bound(want, got):
    """The int8 world's ``ef_norm`` limit per worker: 1e-4 plus one step
    of the worker's largest final row, max|row| / 127 over its leaves."""
    steps = np.max([np.abs(p.reshape(p.shape[0], -1)).max(axis=1)
                    for p in want["params"].values()], axis=0) / 127.0
    return steps


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_probe_series_match_jax(name):
    jled, led, want, got = both(name)
    assert led.names() == jled.names()
    assert led.rounds_done == jled.rounds_done == ROUNDS[name]
    for probe in jled.names():
        a, b = led.series(probe), jled.series(probe)
        assert a.shape == b.shape and a.dtype == b.dtype, probe
        if probe in EXACT:
            np.testing.assert_array_equal(a, b, err_msg=probe)
        elif probe == "ef_norm":
            limit = TOL["atol"] + TOL["rtol"] * np.abs(b) \
                + ef_bound(want, got)[None, :]
            assert (np.abs(a - b) <= limit).all(), probe
        else:
            np.testing.assert_allclose(a, b, err_msg=probe, **TOL)
    if name == "int8_ef":
        assert "ef_norm" in led.names()
    if name == "async_early_exit":
        np.testing.assert_array_equal(led.series("round"), np.arange(20))
        assert "fired" in led.names()


@pytest.mark.parametrize("name", sorted(WORLDS))
def test_jsonl_rows_match_jax(name):
    """Row types, keys in order and ``t`` stamps equal, one round row per
    round or tick run; the summary carries the reference's keys (its
    ``dispatches`` counts chunks here, so the value is not compared)."""
    jled, led, _, _ = both(name)
    jrows, rows = jled.sink.rows, led.sink.rows
    assert [list(r) for r in rows] == [list(r) for r in jrows]
    assert [r.get("t") for r in rows] == [r.get("t") for r in jrows]
    assert rows[0] == jrows[0] == {"type": "manifest", "m": 1}
    body = [r for r in rows if r["type"] == "round"]
    assert [r["t"] for r in body] == list(range(ROUNDS[name]))
    assert rows[-1]["rounds_recorded"] == jrows[-1]["rounds_recorded"]


def test_port_ledger_records_a_frame_per_round():
    """The repaired fault: a ledger given to the port's ``run_defta`` holds
    every probe's ``[epochs, ...]`` series where the reference's does
    (before, the port's ``series`` were None: no registry was built)."""
    jled, led, _, _ = both("static")
    assert jled.series("theta_in").shape == (6, 5)
    for name in jled.names():
        assert led.series(name) is not None, name
    assert led.series("theta_in").shape == (6, 5)
    assert len(led.sink.rows) == 1 + 6 + 1


def test_final_states_match_jax_under_telemetry():
    """The probes leave the held state fields as they were: the static and
    CFL-F worlds' final states within the fp32 limit."""
    for name in ("static", "cfl_f"):
        _, _, want, got = both(name)
        slice_helpers.assert_fields_close(want, got, **TOL)


# ---------------------------------------------------------------------------
# Port telemetry on vs off: the same state bit for bit, the same draws
# ---------------------------------------------------------------------------

class Recording:
    """A draw provider that records every request it is given."""

    def __init__(self, inner):
        self.inner, self.requests = inner, []

    def __call__(self, *args, **kw):
        self.requests.append(repr((args, sorted(kw.items()))))
        return self.inner(*args, **kw)


def on_off(run):
    """``run(ledger, draws, tick_draws)`` with a ledger and without, from
    one seed; returns ((state, draws, tick draws, ledger), ...)."""
    out = []
    for led in (RunLedger(), None):
        gen = torch.Generator()
        gen.manual_seed(5)
        draws = Recording(TorchDraws(gen))
        ticks = Recording(TorchTickDraws(gen))
        out.append((run(led, draws, ticks), draws, ticks, led))
    return out


def assert_bit_equal(a, b):
    slice_helpers.assert_fields_close(a, b, rtol=0, atol=0)


def port_data(w=6):
    return jfederated_dataset("vector", w, np.random.default_rng(2),
                              n_per_worker=32, alpha=0.5)


CFG = dict(num_workers=6, avg_peers=2, num_sampled=1, local_epochs=1)


@pytest.mark.parametrize("kind", ["storm_int8_all", "async_target",
                                  "fedavg_cfl_s", "cross_device_int8"])
def test_telemetry_on_leaves_state_and_draws_unchanged(kind):
    data, train = port_data(), TrainConfig(batch_size=16)
    task = mlp_task(32, 10)
    if kind == "storm_int8_all":
        cfg = DeFTAConfig(**CFG, gossip_dtype="int8", dts_signal="all",
                          gossip_wire_round="stochastic")

        def run(led, draws, ticks):
            return state_to_numpy(run_defta(
                0, task, cfg, train, data, epochs=4, scenario="storm",
                device="cpu", ledger=led, draws=draws)[0])
    elif kind == "async_target":
        cfg = DeFTAConfig(**CFG)

        def run(led, draws, ticks):
            return state_to_numpy(run_async_defta(
                0, task, cfg, train, data, ticks=12, target_epochs=3,
                check_every=2, num_malicious=1, device="cpu", ledger=led,
                draws=draws, tick_draws=ticks)[0])
    elif kind == "fedavg_cfl_s":
        cfg = DeFTAConfig(**CFG)

        def run(led, draws, ticks):
            gen = torch.Generator()
            gen.manual_seed(6)
            fd = Recording(TorchFedAvgDraws(gen))
            st, _ = run_fedavg(0, task, cfg, train, data, epochs=3,
                               num_malicious=1, sample_workers=3,
                               device="cpu", ledger=led, draws=fd)
            draws.requests = fd.requests
            return {"server": fedavg_state_to_numpy(st)["server"]}
    else:
        cfg = DeFTAConfig(**CFG, gossip_dtype="int8", dts_signal="all")

        def run(led, draws, ticks):
            return cross_device_state_to_numpy(run_cross_device(
                0, task, cfg, train, data, world=CrossDeviceSpec(
                    enrolled=6, sample_k=4, attacks=(("alie", 0.3),)),
                epochs=4, device="cpu", ledger=led, draws=draws)[0])
    (on, d_on, t_on, led), (off, d_off, t_off, _) = on_off(run)
    assert d_on.requests == d_off.requests and d_on.requests
    assert t_on.requests == t_off.requests
    assert_bit_equal(on, off)
    assert led.names() and all(led.series(n) is not None
                               for n in led.names())


def test_probes_false_keeps_the_accounting_only():
    """``probes=False`` with a ledger: chunk accounting, no frames, and
    the round is built without a registry."""
    led = RunLedger()
    run_defta(0, mlp_task(32, 10), DeFTAConfig(**CFG), TrainConfig(
        batch_size=16), port_data(), epochs=2, device="cpu", ledger=led,
        probes=False)
    assert led.as_stats() == {"dispatches": 1, "epochs": 2}
    assert led.names() == [] and led.series("round") is None
