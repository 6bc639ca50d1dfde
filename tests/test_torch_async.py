"""The port's ``run_async_defta`` against a live JAX ``run_async_defta``.

Both start from one initial state (``convert.state_from_jax``) and consume
the same randomness: the round's draws through ``JaxDraws`` and the
ticks' uniforms through ``JaxTickDraws``, which replays the reference's
``split(fold_in(key, 99), ticks)`` (async_defta.py:114). The reference
runs its default einsum mix; the port runs ``auto`` (the plain version of
the kernel ``auto`` picks) and ``einsum``. The JAX package pins its
backends equal, so only summation order differs.
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
from repro.core.async_defta import run_async_defta as jrun_async_defta
from repro.core.gossip import uses_error_feedback as juses_ef
from repro.core.tasks import mlp_task as jmlp_task
from repro.data.synthetic import federated_dataset as jfederated_dataset

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.core import engine
from repro_torch.core.async_defta import run_async_defta
from repro_torch.core.tasks import mlp_task
from repro_torch.rng import TorchDraws, TorchTickDraws
from repro_torch.telemetry import RunLedger


class JaxTickDraws:
    """The reference's per-tick uniforms: ``uniform(tkeys[t], (W,))`` with
    ``tkeys = split(fold_in(key, 99), ticks)``, one per call in tick
    order."""

    def __init__(self, key, ticks):
        self.keys = jax.random.split(jax.random.fold_in(key, 99),
                                     max(ticks, 1))[:ticks]
        self.calls = 0

    def __call__(self, w):
        u = jax.random.uniform(self.keys[self.calls], (w,))
        self.calls += 1
        return torch.tensor(np.asarray(u))


def env_world():
    data, _, cfg, train = golden_setup()
    return data, dataclasses.asdict(cfg), dataclasses.asdict(train)


def async_setup_world():
    """test_gossip_quant.py's ``_async_setup``: W = 5, avg_peers = 2."""
    data = jfederated_dataset("vector", 5, np.random.default_rng(4),
                              n_per_worker=48, alpha=0.5)
    return data, dict(num_workers=5, avg_peers=2, num_sampled=1,
                      local_epochs=1), dict(learning_rate=0.05,
                                            batch_size=16)


def world12(**cfg):
    """W = 12 + 1 attacker at density 3/13: ``auto`` picks the sparse
    mix (the quant mix on the int8 wire)."""
    data = jfederated_dataset("vector", 12, np.random.default_rng(1),
                              n_per_worker=48, alpha=0.5)
    return data, dict(num_workers=12, avg_peers=2, num_sampled=1,
                      local_epochs=2, **cfg), dict(learning_rate=0.05,
                                                   batch_size=32)


WORLDS = {"env": env_world, "async_setup": async_setup_world,
          "world12": world12,
          "world12_int8": lambda: world12(gossip_dtype="int8")}

# (world, run keywords, ticks run): the reference's async_target golden
# setting (test_engine.py:69), its device-exit parity settings
# (test_gossip_quant.py:229: a target reached at the chunk boundary 20 of
# a 21-tick budget, and one never reached), and an untargeted run with an
# attacker on the sparse mix
SETTINGS = {
    "target3": ("env", dict(ticks=10, target_epochs=3), 10),
    "t21_target6": ("async_setup", dict(ticks=21, target_epochs=6,
                                        check_every=4), 20),
    "t8_target100": ("async_setup", dict(ticks=8, target_epochs=100,
                                         check_every=4), 8),
    "untargeted_attacker": ("world12", dict(ticks=6, num_malicious=1), 6),
}

_JAX_RUNS: dict = {}


def jax_run(world, kw):
    """The reference's final state fields, its final round key (one split
    per live tick, so it counts the ticks run), malicious and speeds
    (memoized: both port backends are held against one reference run)."""
    name = (world, tuple(sorted(kw.items())))
    if name not in _JAX_RUNS:
        data, cfg_kw, train_kw = WORLDS[world]()
        st, _, mal, speeds = jrun_async_defta(
            jax.random.PRNGKey(0), jmlp_task(32, 10),
            JDeFTAConfig(**cfg_kw), JTrainConfig(**train_kw), data, **kw)
        fields = {f.name: jax.tree.map(np.asarray, getattr(st, f.name))
                  for f in dataclasses.fields(st)
                  if f.name != "key"}
        _JAX_RUNS[name] = fields, np.asarray(st.key), mal, np.asarray(speeds)
    return _JAX_RUNS[name]


def port_run(world, kw, backend):
    """The port from the reference's initial state and draws; returns the
    final fields, ticks run, malicious, speeds and the providers."""
    data, cfg_kw, train_kw = WORLDS[world]()
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**cfg_kw)
    w = jcfg.num_workers + kw.get("num_malicious", 0)
    init = jengine.init_state(key, jmlp_task(32, 10), w,
                              wire_error=juses_ef(jcfg))
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init)
              if f.name != "key"}
    draws = slice_helpers.JaxDraws(init.key)
    tick_draws = JaxTickDraws(key, kw["ticks"])
    led = RunLedger()
    st, _, mal, speeds = run_async_defta(
        0, mlp_task(32, 10), DeFTAConfig(**cfg_kw), TrainConfig(**train_kw),
        data, gossip_backend=backend, device="cpu", ledger=led,
        init=state_from_jax(fields, device="cpu"), draws=draws,
        tick_draws=tick_draws, **kw)
    return state_to_numpy(st), led, mal, speeds, draws, tick_draws


FP32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["auto", "einsum"])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_run_async_defta_matches_jax(setting, backend):
    world, kw, ticks_run = SETTINGS[setting]
    want, want_key, jmal, jspeeds = jax_run(world, kw)
    got, led, mal, speeds, draws, tick_draws = port_run(world, kw, backend)
    np.testing.assert_array_equal(mal, jmal)
    assert speeds.dtype == np.float32
    np.testing.assert_array_equal(speeds, jspeeds)
    # the same number of ticks ran: the replayed round key, split once per
    # provider call, ends where the reference's state key does
    np.testing.assert_array_equal(np.asarray(draws.key), want_key)
    assert led.rounds_done == draws.calls == tick_draws.calls == ticks_run
    np.testing.assert_array_equal(got["epoch"], want["epoch"])
    assert got["epoch"].min() < got["epoch"].max()       # fired unevenly
    slice_helpers.assert_fields_close(want, got, **FP32_TOL)


def test_int8_ef_async_matches_jax():
    """The int8 + EF21 wire on ``auto`` (the quant mix's plain version):
    epochs and ticks exactly, losses and conf at rtol 1e-3, params, backup
    and residuals within one quantization step, as in
    ``test_torch_slice.test_int8_ef_world_matches_jax``."""
    kw = dict(ticks=6, num_malicious=1)
    want, want_key, _, _ = jax_run("world12_int8", kw)
    got, led, _, _, draws, _ = port_run("world12_int8", kw, "auto")
    np.testing.assert_array_equal(np.asarray(draws.key), want_key)
    assert led.rounds_done == 6
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


class Counting:
    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def __call__(self, *args):
        self.calls += 1
        return self.inner(*args)


def test_early_exit_stops_at_target_and_draws_nothing_after():
    """The pattern of test_gossip_quant.py:270 on the port alone: the run
    stops at a chunk boundary once every vanilla worker has 3 epochs, well
    inside the 60-tick budget, and neither provider is called after the
    exit: one round draw and one tick draw per tick run."""
    data, cfg_kw, train_kw = async_setup_world()
    gen = torch.Generator()
    gen.manual_seed(1)
    draws, ticks = Counting(TorchDraws(gen)), Counting(TorchTickDraws(gen))
    led = RunLedger()
    st, _, mal, _ = run_async_defta(
        1, mlp_task(32, 10), DeFTAConfig(**cfg_kw), TrainConfig(**train_kw),
        data, ticks=60, target_epochs=3, check_every=4, device="cpu",
        ledger=led, draws=draws, tick_draws=ticks)
    ep = st.epoch.numpy()[~mal]
    assert (ep >= 3).all() and ep.max() < 30, ep
    run = led.rounds_done
    assert 0 < run < 60 and run % 4 == 0
    assert draws.calls == ticks.calls == run
    assert led.as_stats() == {"dispatches": run // 4, "ticks": 60}


@pytest.mark.parametrize("ticks,check_every", [(7, 3), (5, 0)])
def test_untargeted_runs_every_tick(ticks, check_every):
    """No target: every tick runs, in one chunk, each drawing once from
    each provider."""
    data, cfg_kw, train_kw = async_setup_world()
    gen = torch.Generator()
    draws, tick_draws = Counting(TorchDraws(gen)), \
        Counting(TorchTickDraws(gen))
    led = RunLedger()
    st, *_ = run_async_defta(
        0, mlp_task(32, 10), DeFTAConfig(**cfg_kw), TrainConfig(**train_kw),
        data, ticks=ticks, check_every=check_every, device="cpu",
        ledger=led, draws=draws, tick_draws=tick_draws)
    assert draws.calls == tick_draws.calls == ticks
    assert led.as_stats() == {"dispatches": 1, "ticks": ticks}
    assert int(st.epoch.max()) <= ticks


def test_tick_merge_gates_every_field_on_fired():
    """One tick with speeds 1 (always fires) and 0 (never): fired workers
    take the round's state, EF21 residual included; the others keep every
    field of theirs bit for bit."""
    data, cfg_kw, train_kw = world12(gossip_dtype="int8")
    cfg = DeFTAConfig(**cfg_kw)
    w = 12
    gen = torch.Generator()
    gen.manual_seed(0)
    from repro_torch.core.defta import initial_state, to_device_data
    from repro_torch.core.topology import make_topology
    state = initial_state(gen, mlp_task(32, 10), cfg, w, None)
    state.wire_err = {k: torch.randn(v.shape, generator=gen)
                      for k, v in state.wire_err.items()}
    rnd = engine.build_defta_round(
        mlp_task(32, 10), cfg, TrainConfig(**train_kw),
        make_topology(cfg.topology, w, cfg.avg_peers, cfg.seed),
        data["sizes"], np.zeros(w, bool), draws=TorchDraws(gen),
        device="cpu")
    tdata = to_device_data(data, "cpu")
    speeds = torch.tensor([1.0, 0.0] * 6)
    fired = speeds > 0
    gen.manual_seed(5)
    nxt = rnd(state, tdata)
    gen.manual_seed(5)
    tick = engine.build_fire_gated_tick(rnd, tdata, speeds, w,
                                        draws=lambda n: torch.rand(n) * 0.99)
    got = tick(state, 0)
    for field in ("params", "backup", "wire_err"):
        for k, v in getattr(got, field).items():
            torch.testing.assert_close(v[fired], getattr(nxt, field)[k][fired],
                                       rtol=0, atol=0)
            torch.testing.assert_close(v[~fired],
                                       getattr(state, field)[k][~fired],
                                       rtol=0, atol=0)
    for field in ("conf", "best_loss", "last_loss", "epoch"):
        v = getattr(got, field)
        torch.testing.assert_close(v[fired], getattr(nxt, field)[fired],
                                   rtol=0, atol=0)
        torch.testing.assert_close(v[~fired], getattr(state, field)[~fired],
                                   rtol=0, atol=0)
    assert got.epoch.tolist() == [1, 0] * 6


def test_refusals():
    """Shards still raise (item 7); a scenario runs (test_torch_scenario_
    async.py), but attackers come from it or from num_malicious, not
    both."""
    data, cfg_kw, train_kw = async_setup_world()
    args = (0, mlp_task(32, 10), DeFTAConfig(**cfg_kw),
            TrainConfig(**train_kw), data)
    with pytest.raises(ValueError, match="not num_malicious"):
        run_async_defta(*args, ticks=2, scenario="churn_signflip",
                        num_malicious=1, device="cpu")
    with pytest.raises(NotImplementedError, match="queue 1a, item 7"):
        run_async_defta(*args, ticks=2, shards=2, device="cpu")
