"""The port's cross-device round against a live JAX ``run_cross_device``.

Both packages start from one population (the reference's
``init_cross_device_state``, carried across by
``convert.cross_device_state_from_jax``) and consume one draw stream:
``JaxScenarioDraws`` replays the reference's per-round key layout on the
cohort (W = k), starting from ``keys[-1]`` of its ``split(key, N + 1)``.
The reference runs its default ``einsum`` backend, the port ``auto`` (the
plain version of the dense mix on the CPU). Worlds at the reference
tests' size (12 enrolled, k = 4) and at 40 enrolled, k = 8: clean
``loss``, ``label_flip`` + ``alie`` under geom / corr / all, vacancy,
``max_staleness`` 3, ``k_min`` 2, ``dts_conf_decay`` 0.9 with
``dts_min_obs`` 2, and the int8 + EF21 stochastic wire. Every
``CrossDeviceState`` field agrees: floats within 1e-4 (the int8 world's
models within one quantization step), sketches and stamps equal, and
``epoch``, ``obs``, ``last_part`` and the probe history exact.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest

import test_torch_slice as slice_helpers
from geom_tie import record_reference_norm_median, reference_off_exact
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import engine as jengine
from repro.core.cross_device import run_cross_device as jrun_cross_device
from repro.core.gossip import uses_error_feedback as juses_ef
from repro.core.tasks import mlp_task as jmlp_task
from repro.data.synthetic import federated_dataset as jfederated_dataset
from repro.scenarios.cross_device import CrossDeviceSpec as JSpec
from test_torch_scenario_slice import JaxScenarioDraws

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import (cross_device_state_from_jax,
                                 cross_device_state_to_numpy)
from repro_torch.core.cross_device import run_cross_device
from repro_torch.core.tasks import mlp_task
from repro_torch.scenarios.cross_device import CrossDeviceSpec
from torch_threads import one_torch_thread  # noqa: F401


TRAIN = dict(learning_rate=0.05, batch_size=8)
FP32_TOL = dict(rtol=1e-4, atol=1e-4)
EXACT = ("epoch", "obs", "last_part", "sketch", "sketch_round")
ATTACKED = (("label_flip", 0.2), ("alie", 0.2))
# name: (config change, spec change, rounds)
WORLDS = {
    "clean_loss": ({}, {}, 10),
    "attacked_geom": (dict(dts_signal="geom"), dict(attacks=ATTACKED), 10),
    "attacked_corr": (dict(dts_signal="corr"), dict(attacks=ATTACKED), 12),
    "attacked_all": (dict(dts_signal="all"), dict(attacks=ATTACKED), 12),
    "vacancy": ({}, dict(availability=0.3, attacks=(("sign_flip", 0.2),)),
                10),
    "staleness3": (dict(max_staleness=3), dict(availability=0.5), 12),
    "k_min2": ({}, dict(k_min=2, avg_peers=2), 8),
    "decay_min_obs": (dict(dts_signal="all", dts_conf_decay=0.9,
                           dts_min_obs=2), dict(attacks=ATTACKED), 12),
    "int8_ef_stochastic": (dict(gossip_dtype="int8",
                                gossip_wire_round="stochastic",
                                dts_signal="all"),
                           dict(attacks=(("noise", 0.2),)), 8),
}


def small_data(enrolled):
    return jfederated_dataset("vector", enrolled, np.random.default_rng(3),
                              n_per_worker=24, dim=8, num_classes=4)


def run_both(name, enrolled, k, *, eval_every=4):
    """The world ``name`` through both packages; returns (reference fields,
    port fields, reference history, port history, draws)."""
    cfg_change, spec_change, rounds = WORLDS[name]
    cfg_kw = dict(num_workers=enrolled, avg_peers=2, num_sampled=2,
                  local_epochs=1, seed=0, **cfg_change)
    spec_kw = dict(dict(enrolled=enrolled, sample_k=k, avg_peers=3, seed=1),
                   **spec_change)
    data = small_data(enrolled)
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**cfg_kw)
    jst, jhist = jrun_cross_device(
        key, jmlp_task(8, 4, hidden=16), jcfg, JTrainConfig(**TRAIN), data,
        world=JSpec(**spec_kw), epochs=rounds, eval_every=eval_every,
        test_x=data["test_x"], test_y=data["test_y"], probe=6)
    init = jengine.init_cross_device_state(
        key, jmlp_task(8, 4, hidden=16), enrolled, wire_error=juses_ef(jcfg),
        sketch=jengine.sketch_shape(jcfg))
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init) if f.name != "key"}
    draws = JaxScenarioDraws(init.key,
                             jengine.make_transport(jcfg).stochastic)
    st, hist = run_cross_device(
        0, mlp_task(8, 4, hidden=16), DeFTAConfig(**cfg_kw),
        TrainConfig(**TRAIN), data, world=CrossDeviceSpec(**spec_kw),
        epochs=rounds, eval_every=eval_every, test_x=data["test_x"],
        test_y=data["test_y"], probe=6, device="cpu",
        init=cross_device_state_from_jax(fields, device="cpu"),
        draws=draws)
    # one provider call a round: the replayed key ends on the reference's
    assert draws.calls == rounds
    np.testing.assert_array_equal(np.asarray(draws.key), np.asarray(jst.key))
    want = {f.name: jax.tree.map(np.asarray, getattr(jst, f.name))
            for f in dataclasses.fields(jst) if f.name != "key"}
    return want, cross_device_state_to_numpy(st), jhist, hist


def assert_exact(want, got):
    for f in EXACT:
        if want[f] is None:
            assert got[f] is None, f
        else:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


def assert_history(jhist, hist):
    assert [h[0] for h in hist] == [int(h[0]) for h in jhist]
    np.testing.assert_array_equal([h[1:] for h in hist],
                                  np.asarray([h[1:] for h in jhist],
                                             np.float64))


@pytest.mark.parametrize("enrolled,k", [(12, 4), (40, 8)])
@pytest.mark.parametrize("name", [n for n in WORLDS
                                  if n != "int8_ef_stochastic"])
def test_round_matches_jax(name, enrolled, k):
    want, got, jhist, hist = run_both(name, enrolled, k)
    assert_exact(want, got)
    floats = {f: v for f, v in want.items() if f not in EXACT}
    slice_helpers.assert_fields_close(
        floats, {f: got[f] for f in floats}, **FP32_TOL)
    assert_history(jhist, hist)
    assert got["epoch"].min() < got["epoch"].max()      # partial rounds


# the rounds and cohort rows where the reference's float32 norm median
# leaves the exact one in the int8 world (ROADMAP.md queue 3, item 3)
INT8_OFF_EXACT = {(12, 4): {3: [3], 5: [0]}, (40, 8): {}}


@pytest.mark.parametrize("enrolled,k", [(12, 4), (40, 8)])
def test_int8_ef_stochastic_matches_jax(enrolled, k, monkeypatch):
    """The int8 + EF21 wire with stochastic rounding (equal uniforms):
    counters, sketches and stamps exact, losses and conf within 1e-3,
    params, backup and residuals within one quantization step of the
    reference's rows. The reference's geometry norm median is swapped in
    process for the exact one, which the port computes; its own float32
    pick leaves the exact median only at the recorded half-mass ties
    (``test_torch_shard_slice.reference_off_exact``)."""
    seen = record_reference_norm_median(monkeypatch)
    want, got, _, _ = run_both("int8_ef_stochastic", enrolled, k)
    assert reference_off_exact(seen) == INT8_OFF_EXACT[enrolled, k]
    assert_exact(want, got)
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
