"""The port's ``run_fedavg`` (CFL-F, CFL-S, FedAdam) against a live JAX
``run_fedavg``.

Both start from the reference's server (carried across by
``convert.fedavg_state_from_jax``) and consume the same randomness: the
port takes its draws from ``JaxFedAvgDraws``, which re-derives the
reference's per-round draws from its frozen key layout. FedAvg runs no
kernel on either side; only summation order differs.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import test_torch_slice as slice_helpers
from repro.core import fedavg as jfedavg

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import fedavg_state_from_jax, fedavg_state_to_numpy
from repro_torch.core import engine
from repro_torch.core.fedavg import evaluate_server, init_state, run_fedavg
from repro_torch.core.tasks import mlp_task
from repro_torch.rng import FedAvgRoundDraws, TorchFedAvgDraws
from repro_torch.telemetry import RunLedger


class JaxFedAvgDraws:
    """Replays the reference's FedAvg round draws: ``split(key, 4)`` ->
    (key, k_sel, k_train, k_noise) (engine.py:855), the permutations and
    noise as ``JaxDraws`` replays them, and the CFL-S cohort as
    ``jax.random.choice(k_sel, W, (sample_workers,), replace=False)``
    (engine.py:892)."""

    def __init__(self, key):
        self.key = key

    def __call__(self, w, local_epochs, n, noise_shapes, sample_workers):
        self.key, k_sel, k_train, k_noise = jax.random.split(self.key, 4)
        cohort = None
        if sample_workers:
            cohort = torch.tensor(np.asarray(jax.random.choice(
                k_sel, w, (sample_workers,), replace=False))).long()
        return FedAvgRoundDraws(
            perm=slice_helpers.replay_perm(k_train, w, local_epochs, n),
            noise=slice_helpers.replay_noise(k_noise, noise_shapes),
            cohort=cohort)


def port_configs(cfg, train):
    return (DeFTAConfig(**dataclasses.asdict(cfg)),
            TrainConfig(**dataclasses.asdict(train)))


def jax_fields(state) -> dict:
    return {"server": jax.tree.map(np.asarray, state.server),
            "opt": jax.tree.map(np.asarray, state.opt)}


VARIANTS = {
    "cfl_f": {},
    "cfl_s": {"sample_workers": 2},
    "fedadam_attacker": {"num_malicious": 1, "server_opt": "fedadam"},
}

# fp32, summation order only (the size-weighted mean, SGD's matmuls);
# FedAdam divides by sqrt(v) + 1e-3, which amplifies an ulp of the delta
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_run_fedavg_matches_jax(env, variant):
    """4 epochs on the env world (W = 4), evaluated every 2 epochs."""
    data, jtask, jcfg, jtrain = env
    kw = VARIANTS[variant]
    key = jax.random.PRNGKey(0)
    stats = {}
    jst = jfedavg.run_fedavg(key, jtask, jcfg, jtrain, data, epochs=4,
                             eval_every=2, test_x=data["test_x"],
                             test_y=data["test_y"], stats=stats, **kw)
    jinit = jfedavg.init_state(key, jtask, kw.get("server_opt", "none"))
    cfg, train = port_configs(jcfg, jtrain)
    task = mlp_task(32, 10)
    led = RunLedger()
    st, hist = run_fedavg(
        0, task, cfg, train, data, epochs=4, eval_every=2,
        test_x=data["test_x"], test_y=data["test_y"], ledger=led,
        device="cpu", init=fedavg_state_from_jax(jax_fields(jinit), "cpu"),
        draws=JaxFedAvgDraws(jinit.key), **kw)
    want, got = jax_fields(jst), fedavg_state_to_numpy(st)
    assert sorted(got["server"]) == sorted(want["server"])
    for k in want["server"]:
        np.testing.assert_allclose(got["server"][k], want["server"][k],
                                   err_msg=k, **TOL)
    if want["opt"] is None:
        assert got["opt"] is None
    else:
        for m in ("m", "v"):
            for k in want["opt"][m]:
                np.testing.assert_allclose(got["opt"][m][k],
                                           want["opt"][m][k],
                                           err_msg=f"{m}.{k}", **TOL)
    assert [e for e, _ in stats["history"]] == [2, 4]
    assert hist == stats["history"]
    assert led.as_stats() == {"dispatches": 2, "epochs": 4}
    # the same server evaluates equal on both sides
    carried = fedavg_state_from_jax(want, "cpu")
    assert evaluate_server(task, carried, data["test_x"], data["test_y"]) \
        == jfedavg.evaluate_server(jtask, jst, data["test_x"],
                                   data["test_y"])


def test_init_state_and_default_draws(env):
    """The default run draws its server and its rounds from one seeded
    generator: same seed, same run; FedAdam's moments start at zeros; the
    CFL-S cohort holds distinct workers."""
    data, _, jcfg, jtrain = env
    cfg, train = port_configs(jcfg, jtrain)
    task = mlp_task(32, 10)
    gen = torch.Generator()
    gen.manual_seed(3)
    st = init_state(gen, task, "fedadam")
    assert {k: tuple(v.shape) for k, v in st.server.items()} == {
        "w1": (32, 64), "b1": (64,), "w2": (64, 10), "b2": (10,)}
    assert all(not v.any() for m in st.opt.values() for v in m.values())
    d = TorchFedAvgDraws(gen)(6, 2, 40, None, 4)
    assert len(set(d.cohort.tolist())) == 4 and d.noise is None
    assert tuple(d.perm.shape) == (6, 2, 40)
    runs = [run_fedavg(7, task, cfg, train, data, epochs=2,
                       sample_workers=2, device="cpu")[0]
            for _ in range(2)]
    for k in runs[0].server:
        torch.testing.assert_close(runs[0].server[k], runs[1].server[k],
                                   rtol=0, atol=0)


def test_fedavg_stage_selection(env):
    """The round is the reference's six stages (split_keys is split_draws
    here), and a materialised broadcast reaches local training."""
    data, _, jcfg, jtrain = env
    cfg, train = port_configs(jcfg, jtrain)
    rnd = engine.build_fedavg_round(
        mlp_task(32, 10), cfg, train, np.full(4, 64), np.zeros(4, bool),
        draws=TorchFedAvgDraws(torch.Generator()), device="cpu")
    assert engine.stage_names(rnd) == (
        "split_draws", "star_broadcast", "local_train", "attack_inject",
        "star_aggregate", "server_update")
    gen = torch.Generator()
    gen.manual_seed(0)
    c = {"state": init_state(gen, mlp_task(32, 10))}
    dict(rnd.stages)["star_broadcast"](c)
    for k, v in c["bcast"].items():
        assert v.shape[0] == 4 and v.is_contiguous() and v.stride()[0] > 0
        torch.testing.assert_close(v[3], c["state"].server[k])
