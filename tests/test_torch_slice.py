"""The port's whole sync ``run_defta`` against a live JAX ``run_defta``.

The initial state is carried across (``convert.state_from_jax``) and the
port takes its random numbers from ``JaxDraws``, which re-derives the
reference's draws from its frozen key layout, so both sides consume the
same randomness. Three worlds: the golden world on the dense kernel
(``backend="pallas"``), a W=12+1 world whose density 3/13 makes ``auto``
pick the sparse kernel, and that world on the int8 + EF21 wire (the quant
kernel). JAX's kernels run in Pallas interpret mode, as the JAX package's
own tests run them; the port runs its kernels' plain versions on the CPU.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from capture_engine_goldens import setup as golden_setup
from repro.config import DeFTAConfig as JDeFTAConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import engine as jengine
from repro.core.defta import run_defta as jrun_defta
from repro.core.gossip import uses_error_feedback as juses_ef
from repro.core.tasks import mlp_task as jmlp_task
from repro.data.synthetic import federated_dataset as jfederated_dataset

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.convert import state_from_jax, state_to_numpy
from repro_torch.core.defta import run_defta
from repro_torch.core.tasks import mlp_task
from repro_torch.rng import RoundDraws


def replay_perm(k_train, w, local_epochs, n):
    """The reference's minibatch permutations [W, local_epochs, n]:
    ``split(k_train, W)`` -> ``split(., local_epochs)`` ->
    ``split(ekey)[0]``."""
    def perms(k):
        ekeys = jax.random.split(k, local_epochs)
        return jax.vmap(lambda ek: jax.random.permutation(
            jax.random.split(ek)[0], n))(ekeys)
    perm = jax.vmap(perms)(jax.random.split(k_train, w))
    return torch.tensor(np.asarray(perm)).long()


def replay_noise(k_noise, noise_shapes):
    """The reference's noise attack draws: ``split(k_noise, n_leaves)`` in
    sorted leaf order, one N(0, 1) per leaf; None without attackers."""
    if noise_shapes is None:
        return None
    names = sorted(noise_shapes)
    keys = jax.random.split(k_noise, len(names))
    return {nm: torch.tensor(np.asarray(jax.random.normal(
        k, noise_shapes[nm], jnp.float32))) for nm, k in zip(names, keys)}


class JaxDraws:
    """Replays the reference's per-round draws: ``split_round_keys``
    (key, k_sample, k_train, k_noise), ``split(k_sample, W)`` for the
    Gumbel rows, then ``replay_perm`` and ``replay_noise``."""

    def __init__(self, key):
        self.key = key
        self.calls = 0

    def __call__(self, w, local_epochs, n, noise_shapes):
        self.calls += 1
        ks = jengine.split_round_keys(self.key, False, False)
        self.key = ks["key"]
        gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (w,)))(
            jax.random.split(ks["k_sample"], w))
        return RoundDraws(gumbel=torch.tensor(np.asarray(gumbel)),
                          perm=replay_perm(ks["k_train"], w, local_epochs,
                                           n),
                          noise=replay_noise(ks["k_noise"], noise_shapes))


def run_both(data, cfg_kw, train_kw, *, epochs, num_malicious, backend):
    """Run the reference and the port from the same initial state and the
    same draws; return both final states as numpy field dicts."""
    key = jax.random.PRNGKey(0)
    jcfg = JDeFTAConfig(**cfg_kw)
    jstate, _, _, _ = jrun_defta(key, jmlp_task(32, 10), jcfg,
                                 JTrainConfig(**train_kw), data,
                                 epochs=epochs, num_malicious=num_malicious,
                                 gossip_backend=backend)
    w = jcfg.num_workers + num_malicious
    init = jengine.init_state(key, jmlp_task(32, 10), w,
                              wire_error=juses_ef(jcfg))
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init) if f.name != "key"}
    state, _, _, _ = run_defta(
        0, mlp_task(32, 10), DeFTAConfig(**cfg_kw), TrainConfig(**train_kw),
        data, epochs=epochs, num_malicious=num_malicious,
        gossip_backend=backend, device="cpu",
        init=state_from_jax(fields, device="cpu"), draws=JaxDraws(init.key))
    want = {f.name: jax.tree.map(np.asarray, getattr(jstate, f.name))
            for f in dataclasses.fields(jstate)
            if f.name != "key"}
    return want, state_to_numpy(state)


def assert_fields_close(want, got, rtol, atol):
    for field in want:
        if want[field] is None or got[field] is None:
            # a field one side carries and the other does not (the sketch
            # ring buffer, the EF21 residuals) is a mismatch
            assert want[field] is None and got[field] is None, field
            continue
        if isinstance(want[field], dict):
            assert sorted(want[field]) == sorted(got[field]), field
            for leaf in want[field]:
                np.testing.assert_allclose(
                    got[field][leaf], want[field][leaf], rtol=rtol,
                    atol=atol, err_msg=f"{field}.{leaf}")
        else:
            np.testing.assert_allclose(got[field], want[field], rtol=rtol,
                                       atol=atol, err_msg=field)


@pytest.fixture(scope="module")
def world12():
    """W=12 vanilla workers, avg_peers=2, + 1 attacker: density 3/13."""
    data = jfederated_dataset("vector", 12, np.random.default_rng(1),
                              n_per_worker=48, alpha=0.5)
    cfg_kw = dict(num_workers=12, avg_peers=2, num_sampled=1,
                  local_epochs=2)
    train_kw = dict(learning_rate=0.05, batch_size=32)
    return data, cfg_kw, train_kw


# fp32 worlds: only summation order differs, yet SGD carries an ulp of
# drift from round to round. Measured on the CPU against jax 0.9.0: the
# largest relative error of an entry above 1e-3 is 8.6e-5 (golden world,
# params.w1) and the largest absolute error 6.1e-5 (one ulp of the
# attacker's ~1e3-sized noise rows), so 1e-5 is loosened to 1e-4.
FP32_TOL = dict(rtol=1e-4, atol=1e-4)


def test_golden_world_dense_kernel_matches_jax():
    """W=4 + 1 attacker, 6 epochs, the dense kernel (backend="pallas")."""
    data, _, cfg, train = golden_setup()
    cfg_kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    train_kw = {f.name: getattr(train, f.name)
                for f in dataclasses.fields(train)}
    want, got = run_both(data, cfg_kw, train_kw, epochs=6, num_malicious=1,
                         backend="pallas")
    np.testing.assert_array_equal(got["epoch"], want["epoch"])
    assert_fields_close(want, got, **FP32_TOL)


def test_sparse_world_matches_jax(world12):
    """auto at density 3/13 picks the sparse kernel on both sides; fp32
    wire."""
    data, cfg_kw, train_kw = world12
    want, got = run_both(data, cfg_kw, train_kw, epochs=6, num_malicious=1,
                         backend="auto")
    np.testing.assert_array_equal(got["epoch"], want["epoch"])
    assert_fields_close(want, got, **FP32_TOL)


def test_int8_ef_world_matches_jax(world12):
    """auto + int8 + EF21: the quant kernel. Losses and conf at rtol 1e-3.
    Inputs an ulp apart can flip a round-half tie, and EF21 carries that
    step into the next round, so params and backup are held within one
    quantization step of their (worker, leaf) row, max|row| / 127 of the
    reference's final params. The residuals belong to the last round's
    send, whose row scales the final state does not keep: they are held
    within the leaf's largest row step."""
    data, cfg_kw, train_kw = world12
    cfg_kw = dict(cfg_kw, gossip_dtype="int8")
    want, got = run_both(data, cfg_kw, train_kw, epochs=6, num_malicious=1,
                         backend="auto")
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


def test_evaluate_and_global_model_match_jax():
    """``evaluate`` (vanilla mean/std accuracy) and the size-weighted
    ``global_model`` on one carried-across state."""
    from repro.core.defta import evaluate as jevaluate
    from repro.core.defta import global_model as jglobal_model

    from repro_torch.core.defta import evaluate, global_model
    data, task_j, _, _ = golden_setup()
    init = jengine.init_state(jax.random.PRNGKey(1), task_j, 5)
    fields = {f.name: jax.tree.map(np.asarray, getattr(init, f.name))
              for f in dataclasses.fields(init) if f.name != "key"}
    state = state_from_jax(fields, device="cpu")
    malicious = np.array([False] * 4 + [True])
    m, s, accs = evaluate(mlp_task(32, 10), state, data["test_x"],
                          data["test_y"], malicious)
    jm, js, jaccs = jevaluate(task_j, init, data["test_x"], data["test_y"],
                              malicious)
    np.testing.assert_allclose(accs, jaccs, rtol=0, atol=1e-6)
    np.testing.assert_allclose([m, s], [jm, js], rtol=1e-6, atol=1e-6)
    sizes = np.array([3, 1, 4, 1, 5])
    got = global_model(state, sizes)
    want = jglobal_model(init, sizes)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
    # a sampled global model averages exactly the sampled workers
    gen = torch.Generator()
    gen.manual_seed(0)
    picked = torch.randperm(5, generator=gen)[:2].numpy()
    gen.manual_seed(0)
    got = global_model(state, sizes, sample=2, generator=gen)
    wts = np.zeros(5, np.float32)
    wts[picked] = sizes[picked]
    wts /= wts.sum()
    for k, v in fields["params"].items():
        np.testing.assert_allclose(got[k].numpy(),
                                   np.einsum("i,i...->...", wts, v),
                                   rtol=1e-5, atol=1e-6)
