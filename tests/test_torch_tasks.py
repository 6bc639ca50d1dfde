"""The port's batched tasks against the reference's per-worker tasks.

Parameters come from the reference's ``init`` (vmapped over W worker keys)
and are carried across by ``convert.params_from_jax``; inputs are numpy
from a seed. Loss, accuracy and the per-worker gradients (one
``backward()`` of the summed per-worker losses on the port's side,
``jax.vmap(jax.grad(task.loss))`` on the reference's) agree at atol 1e-5,
with rtol 1e-5 for gradients (summation order only).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import tasks as jtasks

from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import tasks

W, B = 3, 9


def make(kind):
    rng = np.random.default_rng({"mlp": 0, "cnn": 1, "lm": 2}[kind])
    if kind == "mlp":
        pair = jtasks.mlp_task(12, 5, hidden=16), tasks.mlp_task(12, 5, 16)
        x = rng.normal(size=(W, B, 12)).astype(np.float32)
        y = rng.integers(0, 5, (W, B)).astype(np.int32)
    elif kind == "cnn":
        pair = jtasks.cnn_task(10, 2, 4, width=3), tasks.cnn_task(10, 2, 4, 3)
        x = rng.normal(size=(W, B, 10 * 10 * 2)).astype(np.float32)
        y = rng.integers(0, 4, (W, B)).astype(np.int32)
    else:
        pair = jtasks.lm_task(11, d=8, seq=6, heads=2), \
            tasks.lm_task(11, d=8, seq=6, heads=2)
        x = rng.integers(0, 11, (W, B, 6)).astype(np.int32)
        y = np.zeros((W, B), np.int32)
    mask = (rng.random((W, B)) < 0.8).astype(np.float32)
    mask[:, 0] = 1.0
    return pair, x, y, mask


@pytest.mark.parametrize("kind", ["mlp", "cnn", "lm"])
def test_task_loss_accuracy_and_grads_match_jax(kind):
    (jtask, task), x, y, mask = make(kind)
    jparams = jax.vmap(jtask.init)(jax.random.split(jax.random.PRNGKey(0),
                                                    W))
    params = params_from_jax({k: np.asarray(v) for k, v in jparams.items()},
                             device="cpu")
    jx, jy, jm = jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)
    tx, ty, tm = torch.tensor(x), torch.tensor(y), torch.tensor(mask)

    jl, jg = jax.vmap(jax.value_and_grad(jtask.loss))(jparams, jx, jy, jm)
    ja = jax.vmap(jtask.accuracy)(jparams, jx, jy, jm)
    ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss = task.loss(ps, tx, ty, tm)
    loss.sum().backward()
    acc = task.accuracy(params, tx, ty, tm)

    assert loss.shape == (W,) and acc.shape == (W,)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jl),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(acc.numpy(), np.asarray(ja), rtol=0,
                               atol=1e-6)
    assert sorted(ps) == sorted(jg)
    for k in ps:
        np.testing.assert_allclose(ps[k].grad.numpy(), np.asarray(jg[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["mlp", "cnn", "lm"])
def test_task_init_layouts_match_jax(kind):
    """The port's own init draws the reference's names, shapes and dtypes
    (the values differ: its generator is torch's), with the same scale."""
    (jtask, task), *_ = make(kind)
    jparams = jax.vmap(jtask.init)(jax.random.split(jax.random.PRNGKey(0),
                                                    W))
    gen = torch.Generator()
    gen.manual_seed(0)
    params = params_to_numpy(task.init(gen, W))
    assert sorted(params) == sorted(jparams)
    for k, v in jparams.items():
        assert params[k].shape == v.shape and params[k].dtype == v.dtype, k
        want, got = float(np.std(np.asarray(v))), float(np.std(params[k]))
        assert abs(got - want) <= 0.35 * want + 1e-7, k


def test_batched_loss_isolates_workers():
    """Worker i's gradient depends only on worker i's slice: perturbing
    worker 0's data leaves workers 1.. unchanged."""
    (_, task), x, y, mask = make("mlp")
    gen = torch.Generator()
    gen.manual_seed(1)
    params = task.init(gen, W)

    def grads(xx):
        ps = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        task.loss(ps, torch.tensor(xx), torch.tensor(y),
                  torch.tensor(mask)).sum().backward()
        return {k: v.grad for k, v in ps.items()}
    g0 = grads(x)
    x2 = x.copy()
    x2[0] += 1.0
    g1 = grads(x2)
    for k in g0:
        assert not torch.equal(g0[k][0], g1[k][0])
        assert torch.equal(g0[k][1:], g1[k][1:])
