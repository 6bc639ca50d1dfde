"""Tensor-parallel mamba2-780m (the per-head mixer), deepseek-moe-16b
(grouped, and eplocal from the placement) and jamba (hybrid) against the
reference unsharded, live JAX in the process: the checks of
``test_torch_tp_models.py`` (logits and loss within 1e-5, gradients within
1e-4 of their max, 8 greedy decode steps within 2e-3 with equal tokens,
Adam and Adafactor on the placed state within 1e-6), and DeepSeekMoE's
eplocal on a placed tree against the port's eplocal on the whole tree.
"""
from __future__ import annotations

import pytest

from test_torch_tp_models import (MESHES, check_eplocal_placement,
                                  check_forward_loss_and_gradients,
                                  check_greedy_decode, check_optimizer_step)
from torch_threads import one_torch_thread  # noqa: F401

HERE = ("mamba2", "deepseek", "jamba")


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", HERE)
def test_forward_loss_and_gradients(case, shape):
    check_forward_loss_and_gradients(case, shape)


@pytest.mark.parametrize("shape", MESHES)
@pytest.mark.parametrize("case", HERE)
def test_greedy_decode(case, shape):
    check_greedy_decode(case, shape)


@pytest.mark.parametrize("name", ["adam", "adafactor"])
@pytest.mark.parametrize("case", HERE)
def test_optimizer_step_on_the_placed_state(case, name):
    check_optimizer_step(case, name)


@pytest.mark.parametrize("shape", MESHES)
def test_eplocal_reads_its_blocks_from_the_placement(shape):
    check_eplocal_placement(shape)
