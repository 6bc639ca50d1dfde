"""Centralized FL baselines (port of ``repro.core.fedavg``): CFL-F (FedAvg
over all workers), CFL-S (FedAvg over a sampled cohort) and the FedAdam
server optimizer (Reddi et al.).

No defence: a single malicious worker (sending server + noise) collapses
training, as in paper Table 3. FedAvg is a stage selection over the
engine (``engine.build_fedavg_round``: star broadcast, local training,
attack, size-weighted star aggregate, server update) under the same
Python-loop driver as DeFTA (``engine.drive_epochs``). Its aggregate is a
plain product, as the reference's ``jnp.einsum`` is: FedAvg runs no
kernel.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.core.defta import (attacker_world, local_train_fn,  # noqa
                                    registry, to_device_data, tree_select)
from repro_torch.core.engine import (FedAvgState, build_fedavg_round,
                                     drive_epochs)
from repro_torch.core.tasks import Task
from repro_torch.device import resolve_device
from repro_torch.rng import TorchFedAvgDraws

__all__ = ["FedAvgState", "build_round", "build_round_fn",
           "evaluate_server", "init_state", "run_fedavg"]


def init_state(generator: torch.Generator, task: Task,
               server_opt: str = "none") -> FedAvgState:
    """One server model drawn from the generator (the task's init for one
    worker, the worker axis dropped); FedAdam's moments start at zeros."""
    server = {k: v[0] for k, v in task.init(generator, 1).items()}
    opt = None
    if server_opt == "fedadam":
        opt = {"m": {k: torch.zeros_like(v) for k, v in server.items()},
               "v": {k: torch.zeros_like(v) for k, v in server.items()}}
    return FedAvgState(server=server, opt=opt)


def build_round_fn(task: Task, cfg: DeFTAConfig, train: TrainConfig,
                   sizes: np.ndarray, malicious: np.ndarray, *, draws,
                   device, sample_workers: int = 0, server_opt: str = "none",
                   server_lr: float = 1.0, noise_scale: float = 200.0,
                   telemetry=None):
    """round(state, data, epoch=None) -> state; ``sample_workers=0`` ->
    CFL-F, >0 -> CFL-S (see ``engine.build_fedavg_round``)."""
    return build_fedavg_round(task, cfg, train, sizes, malicious,
                              draws=draws, device=device,
                              sample_workers=sample_workers,
                              server_opt=server_opt, server_lr=server_lr,
                              noise_scale=noise_scale, telemetry=telemetry)


# the reference jits the round here; torch has no jit
build_round = build_round_fn


def run_fedavg(seed: int, task: Task, cfg: DeFTAConfig, train: TrainConfig,
               data, *, epochs: int, num_malicious: int = 0,
               sample_workers: int = 0, server_opt: str = "none",
               eval_every: int = 0, test_x=None, test_y=None, ledger=None,
               probes: bool = True, device=None,
               init: Optional[FedAvgState] = None, draws=None):
    """End-to-end FedAvg driver. Attackers are appended after the
    ``cfg.num_workers`` vanilla workers, with padded data slots.

    ``seed`` seeds the one ``torch.Generator`` (on the run's device) that
    draws the server and feeds the default ``rng.TorchFedAvgDraws``;
    ``init`` replaces the drawn state (e.g. ``convert.fedavg_state_from_jax``)
    and ``draws`` the provider. ``device=None`` runs on the card and raises
    without one. ``eval_every`` with ``test_x``/``test_y`` evaluates the
    server every that many epochs. ``ledger`` (a ``telemetry.RunLedger``)
    receives the per-chunk epoch counts and wall seconds and, as in the
    reference, every round's ``fedavg_specs`` frame (the round is built
    with a ``telemetry.Telemetry`` registry); ``probes=False`` keeps the
    accounting without the probes.

    Returns ``(state, history)``, history a list of ``(epoch,
    server_acc)`` (the reference's ``stats["history"]``)."""
    dev = resolve_device(device)
    w, malicious, data, sizes = attacker_world(cfg, data, num_malicious)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = init if init is not None else init_state(gen, task, server_opt)
    if (state.opt is not None) != (server_opt == "fedadam"):
        raise ValueError(f"init state's optimizer moments do not fit "
                         f"server_opt={server_opt!r}")
    rnd_fn = build_round_fn(task, cfg, train, sizes, malicious,
                            draws=draws or TorchFedAvgDraws(gen), device=dev,
                            sample_workers=sample_workers,
                            server_opt=server_opt,
                            telemetry=registry(ledger, probes))

    eval_fn = None
    if test_x is not None:
        def eval_fn(st, done):
            return (done, evaluate_server(task, st, test_x, test_y))
    return drive_epochs(rnd_fn, state, to_device_data(data, dev), epochs,
                        eval_every=eval_every, eval_fn=eval_fn,
                        ledger=ledger)


def evaluate_server(task: Task, state: FedAvgState, test_x, test_y) -> float:
    """The server model's test accuracy."""
    params = {k: v[None] for k, v in state.server.items()}
    dev = next(iter(params.values())).device
    x = torch.as_tensor(np.asarray(test_x)).to(dev)[None]
    y = torch.as_tensor(np.asarray(test_y)).to(dev)[None]
    with torch.no_grad():
        acc = task.accuracy(params, x, y, torch.ones(1, x.shape[1],
                                                     device=dev))
    return float(acc[0])
