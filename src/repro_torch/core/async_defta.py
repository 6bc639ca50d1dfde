"""AsyncDeFTA (paper §3.4; port of ``repro.core.async_defta``): drop the
global barrier.

Asynchrony is modelled by its only algorithmically observable effect:
which epoch's peer models a worker reads. Each worker has a speed s_i in
``speed_range``; on every global tick worker i completes a round with
probability s_i. Firing workers aggregate their peers' current models
(possibly stale, possibly ahead); the others are unchanged. The round is
sync DeFTA's (``engine.build_defta_round``, so the gossip kernels run on
every tick), wrapped in the fire-gated tick merge
(``engine.build_fire_gated_tick``) and run by the tick driver
(``engine.drive_ticks``).

Paper Table 4's observation, that fast workers finish with immature peer
models, shows in the per-worker epochs at a fixed tick budget against an
extended one (AsyncDeFTA-L).

A ``scenario`` replays its timeline over the tick axis: the tick index is
the scenario epoch, so scenario stragglers compose with the speed model (a
worker advances only when it fires and the scenario lets it).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.core.defta import (attacker_world, check_world,
                                    initial_state, scenario_world,
                                    to_device_data)
from repro_torch.core.engine import (DeFTAState, build_defta_round,
                                     build_fire_gated_tick, drive_ticks)
from repro_torch.core.tasks import Task
from repro_torch.core.topology import make_topology
from repro_torch.device import resolve_device
from repro_torch.rng import TorchDraws, TorchTickDraws

__all__ = ["run_async_defta"]


def run_async_defta(seed: int, task: Task, cfg: DeFTAConfig,
                    train: TrainConfig, data, *, ticks: int,
                    num_malicious: int = 0, scenario=None,
                    speed_range=(0.3, 1.0), target_epochs: int = 0,
                    check_every: int = 0, host_exit: bool = False,
                    ledger=None, shards: Optional[int] = None, device=None,
                    gossip_backend: str = "auto",
                    init: Optional[DeFTAState] = None, draws=None,
                    tick_draws=None):
    """Run until every vanilla worker reaches ``target_epochs`` (if > 0) or
    for ``ticks`` ticks. Returns ``(state, adj, malicious, speeds)``.

    The speeds are ``np.random.default_rng(cfg.seed + 17).uniform(
    *speed_range, W)`` in float32, as the reference compares them (a
    float64 comparison would fire differently wherever a uniform lies
    between the two roundings). ``check_every`` (default ``min(8, ticks)``
    with a target, else ``ticks``) is the early exit's granularity; see
    ``engine.drive_ticks``. ``host_exit`` is accepted and changes nothing:
    the port has one exit path, and it stops where the reference's does.

    ``seed`` seeds the one ``torch.Generator`` (on the run's device) that
    initializes the parameters and feeds the default round and tick
    providers (``rng.TorchDraws``, ``rng.TorchTickDraws``); ``init``,
    ``draws`` and ``tick_draws`` replace them. ``gossip_backend`` defaults
    to ``"auto"`` (the sparse kernel on DeFTA topologies; the reference's
    default einsum computes the same mix). ``device=None`` runs on the card
    and raises without one.

    ``scenario`` (``ScenarioSpec``, ``CompiledScenario`` or preset name) is
    compiled over ``max(ticks, 1)`` ticks and replayed with the tick index
    as its epoch. With a target, only the vanilla workers whose scenario
    fire opportunities reach it are waited for (all vanilla workers if none
    can). ``shards`` is a later item of the port and raises
    ``NotImplementedError``.
    """
    del host_exit
    dev = resolve_device(device)
    check_world(shards)
    scenario, num_classes = scenario_world(scenario, num_malicious, cfg,
                                           data, max(ticks, 1), dev)
    w, malicious, data, sizes = attacker_world(cfg, data, num_malicious,
                                               scenario)
    adj = make_topology(cfg.topology, w, cfg.avg_peers, cfg.seed)
    speeds = np.random.default_rng(cfg.seed + 17).uniform(
        *speed_range, size=w).astype(np.float32)

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = initial_state(gen, task, cfg, w, init)
    rnd_fn = build_defta_round(task, cfg, train, adj, sizes, malicious,
                               draws=draws or TorchDraws(gen), device=dev,
                               gossip_backend=gossip_backend,
                               scenario=scenario, num_classes=num_classes)
    tick = build_fire_gated_tick(rnd_fn, to_device_data(data, dev),
                                 torch.as_tensor(speeds).to(dev), w,
                                 draws=tick_draws or TorchTickDraws(gen))
    if not check_every:
        check_every = min(8, ticks) if target_epochs else ticks
    # the early exit waits only on workers that can reach the target: a
    # churned-out or heavily straggled worker would otherwise hold it
    required = ~malicious
    if scenario is not None and target_epochs:
        opportunities = scenario.fire[:max(ticks, 1)].sum(0).cpu().numpy()
        required = required & (opportunities >= target_epochs)
        if not required.any():
            # unreachable for everyone: run the whole budget
            required = ~malicious
    state = drive_ticks(tick, state, ticks, check_every=max(1, check_every),
                        required=required, target_epochs=target_epochs,
                        ledger=ledger)
    return state, adj, malicious, speeds
