"""Synchronous DeFTA (Algorithm 1), simulation mode: the port of
``repro.core.defta``.

All W workers are carried as worker-stacked tensors and advanced one
round per global epoch by the engine's stage pipeline
(``engine.build_defta_round``) under the Python-loop driver
(``engine.drive_epochs``). By default malicious workers are appended after
the vanilla ones and send ``aggregate + noise`` (the paper's attack
model); a ``scenario`` (``repro_torch.scenarios``) replays a whole event
timeline instead: churn, link failures, partitions, stragglers,
time-varying topologies and any mix of the attack zoo.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.core.engine import (DeFTAState, build_defta_round,
                                     drive_epochs, init_state, sketch_shape)
from repro_torch.core.gossip import uses_error_feedback
from repro_torch.core.tasks import Task
from repro_torch.core.topology import make_topology
from repro_torch.device import resolve_device
from repro_torch.rng import TorchDraws
from repro_torch.scenarios.compile import (CompiledScenario,
                                           compile_scenario, to_device)
from repro_torch.scenarios.spec import ScenarioSpec, get_scenario
from repro_torch.sharding import worker_shards
from repro_torch.telemetry.spec import Telemetry

__all__ = ["DeFTAState", "evaluate", "global_model", "resolve_scenario",
           "run_defta"]


def evaluate(task: Task, state: DeFTAState, test_x, test_y,
             malicious: np.ndarray):
    """Mean/std test accuracy across vanilla (non-malicious) workers, and
    every worker's accuracy (numpy)."""
    dev = state.conf.device
    x = torch.as_tensor(np.asarray(test_x)).to(dev)
    y = torch.as_tensor(np.asarray(test_y)).to(dev)
    w = state.conf.shape[0]
    with torch.no_grad():
        accs = task.accuracy(state.params, x.expand(w, *x.shape),
                             y.expand(w, *y.shape),
                             torch.ones(w, x.shape[0], device=dev))
    accs = accs.cpu().numpy()[~np.asarray(malicious, bool)]
    return float(accs.mean()), float(accs.std()), accs


def _pad_workers(data, sizes, extra: int):
    """Pad stacked per-worker data/sizes with ``extra`` attacker slots
    (unused training slots — only what attackers *send* matters)."""
    sizes = np.concatenate([np.asarray(sizes),
                            np.full(extra, int(np.mean(sizes)))])
    if extra:
        pad = lambda a: np.concatenate(
            [a, np.repeat(a[-1:], extra, 0)], 0)
        data = {**data, "x": pad(data["x"]), "y": pad(data["y"]),
                "mask": pad(data["mask"])}
    return data, sizes


def attacker_world(cfg: DeFTAConfig, data, num_malicious: int,
                   scenario=None):
    """The world's W, its malicious mask (attackers appended after the
    vanilla workers: paper §4.3, normal workers fixed, attackers newly
    joined) and the data and sizes padded with their slots. With a
    compiled ``scenario`` the attackers and W are the scenario's."""
    if scenario is not None:
        w = scenario.num_workers
        malicious = scenario.malicious.copy()
    else:
        w = cfg.num_workers + num_malicious
        malicious = np.zeros(w, bool)
        malicious[cfg.num_workers:] = True
    data, sizes = _pad_workers(data, data["sizes"], w - cfg.num_workers)
    return w, malicious, data, sizes


def to_device_data(data, dev) -> dict:
    """The padded per-worker ``x``, ``y``, ``mask`` as tensors on dev."""
    return {k: torch.as_tensor(np.asarray(data[k])).to(dev)
            for k in ("x", "y", "mask")}


def resolve_scenario(scenario, cfg: DeFTAConfig, epochs: int, device):
    """Accept a ScenarioSpec (compiled here over ``epochs``), an
    already-compiled CompiledScenario or a preset name; its tensors end on
    ``device``."""
    if isinstance(scenario, str):
        scenario = get_scenario(scenario, cfg.num_workers)
    if isinstance(scenario, ScenarioSpec):
        scenario = compile_scenario(scenario, cfg.num_workers, epochs,
                                    device)
    if not isinstance(scenario, CompiledScenario):
        raise TypeError(f"scenario must be a ScenarioSpec, "
                        f"CompiledScenario or preset name, got "
                        f"{type(scenario).__name__}")
    if scenario.num_vanilla != cfg.num_workers:
        raise ValueError(f"scenario compiled for {scenario.num_vanilla} "
                         f"vanilla workers, cfg has {cfg.num_workers}")
    if scenario.epochs < epochs:
        # the per-epoch fire/attack_on schedules would freeze at the last
        # epoch's draw past the horizon: a precompiled scenario must cover
        # the run
        raise ValueError(f"scenario horizon {scenario.epochs} is shorter "
                         f"than the run ({epochs} epochs) — recompile "
                         f"with compile_scenario(spec, W, {epochs})")
    return to_device(scenario, device)


def scenario_world(scenario, num_malicious: int, cfg: DeFTAConfig, data,
                   horizon: int, device):
    """The compiled scenario (or None) and the label count a label_flip
    needs (``max(y) + 1``; 0 without a scenario)."""
    if scenario is None:
        return None, 0
    if num_malicious:
        raise ValueError("pass attackers via the scenario, not "
                         "num_malicious, when a scenario is given")
    return (resolve_scenario(scenario, cfg, horizon, device),
            int(np.max(data["y"])) + 1)


def registry(ledger, probes: bool):
    """The round's telemetry registry: a fresh one whenever a ledger is
    given (as the reference's drivers build one), unless ``probes`` is
    False (a ledger that keeps only the chunk accounting)."""
    return Telemetry() if ledger is not None and probes else None


def initial_state(gen: torch.Generator, task: Task, cfg: DeFTAConfig,
                  w: int, init: Optional[DeFTAState]) -> DeFTAState:
    """``init`` checked against the world (W, the EF21 residuals and the
    sketch ring buffer ``sketch_shape(cfg)`` asks for), or a fresh state
    drawn from ``gen``."""
    wire_error = uses_error_feedback(cfg)
    sketch = sketch_shape(cfg)
    if init is None:
        return init_state(gen, task, w, wire_error=wire_error, sketch=sketch)
    want = None if sketch is None else (w,) + tuple(sketch)
    got = None if init.sketch is None else tuple(init.sketch.shape)
    if tuple(init.conf.shape) != (w, w) or \
            (init.wire_err is not None) != wire_error or got != want:
        raise ValueError(f"init state does not fit W={w} "
                         f"(wire_error={wire_error}, sketch={want}; "
                         f"got sketch={got})")
    return init


def run_defta(seed: int, task: Task, cfg: DeFTAConfig, train: TrainConfig,
              data, *, epochs: int, num_malicious: int = 0, scenario=None,
              gossip_backend: str = "auto", eval_every: int = 0,
              test_x=None, test_y=None, ledger=None, probes: bool = True,
              shards: Optional[int] = None, shard_devices=None,
              device=None, init: Optional[DeFTAState] = None, draws=None):
    """End-to-end driver. Malicious workers are appended after the vanilla
    ones (paper §4.3: normal workers fixed, attackers newly joined).

    ``seed`` seeds the one ``torch.Generator`` (on the run's device) that
    initializes the parameters and feeds the default ``rng.TorchDraws``.
    ``init`` replaces the drawn initial state (e.g. one carried across from
    the reference by ``convert.state_from_jax``); ``draws`` replaces the
    draw provider. ``device=None`` runs on the card and raises without one;
    ``device="cpu"`` runs the kernels' plain versions. ``gossip_backend``
    defaults to ``"auto"`` (the sparse kernel on DeFTA topologies).

    ``eval_every`` with ``test_x``/``test_y`` evaluates every that many
    epochs into the returned history as ``(done, mean, std)``. ``ledger``
    (a ``telemetry.RunLedger``) receives the per-chunk round counts and wall
    seconds (the reference's ``stats`` dict is ``ledger.as_stats()``) and,
    as in the reference, the round is then built with a
    ``telemetry.Telemetry`` registry: every round's ``defta_specs`` frame
    lands in the ledger (``ledger.series(name)``; one JSONL row a round
    when it has a sink). ``probes=False`` keeps the ledger's accounting
    and builds the round without probes (a probe-free timing run).
    ``scenario`` (a ``ScenarioSpec``, a ``CompiledScenario`` or a preset
    name: ``paper_noise@K``, ``churn_signflip``, ``storm``) replaces
    ``num_malicious`` with a full event timeline: its attackers are
    appended the same way, and churn, link, partition and straggler events
    replay round by round.

    ``shards``: shard the worker axis over that many devices
    (``sharding.worker_shards``: the first ``shards`` cards, or
    ``["cpu"] * shards`` with ``device="cpu"``; ``shard_devices``, e.g.
    ``["cuda:0"] * 4``, names them instead and then runs on its first).
    Per-shard blocks carry their own params, confidence, EF21 residual and
    sketch rows, and the transport becomes the local-block CSR +
    cross-shard ring mix; W need not divide ``shards`` (the state then
    stays whole, warned once, and only the transport pads). The draws,
    the result and the ledger rows are those of an unsharded run.

    Returns ``(state, adj, malicious, history)``.
    """
    dev = resolve_device(device)
    shard = worker_shards(shards, dev, shard_devices)
    if shard is not None:
        dev = shard.devices[0]
    scenario, num_classes = scenario_world(scenario, num_malicious, cfg,
                                           data, epochs, dev)
    w, malicious, data, sizes = attacker_world(cfg, data, num_malicious,
                                               scenario)
    adj = make_topology(cfg.topology, w, cfg.avg_peers, cfg.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = initial_state(gen, task, cfg, w, init)
    rnd_fn = build_defta_round(task, cfg, train, adj, sizes, malicious,
                               draws=draws or TorchDraws(gen), device=dev,
                               gossip_backend=gossip_backend,
                               scenario=scenario, num_classes=num_classes,
                               telemetry=registry(ledger, probes),
                               shard=shard)
    tdata = to_device_data(data, dev)

    eval_fn = None
    if test_x is not None:
        def eval_fn(st, done):
            m, s, _ = evaluate(task, st, test_x, test_y, malicious)
            return (done, m, s)
    state, history = drive_epochs(rnd_fn, state, tdata, epochs,
                                  eval_every=eval_every, eval_fn=eval_fn,
                                  ledger=ledger, shard=shard, shard_rows=w)
    return state, adj, malicious, history


def global_model(state: DeFTAState, sizes, sample: int = 0,
                 generator: Optional[torch.Generator] = None):
    """Paper §5.3: the stable global model of a decentralized cluster —
    average (a sample of) the workers' models with dataset-size weights
    Σ_k (n_k / Σn) w_k. ``sample`` workers are drawn without replacement
    from ``generator`` when both are given."""
    dev = state.conf.device
    sizes = torch.as_tensor(np.asarray(sizes, np.float32)).to(dev)
    w = sizes.shape[0]
    mask = torch.ones(w, device=dev)
    if sample and generator is not None:
        idx = torch.randperm(w, generator=generator,
                             device=generator.device)[:min(sample, w)]
        mask = torch.zeros(w, device=dev)
        mask[idx.to(dev)] = 1.0
    weights = mask * sizes
    weights = weights / weights.sum()
    return {k: torch.einsum("i,i...->...", weights.to(x.dtype), x)
            for k, x in state.params.items()}
