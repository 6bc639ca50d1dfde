"""Cross-device runner (port of ``repro.core.cross_device``): drive the
participation round end to end.

``run_cross_device`` is the cross-device counterpart of ``run_defta``: it
builds the population state (every buffer sized to the enrolled N), the
gather -> dense k-block -> scatter round
(``engine.build_cross_device_round``) and hands it to the same
``drive_epochs`` driver.

Evaluation at population scale cannot afford to test 10,000 models at
every eval point, so it probes a fixed random subset of HONEST users
(``probe``): the mean and std test accuracy over the probe is the headline
statistic (with non-iid shards and uniform participation, an unbiased
estimate of the honest-population mean).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.core.defta import check_world, registry, to_device_data
from repro_torch.core.engine import (CrossDeviceState,
                                     build_cross_device_round, drive_epochs,
                                     init_cross_device_state, sketch_shape)
from repro_torch.core.gossip import uses_error_feedback
from repro_torch.core.tasks import Task
from repro_torch.device import resolve_device
from repro_torch.rng import TorchDraws
from repro_torch.scenarios.cross_device import (CompiledWorld,
                                                CrossDeviceSpec,
                                                compile_world)

__all__ = ["CrossDeviceState", "evaluate_probe", "probe_indices",
           "resolve_world", "run_cross_device"]


def resolve_world(world, epochs: int) -> CompiledWorld:
    """Accept a CrossDeviceSpec (compiled here over ``epochs``) or an
    already-compiled CompiledWorld (rejected if shorter than the run —
    the per-round schedules would index out of range)."""
    if isinstance(world, CrossDeviceSpec):
        world = compile_world(world, epochs)
    if not isinstance(world, CompiledWorld):
        raise TypeError(f"world must be a CrossDeviceSpec or "
                        f"CompiledWorld, got {type(world).__name__}")
    if world.epochs < epochs:
        raise ValueError(f"world compiled for {world.epochs} rounds, "
                         f"run wants {epochs}")
    return world


def probe_indices(world: CompiledWorld, probe: int,
                  seed: int = 0) -> np.ndarray:
    """A fixed random subset of HONEST users to evaluate."""
    honest = np.flatnonzero(~world.malicious)
    if honest.size == 0:
        raise ValueError("no honest users to probe")
    rng = np.random.default_rng(seed + 0x9E3779B9)
    take = min(probe, honest.size)
    return np.sort(rng.permutation(honest)[:take]).astype(np.int32)


def evaluate_probe(task: Task, state: CrossDeviceState, test_x, test_y,
                   probe_ix):
    """Mean and std test accuracy over the probe users' models: one
    batched ``task.accuracy`` over their stacked parameters."""
    dev = state.conf.device
    ix = torch.as_tensor(np.asarray(probe_ix, np.int64)).to(dev)
    params = {k: v.index_select(0, ix) for k, v in state.params.items()}
    x = torch.as_tensor(np.asarray(test_x)).to(dev)
    y = torch.as_tensor(np.asarray(test_y)).to(dev)
    p = ix.shape[0]
    with torch.no_grad():
        accs = task.accuracy(params, x.expand(p, *x.shape),
                             y.expand(p, *y.shape),
                             torch.ones(p, x.shape[0], device=dev))
    accs = accs.cpu().numpy()
    return float(accs.mean()), float(accs.std())


def initial_population(gen: torch.Generator, task: Task, cfg: DeFTAConfig,
                       enrolled: int,
                       init: Optional[CrossDeviceState]) -> CrossDeviceState:
    """``init`` checked against the world (N, the EF21 residuals and the
    sketch ring buffer and stamps ``sketch_shape(cfg)`` asks for), or a
    fresh population drawn from ``gen``."""
    wire_error = uses_error_feedback(cfg)
    sketch = sketch_shape(cfg)
    if init is None:
        return init_cross_device_state(gen, task, enrolled,
                                       wire_error=wire_error, sketch=sketch)
    want = None if sketch is None else (enrolled,) + tuple(sketch)
    got = None if init.sketch is None else tuple(init.sketch.shape)
    stamps = None if init.sketch_round is None \
        else tuple(init.sketch_round.shape)
    if tuple(init.conf.shape) != (enrolled, enrolled) or \
            (init.wire_err is not None) != wire_error or got != want or \
            stamps != (None if want is None else want[:2]):
        raise ValueError(f"init state does not fit N={enrolled} "
                         f"(wire_error={wire_error}, sketch={want}; got "
                         f"sketch={got}, stamps={stamps})")
    return init


def run_cross_device(seed: int, task: Task, cfg: DeFTAConfig,
                     train: TrainConfig, data, *, world, epochs: int,
                     gossip_backend: str = "auto", eval_every: int = 0,
                     test_x=None, test_y=None, probe: int = 32,
                     ledger=None, probes: bool = True,
                     shards: Optional[int] = None, device=None,
                     init: Optional[CrossDeviceState] = None, draws=None):
    """Train a cross-device world for ``epochs`` global rounds.

    ``data``: the federated dataset dict sharded over the ENROLLED
    population (``data["x"]`` is [N, n, ...]). ``world``: a
    ``CrossDeviceSpec`` or a precompiled ``CompiledWorld``. ``seed`` seeds
    the one ``torch.Generator`` (on the run's device) that draws the
    parameters and feeds the default ``rng.TorchDraws``; ``init`` replaces
    the drawn population (e.g. one carried across from the reference by
    ``convert.cross_device_state_from_jax``; the run consumes it) and
    ``draws`` the draw provider. ``device=None`` runs on the card and
    raises without one; ``device="cpu"`` runs the kernels' plain
    versions. ``gossip_backend="auto"`` runs the dense mix on the cohort
    block. ``ledger`` (a ``telemetry.RunLedger``) receives the per-chunk
    round counts and wall seconds and, as in the reference, every round's
    ``cross_device_specs`` frame (the round is built with a
    ``telemetry.Telemetry`` registry); ``probes=False`` keeps the
    accounting without the probes. ``shards`` is a later item of the port
    and raises ``NotImplementedError``.

    Returns ``(state, history)`` with history entries ``(done_rounds,
    probe_acc_mean, probe_acc_std)`` every ``eval_every`` rounds when
    ``test_x`` and ``test_y`` are given.
    """
    dev = resolve_device(device)
    check_world(shards)
    world = resolve_world(world, epochs)
    if data["x"].shape[0] != world.enrolled:
        raise ValueError(f"data sharded over {data['x'].shape[0]} users, "
                         f"world enrolled {world.enrolled}")
    num_classes = int(np.max(data["y"])) + 1
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = initial_population(gen, task, cfg, world.enrolled, init)
    rnd = build_cross_device_round(task, cfg, train, world, data["sizes"],
                                   draws=draws or TorchDraws(gen),
                                   device=dev, gossip_backend=gossip_backend,
                                   num_classes=num_classes,
                                   telemetry=registry(ledger, probes))
    tdata = to_device_data(data, dev)

    eval_fn = None
    if eval_every and test_x is not None:
        pix = probe_indices(world, probe, seed=cfg.seed)

        def eval_fn(st, done):
            m, s = evaluate_probe(task, st, test_x, test_y, pix)
            return (done, m, s)

    return drive_epochs(rnd, state, tdata, epochs, eval_every=eval_every,
                        eval_fn=eval_fn, ledger=ledger)
