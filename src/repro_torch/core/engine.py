"""The sync DeFTA round program (port of ``repro.core.engine``, static
form).

A round is an ordered tuple of named stages over a round context, as in
the reference:

    split_draws -> scenario_view -> peer_sample -> transport
        -> damage_check -> local_train -> attack_inject -> trust_update
        -> finalize

``split_draws`` takes the round's random numbers from a ``rng.Draws``
provider where the reference splits its PRNG key; ``scenario_view`` is the
static topology. The transport is the in-process ``gossip.mix_pytree``
(einsum / pallas / sparse / auto backends, fp32, bf16 or int8 + EF21
wire). ``drive_epochs`` runs rounds in a Python loop with eval chunks and
per-chunk wall time.

What the slice does not carry raises ``NotImplementedError`` when the
round is built (``check_supported``): scenarios, trust signals other than
"loss", robust aggregation, DP, secure aggregation, ``max_staleness``,
stochastic int8 rounding, telemetry and sharded workers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.core import dts as dts_mod
from repro_torch.core.gossip import (mix_pytree, normalize_wire,
                                     uses_error_feedback)
from repro_torch.core.tasks import Task
from repro_torch.scenarios.attacks import noise, tree_select
from repro_torch.telemetry.ledger import RunLedger

ROBUST_RULES = ("trimmed_mean", "median", "krum")


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1, {item})")


def check_supported(cfg: DeFTAConfig, *, scenario=None, telemetry=None,
                    shard=None) -> None:
    """Raise ``NotImplementedError`` for any part of the config this slice
    does not carry, naming the ROADMAP item that ports it. A config is
    never silently ignored."""
    if scenario is not None:
        _not_ported("scenario", "item 8: scenarios")
    if cfg.use_dts and cfg.dts_signal != "loss":
        _not_ported(f"dts_signal={cfg.dts_signal!r}",
                    "item 9: DTS v2 and v3 channels")
    if cfg.aggregation in ROBUST_RULES:
        _not_ported(f"aggregation={cfg.aggregation!r}", "item 8: scenarios")
    if cfg.aggregation not in ("defta", "defl", "uniform"):
        raise ValueError(f"unknown aggregation {cfg.aggregation!r}")
    if cfg.dp_clip > 0:
        _not_ported("DP-SGD (dp_clip > 0)", "item 11: privacy wire")
    if cfg.dp_sigma > 0:
        _not_ported("update DP (dp_sigma > 0)", "item 11: privacy wire")
    if cfg.secagg is not None:
        _not_ported("secagg", "item 11: privacy wire")
    if cfg.max_staleness:
        _not_ported("max_staleness", "item 8: scenarios")
    if normalize_wire(cfg.gossip_dtype) == "int8" \
            and cfg.gossip_wire_round == "stochastic":
        _not_ported("gossip_wire_round='stochastic'", "item 8: scenarios")
    if telemetry is not None:
        _not_ported("telemetry", "item 12: telemetry")
    if shard is not None:
        _not_ported("sharded workers", "item 13: multi-device transports")


# ---------------------------------------------------------------------------
# Shared state + local-training stage
# ---------------------------------------------------------------------------

@dataclass
class DeFTAState:
    params: dict                 # stacked [W, ...]
    backup: dict                 # stacked [W, ...]
    conf: torch.Tensor           # [W, W]
    best_loss: torch.Tensor      # [W]
    last_loss: torch.Tensor      # [W]
    epoch: torch.Tensor          # [W] int32 per-worker epoch counters
    wire_err: Optional[dict] = None   # EF21 residuals (stacked like params;
                                      # None when the wire is lossless or
                                      # error feedback is off)


def init_state(generator: torch.Generator, task: Task, num_workers: int, *,
               wire_error: bool = False) -> DeFTAState:
    """Fresh state on the generator's device, parameters drawn from it."""
    dev = generator.device
    params = task.init(generator, num_workers)
    return DeFTAState(
        params=params,
        backup={k: v.clone() for k, v in params.items()},
        conf=torch.zeros(num_workers, num_workers, device=dev),
        best_loss=torch.full((num_workers,), float("inf"), device=dev),
        last_loss=torch.zeros(num_workers, device=dev),
        epoch=torch.zeros(num_workers, dtype=torch.int32, device=dev),
        wire_err={k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in params.items()} if wire_error else None,
    )


def local_train_fn(task: Task, train: TrainConfig, local_epochs: int):
    """Returns f(perm, params, x, y, mask) -> (params, mean_loss [W])
    running ``local_epochs`` epochs of minibatch SGD on every worker at
    once. ``perm`` [W, local_epochs, n] orders each worker's n (padded)
    samples per epoch; an epoch takes ``max(n // batch_size, 1)`` steps.
    (The reference's DP-SGD variant is a later item, guarded by
    ``check_supported``.)"""
    bs, lr = train.batch_size, train.learning_rate

    def run(perm, params, x, y, mask):
        w, n = x.shape[:2]
        steps = max(n // bs, 1)
        rows = torch.arange(w, device=x.device)[:, None]
        epoch_losses = []
        with torch.enable_grad():
            for e in range(local_epochs):
                order = perm[:, e, :steps * bs].reshape(w, steps, -1)
                step_losses = []
                for s in range(steps):
                    b = order[:, s]
                    ps = {k: v.detach().requires_grad_(True)
                          for k, v in params.items()}
                    loss = task.loss(ps, x[rows, b], y[rows, b],
                                     mask[rows, b])
                    grads = torch.autograd.grad(loss.sum(),
                                                list(ps.values()))
                    params = {k: (p - lr * g).detach()
                              for (k, p), g in zip(ps.items(), grads)}
                    step_losses.append(loss.detach())
                epoch_losses.append(torch.stack(step_losses).mean(0))
        return params, torch.stack(epoch_losses).mean(0)

    return run


# ---------------------------------------------------------------------------
# Transport: the in-process mixing stage
# ---------------------------------------------------------------------------

@dataclass
class Transport:
    """How a round's mixing moves bytes. ``mix(P, stacked, residual=None)``
    follows ``gossip.mix_pytree``: the mixed dict, or ``(mixed,
    new_residual)`` when an EF21 residual dict is passed."""
    kind: str                    # "in_process"
    wire: Optional[str]          # None | "bf16" | "int8"
    use_ef: bool
    mix: Callable


def make_transport(cfg: DeFTAConfig, *, backend: str = "auto",
                   adjacency=None) -> Transport:
    """The in-process transport over the ``mix_pytree`` backends. The
    cross-pod ring and the sharded transport are later items."""
    wire = normalize_wire(cfg.gossip_dtype)
    use_ef = uses_error_feedback(cfg)

    def mix(P, stacked, residual=None):
        return mix_pytree(P, stacked, backend=backend, adjacency=adjacency,
                          wire=wire, residual=residual)
    return Transport(kind="in_process", wire=wire, use_ef=use_ef, mix=mix)


# ---------------------------------------------------------------------------
# The round program
# ---------------------------------------------------------------------------

def run_pipeline(stages, ctx: dict) -> dict:
    """Execute the ordered (name, fn) stages over the context, each under
    a profiler label of its name."""
    for name, fn in stages:
        with torch.profiler.record_function(name):
            fn(ctx)
    return ctx


def stage_names(round_fn):
    return tuple(n for n, _ in getattr(round_fn, "stages", ()))


def build_defta_round(task: Task, cfg: DeFTAConfig, train: TrainConfig,
                      adj: np.ndarray, sizes: np.ndarray,
                      malicious: np.ndarray, *, draws,
                      device, gossip_backend: str = "auto",
                      noise_scale: float = 200.0, scenario=None,
                      telemetry=None, shard=None):
    """The static DeFTA round: returns round(state, data, epoch=None) ->
    state. ``draws`` is the round's ``rng.Draws`` provider (one call per
    round); ``data`` holds the padded per-worker ``x``, ``y``, ``mask``
    tensors on ``device``."""
    check_supported(cfg, scenario=scenario, telemetry=telemetry, shard=shard)
    dev = torch.device(device)
    w = adj.shape[0]
    adj_t = torch.as_tensor(np.asarray(adj, bool)).to(dev)
    eye = torch.eye(w, dtype=torch.bool, device=dev)
    sizes_t = torch.as_tensor(np.asarray(sizes, np.float32)).to(dev)
    adj_self = np.asarray(adj, bool) | np.eye(w, dtype=bool)
    outdeg = torch.as_tensor(adj_self.sum(axis=0).astype(np.float32)).to(dev)
    malicious_np = np.asarray(malicious, bool)
    malicious_t = torch.as_tensor(malicious_np).to(dev)
    attack_scale = torch.full((w,), noise_scale, dtype=torch.float32,
                              device=dev)
    ltrain = local_train_fn(task, train, cfg.local_epochs)
    if cfg.aggregation == "defta":
        col_w = sizes_t / outdeg
    elif cfg.aggregation == "defl":
        col_w = sizes_t
    else:                                          # uniform gossip
        col_w = torch.ones_like(sizes_t)
    transport = make_transport(cfg, backend=gossip_backend, adjacency=adj)
    use_ef = transport.use_ef

    # ---- stages -----------------------------------------------------------

    def stage_split_draws(c):
        """writes draws: this round's Gumbel rows, minibatch permutations
        and (with attackers) the attack noise, in one provider call."""
        params = c["state"].params
        shapes = {k: tuple(v.shape) for k, v in params.items()} \
            if malicious_np.any() else None
        c["draws"] = draws(w, cfg.local_epochs, c["data"]["x"].shape[1],
                           shapes)

    def stage_scenario_view(c):
        """writes eff_adj: the static topology."""
        c["eff_adj"] = adj_t

    def stage_peer_sample(c):
        """reads eff_adj, state.conf, draws.gumbel; writes theta [W, W]
        (DTS sampling weights) and sampled [W, W] (Gumbel top-k, ≤
        num_sampled per row)."""
        if cfg.use_dts:
            theta = dts_mod.sample_weights(c["state"].conf, c["eff_adj"],
                                           cfg.crelu_slope)
        else:
            a = c["eff_adj"].float()
            theta = a / a.sum(1, keepdim=True).clamp_min(1)
        c["theta"] = theta
        c["sampled"] = dts_mod.sample_peers(c["draws"].gumbel, theta,
                                            cfg.num_sampled)

    def stage_transport(c):
        """reads sampled, eff_adj, state.params, state.wire_err; writes P
        (mixing matrix), agg (the mixed models) and wire_err."""
        state = c["state"]
        mask = (c["sampled"] & c["eff_adj"]) | eye
        P = mask * col_w[None, :]
        P = P / P.sum(dim=1, keepdim=True)
        c["P"] = P
        if use_ef:
            if state.wire_err is None:
                raise ValueError(
                    "cfg enables gossip error feedback on a lossy wire "
                    "but the state carries no residual buffers — build "
                    "it with init_state(..., wire_error=True)")
            c["agg"], c["wire_err"] = transport.mix(
                P, state.params, residual=state.wire_err)
        else:
            c["agg"] = transport.mix(P, state.params)
            c["wire_err"] = state.wire_err

    def stage_damage_check(c):
        """reads agg, state.{backup,best_loss}, data; writes loss_agg (each
        worker's self-evaluation of the aggregate), damaged [W] and start
        (the backup on damaged rounds: the §3.3 time machine)."""
        state, data = c["state"], c["data"]
        c["loss_agg"] = task.loss(c["agg"], data["x"], data["y"],
                                  data["mask"]).detach()
        if cfg.time_machine:
            c["damaged"] = dts_mod.is_damaged(c["loss_agg"],
                                              state.best_loss)
            c["start"] = tree_select(c["damaged"], state.backup, c["agg"])
        else:
            c["damaged"] = torch.zeros_like(c["loss_agg"], dtype=torch.bool)
            c["start"] = c["agg"]

    def stage_local_train(c):
        """reads start, data, draws.perm; writes trained and train_loss."""
        data = c["data"]
        c["trained"], c["train_loss"] = ltrain(
            c["draws"].perm, c["start"], data["x"], data["y"], data["mask"])

    def stage_attack_inject(c):
        """reads trained, agg, draws.noise; writes trained (attacker slots
        replaced by agg + noise_scale·N(0, 1), the paper's attack)."""
        if malicious_np.any():
            poisoned = noise(c["draws"].noise, c["agg"], c["trained"],
                             attack_scale)
            c["trained"] = tree_select(malicious_t, poisoned, c["trained"])

    def stage_trust_update(c):
        """reads loss_agg, damaged, sampled, P, state.{conf, backup,
        best_loss, last_loss}; writes conf (c ← c − m ∘ p · loss_trust),
        backup (the ratcheting time machine), best_loss, last_loss."""
        state = c["state"]
        loss_trust = torch.where(c["damaged"],
                                 torch.full_like(c["loss_agg"],
                                                 dts_mod.DAMAGE_PENALTY),
                                 c["loss_agg"] - state.last_loss)
        c["conf"] = state.conf - c["sampled"] * c["P"] \
            * loss_trust[:, None]
        improved = (c["loss_agg"] < state.best_loss) & ~c["damaged"]
        # the time machine RATCHETS: a damaged round trained from the
        # backup, so its result is clean by induction and becomes the new
        # backup (a worker whose peers are all attackers keeps learning)
        c["backup"] = tree_select(improved | c["damaged"], c["trained"],
                                  state.backup)
        c["best_loss"] = torch.where(improved, c["loss_agg"],
                                     state.best_loss)
        c["last_loss"] = torch.where(c["damaged"], state.last_loss,
                                     c["loss_agg"])

    def stage_finalize(c):
        """writes next: every worker advanced one epoch."""
        state = c["state"]
        c["next"] = DeFTAState(
            params=c["trained"], backup=c["backup"], conf=c["conf"],
            best_loss=c["best_loss"], last_loss=c["last_loss"],
            epoch=state.epoch + 1, wire_err=c["wire_err"])

    stages = (
        ("split_draws", stage_split_draws),
        ("scenario_view", stage_scenario_view),
        ("peer_sample", stage_peer_sample),
        ("transport", stage_transport),
        ("damage_check", stage_damage_check),
        ("local_train", stage_local_train),
        ("attack_inject", stage_attack_inject),
        ("trust_update", stage_trust_update),
        ("finalize", stage_finalize),
    )

    def round(state: DeFTAState, data, epoch=None):
        c = {"state": state, "data": data, "epoch": epoch}
        run_pipeline(stages, c)
        return c["next"]

    round.stages = stages
    return round


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

def drive_epochs(rnd_fn, state, data, epochs: int, *, eval_every: int = 0,
                 eval_fn=None, ledger: Optional[RunLedger] = None):
    """Run ``epochs`` rounds in a Python loop, in chunks bounded by eval
    points. Each chunk ends in a device synchronize and is recorded in
    the ``RunLedger`` with its wall-clock seconds (``ledger.superstep_s``;
    ``ledger.as_stats()`` gives ``{"dispatches": chunks, "epochs": e}``).
    ``eval_fn(state, done_epochs)`` runs at eval boundaries; its results
    form the returned history. Returns ``(state, history)``."""
    led = ledger if ledger is not None else RunLedger()
    history = []
    chunk = eval_every if (eval_every and eval_fn is not None) else epochs
    done = 0
    while done < epochs:
        n = min(chunk, epochs - done)
        t0 = time.perf_counter()
        for e in range(done, done + n):
            state = rnd_fn(state, data, e)
        if state.conf.is_cuda:
            torch.cuda.synchronize(state.conf.device)
        led.record_dispatch(n, time.perf_counter() - t0)
        done += n
        if eval_every and done % eval_every == 0 and eval_fn is not None:
            history.append(eval_fn(state, done))
    led.finish("epochs", epochs)
    return state, history
