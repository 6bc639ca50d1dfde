"""The round programs and their drivers (port of ``repro.core.engine``).

A round is an ordered tuple of named stages over a round context, as in
the reference. Sync DeFTA:

    split_draws -> scenario_view -> peer_sample -> transport
        -> damage_check -> local_train -> attack_inject -> trust_update
        -> finalize (fire_merge under a scenario)

FedAvg (CFL-F, CFL-S, FedAdam), a stage selection over the same pipeline:

    split_draws -> star_broadcast -> local_train -> attack_inject
        -> star_aggregate -> server_update

``split_draws`` takes the round's random numbers from a ``rng`` provider
where the reference splits its PRNG key. ``scenario_view`` is the static
topology, or a compiled scenario's epoch (churn, links, partitions,
stragglers, a time-varying topology), with ``max_staleness`` dropping
stale peers. The transport is the in-process ``gossip.mix_pytree`` (einsum
/ pallas / sparse / auto backends, fp32, bf16 or int8 + EF21 wire, int8
rounded to nearest or stochastically), or a classical robust rule
(``scenarios.robust_agg``) that replaces the mix. The attack zoo
(``scenarios.attacks``) poisons what attackers send. FedAvg's star
aggregate is a plain size-weighted mean, as in the reference (no kernel).
``build_fire_gated_tick`` wraps the DeFTA round in AsyncDeFTA's tick
merge. ``drive_epochs`` runs rounds and ``drive_ticks`` runs ticks in a
Python loop, with per-chunk wall time.

The trust update carries every DTS signal: the paper's loss delta, update
geometry (v2) and the cross-round sketch correlation (v3), whose ring
buffer rides in ``DeFTAState.sketch`` and is merged by ``fire`` and by the
tick like every other per-worker row.

``check_supported`` raises the reference's ``ValueError`` for a config the
reference rejects, then ``NotImplementedError`` for what the port does not
carry yet: DP, secure aggregation, telemetry and sharded workers.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.core import dts as dts_mod
from repro_torch.core.gossip import (dynamic_mixing_matrix, mix_pytree,
                                     normalize_wire, uses_error_feedback)
from repro_torch.core.tasks import Task
from repro_torch.scenarios.attacks import (LABEL_FLIP_CODE, RANDOM_ATTACKS,
                                           flip_labels, noise, poison_sends,
                                           tree_select)
from repro_torch.scenarios.compile import epoch_view
from repro_torch.scenarios.robust_agg import ROBUST_RULES, robust_mix
from repro_torch.telemetry.ledger import RunLedger


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, queue 1a, {item})")


_DTS_CHANNELS = {"loss": (), "geom": ("geom",), "both": ("geom",),
                 "corr": ("corr",), "all": ("geom", "corr")}


def resolve_dts_signal(cfg: DeFTAConfig) -> frozenset:
    """Validate ``cfg.dts_signal`` (whether DTS is on or not) and return
    the extra trust channels the round runs: ``{"geom"}``, ``{"corr"}``,
    both for ``"all"``; empty for ``"loss"`` or with DTS off, where the
    trust update is the paper's loss-delta one."""
    if cfg.dts_signal not in _DTS_CHANNELS:
        raise ValueError(f"unknown dts_signal {cfg.dts_signal!r} "
                         f"(one of: {', '.join(_DTS_CHANNELS)})")
    if not cfg.use_dts:
        return frozenset()
    return frozenset(_DTS_CHANNELS[cfg.dts_signal])


def sketch_shape(cfg: DeFTAConfig):
    """The (R, S) sketch ring-buffer dims the state needs under this
    config, or None when the correlation channel is off: pass it to
    ``init_state(..., sketch=sketch_shape(cfg))``."""
    if "corr" in resolve_dts_signal(cfg):
        return (cfg.dts_sketch_rounds, cfg.dts_sketch_dim)
    return None


def check_supported(cfg: DeFTAConfig, *, telemetry=None,
                    shard=None) -> None:
    """Raise the reference's ``ValueError`` for a config it rejects (an
    unknown trust signal, secure-aggregation scheme or mode, secure
    aggregation under a robust rule), then ``NotImplementedError`` for any
    part the port does not carry yet, naming the ROADMAP item that ports
    it. A config is never silently ignored. An unknown ``aggregation`` is
    a ``ValueError`` here, where the reference builds a uniform mix."""
    resolve_dts_signal(cfg)
    if cfg.aggregation not in ("defta", "defl", "uniform") + ROBUST_RULES:
        raise ValueError(f"unknown aggregation {cfg.aggregation!r}")
    if cfg.secagg not in (None, "pairwise"):
        raise ValueError(f"unknown secagg scheme {cfg.secagg!r} "
                         f"(None | 'pairwise')")
    if cfg.secagg_mode not in ("edge", "masked_geom"):
        raise ValueError(f"unknown secagg_mode {cfg.secagg_mode!r} "
                         f"('edge' | 'masked_geom')")
    if cfg.secagg is not None and cfg.aggregation in ROBUST_RULES:
        raise ValueError(
            f"secagg composes with the weighted gossip mix only — robust "
            f"rules ({cfg.aggregation!r}) inspect individual plaintext "
            f"models, which is exactly what the masked wire denies them")
    if cfg.dp_clip > 0:
        _not_ported("DP-SGD (dp_clip > 0)", "item 5: privacy wire")
    if cfg.dp_sigma > 0:
        _not_ported("update DP (dp_sigma > 0)", "item 5: privacy wire")
    if cfg.secagg is not None:
        _not_ported("secagg", "item 5: privacy wire")
    if telemetry is not None:
        _not_ported("telemetry", "item 6: telemetry")
    if shard is not None:
        _not_ported("sharded workers", "item 7: multi-device transports")


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
    sketch: Optional[torch.Tensor] = None  # [W, R, S] sign-sketch ring
                                      # buffer of the DTS v3 correlation
                                      # channel (None unless it is on)


@dataclass
class FedAvgState:
    server: dict                 # one model, no worker axis
    opt: Optional[dict] = None   # FedAdam moments {"m": ..., "v": ...}
                                 # (trees like server), or None


def init_state(generator: torch.Generator, task: Task, num_workers: int, *,
               wire_error: bool = False, sketch=None) -> DeFTAState:
    """Fresh state on the generator's device, parameters drawn from it.
    ``sketch``: the (R, S) ring-buffer dims from ``sketch_shape(cfg)`` when
    the correlation channel is on (zeros: an empty history scores no
    suspicion), else None."""
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
        sketch=torch.zeros((num_workers,) + tuple(sketch), device=dev)
        if sketch else None,
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
    """How a round's mixing moves bytes. ``mix(P, stacked, residual=None,
    wire_u=None)`` follows ``gossip.mix_pytree``: the mixed dict, or
    ``(mixed, new_residual)`` when an EF21 residual dict is passed;
    ``wire_u`` carries the stochastic wire's uniforms."""
    kind: str                    # "in_process"
    wire: Optional[str]          # None | "bf16" | "int8"
    use_ef: bool
    stochastic: bool             # int8 stochastic rounding
    mix: Callable


def make_transport(cfg: DeFTAConfig, *, backend: str = "auto",
                   adjacency=None, robust: bool = False) -> Transport:
    """The in-process transport over the ``mix_pytree`` backends.
    ``adjacency`` is the static support of every P the round builds (the
    scenario's support union under a time-varying topology). Stochastic
    int8 rounding exists on the int8 wire only (elsewhere the knob is
    inert, as in the reference). A robust rule never runs the lossy wire.
    The cross-pod ring and the sharded transport are later items."""
    wire = normalize_wire(cfg.gossip_dtype)
    use_ef = uses_error_feedback(cfg)
    stochastic = wire == "int8" and cfg.gossip_wire_round == "stochastic"
    wire_round = "stochastic" if stochastic else "nearest"
    if robust and wire is not None:
        raise ValueError(
            f"robust aggregation ({cfg.aggregation!r}) simulates lossless "
            f"model exchange — it never runs the quantized wire, so "
            f"comparing it against a lossy-wire DeFTA run would be "
            f"apples-to-oranges; set gossip_dtype='float32'")

    def mix(P, stacked, residual=None, wire_u=None):
        return mix_pytree(P, stacked, backend=backend, adjacency=adjacency,
                          wire=wire, residual=residual,
                          wire_round=wire_round, wire_u=wire_u)
    return Transport(kind="in_process", wire=wire, use_ef=use_ef,
                     stochastic=stochastic, mix=mix)


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
                      num_classes: int = 0, telemetry=None, shard=None):
    """The DeFTA round: returns round(state, data, epoch=None) -> state.
    ``draws`` is the round's ``rng.Draws`` provider (one call per round);
    ``data`` holds the padded per-worker ``x``, ``y``, ``mask`` tensors on
    ``device``.

    ``scenario``: a ``scenarios.CompiledScenario`` on ``device``. The round
    then looks up its epoch's alive/link/fire/attack state (and, for a
    time-varying topology, the segment's adjacency), poisons sends with the
    attack zoo and merges by ``fire``; ``epoch`` must be given. Without it
    the round is the static one, with the paper's noise attack on
    ``malicious`` workers. ``num_classes`` is needed by a ``label_flip``
    scenario (the flip is ``y -> C-1-y``)."""
    check_supported(cfg, telemetry=telemetry, shard=shard)
    channels = resolve_dts_signal(cfg)
    corr = "corr" in channels
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
    max_staleness = int(cfg.max_staleness)
    robust = cfg.aggregation in ROBUST_RULES
    if cfg.aggregation == "defta":
        col_w = sizes_t / outdeg
    elif cfg.aggregation == "defl":
        col_w = sizes_t
    else:                                # uniform gossip (unused by robust)
        col_w = torch.ones_like(sizes_t)

    noise_kinds = ()
    if scenario is not None:
        if scenario.num_workers != w:
            raise ValueError(f"scenario compiled for W="
                             f"{scenario.num_workers}, topology has {w}")
        if "label_flip" in scenario.kinds_present and num_classes <= 0:
            raise ValueError("label_flip scenario needs num_classes > 0")
        noise_kinds = tuple(k for k in scenario.kinds_present
                            if k in RANDOM_ATTACKS)
    # a time-varying topology: the padded-CSR support must cover every
    # segment's adjacency (the support union), one static entry
    support = adj
    if scenario is not None and scenario.adj_union is not None:
        support = scenario.adj_union
    transport = make_transport(cfg, backend=gossip_backend,
                               adjacency=support, robust=robust)
    use_ef = transport.use_ef
    regen = scenario is not None and scenario.adj_seg is not None

    # ---- stages -----------------------------------------------------------

    def stage_split_draws(c):
        """writes draws: this round's Gumbel rows, minibatch permutations,
        (static path, with attackers) the noise attack's draws, and, gated
        at build time, the scenario's per-kind attack noise and the
        stochastic wire's uniforms, in one provider call."""
        params = c["state"].params
        shapes = {k: tuple(v.shape) for k, v in params.items()}
        extra = {}
        if noise_kinds:
            extra["kind_noise"] = {k: shapes for k in noise_kinds}
        if transport.stochastic:
            extra["wire_shapes"] = {k: (w, v[0].numel())
                                    for k, v in params.items()}
        legacy = scenario is None and malicious_np.any()
        c["draws"] = draws(w, cfg.local_epochs, c["data"]["x"].shape[1],
                           shapes if legacy else None, **extra)

    def stage_scenario_view(c):
        """reads epoch, state.epoch; writes eff_adj (and alive, fire,
        att_on under a scenario): the round's topology = (segment or
        static) adjacency ∧ link_ok ∧ alive on both ends; with
        ``max_staleness`` S > 0, minus the edges from peers whose epoch
        lags the receiver's by more than S."""
        if scenario is not None:
            view = epoch_view(scenario, c["epoch"])
            alive = view["alive"]
            c["alive"], c["fire"], c["att_on"] = \
                alive, view["fire"], view["attack_on"]
            base = view["adj"] if regen else adj_t
            c["eff_adj"] = base & view["link_ok"] & alive[None, :] \
                & alive[:, None]
        else:
            c["eff_adj"] = adj_t
        if max_staleness:
            ep = c["state"].epoch
            fresh = (ep[:, None] - ep[None, :]) <= max_staleness
            c["eff_adj"] = c["eff_adj"] & fresh

    def stage_peer_sample(c):
        """reads eff_adj, state.conf, draws.gumbel; writes theta [W, W]
        (DTS sampling weights, observed by theta_aware) and sampled [W, W]
        (Gumbel top-k, ≤ num_sampled per row)."""
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
        """reads sampled, eff_adj, state.params, state.wire_err,
        draws.wire_u; writes P (mixing matrix), agg (the mixed models) and
        wire_err. A robust rule replaces the mix (no kernel launch), with P
        the uniform bookkeeping weights the trust update needs."""
        state = c["state"]
        mask = (c["sampled"] & c["eff_adj"]) | eye
        if robust:
            c["agg"] = robust_mix(cfg.aggregation, mask, state.params,
                                  trim=cfg.robust_trim)
            c["P"] = mask.float() / mask.sum(dim=1, keepdim=True)
            c["wire_err"] = state.wire_err
            return
        if scenario is not None:
            # per-epoch outdegrees under the dynamic adjacency
            P = dynamic_mixing_matrix(c["sampled"], c["eff_adj"], sizes_t,
                                      cfg.aggregation)
        else:
            P = mask * col_w[None, :]
            P = P / P.sum(dim=1, keepdim=True)
        c["P"] = P
        wire_u = c["draws"].wire_u
        if use_ef:
            if state.wire_err is None:
                raise ValueError(
                    "cfg enables gossip error feedback on a lossy wire "
                    "but the state carries no residual buffers — build "
                    "it with init_state(..., wire_error=True)")
            c["agg"], c["wire_err"] = transport.mix(
                P, state.params, residual=state.wire_err, wire_u=wire_u)
        else:
            c["agg"] = transport.mix(P, state.params, wire_u=wire_u)
            c["wire_err"] = state.wire_err

    def stage_damage_check(c):
        """reads agg, state.{backup,best_loss}, data, att_on; writes y_data
        (the labels, flipped for active label-flippers), loss_agg (each
        worker's self-evaluation of the aggregate), damaged [W] and start
        (the backup on damaged rounds: the §3.3 time machine)."""
        state, data = c["state"], c["data"]
        y_data = data["y"]
        if scenario is not None and "label_flip" in scenario.kinds_present:
            lf = (scenario.attack_kind == LABEL_FLIP_CODE) & c["att_on"]
            y_data = flip_labels(y_data, lf, num_classes)
        c["y_data"] = y_data
        c["loss_agg"] = task.loss(c["agg"], data["x"], y_data,
                                  data["mask"]).detach()
        if cfg.time_machine:
            c["damaged"] = dts_mod.is_damaged(c["loss_agg"],
                                              state.best_loss)
            c["start"] = tree_select(c["damaged"], state.backup, c["agg"])
        else:
            c["damaged"] = torch.zeros_like(c["loss_agg"], dtype=torch.bool)
            c["start"] = c["agg"]

    def stage_local_train(c):
        """reads start, y_data, data, draws.perm; writes trained and
        train_loss."""
        data = c["data"]
        c["trained"], c["train_loss"] = ltrain(
            c["draws"].perm, c["start"], data["x"], c["y_data"],
            data["mask"])

    def stage_attack_inject(c):
        """reads trained, agg, theta, att_on, draws.{noise, kind_noise};
        writes trained: attacker slots replaced by their poisoned sends
        (the scenario's zoo, or on the static path agg + noise_scale·N(0,
        1), the paper's attack)."""
        if scenario is not None:
            c["trained"] = poison_sends(
                c["draws"].kind_noise, scenario.kinds_present,
                scenario.attack_kind, scenario.attack_scale, c["att_on"],
                c["agg"], c["trained"],
                theta=c["theta"] if cfg.use_dts else None)
        elif malicious_np.any():
            poisoned = noise(c["draws"].noise, c["agg"], c["trained"],
                             attack_scale)
            c["trained"] = tree_select(malicious_t, poisoned, c["trained"])

    def stage_trust_update(c):
        """reads loss_agg, damaged, sampled, P, theta, state.{conf, backup,
        best_loss, last_loss} (+ trained, start, eff_adj, fire on the
        geometry and correlation paths, + state.sketch on "corr" / "all");
        writes conf, backup (the ratcheting time machine), best_loss,
        last_loss and sketch (rotated, this round's sign-sketch appended,
        on "corr" / "all"). The confidence update is c ← c − m ∘ p ·
        signal, the signal being the loss delta ("loss", Algorithm 3) or
        its fusion with the geometry and correlation scores of each peer's
        local-update delta ``trained − start`` (after attack injection, so
        the poison is what gets scored)."""
        state = c["state"]
        loss_trust = torch.where(c["damaged"],
                                 torch.full_like(c["loss_agg"],
                                                 dts_mod.DAMAGE_PENALTY),
                                 c["loss_agg"] - state.last_loss)
        c["sketch"] = state.sketch
        if channels:
            # non-firing peers (stragglers) are left out: the fire merge
            # drops their delta, so no peer consumes it
            deltas = dts_mod.flatten_stacked(c["trained"]) \
                - dts_mod.flatten_stacked(c["start"])
            gmask = c["eff_adj"] & c["fire"][None, :] \
                if scenario is not None else c["eff_adj"]
            if corr:
                if state.sketch is None:
                    raise ValueError(
                        f"dts_signal={cfg.dts_signal!r} needs the sketch "
                        f"ring buffer — build the state with "
                        f"init_state(..., sketch=sketch_shape(cfg))")
                c["sketch"] = dts_mod.update_sketch(state.sketch, deltas,
                                                    seed=cfg.seed)
            c["conf"] = dts_mod.geom_confidence_update(
                cfg.dts_signal, cfg.dts_geom_weight, state.conf,
                c["sampled"], c["P"], loss_trust, c["damaged"], deltas,
                gmask, c["theta"], sketch=c["sketch"],
                lam_corr=cfg.dts_corr_weight)
        else:
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
            epoch=state.epoch + 1, wire_err=c["wire_err"],
            sketch=c["sketch"])

    def stage_fire_merge(c):
        """reads fire + everything finalize reads; writes next: workers
        that do not fire (dead, or a straggler's idle epoch) keep params,
        backup, conf rows, losses, EF21 residual and sketch row (a ring
        buffer must not rotate on a round whose delta no peer consumed);
        epoch advances by fire."""
        state, fire = c["state"], c["fire"]
        c["next"] = DeFTAState(
            params=tree_select(fire, c["trained"], state.params),
            backup=tree_select(fire, c["backup"], state.backup),
            conf=torch.where(fire[:, None], c["conf"], state.conf),
            best_loss=torch.where(fire, c["best_loss"], state.best_loss),
            last_loss=torch.where(fire, c["last_loss"], state.last_loss),
            epoch=state.epoch + fire.to(state.epoch.dtype),
            wire_err=tree_select(fire, c["wire_err"], state.wire_err)
            if use_ef else state.wire_err,
            sketch=torch.where(fire[:, None, None], c["sketch"],
                               state.sketch) if corr else state.sketch)

    stages = (
        ("split_draws", stage_split_draws),
        ("scenario_view", stage_scenario_view),
        ("peer_sample", stage_peer_sample),
        ("transport", stage_transport),
        ("damage_check", stage_damage_check),
        ("local_train", stage_local_train),
        ("attack_inject", stage_attack_inject),
        ("trust_update", stage_trust_update),
        ("finalize", stage_finalize) if scenario is None
        else ("fire_merge", stage_fire_merge),
    )

    def round(state: DeFTAState, data, epoch=None):
        c = {"state": state, "data": data, "epoch": epoch}
        run_pipeline(stages, c)
        return c["next"]

    round.stages = stages
    return round


def build_fedavg_round(task: Task, cfg: DeFTAConfig, train: TrainConfig,
                       sizes: np.ndarray, malicious: np.ndarray, *, draws,
                       device, sample_workers: int = 0,
                       server_opt: str = "none", server_lr: float = 1.0,
                       noise_scale: float = 200.0):
    """FedAvg as a stage selection over the same pipeline: the transport is
    a STAR topology (server broadcast down, size-weighted mean up), there
    is no peer sampling / DTS / time machine, and the server optimizer is
    the last stage. ``sample_workers=0`` -> CFL-F; >0 -> CFL-S over that
    many workers drawn without replacement each round; ``server_opt=
    "fedadam"`` -> FedAdam (any other value: plain replacement). Of ``cfg``
    only ``local_epochs`` is read. ``draws`` is the round's
    ``rng.FedAvgDraws`` provider (one call per round).

    Returns round(state, data, epoch=None) -> ``FedAvgState``."""
    dev = torch.device(device)
    w = len(sizes)
    sizes_t = torch.as_tensor(np.asarray(sizes, np.float32)).to(dev)
    malicious_np = np.asarray(malicious, bool)
    malicious_t = torch.as_tensor(malicious_np).to(dev)
    attack_scale = torch.full((w,), noise_scale, dtype=torch.float32,
                              device=dev)
    ltrain = local_train_fn(task, train, cfg.local_epochs)

    def stage_split_draws(c):
        """writes draws: this round's permutations, (with attackers) the
        attack noise over the broadcast's shapes and (CFL-S) the cohort,
        in one provider call."""
        shapes = {k: (w,) + tuple(v.shape)
                  for k, v in c["state"].server.items()} \
            if malicious_np.any() else None
        c["draws"] = draws(w, cfg.local_epochs, c["data"]["x"].shape[1],
                           shapes, sample_workers)

    def stage_star_broadcast(c):
        """reads state.server; writes bcast [W, ...]: every worker starts
        from the server model (a materialised copy, not a stride-0 view:
        local training hands it to autograd)."""
        c["bcast"] = {k: v.expand(w, *v.shape).contiguous()
                      for k, v in c["state"].server.items()}

    def stage_local_train(c):
        """reads bcast, data, draws.perm; writes trained."""
        data = c["data"]
        c["trained"], _ = ltrain(c["draws"].perm, c["bcast"], data["x"],
                                 data["y"], data["mask"])

    def stage_attack_inject(c):
        """reads trained, bcast, draws.noise; writes trained (attacker
        slots replaced by server + noise_scale·N(0, 1): the undefended
        baseline's one attack)."""
        if malicious_np.any():
            poisoned = noise(c["draws"].noise, c["bcast"], c["trained"],
                             attack_scale)
            c["trained"] = tree_select(malicious_t, poisoned, c["trained"])

    def stage_star_aggregate(c):
        """reads trained, draws.cohort; writes new_server: the
        size-weighted mean over the cohort (all workers, or CFL-S's)."""
        if sample_workers:
            wmask = torch.zeros(w, device=dev)
            wmask[c["draws"].cohort.to(dev)] = 1.0
        else:
            wmask = torch.ones(w, device=dev)
        aw = wmask * sizes_t
        aw = aw / aw.sum()
        c["new_server"] = {
            k: torch.einsum("i,i...->...", aw.to(x.dtype), x)
            for k, x in c["trained"].items()}

    def stage_server_update(c):
        """reads new_server, state.{server, opt}; writes next: plain
        replacement, or FedAdam on the server delta."""
        state, new = c["state"], c["new_server"]
        if server_opt != "fedadam":
            c["next"] = FedAvgState(server=new, opt=state.opt)
            return
        b1, b2, eps = 0.9, 0.99, 1e-3
        delta = {k: new[k] - s for k, s in state.server.items()}
        m = {k: b1 * state.opt["m"][k] + (1 - b1) * d
             for k, d in delta.items()}
        v = {k: b2 * state.opt["v"][k] + (1 - b2) * d * d
             for k, d in delta.items()}
        c["next"] = FedAvgState(
            server={k: s + server_lr * m[k] / (v[k].sqrt() + eps)
                    for k, s in state.server.items()},
            opt={"m": m, "v": v})

    stages = (
        ("split_draws", stage_split_draws),
        ("star_broadcast", stage_star_broadcast),
        ("local_train", stage_local_train),
        ("attack_inject", stage_attack_inject),
        ("star_aggregate", stage_star_aggregate),
        ("server_update", stage_server_update),
    )

    def round(state: FedAvgState, data, epoch=None):
        c = {"state": state, "data": data, "epoch": epoch}
        run_pipeline(stages, c)
        return c["next"]

    round.stages = stages
    return round


# ---------------------------------------------------------------------------
# Async: fire-gated tick wrapper
# ---------------------------------------------------------------------------

def build_fire_gated_tick(rnd_fn, data, speeds: torch.Tensor, w: int, *,
                          draws):
    """Wrap a DeFTA round in the AsyncDeFTA tick merge: on each tick,
    worker i completes a round when its uniform (``draws(w)``, one
    ``rng.TickDraws`` call) is below ``speeds[i]`` (float32 [W] on the
    data's device). The round runs for all W workers on every tick, fired
    or not, so the round's draw stream stays aligned with the reference;
    fired workers take its params, backup, conf rows, losses, epoch, EF21
    residual and sketch row, the rest keep theirs (a worker that did not
    fire did not send, so neither its residual nor its sketch history may
    advance).

    The reference pads its last chunk with dead ticks that run and draw
    nothing; here the driver never calls a tick past the budget or after
    the early exit, so there are none.

    Returns tick(state, t) -> state."""

    def tick(state: DeFTAState, t: int) -> DeFTAState:
        fired = draws(w) < speeds
        nxt = rnd_fn(state, data, t)
        return DeFTAState(
            params=tree_select(fired, nxt.params, state.params),
            backup=tree_select(fired, nxt.backup, state.backup),
            conf=torch.where(fired[:, None], nxt.conf, state.conf),
            best_loss=torch.where(fired, nxt.best_loss, state.best_loss),
            last_loss=torch.where(fired, nxt.last_loss, state.last_loss),
            epoch=torch.where(fired, nxt.epoch, state.epoch),
            wire_err=None if state.wire_err is None else
            tree_select(fired, nxt.wire_err, state.wire_err),
            sketch=None if state.sketch is None else
            torch.where(fired[:, None, None], nxt.sketch, state.sketch))

    return tick


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def _synchronize(state) -> None:
    """Wait for the card that holds the state's tensors (a no-op on the
    CPU). Serves every state: the first field that holds a tensor, or a
    dict of them, names the device."""
    for v in vars(state).values():
        t = next(iter(v.values()), None) if isinstance(v, dict) else v
        if isinstance(t, torch.Tensor):
            if t.is_cuda:
                torch.cuda.synchronize(t.device)
            return


def drive_epochs(rnd_fn, state, data, epochs: int, *, eval_every: int = 0,
                 eval_fn=None, ledger: Optional[RunLedger] = None):
    """Run ``epochs`` rounds in a Python loop, in chunks bounded by eval
    points (the DeFTA and the FedAvg round alike). Each chunk ends in a
    device synchronize and is recorded in
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
        _synchronize(state)
        led.record_dispatch(n, time.perf_counter() - t0)
        done += n
        if eval_every and done % eval_every == 0 and eval_fn is not None:
            history.append(eval_fn(state, done))
    led.finish("epochs", epochs)
    return state, history


def drive_ticks(tick_fn, state: DeFTAState, ticks: int, *, check_every: int,
                required: np.ndarray, target_epochs: int = 0,
                ledger: Optional[RunLedger] = None) -> DeFTAState:
    """Run AsyncDeFTA ticks ``tick_fn(state, t)`` in a Python loop.

    With no target every tick runs, as one chunk. With ``target_epochs``
    the ticks run in chunks of ``check_every`` and the run stops before the
    next chunk once ``all(epoch[required] >= target_epochs)``: the
    predicate is read exactly where the reference's ``lax.while_loop``
    reads it (before every chunk), so a run stops on the same tick as the
    reference, overshoot included. Each check is one host read of
    ``epoch``; the reference's device-side exit, with no host round trip,
    has no counterpart here worth building before a tick can be captured
    in a CUDA graph.

    Each chunk ends in a device synchronize and is recorded in the
    ``RunLedger`` (``rounds_done`` counts the ticks run); the ledger counts
    chunks, so ``as_stats()["dispatches"]`` is not the reference's XLA
    dispatch count. Returns the final state."""
    led = ledger if ledger is not None else RunLedger()
    chunk = check_every if target_epochs else max(ticks, 1)
    req = None
    if target_epochs:
        req = torch.as_tensor(np.asarray(required, bool)).to(
            state.epoch.device)
    done = 0
    while done < ticks:
        if req is not None and bool((state.epoch[req]
                                     >= target_epochs).all()):
            break
        n = min(chunk, ticks - done)
        t0 = time.perf_counter()
        for t in range(done, done + n):
            state = tick_fn(state, t)
        _synchronize(state)
        led.record_dispatch(n, time.perf_counter() - t0)
        done += n
    led.finish("ticks", ticks)
    return state
