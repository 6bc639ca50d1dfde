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
where the reference splits its PRNG key. With update DP (``dp_sigma > 0``
and ``dp_clip == 0``) a ``dp_noise`` stage follows ``local_train``;
DP-SGD (``dp_clip > 0``) lives inside ``local_train``. ``scenario_view``
is the static topology, or a compiled scenario's epoch (churn, links,
partitions, stragglers, a time-varying topology), with ``max_staleness``
dropping stale peers. The transport is the in-process ``gossip.mix_pytree`` (einsum
/ pallas / sparse / auto backends, fp32, bf16 or int8 + EF21 wire, int8
rounded to nearest or stochastically, optionally one-time-padded per
directed edge by pairwise secure aggregation), or a classical robust rule
(``scenarios.robust_agg``) that replaces the mix. The attack zoo
(``scenarios.attacks``) poisons what attackers send. FedAvg's star
aggregate is a plain size-weighted mean, as in the reference (no kernel).
``build_fire_gated_tick`` wraps the DeFTA round in AsyncDeFTA's tick
merge. The cross-device round runs the DeFTA stages on a sampled cohort
of an enrolled population:

    participation -> split_draws -> peer_sample -> transport
        -> damage_check -> local_train -> attack_inject -> trust_update
        -> scatter_merge

The multi-pod round of ``--fl`` (``build_pod_round``, state ``PodState``)
runs the same stages over the pod axis between the pods' training steps,
the pods' params a list of per-pod trees on their devices:

    split_draws -> scenario_view -> peer_sample -> transport
        -> [damage_check] -> attack_inject -> trust_update -> finalize

its transport the in-process backends on the stacked rows or the
cross-pod ring (``make_transport(..., pods=devices)``).

``drive_epochs`` runs rounds and ``drive_ticks`` runs ticks in a Python
loop, with per-chunk wall time.

Each builder takes ``telemetry=`` (a ``telemetry.Telemetry`` registry):
its stages then emit the reference's probes (``telemetry.spec``; read-only
observations of values the stages computed) and the round returns
``(state, frame)``. The drivers write the frames into preallocated device
buffers and hand them to the ``RunLedger`` once a chunk. Without a
registry no probe operation runs.

The trust update carries every DTS signal: the paper's loss delta, update
geometry (v2) and the cross-round sketch correlation (v3), whose ring
buffer rides in ``DeFTAState.sketch`` and is merged by ``fire`` and by the
tick like every other per-worker row. Under ``secagg_mode="masked_geom"``
a receiver sees only its aggregate, so the geometry and correlation
channels give way to the pooled signal (``dts.masked_geom_trust``) and the
ring buffer does not rotate.

``check_supported`` raises the reference's ``ValueError`` for a config the
reference rejects.

Worker-axis sharding (``shard=``, a ``sharding.WorkerShards``): the sync
round, the tick and the cross-device round take their per-worker state
as a list of row blocks, one per shard device, and run each stage block
by block; the transport is the sharded local-block mix
(``gossip.mix_rows_sharded``), and the stages that read across rows
gather explicitly. The drivers place the state (``shard=`` on
``drive_epochs`` / ``drive_ticks``) and hand back one whole state.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.config import DeFTAConfig, TrainConfig
from repro_torch.core import dts as dts_mod
from repro_torch.core import pods as pods_mod
from repro_torch.core.gossip import (dynamic_mixing_matrix, mix_pytree,
                                     mix_pytree_ppermute,
                                     mix_pytree_sharded,  # noqa: F401
                                     mix_rows_sharded, mixing_rows,
                                     normalize_wire, uses_error_feedback,
                                     worker_shard_plan)
from repro_torch.core.secagg import secagg_base_key
from repro_torch.core.tasks import Task
from repro_torch.device import resolve_device
from repro_torch.scenarios.attacks import (LABEL_FLIP_CODE, MODEL_ATTACKS,
                                           RANDOM_ATTACKS, flip_labels,
                                           noise, poison_sends, tree_select)
from repro_torch.scenarios.compile import ATTACK_CODE, epoch_view
from repro_torch.scenarios.robust_agg import ROBUST_RULES, robust_mix
from repro_torch.sharding import tree_map
from repro_torch.telemetry.ledger import RunLedger
from repro_torch.telemetry.spec import (cross_device_specs, defta_specs,
                                        fedavg_specs, gather_frames,
                                        stacked_payload_bytes, tick_specs,
                                        tree_payload_bytes)


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


def check_supported(cfg: DeFTAConfig, *, shard=None) -> None:
    """Raise the reference's ``ValueError`` for a config it rejects (an
    unknown trust signal, secure-aggregation scheme or mode, secure
    aggregation under a robust rule, a robust rule on a lossy wire,
    stochastic int8 rounding on the sharded transport), in the
    reference's order. A config is never silently ignored. An unknown
    ``aggregation`` is a ``ValueError`` here, where the reference builds a
    uniform mix."""
    resolve_dts_signal(cfg)
    if cfg.aggregation not in ("defta", "defl", "uniform") + ROBUST_RULES:
        raise ValueError(f"unknown aggregation {cfg.aggregation!r}")
    _check_transport(cfg, robust=cfg.aggregation in ROBUST_RULES,
                     shard=shard)


def _check_transport(cfg: DeFTAConfig, *, robust: bool, shard,
                     pods=None) -> None:
    """``make_transport``'s refusals, in the reference's order (the
    sharded transport's stochastic-int8 refusal before the cross-pod
    ring's)."""
    wire = normalize_wire(cfg.gossip_dtype)
    if robust and wire is not None:
        raise ValueError(
            f"robust aggregation ({cfg.aggregation!r}) simulates lossless "
            f"model exchange — it never runs the quantized wire, so "
            f"comparing it against a lossy-wire DeFTA run would be "
            f"apples-to-oranges; set gossip_dtype='float32'")
    if cfg.secagg not in (None, "pairwise"):
        raise ValueError(f"unknown secagg scheme {cfg.secagg!r} "
                         f"(None | 'pairwise')")
    if cfg.secagg_mode not in ("edge", "masked_geom"):
        raise ValueError(f"unknown secagg_mode {cfg.secagg_mode!r} "
                         f"('edge' | 'masked_geom')")
    if cfg.secagg is not None and robust:
        raise ValueError(
            f"secagg composes with the weighted gossip mix only — robust "
            f"rules ({cfg.aggregation!r}) inspect individual plaintext "
            f"models, which is exactly what the masked wire denies them")
    stochastic = wire == "int8" and cfg.gossip_wire_round == "stochastic"
    if shard is not None and stochastic:
        raise ValueError("wire_round='stochastic' is not supported on "
                         "the sharded transport (row-local nearest "
                         "encode only)")
    if shard is None and pods is not None and stochastic:
        raise ValueError("wire_round='stochastic' is not supported on "
                         "the ppermute transport (row-local nearest "
                         "encode only)")


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


def local_train_fn(task: Task, train: TrainConfig, local_epochs: int,
                   dp_clip: float = 0.0, dp_sigma: float = 0.0):
    """Returns f(perm, params, x, y, mask, dp_noise=None) -> (params,
    mean_loss [W]) running ``local_epochs`` epochs of minibatch SGD on
    every worker at once. ``perm`` [W, local_epochs, n] orders each
    worker's n (padded) samples per epoch; an epoch takes ``max(n //
    batch_size, 1)`` steps. With ``dp_clip > 0`` it runs DP-SGD: each
    worker's minibatch gradient over the whole model is scaled by
    ``min(1, clip / sqrt(Σ⟨g, g⟩ + 1e-12))`` and gets ``σ·clip·N / bs``,
    N from ``dp_noise`` (leaf name -> [W, local_epochs, steps, *leaf]
    standard normals, ``rng.RoundDraws.dp_sgd``)."""
    bs, lr = train.batch_size, train.learning_rate

    def privatize(grads, names, dp_noise, e, s):
        w = grads[0].shape[0]
        sq = sum((g.reshape(w, -1) ** 2).sum(dim=1) for g in grads)
        scale = torch.clamp(dp_clip / torch.sqrt(sq + 1e-12), max=1.0)
        return [g * scale.reshape((-1,) + (1,) * (g.ndim - 1))
                + dp_sigma * dp_clip * dp_noise[k][:, e, s] / bs
                for k, g in zip(names, grads)]

    def run(perm, params, x, y, mask, dp_noise=None):
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
                    if dp_clip > 0:
                        grads = privatize(grads, list(ps), dp_noise, e, s)
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
    wire_u=None, round_=None)`` follows ``gossip.mix_pytree``: the mixed
    dict, or ``(mixed, new_residual)`` when an EF21 residual dict is
    passed; ``wire_u`` carries the stochastic wire's uniforms and
    ``round_`` is the round the secagg pads are keyed on (inert without
    secagg). The sharded transport mixes row blocks instead:
    ``mix_rows(P_rows, stacked_rows, residual_rows, round_)`` returns
    ``(mixed_rows, new_residual_rows)`` (``gossip.mix_rows_sharded``). The pod round mixes per-pod rows:
    ``mix_pods(P, pod_rows, residual=None, wire_u=None, round_=None)``
    takes a list of per-pod dicts of leaves and returns ``(mixed,
    new_residual or None)``, lists alike: the in-process backends on the
    rows stacked onto P's device, or the cross-pod ring
    (``gossip.mix_pytree_ppermute``) between the pods' devices."""
    kind: str                    # "in_process" | "sharded" | "ppermute"
    wire: Optional[str]          # None | "bf16" | "int8"
    use_ef: bool
    stochastic: bool             # int8 stochastic rounding
    mix: Optional[Callable] = None
    mix_rows: Optional[Callable] = None
    mix_pods: Optional[Callable] = None


def make_transport(cfg: DeFTAConfig, *, backend: str = "auto",
                   adjacency=None, robust: bool = False,
                   shard=None, pods=None) -> Transport:
    """The in-process transport over the ``mix_pytree`` backends, or, with
    ``shard`` (a ``sharding.WorkerShards``), the worker-axis-sharded one:
    intra-shard edges run the padded-CSR sparse or int8 kernels on each
    shard's local block, cross-shard edges ride the block-granular ring
    (``gossip.mix_rows_sharded``); like the reference's it encodes
    row-local to nearest, so stochastic int8 rounding raises its
    ``ValueError`` there. ``adjacency`` is the static support of every P
    the round builds (the scenario's support union under a time-varying
    topology). Stochastic int8 rounding exists on the int8 wire only
    (elsewhere the knob is inert, as in the reference). A robust rule
    never runs the lossy wire. With ``cfg.secagg`` the pad root comes from
    ``cfg.seed`` alone (``secagg.secagg_base_key``: no draw moves): the
    in-process mix is then the masked gather mix, the sharded one masks
    its block channels.

    ``pods`` (a list of devices, one a pod; the reference's ``mesh=``)
    selects the cross-pod ``ppermute`` ring for the pod round
    (``gossip.mix_pytree_ppermute``: the ring schedule over the static
    ``adjacency``, row-local nearest encode, so stochastic int8 rounding
    raises its ``ValueError`` there too)."""
    _check_transport(cfg, robust=robust, shard=shard, pods=pods)
    wire = normalize_wire(cfg.gossip_dtype)
    use_ef = uses_error_feedback(cfg)
    stochastic = wire == "int8" and cfg.gossip_wire_round == "stochastic"
    wire_round = "stochastic" if stochastic else "nearest"
    sec_base = secagg_base_key(cfg.seed) if cfg.secagg is not None \
        else None
    if shard is not None:
        plan = None if adjacency is None \
            else worker_shard_plan(adjacency, shard.shards)

        def mix_rows(P_rows, stacked_rows, residual_rows=None, round_=None):
            return mix_rows_sharded(P_rows, stacked_rows, shard,
                                    adjacency=adjacency, wire=wire,
                                    residual_rows=residual_rows,
                                    secagg=sec_base, secagg_round=round_,
                                    plan=plan)
        return Transport(kind="sharded", wire=wire, use_ef=use_ef,
                         stochastic=False, mix_rows=mix_rows)

    if pods is not None:
        devices = [torch.device(d) for d in pods]

        def ring(P, pod_rows, residual=None, wire_u=None, round_=None):
            out = mix_pytree_ppermute(P, pod_rows, devices,
                                      adjacency=adjacency, wire=wire,
                                      residual=residual, secagg=sec_base,
                                      secagg_round=round_)
            return out if residual is not None else (out, None)
        return Transport(kind="ppermute", wire=wire, use_ef=use_ef,
                         stochastic=False, mix_pods=ring)

    def mix(P, stacked, residual=None, wire_u=None, round_=None):
        return mix_pytree(P, stacked, backend=backend, adjacency=adjacency,
                          wire=wire, residual=residual,
                          wire_round=wire_round, wire_u=wire_u,
                          secagg=sec_base, secagg_round=round_)

    def mix_pods(P, pod_rows, residual=None, wire_u=None, round_=None):
        devices = [next(iter(r.values())).device for r in pod_rows]
        stacked = pods_mod.stack(pod_rows, P.device)
        if residual is None:
            out = mix(P, stacked, wire_u=wire_u, round_=round_)
            return pods_mod.unstack(out, devices), None
        out, err = mix(P, stacked, residual=pods_mod.stack(residual,
                                                           P.device),
                       wire_u=wire_u, round_=round_)
        return pods_mod.unstack(out, devices), pods_mod.unstack(err,
                                                                devices)
    return Transport(kind="in_process", wire=wire, use_ef=use_ef,
                     stochastic=stochastic, mix=mix, mix_pods=mix_pods)


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


def uses_update_dp(cfg: DeFTAConfig) -> bool:
    """The per-round update-DP stage is built iff ``dp_sigma > 0`` with
    ``dp_clip == 0`` (with ``dp_clip > 0`` the sigma belongs to DP-SGD in
    ``local_train``, and the stage must not add noise twice)."""
    return cfg.dp_sigma > 0 and cfg.dp_clip == 0


def apply_update_dp(cfg: DeFTAConfig, noise: dict, start: dict,
                    trained: dict) -> dict:
    """Clip the local-update delta ``trained − start`` to
    ``cfg.dp_update_clip`` per worker (L2 over the whole model) and add
    ``dp_sigma·clip·N``, N from ``noise`` (leaf name -> [W, ...] standard
    normals, ``rng.RoundDraws.dp_update``). Returns the noised
    ``trained``."""
    delta = {k: trained[k] - start[k] for k in trained}
    nrm = torch.linalg.norm(dts_mod.flatten_stacked(delta), dim=1)
    clip = float(np.float32(cfg.dp_update_clip))
    scale = torch.clamp(clip / torch.clamp(nrm, min=1e-12), max=1.0)
    sigma = float(np.float32(cfg.dp_sigma) * np.float32(clip))
    return {k: start[k] + (d * scale.reshape((-1,) + (1,) * (d.ndim - 1))
                           + sigma * noise[k])
            for k, d in delta.items()}


def _draw_shapes(shapes: dict, cfg: DeFTAConfig, train: TrainConfig,
                 w: int, n: int, transport: Transport,
                 noise_kinds: tuple) -> dict:
    """The build-time-gated extras a round asks its provider for: the
    random attack kinds' noise, the stochastic wire's uniforms and the two
    DP draws, each only when the round needs it. ``shapes``: each leaf's
    [W, ...] shape."""
    extra = {}
    if noise_kinds:
        extra["kind_noise"] = {k: shapes for k in noise_kinds}
    if transport.stochastic:
        extra["wire_shapes"] = {
            k: (w, int(np.prod(v[1:], dtype=np.int64)))
            for k, v in shapes.items()}
    if cfg.dp_clip > 0:
        steps = max(n // train.batch_size, 1)
        extra["dp_sgd_shapes"] = {
            k: (w, cfg.local_epochs, steps) + s[1:]
            for k, s in shapes.items()}
    if uses_update_dp(cfg):
        extra["dp_update_shapes"] = shapes
    return extra


def _blocks(state, data, n: int) -> list:
    """The round's per-block contexts: a state and its data, each a list
    of row blocks (a sharded run) or one whole tree."""
    states = state if isinstance(state, list) else [state]
    datas = data if isinstance(data, list) else [data]
    if len(states) != n or len(datas) != n:
        raise ValueError(f"the round runs {n} row block(s); got "
                         f"{len(states)} state and {len(datas)} data "
                         f"block(s) (place them with "
                         f"WorkerShards.shard_leading)")
    return [{"state": s, "data": d} for s, d in zip(states, datas)]


def _close_blocks(c) -> None:
    """The round's last stage: ``next`` is the blocks' next states, a list
    when the round was given one, else the one state."""
    nxt = [bc["next"] for bc in c["blocks"]]
    c["next"] = nxt if isinstance(c["state"], list) else nxt[0]


def _cat(parts, dev):
    """Row blocks -> one tensor on ``dev``; a single block passes
    through."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(dev) for p in parts])


def _cat_tree(parts, dev):
    """Row blocks of a dict of tensors -> one dict on ``dev``."""
    if len(parts) == 1:
        return parts[0]
    return {k: _cat([p[k] for p in parts], dev) for k in parts[0]}


def _total(parts, dev):
    """The sum of per-block partial results on ``dev`` (a single block
    passes through)."""
    out = parts[0].to(dev)
    for p in parts[1:]:
        out = out + p.to(dev)
    return out


def _split(tree, bounds):
    """A whole tensor (or dict or dataclass of them) -> its rows of each
    block ``(r0, r1, device)``; a single block takes it whole."""
    if len(bounds) == 1:
        return [tree]
    return [tree_map(lambda x, r0=r0, r1=r1, d=d: x[r0:r1].to(d), tree)
            for r0, r1, d in bounds]


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
    scenario (the flip is ``y -> C-1-y``).

    ``telemetry``: a ``telemetry.Telemetry`` registry. The round declares
    ``defta_specs`` into it, its stages emit them, and it returns
    ``(state, frame)``; ``round.telemetry`` is the registry (None without
    one, and then no probe operation runs).

    ``shard``: a ``sharding.WorkerShards`` (``device`` its first device).
    The round then takes and returns the state and data as lists of row
    blocks (``WorkerShards.shard_leading``: one per shard when W divides
    evenly, else one whole block) and runs its stages block by block; the
    transport is the sharded local-block mix (``gossip.mix_rows_sharded``).
    The draws are asked for once at full W and each block takes its rows,
    so a sharded run consumes the unsharded stream. The stages that read
    across rows gather their inputs onto ``device`` explicitly (what
    GSPMD's collectives do in the reference): the staleness test (the
    epoch vector), the scenario's outdegrees, the robust rules, the
    attack zoo's population statistics, the geometry, correlation and
    ``masked_geom`` trust channels, and the probes over receivers.
    ``round.bounds`` lists the blocks as (r0, r1, device)."""
    check_supported(cfg, shard=shard)
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
    ltrain = local_train_fn(task, train, cfg.local_epochs,
                            dp_clip=cfg.dp_clip, dp_sigma=cfg.dp_sigma)
    dp_update = uses_update_dp(cfg)
    # a receiver of an aggregate-only secagg wire sees no per-peer update:
    # the geometry and correlation channels give way to the pooled signal
    masked_geom = cfg.secagg is not None \
        and cfg.secagg_mode == "masked_geom"
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
                               adjacency=support, robust=robust, shard=shard)
    use_ef = transport.use_ef
    regen = scenario is not None and scenario.adj_seg is not None
    if telemetry is not None:
        telemetry.declare(*defta_specs(w, scenario=scenario is not None,
                                       use_ef=use_ef))
        tm_specs = telemetry.specs       # snapshot: the tick adds "fired"
    bounds = shard.bounds(w) if shard is not None else [(0, w, dev)]
    # each block's receiver-row constants (the column-indexed ones, col_w
    # and sizes, stay whole)
    consts = [dict(
        rows=slice(r0, r1), dev=bdev, adj=adj_t[r0:r1].to(bdev),
        eye=eye[r0:r1].to(bdev), off=~eye[r0:r1].to(bdev),
        malicious=malicious_t[r0:r1].to(bdev),
        attack_scale=attack_scale[r0:r1].to(bdev), col_w=col_w.to(bdev),
        sizes=sizes_t.to(bdev),
        attack_kind=None if scenario is None
        else scenario.attack_kind[r0:r1].to(bdev))
        for r0, r1, bdev in bounds]

    def full(bs, key):
        """A per-block tensor (or dict of them) of every block, whole on
        ``device``."""
        parts = [bc[key] for bc in bs]
        if isinstance(parts[0], dict):
            return _cat_tree(parts, dev)
        return _cat(parts, dev)

    def to_blocks(bs, key, value):
        """Each block takes its rows of a whole tensor (or dict)."""
        for bc, part in zip(bs, _split(value, bounds)):
            bc[key] = part

    # ---- stages -----------------------------------------------------------

    def stage_split_draws(c):
        """writes draws: this round's Gumbel rows, minibatch permutations,
        (static path, with attackers) the noise attack's draws, and, gated
        at build time, the scenario's per-kind attack noise, the stochastic
        wire's uniforms and the DP-SGD or update-DP normals, in one
        provider call at full W; each block takes its rows. Opens the
        round's per-block contexts (``blocks``) over state and data."""
        c["blocks"] = bs = _blocks(c["state"], c["data"], len(bounds))
        shapes = {k: (w,) + tuple(v.shape[1:])
                  for k, v in bs[0]["state"].params.items()}
        n = bs[0]["data"]["x"].shape[1]
        extra = _draw_shapes(shapes, cfg, train, w, n, transport,
                             noise_kinds)
        legacy = scenario is None and malicious_np.any()
        c["draws"] = draws(w, cfg.local_epochs, n,
                           shapes if legacy else None, **extra)
        to_blocks(bs, "draws", c["draws"])

    def stage_scenario_view(c):
        """reads epoch, state.epoch; writes eff_adj (and alive, fire,
        att_on under a scenario): the round's topology = (segment or
        static) adjacency ∧ link_ok ∧ alive on both ends; with
        ``max_staleness`` S > 0, minus the edges from peers whose epoch
        lags the receiver's by more than S (the whole epoch vector
        gathered)."""
        bs = c["blocks"]
        if scenario is not None:
            view = epoch_view(scenario, c["epoch"])
            alive = view["alive"]
            c["alive"], c["fire"], c["att_on"] = \
                alive, view["fire"], view["attack_on"]
            base = view["adj"] if regen else adj_t
            for bc, k in zip(bs, consts):
                r = k["rows"]
                bc["alive"] = alive[r].to(k["dev"])
                bc["fire"] = view["fire"][r].to(k["dev"])
                bc["att_on"] = view["attack_on"][r].to(k["dev"])
                bc["eff_adj"] = (base[r] & view["link_ok"][r]
                                 & alive[None, :] & alive[r, None]
                                 ).to(k["dev"])
        else:
            for bc, k in zip(bs, consts):
                bc["eff_adj"] = k["adj"]
        if max_staleness:
            ep = _cat([bc["state"].epoch for bc in bs], dev)
            for bc, k in zip(bs, consts):
                fresh = (bc["state"].epoch[:, None]
                         - ep.to(k["dev"])[None, :]) <= max_staleness
                bc["eff_adj"] = bc["eff_adj"] & fresh
        if telemetry is not None:
            # a host number: the drivers stamp the column from one arange
            telemetry.emit(c, "round",
                           -1 if c["epoch"] is None else c["epoch"])
            if scenario is not None:
                telemetry.emit(c, "alive", c["alive"])
                telemetry.emit(c, "fire", c["fire"])

    def stage_peer_sample(c):
        """reads eff_adj, state.conf, draws.gumbel; writes theta [W, W]
        (DTS sampling weights, observed by theta_aware) and sampled [W, W]
        (Gumbel top-k, ≤ num_sampled per row), each block its rows."""
        for bc in c["blocks"]:
            if cfg.use_dts:
                theta = dts_mod.sample_weights(bc["state"].conf,
                                               bc["eff_adj"], cfg.crelu_slope)
            else:
                a = bc["eff_adj"].float()
                theta = a / a.sum(1, keepdim=True).clamp_min(1)
            bc["theta"] = theta
            bc["sampled"] = dts_mod.sample_peers(bc["draws"].gumbel, theta,
                                                 cfg.num_sampled)
        if telemetry is not None:
            telemetry.emit(c, "theta_in", full(c["blocks"], "theta")
                           .mean(dim=0))

    def stage_transport(c):
        """reads sampled, eff_adj, state.params, state.wire_err,
        draws.wire_u; writes P (mixing matrix), agg (the mixed models) and
        wire_err. A robust rule replaces the mix (no kernel launch), with P
        the uniform bookkeeping weights the trust update needs."""
        bs = c["blocks"]
        for bc, k in zip(bs, consts):
            bc["mask"] = (bc["sampled"] & bc["eff_adj"]) | k["eye"]
        if telemetry is not None:
            # priced from the plaintext payload, secagg or not (the pads
            # ride in place)
            live = _total([(bc["sampled"] & bc["eff_adj"] & k["off"]).sum()
                           for bc, k in zip(bs, consts)], dev)
            telemetry.emit(c, "edges", live)
            telemetry.emit(c, "wire_bytes", live.float()
                           * stacked_payload_bytes(bs[0]["state"].params,
                                                   transport.wire))
        if robust:
            params = [bc["state"].params for bc in bs]
            to_blocks(bs, "agg", robust_mix(
                cfg.aggregation, full(bs, "mask"), _cat_tree(params, dev),
                trim=cfg.robust_trim))
            for bc in bs:
                bc["P"] = bc["mask"].float() \
                    / bc["mask"].sum(dim=1, keepdim=True)
                bc["wire_err"] = bc["state"].wire_err
            return
        if scenario is not None:
            # per-epoch outdegrees under the dynamic adjacency (a sum over
            # every block's receivers)
            deg = _total([(bc["eff_adj"] | k["eye"]).sum(dim=0)
                          for bc, k in zip(bs, consts)], dev)
            for bc, k in zip(bs, consts):
                bc["P"] = mixing_rows(bc["sampled"], bc["eff_adj"], k["eye"],
                                      deg.to(k["dev"]), k["sizes"],
                                      cfg.aggregation)
        else:
            for bc, k in zip(bs, consts):
                P = bc["mask"] * k["col_w"][None, :]
                bc["P"] = P / P.sum(dim=1, keepdim=True)
        round_ = 0 if c["epoch"] is None else c["epoch"]
        if use_ef and bs[0]["state"].wire_err is None:
            raise ValueError(
                "cfg enables gossip error feedback on a lossy wire "
                "but the state carries no residual buffers — build "
                "it with init_state(..., wire_error=True)")
        if transport.kind == "sharded":
            aggs, errs = transport.mix_rows(
                [bc["P"] for bc in bs], [bc["state"].params for bc in bs],
                [bc["state"].wire_err for bc in bs] if use_ef else None,
                round_)
            for i, bc in enumerate(bs):
                bc["agg"] = aggs[i]
                bc["wire_err"] = errs[i] if use_ef else bc["state"].wire_err
        else:
            bc = bs[0]
            state = bc["state"]
            wire_u = bc["draws"].wire_u
            if use_ef:
                bc["agg"], bc["wire_err"] = transport.mix(
                    bc["P"], state.params, residual=state.wire_err,
                    wire_u=wire_u, round_=round_)
            else:
                bc["agg"] = transport.mix(bc["P"], state.params,
                                          wire_u=wire_u, round_=round_)
                bc["wire_err"] = state.wire_err
        if telemetry is not None and use_ef:
            telemetry.emit(c, "ef_norm", _cat([torch.linalg.norm(
                dts_mod.flatten_stacked(bc["wire_err"]), dim=1)
                for bc in bs], dev))

    def stage_damage_check(c):
        """reads agg, state.{backup,best_loss}, data, att_on; writes y_data
        (the labels, flipped for active label-flippers), loss_agg (each
        worker's self-evaluation of the aggregate), damaged [W] and start
        (the backup on damaged rounds: the §3.3 time machine)."""
        bs = c["blocks"]
        for bc, k in zip(bs, consts):
            state, data = bc["state"], bc["data"]
            y_data = data["y"]
            if scenario is not None and \
                    "label_flip" in scenario.kinds_present:
                lf = (k["attack_kind"] == LABEL_FLIP_CODE) & bc["att_on"]
                y_data = flip_labels(y_data, lf, num_classes)
            bc["y_data"] = y_data
            bc["loss_agg"] = task.loss(bc["agg"], data["x"], y_data,
                                       data["mask"]).detach()
            if cfg.time_machine:
                bc["damaged"] = dts_mod.is_damaged(bc["loss_agg"],
                                                   state.best_loss)
                bc["start"] = tree_select(bc["damaged"], state.backup,
                                          bc["agg"])
            else:
                bc["damaged"] = torch.zeros_like(bc["loss_agg"],
                                                 dtype=torch.bool)
                bc["start"] = bc["agg"]
        if telemetry is not None:
            telemetry.emit(c, "loss_agg", full(bs, "loss_agg"))
            telemetry.emit(c, "damaged", full(bs, "damaged"))

    def stage_local_train(c):
        """reads start, y_data, data, draws.perm (+ draws.dp_sgd under
        DP-SGD); writes trained and train_loss."""
        bs = c["blocks"]
        for bc in bs:
            data = bc["data"]
            bc["trained"], bc["train_loss"] = ltrain(
                bc["draws"].perm, bc["start"], data["x"], bc["y_data"],
                data["mask"], bc["draws"].dp_sgd)
        if telemetry is not None:
            telemetry.emit(c, "train_loss", full(bs, "train_loss"))

    def stage_dp_noise(c):
        """reads trained, start, draws.dp_update; writes trained: every
        worker clips its local-update delta and noises it before it
        becomes the next round's send, so peers and the trust channels
        see only the privatized update (``apply_update_dp``). Built only
        under ``uses_update_dp(cfg)``."""
        for bc in c["blocks"]:
            bc["trained"] = apply_update_dp(cfg, bc["draws"].dp_update,
                                            bc["start"], bc["trained"])

    def stage_attack_inject(c):
        """reads trained, agg, theta, att_on, draws.{noise, kind_noise};
        writes trained: attacker slots replaced by their poisoned sends
        (the scenario's zoo, over the whole population, since alie,
        dts_dodge and theta_aware read every row; or on the static path
        agg + noise_scale·N(0, 1), the paper's attack, block by block)."""
        bs = c["blocks"]
        if scenario is not None:
            to_blocks(bs, "trained", poison_sends(
                c["draws"].kind_noise, scenario.kinds_present,
                scenario.attack_kind, scenario.attack_scale, c["att_on"],
                full(bs, "agg"), full(bs, "trained"),
                theta=full(bs, "theta") if cfg.use_dts else None))
        elif malicious_np.any():
            for bc, k in zip(bs, consts):
                poisoned = noise(bc["draws"].noise, bc["agg"],
                                 bc["trained"], k["attack_scale"])
                bc["trained"] = tree_select(k["malicious"], poisoned,
                                            bc["trained"])

    def trust_channels(conf, sampled, P, theta, loss_trust, damaged,
                       deltas, eff_adj, fire, sketch):
        """The geometry, correlation or ``masked_geom`` confidence update
        over whole [W, ...] inputs: returns (conf, sketch)."""
        gmask = eff_adj & fire[None, :] if scenario is not None else eff_adj
        if masked_geom:
            mg = dts_mod.masked_geom_trust(deltas, P, gmask)
            return conf - sampled * P \
                * (loss_trust + cfg.dts_geom_weight * mg)[:, None], sketch
        # non-firing peers (stragglers) are left out: the fire merge drops
        # their delta, so no peer consumes it
        if corr:
            if sketch is None:
                raise ValueError(
                    f"dts_signal={cfg.dts_signal!r} needs the sketch "
                    f"ring buffer — build the state with "
                    f"init_state(..., sketch=sketch_shape(cfg))")
            sketch = dts_mod.update_sketch(sketch, deltas, seed=cfg.seed)
        return dts_mod.geom_confidence_update(
            cfg.dts_signal, cfg.dts_geom_weight, conf, sampled, P,
            loss_trust, damaged, deltas, gmask, theta, sketch=sketch,
            lam_corr=cfg.dts_corr_weight), sketch

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
        the poison is what gets scored; every block's rows gathered). Under
        ``masked_geom`` the extra channels are replaced by the pooled
        aggregate-minus-own signal (``dts.masked_geom_trust``), broadcast
        over the receiver's sampled row, and the sketch ring buffer is
        left as it was."""
        bs = c["blocks"]
        for bc in bs:
            state = bc["state"]
            bc["loss_trust"] = torch.where(
                bc["damaged"], torch.full_like(bc["loss_agg"],
                                               dts_mod.DAMAGE_PENALTY),
                bc["loss_agg"] - state.last_loss)
            bc["conf0"], bc["sketch"] = state.conf, state.sketch
        deltas = None
        if channels:
            deltas = dts_mod.flatten_stacked(full(bs, "trained")) \
                - dts_mod.flatten_stacked(full(bs, "start"))
            conf, sketch = trust_channels(
                full(bs, "conf0"), full(bs, "sampled"), full(bs, "P"),
                full(bs, "theta"), full(bs, "loss_trust"),
                full(bs, "damaged"), deltas, full(bs, "eff_adj"),
                c.get("fire"), full(bs, "sketch") if corr else None)
            to_blocks(bs, "conf", conf)
            if corr and not masked_geom:
                to_blocks(bs, "sketch", sketch)
        else:
            for bc in bs:
                bc["conf"] = bc["conf0"] - bc["sampled"] * bc["P"] \
                    * bc["loss_trust"][:, None]
        if telemetry is not None:
            if deltas is None:
                deltas = dts_mod.flatten_stacked(full(bs, "trained")) \
                    - dts_mod.flatten_stacked(full(bs, "start"))
            telemetry.emit(c, "loss_trust", full(bs, "loss_trust"))
            telemetry.emit(c, "conf_in", full(bs, "conf").mean(dim=0))
            telemetry.emit(c, "update_norm", torch.linalg.norm(deltas,
                                                               dim=1))
        for bc in bs:
            state = bc["state"]
            improved = (bc["loss_agg"] < state.best_loss) & ~bc["damaged"]
            # the time machine RATCHETS: a damaged round trained from the
            # backup, so its result is clean by induction and becomes the
            # new backup (a worker whose peers are all attackers keeps
            # learning)
            bc["backup"] = tree_select(improved | bc["damaged"],
                                       bc["trained"], state.backup)
            bc["best_loss"] = torch.where(improved, bc["loss_agg"],
                                          state.best_loss)
            bc["last_loss"] = torch.where(bc["damaged"], state.last_loss,
                                          bc["loss_agg"])

    def stage_finalize(c):
        """writes next: every worker advanced one epoch."""
        for bc in c["blocks"]:
            state = bc["state"]
            bc["next"] = DeFTAState(
                params=bc["trained"], backup=bc["backup"], conf=bc["conf"],
                best_loss=bc["best_loss"], last_loss=bc["last_loss"],
                epoch=state.epoch + 1, wire_err=bc["wire_err"],
                sketch=bc["sketch"])
        _close_blocks(c)

    def stage_fire_merge(c):
        """reads fire + everything finalize reads; writes next: workers
        that do not fire (dead, or a straggler's idle epoch) keep params,
        backup, conf rows, losses, EF21 residual and sketch row (a ring
        buffer must not rotate on a round whose delta no peer consumed);
        epoch advances by fire."""
        for bc in c["blocks"]:
            state, fire = bc["state"], bc["fire"]
            bc["next"] = DeFTAState(
                params=tree_select(fire, bc["trained"], state.params),
                backup=tree_select(fire, bc["backup"], state.backup),
                conf=torch.where(fire[:, None], bc["conf"], state.conf),
                best_loss=torch.where(fire, bc["best_loss"],
                                      state.best_loss),
                last_loss=torch.where(fire, bc["last_loss"],
                                      state.last_loss),
                epoch=state.epoch + fire.to(state.epoch.dtype),
                wire_err=tree_select(fire, bc["wire_err"], state.wire_err)
                if use_ef else state.wire_err,
                sketch=torch.where(fire[:, None, None], bc["sketch"],
                                   state.sketch) if corr else state.sketch)
        _close_blocks(c)

    stages = (
        ("split_draws", stage_split_draws),
        ("scenario_view", stage_scenario_view),
        ("peer_sample", stage_peer_sample),
        ("transport", stage_transport),
        ("damage_check", stage_damage_check),
        ("local_train", stage_local_train),
    ) + ((("dp_noise", stage_dp_noise),) if dp_update else ()) + (
        ("attack_inject", stage_attack_inject),
        ("trust_update", stage_trust_update),
        ("finalize", stage_finalize) if scenario is None
        else ("fire_merge", stage_fire_merge),
    )

    def round(state, data, epoch=None):
        c = {"state": state, "data": data, "epoch": epoch}
        run_pipeline(stages, c)
        if telemetry is None:
            return c["next"]
        return c["next"], telemetry.collect(c, tm_specs)

    round.stages = stages
    round.telemetry = telemetry
    round.bounds = bounds
    return round


def build_fedavg_round(task: Task, cfg: DeFTAConfig, train: TrainConfig,
                       sizes: np.ndarray, malicious: np.ndarray, *, draws,
                       device, sample_workers: int = 0,
                       server_opt: str = "none", server_lr: float = 1.0,
                       noise_scale: float = 200.0, telemetry=None):
    """FedAvg as a stage selection over the same pipeline: the transport is
    a STAR topology (server broadcast down, size-weighted mean up), there
    is no peer sampling / DTS / time machine, and the server optimizer is
    the last stage. ``sample_workers=0`` -> CFL-F; >0 -> CFL-S over that
    many workers drawn without replacement each round; ``server_opt=
    "fedadam"`` -> FedAdam (any other value: plain replacement). Of ``cfg``
    only ``local_epochs`` is read. ``draws`` is the round's
    ``rng.FedAvgDraws`` provider (one call per round).

    Returns round(state, data, epoch=None) -> ``FedAvgState``; with a
    ``telemetry`` registry it declares ``fedavg_specs`` and returns
    ``(state, frame)``."""
    dev = torch.device(device)
    w = len(sizes)
    sizes_t = torch.as_tensor(np.asarray(sizes, np.float32)).to(dev)
    malicious_np = np.asarray(malicious, bool)
    malicious_t = torch.as_tensor(malicious_np).to(dev)
    attack_scale = torch.full((w,), noise_scale, dtype=torch.float32,
                              device=dev)
    ltrain = local_train_fn(task, train, cfg.local_epochs)
    if telemetry is not None:
        telemetry.declare(*fedavg_specs(w))
        tm_specs = telemetry.specs
        star_bytes = {}                  # the star wire's constant, once

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
        if telemetry is not None:
            telemetry.emit(c, "round",
                           -1 if c["epoch"] is None else c["epoch"])

    def stage_local_train(c):
        """reads bcast, data, draws.perm; writes trained (its per-worker
        losses feed the telemetry probe)."""
        data = c["data"]
        c["trained"], train_loss = ltrain(c["draws"].perm, c["bcast"],
                                          data["x"], data["y"],
                                          data["mask"])
        if telemetry is not None:
            telemetry.emit(c, "train_loss", train_loss)

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
        if telemetry is not None:
            # star wire: W broadcasts down + the (sampled) cohort up, at the
            # fp32 payload; one device constant (a fill, no copy) made on
            # the first round
            if not star_bytes:
                up = sample_workers if sample_workers else w
                star_bytes["v"] = torch.full(
                    (), (w + up) * tree_payload_bytes(c["state"].server,
                                                      None),
                    dtype=torch.float32, device=dev)
            telemetry.emit(c, "wire_bytes", star_bytes["v"])

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
        if telemetry is None:
            return c["next"]
        return c["next"], telemetry.collect(c, tm_specs)

    round.stages = stages
    round.telemetry = telemetry
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

    When the round carries a telemetry registry the tick declares
    ``tick_specs`` into it and returns ``(state, frame)``, the round's
    frame with ``fired`` added last.

    With a sharded round (``rnd_fn.bounds``, more than one block) the
    state is a list of row blocks and each takes its rows of ``fired``.

    Returns tick(state, t) -> state."""
    telemetry = getattr(rnd_fn, "telemetry", None)
    if telemetry is not None:
        telemetry.declare(*tick_specs(w))
    bounds = getattr(rnd_fn, "bounds", [(0, w, speeds.device)])

    def merge(fired, nxt, state):
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

    def tick(state, t: int):
        fired = draws(w) < speeds
        if telemetry is None:
            nxt = rnd_fn(state, data, t)
        else:
            nxt, frame = rnd_fn(state, data, t)
        if isinstance(state, list):
            merged = [merge(f, n, s) for f, n, s in
                      zip(_split(fired, bounds), nxt, state)]
        else:
            merged = merge(fired, nxt, state)
        if telemetry is None:
            return merged
        return merged, dict(frame, fired=fired)

    tick.telemetry = telemetry
    return tick


# ---------------------------------------------------------------------------
# Multi-pod round program (launch/train.py --fl)
# ---------------------------------------------------------------------------

@dataclass
class PodState:
    """Gossip-round state of the multi-pod path (ref ``PodState``): DTS
    confidence, EF21 residuals and the round counter; the pods' params and
    optimizer states live in the launcher's training loop. ``backup`` /
    ``best_loss`` are the pod time machine (None when it is off). The
    [npods, ...] fields lie on the controller device; ``wire_err`` and
    ``backup`` are lists of per-pod trees on the pods' devices. ``round``
    is a host counter (the reference's int32 scalar; the port's randomness
    comes from the round's ``rng.Draws`` provider, so there is no key)."""
    conf: torch.Tensor           # [npods, npods]
    last_loss: torch.Tensor      # [npods]
    round: int = 0
    wire_err: Optional[list] = None   # per-pod EF21 residual trees (f32)
    backup: Optional[list] = None     # per-pod best-eval param trees
    best_loss: Optional[torch.Tensor] = None   # [npods]
    sketch: Optional[torch.Tensor] = None      # [npods, R, S]


def init_pod_state(npods: int, params=None, *, wire_error: bool = False,
                   time_machine: bool = False, sketch=None,
                   device=None) -> PodState:
    """``params``: the per-pod parameter trees (needed to size the EF21
    residuals and the time machine's backups); ``sketch``: the (R, S) dims
    from ``sketch_shape(cfg)`` when the correlation channel is on.
    ``device``: the controller device (default: pod 0's, else the
    card)."""
    if (wire_error or time_machine) and params is None:
        raise ValueError("wire_error/time_machine pod state needs the "
                         "stacked params to size its buffers")
    if device is None and params is not None:
        dev = next(iter(pods_mod.flatten(params[0]).values())).device
    else:
        dev = resolve_device(device)

    def zeros_f32(tree):
        return {k: zeros_f32(v) if isinstance(v, dict) else
                torch.zeros(v.shape, dtype=torch.float32, device=v.device)
                for k, v in tree.items()}
    return PodState(
        conf=torch.zeros((npods, npods), device=dev),
        last_loss=torch.zeros(npods, device=dev),
        round=0,
        wire_err=[zeros_f32(p) for p in params] if wire_error else None,
        backup=[pods_mod.copy_to(p) for p in params] if time_machine
        else None,
        best_loss=torch.full((npods,), float("inf"), device=dev)
        if time_machine else None,
        sketch=torch.zeros((npods,) + tuple(sketch), device=dev)
        if sketch else None)


def build_pod_round(cfg: DeFTAConfig, npods: int, sizes, *,
                    transport: Transport, adj: np.ndarray, draws,
                    device=None, scenario=None, num_appended: int = 0,
                    self_eval=None):
    """The multi-pod gossip round (ref ``build_pod_round``) as the same
    stage pipeline over the pod axis:

        split_draws -> scenario_view -> peer_sample -> transport
            -> [damage_check] -> attack_inject -> trust_update -> finalize

    Local training happens between gossip rounds (``launch.steps``).
    ``transport``: ``make_transport(cfg, adjacency=..., pods=devices)``
    for the cross-pod ring, without ``pods`` for the in-process backends.
    ``draws``: the round's ``rng.Draws`` provider, asked once a round for
    the peer-sampling Gumbel rows (and, gated at build time, the random
    attack kinds' noise and the stochastic wire's uniforms). ``device``:
    the controller device, where the [npods, ...] state and the stages
    that read across pods run (default: the card).

    ``self_eval(pod_params) -> [npods] losses`` (a list of per-pod trees
    in, a tensor on the controller device out) is the pod time machine's
    held-out self-evaluation: with ``cfg.time_machine`` the candidate
    aggregate is evaluated, damaged pods restore their backup instead of
    adopting the mix, and the damage penalty feeds the trust update.
    Without it ``damage_check`` is not built.

    Returns gossip_round(pstate, params, losses, start_params=None) ->
    (pstate, new_params): ``params`` the per-pod trees, ``losses`` [npods]
    the pods' current train losses. ``start_params`` (the per-pod trees
    the pods departed from this interval) makes the geometry and
    correlation channels score the true local-train deltas ``sent −
    start``; without it they score the round displacement ``out −
    params``, as the reference's legacy pod path does. The scenario's
    epoch axis is the gossip round (``pstate.round``); its
    ``num_appended`` attackers occupy the last pod slots."""
    del num_appended                      # slots are already in npods
    w = npods
    dev = resolve_device(device)
    adj_t = torch.as_tensor(np.asarray(adj, bool)).to(dev)
    eye = torch.eye(w, dtype=torch.bool, device=dev)
    sizes_t = torch.as_tensor(np.asarray(sizes, np.float32)).to(dev)
    robust = cfg.aggregation in ROBUST_RULES
    if robust and transport.wire is not None:
        raise ValueError("robust aggregation on the pod path needs a "
                         "lossless wire (gossip_dtype='float32')")
    if scenario is not None and scenario.num_workers != w:
        raise ValueError(f"scenario compiled for W={scenario.num_workers} "
                         f"pods, mesh has {w}")
    regen = scenario is not None and scenario.adj_seg is not None
    use_ef = transport.use_ef
    channels = resolve_dts_signal(cfg)
    corr = "corr" in channels
    if cfg.secagg is not None and cfg.secagg_mode == "masked_geom":
        raise ValueError(
            "secagg_mode='masked_geom' has no pod selection: pod trust "
            "already runs at pod granularity (each pod IS an aggregate) "
            "— use the simulation/cross-device engines to measure the "
            "aggregate-only trust degradation")
    time_machine = cfg.time_machine and self_eval is not None
    noise_kinds = () if scenario is None else tuple(
        k for k in scenario.kinds_present if k in RANDOM_ATTACKS)
    model_kinds = () if scenario is None else tuple(
        k for k in scenario.kinds_present if k in MODEL_ATTACKS)

    def stage_split_draws(c):
        """reads params; writes draws (the Gumbel rows, and the random
        attack kinds' noise and the stochastic wire's uniforms when the
        round needs them) and flat (each pod's params, wire_err and
        backup as dicts of leaves)."""
        pstate = c["pstate"]
        c["flat"] = [pods_mod.flatten(p) for p in c["params"]]
        c["flat_err"] = None if pstate.wire_err is None else \
            [pods_mod.flatten(e) for e in pstate.wire_err]
        shapes = {k: (w,) + tuple(v.shape) for k, v in c["flat"][0].items()}
        extra = {}
        if noise_kinds:
            extra["kind_noise"] = {k: shapes for k in noise_kinds}
        if transport.stochastic:
            extra["wire_shapes"] = {
                k: (w, int(np.prod(v[1:], dtype=np.int64)))
                for k, v in shapes.items()}
        c["draws"] = draws(w, 0, 0, None, **extra)

    def stage_scenario_view(c):
        """reads pstate.round; writes eff_adj (+ alive, fire, att_on with
        a scenario): the gossip round is the scenario's epoch."""
        if scenario is not None:
            view = epoch_view(scenario, c["pstate"].round)
            c["alive"], c["fire"], c["att_on"] = \
                view["alive"], view["fire"], view["attack_on"]
            base = view["adj"] if regen else adj_t
            c["eff_adj"] = base & view["link_ok"] \
                & c["alive"][None, :] & c["alive"][:, None]
        else:
            c["eff_adj"] = adj_t

    def stage_peer_sample(c):
        """reads eff_adj, pstate.conf, draws.gumbel; writes theta and
        sampled (without DTS every live peer is listened to and theta is
        the row-normalised adjacency)."""
        if cfg.use_dts:
            theta = dts_mod.sample_weights(c["pstate"].conf, c["eff_adj"],
                                           cfg.crelu_slope)
            c["sampled"] = dts_mod.sample_peers(
                c["draws"].gumbel.to(dev), theta, cfg.num_sampled)
        else:
            a = c["eff_adj"].float()
            theta = a / a.sum(1, keepdim=True).clamp_min(1)
            c["sampled"] = c["eff_adj"]
        c["theta"] = theta

    def stage_transport(c):
        """reads sampled, eff_adj, flat, pstate.wire_err, draws.wire_u;
        writes P, agg (per-pod dicts) and wire_err: the wire stack over the
        in-process backends or the cross-pod ring, or a robust rule."""
        pstate = c["pstate"]
        mask = (c["sampled"] & c["eff_adj"]) | eye
        c["mask"] = mask
        devices = [next(iter(f.values())).device for f in c["flat"]]
        if robust:
            c["agg"] = pods_mod.unstack(robust_mix(
                cfg.aggregation, mask, pods_mod.stack(c["flat"], dev),
                trim=cfg.robust_trim), devices)
            c["P"] = mask.float() / mask.sum(dim=1, keepdim=True)
            c["wire_err"] = c["flat_err"]
            return
        P = dynamic_mixing_matrix(c["sampled"], c["eff_adj"], sizes_t,
                                  cfg.aggregation)
        c["P"] = P
        if use_ef and c["flat_err"] is None:
            raise ValueError(
                "cfg enables gossip error feedback on a lossy wire but the "
                "pod state carries no residual buffers — build it with "
                "init_pod_state(..., wire_error=True)")
        c["agg"], err = transport.mix_pods(
            P, c["flat"], residual=c["flat_err"] if use_ef else None,
            wire_u=c["draws"].wire_u, round_=pstate.round)
        c["wire_err"] = err if use_ef else c["flat_err"]

    def stage_damage_check(c):
        """reads agg, pstate.{backup, best_loss}; writes eval_loss (the
        held-out self-eval of the candidate aggregate), damaged, and agg
        (damaged pods restore their backup: the pod time machine)."""
        pstate = c["pstate"]
        c["eval_loss"] = self_eval([pods_mod.rebuild(like, a) for like, a
                                    in zip(c["params"], c["agg"])]).to(dev)
        c["damaged"] = dts_mod.is_damaged(c["eval_loss"], pstate.best_loss)
        c["flat_backup"] = [pods_mod.flatten(b) for b in pstate.backup]
        c["agg"] = pods_mod.select(c["damaged"], c["flat_backup"], c["agg"])

    def stage_attack_inject(c):
        """reads agg, flat, att_on, theta, draws.kind_noise; writes out
        (actively attacking slots ship their poisoned send, built from
        the aggregate and their own pre-mix params; everyone else adopts
        the aggregate) and att_active."""
        if scenario is None:
            c["out"] = c["agg"]
            c["att_active"] = torch.zeros(w, dtype=torch.bool, device=dev)
            return
        devices = [next(iter(f.values())).device for f in c["flat"]]
        poisoned = poison_sends(
            c["draws"].kind_noise, scenario.kinds_present,
            scenario.attack_kind, scenario.attack_scale, c["att_on"],
            pods_mod.stack(c["agg"], dev), pods_mod.stack(c["flat"], dev),
            theta=c["theta"] if cfg.use_dts else None)
        att = torch.zeros_like(c["att_on"])
        for kind in model_kinds:
            att = att | (scenario.attack_kind == ATTACK_CODE[kind])
        c["att_active"] = att & c["att_on"]
        c["out"] = pods_mod.select(c["att_active"],
                                   pods_mod.unstack(poisoned, devices),
                                   c["agg"])

    def stage_trust_update(c):
        """reads losses, sampled, P, theta, out, flat, att_active,
        start_params, pstate.{conf, last_loss} (+ pstate.sketch on "corr"
        / "all"); writes conf (+ sketch). The observable of the geometry
        and correlation channels is each pod's local-train delta, the
        post-attack send minus ``start_params`` (the round displacement
        ``out − params`` without it)."""
        pstate = c["pstate"]
        damaged = c.get("damaged")
        if damaged is None:
            damaged = torch.zeros(w, dtype=torch.bool, device=dev)
        losses = c["losses"].to(dev)
        loss_trust = torch.where(
            damaged, torch.full_like(losses, dts_mod.DAMAGE_PENALTY),
            losses - pstate.last_loss)
        c["sketch"] = pstate.sketch
        if channels:
            if c["start_params"] is not None:
                sent = pods_mod.select(c["att_active"], c["out"], c["flat"])
                start = [pods_mod.flatten(p) for p in c["start_params"]]
                deltas = pods_mod.pod_vectors(sent, dev) \
                    - pods_mod.pod_vectors(start, dev)
            else:
                deltas = pods_mod.pod_vectors(c["out"], dev) \
                    - pods_mod.pod_vectors(c["flat"], dev)
            gmask = c["eff_adj"] & c["fire"][None, :] \
                if scenario is not None else c["eff_adj"]
            if corr:
                if pstate.sketch is None:
                    raise ValueError(
                        f"dts_signal={cfg.dts_signal!r} needs the sketch "
                        f"ring buffer — build the pod state with "
                        f"init_pod_state(..., sketch=sketch_shape(cfg))")
                c["sketch"] = dts_mod.update_sketch(pstate.sketch, deltas,
                                                    seed=cfg.seed)
            c["conf"] = dts_mod.geom_confidence_update(
                cfg.dts_signal, cfg.dts_geom_weight, pstate.conf,
                c["sampled"], c["P"], loss_trust, damaged, deltas, gmask,
                c["theta"], sketch=c["sketch"], lam_corr=cfg.dts_corr_weight)
        else:
            c["conf"] = pstate.conf - c["sampled"] * c["P"] \
                * loss_trust[:, None]

    def stage_finalize(c):
        """reads out, conf, losses, wire_err, sketch (+ fire, damaged,
        eval_loss); writes next (PodState) and new_params. With a
        scenario, non-firing pods freeze (sketch rows included); with the
        time machine, improving rounds refresh the backup (the ratchet)."""
        pstate = c["pstate"]
        losses = c["losses"].to(dev)
        backup, best_loss = c.get("flat_backup"), pstate.best_loss
        if time_machine:
            improved = (c["eval_loss"] < pstate.best_loss) & ~c["damaged"]
            backup = pods_mod.select(improved, c["out"], c["flat_backup"])
            best_loss = torch.where(improved, c["eval_loss"],
                                    pstate.best_loss)
        sketch = c["sketch"]
        out, wire_err = c["out"], c["wire_err"]
        conf, last_loss = c["conf"], losses
        if scenario is not None:
            fire = c["fire"]
            out = pods_mod.select(fire, c["out"], c["flat"])
            if use_ef:
                wire_err = pods_mod.select(fire, c["wire_err"],
                                           c["flat_err"])
            conf = torch.where(fire[:, None], c["conf"], pstate.conf)
            last_loss = torch.where(fire, losses, pstate.last_loss)
            if time_machine:
                backup = pods_mod.select(fire, backup, c["flat_backup"])
                best_loss = torch.where(fire, best_loss, pstate.best_loss)
            if corr:
                sketch = torch.where(fire[:, None, None], c["sketch"],
                                     pstate.sketch)
        def trees(flats):
            return [pods_mod.rebuild(like, f)
                    for like, f in zip(c["params"], flats)]
        c["next"] = PodState(
            conf=conf, last_loss=last_loss, round=pstate.round + 1,
            wire_err=None if wire_err is None else trees(wire_err),
            backup=trees(backup) if time_machine else pstate.backup,
            best_loss=best_loss, sketch=sketch)
        c["new_params"] = trees(out)

    stages = (
        ("split_draws", stage_split_draws),
        ("scenario_view", stage_scenario_view),
        ("peer_sample", stage_peer_sample),
        ("transport", stage_transport),
    ) + ((("damage_check", stage_damage_check),) if time_machine
         else ()) + (
        ("attack_inject", stage_attack_inject),
        ("trust_update", stage_trust_update),
        ("finalize", stage_finalize),
    )

    def gossip_round(pstate: PodState, params, losses, start_params=None):
        c = {"pstate": pstate, "params": params, "losses": losses,
             "start_params": start_params}
        run_pipeline(stages, c)
        return c["next"], c["new_params"]

    gossip_round.stages = stages
    return gossip_round


# ---------------------------------------------------------------------------
# Cross-device participation: enrolled population, sampled cohorts
# ---------------------------------------------------------------------------

@dataclass
class CrossDeviceState:
    """Population state of the cross-device path: every per-worker buffer
    of ``DeFTAState``, sized to the ENROLLED population N, plus the
    participation bookkeeping (when a user last fired, how often it has
    been observed, which global round each sketch slot came from)."""
    params: dict                 # stacked [N, ...] per-user models
    backup: dict                 # stacked [N, ...] time-machine backups
    conf: torch.Tensor           # [N, N] trust confidences
    best_loss: torch.Tensor      # [N]
    last_loss: torch.Tensor      # [N]
    epoch: torch.Tensor          # [N] int32 completed rounds per user
    last_part: torch.Tensor      # [N] int32 global round of the user's last
                                 # completed participation (the anchor of
                                 # the lazy confidence decay and staleness)
    obs: torch.Tensor            # [N] int32 completed participations
    wire_err: Optional[dict] = None        # EF21 residuals [N, ...]
    sketch: Optional[torch.Tensor] = None  # [N, R, S] sign-sketch ring
    sketch_round: Optional[torch.Tensor] = None
                                 # [N, R] int32 global-round stamp of each
                                 # ring slot (-1: never filled)


def init_cross_device_state(generator: torch.Generator, task: Task,
                            enrolled: int, *, wire_error: bool = False,
                            sketch=None) -> CrossDeviceState:
    """Fresh population state on the generator's device, parameters drawn
    from it as ``init_state`` draws them. ``sketch``: the (R, S) dims from
    ``sketch_shape(cfg)`` when the correlation channel is on, else None.
    Stamps start at -1: an empty slot never stamp-matches, so a fresh user
    carries no correlation evidence."""
    dev = generator.device
    params = task.init(generator, enrolled)
    return CrossDeviceState(
        params=params,
        backup={k: v.clone() for k, v in params.items()},
        conf=torch.zeros(enrolled, enrolled, device=dev),
        best_loss=torch.full((enrolled,), float("inf"), device=dev),
        last_loss=torch.zeros(enrolled, device=dev),
        epoch=torch.zeros(enrolled, dtype=torch.int32, device=dev),
        last_part=torch.zeros(enrolled, dtype=torch.int32, device=dev),
        obs=torch.zeros(enrolled, dtype=torch.int32, device=dev),
        wire_err={k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in params.items()} if wire_error else None,
        sketch=torch.zeros((enrolled,) + tuple(sketch), device=dev)
        if sketch else None,
        sketch_round=torch.full((enrolled, sketch[0]), -1,
                                dtype=torch.int32, device=dev)
        if sketch else None,
    )


def _gather(tree, ix):
    """Rows ``ix`` of every leaf (None passes through)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: v.index_select(0, ix) for k, v in tree.items()}
    return tree.index_select(0, ix)


def build_cross_device_round(task: Task, cfg: DeFTAConfig,
                             train: TrainConfig, world, sizes, *, draws,
                             device, gossip_backend: str = "auto",
                             num_classes: int = 0, telemetry=None,
                             shard=None):
    """The cross-device round: ``participation`` gathers the round's
    k-member cohort out of the enrolled population, the dense stages run
    on the [k, k] block, and ``scatter_merge`` writes the firing members'
    rows back. Returns round(state, data, epoch) -> state, ``epoch`` the
    global round t (a Python int). ``world`` is a
    ``scenarios.cross_device.CompiledWorld``; ``sizes`` the enrolled
    users' dataset sizes; ``draws`` the ``rng.Draws`` provider, asked once
    a round for the cohort (W = k).

    As in the reference: a mid-round dropout leaves ``eff_adj`` before the
    mixing matrix is normalised and does not fire; a straggler trains and
    is mixed from but does not fire; a row with fewer than
    ``world.k_min`` surviving sampled peers mixes as the identity; a
    vacancy pad slot is masked out of everything. Gathered confidence rows
    decay by ``cfg.dts_conf_decay ** (t - last_part)``, written back only
    on fire, so an absent user's rows stay bit-unchanged; the correlation
    channel scores stamp-aligned sketch slots (``dts.stamped_correlation``,
    ``cfg.dts_min_obs``); ``cfg.max_staleness`` drops peers whose last
    completed participation is more than S rounds old.

    The population buffers are updated in place (``index_copy_`` on the
    cohort's rows, which are distinct within a round: no atomics), as the
    reference's donated scan carry is: the state passed in is consumed.
    The cohort block has no static support, so ``auto`` runs the dense
    mix; under secagg the support is all-ones [k, k] and the masked
    gather mix runs instead (no kernel).

    ``telemetry``: a ``telemetry.Telemetry`` registry; the round then
    declares ``cross_device_specs`` (cohort, occupancy, dropout, straggler
    and scatter-write counts, then the transport, damage, train and trust
    probes on the [k, k] block) and returns ``(state, frame)``.

    ``shard`` (a ``sharding.WorkerShards``, ``device`` its first device):
    the population buffers are lists of row blocks of the enrolled N
    (``WorkerShards.shard_leading``); ``participation`` gathers each
    cohort row from the block that owns it, the dense k-block runs on
    ``device`` (the reference replicates it; the numbers are the same)
    and ``scatter_merge`` writes each row back to its owner. Which block
    owns which cohort slot is read from the compiled timeline on the host
    at build time."""
    channels = resolve_dts_signal(cfg)
    if world.epochs <= 0:
        raise ValueError("cross-device world compiled for 0 rounds")
    if "label_flip" in world.kinds_present and num_classes <= 0:
        raise ValueError("label_flip cross-device world needs "
                         "num_classes > 0")
    if cfg.aggregation in ROBUST_RULES:
        raise ValueError(
            f"robust aggregation ({cfg.aggregation!r}) has no "
            f"cross-device selection yet — use defta/defl/uniform")
    check_supported(cfg, shard=shard)
    corr = "corr" in channels
    dev = torch.device(device)
    k = int(world.sample_k)
    k_min = int(world.k_min)
    max_staleness = int(cfg.max_staleness)
    decay = float(cfg.dts_conf_decay)
    decay_t = torch.tensor(decay, dtype=torch.float32, device=dev)
    ltrain = local_train_fn(task, train, cfg.local_epochs,
                            dp_clip=cfg.dp_clip, dp_sigma=cfg.dp_sigma)
    # the cohort block has no static support, except under secagg, whose
    # per-edge pads need one: every cohort-slot pair is a potential wire
    # edge (pads are keyed on (round, slot, slot), so two users holding
    # one slot in different rounds never share a pad)
    transport = make_transport(
        cfg, backend=gossip_backend,
        adjacency=np.ones((k, k), bool) if cfg.secagg is not None else None)
    use_ef = transport.use_ef
    dp_update = uses_update_dp(cfg)
    masked_geom = cfg.secagg is not None \
        and cfg.secagg_mode == "masked_geom"
    noise_kinds = tuple(kk for kk in world.kinds_present
                        if kk in RANDOM_ATTACKS)

    def on_dev(a, dtype=None):
        t = torch.as_tensor(np.asarray(a))
        return t.to(device=dev, dtype=dtype or t.dtype)
    sizes_t = on_dev(np.asarray(sizes, np.float32))
    part_ix = on_dev(world.part_ix, torch.int64)         # [T, k]
    filled_t = on_dev(world.filled)                      # [T, k] bool
    survive_t = on_dev(world.survive)
    complete_t = on_dev(world.complete)
    adj_t = on_dev(world.adj)                            # [T, k, k] bool
    att_kind_u = on_dev(world.attack_kind)               # [N] int32
    att_scale_u = on_dev(world.attack_scale)             # [N] float32
    eye_k = torch.eye(k, dtype=torch.bool, device=dev)
    n_users = int(world.enrolled)
    bounds = shard.bounds(n_users) if shard is not None \
        else [(0, n_users, dev)]
    # per round: each block's (cohort slots it owns, on the device; their
    # rows in the block, on the block's device), and the order that puts
    # the blocks' gathered rows back in cohort order
    owners = []
    if len(bounds) > 1:
        for t in range(world.epochs):
            ixt = np.asarray(world.part_ix[t], np.int64)
            per, slots = [], []
            for r0, r1, bdev in bounds:
                pos = np.flatnonzero((ixt >= r0) & (ixt < r1))
                per.append((on_dev(pos, torch.int64),
                            torch.as_tensor(ixt[pos] - r0).to(bdev)))
                slots.append(pos)
            owners.append((per, on_dev(np.argsort(np.concatenate(slots),
                                                  kind="stable"),
                                       torch.int64)))

    def gather_rows(blocks, t, ix):
        """Rows ``ix`` (the cohort of round t) of a population buffer held
        as row blocks, in cohort order on ``device``."""
        if blocks[0] is None:
            return None
        if len(blocks) == 1:
            return _gather(blocks[0], ix)
        per, order = owners[t]
        parts = [_gather(b, loc) for b, (_, loc) in zip(blocks, per)]
        if isinstance(parts[0], dict):
            return {name: torch.cat([p[name].to(dev) for p in parts])
                    .index_select(0, order) for name in parts[0]}
        return torch.cat([p.to(dev) for p in parts]).index_select(0, order)

    def scatter_rows(blocks, t, ix, rows):
        """Write the cohort's ``rows`` back into the blocks that own them
        (in place); returns the blocks."""
        if len(blocks) == 1:
            per = [(None, ix)]
        else:
            per = owners[t][0]
        for b, (pos, loc) in zip(blocks, per):
            part = rows if pos is None else _gather(rows, pos)
            if isinstance(b, dict):
                for name, v in b.items():
                    v.index_copy_(0, loc, part[name].to(v.device))
            else:
                b.index_copy_(0, loc, part.to(b.device))
        return blocks
    if telemetry is not None:
        telemetry.declare(*cross_device_specs(k, use_ef=use_ef))
        tm_specs = telemetry.specs
        off_k = ~eye_k

    # ---- stages -----------------------------------------------------------

    def stage_participation(c):
        """reads epoch (the global round t), state.*, data; writes ix (the
        cohort), active / fire (filled ∧ survive, ∧ complete), eff_adj (the
        survivor-masked cohort topology, minus stale peers), the gathered
        g_* k-blocks of every population buffer (confidence rows decayed
        by the rounds since their user last fired; conf the [k, k] block)
        and the gathered data shards and attack assignment. t indexes the
        compiled timeline on the host: nothing is read back."""
        blocks = _blocks(c["state"], c["data"], len(bounds))
        c["blocks"] = bs = [b["state"] for b in blocks]
        c["data_blocks"] = [b["data"] for b in blocks]
        t = c["epoch"]
        ix = part_ix[t]
        c["ix"] = ix
        active = filled_t[t] & survive_t[t]
        c["active"] = active
        c["fire"] = active & complete_t[t]

        def g(field):
            return gather_rows([getattr(b, field) for b in bs], t, ix)
        c["g_params"] = g("params")
        c["g_backup"] = g("backup")
        c["g_wire_err"] = g("wire_err") if use_ef else None
        c["g_epoch"] = g("epoch")
        c["g_last_part"] = g("last_part")
        c["g_conf_raw"] = g("conf")                           # [k, N]
        rows = c["g_conf_raw"]
        if decay < 1.0:
            gap = (t - c["g_last_part"]).clamp_min(0).float()
            rows = rows * decay_t.pow(gap)[:, None]
        c["g_conf_rows"] = rows
        c["conf"] = rows.index_select(1, ix)                  # [k, k]
        c["g_best"] = g("best_loss")
        c["g_last"] = g("last_loss")
        c["g_obs"] = g("obs")
        if corr:
            c["g_sketch"] = g("sketch")
            c["g_stamp"] = g("sketch_round")
        for key in ("x", "y", "mask"):
            c[f"g_{key}"] = gather_rows([d[key] for d in c["data_blocks"]],
                                        t, ix)
        c["g_sizes"] = _gather(sizes_t, ix)
        c["att_kind"] = _gather(att_kind_u, ix)
        c["att_scale"] = _gather(att_scale_u, ix)
        c["att_on"] = active & (c["att_kind"] > 0)
        eff = adj_t[t] & active[None, :] & active[:, None]
        if max_staleness:
            fresh = (t - c["g_last_part"]) <= max_staleness
            eff = eff & fresh[None, :]
        c["eff_adj"] = eff
        if telemetry is not None:
            telemetry.emit(c, "round", t)
            telemetry.emit(c, "cohort", ix)
            telemetry.emit(c, "occupancy", active.sum())
            telemetry.emit(c, "dropout_count",
                           (filled_t[t] & ~survive_t[t]).sum())
            telemetry.emit(c, "straggler_count",
                           (active & ~complete_t[t]).sum())
            telemetry.emit(c, "fire", c["fire"])
            telemetry.emit(c, "scatter_writes", c["fire"].sum())

    def stage_split_draws(c):
        """reads g_params (the leaves' shapes), g_x (the shard size);
        writes draws for the cohort (W = k): Gumbel rows, minibatch
        permutations and, gated at build time, the random attack kinds'
        noise, the stochastic wire's uniforms and the DP normals, in one
        provider call."""
        n = c["g_x"].shape[1]
        c["draws"] = draws(k, cfg.local_epochs, n, None, **_draw_shapes(
            {kk: tuple(v.shape) for kk, v in c["g_params"].items()}, cfg,
            train, k, n, transport, noise_kinds))

    def stage_peer_sample(c):
        """reads conf (the decayed k-block), eff_adj, draws.gumbel; writes
        theta and sampled over the cohort."""
        if cfg.use_dts:
            theta = dts_mod.sample_weights(c["conf"], c["eff_adj"],
                                           cfg.crelu_slope)
        else:
            a = c["eff_adj"].float()
            theta = a / a.sum(1, keepdim=True).clamp_min(1)
        c["theta"] = theta
        c["sampled"] = dts_mod.sample_peers(c["draws"].gumbel, theta,
                                            cfg.num_sampled)

    def stage_transport(c):
        """reads sampled, eff_adj, g_sizes, g_params, g_wire_err,
        draws.wire_u; writes P, agg and wire_err. P renormalises over the
        survivors; a row with fewer than k_min surviving sampled peers is
        the identity."""
        P = dynamic_mixing_matrix(c["sampled"], c["eff_adj"], c["g_sizes"],
                                  cfg.aggregation)
        if k_min > 1:
            npeers = (c["sampled"] & c["eff_adj"] & ~eye_k).sum(dim=1)
            P = torch.where((npeers >= k_min)[:, None], P, eye_k.float())
        c["P"] = P
        if telemetry is not None:
            live = (c["sampled"] & c["eff_adj"] & off_k).sum()
            telemetry.emit(c, "edges", live)
            telemetry.emit(c, "wire_bytes", live.float()
                           * stacked_payload_bytes(c["g_params"],
                                                   transport.wire))
        wire_u = c["draws"].wire_u
        if use_ef:
            c["agg"], c["wire_err"] = transport.mix(
                P, c["g_params"], residual=c["g_wire_err"], wire_u=wire_u,
                round_=c["epoch"])
            if telemetry is not None:
                telemetry.emit(c, "ef_norm", torch.linalg.norm(
                    dts_mod.flatten_stacked(c["wire_err"]), dim=1))
        else:
            c["agg"] = transport.mix(P, c["g_params"], wire_u=wire_u,
                                     round_=c["epoch"])
            c["wire_err"] = c["g_wire_err"]

    def stage_damage_check(c):
        """reads agg, g_x, g_y, g_mask, g_best, g_backup, att_kind,
        att_on; writes y_data, loss_agg, damaged and start, as the dense
        round does on the cohort."""
        y = c["g_y"]
        if "label_flip" in world.kinds_present:
            lf = (c["att_kind"] == LABEL_FLIP_CODE) & c["att_on"]
            y = flip_labels(y, lf, num_classes)
        c["y_data"] = y
        c["loss_agg"] = task.loss(c["agg"], c["g_x"], y,
                                  c["g_mask"]).detach()
        if cfg.time_machine:
            c["damaged"] = dts_mod.is_damaged(c["loss_agg"], c["g_best"])
            c["start"] = tree_select(c["damaged"], c["g_backup"], c["agg"])
        else:
            c["damaged"] = torch.zeros_like(c["loss_agg"], dtype=torch.bool)
            c["start"] = c["agg"]
        if telemetry is not None:
            telemetry.emit(c, "loss_agg", c["loss_agg"])

    def stage_local_train(c):
        """reads start, g_x, y_data, g_mask, draws.perm (+ draws.dp_sgd
        under DP-SGD); writes trained and train_loss."""
        c["trained"], c["train_loss"] = ltrain(
            c["draws"].perm, c["start"], c["g_x"], c["y_data"], c["g_mask"],
            c["draws"].dp_sgd)
        if telemetry is not None:
            telemetry.emit(c, "train_loss", c["train_loss"])

    def stage_dp_noise(c):
        """reads trained, start, draws.dp_update; writes trained: the dense
        round's update-DP stage on the cohort block."""
        c["trained"] = apply_update_dp(cfg, c["draws"].dp_update,
                                       c["start"], c["trained"])

    def stage_attack_inject(c):
        """reads trained, agg, att_kind, att_scale, att_on, theta,
        draws.kind_noise; writes trained. An attacker attacks whenever it
        participates."""
        if world.kinds_present:
            c["trained"] = poison_sends(
                c["draws"].kind_noise, world.kinds_present, c["att_kind"],
                c["att_scale"], c["att_on"], c["agg"], c["trained"],
                theta=c["theta"] if cfg.use_dts else None)

    def stage_trust_update(c):
        """reads conf, sampled, P, theta, eff_adj, fire, loss_agg, damaged,
        g_last, g_best, g_backup, trained, start (+ g_sketch, g_stamp on
        the correlation channel); writes conf_new, backup, best_loss,
        last_loss (+ sketch, stamp). The dense trust update on the cohort,
        its correlation channel swapped for the sparse-observation one:
        the ring buffer rotates with a stamp column holding t, and pairs
        with fewer than ``cfg.dts_min_obs`` stamp-matched slots join
        neither the suspicion nor its median + MAD baseline. Under
        ``masked_geom`` the pooled signal only: the ring buffer does not
        rotate and the stamps pass through unchanged."""
        loss_trust = torch.where(c["damaged"],
                                 torch.full_like(c["loss_agg"],
                                                 dts_mod.DAMAGE_PENALTY),
                                 c["loss_agg"] - c["g_last"])
        deltas = None
        if channels and masked_geom:
            deltas = dts_mod.flatten_stacked(c["trained"]) \
                - dts_mod.flatten_stacked(c["start"])
            gmask = c["eff_adj"] & c["fire"][None, :]
            mg = dts_mod.masked_geom_trust(deltas, c["P"], gmask)
            if corr:
                c["sketch"], c["stamp"] = c["g_sketch"], c["g_stamp"]
            c["conf_new"] = c["conf"] - c["sampled"] * c["P"] \
                * (loss_trust + cfg.dts_geom_weight * mg)[:, None]
        elif channels:
            deltas = dts_mod.flatten_stacked(c["trained"]) \
                - dts_mod.flatten_stacked(c["start"])
            gmask = c["eff_adj"] & c["fire"][None, :]
            gs = dts_mod.geom_scores(deltas, gmask, weights=c["theta"]) \
                if "geom" in channels else None
            cs = None
            if corr:
                c["sketch"] = dts_mod.update_sketch(c["g_sketch"], deltas,
                                                    seed=cfg.seed)
                c["stamp"] = torch.cat(
                    [c["g_stamp"][:, 1:],
                     torch.full((k, 1), c["epoch"], dtype=torch.int32,
                                device=dev)], dim=1)
                cmat, valid = dts_mod.stamped_correlation(
                    c["sketch"], c["stamp"], min_obs=cfg.dts_min_obs)
                cs = dts_mod.correlation_suspicion(
                    cmat, gmask, weights=c["theta"], valid=valid)
            signal = dts_mod.fused_trust_signal(
                cfg.dts_signal, loss_trust, gs, c["damaged"],
                cfg.dts_geom_weight, corr=cs, lam_corr=cfg.dts_corr_weight)
            c["conf_new"] = c["conf"] - c["sampled"] * c["P"] * signal
        else:
            c["conf_new"] = c["conf"] - c["sampled"] * c["P"] \
                * loss_trust[:, None]
        if telemetry is not None:
            if deltas is None:
                deltas = dts_mod.flatten_stacked(c["trained"]) \
                    - dts_mod.flatten_stacked(c["start"])
            telemetry.emit(c, "loss_trust", loss_trust)
            telemetry.emit(c, "conf_in", c["conf_new"].mean(dim=0))
            telemetry.emit(c, "update_norm", torch.linalg.norm(deltas,
                                                               dim=1))
        improved = (c["loss_agg"] < c["g_best"]) & ~c["damaged"]
        c["backup"] = tree_select(improved | c["damaged"], c["trained"],
                                  c["g_backup"])
        c["best_loss"] = torch.where(improved, c["loss_agg"], c["g_best"])
        c["last_loss"] = torch.where(c["damaged"], c["g_last"],
                                     c["loss_agg"])

    def stage_scatter_merge(c):
        """reads fire and every updated cohort buffer; writes next (the
        population state, updated in place). Gated on fire: a cohort member
        that does not fire writes back its original, undecayed rows, so
        every carried buffer (trust, EF21 residuals, sketch, stamps) is
        unchanged across a round its user misses."""
        bs, t, ix, fire = c["blocks"], c["epoch"], c["ix"], c["fire"]

        def scat(field, new_rows, old_rows):
            blocks = [getattr(b, field) for b in bs]
            if isinstance(new_rows, dict):
                sel = tree_select(fire, new_rows, old_rows)
            else:
                f = fire.reshape((-1,) + (1,) * (new_rows.ndim - 1))
                sel = torch.where(f, new_rows, old_rows)
            return scatter_rows(blocks, t, ix, sel)

        rows_new = c["g_conf_rows"].index_copy(1, ix, c["conf_new"])
        fire_i = fire.to(torch.int32)
        fields = dict(
            params=scat("params", c["trained"], c["g_params"]),
            backup=scat("backup", c["backup"], c["g_backup"]),
            conf=scat("conf", rows_new, c["g_conf_raw"]),
            best_loss=scat("best_loss", c["best_loss"], c["g_best"]),
            last_loss=scat("last_loss", c["last_loss"], c["g_last"]),
            epoch=scatter_rows([b.epoch for b in bs], t, ix,
                               c["g_epoch"] + fire_i),
            last_part=scat("last_part", torch.full_like(c["g_last_part"], t),
                           c["g_last_part"]),
            obs=scatter_rows([b.obs for b in bs], t, ix, c["g_obs"] + fire_i),
            wire_err=scat("wire_err", c["wire_err"], c["g_wire_err"])
            if use_ef else [b.wire_err for b in bs],
            sketch=scat("sketch", c["sketch"], c["g_sketch"])
            if corr else [b.sketch for b in bs],
            sketch_round=scat("sketch_round", c["stamp"], c["g_stamp"])
            if corr else [b.sketch_round for b in bs])
        nxt = [CrossDeviceState(**{f: v[i] for f, v in fields.items()})
               for i in range(len(bs))]
        c["next"] = nxt if isinstance(c["state"], list) else nxt[0]

    stages = (
        ("participation", stage_participation),
        ("split_draws", stage_split_draws),
        ("peer_sample", stage_peer_sample),
        ("transport", stage_transport),
        ("damage_check", stage_damage_check),
        ("local_train", stage_local_train),
    ) + ((("dp_noise", stage_dp_noise),) if dp_update else ()) + (
        ("attack_inject", stage_attack_inject),
        ("trust_update", stage_trust_update),
        ("scatter_merge", stage_scatter_merge),
    )

    def round(state, data, epoch=None):
        if epoch is None:
            raise ValueError("the cross-device round needs the global "
                             "round t (epoch=)")
        c = {"state": state, "data": data, "epoch": int(epoch)}
        run_pipeline(stages, c)
        if telemetry is None:
            return c["next"]
        return c["next"], telemetry.collect(c, tm_specs)

    round.stages = stages
    round.telemetry = telemetry
    round.bounds = bounds
    return round


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def _state_device(state) -> torch.device:
    """The device of the state's tensors (of its first block, for a list
    of row blocks). Serves every state: the first field that holds a
    tensor, or a dict of them, names it."""
    if isinstance(state, list):
        state = state[0]
    for v in vars(state).values():
        t = next(iter(v.values()), None) if isinstance(v, dict) else v
        if isinstance(t, torch.Tensor):
            return t.device
    raise ValueError("state holds no tensor")


def _synchronize(state) -> None:
    """Wait for every card that holds the state's tensors (a no-op on the
    CPU)."""
    blocks = state if isinstance(state, list) else [state]
    for dev in {_state_device(b) for b in blocks}:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def _place(shard, state, data, rows: Optional[int]):
    """The drivers' placement rule: with a ``WorkerShards``, the state
    (and the data, when given as one whole dict) as row blocks of its
    ``rows`` workers (default: the state's conf rows), and a function
    that gives a state of blocks back whole."""
    if shard is None:
        return state, data, lambda st: st
    n = rows if rows is not None else state.conf.shape[0]
    if data is not None and not isinstance(data, list):
        data = shard.shard_leading(data, n)
    return (shard.shard_leading(state, n), data,
            lambda st: shard.gather_leading(st, n))


class _FrameChunk:
    """One driver chunk's telemetry buffers on the device: ``[n, ...]``
    per probe (``Telemetry.zero_buffers``), the ``round`` column made by
    one ``arange`` over the chunk's stamps (the one probe the host knows:
    no device tensor is built from a Python int per round), every other
    probe written in place round by round. On the card ``stage`` queues
    one asynchronous copy per probe into pinned host memory before the
    chunk's synchronize, so reading the frames adds no synchronisation."""

    def __init__(self, telemetry, start: int, n: int, device):
        self.start = start
        self.bufs = telemetry.zero_buffers(n, device=device)
        if "round" in self.bufs:
            self.bufs["round"] = torch.arange(start, start + n,
                                              dtype=torch.int32,
                                              device=device)
        self.host = self.bufs

    def write(self, i: int, frame: dict) -> None:
        for name, v in frame.items():
            if name != "round":
                self.bufs[name][i].copy_(v)

    def stage(self) -> None:
        if next(iter(self.bufs.values())).is_cuda:
            self.host = {k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=True).copy_(
                                            v, non_blocking=True)
                         for k, v in self.bufs.items()}

    def flush(self, led: RunLedger) -> None:
        """Hand the chunk's rounds to the ledger (after the chunk's
        synchronize), the probes in sorted name order: the reference's
        frames come back from its scan as a JAX pytree, whose dict keys
        are sorted, and its JSONL rows and ``ledger.names()`` follow that
        order."""
        led.record_frames(dict(sorted(gather_frames(self.host).items())),
                          self.start)


def drive_epochs(rnd_fn, state, data, epochs: int, *, eval_every: int = 0,
                 eval_fn=None, ledger: Optional[RunLedger] = None,
                 shard=None, shard_rows: Optional[int] = None):
    """Run ``epochs`` rounds in a Python loop, in chunks bounded by eval
    points (the DeFTA, the FedAvg and the cross-device round alike). Each
    chunk ends in a device synchronize and is recorded in the
    ``RunLedger`` with its wall-clock seconds (``ledger.superstep_s``;
    ``ledger.as_stats()`` gives ``{"dispatches": chunks, "epochs": e}``:
    the port's ledger counts host chunks, not XLA dispatches). When the
    round carries a telemetry registry (``rnd_fn.telemetry``), its frames
    are written into the chunk's device buffers and gathered into the
    ledger once a chunk, stamped with their epochs.
    ``eval_fn(state, done_epochs)`` runs at eval boundaries; its results
    form the returned history. Returns ``(state, history)``.

    With ``shard`` (a ``sharding.WorkerShards``, the round built with it)
    the state and data are placed as row blocks of ``shard_rows`` workers
    (default: the state's conf rows) before the first chunk; ``eval_fn``
    sees, and the driver returns, the state reassembled whole on shard
    0's device, and the round's frames are already in the global layout,
    so ledger rows do not depend on the shard count."""
    led = ledger if ledger is not None else RunLedger()
    telemetry = getattr(rnd_fn, "telemetry", None)
    history = []
    state, data, whole = _place(shard, state, data, shard_rows)
    chunk = eval_every if (eval_every and eval_fn is not None) else epochs
    done = 0
    while done < epochs:
        n = min(chunk, epochs - done)
        t0 = time.perf_counter()
        if telemetry is None:
            for e in range(done, done + n):
                state = rnd_fn(state, data, e)
        else:
            frames = _FrameChunk(telemetry, done, n, _state_device(state))
            for i in range(n):
                state, frame = rnd_fn(state, data, done + i)
                frames.write(i, frame)
            frames.stage()
        _synchronize(state)
        led.record_dispatch(n, time.perf_counter() - t0)
        if telemetry is not None:
            frames.flush(led)
        done += n
        if eval_every and done % eval_every == 0 and eval_fn is not None:
            history.append(eval_fn(whole(state), done))
    led.finish("epochs", epochs)
    return whole(state), history


def drive_ticks(tick_fn, state: DeFTAState, ticks: int, *, check_every: int,
                required: np.ndarray, target_epochs: int = 0,
                ledger: Optional[RunLedger] = None, shard=None,
                shard_rows: Optional[int] = None) -> DeFTAState:
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
    dispatch count. With a telemetry-built tick (``tick_fn.telemetry``)
    each chunk's frames go to the ledger after it, so an early exit leaves
    exactly the ticks that ran, stamped 0 .. ran - 1, as the reference's
    trimmed buffers do. With ``shard`` the state is placed as row blocks
    (``drive_epochs``; ``run_async_defta`` places the tick's data), the
    check reads the epoch vector gathered, and the final state comes back
    whole on shard 0's device. Returns the final state."""
    led = ledger if ledger is not None else RunLedger()
    telemetry = getattr(tick_fn, "telemetry", None)
    chunk = check_every if target_epochs else max(ticks, 1)
    state, _, whole = _place(shard, state, None, shard_rows)
    home = _state_device(state)
    req = None
    if target_epochs:
        req = torch.as_tensor(np.asarray(required, bool)).to(home)
    done = 0
    while done < ticks:
        if req is not None:
            ep = _cat([b.epoch for b in state], home) \
                if isinstance(state, list) else state.epoch
            if bool((ep[req] >= target_epochs).all()):
                break
        n = min(chunk, ticks - done)
        t0 = time.perf_counter()
        if telemetry is None:
            for t in range(done, done + n):
                state = tick_fn(state, t)
        else:
            frames = _FrameChunk(telemetry, done, n, _state_device(state))
            for i in range(n):
                state, frame = tick_fn(state, done + i)
                frames.write(i, frame)
            frames.stage()
        _synchronize(state)
        led.record_dispatch(n, time.perf_counter() - t0)
        if telemetry is not None:
            frames.flush(led)
        done += n
    led.finish("ticks", ticks)
    return whole(state)
