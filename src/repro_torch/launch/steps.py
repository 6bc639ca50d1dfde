"""Step builders for the launcher (the port of ``repro.launch.steps``):

* ``build_train_step``: forward + backward + optimizer update of one model
  (micro-batched gradient accumulation optional).
* ``build_fl_train_step`` / ``build_gossip_step``: LM training across
  pods. The pod axis is a list of per-pod trees (``core.pods``), pod p's
  on its own device; each pod trains on its own batch shard with no
  cross-pod traffic, and the gossip step mixes the pods' params with the
  outdegree-corrected matrix P.
* ``build_pod_gossip_step``: the multi-pod DeFTA gossip round as the
  engine's stage pipeline (``core.engine.build_pod_round``).
* ``build_prefill_step`` / ``build_decode_step``: serving.

The reference vmaps its train step over the pod axis. ``torch.func.vmap``
cannot map a kernel called through ``ctypes``, so the FL step is a loop
over pods, each on its pod's device: a step launches the flash kernel
pods x layers times (forward only: its gradient is the plain version's,
``kernels.ops.flash_attention``). The reference's abstract-input and
sharding builders cost a TPU mesh and are not ported (ROADMAP.md queue
1a, item 12).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import pods as pods_mod
from repro_torch.core.gossip import normalize_wire
from repro_torch.models import model as model_mod


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _device_of(tree) -> torch.device:
    return next(iter(pods_mod.flatten(tree).values())).device


def build_train_step(cfg: ModelConfig, optimizer, *, moe_strategy="grouped",
                     microbatches: int = 1, accum_dtype=torch.float32):
    """fwd + bwd + update: ``train_step(params, opt_state, step, batch) ->
    (params, opt_state, step + 1, loss)``. ``microbatches > 1`` splits the
    leading batch dim and accumulates the gradients in ``accum_dtype``
    (fp32 by default), then divides by the count and casts to each
    parameter's dtype, as the reference's scan does; the loss is the
    micro-batches' mean."""
    def grads_of(params, batch):
        flat = pods_mod.flatten(params)
        leaves = {k: v.detach().requires_grad_() for k, v in flat.items()}
        loss, _ = model_mod.loss_fn(pods_mod.rebuild(params, leaves), cfg,
                                    batch, moe_strategy=moe_strategy)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), pods_mod.rebuild(params, {
            k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(leaves.items(), grads)})

    def train_step(params, opt_state, step, batch):
        if microbatches == 1:
            loss, grads = grads_of(params, batch)
        else:
            acc, losses = None, []
            for i in range(microbatches):
                one = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                    + tuple(v.shape[1:]))[i]
                       for k, v in batch.items()}
                loss_i, g = grads_of(params, one)
                losses.append(loss_i)
                g = pods_mod.flatten(g)
                acc = {k: v.to(accum_dtype) for k, v in g.items()} \
                    if acc is None else {k: acc[k] + g[k].to(accum_dtype)
                                         for k in acc}
            flat = pods_mod.flatten(params)
            grads = pods_mod.rebuild(params, {
                k: (acc[k] / microbatches).to(flat[k].dtype) for k in acc})
            loss = torch.stack(losses).mean()
        params, opt_state = optimizer.update(params, grads, opt_state, step)
        return params, opt_state, step + 1, loss
    return train_step


def build_fl_train_step(cfg: ModelConfig, optimizer, *,
                        moe_strategy="grouped", microbatches: int = 1,
                        accum_dtype=torch.float32):
    """The train step over pods: ``fl_step(pod_params, pod_opt, step,
    batch) -> (pod_params, pod_opt, step + 1, losses)``. ``pod_params`` and
    ``pod_opt`` are lists of per-pod trees (pod p's on its device);
    ``batch`` a dict of [npods, per_pod_batch, ...] arrays or tensors, pod
    p training on row p, copied to its device. ``losses`` is [npods] on
    pod 0's device."""
    inner = build_train_step(cfg, optimizer, moe_strategy=moe_strategy,
                             microbatches=microbatches,
                             accum_dtype=accum_dtype)

    def fl_step(pod_params, pod_opt, step, batch):
        new_p, new_o, losses = [], [], []
        for p, (params, opt) in enumerate(zip(pod_params, pod_opt)):
            dev = _device_of(params)
            b = {k: torch.as_tensor(v[p]).to(dev) for k, v in batch.items()}
            p2, o2, _, loss = inner(params, opt, step, b)
            new_p.append(p2)
            new_o.append(o2)
            losses.append(loss)
        dev0 = _device_of(pod_params[0])
        return new_p, new_o, step + 1, torch.stack([x.to(dev0)
                                                    for x in losses])
    return fl_step


# ---------------------------------------------------------------------------
# Gossip across pods
# ---------------------------------------------------------------------------

def build_gossip_step(cfg: ModelConfig, *, wire=None, backend: str = "einsum",
                      adjacency=None, error_feedback: bool = False,
                      wire_round: str = "nearest"):
    """One DeFTA aggregation across pods: params <- P @ params, P the
    [npods, npods] mixing matrix, through the in-process transport's
    ``mix_pods`` (``core.engine.make_transport``: the ``mix_pytree``
    backends on the pods' rows stacked onto P's device, the mixed rows
    back on the pods' devices).

    ``gossip_step(pod_params, mix, wire_u=None) -> pod_params``; with
    ``error_feedback`` ``gossip_step(pod_params, mix, wire_err,
    wire_u=None) -> (pod_params, wire_err')``, the EF21 residuals a list of
    per-pod fp32 trees (zeros at step 0). ``wire_round="stochastic"``
    (int8 only) reads ``wire_u``, the per-leaf [npods, F] uniforms keyed by
    the leaves' "/"-joined paths (``core.pods.flatten``), where the
    reference takes a key."""
    del cfg                                  # signature parity
    from repro_torch.config import DeFTAConfig
    from repro_torch.core.engine import make_transport

    if wire_round == "stochastic" and normalize_wire(wire) != "int8":
        raise ValueError("wire_round='stochastic' is an int8-wire option "
                         f"(wire={normalize_wire(wire)!r})")
    mix_pods = make_transport(
        DeFTAConfig(gossip_dtype=wire, gossip_error_feedback=error_feedback,
                    gossip_wire_round=wire_round),
        backend=backend, adjacency=adjacency).mix_pods

    def mix(pod_params, P, wire_err, wire_u):
        flats = [pods_mod.flatten(p) for p in pod_params]
        res = None if wire_err is None else \
            [pods_mod.flatten(e) for e in wire_err]
        mixed, err = mix_pods(P, flats, residual=res, wire_u=wire_u)
        def trees(rows):
            return [pods_mod.rebuild(like, f)
                    for like, f in zip(pod_params, rows)]
        if err is None:
            return trees(mixed)
        return trees(mixed), trees(err)

    if error_feedback:
        def gossip_step(pod_params, P, wire_err, wire_u=None):
            return mix(pod_params, P, wire_err, wire_u)
    else:
        def gossip_step(pod_params, P, wire_u=None):
            return mix(pod_params, P, None, wire_u)
    return gossip_step


def build_pod_gossip_step(cfg: ModelConfig, defta_cfg, npods: int, sizes, *,
                          adjacency, draws, transport: str = "in_jit",
                          backend: str = "einsum", pods=None, scenario=None,
                          self_eval=None, device=None):
    """The multi-pod DeFTA gossip round as the engine's stage pipeline
    (``core.engine.build_pod_round``): scenario_view -> peer_sample (DTS)
    -> transport -> [damage_check] -> attack_inject -> trust_update over the
    pod axis.

    ``transport="ppermute"`` ships the encoded payloads on the cross-pod
    ring (``gossip.mix_pytree_ppermute``) between ``pods``, the list of
    pod devices (the reference's mesh); ``"in_jit"`` uses the
    einsum / pallas / sparse / quant ``mix_pytree`` backends on the rows
    stacked onto the controller ``device``. ``draws``: the round's
    ``rng.Draws`` provider. ``self_eval(pod_params) -> [npods] losses``
    arms the pod time machine when ``defta_cfg.time_machine`` is set; the
    trust signal follows ``defta_cfg.dts_signal`` ("corr" / "all" need the
    pod state built with ``init_pod_state(..., sketch=sketch_shape(cfg))``).

    Returns ``(gossip_round, pod_transport)``, ``gossip_round(pstate,
    pod_params, losses, start_params=None) -> (pstate', pod_params')``.
    Pass ``start_params`` (the per-pod trees the pods departed from this
    interval) so the geometry and correlation signals score the true
    local-train deltas."""
    del cfg                                  # signature parity
    from repro_torch.core.engine import build_pod_round, make_transport
    from repro_torch.scenarios.robust_agg import ROBUST_RULES

    support = np.asarray(adjacency, bool)
    if scenario is not None and scenario.adj_union is not None:
        # a time-varying topology: the ring's support must cover every
        # segment's adjacency
        support = scenario.adj_union
    tr = make_transport(
        defta_cfg, backend=backend, adjacency=support,
        robust=defta_cfg.aggregation in ROBUST_RULES,
        pods=pods if transport == "ppermute" else None)
    rnd = build_pod_round(defta_cfg, npods, sizes, transport=tr,
                          adj=np.asarray(adjacency, bool), draws=draws,
                          device=device, scenario=scenario,
                          self_eval=self_eval)
    return rnd, tr


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def build_prefill_step(cfg: ModelConfig, *, moe_strategy="grouped"):
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = model_mod.forward(params, cfg, batch,
                                      moe_strategy=moe_strategy)
        return logits
    return prefill_step


def build_decode_step(cfg: ModelConfig, *, moe_strategy="dense"):
    @torch.no_grad()
    def decode_step(params, tokens, cache, pos: int):
        return model_mod.decode_step(params, cfg, tokens, cache, pos,
                                     moe_strategy=moe_strategy)
    return decode_step
