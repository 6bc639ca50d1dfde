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
``kernels.ops.flash_attention``).

* ``abstract_state`` / ``input_specs``: the state and the inputs of a step
  as meta tensors (shapes, no storage), the counterpart of the reference's
  ShapeDtypeStructs, for the dry run (``launch.dryrun``); with a mesh and
  rules the parameters, the optimizer state (``_opt_state_axes``, ZeRO-1's
  ``zero1_axes`` under the ``zero1`` rules) and the decode cache are
  placed by logical axis (``sharding.Placed``), as the reference attaches
  its shardings. ``place_state`` places a real state the same way.

On a placed state the train, FL, prefill and decode steps run
tensor-parallel over the mesh's model axis (``models.model``), the
gradients are taken per block and the optimizer updates each block
(``optim``). The steps mark their parts for the counting pass
(``repro_torch.counting``): the optimizer update is replicated work (a
placed one each block's holders'), each FL pod's step is its pod's, and
the gradients are all-reduced over the data axis in closed form (a placed
step's blocks at the devices holding them; blocks split over the data
axis, an expert's, need none).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import counting, sharding
from repro_torch.config import ModelConfig, ShapeConfig
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
        if sharding.is_placed(params):
            return placed_grads(cfg, params, batch, moe_strategy)
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
        placed = sharding.is_placed(params)
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
                acc = _zip_leaves(lambda t: t.to(accum_dtype), g) \
                    if acc is None else _zip_leaves(
                        lambda a, t: a + t.to(accum_dtype), acc, g)
            grads = _zip_leaves(lambda a, p: (a / microbatches).to(p.dtype),
                                acc, params)
            loss = torch.stack(losses).mean()
        if placed:
            placed_gradient_allreduce(grads)
        else:
            counting.gradient_allreduce(grads)
        with counting.replicated():
            params, opt_state = optimizer.update(params, grads, opt_state,
                                                 step)
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
            with counting.pod(p):
                b = {k: torch.as_tensor(v[p]).to(dev)
                     for k, v in batch.items()}
                p2, o2, _, loss = inner(params, opt, step, b)
            new_p.append(p2)
            new_o.append(o2)
            losses.append(loss)
        dev0 = _device_of(pod_params[0])
        return new_p, new_o, step + 1, torch.stack([x.to(dev0)
                                                    for x in losses])
    return fl_step


def placed_gradient_allreduce(grads) -> None:
    """The data axis's gradient all-reduce of a placed step in closed form
    (``counting.gradient_allreduce``): each block at the devices holding
    it; a block split over the data axis (an expert's) needs none."""
    counting.gradient_allreduce(None, held=[
        (g, P.holders(k)) for _, P in sharding.placed_leaves(grads)
        if not sharding.splits_over(P, "data")
        for k, g in enumerate(P.parts)])


def placed_grads(cfg, params, batch, moe_strategy):
    """(loss, grads) of a placed tree: the gradient of every block (one
    tensor however many shards read it), as a placed tree of the same
    regions. Copies of one region on distinct cards have their gradients
    summed (an all-reduce)."""
    req = {}

    def mark(P):
        parts = []
        for t in P.parts:
            if id(t) not in req:
                req[id(t)] = t.detach().requires_grad_()
            parts.append(req[id(t)])
        return P.with_parts(parts)
    tree = sharding.map_placed(mark, params)
    leaves = list(req.values())
    loss, _ = model_mod.loss_fn(tree, cfg, batch, moe_strategy=moe_strategy)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    got = {id(t): torch.zeros_like(t) if g is None else g
           for t, g in zip(leaves, grads)}

    def back(P):
        parts = [got[id(t)] for t in P.parts]
        groups = {}
        for k, r in enumerate(P.regions):
            groups.setdefault(sharding._region_key(r), []).append(k)
        for ks in groups.values():
            if len(ks) > 1:                     # copies on distinct cards
                total = sum(parts[k].to(parts[ks[0]].device) for k in ks)
                n = total.numel() * total.element_size()
                counting.collective("all-reduce", 2 * (len(ks) - 1)
                                    / len(ks) * n)
                for k in ks:
                    parts[k] = total.to(parts[k].device)
        return P.with_parts(parts)
    return loss.detach(), sharding.map_placed(back, tree)


def _zip_leaves(fn, *trees):
    """``fn`` over the matching leaves of trees of one structure: nested
    dicts of tensors, or of ``Placed`` leaves (``fn`` on their parts)."""
    a = trees[0]
    if isinstance(a, dict):
        return {k: _zip_leaves(fn, *(t[k] for t in trees)) for k in a}
    if isinstance(a, sharding.Placed):
        return a.with_parts([fn(*xs) for xs in zip(*(t.parts for t in trees))])
    return fn(*trees)


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

def build_prefill_step(cfg: ModelConfig, *, moe_strategy="grouped",
                       whole_logits: bool = True):
    """``prefill_step(params, batch) -> logits``; ``batch`` carries
    ``frame_embeds`` (encoder-decoder) or ``vision_embeds`` (vlm) beside
    the tokens. On a placed tree ``whole_logits=False`` leaves the logits
    in their shards' layout (``model.forward``)."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, _ = model_mod.forward(params, cfg, batch,
                                      moe_strategy=moe_strategy,
                                      whole_logits=whole_logits)
        return logits
    return prefill_step


def build_decode_step(cfg: ModelConfig, *, moe_strategy="dense"):
    """``decode_step(params, tokens, cache, pos, enc_out=None) -> (logits,
    cache)``; an encoder-decoder passes its encoder states."""
    @torch.no_grad()
    def decode_step(params, tokens, cache, pos: int, enc_out=None):
        return model_mod.decode_step(params, cfg, tokens, cache, pos,
                                     enc_out=enc_out,
                                     moe_strategy=moe_strategy)
    return decode_step


# ---------------------------------------------------------------------------
# Abstract state and inputs (meta tensors: shapes, no storage)
# ---------------------------------------------------------------------------

def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh=None,
                rules=None, *, fl_pods: int = 0):
    """The inputs of a ``shape.mode`` step as meta tensors (the reference's
    ``input_specs``): tokens and labels [B, S] for train (``fl_pods`` > 0
    prepends the pod axis: [pods, B / pods, S]), tokens for prefill, one
    token, ``pos`` and the decode cache for decode; a vlm's
    ``vision_embeds`` and an encoder-decoder's ``frame_embeds`` (or
    ``enc_out`` for decode) at the model's dtype. ``pos`` is a Python int,
    as the port's decode step takes it. With ``mesh`` and ``rules`` the
    decode cache is placed (``model.place_cache``: along "model"; the
    batch's data axis is the counting pass's share, not a cut)."""
    b, s = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    lead = (fl_pods, b // fl_pods) if fl_pods and shape.mode == "train" \
        else (b,)
    specs = {}
    if shape.mode in ("train", "prefill"):
        specs["tokens"] = _meta(lead + (s,), torch.int64)
        if shape.mode == "train":
            specs["labels"] = _meta(lead + (s,), torch.int64)
        if cfg.family == "vlm":
            specs["vision_embeds"] = _meta(
                lead + (cfg.num_vision_tokens, cfg.d_model), dt)
        if cfg.is_encoder_decoder:
            specs["frame_embeds"] = _meta(
                lead + (cfg.encoder_seq_len, cfg.d_model), dt)
    else:
        specs["tokens"] = _meta((b, 1), torch.int64)
        specs["pos"] = s - 1
        specs["cache"] = model_mod.init_cache(cfg, b, s, device="meta")
        if mesh is not None:
            specs["cache"] = model_mod.place_cache(specs["cache"], cfg,
                                                   _pod(mesh), rules or {})
        if cfg.is_encoder_decoder:
            specs["enc_out"] = _meta((b, cfg.encoder_seq_len, cfg.d_model),
                                     dt)
    return specs


def _pod(mesh, p: int = 0):
    from repro_torch.launch.mesh import pod_mesh
    return pod_mesh(mesh, p)


def _opt_state_axes(name: str, axes, params_sds):
    """The optimizer state's logical axes: Adam's moments the parameters',
    Adafactor's row statistic without the last dim and its column
    statistic without the second last, SGD none."""
    from repro_torch.launch.sharding_rules import map_axes
    if name == "adam":
        return {"m": axes, "v": axes}
    if name == "sgd":
        return {}
    if name == "adafactor":
        def one(a, s):
            if len(s.shape) >= 2:
                return {"vr": a[:-1], "vc": a[:-2] + a[-1:]}
            return {"v": a}
        return {"f": map_axes(one, axes, params_sds)}
    raise ValueError(name)


def _opt_state_layouts(name: str, layouts):
    """The column layouts of the optimizer state: where a parameter's last
    dim has one, the state leaves that keep that dim."""
    if name == "adam":
        return {"m": layouts, "v": layouts}
    if name == "adafactor":
        def one(lay):
            if isinstance(lay, dict):
                return {k: one(v) for k, v in lay.items()}
            return {"vc": lay, "v": lay}
        return {"f": one(layouts)}
    return {}


def _place_opt(opt_state, opt_name, cfg, params_sds, mesh, rules):
    """The optimizer state placed by ``_opt_state_axes`` (ZeRO-1's
    ``zero1_axes`` where the rules name a "zero" axis)."""
    from repro_torch.launch.sharding_rules import zero1_axes
    axes = _opt_state_axes(opt_name, model_mod.param_axes(cfg), params_sds)
    if rules and rules.get("zero"):
        axes = zero1_axes(axes, opt_state, rules)
    lay = _opt_state_layouts(opt_name, model_mod.param_layouts(cfg))
    return _place_by(opt_state, axes, lay, mesh, rules)


def _place_by(tree, axes, layouts, mesh, rules):
    if isinstance(tree, dict):
        return {k: _place_by(v, axes[k], None if layouts is None
                             else layouts.get(k), mesh, rules)
                for k, v in tree.items()}
    return sharding.place_tree(tree, axes, mesh, rules, layouts=layouts)


def place_state(cfg: ModelConfig, params, opt_state, opt_name: str, mesh,
                rules):
    """(params, opt_state) placed by logical axis on a ("data", "model")
    mesh under ``rules``: the parameters by ``model.param_axes`` (with the
    mixer's per-head layout), the optimizer state by ``_opt_state_axes``.
    Each block is a copy with its own storage (a replicated one the tensor
    itself), so the whole trees may be dropped."""
    placed = model_mod.place_params(params, cfg, mesh, rules)
    return placed, _place_opt(opt_state, opt_name, cfg, params, mesh, rules)


def param_shardings(cfg: ModelConfig, mesh, rules, *, fl_pods: int = 0):
    """The parameters' ``NamedSharding`` tree (``fl_pods`` prepends the
    reference's "worker" axis)."""
    from repro_torch.launch.sharding_rules import map_axes, sharding_tree
    params_sds = model_mod.abstract_params(cfg)
    axes = model_mod.param_axes(cfg)
    if fl_pods:
        params_sds = sharding.tree_map(lambda t: _meta(
            (fl_pods,) + tuple(t.shape), t.dtype), params_sds)
        axes = map_axes(lambda a: ("worker",) + a, axes)
    return sharding_tree(mesh, rules, axes, params_sds)


def abstract_state(cfg: ModelConfig, optimizer_name: str, lr: float = 1e-3,
                   mesh=None, rules=None, *, fl_pods: int = 0):
    """(params, opt_state, optimizer) on meta: the parameters
    (``model.abstract_params``) and the optimizer's state made by its own
    ``init`` on them. With ``fl_pods`` the params and the state are lists
    of per-pod trees, the port's pod axis (``core.pods``). With ``mesh``
    and ``rules`` each is placed (``place_state``), pod p's on pod p's
    ("data", "model") mesh."""
    from repro_torch.optim import make_optimizer

    opt = make_optimizer(optimizer_name, lr)

    def one(p):
        params = model_mod.abstract_params(cfg)
        state = opt.init(params)
        if mesh is None:
            return params, state
        return place_state(cfg, params, state, optimizer_name, _pod(mesh, p),
                           rules or {})
    if fl_pods:
        trees = [one(p) for p in range(fl_pods)]
        return [t[0] for t in trees], [t[1] for t in trees], opt
    params, state = one(0)
    return params, state, opt
