"""Launch costing (the port of ``repro.launch.costing``).

Two halves:

* Six closed-form columns, ported with the reference's arithmetic, names,
  arguments and keys: ``gossip_cost``, ``participation_cost``,
  ``privacy_cost``, ``worker_shard_cost``, ``telemetry_cost`` and
  ``scenario_gossip_cost``. The parameter count and the number of leaves
  come from the port's ``model.abstract_params``. The wire times divide
  by the link the bytes cross: the pods are nodes (``roofline.DCN_BW``),
  the worker shards cards of one node (``roofline.ICI_BW``).
* ``train_cost``, with the reference's name and return, counted by the
  counting pass on torch's ``meta`` device (``repro_torch.counting``)
  where the reference compiles with XLA. Each figure is a device's share
  (``Counter.per_device``): the batch's work over the devices the batch
  splits over, a model shard's over its share, the optimizer update of a
  device's blocks (the state placed by logical axis on the mesh) whole.
  XLA counts a scanned loop body once, so the reference adds (repeats - 1)
  x one pattern's cost (``body_cost``, applied by ``corrected_cost``);
  eager torch runs every layer, so the port's counts need no such
  correction and those two are not ported: the dry run reads its
  counter as it is.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import warnings
from typing import Dict

import numpy as np
import torch

from repro_torch import counting, sharding
from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.launch import roofline as rf
from repro_torch.models import model as model_mod

_DEMOTION_WARNED: set = set()


@functools.lru_cache(maxsize=32)
def _param_leaves(cfg: ModelConfig):
    """(n_params, number of leaves) of the port's parameter tree."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        else:
            leaves.append(t)
    walk(model_mod.abstract_params(cfg))
    return sum(int(np.prod(t.shape)) for t in leaves), len(leaves)


# ---------------------------------------------------------------------------
# The closed-form columns
# ---------------------------------------------------------------------------

def gossip_cost(cfg: ModelConfig, fl_pods: int, *, wire=None,
                out_degree: float = 0.0,
                adjacency=None) -> Dict[str, float]:
    """Per-round DeFTA gossip WIRE cost, accounted by wire dtype: every
    pod ships one serialized model payload to each of its ``out_degree``
    outbound peers (default: fully connected, pods-1), priced by the gossip
    wire format (4 B/param fp32, 2 B bf16, 1 B int8 + one fp32 scale per
    worker x leaf row). ``ring_bytes`` is the cross-pod ring's per-round
    total with the nnz row selection (the contract over ``adjacency``),
    ``ring_bytes_dense_rotation`` the whole-stack rotation it replaced.
    ``t_ici_s`` is a pod's egress over the link between nodes."""
    from repro_torch.core.topology import make_topology

    n_params, rows = _param_leaves(cfg)
    deg = out_degree or max(fl_pods - 1, 0)
    payload = rf.gossip_wire_bytes(n_params, wire, rows=rows)
    if adjacency is None:
        adjacency = make_topology("dense", fl_pods, fl_pods - 1)
    ring, ring_dense = rf.ppermute_ring_bytes(n_params, adjacency, wire,
                                              rows=rows)
    return {
        "wire": wire or "fp32",
        "payload_bytes": float(payload),
        "round_bytes": rf.gossip_round_wire_bytes(
            n_params, fl_pods, deg, wire, rows=rows),
        "ring_bytes": float(ring),
        "ring_bytes_dense_rotation": float(ring_dense),
        "t_ici_s": payload * deg / rf.DCN_BW,   # per-pod egress / link bw
    }


def participation_cost(cfg: ModelConfig, enrolled: int, sample_k: int, *,
                       wire=None, avg_peers: int = 4,
                       dropout: float = 0.0,
                       straggle: float = 0.0) -> Dict[str, float]:
    """Cross-device participation wire cost, enrolled vs sampled: only the
    ``sample_k``-user cohort ships, each member one payload to each of its
    ``avg_peers`` outbound cohort peers; ``expected_round_bytes`` prices a
    mid-round dropout at half a payload (a straggler's timeout cuts no wire
    bytes)."""
    n_params, rows = _param_leaves(cfg)
    deg = min(avg_peers, sample_k - 1)
    payload = float(rf.gossip_wire_bytes(n_params, wire, rows=rows))
    cohort_bytes = sample_k * deg * payload
    full_bytes = enrolled * min(avg_peers, enrolled - 1) * payload
    rate = sample_k / enrolled
    return {
        "wire": wire or "fp32",
        "enrolled": enrolled,
        "sample_k": sample_k,
        "sampling_rate": rate,
        "payload_bytes": payload,
        "round_bytes": cohort_bytes,
        "round_bytes_full_participation": full_bytes,
        "wire_reduction": full_bytes / max(cohort_bytes, 1.0),
        "expected_round_bytes": cohort_bytes * (1.0 - 0.5 * dropout),
        # how sparsely DTS observes any one peer: expected rounds between
        # a user's appearances in the cohort
        "rounds_between_participations": 1.0 / max(rate, 1e-12),
    }


def privacy_cost(cfg: ModelConfig, w: int, rounds: int, *, wire=None,
                 adjacency=None, secagg: bool = True,
                 dp_sigma: float = 0.0,
                 dp_delta: float = 1e-5) -> Dict[str, float]:
    """Privacy column: the secagg wire's pad material per round (one
    payload-sized pad per directed edge; zero extra wire bytes, the masks
    ride in place) and the naive basic-composition Gaussian accountant over
    ``rounds`` (inf when dp_sigma == 0)."""
    from repro_torch.core.topology import make_topology

    n_params, rows = _param_leaves(cfg)
    if adjacency is None:
        adjacency = make_topology("dense", w, w - 1)
    pads = (rf.secagg_pad_bytes(adjacency, n_params, wire, rows=rows)
            if secagg else {"directed_edges": 0, "pad_bytes_per_edge": 0.0,
                            "pad_bytes": 0.0, "wire_overhead_bytes": 0.0})
    return {
        **pads,
        "wire": wire or "fp32",
        "secagg": bool(secagg),
        "dp_sigma": float(dp_sigma),
        "dp_delta": float(dp_delta),
        "rounds": int(rounds),
        "epsilon": rf.dp_epsilon(dp_sigma, rounds, delta=dp_delta),
    }


def worker_shard_cost(cfg: ModelConfig, w: int, shards: int, *, wire=None,
                      adjacency=None) -> Dict[str, float]:
    """Cross-shard cost column of a worker-axis-sharded round program: the
    per-shard slice of the carried worker state (params + best-eval backup
    + the EF21 residual on lossy wires, fp32, plus the W-wide confidence
    row), how the topology's support splits into intra- and cross-shard
    edges, and the cross-shard ring's bytes (``roofline.
    sharded_ring_bytes``); ``t_ici_s`` over the cards' NVLink."""
    from repro_torch.core.topology import make_topology

    n_params, rows = _param_leaves(cfg)
    if adjacency is None:
        adjacency = make_topology("dense", w, w - 1)
    info = rf.sharded_ring_bytes(n_params, adjacency, shards, wire,
                                 rows=rows)
    lossy = rf.WIRE_BYTES.get(wire, 4) < 4
    copies = 3 if lossy else 2               # params + backup (+ residual)
    per_worker = n_params * 4 * copies + w * 4
    return {
        **info,
        "wire": wire or "fp32",
        "n_params": float(n_params),
        "state_bytes_per_worker": float(per_worker),
        "per_shard_hbm_bytes": float(info["block"] * per_worker),
        "replicated_hbm_bytes": float(w * per_worker),
        "t_ici_s": info["ring_bytes"] / (shards * rf.ICI_BW),
    }


def telemetry_cost(num_workers: int, window: int, *, kind: str = "defta",
                   scenario: bool = True, use_ef: bool = False,
                   tick: bool = False) -> Dict[str, float]:
    """Telemetry-plane buffer cost: the probes' device bytes per round and
    per ``window``-round chunk (``kind``: "defta", "fedavg" or
    "cross_device"; ``tick`` adds the fire-gated tick's mask)."""
    from repro_torch.telemetry.spec import (cross_device_specs, defta_specs,
                                            fedavg_specs, frame_bytes,
                                            tick_specs)

    if kind == "defta":
        specs = defta_specs(num_workers, scenario=scenario, use_ef=use_ef)
    elif kind == "fedavg":
        specs = fedavg_specs(num_workers)
    elif kind == "cross_device":
        specs = cross_device_specs(num_workers, use_ef=use_ef)
    else:
        raise ValueError(f"unknown telemetry kind {kind!r}")
    if tick:
        specs = specs + tick_specs(num_workers)
    per_round = frame_bytes(specs)
    return {
        "kind": kind,
        "probes": len(specs),
        "bytes_per_round": float(per_round),
        "window_rounds": int(window),
        "buffer_bytes": float(per_round * window),
    }


def scenario_gossip_cost(cfg: ModelConfig, fl_pods: int, compiled_scn, *,
                         wire=None, out_degree: float = 0.0) -> Dict:
    """``gossip_cost`` scaled by the scenario's mean live-edge fraction
    (each live edge ships one payload), for the static bytes and the
    ring's; ``summary`` is the compiled scenario's digest."""
    from repro_torch.core.topology import make_topology

    base = gossip_cost(cfg, fl_pods, wire=wire, out_degree=out_degree)
    w = compiled_scn.num_workers
    adj = make_topology("dense", w, w - 1)
    s = compiled_scn.summary(adj)
    frac = s["mean_edge_fraction"]
    return {
        **base,
        "scenario": s["name"],
        "mean_edge_fraction": frac,
        "round_bytes_scenario": base["round_bytes"] * frac,
        "ring_bytes_scenario": base["ring_bytes"] * frac,
        "segments": s["segments"],
        "summary": s,
    }


# ---------------------------------------------------------------------------
# Counted step costs
# ---------------------------------------------------------------------------

def batch_split(mesh, rules, batch: int) -> int:
    """The devices a batch of ``batch`` splits over: the product of the
    mesh axes ``rules["batch"]`` names, or 1 (replicated) where that does
    not divide it, warned once per (axes, batch) as the reference's
    ``resolve_spec`` warns."""
    if mesh is None or not rules:
        return 1
    axes = rules.get("batch")
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    size = math.prod(mesh.shape[a] for a in axes if a in mesh.shape)
    if batch % size:
        key = (axes, batch)
        if key not in _DEMOTION_WARNED:
            _DEMOTION_WARNED.add(key)
            warnings.warn(
                f"sharding: logical axis 'batch' (dim {batch}) is not "
                f"divisible by mesh axis {axes!r} (size {size}) — demoting "
                f"to replicated; pad the dim for an even shard",
                RuntimeWarning, stacklevel=2)
        return 1
    return size


def _grad_ranks(mesh, rules) -> int:
    """The devices a pod's gradient all-reduce spans: those its batch
    splits over (the data axis, and the model axis under ``pure_dp``)."""
    if mesh is None or not rules:
        return 1
    axes = sharding.axes_of(rules.get("batch"))
    return math.prod(mesh.shape[a] for a in axes
                     if a in mesh.shape and a != "pod")


def _ctx(mesh, rules):
    """The model code's sharding context: a pod's ("data", "model") mesh
    (expert parallelism runs inside a pod)."""
    from repro_torch.launch.mesh import pod_mesh
    if mesh is None:
        return sharding.logical_rules(None, rules)
    return sharding.logical_rules(pod_mesh(mesh), rules)


def _result(c: counting.Counter):
    return c.per_device("flops"), c.per_device("bytes"), c.collectives()


def _leaves_requiring_grad(tree):
    flat = {}

    def walk(t, path):
        if isinstance(t, dict):
            return {k: walk(v, path + (k,)) for k, v in t.items()}
        leaf = t.detach().requires_grad_()
        flat[path] = leaf
        return leaf
    return walk(tree, ()), list(flat.values())


def train_cost(cfg: ModelConfig, shape: ShapeConfig, mesh, rules, *,
               optimizer, microbatches: int = 1, fl_pods: int = 0,
               moe_strategy: str = "grouped"):
    """A device's share of one (possibly micro-batched) train step, from
    the reference's composition

        total = mb x (grads_B + w_C x (R - 1) x layer_body_C) + opt_update_D

    with w_C = 0: B, the forward and backward of the whole model on ONE
    microbatch with the data axis's gradient all-reduce (closed form),
    already runs all R repeats of the pattern in eager torch; C (the
    reference's ``body_cost``) corrects XLA's once-counted scan and is
    not ported. D, the optimizer update, is replicated: counted whole on each
    device. Returns (flops, bytes, coll_dict)."""
    from repro_torch.launch.mesh import pod_mesh
    from repro_torch.launch.steps import (abstract_state, input_specs,
                                          placed_gradient_allreduce,
                                          placed_grads)

    pods = max(fl_pods, 1)
    mb_shape = dataclasses.replace(
        shape, global_batch=shape.global_batch // pods // microbatches)
    pm = None if mesh is None else pod_mesh(mesh)
    params, opt_state, opt = abstract_state(cfg, optimizer, mesh=pm,
                                            rules=rules)
    specs = input_specs(cfg, mb_shape)
    split = batch_split(mesh, rules, mb_shape.global_batch)
    ranks = _grad_ranks(mesh, rules)
    kw = {} if pm is None else dict(tp=pm.shape.get("model", 1),
                                    devices=math.prod(pm.shape.values()))
    placed = sharding.is_placed(params)

    def track(c, tree):
        if placed:
            c.track_placed([p for t in tree for _, p in
                            sharding.placed_leaves(t)])
        else:
            c.track(tree)

    # ---- B: one-microbatch grads ---------------------------------------
    with _ctx(mesh, rules), \
            counting.Counter(split=split, grad_ranks=ranks, **kw) as cb:
        track(cb, (params,))
        cb.track(specs, kind="split")
        if placed:
            _, g = placed_grads(cfg, params, specs, moe_strategy)
            placed_gradient_allreduce(g)
        else:
            tree, leaves = _leaves_requiring_grad(params)
            loss, _ = model_mod.loss_fn(tree, cfg, specs,
                                        moe_strategy=moe_strategy)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            counting.gradient_allreduce([g for g in grads if g is not None])
    bf, bb, bcoll = _result(cb)

    # ---- D: optimizer update (a device's blocks) -------------------------
    grads = params                       # a meta tree of the params' shapes
    step = torch.zeros((), dtype=torch.int64, device="meta")
    with counting.Counter(split=split, **kw) as cd:
        track(cd, (params, opt_state))
        with counting.replicated():
            opt.update(params, grads, opt_state, step)
    df, db, dcoll = _result(cd)

    flops = microbatches * bf + df
    bytes_ = microbatches * bb + db
    coll = {k: microbatches * bcoll[k] + dcoll[k] for k in bcoll}
    return flops, bytes_, coll
