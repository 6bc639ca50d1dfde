"""Dry run: count every (architecture x input shape x mesh) step of the
port on torch's ``meta`` device (shapes, no storage: nothing is allocated
or computed), and write a device's flops, bytes, collective bytes and
peak memory with the roofline and the gossip columns to JSON (the port of
``repro.launch.dryrun``, which lowers and compiles on ShapeDtypeStructs).

Usage (the CPU is enough: meta needs no card):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --variant zero1
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-0.6b \\
        --shape train_4k --measure --batch 2     # on the card

The mesh is the H100 production mesh (``launch.mesh``): one HGX node of
8 cards, ("data", "model") = (2, 4), or two of them with the pod axis.
The state is placed by logical axis under the reference's rules
(``sharding_rules.base_rules``, ``--variant``: zero1, no_seqshard,
expert_model, pure_dp, noremat, mb16, fp8, as the reference's), each leaf's
blocks live on their devices; the step runs tensor-parallel over the model
axis, except under pure_dp, where no parameter splits over it and the
model axis splits the batch with the data axis (``models.model._tp``).
``--optimizer`` overrides the reference's pick and ``--accum-dtype`` sets
the micro-batches' gradient accumulators' dtype. The counted program is
the port's own step (``launch.steps``), run by the counting pass
(``repro_torch.counting``); a device's figures are the busiest device's
share (``Counter.per_device``): its blocks, its model
shard's work on the data axis's share of the batch, its own. On a
multi-pod mesh the FL train step runs both pods; a step without the pod
loop (prefill, decode, the FedAvg baseline) is counted for one pod's share
of the batch, the same figures a device. The roofline's times are predictions for an NVIDIA
H100 80GB HBM3 at 700 W (``roofline``): collective bytes inside a pod
over NVLink, those that cross pods (the gossip ring, the FedAvg
baseline's gradient all-reduce) over the link between nodes.

``--measure`` runs the same pair on the card at a cut batch or length
(``--batch``, ``--seq``) under the same counter, beside the meta count at
the same cut, and prints the counted flops, bytes and kernel calls of
both, the kernel launches, the meta and the measured peak, the step's ms
and the roofline share (roofline time / measured time).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch import counting, sharding
from repro_torch.config import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import roofline as rf
from repro_torch.launch.mesh import make_production_mesh, pod_mesh
from repro_torch.launch.sharding_rules import base_rules

# shapes skipped per DESIGN.md (noted, not silent)
SKIPS = {
    ("whisper-tiny", "long_500k"):
        "decoder capped at 448 learned positions; 512k-token whisper decode "
        "is not a meaningful computation (DESIGN.md §shape-skips)",
}

# scenario cost reports are compiled over this many epochs (the presets'
# event timelines all fit well inside it)
SCENARIO_HORIZON = 50

# archs needing the sliding-window variant for long_500k (full-attention
# families; window makes decode memory/compute linear)
SLIDING_WINDOW_FOR_LONG = 4096
FULL_ATTENTION_FAMILIES = ("dense", "moe", "vlm")
H100_BYTES = 80e9                # the card's memory (80 GB)


def pick_optimizer(cfg: ModelConfig) -> str:
    # Adafactor above ~25B params: Adam moments would not fit HBM.
    return "adafactor" if cfg.param_count() > 25e9 else "adam"


def pick_microbatches(cfg: ModelConfig, shape: ShapeConfig,
                      fl_pods: int) -> int:
    """Grad-accumulation depth: big models need it to bound per-step
    activation memory (EXPERIMENTS.md §Dry-run notes the policy)."""
    if shape.mode != "train":
        return 1
    if cfg.param_count() < 10e9:
        return 1
    b_pod = shape.global_batch // max(fl_pods, 1)
    return max(1, min(8, b_pod // 16))


def pick_moe_strategy(cfg: ModelConfig, variant: str = "baseline") -> str:
    # expert-parallel shard_map whenever the model has routed experts
    if cfg.moe is None:
        return "grouped"
    return "eplocal_fp8" if "fp8" in variant else "eplocal"


def effective_config(arch: str, shape: ShapeConfig,
                     variant: str = "baseline") -> ModelConfig:
    cfg = get_config(arch)
    if shape.name == "long_500k" and cfg.family in FULL_ATTENTION_FAMILIES:
        cfg = dataclasses.replace(cfg, sliding_window=SLIDING_WINDOW_FOR_LONG)
    if "noremat" in variant:
        cfg = dataclasses.replace(cfg, remat=False)
    return cfg


# ---------------------------------------------------------------------------
# One counted step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Plan:
    """What a pair counts: the config, the shape it runs at (one pod's share
    of the batch where the step has no pod loop), the mesh, the rules, the
    pods of an FL step, the optimizer, micro-batches and MoE strategy, and
    the dtype of the micro-batches' gradient accumulators."""
    cfg: ModelConfig
    shape: ShapeConfig
    mesh: object
    rules: dict
    fl_pods: int
    opt_name: str
    microbatches: int
    moe_strategy: str
    chips: int
    grad_ranks: int
    grad_across_pods: bool
    variant: str = "baseline"
    accum_dtype: str = "float32"


def plan(arch: str, shape: ShapeConfig, *, multi_pod: bool = False,
         fl: bool = True, devices=None, config: ModelConfig = None,
         variant: str = "baseline", pod=None, optimizer: str = "",
         accum_dtype: str = "float32") -> Plan:
    """The pair's ``Plan`` on the production mesh over ``devices``
    (default meta), with the reference's policies (``pick_optimizer``,
    which ``optimizer`` overrides, ``pick_microbatches``,
    ``pick_moe_strategy``, ``effective_config``) and rules under
    ``variant``. ``config`` replaces the arch's config (a reduced one in
    the tests); ``pod`` a pod's (data, model) shape (default
    ``mesh.H100_POD``'s); ``accum_dtype`` (a torch dtype's name) the
    micro-batches' gradient accumulators'."""
    cfg = config or effective_config(arch, shape, variant)
    if config is not None and "noremat" in variant:
        cfg = dataclasses.replace(cfg, remat=False)
    mesh = make_production_mesh(multi_pod=multi_pod, devices=devices,
                                pod=pod)
    chips = math.prod(mesh.shape.values())
    rules = base_rules(multi_pod, variant=variant)
    fl_pods = mesh.shape.get("pod", 0) if (multi_pod and fl and
                                           shape.mode == "train") else 0
    pods = mesh.shape.get("pod", 1)
    data = mesh.shape["data"]
    batch_axes = sharding.axes_of(rules["batch"])
    # the gradients are all-reduced over the devices the batch splits
    # over (data, and model under pure_dp); the FedAvg baseline's across
    # the pods too
    grad_across_pods = multi_pod and not fl_pods
    grad_ranks = math.prod(mesh.shape[a] for a in batch_axes
                           if a != "pod" or grad_across_pods)
    if multi_pod:
        # counted inside one pod: the FL step's pods each on their own, a
        # step without the pod loop for one pod's share of the batch (the
        # batch keeps the pod's axes the variant put it on)
        rules = {**rules, "batch": tuple(a for a in batch_axes
                                         if a != "pod")}
        if not fl_pods and shape.global_batch % pods == 0:
            shape = dataclasses.replace(
                shape, global_batch=shape.global_batch // pods)
    microbatches = pick_microbatches(cfg, shape, fl_pods)
    if "mb16" in variant:
        microbatches = max(microbatches, 16)
    moe_strategy = pick_moe_strategy(cfg, variant)
    if cfg.moe is not None and cfg.moe.num_experts % data:
        # expert parallelism needs the experts to split over the data
        # axis (every full config's do; a reduced one's may not)
        moe_strategy = "grouped"
    return Plan(cfg, shape, mesh, rules, fl_pods,
                optimizer or pick_optimizer(cfg), microbatches,
                moe_strategy, chips, grad_ranks, grad_across_pods, variant,
                accum_dtype)


def _materialize(tree, gen, vocab: int):
    """A meta tree made real on ``gen``'s device: floats from a normal,
    integers (tokens, labels) uniform below ``vocab``; a Python int passes
    through."""
    if isinstance(tree, dict):
        return {k: _materialize(v, gen, vocab) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_materialize(v, gen, vocab) for v in tree]
    if not isinstance(tree, torch.Tensor):
        return tree
    dev = gen.device
    if tree.dtype.is_floating_point:
        return torch.randn(tree.shape, generator=gen, device=dev).to(
            tree.dtype)
    return torch.randint(0, vocab, tree.shape, generator=gen, device=dev,
                         dtype=tree.dtype)


def build_state(p: Plan, device="meta", seed: int = 0):
    """(params, opt_state, opt, inputs) of the pair on ``device``, placed
    by logical axis on the pair's mesh (pod p's on pod p's): meta from
    ``steps.abstract_state`` / ``input_specs``; a real device takes random
    weights from ``model.init_params`` (seed ``seed``), the optimizer's own
    init and random inputs of the same shapes, placed the same way
    (``steps.place_state``, ``model.place_cache``)."""
    from repro_torch.launch.steps import (abstract_state, input_specs,
                                          place_state)
    from repro_torch.models import model as model_mod

    opt_name = p.opt_name if p.shape.mode == "train" else "sgd"
    if torch.device(device).type == "meta":
        params, opt_state, opt = abstract_state(
            p.cfg, opt_name, mesh=p.mesh, rules=p.rules, fl_pods=p.fl_pods)
        inputs = input_specs(p.cfg, p.shape, p.mesh, p.rules,
                             fl_pods=p.fl_pods)
        return params, opt_state, opt, inputs
    _, _, opt = abstract_state(p.cfg, opt_name)
    inputs = input_specs(p.cfg, p.shape, fl_pods=p.fl_pods)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def one(pod):
        params = model_mod.init_params(gen, p.cfg)
        return place_state(p.cfg, params, opt.init(params), opt_name,
                           pod_mesh(p.mesh, pod), p.rules)
    if p.fl_pods:
        trees = [one(i) for i in range(p.fl_pods)]
        params, opt_state = [t[0] for t in trees], [t[1] for t in trees]
    else:
        params, opt_state = one(0)
    inputs = _materialize(inputs, gen, p.cfg.vocab_size)
    if "cache" in inputs:
        inputs["cache"] = model_mod.place_cache(inputs["cache"], p.cfg,
                                                pod_mesh(p.mesh), p.rules)
    return params, opt_state, opt, inputs


def count_step(p: Plan, state):
    """Run the pair's step once under a ``counting.Counter`` (on whatever
    device ``state`` lies) and return the counter. The state and inputs
    are registered first: the placed parameters and optimizer state block
    by block on the devices holding each (an FL step's per pod), the
    inputs the batch's, which splits over the pod's data axis, and a
    decode cache's blocks by model shard for that share."""
    from repro_torch.launch.costing import batch_split

    params, opt_state, _, inputs = state
    pm = pod_mesh(p.mesh)
    split = batch_split(pm, p.rules,
                        p.shape.global_batch // max(p.fl_pods, 1))
    with counting.Counter(split=split, grad_ranks=p.grad_ranks,
                          grad_across_pods=p.grad_across_pods,
                          tp=pm.shape.get("model", 1),
                          devices=math.prod(pm.shape.values())) as c:
        if p.fl_pods:
            for i in range(p.fl_pods):
                c.track_placed(_placed((params[i], opt_state[i])), pod=i)
        else:
            c.track_placed(_placed((params, opt_state)))
        plain = {k: v for k, v in inputs.items() if k != "cache"}
        c.track(plain, kind="split")
        if "cache" in inputs:
            c.track_placed(_placed(inputs["cache"]), batch=True)
        run_step(p, state)
    return c


def _placed(tree):
    """The ``Placed`` leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _placed(t)]
    return [pl for _, pl in sharding.placed_leaves(tree)]


def _device_bytes(tree) -> float:
    """The busiest device's bytes of a placed tree (its blocks)."""
    leaves = _placed(tree)
    if not leaves:
        return float(_tree_bytes(tree))
    coords = leaves[0].owners
    return max(sum(pl.device_bytes(cd) for pl in leaves) for cd in coords)


def _gb(tree_bytes: float) -> float:
    return tree_bytes / 2 ** 30


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for t in counting._tensors(tree))


def _gossip_info(cfg, fl_pods, params, *, scenario, cd_enrolled,
                 cd_sample_k, shard_workers, verbose):
    """The reference's gossip columns of a multi-pod FL train pair: the
    gossip step counted on meta, the wire and ring bytes by wire format,
    and the participation, worker-sharding, telemetry, privacy and
    scenario columns. The step is counted through the port's cross-pod
    ring (``gossip.mix_pytree_ppermute``: all pods joined, one device a
    pod, the parameters in their own dtype on the wire, bf16 in every
    config), where the reference reads the collectives that XLA lowers its
    einsum over the pod axis into. Each pod sends its payload to the
    others between nodes, so the bytes are priced at ``DCN_BW``: the time
    is ``gossip_cost``'s ``t_ici_s`` at the same wire."""
    from repro_torch.core import pods as pods_mod
    from repro_torch.core.gossip import mix_pytree_ppermute
    from repro_torch.core.topology import make_topology
    from repro_torch.launch.costing import (gossip_cost, participation_cost,
                                            privacy_cost,
                                            scenario_gossip_cost,
                                            telemetry_cost,
                                            worker_shard_cost)

    mix = torch.empty((fl_pods, fl_pods), dtype=torch.float32,
                      device="meta")
    with counting.Counter() as g:
        mix_pytree_ppermute(mix, [pods_mod.flatten(sharding.unplace(p))
                                  for p in params],
                            ["meta"] * fl_pods,
                            adjacency=make_topology("dense", fl_pods,
                                                    fl_pods - 1))
    g_coll = g.collectives()
    g_costs = {fmt: gossip_cost(cfg, fl_pods, wire=fmt)
               for fmt in (None, "bf16", "int8")}
    info = {
        "collective_gbytes_per_chip": sum(g_coll.values()) / 1e9,
        "collective_breakdown": {k: v / 1e9 for k, v in g_coll.items()},
        "t_collective_s": rf.collective_seconds(g_coll,
                                                g.collectives(dcn=True)),
        "flops_dev": g.per_device("flops"),
        "wire_gbytes_per_round": {
            fmt or "fp32": gc["round_bytes"] / 1e9
            for fmt, gc in g_costs.items()},
        "ppermute_ring_gbytes_per_round": {
            fmt or "fp32": gc["ring_bytes"] / 1e9
            for fmt, gc in g_costs.items()},
        "ppermute_dense_rotation_gbytes_per_round":
            g_costs[None]["ring_bytes_dense_rotation"] / 1e9,
    }
    p_costs = {fmt: participation_cost(cfg, cd_enrolled, cd_sample_k,
                                       wire=fmt, dropout=0.05, straggle=0.10)
               for fmt in (None, "bf16", "int8")}
    p0 = p_costs[None]
    info["participation"] = {
        "enrolled": p0["enrolled"],
        "sample_k": p0["sample_k"],
        "sampling_rate": p0["sampling_rate"],
        "rounds_between_participations": p0["rounds_between_participations"],
        "wire_reduction_vs_full": p0["wire_reduction"],
        "cohort_wire_gbytes_per_round": {
            fmt or "fp32": pc["round_bytes"] / 1e9
            for fmt, pc in p_costs.items()},
        "expected_wire_gbytes_per_round": {
            fmt or "fp32": pc["expected_round_bytes"] / 1e9
            for fmt, pc in p_costs.items()},
        "full_participation_wire_gbytes_per_round":
            p0["round_bytes_full_participation"] / 1e9,
    }
    ws_w = cd_enrolled
    ws_adj = make_topology("random_kout", ws_w, 4, seed=0)
    ws = {fmt: worker_shard_cost(cfg, ws_w, shard_workers, wire=fmt,
                                 adjacency=ws_adj)
          for fmt in (None, "bf16", "int8")}
    ws0 = ws[None]
    info["worker_sharding"] = {
        "workers": ws_w,
        "shards": ws0["shards"],
        "block": ws0["block"],
        "intra_edges": ws0["intra_edges"],
        "cross_edges": ws0["cross_edges"],
        "used_shard_pairs": ws0["used_pairs"],
        "per_shard_hbm_gb": ws0["per_shard_hbm_bytes"] / 1e9,
        "replicated_hbm_gb": ws0["replicated_hbm_bytes"] / 1e9,
        "ring_gbytes_per_round": {
            fmt or "fp32": c["ring_bytes"] / 1e9 for fmt, c in ws.items()},
        "bytes_per_boundary": {
            fmt or "fp32": c["bytes_per_boundary"] for fmt, c in ws.items()},
    }
    tc_pod = telemetry_cost(fl_pods, SCENARIO_HORIZON,
                            scenario=bool(scenario))
    tc_cd = telemetry_cost(cd_sample_k, SCENARIO_HORIZON,
                           kind="cross_device")
    info["telemetry"] = {
        "pod_probes": tc_pod["probes"],
        "pod_bytes_per_round": tc_pod["bytes_per_round"],
        "pod_buffer_kb": tc_pod["buffer_bytes"] / 1e3,
        "cross_device_probes": tc_cd["probes"],
        "cross_device_bytes_per_round": tc_cd["bytes_per_round"],
        "cross_device_buffer_kb": tc_cd["buffer_bytes"] / 1e3,
        "window_rounds": SCENARIO_HORIZON,
    }
    pv = {fmt: privacy_cost(cfg, fl_pods, SCENARIO_HORIZON, wire=fmt,
                            dp_sigma=1.0)
          for fmt in (None, "bf16", "int8")}
    pv0 = pv[None]
    info["privacy"] = {
        "directed_edges": pv0["directed_edges"],
        "pad_gbytes_per_round": {
            fmt or "fp32": c["pad_bytes"] / 1e9 for fmt, c in pv.items()},
        "wire_overhead_bytes": pv0["wire_overhead_bytes"],
        "dp_epsilon_at_sigma": {
            f"{sig:g}": rf.dp_epsilon(sig, SCENARIO_HORIZON)
            for sig in (0.5, 1.0, 2.0)},
        "dp_delta": 1e-5,
        "rounds": SCENARIO_HORIZON,
    }
    if scenario:
        from repro_torch.scenarios import compile_scenario, get_scenario
        spec = get_scenario(scenario, fl_pods)
        compiled_scn = compile_scenario(spec, fl_pods, SCENARIO_HORIZON,
                                        device="cpu")
        sc = scenario_gossip_cost(cfg, fl_pods, compiled_scn)
        info["scenario"] = {
            "summary": sc["summary"],
            "mean_edge_fraction": sc["mean_edge_fraction"],
            "wire_gbytes_per_round": sc["round_bytes_scenario"] / 1e9,
            "wire_gbytes_per_round_static": sc["round_bytes"] / 1e9,
            "ppermute_ring_gbytes_per_round":
                sc["ring_bytes_scenario"] / 1e9,
            "ppermute_ring_gbytes_per_round_static": sc["ring_bytes"] / 1e9,
        }
    if verbose:
        print(f"  gossip: ring {info['ppermute_ring_gbytes_per_round']} "
              f"GB/round; participation {p0['sample_k']}/{p0['enrolled']}"
              f" -> {p0['round_bytes'] / 1e9:.2f} GB/round; worker "
              f"sharding {ws0['per_shard_hbm_bytes'] / 1e9:.2f} GB/shard; "
              f"secagg pads {pv0['pad_bytes'] / 1e9:.2f} GB/round")
    return info


def run_dryrun(arch: str, shape_name: str, *, multi_pod: bool = False,
               fl: bool = True, variant: str = "baseline",
               optimizer: str = "", accum_dtype: str = "float32",
               scenario: str = "", cd_enrolled: int = 10_000,
               cd_sample_k: int = 64, shard_workers: int = 8,
               verbose: bool = True):
    """Count one (arch, shape, mesh) on meta. Returns the reference's
    result dict: memory (``peak_per_device_gb`` the counted peak of the
    busiest device; ``arg_gb`` its state and inputs, ``temp_gb`` the
    rest), the roofline (``roofline.analyze`` on a device's counted flops,
    bytes and collectives of the whole step, those that cross pods priced
    between nodes; the reference composes a train step's from
    ``train_cost``'s parts, since XLA counts a scan body once, and the
    port's ``train_cost`` agrees with the whole step's count, which a test
    holds) and, on a multi-pod FL train pair, the gossip columns.
    ``lower_s`` is the seconds to build the meta state, ``compile_s``
    those of the counting pass."""
    shape = SHAPES[shape_name]
    mesh_name = "multi" if multi_pod else "single"
    if (arch, shape_name) in SKIPS:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": SKIPS[(arch, shape_name)]}
    p = plan(arch, shape, multi_pod=multi_pod, fl=fl, variant=variant,
             optimizer=optimizer, accum_dtype=accum_dtype)
    t0 = time.time()
    state = build_state(p)
    t_lower = time.time() - t0
    t0 = time.time()
    c = count_step(p, state)
    t_compile = time.time() - t0
    pods_state = state[:2] if not p.fl_pods else (state[0][0],
                                                   state[1][0])
    cache = state[3].get("cache")
    args_dev = (_device_bytes(pods_state)
                + _tree_bytes({k: v for k, v in state[3].items()
                               if k != "cache"}) / c.split
                + (_device_bytes(cache) / c.split if cache is not None
                   else 0))

    gossip_info = None
    if p.fl_pods:
        gossip_info = _gossip_info(
            p.cfg, p.fl_pods, state[0], scenario=scenario,
            cd_enrolled=cd_enrolled, cd_sample_k=cd_sample_k,
            shard_workers=shard_workers, verbose=verbose)

    flops_dev, bytes_dev = c.per_device("flops"), c.per_device("bytes")
    peak = c.peak_device_bytes
    roof = rf.analyze(arch, shape_name, mesh_name, p.chips,
                      {"flops": flops_dev, "bytes accessed": bytes_dev},
                      "", rf.model_flops_estimate(p.cfg, shape), peak,
                      coll_override=c.collectives(),
                      dcn_override=c.collectives(dcn=True))
    result = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "status": "ok", "chips": p.chips, "optimizer": p.opt_name,
        "variant": p.variant,
        "accum_dtype": p.accum_dtype,
        "mesh_shape": dict(p.mesh.shape),
        "params_b": p.cfg.param_count() / 1e9,
        "microbatches": p.microbatches,
        "moe_strategy": p.moe_strategy,
        "active_params_b": p.cfg.param_count(active_only=True) / 1e9,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {
            "temp_gb": _gb(peak - args_dev),
            "arg_gb": _gb(args_dev),
            "out_gb": 0.0,
            "alias_gb": 0.0,
            "peak_per_device_gb": _gb(peak),
            "fits_80gb": peak <= H100_BYTES,
        },
        "roofline": roof.to_dict(),
        "gossip": gossip_info,
        "counted": {
            "program_flops": c.flops,
            "program_bytes": c.bytes,
            "kernel_calls": dict(c.calls),
            "closed_form_collectives": sorted(c.closed_form),
            "top_bytes_by_op": dict(sorted(
                c.op_bytes.items(), key=lambda kv: -kv[1])[:8]),
            "program_peak_gb": _gb(c.peak_bytes),
        },
        "card": rf.CARD,
    }
    if verbose:
        print(f"[{arch} × {shape_name} × {mesh_name}] "
              f"compile={t_compile:.0f}s "
              f"peak/dev={_gb(peak):.2f}GiB "
              f"flops/dev={flops_dev / 1e12:.2f}T "
              f"bottleneck={roof.bottleneck} "
              f"(c={roof.t_compute * 1e3:.1f}ms m={roof.t_memory * 1e3:.1f}ms "
              f"x={roof.t_collective * 1e3:.1f}ms)", flush=True)
    return result


# ---------------------------------------------------------------------------
# --measure: the same pair on the card at a cut
# ---------------------------------------------------------------------------

def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def measure(arch: str, shape_name: str, *, batch: int = 0, seq: int = 0,
            device=None, multi_pod: bool = False, repeats: int = 3,
            verbose: bool = True,
            config: ModelConfig = None, pod=None):
    """Count the pair at a cut (``batch``, ``seq``; 0 keeps the shape's) on
    meta, then run it on ``device`` (default the card; ``"cpu"`` for
    tests) under the same counter, then time it there without the counter
    (median of ``repeats`` steps). The mesh's devices are ``device``
    repeated, so expert parallelism runs its shards on the one device.
    Returns the counts of both, the launches, the peaks (the measured one
    is ``torch.cuda.max_memory_allocated`` less the allocation that stood
    before the pair's state, on the card; the CPU has none), the step's ms
    and the roofline share. ``config`` replaces the arch's config."""
    import statistics

    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    dev = resolve_device(device)
    full = SHAPES[shape_name]
    shape = dataclasses.replace(full, global_batch=batch or full.global_batch,
                                seq_len=seq or full.seq_len)
    cuts = [f"{k} {getattr(full, k)} -> {getattr(shape, k)}"
            for k in ("global_batch", "seq_len")
            if getattr(full, k) != getattr(shape, k)]
    kw = dict(multi_pod=multi_pod, config=config, pod=pod)

    def one_plan(d):
        p = plan(arch, full, **kw, devices=[d] * (16 if multi_pod else 8))
        # the cut applies to the counted shape (one pod's share)
        return dataclasses.replace(p, shape=dataclasses.replace(
            p.shape, global_batch=shape.global_batch,
            seq_len=shape.seq_len))

    t0 = time.time()
    pm = one_plan("meta")
    cm = count_step(pm, build_state(pm))
    meta_s = time.time() - t0

    pc = one_plan(str(dev))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated(dev)
    state = build_state(pc, dev)
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    before = dict(ops.LAUNCHES)
    cc = count_step(pc, state)
    _sync(dev)
    launches = {k: ops.LAUNCHES[k] - before[k] for k in ops.LAUNCHES
                if ops.LAUNCHES[k] != before[k]}
    peak = (torch.cuda.max_memory_allocated(dev) - base
            if dev.type == "cuda" else None)

    times = []
    for _ in range(repeats):
        _sync(dev)
        t1 = time.perf_counter()
        run_step(pc, state)
        _sync(dev)
        times.append((time.perf_counter() - t1) * 1e3)
    ms = statistics.median(times)
    t_roof = max(cc.flops / rf.PEAK_FLOPS, cc.bytes / rf.HBM_BW)
    out = {
        "arch": arch, "shape": shape_name, "cuts": cuts,
        "optimizer": pc.opt_name, "moe_strategy": pc.moe_strategy,
        "remat": pc.cfg.remat,
        "meta": {"flops": cm.flops, "bytes": cm.bytes,
                 "calls": dict(cm.calls), "peak_bytes": cm.peak_bytes,
                 "seconds": meta_s},
        "device": {"flops": cc.flops, "bytes": cc.bytes,
                   "calls": dict(cc.calls), "counted_peak_bytes":
                   cc.peak_bytes},
        "launches": launches,
        "measured_peak_bytes": peak,
        "step_ms": ms, "step_ms_all": times,
        "roofline_ms": t_roof * 1e3,
        "roofline_share": t_roof * 1e3 / ms,
        "ops_gap": {k: (cm.ops.get(k), cc.ops.get(k))
                    for k in set(cm.ops) | set(cc.ops)
                    if cm.ops.get(k) != cc.ops.get(k)},
    }
    if verbose:
        print(f"measure [{arch} × {shape_name}] {', '.join(cuts) or 'uncut'}"
              f" on {dev}: flops meta {cm.flops:.6e} / device "
              f"{cc.flops:.6e}; bytes meta {cm.bytes:.6e} / device "
              f"{cc.bytes:.6e}; calls meta {dict(cm.calls)} / device "
              f"{dict(cc.calls)}; launches {launches}; peak meta "
              f"{cm.peak_bytes / 1e9:.3f} GB / measured "
              f"{'-' if peak is None else f'{peak / 1e9:.3f}'} GB; step "
              f"{ms:.2f} ms ({[round(t, 2) for t in times]}); roofline "
              f"{t_roof * 1e3:.3f} ms, share {t_roof * 1e3 / ms:.4f}",
              flush=True)
    return out


def run_step(p: Plan, state):
    """The pair's step once, on the pod's mesh (``count_step`` counts it,
    ``measure`` times it)."""
    from repro_torch.launch import steps as steps_mod

    params, opt_state, opt, inputs = state
    with sharding.logical_rules(pod_mesh(p.mesh), p.rules):
        if p.shape.mode == "train":
            dev = next(iter(inputs.values())).device
            step = torch.zeros((), dtype=torch.int64, device=dev)
            build = steps_mod.build_fl_train_step if p.fl_pods else \
                steps_mod.build_train_step
            build(p.cfg, opt, moe_strategy=p.moe_strategy,
                  microbatches=p.microbatches,
                  accum_dtype=getattr(torch, p.accum_dtype))(
                      params, opt_state, step, inputs)
        elif p.shape.mode == "prefill":
            # the logits stay in their shards' layout, as the reference's
            # constraint leaves them
            steps_mod.build_prefill_step(
                p.cfg, moe_strategy=p.moe_strategy,
                whole_logits=False)(params, inputs)
        else:
            dec = p.moe_strategy if p.cfg.moe is not None else "dense"
            kw = {"enc_out": inputs["enc_out"]} if "enc_out" in inputs \
                else {}
            steps_mod.build_decode_step(p.cfg, moe_strategy=dec)(
                params, inputs["tokens"], inputs["cache"], inputs["pos"],
                **kw)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="")
    ap.add_argument("--shape", default="")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline",
                    help="the reference's rule variants (zero1, "
                    "no_seqshard, expert_model, pure_dp, noremat, mb16, "
                    "fp8; joined, e.g. zero1_fp8)")
    ap.add_argument("--optimizer", default="",
                    help="adam, adafactor or sgd in place of the "
                    "reference's pick (adafactor above 25B parameters)")
    ap.add_argument("--accum-dtype", default="float32",
                    help="the micro-batches' gradient accumulators' dtype "
                    "(a torch dtype's name: float32, bfloat16)")
    ap.add_argument("--fedavg-baseline", action="store_true",
                    help="multi-pod without the FL pod axis (params "
                    "replicated across pods; grad AR crosses pods)")
    ap.add_argument("--scenario", default="",
                    help="attach a named scenario's summary + gossip cost "
                    "delta to multi-pod FL dry-runs (paper_noise[@K], "
                    "churn_signflip, storm)")
    ap.add_argument("--cd-enrolled", type=int, default=10_000,
                    help="cross-device participation column: enrolled "
                    "population size (multi-pod FL dry-runs)")
    ap.add_argument("--cd-sample-k", type=int, default=64,
                    help="cross-device participation column: per-round "
                    "cohort size")
    ap.add_argument("--shard-workers", type=int, default=8,
                    help="worker-sharding column: shard count for the "
                    "cross-shard HBM / ring-bytes contract (multi-pod "
                    "FL dry-runs)")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--measure", action="store_true",
                    help="run the pair on the card at --batch / --seq under "
                    "the same counter, beside the meta count at that cut")
    ap.add_argument("--batch", type=int, default=0,
                    help="--measure: the cut global batch (0: the shape's)")
    ap.add_argument("--seq", type=int, default=0,
                    help="--measure: the cut length (0: the shape's)")
    ap.add_argument("--device", default=None,
                    help="--measure: the device (default the card; cpu for "
                    "tests)")
    args = ap.parse_args(argv)

    if args.measure:
        res = measure(args.arch, args.shape, batch=args.batch, seq=args.seq,
                      device=args.device, multi_pod=args.multi_pod)
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, f"{args.arch}_{args.shape}_"
                               f"measure.json"), "w") as f:
            json.dump(res, f, indent=1)
        return 0

    os.makedirs(args.out, exist_ok=True)
    pairs = []
    if args.all:
        for a in ARCH_IDS:
            if a == "paper-small":
                continue
            for s in SHAPES:
                pairs.append((a, s))
    else:
        pairs.append((args.arch, args.shape))

    for arch, shape in pairs:
        tag = f"{arch}_{shape}_{'multi' if args.multi_pod else 'single'}"
        if args.fedavg_baseline:
            tag += "_fedavg"
        if args.variant != "baseline":
            tag += f"_{args.variant}"
        out_path = os.path.join(args.out, tag + ".json")
        try:
            res = run_dryrun(arch, shape, multi_pod=args.multi_pod,
                             fl=not args.fedavg_baseline,
                             variant=args.variant,
                             optimizer=args.optimizer,
                             accum_dtype=args.accum_dtype,
                             scenario=args.scenario,
                             cd_enrolled=args.cd_enrolled,
                             cd_sample_k=args.cd_sample_k,
                             shard_workers=args.shard_workers)
        except Exception as e:  # record failures; they are bugs to fix
            traceback.print_exc()
            res = {"arch": arch, "shape": shape, "status": "FAILED",
                   "error": f"{type(e).__name__}: {e}"}
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
