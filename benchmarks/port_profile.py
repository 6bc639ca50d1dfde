"""Where the PyTorch port's time goes, on one CUDA card.

    PYTHONPATH=src python benchmarks/port_profile.py \
        [defta|trust|cross_device|privacy|telemetry|serve|fl] \
        [--epochs 3] [--table PATH]

``defta`` (the default) runs the Table 2 worlds of ``chip_smoke.py`` (MLP
fp32 ``auto``, MLP int8 + EF21 ``auto``, CNN fp32 ``auto``; 20 workers + 2
noise attackers) through ``repro_torch.core.defta.run_defta`` after a
warm-up epoch, per epoch; then the MLP world through ``run_fedavg`` (CFL-F
and FedAdam, per epoch) and ``run_async_defta`` (fp32 ``auto``, per
tick); then the Table 3 world (the MLP world with 40 noise attackers, W =
60) under the ``paper_noise@40`` scenario with DTS and with each robust
rule (trimmed_mean, median, krum; no DTS, no time machine), per epoch: a
robust rule's ``transport`` stage is the rule itself (no mix runs).
``trust`` runs the Table 3 world with 40 ``alie`` colluders (the
scenario of ``chip_smoke.py`` [4t]) under ``dts_signal`` loss, geom, corr
and all, per epoch: the ``trust_update`` stage carries the geometry
scores, the sketch ring buffer and the correlation scores.
``cross_device`` runs the reference launcher's ``--cross-device`` world
at full width (10,000 enrolled users, k = 64, ``label_flip`` 0.15 +
``alie`` 0.14; ``port_cross_device.full_world``) under ``all`` on
``auto``, per round, after 3 warm-up rounds; then one more round stage by
stage, each stage under ``torch.cuda.set_sync_debug_mode("error")`` (a
stage that reads back to the host is reported, and exits 1 if it is
``participation``, ``trust_update`` or ``scatter_merge``) and each under
its own profiler to count its launches.
``privacy`` runs the Table 2 world (MLP fp32 ``auto``, 20 workers + 2
noise attackers) plain, under secagg (fp32 and int8 + EF21), under update
DP (``dp_sigma`` 1, with and without secagg) and under DP-SGD (``dp_clip``
1, ``dp_sigma`` 0.5), per epoch, then the full-width cross-device world
under ``all`` plain and with secagg and update DP, per round; after each
window one more round stage by stage, each stage under its own profiler,
for the launches of ``transport``, ``local_train`` and ``dp_noise``.
``telemetry`` runs the Table 2 and Table 3 worlds per epoch, async DeFTA
per tick and the full-width cross-device world per round, each with the
telemetry probes off and on in turn (off, on, on, off), for the probes'
launches and ms (``profile_telemetry``).
``serve`` draws each served model at full size on the card in turn
(random weights, seed 0) and runs, after a warm-up, two
``build_prefill_step`` calls at each of its two prefill shapes and 8
decode steps of the serve loop (batch 4, after a 32-token prompt), per call
or step: DeepSeekMoE-16B at B=4, S=512 and B=1, S=4096; Mamba2-780M at
B=4, S=2048 and B=1, S=16384; Jamba-v0.1 at full width cut to one 8-layer
period (the whole model does not fit one card) at B=1, S=4096.
``fl`` runs the launcher's ``--fl`` path at paper-small's full width, 4
pods on the card: the FL train step per step, then the pod gossip round
per round on the in-process fp32 wire, the cross-pod ring (fp32, int8 +
EF21) and under ``--pod-dts --dts-signal all`` (``profile_fl``).

Each window runs under ``torch.profiler`` and prints: the wall ms
(synchronized; the profiler's own host overhead is in it), the kernels' busy ms
(the sum of kernel times), the device's idle share (1 - busy / wall), the
kernel launches, the busy ms by kernel family (the port's own kernels,
cuBLAS/CUTLASS GEMMs, everything else) and the top kernels; for DeFTA also each
round stage's host ms (its ``record_function`` range) and GPU span (FedAvg's
six stages; a tick's are the DeFTA round's); for serving
also the ms of the kernels that the MoE grouped dispatch ran before the fused
route-and-slot kernel (``OLD_DISPATCH``: the rank's outer-dim ``cumsum``, the
sorted ``index_put_``, the combine's ``index_add_``), 0 where the window no
longer runs them. With ``--table PATH`` the profiler's full tables are written
to PATH.
Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.config import DeFTAConfig, TrainConfig  # noqa: E402
from repro_torch.core.async_defta import run_async_defta  # noqa: E402
from repro_torch.core.defta import run_defta  # noqa: E402
from repro_torch.core.fedavg import run_fedavg  # noqa: E402
from repro_torch.core.tasks import cnn_task, mlp_task  # noqa: E402
from repro_torch.data import federated_dataset  # noqa: E402

STAGES = ("split_draws", "scenario_view", "peer_sample", "transport",
          "damage_check", "local_train", "attack_inject", "trust_update",
          "finalize")
SCENARIO_STAGES = STAGES[:-1] + ("fire_merge",)
CROSS_DEVICE_STAGES = ("participation", "split_draws", "peer_sample",
                       "transport", "damage_check", "local_train",
                       "attack_inject", "trust_update", "scatter_merge")
PRIVACY_STAGES = STAGES[:6] + ("dp_noise",) + STAGES[6:]
CROSS_DEVICE_PRIVACY_STAGES = CROSS_DEVICE_STAGES[:6] + ("dp_noise",) \
    + CROSS_DEVICE_STAGES[6:]
PRIVACY_WORLDS = (("plain", {}), ("secagg", dict(secagg="pairwise")),
                  ("secagg int8+ef", dict(secagg="pairwise",
                                          gossip_dtype="int8")),
                  ("update dp", dict(dp_sigma=1.0)),
                  ("secagg + update dp", dict(secagg="pairwise",
                                              dp_sigma=1.0)),
                  ("dp-sgd", dict(dp_clip=1.0, dp_sigma=0.5)))
PRIVACY_COUNTED = ("transport", "local_train", "dp_noise")
NO_SYNC_STAGES = ("participation", "trust_update", "scatter_merge")
FEDAVG_STAGES = ("split_draws", "star_broadcast", "local_train",
                 "attack_inject", "star_aggregate", "server_update")
FAMILIES = (("gossip_mix", ("mix_kernel",)),
            ("flash_attention", ("flash_kernel", "flash_tc_kernel")),
            ("moe_router", ("router_kernel", "route_slots_kernel")),
            ("ssd_chunk", ("ssd_chunk_kernel", "ssd_tc_kernel")),
            ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas",
                      "sm90_")))
# the MoE grouped dispatch's scans and sorted scatters before the fused
# route-and-slot kernel: the rank's int64 cumsum over the outer dim, the
# sort behind index_put_(accumulate=True), the combine's index_add_
OLD_DISPATCH = ("scan_outer_dim", "indexing_backward_kernel", "radixsort",
                "indexfunclargeindex", "indexfuncsmallindex")
# (arch, prefill (batch, seq) shapes, layers kept: None for all)
SERVE_MODELS = (("deepseek-moe-16b", ((4, 512), (1, 4096)), None),
                ("mamba2-780m", ((4, 2048), (1, 16384)), None),
                ("jamba-v0.1-52b", ((1, 4096),), 8))
PROMPT, DECODE_STEPS = 32, 8


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def profile_window(label, fn, units, unit, out, stages=()):
    """Run ``fn`` (``units`` epochs, calls or steps) once under the
    profiler and print its numbers per ``unit``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / units
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # each stage shows up twice: its CPU range and its GPU annotation (the
    # span from its first to its last kernel); neither is a kernel
    host = {e.key: e for e in events if e.device_type != cuda}
    span = {e.key: e for e in events if e.device_type == cuda}
    kernels = sorted((e for e in events if e.device_type == cuda
                      and e.key not in stages
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: -e.self_device_time_total)
    per = {e.key: e.self_device_time_total / 1e3 / units for e in kernels}
    busy_ms = sum(per.values())
    fams = {}
    for name, ms in per.items():
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    print(f"{label}: wall {wall_ms:.2f} ms/{unit}, kernels busy "
          f"{busy_ms:.3f} ms/{unit}, device idle share "
          f"{1 - busy_ms / wall_ms:.4f}, kernel launches "
          f"{sum(e.count for e in kernels) // units}/{unit}")
    print("  by family: " + ", ".join(
        f"{f} {ms:.3f} ms ({ms / busy_ms:.1%})"
        for f, ms in sorted(fams.items(), key=lambda x: -x[1])))
    old = [e for e in kernels if any(k in e.key.lower()
                                     for k in OLD_DISPATCH)]
    if not stages:
        print(f"  MoE dispatch scans and sorted scatters (cumsum, sorted "
              f"index_put_, index_add_): "
              f"{sum(per[e.key] for e in old):.3f} ms/{unit} in "
              f"{sum(e.count for e in old) // units} launches/{unit}")
    for s in stages:
        h = host[s].cpu_time_total / 1e3 / units if s in host else 0.0
        g = span[s].device_time_total / 1e3 / units if s in span else 0.0
        print(f"  stage {s:14s} host {h:8.3f} ms/{unit}  gpu span "
              f"{g:8.3f} ms/{unit}")
    for e in kernels[:12]:
        print(f"  kernel {per[e.key]:8.3f} ms x{e.count // units:5d}  "
              f"{e.key[:90]}")
    if out is not None:
        out.write(f"== {label}\n")
        out.write(events.table(sort_by="self_device_time_total",
                               row_limit=40))
        out.write("\n")


def world(kind: str, wire: str):
    rng = np.random.default_rng(0)
    if kind == "cnn":
        data = federated_dataset("image", 20, rng, hw=10, n_per_worker=100)
        task = cnn_task(10, 1, 10, width=8)
    else:
        data = federated_dataset("vector", 20, rng, n_per_worker=150)
        task = mlp_task(32, 10)
    cfg = DeFTAConfig(num_workers=20, avg_peers=4, num_sampled=2,
                      local_epochs=5, seed=0, gossip_dtype=wire)
    return task, cfg, TrainConfig(learning_rate=0.05, batch_size=32), data


def profile_defta(epochs, out):
    for label, kind, wire in (("mlp fp32 auto", "mlp", "float32"),
                              ("mlp int8+ef auto", "mlp", "int8"),
                              ("cnn fp32 auto", "cnn", "float32")):
        task, cfg, train, data = world(kind, wire)
        run = lambda n: run_defta(0, task, cfg, train, data,  # noqa: E731
                                  epochs=n, num_malicious=2,
                                  gossip_backend="auto")
        run(1)                                     # warm-up (cuDNN, cuBLAS)
        profile_window(label, lambda: run(epochs), epochs, "epoch", out,
                       stages=STAGES)
    task, cfg, train, data = world("mlp", "float32")
    for label, opt in (("mlp cfl-f", "none"), ("mlp fedadam", "fedadam")):
        run = lambda n: run_fedavg(0, task, cfg, train, data,  # noqa: E731
                                   epochs=n, num_malicious=2,
                                   server_opt=opt)
        run(1)
        profile_window(label, lambda: run(epochs), epochs, "epoch", out,
                       stages=FEDAVG_STAGES)
    run = lambda n: run_async_defta(0, task, cfg, train, data,  # noqa: E731
                                    ticks=n, num_malicious=2)
    run(1)
    profile_window("mlp async fp32 auto", lambda: run(epochs), epochs,
                   "tick", out, stages=STAGES)
    for label, change in (("table3 paper_noise@40 dts", {}),
                          ("table3 trimmed_mean", {"aggregation":
                                                   "trimmed_mean"}),
                          ("table3 median", {"aggregation": "median"}),
                          ("table3 krum", {"aggregation": "krum"})):
        c = cfg if not change else dataclasses.replace(
            cfg, use_dts=False, time_machine=False, **change)
        run = lambda n: run_defta(0, task, c, train, data,  # noqa: E731
                                  epochs=n, scenario="paper_noise@40")
        run(1)
        profile_window(label, lambda: run(epochs), epochs, "epoch", out,
                       stages=SCENARIO_STAGES)


def profile_trust(epochs, out):
    from repro_torch.scenarios import AttackSpec, ScenarioSpec
    task, cfg, train, data = world("mlp", "float32")
    spec = ScenarioSpec(attacks=tuple(AttackSpec("alie") for _ in range(40)))
    for signal in ("loss", "geom", "corr", "all"):
        c = dataclasses.replace(cfg, dts_signal=signal)
        run = lambda n: run_defta(0, task, c, train, data,  # noqa: E731
                                  epochs=n, scenario=spec)
        run(1)
        profile_window(f"table3 alie@40 {signal}", lambda: run(epochs),
                       epochs, "epoch", out, stages=SCENARIO_STAGES)


def stage_launches(stages, c) -> dict:
    """Run one round's stages in order over the context ``c``, each under
    its own profiler; returns the kernel launches of each stage."""
    counts = {}
    for name, fn in stages:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn(c)
            torch.cuda.synchronize()
        counts[name] = sum(
            e.count for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.key != name)
    return counts


def cross_device_round(change, rounds, telemetry=None):
    """The full-width cross-device world under ``all`` with the config
    ``change``, built as a round over a population on the card (with the
    ``telemetry`` registry, if one is given); returns (round, [state],
    device data, world, run(ts)) after 3 warm-up rounds, the world
    compiled for ``rounds`` + 2 more."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    from port_cross_device import full_world
    from repro_torch.core.cross_device import initial_population
    from repro_torch.core.defta import to_device_data
    from repro_torch.core.engine import build_cross_device_round
    from repro_torch.rng import TorchDraws
    from repro_torch.scenarios import compile_world

    task, cfg, train, data, spec = full_world("all")
    cfg = dataclasses.replace(cfg, **change)
    world = compile_world(spec, 3 + rounds + 2)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    box = [initial_population(gen, task, cfg, world.enrolled, None)]
    rnd = build_cross_device_round(
        task, cfg, train, world, data["sizes"], draws=TorchDraws(gen),
        device=dev, num_classes=int(np.max(data["y"])) + 1,
        telemetry=telemetry)
    tdata = to_device_data(data, dev)

    def run(ts):
        for t in ts:
            out = rnd(box[0], tdata, t)
            box[0] = out if telemetry is None else out[0]
    run(range(3))
    return rnd, box, tdata, world, run


def profile_cross_device(rounds, out) -> bool:
    """The full-width cross-device window; returns False when a stage of
    ``NO_SYNC_STAGES`` reads back to the host."""
    from repro_torch.kernels import ops

    warm = 3
    rnd, box, tdata, world, run = cross_device_round({}, rounds)
    ops.reset_launches()
    profile_window(f"cross-device full world all N={world.enrolled} "
                   f"k={world.sample_k}", lambda: run(range(warm, warm
                                                            + rounds)),
                   rounds, "round", out, stages=CROSS_DEVICE_STAGES)
    print(f"  gossip launches a round by regime: "
          f"{ {k: v / rounds for k, v in ops.REGIMES.items()} }")
    ok = True
    c = {"state": box[0], "data": tdata, "epoch": warm + rounds}
    for name, fn in rnd.stages:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn(c)
            synced = False
        except RuntimeError:
            synced = True
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if synced:
            fn(c)
        ok = ok and not (synced and name in NO_SYNC_STAGES)
        print(f"  stage {name:14s} "
              f"{'reads back to the host' if synced else 'no host synchronisation'}")
    c = {"state": c["next"], "data": tdata, "epoch": warm + rounds + 1}
    for name, n in stage_launches(rnd.stages, c).items():
        print(f"  stage {name:14s} launches {n}")
    return ok


def profile_telemetry(epochs, out):
    """The telemetry windows, probes off, on, on, off in turn (a
    ``RunLedger`` each; ``probes=False`` builds the round without a
    registry): the Table 2 world (MLP fp32 ``auto``, 20 workers + 2 noise
    attackers) and the Table 3 world (``paper_noise@40``, W = 60) per
    epoch and async DeFTA in the Table 2 world per tick, each a whole run
    after a warm-up run; then the full-width cross-device world under
    ``all`` per round through ``engine.drive_epochs``, which writes each
    round's frame into the chunk's buffers when the round carries a
    registry."""
    from repro_torch.core.engine import drive_epochs
    from repro_torch.telemetry import RunLedger, Telemetry
    task, cfg, train, data = world("mlp", "float32")
    runs = (("table2 mlp fp32 auto", "epoch", STAGES,
             lambda n, on: run_defta(0, task, cfg, train, data, epochs=n,
                                     num_malicious=2, ledger=RunLedger(),
                                     probes=on)),
            ("table3 paper_noise@40", "epoch", SCENARIO_STAGES,
             lambda n, on: run_defta(0, task, cfg, train, data, epochs=n,
                                     scenario="paper_noise@40",
                                     ledger=RunLedger(), probes=on)),
            ("table2 async fp32 auto", "tick", STAGES,
             lambda n, on: run_async_defta(0, task, cfg, train, data,
                                           ticks=n, num_malicious=2,
                                           ledger=RunLedger(), probes=on)))
    for label, unit, stages, run in runs:
        run(1, True)
        for on in (False, True, True, False):
            profile_window(f"{label} probes {'on' if on else 'off'}",
                           lambda: run(epochs, on), epochs, unit, out,
                           stages=stages)
    for on in (False, True, True, False):
        rnd, box, tdata, _, _ = cross_device_round(
            {}, epochs, telemetry=Telemetry() if on else None)
        profile_window(f"cross-device full world all probes "
                       f"{'on' if on else 'off'}",
                       lambda: drive_epochs(rnd, box[0], tdata, epochs,
                                            ledger=RunLedger()),
                       epochs, "round", out, stages=CROSS_DEVICE_STAGES)
        del rnd, box
        torch.cuda.empty_cache()


def profile_privacy(epochs, out):
    """The privacy windows: the Table 2 world per epoch, then the
    full-width cross-device world per round, with the launches of one more
    round by stage."""
    from repro_torch.core.defta import attacker_world, to_device_data
    from repro_torch.core.engine import (build_defta_round, init_state,
                                         sketch_shape)
    from repro_torch.core.gossip import uses_error_feedback
    from repro_torch.core.topology import make_topology
    from repro_torch.rng import TorchDraws

    task, cfg0, train, data = world("mlp", "float32")
    dev = torch.device("cuda")
    for label, change in PRIVACY_WORLDS:
        cfg = dataclasses.replace(cfg0, **change)
        run = lambda n: run_defta(0, task, cfg, train, data,  # noqa: E731
                                  epochs=n, num_malicious=2)
        run(1)
        profile_window(f"privacy table2 {label}", lambda: run(epochs),
                       epochs, "epoch", out, stages=PRIVACY_STAGES)
        w, mal, wdata, sizes = attacker_world(cfg, data, 2)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        state = init_state(gen, task, w, wire_error=uses_error_feedback(cfg),
                           sketch=sketch_shape(cfg))
        rnd = build_defta_round(task, cfg, train,
                                make_topology(cfg.topology, w,
                                              cfg.avg_peers, cfg.seed),
                                sizes, mal, draws=TorchDraws(gen),
                                device=dev)
        tdata = to_device_data(wdata, dev)
        state = rnd(state, tdata, 0)
        n = stage_launches(rnd.stages, {"state": state, "data": tdata,
                                        "epoch": 1})
        print("  launches a round: " + ", ".join(
            f"{k} {n.get(k, 0)}" for k in PRIVACY_COUNTED))
    for label, change in (("all", {}),
                          ("all secagg + update dp",
                           dict(secagg="pairwise", dp_sigma=1.0))):
        rnd, box, tdata, world_, run = cross_device_round(change, epochs)
        profile_window(f"privacy cross-device {label} N={world_.enrolled} "
                       f"k={world_.sample_k}",
                       lambda: run(range(3, 3 + epochs)), epochs, "round",
                       out, stages=CROSS_DEVICE_PRIVACY_STAGES)
        n = stage_launches(rnd.stages, {"state": box[0], "data": tdata,
                                        "epoch": 3 + epochs})
        print("  launches a round: " + ", ".join(
            f"{k} {n.get(k, 0)}" for k in PRIVACY_COUNTED))
        del rnd, box
        torch.cuda.empty_cache()


def repeat(fn, n):
    for _ in range(n):
        fn()


def profile_serve(out):
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import model

    dev = resolve_device(None)
    for arch, shapes, layers in SERVE_MODELS:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, num_layers=layers)
            arch = f"{arch} ({layers} layers)"
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = model.init_params(gen, cfg)
        prefill, decode = build_prefill_step(cfg), build_decode_step(cfg)
        for b, s in shapes:
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                             generator=gen, device=dev)}
            prefill(params, batch)                       # warm-up
            profile_window(f"{arch} prefill B={b} S={s}",
                           lambda: repeat(lambda: prefill(params, batch), 2),
                           2, "call", out)
            del batch
        total = PROMPT + 2 * DECODE_STEPS
        cache = model.init_cache(cfg, 4, total)
        tokens = torch.randint(0, cfg.vocab_size, (4, 1), generator=gen,
                               device=dev)
        pos = iter(range(total))
        step = lambda: decode(params, tokens, cache, next(pos))  # noqa: E731
        repeat(step, PROMPT + DECODE_STEPS)   # the prompt, then a warm-up
        profile_window(f"{arch} decode batch=4 (positions "
                       f"{PROMPT + DECODE_STEPS}..{total - 1})",
                       lambda: repeat(step, DECODE_STEPS), DECODE_STEPS,
                       "step", out)
        del params, cache
        torch.cuda.empty_cache()


POD_STAGES = ("split_draws", "scenario_view", "peer_sample", "transport",
              "damage_check", "attack_inject", "trust_update", "finalize")
FL_PODS = 4


def profile_fl(out):
    """The launcher's ``--fl`` path at paper-small's full width (2 layers,
    d 256, vocab 33,278, bf16; 4 pods on the card, 2 sequences of 128 a
    pod): the FL train step (the pods in turn, each a forward with the
    flash kernel and a backward through its plain version) per step, then
    the pod gossip round per round on the in-process fp32 wire, the
    cross-pod ring fp32 and int8 + EF21, and in-process fp32 under
    ``--pod-dts --dts-signal all`` (the geometry and correlation channels
    over the pods' whole models), after a warm-up."""
    from repro_torch.config import DeFTAConfig
    from repro_torch.configs import get_config
    from repro_torch.core import pods as pods_mod
    from repro_torch.core.engine import init_pod_state, sketch_shape
    from repro_torch.core.topology import make_topology
    from repro_torch.data.loader import TokenBatcher
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import (build_fl_train_step,
                                          build_pod_gossip_step)
    from repro_torch.models import model
    from repro_torch.optim import make_optimizer
    from repro_torch.rng import TorchDraws

    dev = resolve_device(None)
    cfg = get_config("paper-small")
    devices = [dev] * FL_PODS
    params = model.init_params(torch.Generator(device=dev).manual_seed(0),
                               cfg)
    opt = make_optimizer("adam", 1e-3)
    pod_params = pods_mod.replicate(params, devices)
    pod_opt = [opt.init(p) for p in pod_params]
    fl_step = build_fl_train_step(cfg, opt)
    batcher = TokenBatcher(cfg.vocab_size, 128, 8)
    batches = [{k: torch.as_tensor(v).reshape(FL_PODS, 2, -1)
                for k, v in batcher.batch_at(i).items()} for i in range(8)]
    state = {"p": pod_params, "o": pod_opt, "step": 0, "losses": None}

    def train(n):
        for i in range(n):
            state["p"], state["o"], state["step"], state["losses"] = \
                fl_step(state["p"], state["o"], state["step"],
                        batches[i % len(batches)])
    train(2)                                         # warm-up
    profile_window("fl step (4 pods, paper-small, bf16)",
                   lambda: train(4), 4, "step", out)
    adj = make_topology("dense", FL_PODS, FL_PODS - 1)
    for label, transport, kw in (
            ("in_jit fp32", "in_jit", {}),
            ("ring fp32", "ppermute", {}),
            ("ring int8+ef", "ppermute", dict(gossip_dtype="int8")),
            ("in_jit fp32 dts all", "in_jit",
             dict(use_dts=True, dts_signal="all"))):
        dcfg = DeFTAConfig(num_workers=FL_PODS, avg_peers=FL_PODS - 1,
                           num_sampled=2, topology="dense",
                           time_machine=False,
                           **dict(dict(use_dts=False), **kw))
        rnd, _ = build_pod_gossip_step(
            cfg, dcfg, FL_PODS, np.full(FL_PODS, 8), adjacency=adj,
            transport=transport, pods=devices, device=dev,
            draws=TorchDraws(torch.Generator(device=dev).manual_seed(101)))
        pst = init_pod_state(FL_PODS, state["p"],
                             wire_error=dcfg.gossip_dtype == "int8",
                             sketch=sketch_shape(dcfg), device=dev)
        box = {"ps": pst, "p": state["p"]}

        def gossip(n):
            for _ in range(n):
                box["ps"], box["p"] = rnd(box["ps"], box["p"],
                                          state["losses"], state["p"])
        gossip(2)                                    # warm-up
        profile_window(f"pod gossip round {label}", lambda: gossip(3), 3,
                       "round", out, stages=POD_STAGES)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?",
                    choices=("defta", "trust", "cross_device", "privacy",
                             "telemetry", "serve", "fl"),
                    default="defta")
    ap.add_argument("--epochs", type=int, default=3,
                    help="DeFTA and FedAvg epochs (async ticks) to profile")
    ap.add_argument("--table", help="write the full profiler tables here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("port_profile: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}")
    out = open(args.table, "w") if args.table else None
    try:
        if args.path == "serve":
            profile_serve(out)
        elif args.path == "fl":
            profile_fl(out)
        elif args.path == "trust":
            profile_trust(args.epochs, out)
        elif args.path == "cross_device":
            if not profile_cross_device(args.epochs, out):
                return 1
        elif args.path == "privacy":
            profile_privacy(args.epochs, out)
        elif args.path == "telemetry":
            profile_telemetry(args.epochs, out)
        else:
            profile_defta(args.epochs, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
