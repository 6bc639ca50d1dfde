"""Where the PyTorch port's time goes, on one CUDA card.

    PYTHONPATH=src python benchmarks/port_profile.py [defta|trust|serve] \
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
``serve`` draws each served model at full size on the card in turn
(random weights, seed 0) and runs, after a warm-up, two
``build_prefill_step`` calls at each of its two prefill shapes and 8
decode steps of the serve loop (batch 4, after a 32-token prompt), per call
or step: DeepSeekMoE-16B at B=4, S=512 and B=1, S=4096; Mamba2-780M at
B=4, S=2048 and B=1, S=16384; Jamba-v0.1 at full width cut to one 8-layer
period (the whole model does not fit one card) at B=1, S=4096.

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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", choices=("defta", "trust", "serve"),
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
        elif args.path == "trust":
            profile_trust(args.epochs, out)
        else:
            profile_defta(args.epochs, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
