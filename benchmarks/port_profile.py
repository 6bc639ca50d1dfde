"""Where an epoch of the PyTorch port's sync DeFTA goes, on one CUDA card.

    PYTHONPATH=src python benchmarks/port_profile.py [--epochs 3] \
        [--table PATH]

Runs the Table 2 worlds of ``chip_smoke.py`` (MLP fp32 ``auto``, MLP int8
+ EF21 ``auto``, CNN fp32 ``auto``; 20 workers + 2 noise attackers) through
``repro_torch.core.defta.run_defta`` under ``torch.profiler`` after a
warm-up epoch, and prints per epoch: wall ms, each round stage's host ms
(its ``record_function`` range) and GPU span, the kernels' busy ms (the
sum of kernel times) and the device's idle share (1 - busy / wall, with
the profiler's own host overhead in the wall), plus the top kernels.
With ``--table PATH`` the profiler's full tables are written to PATH.
Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
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
from repro_torch.core.defta import run_defta  # noqa: E402
from repro_torch.core.tasks import cnn_task, mlp_task  # noqa: E402
from repro_torch.data import federated_dataset  # noqa: E402

STAGES = ("split_draws", "scenario_view", "peer_sample", "transport",
          "damage_check", "local_train", "attack_inject", "trust_update",
          "finalize")


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


def profile_world(label, kind, wire, epochs, out):
    task, cfg, train, data = world(kind, wire)
    run = lambda n: run_defta(0, task, cfg, train, data, epochs=n,  # noqa
                              num_malicious=2, gossip_backend="auto")
    run(1)                                         # warm-up (cuDNN, cuBLAS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(epochs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / epochs
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    # each stage shows up twice: its CPU range and its GPU annotation (the
    # span from its first to its last kernel); neither is a kernel
    host = {e.key: e for e in events if e.device_type != cuda}
    span = {e.key: e for e in events if e.device_type == cuda}
    kernels = sorted((e for e in events if e.device_type == cuda
                      and e.key not in STAGES
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / epochs
    print(f"{label}: wall {wall_ms:.2f} ms/epoch, kernels busy "
          f"{busy_ms:.3f} ms/epoch, device idle share "
          f"{1 - busy_ms / wall_ms:.4f}")
    for s in STAGES:
        h = host[s].cpu_time_total / 1e3 / epochs if s in host else 0.0
        g = span[s].device_time_total / 1e3 / epochs if s in span else 0.0
        print(f"  stage {s:14s} host {h:8.3f} ms/epoch  gpu span "
              f"{g:8.3f} ms/epoch")
    for e in kernels[:10]:
        print(f"  kernel {e.self_device_time_total / 1e3 / epochs:8.3f} "
              f"ms/epoch x{e.count // epochs:5d}/epoch  {e.key[:80]}")
    if out is not None:
        out.write(f"== {label}\n")
        out.write(events.table(sort_by="self_device_time_total",
                               row_limit=40))
        out.write("\n")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=3)
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
        for label, kind, wire in (("mlp fp32 auto", "mlp", "float32"),
                                  ("mlp int8+ef auto", "mlp", "int8"),
                                  ("cnn fp32 auto", "cnn", "float32")):
            profile_world(label, kind, wire, args.epochs, out)
    finally:
        if out is not None:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
