"""Paper Table 2 on the PyTorch port: accuracy of CFL-F / CFL-S / DeFTA /
DeFL across world sizes, the port's version of
``benchmarks/table2_performance.py``.

    PYTHONPATH=src python benchmarks/port_table2.py [--epochs 50]
        [--worlds 8 14 20] [--tasks mlp_vector cnn_image] [--device cuda]

The worlds are ``benchmarks/common.make_setup``'s (``make_setup`` below is
its copy: synthetic non-iid data from seed 0, ``avg_peers=4``,
``num_sampled=2``, ``local_epochs=5``); CFL-S samples 2 workers a round;
DeFL is DeFTA with ``aggregation="defl"`` and no DTS. Claim checked: DeFTA
≈ CFL-S > DeFL, the gap growing with the world (non-iid-ness). Runs on the
card by default (``--device cpu`` runs the kernels' plain versions). Prints
each method's accuracy (vanilla mean ± std for the decentralized ones,
the server's for FedAvg) and wall seconds, then one JSON line of all rows.
Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.config import DeFTAConfig, TrainConfig  # noqa: E402
from repro_torch.core.defta import evaluate, run_defta  # noqa: E402
from repro_torch.core.fedavg import evaluate_server, run_fedavg  # noqa: E402
from repro_torch.core.tasks import cnn_task, mlp_task  # noqa: E402
from repro_torch.data import federated_dataset  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

TASKS = {
    "mlp_vector": ("vector", lambda: mlp_task(32, 10)),
    "cnn_image": ("image", lambda: cnn_task(10, 1, 10, width=8)),
}


def make_setup(task_name: str, num_workers: int, seed: int = 0,
               n_per_worker: int = 150):
    """``benchmarks/common.make_setup`` for the port's tasks."""
    kind, mk = TASKS[task_name]
    rng = np.random.default_rng(seed)
    kw = {"hw": 10, "n_per_worker": 100} if kind == "image" else \
        {"n_per_worker": n_per_worker}
    data = federated_dataset(kind, num_workers, rng, **kw)
    cfg = DeFTAConfig(num_workers=num_workers, avg_peers=4, num_sampled=2,
                      local_epochs=5, seed=seed)
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    return data, mk(), cfg, train


def timed(fn, device):
    """fn()'s result and its wall seconds, ended by a synchronize."""
    t0 = time.perf_counter()
    out = fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def card_line(device) -> str:
    if torch.device(device).type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def run(epochs=50, worlds=(8, 14, 20), tasks=("mlp_vector", "cnn_image"),
        device="cuda"):
    rows = []
    for task_name in tasks:
        for w in worlds:
            data, task, cfg, train = make_setup(task_name, w)
            tx, ty = data["test_x"], data["test_y"]
            row = dict(task=task_name, workers=w)
            for name, sample in (("cfl_f", 0), ("cfl_s", 2)):
                (st, _), s = timed(lambda: run_fedavg(
                    0, task, cfg, train, data, epochs=epochs,
                    sample_workers=sample, device=device), device)
                row[name] = evaluate_server(task, st, tx, ty)
                row[f"{name}_s"] = s
            cfg_defl = dataclasses.replace(cfg, aggregation="defl",
                                           use_dts=False)
            for name, c in (("defta", cfg), ("defl", cfg_defl)):
                (st, _, mal, _), s = timed(lambda: run_defta(
                    0, task, c, train, data, epochs=epochs, device=device),
                    device)
                row[name], row[f"{name}_std"], _ = evaluate(task, st, tx,
                                                            ty, mal)
                row[f"{name}_s"] = s
            rows.append(row)
            print(f"port_table2 {task_name} W={w}: "
                  f"CFL-F={row['cfl_f']:.3f} ({row['cfl_f_s']:.1f}s) "
                  f"CFL-S={row['cfl_s']:.3f} ({row['cfl_s_s']:.1f}s) "
                  f"DeFTA={row['defta']:.3f}±{row['defta_std']:.2f} "
                  f"({row['defta_s']:.1f}s) "
                  f"DeFL={row['defl']:.3f}±{row['defl_std']:.2f} "
                  f"({row['defl_s']:.1f}s)", flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--worlds", type=int, nargs="+", default=[8, 14, 20])
    ap.add_argument("--tasks", nargs="+", default=["mlp_vector", "cnn_image"],
                    choices=sorted(TASKS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    resolve_device(args.device)            # no card: raise before any run
    print(f"card: {card_line(args.device)}; torch {torch.__version__}",
          flush=True)
    rows = run(args.epochs, tuple(args.worlds), tuple(args.tasks),
               args.device)
    print(json.dumps({"table2": rows, "epochs": args.epochs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
