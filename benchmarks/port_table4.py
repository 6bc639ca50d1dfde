"""Paper Table 4 on the PyTorch port: synchronous DeFTA against AsyncDeFTA
at an equal budget and AsyncDeFTA-L (three times the ticks), the port's
version of ``benchmarks/table4_async.py``.

    PYTHONPATH=src python benchmarks/port_table4.py [--epochs 50]
        [--task mlp_vector] [--workers 20] [--device cuda]

The world is ``benchmarks/common.make_setup``'s (``port_table2.make_setup``).
Sync DeFTA runs ``epochs`` epochs, AsyncDeFTA ``epochs`` ticks and
AsyncDeFTA-L ``3 * epochs`` ticks, with no target. Claim checked: async
trails sync at an equal budget and catches up given more ticks. Runs on
the card by default (``--device cpu`` runs the kernels' plain versions).
Prints each method's vanilla accuracy (mean ± std), the per-worker epochs
the async runs reached and the wall seconds, then one JSON line of all
rows. Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from port_table2 import TASKS, card_line, make_setup, timed
from repro_torch.core.async_defta import run_async_defta
from repro_torch.core.defta import evaluate, run_defta
from repro_torch.device import resolve_device


def run(epochs=50, task_name="mlp_vector", num_workers=20, device="cuda"):
    data, task, cfg, train = make_setup(task_name, num_workers)
    tx, ty = data["test_x"], data["test_y"]
    (st, _, mal, _), s = timed(lambda: run_defta(
        0, task, cfg, train, data, epochs=epochs, device=device), device)
    m, sd, _ = evaluate(task, st, tx, ty, mal)
    rows = [dict(method="defta_sync", acc=m, std=sd, seconds=s,
                 epochs=[epochs, epochs])]
    print(f"port_table4 DeFTA(sync) {epochs} epochs: {m:.3f}±{sd:.2f} "
          f"({s:.1f}s)", flush=True)
    for name, ticks in (("async", epochs), ("async_long", 3 * epochs)):
        (st, _, mal, _), s = timed(lambda: run_async_defta(
            0, task, cfg, train, data, ticks=ticks, device=device), device)
        m, sd, _ = evaluate(task, st, tx, ty, mal)
        eps = st.epoch.cpu().numpy()[~mal]
        rows.append(dict(method=name, acc=m, std=sd, seconds=s,
                         epochs=[int(eps.min()), int(eps.max())]))
        print(f"port_table4 {name} ({ticks} ticks, epochs "
              f"{eps.min()}-{eps.max()}): {m:.3f}±{sd:.2f} ({s:.1f}s)",
              flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--task", default="mlp_vector", choices=sorted(TASKS))
    ap.add_argument("--workers", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    resolve_device(args.device)            # no card: raise before any run
    print(f"card: {card_line(args.device)}; torch {torch.__version__}",
          flush=True)
    rows = run(args.epochs, args.task, args.workers, args.device)
    print(json.dumps({"table4": rows, "epochs": args.epochs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
