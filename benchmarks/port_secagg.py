"""The privacy wire on the PyTorch port: the port's version of
``benchmarks/kernel_bench.py::bench_secagg`` and its contracts in
``benchmarks/bench_guard.py``.

    PYTHONPATH=src python benchmarks/port_secagg.py [--epochs 24]
        [--eval-every 6] [--device cuda]

The reference bench's world: 10 workers, MLP 32 -> 10, 3 local epochs,
non-iid (Dirichlet α = 0.5) shards of 120 examples from seed 0,
``avg_peers=4``, ``num_sampled=2``, ``epochs`` epochs. It runs the clean
world unmasked, under ``secagg="pairwise"`` and under secagg with update
DP (``dp_sigma=1.0``), and the ``masked_geom`` row family: 8 workers under
``dts_signal="geom"`` with the ``churn_signflip`` scenario, plain, secagg
``edge`` and secagg ``masked_geom``. It prints each run's vanilla accuracy
and the naive DP accountant's ε at σ ∈ {0.5, 1, 2} (``dp_epsilon``), and
checks three contracts, exiting 1 when one fails:

* mask bytes: ``secagg.secagg_mask_bytes`` over the run's topology equals
  ``roofline.secagg_pad_bytes`` for the fp32, bf16 and int8 wires, and the
  wire overhead is 0;
* clean parity: the secagg run's accuracy within 0.01 of the unmasked
  run's (the masked wire decodes bit for bit);
* host parity, in place of the reference's dispatch budget (the port has
  no XLA dispatch): a secagg run makes no more host synchronisations
  (``torch.cuda.set_sync_debug_mode("warn")``, counted over the whole
  run after a one-epoch warm-up of its config; 0 on the CPU) and no more
  chunks than the unmasked run.

Runs on the card by default (``--device cpu`` runs the kernels' plain
versions). Prints a JSON line of the results last. Imports nothing of JAX
or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))

from port_table2 import card_line  # noqa: E402
from repro_torch.config import DeFTAConfig, TrainConfig  # noqa: E402
from repro_torch.core.defta import evaluate, run_defta  # noqa: E402
from repro_torch.core.secagg import secagg_mask_bytes  # noqa: E402
from repro_torch.core.tasks import mlp_task  # noqa: E402
from repro_torch.data import federated_dataset  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.roofline import (dp_epsilon,  # noqa: E402
                                         secagg_pad_bytes)
from repro_torch.telemetry import RunLedger  # noqa: E402

CLEAN_MARGIN = 0.01


def counted_run(task, cfg, train, data, epochs, eval_every, device,
                scenario=None):
    """One ``run_defta``, after a one-epoch warm-up of the same config (so
    first-call set-up, such as a support or counter tensor made once and
    kept, is not counted): vanilla accuracy, the ledger's chunks, the host
    synchronisations counted over the whole run, wall seconds, the final
    state and topology."""
    dev = resolve_device(device)
    run_defta(0, task, cfg, train, data, epochs=1, scenario=scenario,
              device=dev)
    led = RunLedger()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.set_sync_debug_mode("warn")
        try:
            t0 = time.perf_counter()
            st, adj, mal, _ = run_defta(
                0, task, cfg, train, data, epochs=epochs, scenario=scenario,
                eval_every=eval_every, test_x=data["test_x"],
                test_y=data["test_y"], ledger=led, device=dev)
            wall = time.perf_counter() - t0
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    acc, _, _ = evaluate(task, st, data["test_x"], data["test_y"], mal)
    return dict(acc=acc, chunks=led.dispatches, syncs=syncs,
                wall_s=wall), st, adj


def bench(epochs, eval_every, device):
    task = mlp_task(32, 10)
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    cfg = DeFTAConfig(num_workers=10, avg_peers=4, num_sampled=2,
                      local_epochs=3, seed=0)
    data = federated_dataset("vector", cfg.num_workers,
                             np.random.default_rng(0), n_per_worker=120,
                             alpha=0.5)
    runs = {}
    for name, c in (("clean", cfg),
                    ("secagg", dataclasses.replace(cfg, secagg="pairwise")),
                    ("secagg_dp", dataclasses.replace(
                        cfg, secagg="pairwise", dp_sigma=1.0))):
        runs[name], st, adj = counted_run(task, c, train, data, epochs,
                                          eval_every, device)
        if name == "clean":
            clean_state, clean_adj = st, adj
        print(f"{name:10s} acc {runs[name]['acc']:.4f} chunks "
              f"{runs[name]['chunks']} host syncs {runs[name]['syncs']} "
              f"({runs[name]['wall_s']:.1f}s)", flush=True)

    a = np.asarray(clean_adj, bool).copy()
    np.fill_diagonal(a, False)
    n_params = sum(int(np.prod(v.shape[1:]))
                   for v in clean_state.params.values())
    leaves = len(clean_state.params)
    n_edges = int(a.sum())
    mask_rows = {}
    for fmt in (None, "bf16", "int8"):
        realized = secagg_mask_bytes(n_edges, n_params, fmt, rows=leaves)
        roof = secagg_pad_bytes(a, n_params, fmt, rows=leaves)
        mask_rows[fmt or "fp32"] = dict(
            realized_bytes=float(realized), roofline_bytes=roof["pad_bytes"],
            wire_overhead_bytes=roof["wire_overhead_bytes"],
            ok=float(realized) == roof["pad_bytes"]
            and roof["wire_overhead_bytes"] == 0.0)
    mask_ok = all(r["ok"] for r in mask_rows.values())

    # the masked_geom row family (churn_signflip appends its attackers to
    # the 8 workers, so it carries its own 8-worker dataset)
    cfg_g = dataclasses.replace(cfg, num_workers=8, dts_signal="geom")
    data_g = federated_dataset("vector", 8, np.random.default_rng(0),
                               n_per_worker=120, alpha=0.5)
    att = {}
    for mode, c in (("plain", cfg_g),
                    ("edge", dataclasses.replace(cfg_g, secagg="pairwise")),
                    ("masked_geom", dataclasses.replace(
                        cfg_g, secagg="pairwise",
                        secagg_mode="masked_geom"))):
        att[mode], _, _ = counted_run(task, c, train, data_g, epochs,
                                      eval_every, device,
                                      scenario="churn_signflip")
    mg_delta = att["edge"]["acc"] - att["masked_geom"]["acc"]

    clean_delta = abs(runs["clean"]["acc"] - runs["secagg"]["acc"])
    clean_ok = clean_delta <= CLEAN_MARGIN
    host_ok = all(runs[n]["syncs"] <= runs["clean"]["syncs"]
                  and runs[n]["chunks"] <= runs["clean"]["chunks"]
                  for n in ("secagg", "secagg_dp")) and all(
        att[m]["syncs"] <= att["plain"]["syncs"]
        and att[m]["chunks"] <= att["plain"]["chunks"]
        for m in ("edge", "masked_geom"))
    eps = {f"{s:g}": dp_epsilon(s, epochs) for s in (0.5, 1.0, 2.0)}
    print(f"secagg mask bytes: {n_edges} directed edges, {n_params} "
          f"parameters, ok={mask_ok} " + " ".join(
              f"{k}={v['realized_bytes'] / 1e6:.4f}MB"
              for k, v in mask_rows.items()))
    print(f"secagg masked_geom churn_signflip: plain "
          f"{att['plain']['acc']:.4f} edge {att['edge']['acc']:.4f} "
          f"masked_geom {att['masked_geom']['acc']:.4f} (edge - masked_geom "
          f"{mg_delta:+.4f})")
    print(f"dp_epsilon over {epochs} rounds (delta 1e-5): " + ", ".join(
        f"sigma {k}: {v:.2f}" for k, v in eps.items()))
    print(f"contract mask bytes: {'OK' if mask_ok else 'FAIL'}")
    print(f"contract clean parity: unmasked {runs['clean']['acc']:.4f} vs "
          f"masked {runs['secagg']['acc']:.4f} (delta {clean_delta:.4f}, "
          f"limit {CLEAN_MARGIN}) -> {'OK' if clean_ok else 'FAIL'}")
    print(f"contract host parity: syncs and chunks of secagg runs <= the "
          f"unmasked runs' -> {'OK' if host_ok else 'FAIL'}", flush=True)
    return dict(epochs=epochs, eval_every=eval_every, runs=runs,
                clean_delta=clean_delta, n_params=n_params,
                directed_edges=n_edges, mask_bytes=mask_rows,
                mask_bytes_ok=bool(mask_ok), attacked=att,
                masked_geom_delta=mg_delta, dp_epsilon=eps,
                clean_ok=bool(clean_ok), host_ok=bool(host_ok))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=24)
    ap.add_argument("--eval-every", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    resolve_device(args.device)            # no card: raise before any run
    print(f"card: {card_line(args.device)}; torch {torch.__version__}",
          flush=True)
    out = bench(args.epochs, args.eval_every, args.device)
    print(json.dumps(out))
    return 0 if out["mask_bytes_ok"] and out["clean_ok"] \
        and out["host_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
