"""Cross-device participation on the PyTorch port: the port's version of
``benchmarks/kernel_bench.py::bench_cross_device`` and its contracts in
``benchmarks/bench_guard.py``.

    PYTHONPATH=src python benchmarks/port_cross_device.py [--rounds 120]
        [--dense-epochs 40] [--trust-epochs 40] [--device cuda]
    PYTHONPATH=src python benchmarks/port_cross_device.py --world full
        [--rounds 30] [--signal all] [--wire float32]

The bench (the default) runs the reference bench's worlds, MLP 32 -> 10,
3 local epochs, non-iid (Dirichlet α = 0.5) shards of 120 examples from
seed 0:

* dense clean ``run_defta``: 20 workers, ``avg_peers=4``,
  ``num_sampled=2``, ``dense_epochs`` epochs;
* clean cross-device: 20 enrolled, k = 10, ``rounds`` rounds
  (availability 0.7, dropout 0.05, straggle 0.10, ``dts_conf_decay``
  0.98, ``dts_signal="loss"``);
* attacked cross-device: 28 enrolled, k = 14, ``label_flip`` 4/28 +
  ``alie`` 4/28, cohort degree 6, sample 3, under ``corr`` and ``all``;
* the dense ``alie`` × non-iid headline cells (``corr``, ``all``) of
  ``port_table_trust.py``, ``trust_epochs`` epochs;

and checks the two contracts: clean sampled probe accuracy within 0.05 of
the dense clean run, and the best attacked probe accuracy within 0.05 of
the dense alie headline. Exits 1 when either fails.

``--world full`` runs the reference launcher's ``--cross-device`` default
(``launch/train.py``): 10,000 enrolled users, k = 64, 48 examples each,
3 local epochs, ``dts_conf_decay`` 0.98, attacks ``label_flip`` 0.15 +
``alie`` 0.14, for ``rounds`` rounds under ``--signal`` on ``--wire``, and
prints ms a round (chunks of 10 rounds, each ending in a synchronize),
the peak device memory, the launches of the gossip kernels by regime and
the honest probe accuracy.

Runs on the card by default (``--device cpu`` runs the kernels' plain
versions). Prints a JSON line of the results last. Imports nothing of JAX
or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))

from port_table2 import card_line  # noqa: E402
from repro_torch.config import DeFTAConfig, TrainConfig  # noqa: E402
from repro_torch.core.cross_device import (evaluate_probe,  # noqa: E402
                                           probe_indices, run_cross_device)
from repro_torch.core.defta import evaluate, run_defta  # noqa: E402
from repro_torch.core.tasks import mlp_task  # noqa: E402
from repro_torch.data import federated_dataset  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.scenarios import CrossDeviceSpec, compile_world  # noqa
from repro_torch.telemetry import RunLedger  # noqa: E402

MARGIN = 0.05
EVAL_EVERY = 30
LAUNCHER_ATTACKS = (("label_flip", 0.15), ("alie", 0.14))


def cd_run(enrolled, k, attacks, signal, *, rounds, device, avg_peers=4,
           num_sampled=2):
    """One cross-device world of the bench: final honest probe accuracy,
    the ledger's chunks and wall seconds, the participation rate."""
    task = mlp_task(32, 10)
    cfg = DeFTAConfig(num_workers=enrolled, avg_peers=avg_peers,
                      num_sampled=num_sampled, local_epochs=3,
                      dts_signal=signal, dts_conf_decay=0.98, seed=0)
    data = federated_dataset("vector", enrolled, np.random.default_rng(0),
                             n_per_worker=120, alpha=0.5)
    spec = CrossDeviceSpec(enrolled=enrolled, sample_k=k,
                           avg_peers=avg_peers, availability=0.7,
                           dropout=0.05, straggle=0.10, attacks=attacks,
                           seed=0)
    world = compile_world(spec, rounds)
    led = RunLedger()
    state, _ = run_cross_device(
        0, task, cfg, TrainConfig(learning_rate=0.05, batch_size=32), data,
        world=world, epochs=rounds, eval_every=EVAL_EVERY,
        test_x=data["test_x"], test_y=data["test_y"], ledger=led, probes=False,
        device=device)
    m, s = evaluate_probe(task, state, data["test_x"], data["test_y"],
                          probe_indices(world, 32, seed=0))
    return dict(acc=m, std=s, chunks=led.dispatches, wall_s=led.wall_s,
                participation_rate=world.summary()["participation_rate"])


def bench(rounds, dense_epochs, trust_epochs, device):
    from port_table_trust import sweep
    data = federated_dataset("vector", 20, np.random.default_rng(0),
                             n_per_worker=120, alpha=0.5)
    cfg = DeFTAConfig(num_workers=20, avg_peers=4, num_sampled=2,
                      local_epochs=3, seed=0)
    task = mlp_task(32, 10)
    t0 = time.perf_counter()
    st, _, mal, _ = run_defta(0, task, cfg,
                              TrainConfig(learning_rate=0.05, batch_size=32),
                              data, epochs=dense_epochs, device=device)
    clean_dense, _, _ = evaluate(task, st, data["test_x"], data["test_y"],
                                 mal)
    print(f"dense clean run_defta W=20 {dense_epochs} epochs: acc "
          f"{clean_dense:.4f} ({time.perf_counter() - t0:.1f}s)", flush=True)
    clean = cd_run(20, 10, (), "loss", rounds=rounds, device=device)
    print(f"cross-device clean N=20 k=10 {rounds} rounds: probe acc "
          f"{clean['acc']:.4f}±{clean['std']:.3f} (rate "
          f"{clean['participation_rate']:.3f}, {clean['chunks']} chunks, "
          f"{clean['wall_s']:.1f}s)", flush=True)
    attacks = (("label_flip", 4 / 28), ("alie", 4 / 28))
    attacked = {}
    for sig in ("corr", "all"):
        attacked[sig] = r = cd_run(28, 14, attacks, sig, rounds=rounds,
                                   device=device, avg_peers=6,
                                   num_sampled=3)
        print(f"cross-device attacked 29% × {sig} N=28 k=14: probe acc "
              f"{r['acc']:.4f}±{r['std']:.3f} ({r['chunks']} chunks, "
              f"{r['wall_s']:.1f}s)", flush=True)
    rows = sweep(trust_epochs, attacks=("alie",), signals=("corr", "all"),
                 partitions=("non_iid",), device=device, verbose=False)
    dense_alie = {r["signal"]: r["acc"] for r in rows}
    gap = clean_dense - clean["acc"]
    clean_ok = gap <= MARGIN
    ref = max(dense_alie.values())
    best = max(r["acc"] for r in attacked.values())
    trust_ok = best >= ref - MARGIN
    print(f"contract clean parity: sampled {clean['acc']:.4f} vs dense "
          f"{clean_dense:.4f} (gap {gap:+.4f}, limit {MARGIN}) -> "
          f"{'OK' if clean_ok else 'FAIL'}")
    print(f"contract sparse-trust headline: best attacked {best:.4f} vs "
          f"dense alie headline {ref:.4f} ({dense_alie}; floor "
          f"{ref - MARGIN:.4f}) -> {'OK' if trust_ok else 'FAIL'}",
          flush=True)
    return dict(rounds=rounds, dense_epochs=dense_epochs,
                trust_epochs=trust_epochs, clean_dense_acc=clean_dense,
                clean=clean, attacked=attacked, dense_alie_accs=dense_alie,
                clean_ok=bool(clean_ok), trust_ok=bool(trust_ok))


def full_world(signal="all", wire="float32", seed=0):
    """The launcher's ``--cross-device`` default world with its attacked
    example: (task, cfg, train, data, spec)."""
    cfg = DeFTAConfig(num_workers=10_000, avg_peers=4, num_sampled=2,
                      local_epochs=3, dts_signal=signal, dts_conf_decay=0.98,
                      gossip_dtype=wire, seed=seed)
    data = federated_dataset("vector", 10_000, np.random.default_rng(seed),
                             n_per_worker=48, alpha=0.5)
    spec = CrossDeviceSpec(attacks=LAUNCHER_ATTACKS, seed=seed)
    return (mlp_task(32, 10), cfg,
            TrainConfig(learning_rate=0.05, batch_size=32), data, spec)


def run_full(rounds, signal, wire, device):
    task, cfg, train, data, spec = full_world(signal, wire)
    world = compile_world(spec, rounds)
    print(f"world: {world.summary()}", flush=True)
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    led = RunLedger()
    chunk = min(10, rounds)
    state, hist = run_cross_device(
        0, task, cfg, train, data, world=world, epochs=rounds,
        eval_every=chunk, test_x=data["test_x"], test_y=data["test_y"],
        ledger=led, probes=False, device=dev)
    per_round = [1e3 * s / chunk for s in led.superstep_s]
    peak = torch.cuda.max_memory_allocated(dev) / 1e9 \
        if dev.type == "cuda" else None
    out = dict(rounds=rounds, signal=signal, wire=wire,
               ms_per_round=per_round, peak_gb=peak,
               launches=dict(ops.REGIMES),
               probe_acc=[h[1] for h in hist])
    print(f"full world {signal} {wire}: ms a round by chunk "
          f"{[round(x, 2) for x in per_round]}, peak "
          f"{'-' if peak is None else f'{peak:.3f}'} GB, launches "
          f"{out['launches']}, probe acc {[round(a, 4) for a in out['probe_acc']]}",
          flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", choices=("bench", "full"), default="bench")
    ap.add_argument("--rounds", type=int, default=None,
                    help="bench: 120; full: 30")
    ap.add_argument("--dense-epochs", type=int, default=40)
    ap.add_argument("--trust-epochs", type=int, default=40)
    ap.add_argument("--signal", default="all",
                    choices=("loss", "geom", "both", "corr", "all"))
    ap.add_argument("--wire", default="float32",
                    choices=("float32", "bf16", "int8"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    resolve_device(args.device)            # no card: raise before any run
    print(f"card: {card_line(args.device)}; torch {torch.__version__}",
          flush=True)
    if args.world == "full":
        out = run_full(args.rounds or 30, args.signal, args.wire,
                       args.device)
        print(json.dumps(out))
        return 0
    out = bench(args.rounds or 120, args.dense_epochs, args.trust_epochs,
                args.device)
    print(json.dumps(out))
    return 0 if out["clean_ok"] and out["trust_ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
