"""Paper Table 3 on the PyTorch port: 20 vanilla workers + k malicious
actors, and the attack × defense sweep at the paper's 66 % malicious
(k = 40, W = 60); the port's version of
``benchmarks/table3_robustness.py``.

    PYTHONPATH=src python benchmarks/port_table3.py [--epochs 50]
        [--ks 1 3 5 10 20 40] [--attacks noise ...] [--defenses ...]
        [--skip-run] [--skip-sweep] [--seed 0] [--device cuda]

``run()``: CFL-S (2 sampled a round) and DeFL with one noise attacker
(the paper's failure columns), then DeFTA with k ∈ ``--ks`` noise
attackers (``num_malicious``, the static round). ``sweep()``: every attack
of ``ATTACKS`` against every defense of ``DEFENSES`` at k = 40, each a
``ScenarioSpec`` of k appended attackers; the robust rules run pure (no
DTS, no time machine), as in the reference; then the ``sweep check
noise@40`` lines (DTS against each robust baseline). The world is
``benchmarks/common.make_setup``'s (``port_table2.make_setup``); ``--seed``
seeds each run's generator (parameters and draws; the data stay those of
seed 0), to measure a cell's spread over seeds. Runs on
the card by default (``--device cpu`` runs the kernels' plain versions).
Prints each row with its wall seconds, then one JSON line of all rows.
Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))

from port_table2 import card_line, make_setup, timed  # noqa: E402
from repro_torch.core.defta import evaluate, run_defta  # noqa: E402
from repro_torch.core.fedavg import evaluate_server, run_fedavg  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.scenarios import AttackSpec, ScenarioSpec  # noqa: E402

# defense name -> (aggregation, use_dts, time_machine), the reference's
DEFENSES = {
    "defta_dts": ("defta", True, True),
    "trimmed_mean": ("trimmed_mean", False, False),
    "median": ("median", False, False),
    "krum": ("krum", False, False),
    "defl": ("defl", False, False),     # undefended reference
}

ATTACKS = ("noise", "sign_flip", "scaling", "alie", "label_flip")


def run(epochs=50, ks=(1, 3, 5, 10, 20, 40), task_name="mlp_vector",
        num_workers=20, device="cuda", seed=0):
    rows = []
    data, task, cfg, train = make_setup(task_name, num_workers)
    tx, ty = data["test_x"], data["test_y"]
    (st, _), s1 = timed(lambda: run_fedavg(
        seed, task, cfg, train, data, epochs=epochs, num_malicious=1,
        sample_workers=2, device=device), device)
    cfl_s = evaluate_server(task, st, tx, ty)
    cfg_defl = dataclasses.replace(cfg, aggregation="defl", use_dts=False)
    (st, _, mal, _), s2 = timed(lambda: run_defta(
        seed, task, cfg_defl, train, data, epochs=epochs, num_malicious=1,
        device=device), device)
    defl, defl_s, _ = evaluate(task, st, tx, ty, mal)
    print(f"port_table3 k=1 baselines: CFL-S={cfl_s:.3f} ({s1:.1f}s) "
          f"DeFL={defl:.3f}±{defl_s:.2f} ({s2:.1f}s)", flush=True)
    rows.append(dict(task=task_name, k=1, method="cfl_s", acc=cfl_s,
                     seconds=s1))
    rows.append(dict(task=task_name, k=1, method="defl", acc=defl,
                     std=defl_s, seconds=s2))
    for k in ks:
        (st, _, mal, _), s = timed(lambda: run_defta(
            seed, task, cfg, train, data, epochs=epochs, num_malicious=k,
            device=device), device)
        m, sd, _ = evaluate(task, st, tx, ty, mal)
        frac = k / (num_workers + k)
        rows.append(dict(task=task_name, k=k, method="defta", acc=m, std=sd,
                         malicious_frac=round(frac, 3), seconds=s))
        print(f"port_table3 DeFTA k={k} ({frac:.0%} malicious): "
              f"{m:.3f}±{sd:.2f} ({s:.1f}s)", flush=True)
    return rows


def sweep(epochs=50, k=40, attacks=ATTACKS, defenses=tuple(DEFENSES),
          task_name="mlp_vector", num_workers=20, device="cuda", seed=0):
    """Attack × defense grid at k attackers on ``num_workers`` vanilla
    workers; rows of dict(attack, defense, acc, std, seconds)."""
    rows = []
    data, task, cfg, train = make_setup(task_name, num_workers)
    tx, ty = data["test_x"], data["test_y"]
    for attack in attacks:
        spec = ScenarioSpec(name=f"{attack}_k{k}",
                            attacks=tuple(AttackSpec(attack)
                                          for _ in range(k)))
        for defense in defenses:
            agg, dts, tm = DEFENSES[defense]
            cfg_d = dataclasses.replace(cfg, aggregation=agg, use_dts=dts,
                                        time_machine=tm)
            (st, _, mal, _), s = timed(lambda: run_defta(
                seed, task, cfg_d, train, data, epochs=epochs, scenario=spec,
                device=device), device)
            m, sd, _ = evaluate(task, st, tx, ty, mal)
            rows.append(dict(task=task_name, attack=attack, defense=defense,
                             k=k, acc=m, std=sd, seconds=s))
            print(f"port_table3 sweep {attack:>10s} × {defense:<12s} "
                  f"(k={k}, {k / (num_workers + k):.0%} malicious): "
                  f"{m:.3f}±{sd:.2f} ({s:.1f}s)", flush=True)
    if "noise" in attacks and "defta_dts" in defenses:
        by = {(r["attack"], r["defense"]): r["acc"] for r in rows}
        dts_acc = by[("noise", "defta_dts")]
        for d in defenses:
            if d in ("defta_dts", "defl"):
                continue
            flag = "OK" if dts_acc >= by[("noise", d)] else "REGRESSION"
            print(f"port_table3 sweep check noise@{k}: defta_dts "
                  f"{dts_acc:.3f} vs {d} {by[('noise', d)]:.3f} -> {flag}",
                  flush=True)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=50)
    ap.add_argument("--ks", type=int, nargs="+", default=[1, 3, 5, 10, 20, 40])
    ap.add_argument("--attacks", nargs="+", default=list(ATTACKS),
                    choices=ATTACKS)
    ap.add_argument("--defenses", nargs="+", default=list(DEFENSES),
                    choices=sorted(DEFENSES))
    ap.add_argument("--skip-run", action="store_true")
    ap.add_argument("--skip-sweep", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    resolve_device(args.device)            # no card: raise before any run
    print(f"card: {card_line(args.device)}; torch {torch.__version__}",
          flush=True)
    out = {"epochs": args.epochs, "seed": args.seed}
    if not args.skip_run:
        out["table3"] = run(args.epochs, tuple(args.ks), device=args.device,
                            seed=args.seed)
    if not args.skip_sweep:
        out["sweep"] = sweep(args.epochs, attacks=tuple(args.attacks),
                             defenses=tuple(args.defenses),
                             device=args.device, seed=args.seed)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
