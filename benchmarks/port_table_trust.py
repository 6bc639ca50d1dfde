"""The attack × trust-signal × partition grid on the PyTorch port: the
port's version of ``benchmarks/table_trust.py`` (the DTS v2/v3 bench).

    PYTHONPATH=src python benchmarks/port_table_trust.py [--epochs 40]
        [--attacks label_flip alie ...] [--signals loss geom ...]
        [--partitions iid non_iid] [--seed 0] [--device cuda]

Each cell appends k = 8 attackers of one kind to 20 vanilla workers (W =
28, ``avg_peers=4``, ``num_sampled=2``, MLP 32 → 10, 3 local epochs) on
an iid (Dirichlet α = 100) or non-iid (α = 0.5) partition, runs
``dts_signal`` ∈ loss / geom / both / corr / all, and records the final
mean honest accuracy and the trust trajectory: the mean sampling-weight
mass honest workers place on attackers (attacker-θ share) at each eval
point, which a working defence drives toward 0. ``--seed`` seeds the
data, the topology and the run's generator (parameters and draws), as the
reference's ``sweep(seed=...)`` does. Then the two headline checks:
geom or both beat loss under label_flip × non-iid (``headline_check``),
and corr or all beat every earlier signal by ≥ 0.05 under alie × non-iid
(``alie_headline_check``). Runs on the card by default (``--device cpu``
runs the kernels' plain versions). Prints each cell with its wall
seconds, then one JSON line of all rows. Imports nothing of JAX or of the
``repro`` package.
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
from repro_torch.core import dts  # noqa: E402
from repro_torch.core.defta import (attacker_world, evaluate,  # noqa: E402
                                    initial_state, scenario_world,
                                    to_device_data)
from repro_torch.core.engine import (build_defta_round,  # noqa: E402
                                     drive_epochs)
from repro_torch.core.tasks import mlp_task  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.data import federated_dataset  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.rng import TorchDraws  # noqa: E402
from repro_torch.scenarios import AttackSpec, ScenarioSpec  # noqa: E402

ATTACKS = ("label_flip", "alie", "alie_decor", "dts_dodge", "theta_aware")
SIGNALS = ("loss", "geom", "both", "corr", "all")
PARTITIONS = {"iid": 100.0, "non_iid": 0.5}


def attacker_theta_share(conf, adj, malicious) -> float:
    """Mean sampling-weight mass honest workers place on attackers (0 =
    attackers frozen out, ~k/peers = undetected)."""
    theta = dts.sample_weights(conf, torch.as_tensor(adj).to(conf.device))
    t = theta.cpu().numpy()
    return float(t[~malicious][:, malicious].sum(axis=1).mean())


def run_cell(seed, task, cfg: DeFTAConfig, train: TrainConfig, data, spec,
             *, epochs: int, eval_every: int, device):
    """One grid cell on the engine directly (the round + ``drive_epochs``)
    so the eval hook records both honest accuracy and the attacker-θ share
    at each eval point, as the reference's cell does."""
    dev = resolve_device(device)
    scenario, num_classes = scenario_world(spec, 0, cfg, data, epochs, dev)
    w, malicious, data_w, sizes = attacker_world(cfg, data, 0, scenario)
    adj = make_topology(cfg.topology, w, cfg.avg_peers, cfg.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    state = initial_state(gen, task, cfg, w, None)
    rnd_fn = build_defta_round(task, cfg, train, adj, sizes, malicious,
                               draws=TorchDraws(gen), device=dev,
                               scenario=scenario, num_classes=num_classes)

    def eval_fn(st, done):
        m, s, _ = evaluate(task, st, data["test_x"], data["test_y"],
                           malicious)
        return (done, m, s, attacker_theta_share(st.conf, adj, malicious))

    state, hist = drive_epochs(rnd_fn, state, to_device_data(data_w, dev),
                               epochs, eval_every=eval_every, eval_fn=eval_fn)
    _, acc, std, share = hist[-1]
    return dict(acc=acc, std=std, attacker_theta=share,
                trajectory=[dict(epoch=int(e), acc=float(m),
                                 attacker_theta=float(t))
                            for e, m, _, t in hist])


def sweep(epochs: int = 40, k: int = 8, num_workers: int = 20,
          attacks=ATTACKS, signals=SIGNALS, partitions=tuple(PARTITIONS),
          eval_every: int = 10, local_epochs: int = 3, seed: int = 0,
          n_per_worker: int = 120, device="cuda", verbose: bool = True):
    """The attack × signal × partition grid. Returns rows of
    dict(attack, signal, partition, acc, std, attacker_theta, trajectory,
    seconds)."""
    rows = []
    task = mlp_task(32, 10)
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    eval_every = min(eval_every, epochs)      # a short rehearsal evaluates
    for part_name in partitions:
        data = federated_dataset("vector", num_workers,
                                 np.random.default_rng(seed),
                                 n_per_worker=n_per_worker,
                                 alpha=PARTITIONS[part_name])
        for attack in attacks:
            spec = ScenarioSpec(
                name=f"{attack}_k{k}",
                attacks=tuple(AttackSpec(attack) for _ in range(k)))
            for signal in signals:
                cfg = DeFTAConfig(num_workers=num_workers, avg_peers=4,
                                  num_sampled=2, local_epochs=local_epochs,
                                  dts_signal=signal, seed=seed)
                t0 = time.perf_counter()
                cell = run_cell(seed, task, cfg, train, data, spec,
                                epochs=epochs, eval_every=eval_every,
                                device=device)
                s = time.perf_counter() - t0
                rows.append(dict(attack=attack, signal=signal,
                                 partition=part_name, k=k,
                                 num_workers=num_workers, epochs=epochs,
                                 seed=seed, seconds=s, **cell))
                if verbose:
                    traj = [round(p["attacker_theta"], 3)
                            for p in cell["trajectory"]]
                    print(f"port_trust {part_name:>7s} {attack:>11s} × "
                          f"{signal:<4s}: acc {cell['acc']:.3f}±"
                          f"{cell['std']:.2f} attacker-θ "
                          f"{cell['attacker_theta']:.3f} trajectory {traj} "
                          f"({s:.1f}s)", flush=True)
    headline_check(rows, verbose=verbose)
    alie_headline_check(rows, verbose=verbose)
    return rows


def headline_check(rows, verbose: bool = True):
    """geom or both beats loss on final mean honest accuracy under
    label_flip × non-iid. Returns (ok, by_signal); (None, accs) when the
    sweep lacks either side."""
    accs = {r["signal"]: r["acc"] for r in rows
            if r["attack"] == "label_flip" and r["partition"] == "non_iid"}
    geom_accs = [a for s, a in accs.items() if s != "loss"]
    if "loss" not in accs or not geom_accs:
        return None, accs
    ok = max(geom_accs) > accs["loss"]
    if verbose:
        print(f"port_trust headline label_flip × non-iid: loss "
              f"{accs['loss']:.3f} vs best geom-signal "
              f"{max(geom_accs):.3f} -> {'OK' if ok else 'REGRESSION'}",
              flush=True)
    return ok, accs


def alie_headline_check(rows, margin: float = 0.05, verbose: bool = True):
    """corr or all beats the best of loss / geom / both by ≥ ``margin``
    honest accuracy under alie × non-iid. Returns (ok, by_signal); (None,
    accs) when the sweep lacks either signal family."""
    accs = {r["signal"]: r["acc"] for r in rows
            if r["attack"] == "alie" and r["partition"] == "non_iid"}
    old = [a for s, a in accs.items() if s in ("loss", "geom", "both")]
    new = [a for s, a in accs.items() if s in ("corr", "all")]
    if not old or not new:
        return None, accs
    ok = max(new) >= max(old) + margin
    if verbose:
        print(f"port_trust headline alie × non-iid: best pre-corr signal "
              f"{max(old):.3f} vs best corr-signal {max(new):.3f} "
              f"(need +{margin:.2f}) -> {'OK' if ok else 'REGRESSION'}",
              flush=True)
    return ok, accs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--attacks", nargs="+", default=list(ATTACKS),
                    choices=ATTACKS)
    ap.add_argument("--signals", nargs="+", default=list(SIGNALS),
                    choices=SIGNALS)
    ap.add_argument("--partitions", nargs="+", default=list(PARTITIONS),
                    choices=sorted(PARTITIONS))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    resolve_device(args.device)            # no card: raise before any run
    print(f"card: {card_line(args.device)}; torch {torch.__version__}",
          flush=True)
    rows = sweep(args.epochs, attacks=tuple(args.attacks),
                 signals=tuple(args.signals),
                 partitions=tuple(args.partitions), seed=args.seed,
                 device=args.device)
    print(json.dumps({"epochs": args.epochs, "seed": args.seed,
                      "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
