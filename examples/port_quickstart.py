"""Quickstart on the PyTorch port: 8 workers, non-iid data, one malicious
actor, DeFTA vs FedAvg vs DeFL (the port's version of
``examples/quickstart.py``).

    PYTHONPATH=src python examples/port_quickstart.py [--device cpu]

Runs on the card unless ``--device cpu`` is given. Imports nothing of JAX
or of the ``repro`` package.
"""
import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.config import DeFTAConfig, TrainConfig  # noqa: E402
from repro_torch.core.defta import evaluate, run_defta  # noqa: E402
from repro_torch.core.fedavg import evaluate_server, run_fedavg  # noqa: E402
from repro_torch.core.tasks import mlp_task  # noqa: E402
from repro_torch.data import federated_dataset  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--epochs", type=int, default=30)
    args = ap.parse_args(argv)

    # 1. a federated dataset: 8 workers, Dirichlet non-iid label split,
    #    heterogeneous |D_i| (that heterogeneity is what DeFTA's
    #    outdegree-corrected weights are for).
    rng = np.random.default_rng(0)
    data = federated_dataset("vector", num_workers=8, rng=rng,
                             n_per_worker=150)
    print("worker dataset sizes:", data["sizes"].tolist())

    # 2. a local task (the paper's MLP class) and the DeFTA knobs
    task = mlp_task(input_dim=32, num_classes=10)
    cfg = DeFTAConfig(num_workers=8, avg_peers=4, num_sampled=2,
                      local_epochs=5)
    train = TrainConfig(learning_rate=0.05, batch_size=32)
    tx, ty = data["test_x"], data["test_y"]
    run = dict(epochs=args.epochs, num_malicious=1, device=args.device)

    # 3. DeFTA (decentralized, trustless)
    state, adj, malicious, _ = run_defta(0, task, cfg, train, data, **run)
    m, s, _ = evaluate(task, state, tx, ty, malicious)
    print(f"DeFTA   (+1 malicious): {m:.3f} ± {s:.3f}")

    # 4. baselines: FedAvg (collapses under attack), DeFL (no defense)
    st, _ = run_fedavg(0, task, cfg, train, data, **run)
    print(f"FedAvg  (+1 malicious): {evaluate_server(task, st, tx, ty):.3f}")

    cfg_defl = dataclasses.replace(cfg, aggregation="defl", use_dts=False)
    st2, _, mal2, _ = run_defta(0, task, cfg_defl, train, data, **run)
    m2, s2, _ = evaluate(task, st2, tx, ty, mal2)
    print(f"DeFL    (+1 malicious): {m2:.3f} ± {s2:.3f}")
    return m, m2


if __name__ == "__main__":
    main()
