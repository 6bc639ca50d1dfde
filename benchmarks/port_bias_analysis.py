"""Theorem 3.3 / Corollaries 3.3.1–3.3.2 quantified on the PyTorch port:
the stationary-distribution bias of defta vs defl vs uniform across
topologies and world sizes (the port's version of
``benchmarks/bias_analysis.py``, whose table it prints character for
character).

    PYTHONPATH=src python benchmarks/port_bias_analysis.py [--device cpu]

For each world size W and trial, random k-out topologies (4 peers) and
dataset sizes are drawn with numpy as the reference draws them; each
scheme's mixing matrix (``core.aggregation.mixing_matrix``, the copied
module) is raised to its limit by repeated squaring in float64 on the
device (the card unless ``--device cpu``), and the bias is
``max |lim P^t − π_fedavg|``. Imports nothing of JAX or of the ``repro``
package.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.core.aggregation import fedavg_pi, mixing_matrix  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402


def stationary(P: np.ndarray, device, iters: int = 10_000,
               tol: float = 1e-12) -> torch.Tensor:
    """lim P^t by repeated squaring (``aggregation.stationary``'s loop) in
    float64 on ``device``."""
    Q = torch.as_tensor(P, dtype=torch.float64).to(device)
    for _ in range(iters):
        Q2 = Q @ Q
        if float((Q2 - Q).abs().max()) < tol:
            return Q2
        Q = Q2
    return Q


def aggregation_bias(adj, sizes, scheme: str, device) -> float:
    """|| lim P^t − π_fedavg ||_∞ (``aggregation.aggregation_bias``)."""
    pi = stationary(mixing_matrix(adj, sizes, scheme), device)
    ref = torch.as_tensor(fedavg_pi(sizes), dtype=torch.float64).to(device)
    return float((pi - ref[None, :]).abs().max())


def run(worlds=(8, 14, 20, 40, 60), trials: int = 10, device="cuda"):
    dev = resolve_device(device)
    rows = []
    for n in worlds:
        rng = np.random.default_rng(0)
        biases = {"defta": [], "defl": [], "uniform": []}
        for t in range(trials):
            sizes = rng.integers(50, 400, size=n)
            adj = make_topology("random_kout", n, 4, seed=t)
            for scheme in biases:
                biases[scheme].append(aggregation_bias(adj, sizes, scheme,
                                                       dev))
        row = dict(workers=n,
                   **{f"{k}_bias": float(np.mean(v))
                      for k, v in biases.items()})
        row["reduction"] = row["defl_bias"] / max(row["defta_bias"], 1e-12)
        rows.append(row)
        print(f"bias W={n}: defta={row['defta_bias']:.4f} "
              f"defl={row['defl_bias']:.4f} uniform={row['uniform_bias']:.4f}"
              f"  (defl/defta = {row['reduction']:.2f}x)")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
