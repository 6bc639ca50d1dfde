"""Federated training of a ~100M-parameter transformer LM with DeFTA across
4 workers on the PyTorch port (the port's version of
``examples/train_federated.py``).

Each worker holds a private shard of a synthetic token stream; every
``--gossip-every`` steps they exchange params with outdegree-corrected
weights. The workers are pods of ``launch.steps``: each trains on its own
device (``--device``, every pod on the one card), and the mix runs the
``mix_pytree`` einsum backend on their stacked rows.

    PYTHONPATH=src python examples/port_train_federated.py --steps 300 \
        [--device cpu]

Runs on the card unless ``--device cpu`` is given; prints each worker's
loss and, at the end, the losses' spread across workers and the mean step
time. Imports nothing of JAX or of the ``repro`` package.
"""
import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.config import ModelConfig  # noqa: E402
from repro_torch.core.aggregation import mixing_matrix  # noqa: E402
from repro_torch.core.topology import make_topology  # noqa: E402
from repro_torch.data.loader import TokenBatcher  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.steps import (build_fl_train_step,  # noqa: E402
                                      build_gossip_step)
from repro_torch.models import model as mm  # noqa: E402
from repro_torch.optim import make_optimizer  # noqa: E402

CFG_100M = ModelConfig(
    name="repro-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=16_384,
    tie_embeddings=True, dtype="float32", scan_layers=False, remat=False)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--gossip-every", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = CFG_100M
    w = args.workers
    print(f"model: {cfg.name} ({cfg.param_count() / 1e6:.0f}M params), "
          f"{w} federated workers on {dev}")

    # per-worker data streams (different seeds = different local corpora)
    batchers = [TokenBatcher(cfg.vocab_size, args.seq, args.batch, seed=i)
                for i in range(w)]
    adj = make_topology("ring", w, 2)
    sizes = np.full(w, args.batch)
    P = torch.tensor(mixing_matrix(adj, sizes, "defta"),
                     dtype=torch.float32, device=dev)

    opt = make_optimizer("adam", args.lr)
    # one independent init per worker, as the reference's split keys
    params = [mm.init_params(torch.Generator(device=dev).manual_seed(i),
                             cfg) for i in range(w)]
    opt_state = [opt.init(p) for p in params]
    fl_step = build_fl_train_step(cfg, opt)
    gossip = build_gossip_step(cfg)

    step_s, losses = [], None
    for i in range(args.steps):
        t0 = time.time()
        batch = {k: torch.as_tensor(np.stack([b.batch_at(i)[k]
                                              for b in batchers]))
                 for k in ("tokens", "labels")}
        params, opt_state, _, losses = fl_step(params, opt_state, i, batch)
        tag = ""
        if (i + 1) % args.gossip_every == 0:
            params = gossip(params, P)
            tag = "  [gossip]"
        row = losses.tolist()                   # synchronises the step
        step_s.append(time.time() - t0)
        if i % 5 == 0 or tag:
            print(f"step {i:4d}  losses={[round(x, 3) for x in row]} "
                  f"({step_s[-1]:.2f}s){tag}")
    spread = float(losses.std(unbiased=False))
    print(f"final loss spread across workers: {spread:.4f}; mean step "
          f"{1e3 * float(np.mean(step_s[1:] or step_s)):.1f} ms")
    return {"losses": losses, "step_s": step_s, "params": params}


if __name__ == "__main__":
    main()
