"""Worker-axis scaling of the port's sharded transport (the port of
``benchmarks/kernel_bench.py::bench_w_scaling``).

    PYTHONPATH=src python3 benchmarks/port_shard_scaling.py [--out PATH]
    PYTHONPATH=src python3 benchmarks/port_shard_scaling.py --device cpu

For W in {500, 2000, 10000} x shards in {1, 4, 8}, all shards on one card
(``["cuda:0"] * S``: one 1-D "mesh" of S shard devices that name the same
card), one F = 256 leaf on the reference's topology (``random_kout``, 4
peers, seed 0) with a uniform row-stochastic P on its support. Per row:

* ``err_vs_single_shard``: max |mix - the one-shard mix| at that W (the
  reference's limit, 5e-5);
* ``ring_bytes_ok``: ``WorkerShardPlan.ring_bytes`` equals the independent
  ``launch.roofline.sharded_ring_bytes``, and ``ring_bytes_moved_ok``: the
  bytes the transport copied between shards (``gossip.RING``) equal it;
* ``mix_us``: microseconds per mix between two CUDA events around 20
  back-to-back mixes after a warm-up, the plan built once as the round's
  transport builds it (the mix's launches and the host time between them
  included: the sharded transport is a Python loop over shards and ring
  blocks; on whole [W, W] P it also pads P to [wp, wp]);
* ``launches``: kernel launches per mix by kernel (one local-block kernel
  per shard).

Then the engine's chunk parity at W = 500: a 2-epoch ``run_defta`` with
``eval_every=2`` is one driver chunk at every shard count.

Every row prints as one JSON line; ``--out`` also writes them as one JSON
file (no ``BENCH_*.json`` is written). Every number is the card's, beside
``nvidia-smi --query-gpu=name,power.limit``. ``--device cpu`` rehearses
the sweep on CPU shards (W up to 2000) and measures no time.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

F = 256
CALLS = 20


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def mix_us(fn) -> float:
    """Microseconds per call between CUDA events around ``CALLS`` calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(CALLS):
        fn()
    b.record()
    b.synchronize()
    return 1e3 * a.elapsed_time(b) / CALLS


def sweep(dev, widths):
    from repro_torch.core import gossip
    from repro_torch.core.topology import make_topology
    from repro_torch.kernels import ops
    from repro_torch.launch.roofline import sharded_ring_bytes
    from repro_torch.sharding import WorkerShards

    rows = []
    for w in widths:
        adj = make_topology("random_kout", w, 4, seed=0)
        P = (adj | np.eye(w, dtype=bool)).astype(np.float32)
        P = torch.tensor(P / P.sum(1, keepdims=True), device=dev)
        gen = torch.Generator(device=dev)
        gen.manual_seed(w)
        stack = {"p": torch.randn(w, F, generator=gen, device=dev)}
        base = None
        for shards in (1, 4, 8):
            sh = WorkerShards((dev,) * shards)
            plan = gossip.worker_shard_plan(adj, shards)
            roof = sharded_ring_bytes(F, adj, shards, None, rows=1)

            def mix():
                return gossip.mix_pytree_sharded(P, stack, sh,
                                                 adjacency=adj,
                                                 plan=plan)["p"]
            ops.reset_launches()
            gossip.reset_ring()
            out = mix()
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            moved = gossip.RING["bytes"]
            if base is None:
                base = out
            err = float((out - base).abs().max())
            row = dict(
                W=w, shards=shards, block=plan.block,
                mix_us=mix_us(mix) if dev.type == "cuda" else None,
                launches=launches, ring_bytes=float(plan.ring_bytes(F)),
                ring_bytes_ok=bool(plan.ring_bytes(F) == roof["ring_bytes"]),
                ring_bytes_moved_ok=bool(moved == roof["ring_bytes"]),
                bytes_per_boundary=roof["bytes_per_boundary"],
                used_pairs=roof["used_pairs"],
                intra_edges=roof["intra_edges"],
                cross_edges=roof["cross_edges"], err_vs_single_shard=err)
            print(json.dumps(row), flush=True)
            rows.append(row)
            if not (err < 5e-5 and row["ring_bytes_ok"]
                    and row["ring_bytes_moved_ok"]
                    and (dev.type != "cuda"
                         or launches == {"gossip_mix_sparse": shards})):
                raise SystemExit(f"row W={w} shards={shards} failed: {row}")
    return rows


def chunk_parity(dev):
    """A 2-epoch W = 500 run with eval_every=2 is one chunk at every shard
    count (the reference's dispatch-parity check)."""
    from repro_torch.config import DeFTAConfig, TrainConfig
    from repro_torch.core.defta import run_defta
    from repro_torch.core.tasks import mlp_task
    from repro_torch.data.synthetic import federated_dataset
    from repro_torch.telemetry import RunLedger

    w = 500
    cfg = DeFTAConfig(num_workers=w, avg_peers=4, num_sampled=2,
                      local_epochs=1)
    train = TrainConfig(learning_rate=0.05, batch_size=16)
    data = federated_dataset("vector", w, np.random.default_rng(0),
                             n_per_worker=16, alpha=0.5)
    out = []
    for shards in (1, 4, 8):
        led = RunLedger()
        st, *_ = run_defta(0, mlp_task(32, 10), cfg, train, data, epochs=2,
                           eval_every=2, test_x=data["test_x"],
                           test_y=data["test_y"], ledger=led, probes=False,
                           device=dev, shards=shards,
                           shard_devices=[dev] * shards if shards > 1
                           else None)
        row = dict(engine_W=w, shards=shards,
                   chunks=led.as_stats()["dispatches"],
                   epochs=sorted(set(st.epoch.tolist())))
        print(json.dumps(row), flush=True)
        if row["chunks"] != 1 or row["epochs"] != [2]:
            raise SystemExit(f"engine parity failed: {row}")
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    from repro_torch.device import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
        card = card_line()
        print(f"card: {card}; {torch.cuda.get_device_name(0)}", flush=True)
    else:
        card = "cpu (no time measured)"
    widths = (500, 2000, 10000) if dev.type == "cuda" else (500, 2000)
    rows = sweep(dev, widths)
    engine = chunk_parity(dev)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            {"card": card, "rows": rows, "engine": engine}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
