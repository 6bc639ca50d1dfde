"""The benchmark aggregator on the PyTorch port: the port's version of
``benchmarks/run.py``, one function per paper table plus the kernel rows,
over the port's scripts. Prints ``name,us_per_call,derived`` CSV rows as
the reference does, after the scripts' own tables.

    PYTHONPATH=src python benchmarks/port_run.py [--fast|--full] [--device cpu]

--fast  : tiny epoch counts (a smoke)
default : moderate
--full  : paper-scale epochs

Rows: ``port_bias_analysis.run`` (derived: DeFL's aggregation bias over
DeFTA's at the largest world), ``port_kernel_bench.run`` (one row per
kernel; derived: the plain version's us), ``port_table2.run`` (the mean
CFL-S - DeFTA accuracy gap), ``port_table3.run`` (DeFTA's worst accuracy
over the attacker counts), ``port_table4.run`` (async - sync accuracy),
``port_table_trust.sweep`` (the best geometric signal's accuracy over
loss-only under label_flip x non-iid), and, where ``--dryrun`` (default
``experiments/dryrun``) holds dry-run records, ``port_dryrun_table``'s
table of them (single- and multi-pod records told apart by their
``mesh``). A row's us_per_call is the wall time of its script on the
host. Runs on the card by default (``--device cpu`` runs the kernels'
plain versions); writes every result to ``--out`` as JSON. Imports
nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "benchmarks"))


def dryrun_records(out_dir: str):
    """(single, multi) dicts of the dry-run records in ``out_dir``, keyed
    as ``port_dryrun_table.load`` keys them."""
    single, multi = {}, {}
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        if "arch" in r and "shape" in r:
            (multi if r.get("mesh") == "multi" else single)[
                (r["arch"], r["shape"])] = r
    return single, multi


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="experiments/port_benchmarks.json")
    ap.add_argument("--dryrun", default="experiments/dryrun")
    args = ap.parse_args(argv)
    epochs = 8 if args.fast else (100 if args.full else 40)
    worlds = (8,) if args.fast else (8, 14, 20)
    ks = (1, 3) if args.fast else (1, 3, 5, 10, 20, 40)

    import port_bias_analysis
    import port_dryrun_table
    import port_kernel_bench
    import port_table2
    import port_table3
    import port_table4
    import port_table_trust
    from repro_torch.device import resolve_device

    dev = args.device
    resolve_device(dev)                    # no card: raise before any run
    print(f"card: {port_table2.card_line(dev)}; torch {torch.__version__}",
          flush=True)
    results, csv_rows = {}, []

    t0 = time.time()
    results["bias"] = port_bias_analysis.run(worlds=(8, 14, 20, 40, 60),
                                             device=dev)
    csv_rows.append(("bias_analysis", (time.time() - t0) * 1e6,
                     results["bias"][-1]["reduction"]))

    results["kernels"] = port_kernel_bench.run(dev)
    for r in results["kernels"]:
        csv_rows.append((r["name"], r["us_per_call"], r["ref_us"]))

    t0 = time.time()
    results["table2"] = port_table2.run(epochs=epochs, worlds=worlds,
                                        tasks=("mlp_vector",), device=dev)
    if not args.fast:      # one CNN world-size cell (task difficulty)
        results["table2_cnn"] = port_table2.run(
            epochs=epochs, worlds=(20,), tasks=("cnn_image",), device=dev)
    gap = sum(r["cfl_s"] - r["defta"] for r in results["table2"]) / \
        len(results["table2"])
    csv_rows.append(("table2_performance", (time.time() - t0) * 1e6, gap))

    t0 = time.time()
    results["table3"] = port_table3.run(epochs=epochs, ks=ks,
                                        task_name="mlp_vector", device=dev)
    worst = min(r["acc"] for r in results["table3"]
                if r["method"] == "defta")
    csv_rows.append(("table3_robustness", (time.time() - t0) * 1e6, worst))

    t0 = time.time()
    results["table4"] = port_table4.run(epochs=epochs, device=dev)
    csv_rows.append(("table4_async", (time.time() - t0) * 1e6,
                     results["table4"][2]["acc"]
                     - results["table4"][0]["acc"]))

    t0 = time.time()
    # --fast runs only the headline cells (label_flip x non-iid); the
    # default adds the adaptive attackers and the iid column
    results["table_trust"] = port_table_trust.sweep(
        epochs=epochs,
        attacks=("label_flip",) if args.fast
        else ("label_flip", "alie", "dts_dodge", "theta_aware"),
        partitions=("non_iid",) if args.fast
        else tuple(port_table_trust.PARTITIONS), device=dev, verbose=False)
    ok, accs = port_table_trust.headline_check(results["table_trust"],
                                               verbose=False)
    best_geom = max((a for s, a in accs.items() if s != "loss"),
                    default=0.0)
    csv_rows.append(("table_trust", (time.time() - t0) * 1e6,
                     best_geom - accs.get("loss", 0.0)))

    single, multi = dryrun_records(args.dryrun)
    if single or multi:
        table = port_dryrun_table.markdown(single, multi)
        print(table)
        results["dryrun"] = table

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1, default=str)

    print("\nname,us_per_call,derived")
    for name, us, derived in csv_rows:
        print(f"{name},{us:.0f},{derived}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
