"""The dry run's sweep as one markdown table: a row per (arch, shape),
each cell "single-pod / multi-pod", from the JSON files of

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out SINGLE
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --out MULTI

Usage: python benchmarks/port_dryrun_table.py SINGLE MULTI [--brief]
    [--by-arch] [--before SINGLE0 MULTI0]

``--brief`` keeps the peak, GB moved and fits columns; ``--by-arch`` puts
one arch on a row and its shapes side by side; ``--before`` reads an
earlier sweep (a parent's, any subset of pairs) and shows each of its
pairs' cells that changed as "before → after".

Columns (a device's share, ``repro_torch.counting``): peak live
GB (1e9 B, from the roofline's ``bytes_per_device``; the JSON's
``peak_per_device_gb`` is GiB, the reference's unit), counted TFLOP, GB moved, collective GB, the three roofline times in
ms on an NVIDIA H100 80GB HBM3 at 700 W (``launch.roofline``), the
bottleneck, the useful ratio (model flops / counted flops) and whether
the peak fits the card's 80 GB (if not: "params > pod", the whole bf16
parameters above a pod's 640 GB; "state", a device's placed parameters,
optimizer state and inputs alone above 80 GB; else "activations").
"""
from __future__ import annotations

import glob
import json
import os
import sys


def load(out_dir: str) -> dict:
    rows = {}
    for p in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(p) as f:
            r = json.load(f)
        rows[(r["arch"], r["shape"])] = r
    return rows


def cell(r, fmt) -> str:
    if r is None:
        return "—"
    if r.get("status") != "ok":
        return r.get("status", "?")
    return fmt(r, r["roofline"])


COLUMNS = (
    ("peak GB", lambda r, f: f"{f['bytes_per_device'] / 1e9:.1f}"),
    ("TFLOP", lambda r, f: f"{f['hlo_gflops_total'] / r['chips'] / 1e3:.4g}"),
    ("GB moved", lambda r, f: f"{f['hlo_gbytes_total'] / r['chips']:.4g}"),
    ("coll GB", lambda r, f: f"{f['collective_gbytes_per_chip']:.3g}"),
    ("t_comp ms", lambda r, f: f"{f['t_compute'] * 1e3:.4g}"),
    ("t_mem ms", lambda r, f: f"{f['t_memory'] * 1e3:.4g}"),
    ("t_coll ms", lambda r, f: f"{f['t_collective'] * 1e3:.3g}"),
    ("bottleneck", lambda r, f: f["bottleneck"]),
    ("useful", lambda r, f: f"{f['useful_ratio']:.3f}"),
    ("fits 80 GB", lambda r, f: _fits(r, f)),
)

POD_BYTES = 8 * 80e9             # a pod's eight cards


def _fits(r, f) -> str:
    """Whether a device's peak fits the card, and if not why: the whole
    parameters (bf16) above a pod's 640 GB, a device's placed state and
    inputs alone above 80 GB, or the step's activations."""
    if f["bytes_per_device"] <= 80e9:
        return "yes"
    if r["params_b"] * 1e9 * 2 > POD_BYTES:
        return "no: params > pod"
    if r["memory"]["arg_gb"] * 2 ** 30 > 80e9:
        return "no: state"
    return "no: activations"


BRIEF = ("peak GB", "GB moved", "fits 80 GB")


def _pair(a, b, fmt) -> str:
    x, y = cell(a, fmt), cell(b, fmt)
    return x if x == y else f"{x} / {y}"


def _cell(single, multi, key, fmt, before) -> str:
    now = _pair(single.get(key), multi.get(key), fmt)
    if before is not None and (key in before[0] or key in before[1]):
        was = _pair(before[0].get(key), before[1].get(key), fmt)
        now = now if was == now else f"{was} → {now}"
    return now


def markdown(single: dict, multi: dict, columns=COLUMNS,
             before=None, by_arch: bool = False) -> str:
    keys = sorted(set(single) | set(multi))
    if by_arch:
        archs = sorted({a for a, _ in keys})
        shapes = sorted({s for _, s in keys})
        head = [f"{s} {c}" for s in shapes for c, _ in columns]
        lines = ["| arch | " + " | ".join(head) + " |",
                 "|" + " --- |" * (len(head) + 1)]
        for a in archs:
            cells = [_cell(single, multi, (a, s), fmt, before)
                     for s in shapes for _, fmt in columns]
            lines.append(f"| {a} | " + " | ".join(cells) + " |")
        return "\n".join(lines)
    lines = ["| arch | shape | " + " | ".join(c for c, _ in columns) + " |",
             "|" + " --- |" * (len(columns) + 2)]
    for key in keys:
        cells = [_cell(single, multi, key, fmt, before) for _, fmt in columns]
        lines.append(f"| {key[0]} | {key[1]} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    columns, before = COLUMNS, None
    if "--brief" in args:
        args.remove("--brief")
        columns = tuple(c for c in COLUMNS if c[0] in BRIEF)
    by_arch = "--by-arch" in args
    if by_arch:
        args.remove("--by-arch")
    if "--before" in args:
        i = args.index("--before")
        before = (load(args[i + 1]), load(args[i + 2]))
        del args[i:i + 3]
    single, multi = load(args[0]), load(args[1])
    bad = [k for rows in (single, multi) for k, r in rows.items()
           if r.get("status") not in ("ok", "skipped")]
    print(f"single {len(single)} pairs, multi {len(multi)}; not ok or "
          f"skipped: {bad}")
    print(markdown(single, multi, columns, before, by_arch))
    return 1 if bad else 0


if __name__ == "__main__":
    raise SystemExit(main())
