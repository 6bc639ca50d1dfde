"""Where a counted step's bytes go: the dry run's count of one pair at a
cut (``repro_torch.launch.dryrun``), its bytes by aten op and by kernel,
largest first. Runs on torch's meta device: no card needed.

Usage: PYTHONPATH=src python benchmarks/port_dryrun_bytes.py \\
    qwen3-0.6b:train_4k:2 deepseek-moe-16b:prefill_32k:8:4096 ...

Each argument is ARCH:SHAPE:BATCH[:SEQ] (SEQ 0 or absent keeps the
shape's length): the pairs of ``chip_smoke.py`` [10].
"""
from __future__ import annotations

import dataclasses
import sys

from repro_torch.config import SHAPES
from repro_torch.launch import dryrun


def breakdown(arch: str, shape: str, batch: int, seq: int = 0, top=10):
    p = dryrun.plan(arch, SHAPES[shape])
    p = dataclasses.replace(p, shape=dataclasses.replace(
        p.shape, global_batch=batch, seq_len=seq or p.shape.seq_len))
    c = dryrun.count_step(p, dryrun.build_state(p))
    rows = sorted(c.op_bytes.items(), key=lambda kv: -kv[1])[:top]
    return c, rows


def main(argv=None) -> int:
    for pair in (sys.argv[1:] if argv is None else argv):
        arch, shape, *rest = pair.split(":")
        batch, seq = int(rest[0]), int(rest[1]) if len(rest) > 1 else 0
        c, rows = breakdown(arch, shape, batch, seq)
        print(f"{arch} {shape} B={batch} S={seq or SHAPES[shape].seq_len}: "
              f"{c.bytes:.4e} bytes, {c.flops:.4e} flops, calls "
              f"{dict(c.calls)}")
        for name, n in rows:
            print(f"  {name:36s} {n / 1e9:10.1f} GB  {n / c.bytes:6.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
