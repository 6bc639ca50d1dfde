"""Where a counted step's bytes go: the dry run's count of one pair at a
cut (``repro_torch.launch.dryrun``), its bytes by aten op and by kernel,
largest first. Runs on torch's meta device: no card needed.

Usage: PYTHONPATH=src python benchmarks/port_dryrun_bytes.py \\
    qwen3-0.6b:train_4k:2 deepseek-moe-16b:prefill_32k:8:4096 ...

Each argument is ARCH:SHAPE:BATCH[:SEQ] (SEQ 0 or absent keeps the
shape's length): the pairs of ``chip_smoke.py`` [10]. A train pair also
prints the bytes of the flash kernel's backward recomputes (the plain
version's gradient, ``ops._FlashAttention.backward``), their share, and
the counted (non-view) aten ops of one recompute.
"""
from __future__ import annotations

import dataclasses
import sys

from repro_torch.config import SHAPES
from repro_torch.launch import dryrun


def breakdown(arch: str, shape: str, batch: int, seq: int = 0, top=10):
    """The pair's counter, its ``top`` ops by bytes and the bytes counted
    inside the flash backward's recomputes."""
    from repro_torch import counting
    from repro_torch.kernels import ops
    p = dryrun.plan(arch, SHAPES[shape])
    p = dataclasses.replace(p, shape=dataclasses.replace(
        p.shape, global_batch=batch, seq_len=seq or p.shape.seq_len))
    real, attn = ops._FlashAttention.backward, [0.0, 0, 0]

    def backward(ctx, grad_out):
        c = counting.active()
        before, ops_before = c.bytes, sum(c.ops.values())
        out = real(ctx, grad_out)
        attn[0] += c.bytes - before
        attn[1] += sum(c.ops.values()) - ops_before
        attn[2] += 1
        return out
    ops._FlashAttention.backward = staticmethod(backward)
    try:
        c = dryrun.count_step(p, dryrun.build_state(p))
    finally:
        ops._FlashAttention.backward = staticmethod(real)
    rows = sorted(c.op_bytes.items(), key=lambda kv: -kv[1])[:top]
    return c, rows, attn


def main(argv=None) -> int:
    for pair in (sys.argv[1:] if argv is None else argv):
        arch, shape, *rest = pair.split(":")
        batch, seq = int(rest[0]), int(rest[1]) if len(rest) > 1 else 0
        c, rows, attn = breakdown(arch, shape, batch, seq)
        print(f"{arch} {shape} B={batch} S={seq or SHAPES[shape].seq_len}: "
              f"{c.bytes:.4e} bytes, {c.flops:.4e} flops, calls "
              f"{dict(c.calls)}")
        if attn[2]:
            print(f"  {'flash backward recomputes':36s} {attn[0] / 1e9:10.1f} "
                  f"GB  {attn[0] / c.bytes:6.3f}  ({attn[2]} calls, "
                  f"{attn[1] // attn[2]} aten ops a call)")
        for name, n in rows:
            print(f"  {name:36s} {n / 1e9:10.1f} GB  {n / c.bytes:6.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
