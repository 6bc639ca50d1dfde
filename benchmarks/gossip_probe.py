#!/usr/bin/env python3
"""Time the port's dense and int8 gossip mixes on one CUDA card.

    python3 benchmarks/gossip_probe.py [--src DIR] [--out PATH]

``--src`` is the ``src`` directory whose ``repro_torch`` is timed (default
this checkout's), so the same script times another tree's kernels, for
example a parent commit unpacked with ``git archive``; inputs, timing and
bounds come from this checkout's ``chip_smoke.py`` (device time per call:
a CUDA graph of 50 back-to-back calls, median of 7 replays).

1. At the main path's shape (W = 22, K = 5, F = 2048) and at W = 500,
   K = 25, F = 4096: the dense mix on an f32, a bf16 and an int8 payload
   (P with the int8 row scales folded into its columns, as the pallas
   backend feeds it), ``torch.matmul`` on the f32 payload, and the int8
   mix.
2. Where the tree has the two dense regimes (``ops.GOSSIP_STREAM_MAX_W``):
   both regimes, forced through that constant, at W in {22, 32, 48, 64,
   96, 128, 200} and F in {2048, 4096}, f32 and int8 payloads, each checked
   against the plain version (limit 1e-5 (1 + max|plain|)).

Prints one line per timing and, with ``--out``, writes them as JSON.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gossip_probe: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; kernels from {Path(ops.__file__).parent}",
          flush=True)
    build.build(("gossip_mix", "gossip_mix_quant"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = []

    def record(**row):
        rows.append(row)
        print("  " + " ".join(f"{k}={v:.3f}" if isinstance(v, float)
                              else f"{k}={v}" for k, v in row.items()),
              flush=True)

    for tag, w, kp, f in (("main", 22, 4, 2048), ("w500", 500, 24, 4096)):
        P, idx, val, _ = cs.world_csr(w, kp, seed=7, dev=dev)
        x32, _ = cs.payload(gen, w, f, "float32")
        x16, _ = cs.payload(gen, w, f, "bfloat16")
        q, scale = cs.payload(gen, w, f, "int8")
        Pw = (P * scale[None, :]).contiguous()
        for name, fn in (
                ("gossip_mix f32", lambda: ops.gossip_mix(P, x32)),
                ("gossip_mix bf16", lambda: ops.gossip_mix(P, x16)),
                ("gossip_mix int8", lambda: ops.gossip_mix(Pw, q)),
                ("torch.matmul f32", lambda: torch.matmul(P, x32)),
                ("gossip_mix_quant", lambda: ops.gossip_mix_quant(
                    idx, val, scale, q))):
            record(tag=tag, W=w, K=idx.shape[1], F=f, call=name,
                   us=cs.device_ms(fn) * 1e3)

    if hasattr(ops, "GOSSIP_STREAM_MAX_W"):
        keep = ops.GOSSIP_STREAM_MAX_W
        try:
            for w in (22, 32, 48, 64, 96, 128, 200):
                P, *_ = cs.world_csr(w, max(4, w // 3), seed=w, dev=dev)
                for f in (2048, 4096):
                    for dtype in ("float32", "int8"):
                        x, scale = cs.payload(gen, w, f, dtype)
                        Pm = P if scale is None else \
                            (P * scale[None, :]).contiguous()
                        want = ref.gossip_mix_ref(Pm, x)
                        for regime, limit in (("stream", 1 << 30),
                                              ("tile", 0)):
                            ops.GOSSIP_STREAM_MAX_W = limit
                            if ops.gossip_mix_plan(w, f, x.dtype)[0] != \
                                    regime:
                                continue
                            got = ops.gossip_mix(Pm, x)
                            torch.cuda.synchronize()
                            err = float((got - want).abs().max())
                            tol = 1e-5 * (1 + float(want.abs().max()))
                            us = cs.device_ms(
                                lambda: ops.gossip_mix(Pm, x)) * 1e3
                            record(tag="regime", W=w, F=f, dtype=dtype,
                                   regime=regime, us=us, err=err, tol=tol,
                                   ok=err <= tol)
        finally:
            ops.GOSSIP_STREAM_MAX_W = keep
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "rows": rows},
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
