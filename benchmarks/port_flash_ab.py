"""The SIMT flash kernel of checkouts side by side, on one CUDA card.

    python benchmarks/port_flash_ab.py ROOT [ROOT ...] [--rounds 2]
        [--main-paths]

Runs the checkouts in the order given, then in reverse, and so on for
``--rounds`` passes (two roots, two rounds: A, B, B, A), each in a
process of its own that builds that checkout's kernels and times, through
that checkout's ``chip_smoke.simt_flash`` (the SIMT kernel's C entry,
causal, window 0) and ``chip_smoke.device_ms`` (CUDA graph of back-to-back
calls, median of 7 replays), the SIMT kernel at the serving path's prefill
shapes in their layout (``chip_smoke.main_path_qkv``, bf16, D = 128):
[4, 16, 512, 128] and [1, 16, 4096, 128]. Prints one line per run and a
JSON summary of the median microseconds per checkout (by directory name)
and shape.

``--main-paths`` times instead the calls that reach the SIMT kernel on
the main paths, ``SIMT_TIMED`` of this tree's ``chip_smoke.py`` (the f32
calls, Kimi-K2's bf16 call at D = 112, inputs from its
``simt_inputs``), through each checkout's own ``ops.flash_attention``
(its wrapper, whatever grid it plans), and the bf16 [64, 512, 128] row
through that checkout's ``simt_flash`` (the wrapper sends it to the
tensor-core kernel).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

SHAPES = ((4, 512), (1, 4096))        # (B, S) at 16 heads, D = 128
CALLS = {512: 5, 4096: 2}


def load_smoke(root: Path, name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  root / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def time_one(root: Path, main_paths: bool = False) -> dict:
    """{"B,S": µs} of the SIMT kernel of the checkout at ``root`` (with
    ``main_paths``, {label: µs} at ``SIMT_TIMED``)."""
    sys.path[:0] = [str(root / "src"), str(root)]
    smoke = load_smoke(root, "chip_smoke")
    import torch
    from repro_torch.kernels import build
    build.build(("flash_attention",))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {}
    if main_paths:
        from repro_torch.kernels import ops
        here = load_smoke(Path(__file__).resolve().parents[1], "this_smoke")
        for label, dtype, b, h, sq, sk, d, causal in here.SIMT_TIMED:
            q, k, v = here.simt_inputs(gen, label, dtype, b, h, sq, sk, d,
                                       "cuda")
            if label.startswith("C entry"):
                fn = lambda: smoke.simt_flash(q, k, v, causal)
            else:
                fn = lambda: ops.flash_attention(q, k, v, causal=causal)
            calls = 20 if b * h * sq * sk <= 2 ** 26 else 2
            out[label] = smoke.device_ms(fn, calls) * 1e3
        return out
    for b, s in SHAPES:
        q, k, v = smoke.main_path_qkv(gen, b, s, "cuda")
        out[f"{b},{s}"] = smoke.device_ms(
            lambda: smoke.simt_flash(q, k, v), CALLS[s]) * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("roots", nargs="*", type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--main-paths", action="store_true")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        print(json.dumps(time_one(args.one.resolve(), args.main_paths)))
        return 0
    roots = [r.resolve() for r in args.roots]
    runs = {str(r): [] for r in roots}
    order = []
    for i in range(args.rounds):
        order += roots if i % 2 == 0 else roots[::-1]
    for root in order:
        res = subprocess.run([sys.executable, __file__, "--one", str(root)]
                             + ["--main-paths"] * args.main_paths,
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        runs[str(root)].append(row)
        print(f"{root.name}: " + ", ".join(
            f"[{k}] {v:.2f}us" for k, v in row.items()), flush=True)
    print(json.dumps({"simt_flash_us_median": {
        r.name: {k: statistics.median(x[k] for x in runs[str(r)])
                 for k in runs[str(r)][0]} for r in roots}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
