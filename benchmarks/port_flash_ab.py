"""Kernels of checkouts side by side, on one CUDA card.

    python benchmarks/port_flash_ab.py ROOT [ROOT ...] [--rounds 2]
        [--main-paths | --mode {flash,main_paths,router,route_slots,ssd16,
                                train_4k}]

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

``--mode router`` times each checkout's ``ops.moe_router_topk`` at E = 64,
k = 6 (DeepSeekMoE) on f32 logits at T in {4, 2048, 4096, 32768} and on
bf16 logits at T in {2048, 32768}; ``--mode route_slots`` its
``ops.moe_route_slots`` at T in {2048, 32768}, E = 64, k = 6, f32,
``moe_grouped``'s capacity; ``--mode ssd16`` its ``ops.ssd_chunk`` at the
P = 16 shapes of this tree's ``chip_smoke.SSD_TIMED`` (inputs from its
``ssd_inputs``), whichever kernel that checkout's wrapper launches there.
Each builds only the kernels it times. ``--mode train_4k`` runs chip_smoke
[10]'s qwen3-0.6b ``train_4k`` pair (B = 2, the (2, 4) pod on the card)
through each checkout's ``launch.dryrun.measure``: the step's µs (median
of 2), the meta and measured peaks (MB) and the counted bytes (GB).
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


ROUTER_T = [(t, "float32") for t in (4, 2048, 4096, 32768)] + \
    [(t, "bfloat16") for t in (2048, 32768)]
ROUTE_SLOTS_T = (2048, 32768)
MODES = ("flash", "main_paths", "router", "route_slots", "ssd16",
         "train_4k")


def time_moe(smoke, ops, gen, mode: str) -> dict:
    """{label: µs} of the checkout's router or route-and-slot wrapper."""
    import torch
    from repro_torch.models.moe import grouped_capacity
    out = {}
    for t, dt in (ROUTER_T if mode == "router" else
                  [(t, "float32") for t in ROUTE_SLOTS_T]):
        x = torch.randn(t, 64, generator=gen, device="cuda").to(
            getattr(torch, dt))
        if mode == "router":
            fn = lambda: ops.moe_router_topk(x, 6)
        else:
            cap = grouped_capacity(t, 64, 6)
            fn = lambda: ops.moe_route_slots(x, 6, cap)
        out[f"T={t} {dt}"] = smoke.device_ms(fn) * 1e3
    return out


def time_ssd16(smoke, ops, gen) -> dict:
    """{label: µs} of the checkout's ``ops.ssd_chunk`` at P = 16."""
    from repro_torch.kernels import build
    here = load_smoke(Path(__file__).resolve().parents[1], "this_smoke")
    out = {}
    for tag, b, s, h, n, p, chunk in here.SSD_TIMED:
        if p != 16:
            continue
        build.build((ops.ssd_kernel(n, p),))
        args = here.ssd_inputs(gen, b, s, h, n, p, chunk, "cuda")
        out[f"{tag} [{args[4].shape[0]},{h},{args[4].shape[2]},{n},{p}] "
            f"{ops.ssd_kernel(n, p)}"] = smoke.device_ms(
                lambda: ops.ssd_chunk(*args), 20) * 1e3
    return out


def time_train_4k() -> dict:
    """[10]'s qwen3-0.6b train_4k pair of the checkout on sys.path."""
    from repro_torch.kernels import build
    from repro_torch.launch import dryrun
    build.build(("flash_attention_tc",))
    r = dryrun.measure("qwen3-0.6b", "train_4k", batch=2, repeats=2,
                       verbose=False)
    return {"step": r["step_ms"] * 1e3,
            "peak meta MB": r["meta"]["peak_bytes"] / 1e6,
            "peak measured MB": r["measured_peak_bytes"] / 1e6,
            "bytes GB": r["meta"]["bytes"] / 1e9}


def time_one(root: Path, mode: str = "flash") -> dict:
    """{"B,S": µs} of the SIMT kernel of the checkout at ``root`` (with
    mode ``main_paths``, {label: µs} at ``SIMT_TIMED``; with ``router``,
    ``route_slots`` or ``ssd16``, {label: µs} of that wrapper)."""
    sys.path[:0] = [str(root / "src"), str(root)]
    smoke = load_smoke(root, "chip_smoke")
    import torch
    from repro_torch.kernels import build, ops
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    if mode in ("router", "route_slots"):
        build.build(("moe_router" if mode == "router" else
                     "moe_route_slots",))
        return time_moe(smoke, ops, gen, mode)
    if mode == "ssd16":
        return time_ssd16(smoke, ops, gen)
    if mode == "train_4k":
        return time_train_4k()
    build.build(("flash_attention",))
    out = {}
    if mode == "main_paths":
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
    ap.add_argument("--main-paths", action="store_true",
                    help="the same as --mode main_paths")
    ap.add_argument("--mode", choices=MODES, default="flash")
    ap.add_argument("--one", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    mode = "main_paths" if args.main_paths else args.mode
    if args.one:
        print(json.dumps(time_one(args.one.resolve(), mode)))
        return 0
    roots = [r.resolve() for r in args.roots]
    runs = {str(r): [] for r in roots}
    order = []
    for i in range(args.rounds):
        order += roots if i % 2 == 0 else roots[::-1]
    for root in order:
        res = subprocess.run([sys.executable, __file__, "--one", str(root),
                              "--mode", mode],
                             capture_output=True, text=True, timeout=900)
        if res.returncode != 0:
            print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
            return 1
        row = json.loads(res.stdout.strip().splitlines()[-1])
        runs[str(root)].append(row)
        print(f"{root.name}: " + ", ".join(
            f"[{k}] {v:.2f}" + ("" if " " in k else "us")
            for k, v in row.items()), flush=True)
    key = "simt_flash_us" if mode in ("flash", "main_paths") else \
        mode if mode == "train_4k" else f"{mode}_us"
    print(json.dumps({f"{key}_median": {
        r.name: {k: statistics.median(x[k] for x in runs[str(r)])
                 for k in runs[str(r)][0]} for r in roots}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
