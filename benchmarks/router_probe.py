"""What holds the decode router (``csrc/moe_router.cu``, the row code of
``csrc/router_row.cuh``) back, on one CUDA card.

    PYTHONPATH=src python benchmarks/router_probe.py [--variants NAME ...]

Variants of the kernel, built from its sources with the experts a lane
changed or one piece taken out, timed through its C entry at E = 64, k = 6
(DeepSeekMoE) and T in {4, 2048, 4096, 32768}, f32 logits, and at T in
{2048, 32768} on bf16 logits: ``base`` (the kernel as it is: G = 16
lanes a row, each lane's 4 experts sorted once), ``lanes4``, ``lanes8``
and ``lanes32`` (16, 8 and 2 experts a lane: G = 4, 8 and 32 at E = 64),
``one_round`` (one top-k
round in place of k), ``no_sort`` (the lanes' sort taken out),
``no_exp`` (the softmax's exponent taken out) and ``no_rounds`` (the k
rounds taken out: the launch, the loads, the softmax's max and sum and
the stores remain). Beside them the
floor of ``chip_smoke.device_ms``: a one-element in-place ``add_``. Each
row is the median of ``chip_smoke.device_ms`` (a CUDA graph of 50
back-to-back calls, median of 7 replays); ``base`` is timed first and
last. Only the times of the variants but the ``lanes`` ones mean
anything: their outputs are wrong by construction. Each variant's line
of ptxas registers is followed by the SASS instructions of its f32
kernel at E = 64 (``cuobjdump -sass``): the code a row's path runs, once
and cold, in a launch at small T.

Builds into ``build/router_probe/``, one nvcc per variant, all at once.
Imports nothing of JAX or of the ``repro`` package.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import build  # noqa: E402

OUT = ROOT / "build" / "router_probe"
HEADER = "router_row.cuh"
EPL_LINE = "constexpr int EPL_T = 4;"


def lanes(epl: int):
    """The substitution for ``epl`` experts a lane below 32 lanes a row."""
    return [(EPL_LINE, EPL_LINE.replace("4", str(epl)))]


# variant -> [(text in router_row.cuh, its replacement)]
VARIANTS = {
    "base": [],
    "lanes4": lanes(16),
    "lanes8": lanes(8),
    "lanes32": lanes(2),
    "one_round": [("for (int r = 0; r < k; ++r) {",
                   "for (int r = 0; r < 1; ++r) {")],
    "no_sort": [("sort_lane<EPL>(p, ix);", "")],
    "no_exp": [("p[i] = first + i < E ? expf(p[i] - mx) : 0.f;",
                "p[i] = first + i < E ? p[i] - mx : 0.f;")],
    "no_rounds": [("for (int r = 0; r < k; ++r) {",
                   "for (int r = 0; r < 0; ++r) {")],
}
SHAPES = [(t, "float32") for t in (4, 2048, 4096, 32768)] + \
    [(t, "bfloat16") for t in (2048, 32768)]
E, K = 64, 6


def build_variants(names) -> None:
    jobs = {}
    for name in names:
        subs = VARIANTS[name]
        src = OUT / name
        src.mkdir(parents=True, exist_ok=True)
        for f in ("moe_router.cu", "common.cuh", HEADER):
            shutil.copy(build.CSRC / f, src / f)
        text = (src / HEADER).read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in {HEADER}")
            text = text.replace(old, new)
        (src / HEADER).write_text(text)
        jobs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
             str(src / "librouter.so"), str(src / "moe_router.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in jobs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        regs = sorted({line.split("Used ")[1].split(",")[0]
                       for line in log.splitlines() if "Used " in line})
        print(f"  {name}: ptxas {'; '.join(regs)}; SASS instructions of "
              f"the f32 E=64 kernel: {sass_count(OUT / name)}", flush=True)


def sass_count(out_dir: Path) -> int:
    """SASS instructions of the f32 kernel that E = 64 dispatches to in
    the library under ``out_dir`` (the kernel's name carries G and EPL)."""
    epl = int(re.search(r"constexpr int EPL_T = (\d+);",
                        (out_dir / HEADER).read_text()).group(1))
    g = min(32, 64 // epl)
    sym = f"router_kernelIfLi{g}ELi{epl}E"
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(out_dir / "librouter.so")],
                          capture_output=True, text=True).stdout
    count, inside = 0, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = sym in line
        elif inside and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            count += 1
    return count


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    args = ap.parse_args()
    names = list(dict.fromkeys(["base"] + args.variants))
    build_variants(names)
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops
    fns = {}
    for name in names:
        fn = ctypes.CDLL(str(OUT / name / "librouter.so")).moe_router_launch
        fn.argtypes = list(build.SIGNATURES["moe_router"][1])
        fn.restype = ctypes.c_int
        fns[name] = fn
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    one = torch.zeros(1, device="cuda")
    floor_us = cs.device_ms(lambda: one.add_(1.0)) * 1e3
    print(f"  floor (one-element add_): {floor_us:.2f} us", flush=True)
    rows = {"floor_us": floor_us}
    for t, dt in SHAPES:
        dtype = getattr(torch, dt)
        x = torch.randn(t, E, generator=gen, device="cuda").to(dtype)
        gates = torch.empty(t, K, device="cuda")
        idx = torch.empty(t, K, dtype=torch.int32, device="cuda")
        b_ms, b_by = cs.router_bound(t, E, K, x.element_size())
        for name in names + ["base"]:
            def call(fn=fns[name]):
                rc = fn(x.data_ptr(), gates.data_ptr(), idx.data_ptr(), t, E,
                        K, ops._DTYPE_CODE[dtype],
                        torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            us = cs.device_ms(call) * 1e3
            rows.setdefault(f"{t},{dt}", {}).setdefault(name, []).append(us)
            print(f"  {name:10s} T={t:5d} E={E} k={K} {dt:8s}: {us:.2f} us "
                  f"(bound {b_ms * 1e3:.3f} us, {b_by})", flush=True)
    print(json.dumps({"router_probe_us": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
