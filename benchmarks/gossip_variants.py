"""What holds the redesigned dense and int8 gossip mixes back, on one CUDA
card.

    PYTHONPATH=src python benchmarks/gossip_variants.py

Variants of ``csrc/gossip_mix.cu`` (its tile regime) and
``csrc/gossip_mix_quant.cu`` (its slice branch), each built from the
kernel's source with one piece changed or taken out, timed through the C
entry at the shapes that matter:

- dense, W = 500 and 1000 at F = 4096 (f32 and an int8 payload) and W =
  200: ``base`` (the kernel as it is); ``wide`` (128 x 128 CTA tiles, 2 x
  8 mma tiles a warp, one CTA per SM); ``one_product`` (hi.hi only: what
  3xTF32 costs over plain TF32);
- int8, W = 22 (K = 5, F = 2048) and W = 500 (K = 25, F = 4096):
  ``base``; ``cols8``, ``cols16`` (8 or 16 columns of a row per thread, not
  4); ``threads256``, ``threads1024`` (one CTA size at every W);
  ``no_widen`` (the int8 bytes fed to the FMAs as raw bits: what widening
  costs); ``staging_only`` (the gather-and-FMA loop taken out: the copies,
  the slot fold and the launch).

The variants' outputs are wrong by construction (``base`` is checked
against the plain version): only their times mean anything. Each variant
runs in a process of its own (their libraries share symbol names). Device
us per call as ``chip_smoke.device_ms`` takes them. Builds into
``build/gossip_variants/``. Imports nothing of JAX or of the ``repro``
package.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import build  # noqa: E402

OUT = ROOT / "build" / "gossip_variants"
# kernel -> variant -> (text in the kernel's source, its replacement)
VARIANTS = {
    "gossip_mix": {
        "base": [],
        "wide": [("constexpr int MT = 2, NT = 4;",
                  "constexpr int MT = 2, NT = 8;"),
                 ("__launch_bounds__(MIX_THREADS, 2)",
                  "__launch_bounds__(MIX_THREADS, 1)")],
        "one_product": [("          mma_tf32(acc[mt][nt], al[mt], bh);\n",
                         ""),
                        ("          if constexpr (WIDE) mma_tf32(acc[mt][nt], "
                         "ah[mt], bl);\n", "")],
    },
    "gossip_mix_quant": {
        "base": [],
        "cols8": [("constexpr int CPT = 4;", "constexpr int CPT = 8;")],
        "cols16": [("constexpr int CPT = 4;", "constexpr int CPT = 16;")],
        "threads256": [("> 256;\n    auto kern", "> 1 << 30;\n    auto kern")],
        "threads1024": [("> 256;\n    auto kern", "> 0;\n    auto kern")],
        "no_widen": [("        for (int u = 0; u < CPT / 4; ++u) "
                      "i8x4_to_f32(raw[u], x + 4 * u);\n",
                      "        for (int c = 0; c < CPT; ++c)\n"
                      "          x[c] = __uint_as_float(raw[c / 4] + c);\n")],
        "staging_only": [("    for (int r = tid / n_cg; r < nr; r += n_rg) {",
                          "    for (int r = nr; r < nr; r += n_rg) {")],
    },
}
# the tile regime's CTA tile (rows, cols) per variant
TILE = {"base": (128, 64), "wide": (128, 128), "one_product": (128, 64)}


def tile_smem(variant: str, size: int) -> int:
    """Shared-memory bytes of a tile-regime variant's 3-stage ring."""
    bm, bn = TILE[variant]
    return 3 * (bm * 36 * 4 + 32 * (bn + (16 if size == 1 else 8)) * size)


def load(kernel: str, variant: str):
    fn = getattr(ctypes.CDLL(str(OUT / f"lib{kernel}_{variant}.so")),
                 build.SIGNATURES[kernel][0])
    fn.argtypes = list(build.SIGNATURES[kernel][1])
    fn.restype = ctypes.c_int
    return fn


def time_dense(variant: str) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    fn = load("gossip_mix", variant)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for w, f, dtype in ((500, 4096, "float32"), (500, 4096, "int8"),
                        (1000, 4096, "float32"), (200, 4096, "float32")):
        P, *_ = cs.world_csr(w, 24, seed=7, dev=dev)
        x, scale = cs.payload(gen, w, f, dtype)
        Pm = P if scale is None else (P * scale[None, :]).contiguous()
        out = torch.empty(w, f, device=dev)
        flags = ops.W_ROWS16 | ops.OUT_ROWS16 | ops.P_ROWS16 * (w % 4 == 0)

        def call():
            rc = fn(Pm.data_ptr(), x.data_ptr(), out.data_ptr(), w, f,
                    ops._DTYPE_CODE[x.dtype], 1, 0, flags,
                    tile_smem(variant, x.element_size()),
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{variant}: launch failed ({rc})")

        call()
        torch.cuda.synchronize()
        note = ""
        if variant == "base":
            want = ref.gossip_mix_ref(Pm, x)
            err = float((out - want).abs().max())
            note = f" (max err {err:.2e}, limit " \
                   f"{1e-5 * (1 + float(want.abs().max())):.1e})"
        print(f"  gossip_mix {variant:12s} W={w:4d} F={f} {dtype:8s}: "
              f"{cs.device_ms(call) * 1e3:.2f} us{note}", flush=True)


def time_quant(variant: str) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    fn = load("gossip_mix_quant", variant)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for w, kp, f in ((22, 4, 2048), (500, 24, 4096)):
        _, idx, val, _ = cs.world_csr(w, kp, seed=7, dev=dev)
        q, scale = cs.payload(gen, w, f, "int8")
        k = idx.shape[1]
        branch, cols, rows, smem = ops.gossip_mix_quant_plan(w, k, f)
        out = torch.empty(w, f, device=dev)

        def call():
            rc = fn(idx.data_ptr(), val.data_ptr(), scale.data_ptr(),
                    q.data_ptr(), out.data_ptr(), w, k, f, branch, cols,
                    rows, 16, smem, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{variant}: launch failed ({rc})")

        call()
        torch.cuda.synchronize()
        note = ""
        if variant == "base":
            want = ref.gossip_mix_quant_ref(idx, val, scale, q)
            note = f" (max err {float((out - want).abs().max()):.2e})"
        print(f"  gossip_mix_quant {variant:12s} W={w:4d} K={k:2d} F={f} "
              f"cols={cols}: {cs.device_ms(call) * 1e3:.2f} us{note}",
              flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--variant":
        kernel, variant = sys.argv[2], sys.argv[3]
        (time_dense if kernel == "gossip_mix" else time_quant)(variant)
        return 0
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kernel, variants in VARIANTS.items():
        src = (build.CSRC / f"{kernel}.cu").read_text()
        for variant, subs in variants.items():
            text = src
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"{kernel} {variant}: {old!r} not in "
                                       f"the source")
                text = text.replace(old, new)
            cu = OUT / f"{kernel}_{variant}.cu"
            cu.write_text(text)
            jobs[kernel, variant] = subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                 "-o", str(OUT / f"lib{kernel}_{variant}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (kernel, variant), proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            raise RuntimeError(f"{kernel} {variant}: nvcc exit "
                               f"{proc.returncode}")
    for kernel, variant in jobs:
        subprocess.run([sys.executable, __file__, "--variant", kernel,
                        variant], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
