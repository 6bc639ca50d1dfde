"""What holds the redesigned gossip mixes back, on one CUDA card.

    PYTHONPATH=src python benchmarks/gossip_variants.py [KERNEL ...]

Variants of ``csrc/gossip_mix.cu`` (its tile regime),
``csrc/gossip_mix_sparse.cu`` and ``csrc/gossip_mix_quant.cu`` (their
slice branches), each built from the kernel's source with one piece
changed or taken out, timed through the C entry at the shapes that
matter:

- dense, W = 500 and 1000 at F = 4096 (f32 and an int8 payload) and W =
  200: ``base`` (the kernel as it is); ``wide`` (128 x 128 CTA tiles, 2 x
  8 mma tiles a warp, one CTA per SM); ``one_product`` (hi.hi only: what
  3xTF32 costs over plain TF32);
- int8, W = 22 (K = 5, F = 2048) and W = 500 (K = 25, F = 4096):
  ``base``; ``cols8``, ``cols16`` (8 or 16 columns of a row per thread, not
  4); ``threads256``, ``threads1024`` (one CTA size at every W);
  ``no_widen`` (the int8 bytes fed to the FMAs as raw bits: what widening
  costs); ``staging_only`` (the gather-and-FMA loop taken out: the copies,
  the slot fold and the launch);
- sparse, W = 22 (K = 5, F = 2048) and W = 500 (K = 25, F = 4096), f32
  and bf16 payloads: ``base`` at the plan's launch and, through the C
  entry's arguments, at other slice widths, row splits and CTA sizes;
  ``stage_only`` (the gather-and-FMA loop taken out: the slice copy, the
  slot copies and the launch); ``copy_only`` (the slot copies taken out
  too: the slice copy and the launch); ``no_slots`` (no slot copies and
  no slot reads: each row folds rows (r + k) mod 16 with weight 1);
  ``no_w`` (no read of w's slice: the slot's row number is folded as the
  value); ``no_widen`` (one 8-byte load of two payload words, fed to the
  FMAs as they are: for bf16, what widening costs; meaningless for f32);
  ``unroll8`` (the slot loop unrolled 8 times, not 4).

KERNEL (``gossip_mix``, ``gossip_mix_sparse``, ``gossip_mix_quant``)
picks the kernels whose variants run; all three by default. The
variants' outputs are wrong by construction (``base`` is checked
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
# the sparse mix's loop over a slot group's rows and its slot copies
_SPARSE_ROWS = "for (int r = tid / n_cg; r < nr; r += n_rg) {"
_SPARSE_NO_ROWS = "for (int r = nr; r < nr; r += n_rg) {"
_SPARSE_SLOTS = "for (int e = threadIdx.x; e < n; e += blockDim.x) {"
_SPARSE_NO_SLOTS = "for (int e = threadIdx.x; e < 0; e += blockDim.x) {"
_SPARSE_LOAD = "          lds4(swc + sl.x * cols, x);"
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
    "gossip_mix_sparse": {
        "base": [],
        "stage_only": [(_SPARSE_ROWS, _SPARSE_NO_ROWS)],
        "copy_only": [(_SPARSE_ROWS, _SPARSE_NO_ROWS),
                      (_SPARSE_SLOTS, _SPARSE_NO_SLOTS)],
        "no_slots": [(_SPARSE_SLOTS, _SPARSE_NO_SLOTS),
                     ("          const int2 sl = slot[k];",
                      "          const int2 sl = make_int2((r + k) & 15, "
                      "0x3f800000);")],
        "no_w": [(_SPARSE_LOAD, "          x[0] = x[1] = x[2] = x[3] = "
                  "__int_as_float(sl.x);")],
        "no_widen": [(_SPARSE_LOAD, "          {\n"
                      "            const uint2 q = *reinterpret_cast<const "
                      "uint2*>(swc + sl.x * cols);\n"
                      "            x[0] = x[2] = __uint_as_float(q.x);\n"
                      "            x[1] = x[3] = __uint_as_float(q.y);\n"
                      "          }")],
        "unroll8": [("#pragma unroll 4\n        for (int k = 0; k < K; ++k)",
                     "#pragma unroll 8\n        for (int k = 0; k < K; ++k)")],
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


def time_sparse(variant: str) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops, ref
    fn = load("gossip_mix_sparse", variant)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    # launches (cols, split, threads) tried beside the plan's, base only
    others = {(22, "float32"): [(16, 1, 256), (32, 1, 256), (64, 4, 256)],
              (22, "bfloat16"): [(32, 1, 256), (32, 2, 256), (64, 4, 256)],
              (500, "float32"): [(64, 2, 1024), (32, 2, 1024),
                                 (16, 1, 1024)],
              (500, "bfloat16"): [(32, 1, 1024), (128, 4, 1024),
                                  (32, 2, 1024)]}
    for w, kp, f in ((22, 4, 2048), (500, 24, 4096)):
        _, idx, val, _ = cs.world_csr(w, kp, seed=7, dev=dev)
        k = idx.shape[1]
        for dtype in ("float32", "bfloat16"):
            x, _ = cs.payload(gen, w, f, dtype)
            size = x.element_size()
            plan = ops.gossip_mix_sparse_plan(w, k, f, x.dtype, x.data_ptr())
            launches = [(plan.cols, plan.split, plan.threads)]
            if variant == "base":
                launches += others[w, dtype]
            out = torch.empty(w, f, device=dev)
            for cols, split, threads in launches:
                rows = ops._sparse_rows(w, k, cols, split, size)
                smem = ops._sparse_slice_bytes(w, k, cols, split, rows, size)

                def call():
                    rc = fn(idx.data_ptr(), val.data_ptr(), x.data_ptr(),
                            out.data_ptr(), w, k, f, ops._DTYPE_CODE[x.dtype],
                            1, cols, split, rows, threads, plan.align, smem,
                            torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f"{variant}: launch failed ({rc})")

                call()
                torch.cuda.synchronize()
                note = ""
                if variant == "base":
                    want = ref.gossip_mix_sparse_ref(idx, val, x)
                    note = f" (max err {float((out - want).abs().max()):.2e})"
                tag = " (plan)" if (cols, split, threads) == launches[0] \
                    else ""
                print(f"  gossip_mix_sparse {variant:10s} W={w:3d} K={k:2d} "
                      f"F={f} {dtype:8s} cols={cols:3d} split={split} "
                      f"threads={threads:4d}{tag}: "
                      f"{cs.device_ms(call) * 1e3:.2f} us{note}", flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--variant":
        kernel, variant = sys.argv[2], sys.argv[3]
        {"gossip_mix": time_dense, "gossip_mix_sparse": time_sparse,
         "gossip_mix_quant": time_quant}[kernel](variant)
        return 0
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kernel in sys.argv[1:] or VARIANTS:
        variants = VARIANTS[kernel]
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
