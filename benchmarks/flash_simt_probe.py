"""What holds the SIMT flash kernel (``csrc/flash_attention.cu``, mma.sync
on the tensor cores) back, on one CUDA card.

    PYTHONPATH=src python benchmarks/flash_simt_probe.py [--src DIR]
        [--variants NAME ...] [--tag TAG]

1. The rates ``mma.sync`` reaches alone: m16n8k8 TF32 and m16n8k16 bf16,
   every warp issuing independent products on registers, 8 accumulators,
   8 warps per SM.
2. Variants of the kernel, built from its source with one piece taken out,
   timed through its split C entry at the main paths' shapes
   (``chip_smoke.SIMT_TIMED``, the wrapper's split count): ``base`` (the
   kernel as it is), ``no_pv`` (P.V skipped), ``no_scores`` (Q.K^T
   skipped), ``no_loads`` (no key tile loaded after the first),
   ``one_pass`` (P.V and, in f32, Q.K^T with the hi.hi product only),
   ``no_exp`` (the exponent of p taken out), ``no_tiles`` (no key tile:
   the launch, Q's load, the stores and the merge alone), ``no_merge``
   (no second pass) and ``unsplit`` (the kernel as it is, its key range
   never split, where the wrapper would split it). The variants' outputs are
   wrong by construction: only their times mean anything. Each variant
   runs in a process of its own (their libraries share symbol names).

``--src DIR`` takes the kernel's source from another tree's
``src/repro_torch/kernels/csrc`` (its ``common.cuh`` too; ``--variants
base`` for a source the other variants' texts do not match). Device us
per call as ``chip_smoke.device_ms`` takes them. Builds into
``build/flash_simt_probe/TAG/``. Imports nothing of JAX or of the ``repro``
package.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from repro_torch.kernels import build  # noqa: E402

OUT = ROOT / "build" / "flash_simt_probe"
# variant -> [(text in the kernel's source, its replacement)]
VARIANTS = {
    "base": [],
    "no_pv": [("accumulate<DP>(o, s, sK + BK * KS, lane);", "")],
    "no_scores": [("scores<DP>(s, qf, sK, lane);", "")],
    "no_loads": [("if (next < t1) load_kv(next, (next - t0) % STAGES);",
                  "")],
    "no_tiles": [("const int t1 = t_first + n_t * (z + 1) / splits;",
                  "const int t1 = t0;")],
    "no_merge": [("if (err != cudaSuccess || p.splits == 1)", "")],
    "unsplit": [],
    "one_pass": [("mma_tf32(sl[n], al, bh);", ""),
                 ("mma_tf32(sl[n], ah, bl);", ""),
                 ("mma_tf32(o[n], al, bh);", ""),
                 ("mma_tf32(o[n], ah, bl);", ""),
                 ("mma_bf16(o[2 * n], al, vb[0], vb[1]);", ""),
                 ("mma_bf16(o[2 * n + 1], al, vb[2], vb[3]);", "")],
    "no_exp": [("s[n][e] = exp2f(s[n][e] - mu[e >> 1]);",
                "s[n][e] = s[n][e] - mu[e >> 1];")],
}
MMA_RATE = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
template <bool BF16>
__global__ void __launch_bounds__(256) rate(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  uint32_t b0 = threadIdx.x ^ 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (BF16)
        asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    a[0] += 1;
  }
  float s = 0;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  if (s == 12345.f) out[0] = s;
}
template <bool BF16>
void measure(float* out, int sms) {
  const int iters = 4096, blocks = sms;
  rate<BF16><<<blocks, 256>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<BF16><<<blocks, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = (BF16 ? 4096.0 : 2048.0) * 8 * iters * blocks * 8;
  printf("mma.sync %s, 8 warps/SM, 8 accumulators: %.1f TFLOP/s (%s)\n",
         BF16 ? "m16n8k16 bf16" : "m16n8k8 tf32", flop / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
}
int main() {
  float* out;
  cudaMalloc(&out, 4);
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  measure<false>(out, sms);
  measure<true>(out, sms);
  return 0;
}
"""


def nvcc(args):
    return subprocess.Popen([build.nvcc_path(), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def time_variant(name: str, out_dir: Path) -> None:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ops
    fn = getattr(ctypes.CDLL(str(out_dir / f"lib{name}.so")),
                 "flash_attention_split_launch")
    fn.argtypes = list(build.VARIANTS["flash_attention"][1])
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    for label, dtype, b, h, sq, sk, d, causal in cs.SIMT_TIMED:
        q, k, v = cs.simt_inputs(gen, label, dtype, b, h, sq, sk, d, dev)
        out = torch.empty_like(q)
        splits = 1 if name == "unsplit" else ops.flash_simt_splits(
            b, h, sq, sk)
        part = torch.empty(max(1, ops.flash_simt_scratch(b, h, sq, d,
                                                         splits)),
                           dtype=torch.float32, device=dev)

        def call():
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b * h, h, sq, sk, d, *q.stride()[:3], *k.stride()[:3],
                    *out.stride()[:3], int(causal), 0,
                    ops._DTYPE_CODE[dtype], part.data_ptr(), splits,
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        calls = 20 if b * h * sq * sk <= 2 ** 26 else 3
        print(f"  {out_dir.name}/{name:9s} {label:32s} [{b},{h},{sq},{d}] "
              f"Sk={sk} {str(dtype)[6:]} splits={splits}: "
              f"{cs.device_ms(call, calls) * 1e3:.2f} us", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant")
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument("--src", default=str(build.CSRC))
    ap.add_argument("--tag", default="this")
    args = ap.parse_args()
    out_dir = OUT / args.tag
    if args.variant:
        time_variant(args.variant, out_dir)
        return 0
    src_dir = Path(args.src)
    if (src_dir / "src").is_dir():
        src_dir = src_dir / "src" / "repro_torch" / "kernels" / "csrc"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (src_dir / "flash_attention.cu").read_text()
    (OUT / "mma_rate.cu").write_text(MMA_RATE)
    jobs = {"mma_rate": nvcc(["-gencode", "arch=compute_90a,code=sm_90a",
                              "-O3", "-o", str(OUT / "mma_rate"),
                              str(OUT / "mma_rate.cu")])}
    for name in args.variants:
        subs = VARIANTS[name]
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        (out_dir / f"{name}.cu").write_text(text)
        jobs[name] = nvcc([*build.NVCC_FLAGS[:-2], "-I", str(src_dir),
                           "-o", str(out_dir / f"lib{name}.so"),
                           str(out_dir / f"{name}.cu")])
    for name, proc in jobs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
    print(subprocess.run([str(OUT / "mma_rate")], capture_output=True,
                         text=True).stdout, end="", flush=True)
    for name in args.variants:
        subprocess.run([sys.executable, __file__, "--variant", name,
                        "--tag", args.tag], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
