"""What holds the tensor-core SSD kernel (``csrc/ssd_chunk_tc.cu``) back, on
one CUDA card.

    PYTHONPATH=src python benchmarks/ssd_tc_probe.py

1. The rate ``mma.sync.m16n8k8`` TF32 reaches alone: every warp issues
   independent products on registers, 8 accumulators, 16 warps per SM.
2. Variants of the kernel, built from its source with one piece taken out,
   timed at the main path's shapes (``chip_smoke.SSD_TIMED``: Mamba2-780M's
   [32, 48, 256, 128, 64] and Jamba's [16, 128, 256, 16, 64]): ``base``
   (the kernel as it is), ``one_pass`` (W . X with the hi.hi product only),
   ``no_scores`` (the score phase skipped) and ``no_heads`` (the W . X
   phase skipped). The variants' outputs are wrong by construction: only
   their times mean anything. Each variant runs in a process of its own
   (their libraries share symbol names).

Device ms per call as ``chip_smoke.device_ms`` takes them. Builds into
``build/ssd_tc_probe/``. Imports nothing of JAX or of the ``repro``
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

OUT = ROOT / "build" / "ssd_tc_probe"
SOURCE = build.CSRC / "ssd_chunk_tc.cu"
# variant -> (text in the kernel's source, its replacement)
VARIANTS = {
    "base": [],
    "one_pass": [("mma_tf32(acc[2 * m], al, bh[0]);", ""),
                 ("mma_tf32(acc[2 * m + 1], al, bh[1]);", ""),
                 ("mma_tf32(acc[2 * m], ah, bl[0]);", ""),
                 ("mma_tf32(acc[2 * m + 1], ah, bl[1]);", "")],
    "no_scores": [("const int n_items = nkt * n_nc;",
                   "const int n_items = 0;")],
    "no_heads": [("const int n_items2 = n_heads * nkt;",
                  "const int n_items2 = 0;")],
}
MMA_RATE = r"""
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>
__global__ void __launch_bounds__(256) rate(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  uint32_t b0 = threadIdx.x ^ 5u, b1 = 11u;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
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
int main() {
  float* out;
  cudaMalloc(&out, 4);
  int sms;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int iters = 4096, blocks = 2 * sms;
  rate<<<blocks, 256>>>(out, 16);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  rate<<<blocks, 256>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2048.0 * 8 * iters * blocks * 8;
  printf("mma.sync m16n8k8 tf32, 16 warps/SM, 8 accumulators: %.1f "
         "TFLOP/s (%s)\n", flop / ms / 1e9,
         cudaGetErrorString(cudaGetLastError()));
  return 0;
}
"""


def nvcc(args):
    return subprocess.Popen([build.nvcc_path(), *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def time_variant(name: str) -> None:
    import torch
    import chip_smoke as cs
    fn = getattr(ctypes.CDLL(str(OUT / f"lib{name}.so")),
                 "ssd_chunk_tc_launch")
    fn.argtypes = list(build.SIGNATURES["ssd_chunk_tc"][1])
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    for tag, b, s, h, n, p, chunk in cs.SSD_TIMED[:1] + cs.SSD_TIMED[2:]:
        C, B, acum, dt, x = cs.ssd_inputs(gen, b, s, h, n, p, chunk, dev)
        g, t = x.shape[0], x.shape[2]
        y = torch.empty_like(x)

        def call():
            rc = fn(C.data_ptr(), B.data_ptr(), acum.data_ptr(),
                    dt.data_ptr(), x.data_ptr(), y.data_ptr(), g, h, t, n, p,
                    *x.stride()[:3], *y.stride()[:3],
                    torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"{name}: launch failed ({rc})")

        print(f"  {name:10s} [{g},{h},{t},{n},{p}] ({tag}): "
              f"{cs.device_ms(call, 20) * 1e3:.2f} us", flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--variant":
        time_variant(sys.argv[2])
        return 0
    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    (OUT / "mma_rate.cu").write_text(MMA_RATE)
    jobs = {"mma_rate": nvcc(["-gencode", "arch=compute_90a,code=sm_90a",
                              "-O3", "-o", str(OUT / "mma_rate"),
                              str(OUT / "mma_rate.cu")])}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in {SOURCE.name}")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        jobs[name] = nvcc([*build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
                           str(OUT / f"{name}.cu")])
    for name, proc in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(log)
            raise RuntimeError(f"{name}: nvcc exit {proc.returncode}")
    print(subprocess.run([str(OUT / "mma_rate")], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for name in VARIANTS:
        subprocess.run([sys.executable, __file__, "--variant", name],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
