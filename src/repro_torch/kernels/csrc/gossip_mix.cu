// gossip_mix — dense gossip mix out = P @ w on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix.py,
// gossip_mix_pallas: P [W, W] f32, w [W, F] f32, bf16 or int8 (the pallas
// backend folds the int8 row scales into P's columns and feeds the raw int8
// payload), out [W, F] f32, fp32 accumulate.
//
// Bound on an H100: W*F*sizeof(w) + W*F*4 + W*W*4 bytes over 3.35 TB/s,
// against 2*W*W*F fp32 flops over 67 TFLOP/s (CUDA cores; this kernel does
// not use the tensor cores). At DeFTA's small W the bytes bound it; the two
// cross near W = 80 for f32 w (W = 50 for int8), and at W = 500 the flops
// bound it.
//
// Design: a tiled product written out in the kernel body (the TPU kernel
// computes its P @ w tile product in its own body too). Each 256-thread
// block owns a 64 x 64 tile of out and walks the contraction (P's columns)
// in chunks of 16: a 64 x 16 slice of P and a 16 x 64 slice of w are staged
// in shared memory (w widened to fp32 as it is staged, so an int8 or bf16
// payload never exists in fp32 in device memory), then each thread
// accumulates a 4 x 4 micro-tile in registers. P is never resident whole —
// at W = 500 it is 1 MB, past the 227 KB a block can hold. Loads of w are
// coalesced along F; edges in W and F are masked, nothing is padded.
#include "common.cuh"

namespace gossip {

constexpr int BM = 64, BN = 64, BK = 16, DENSE_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(DENSE_THREADS)
dense_mix_kernel(const float* __restrict__ P, const T* __restrict__ w,
                 float* __restrict__ out, int W, int64_t F) {
  __shared__ float sP[BK][BM + 1];  // +1: conflict-free transposed stores
  __shared__ float sW[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * BN;

  float acc[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n] = 0.f;

  for (int k0 = 0; k0 < W; k0 += BK) {
    for (int e = tid; e < BM * BK; e += DENSE_THREADS) {
      const int r = e / BK, c = e % BK;
      const int gr = row0 + r, gc = k0 + c;
      sP[c][r] = (gr < W && gc < W)
                     ? P[static_cast<int64_t>(gr) * W + gc] : 0.f;
    }
    for (int e = tid; e < BK * BN; e += DENSE_THREADS) {
      const int r = e / BN, c = e % BN;
      const int gr = k0 + r;
      const int64_t gc = col0 + c;
      sW[r][c] = (gr < W && gc < F)
                     ? to_f32(w[static_cast<int64_t>(gr) * F + gc]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = sP[k][ty + 16 * m];
#pragma unroll
      for (int n = 0; n < 4; ++n) b[n] = sW[k][tx + 16 * n];
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) acc[m][n] = fmaf(a[m], b[n], acc[m][n]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int r = row0 + ty + 16 * m;
    if (r >= W) continue;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int64_t c = col0 + tx + 16 * n;
      if (c < F) out[static_cast<int64_t>(r) * F + c] = acc[m][n];
    }
  }
}

template <typename T>
int launch_dense(const float* P, const void* w, float* out, int W, int64_t F,
                 cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((F + BN - 1) / BN),
                  static_cast<unsigned>((W + BM - 1) / BM));
  dense_mix_kernel<T><<<grid, DENSE_THREADS, 0, stream>>>(
      P, static_cast<const T*>(w), out, W, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gossip

extern "C" int gossip_mix_launch(const void* P, const void* w, void* out,
                                 int W, long long F, int dtype, void* stream) {
  using namespace gossip;
  const auto* p = static_cast<const float*>(P);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return launch_dense<float>(p, w, o, W, F, s);
    case kBF16: return launch_dense<__nv_bfloat16>(p, w, o, W, F, s);
    case kI8: return launch_dense<int8_t>(p, w, o, W, F, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
