// The padded-CSR gather-mix shared by gossip_mix_sparse.cu and
// gossip_mix_quant.cu:
//
//   out[i, f] = sum_k wk[i, k] * w[idx[i, k], f]      (fp32 accumulate)
//
// with wk = val (sparse) or val * scale[idx] (quant: the int8 dequant scale
// folded into the weight once per slot, so the int8 rows are widened in
// registers and no fp32 copy of the stack is ever written).
//
// One block per (row i, F tile). The block stages row i's K slots in shared
// memory (CSR_SLOTS at a time, so any K works), then every thread walks the
// slots with fp32 FMAs over its columns. Where F and the pointers allow it
// (VECTOR), a thread owns Vec<T>::N consecutive columns and reads each
// gathered row with one 16-byte load; otherwise (a ragged leaf such as a
// 10-wide bias) a thread owns N columns strided by the block width, which
// keeps the loads coalesced, and the F tail is masked. F is never padded.
#pragma once

#include "common.cuh"

namespace gossip {

constexpr int CSR_THREADS = 256;
constexpr int CSR_SLOTS = 128;

template <typename T, bool VECTOR>
__global__ void __launch_bounds__(CSR_THREADS)
csr_mix_kernel(const int32_t* __restrict__ idx, const float* __restrict__ val,
               const float* __restrict__ scale, const T* __restrict__ w,
               float* __restrict__ out, int K, int64_t F) {
  constexpr int N = Vec<T>::N;
  __shared__ int32_t s_idx[CSR_SLOTS];
  __shared__ float s_val[CSR_SLOTS];

  const int64_t i = blockIdx.y;
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * CSR_THREADS * N;
  // VECTOR: columns col0 .. col0+N-1; else col0 + j*CSR_THREADS, j < N
  const int64_t col0 = VECTOR ? tile0 + static_cast<int64_t>(threadIdx.x) * N
                              : tile0 + threadIdx.x;
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += CSR_SLOTS) {
    const int nk = min(CSR_SLOTS, K - k0);
    for (int t = threadIdx.x; t < nk; t += CSR_THREADS) {
      const int32_t j = idx[i * K + k0 + t];
      float v = val[i * K + k0 + t];
      if (scale != nullptr) v *= scale[j];
      s_idx[t] = j;
      s_val[t] = v;
    }
    __syncthreads();
    for (int t = 0; t < nk; ++t) {
      const T* row = w + static_cast<int64_t>(s_idx[t]) * F;
      const float v = s_val[t];
      if constexpr (VECTOR) {
        if (col0 < F) {
          float x[N];
          load16<T>(row + col0, x);
#pragma unroll
          for (int j = 0; j < N; ++j) acc[j] = fmaf(v, x[j], acc[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < N; ++j) {
          const int64_t c = col0 + static_cast<int64_t>(j) * CSR_THREADS;
          if (c < F) acc[j] = fmaf(v, to_f32(row[c]), acc[j]);
        }
      }
    }
    __syncthreads();
  }

  float* o = out + i * F;
  if constexpr (VECTOR) {
    if (col0 < F) {
#pragma unroll
      for (int j = 0; j < N; j += 4)
        *reinterpret_cast<float4*>(o + col0 + j) =
            make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int64_t c = col0 + static_cast<int64_t>(j) * CSR_THREADS;
      if (c < F) o[c] = acc[j];
    }
  }
}

// Launches csr_mix_kernel<T> on `stream`, taking the 16-byte vector path
// when F is a multiple of Vec<T>::N and both w and out are 16-byte aligned.
// Returns cudaGetLastError() right after the launch.
template <typename T>
int launch_csr_mix(const int32_t* idx, const float* val, const float* scale,
                   const void* w, float* out, int W, int K, int64_t F,
                   cudaStream_t stream) {
  constexpr int N = Vec<T>::N;
  const T* wt = static_cast<const T*>(w);
  const bool vector = F % N == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int64_t tile = static_cast<int64_t>(CSR_THREADS) * N;
  const dim3 grid(static_cast<unsigned>((F + tile - 1) / tile),
                  static_cast<unsigned>(W));
  if (vector)
    csr_mix_kernel<T, true>
        <<<grid, CSR_THREADS, 0, stream>>>(idx, val, scale, wt, out, K, F);
  else
    csr_mix_kernel<T, false>
        <<<grid, CSR_THREADS, 0, stream>>>(idx, val, scale, wt, out, K, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gossip
