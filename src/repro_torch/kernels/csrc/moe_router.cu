// moe_router — fused softmax + top-k routing on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_router.py,
// moe_router_pallas: logits [T, E] (f32 or bf16) -> the fp32 softmax
// exp(x - max) / sum, then k rounds of "take the max, mask it to -1" in
// which the lower expert index wins a tie, then gates / (sum + 1e-9);
// gates [T, k] f32 and idx [T, k] int32.
//
// Bound on an H100: T*E*sizeof(logits) + T*k*8 bytes over 3.35 TB/s, under
// 1 MB and a fraction of a microsecond at the serving path's T <= 4096,
// E = 64: the kernel is launch-latency bound, and its design only keeps the
// row out of device memory between the softmax and the top-k (the TPU
// kernel's point) and every lane busy.
//
// Design: one warp per row, 8 rows per 256-thread block. Lane l holds the
// logits of experts l + 32i (i < EPL = ceil(E / 32), E <= 512) in
// registers, so the loads are coalesced. The max and the sum are butterfly
// reductions over __shfl_xor; each of the k rounds is a lane-local arg-max
// (ascending index, strict >, so the lane's lower index wins) and a
// butterfly arg-max on (value, index) pairs in which the lower index wins
// an equal value, so every lane agrees on the winner; the owner masks it to
// -1, below every probability. Round r's winner is kept by lane r (k <= 32),
// which then writes its gate and index: one coalesced store each.
#include "common.cuh"

#include <climits>
#include <math.h>

namespace router {

using gossip::to_f32;

constexpr int THREADS = 256, ROWS = THREADS / 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int EPL>
__global__ void __launch_bounds__(THREADS)
router_kernel(const T* __restrict__ logits, float* __restrict__ gates,
              int* __restrict__ idx, int Tn, int E, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= Tn) return;  // the whole warp leaves together
  const T* x = logits + static_cast<int64_t>(row) * E;

  float p[EPL];
  float mx = -INFINITY;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    const int e = lane + 32 * i;
    p[i] = e < E ? to_f32(x[e]) : -INFINITY;
    mx = fmaxf(mx, p[i]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    p[i] = lane + 32 * i < E ? expf(p[i] - mx) : 0.f;
    sum += p[i];
  }
  sum = warp_sum(sum);
#pragma unroll
  for (int i = 0; i < EPL; ++i) p[i] = lane + 32 * i < E ? p[i] / sum : -1.f;

  float my_val = 0.f;
  int my_idx = 0;
  for (int r = 0; r < k; ++r) {
    float bv = -2.f;
    int bi = INT_MAX;
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      if (p[i] > bv) {
        bv = p[i];
        bi = lane + 32 * i;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == r) {
      my_val = bv;
      my_idx = bi;
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i)
      if (lane + 32 * i == bi) p[i] = -1.f;
  }

  const float total = warp_sum(lane < k ? my_val : 0.f);
  if (lane < k) {
    const int64_t out = static_cast<int64_t>(row) * k + lane;
    gates[out] = my_val / (total + 1e-9f);
    idx[out] = my_idx;
  }
}

template <typename T, int EPL>
int launch(const void* logits, void* gates, void* idx, int Tn, int E, int k,
           cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((Tn + ROWS - 1) / ROWS);
  router_kernel<T, EPL><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<float*>(gates),
      static_cast<int*>(idx), Tn, E, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_e(const void* logits, void* gates, void* idx, int Tn, int E,
             int k, cudaStream_t s) {
  if (E <= 32) return launch<T, 1>(logits, gates, idx, Tn, E, k, s);
  if (E <= 64) return launch<T, 2>(logits, gates, idx, Tn, E, k, s);
  if (E <= 128) return launch<T, 4>(logits, gates, idx, Tn, E, k, s);
  if (E <= 256) return launch<T, 8>(logits, gates, idx, Tn, E, k, s);
  if (E <= 512) return launch<T, 16>(logits, gates, idx, Tn, E, k, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace router

extern "C" int moe_router_launch(const void* logits, void* gates, void* idx,
                                 int T, int E, int k, int dtype,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 32 || k > E) return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case gossip::kF32:
      return router::launch_e<float>(logits, gates, idx, T, E, k, s);
    case gossip::kBF16:
      return router::launch_e<__nv_bfloat16>(logits, gates, idx, T, E, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
