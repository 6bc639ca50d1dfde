// One warp routes one row of MoE router logits: the fp32 softmax
// exp(x - max) / sum, then k rounds of "take the max, mask it to -1" in
// which the lower expert index wins a tie (the TPU kernel
// src/repro/kernels/moe_router.py, moe_router_pallas), then the gates
// renormalised by their sum + 1e-9. Shared by moe_router.cu and
// moe_route_slots.cu, so the two give the same gates and indices bit for
// bit.
//
// Lane l holds the logits of experts l + 32i (i < EPL = ceil(E / 32),
// E <= 512) in registers, so the loads are coalesced. The max and the sum
// are butterfly reductions over __shfl_xor; each of the k rounds is a
// lane-local arg-max (ascending index, strict >, so the lane's lower index
// wins) and a butterfly arg-max on (value, index) pairs in which the lower
// index wins an equal value, so every lane agrees on the winner; the owner
// masks it to -1, below every probability. Round r's winner is kept by
// lane r (k <= 32), which then writes its gate and index.
#pragma once

#include "common.cuh"

#include <climits>
#include <math.h>

namespace router {

using gossip::to_f32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The whole warp routes row x[0, E); lane r < k returns round r's winner:
// its renormalised gate and its expert index.
template <typename T, int EPL>
__device__ __forceinline__ void route_row(const T* __restrict__ x, int E,
                                          int k, int lane, float& gate,
                                          int& expert) {
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
  gate = my_val / (total + 1e-9f);
  expert = my_idx;
}

}  // namespace router
