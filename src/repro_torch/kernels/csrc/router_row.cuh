// A group of G lanes routes one row of MoE router logits: the fp32 softmax
// exp(x - max) / sum, then k rounds of "take the max, mask it to -1" in
// which the lower expert index wins a tie (the TPU kernel
// src/repro/kernels/moe_router.py, moe_router_pallas), then the gates
// renormalised by their sum + 1e-9. Shared by moe_router.cu and
// moe_route_slots.cu, so the two give the same gates and indices bit for
// bit.
//
// Lanes. G, the lanes a row, follows from E alone (dispatch_lanes): the
// least power of two with G * EPL_T >= E, EPL_T = 4 experts a lane, at
// most 32 (E > 128: G = 32 with 8, then 16 experts a lane); a warp holds
// 32 / G rows. Lane gl of a group holds experts gl * EPL .. gl * EPL +
// EPL - 1, in registers; experts at or past E are -inf before the softmax
// and -1 after it (nothing is padded in memory). A lane's run is read with
// 16-byte loads (8-byte for 4 bf16) where it lies inside the row and is
// aligned, else one element at a time. Four experts a lane against eight
// or sixteen (G = 16 at E = 64, against 8 or 4) keep the code of a row's
// path short, which times fastest at T <= 4096 (PERF.md, Findings).
//
// Order of the arithmetic (tests/test_torch_router_redesign.py emulates
// it): the max is a lane's own, then a butterfly of log2 G
// __shfl_xor_sync levels within the group; e = exp(x - max), and the sum a
// lane's own as a tree (element i + w added to i, w = EPL/2 .. 1), then
// the butterfly, so every lane holds the same max and sum. The k rounds
// pick from e, whose order is that of p = e / sum: each lane sorts its
// (e, expert) pairs once, larger e first and the lower expert first among
// equal ones (a bitonic network in registers). A round is a butterfly max
// over the lanes' head values, then a ballot of the group's lanes whose
// head equals it: lanes hold ascending runs of experts, so the lowest such
// lane holds the lowest expert of that value, the winner; one shuffle
// brings its expert, and it drops its head (its list moves up one, -1 at
// the end). Round r is kept by lane r % G of the group in its slot r / G,
// which then forms p = e / sum; the renormalising sum is each lane's slots
// in order, then the butterfly. At E = 64, k = 6 (G = 16) a round is four
// value shuffles, a ballot and one shuffle, each serving two rows.
#pragma once

#include "common.cuh"

#include <climits>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace router {

using gossip::to_f32;

constexpr int EPL_T = 4;  // experts a lane below G = 32
constexpr int MAX_E = 512, MAX_K = 32;

// The rounds a lane keeps at most: k <= min(G * EPL, 32), round r in lane
// r % G's slot r / G.
template <int G, int EPL>
__host__ __device__ constexpr int kpl() {
  return ((G * EPL < MAX_K ? G * EPL : MAX_K) + G - 1) / G;
}

// f(G, EPL) as std::integral_constant tags for E experts (the rule above);
// -1 where E is past MAX_E.
template <typename F>
int dispatch_lanes(int E, F f) {
  using std::integral_constant;
  if (E > MAX_E) return -1;
  if (E <= EPL_T)
    return f(integral_constant<int, 1>{}, integral_constant<int, EPL_T>{});
  if (E <= 2 * EPL_T)
    return f(integral_constant<int, 2>{}, integral_constant<int, EPL_T>{});
  if (E <= 4 * EPL_T)
    return f(integral_constant<int, 4>{}, integral_constant<int, EPL_T>{});
  if (E <= 8 * EPL_T)
    return f(integral_constant<int, 8>{}, integral_constant<int, EPL_T>{});
  if (E <= 16 * EPL_T)
    return f(integral_constant<int, 16>{}, integral_constant<int, EPL_T>{});
  if (E <= 32 * EPL_T)
    return f(integral_constant<int, 32>{}, integral_constant<int, EPL_T>{});
  if (E <= 64 * EPL_T)
    return f(integral_constant<int, 32>{},
             integral_constant<int, 2 * EPL_T>{});
  return f(integral_constant<int, 32>{}, integral_constant<int, 4 * EPL_T>{});
}

template <int G>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Experts first .. first + EPL - 1 of row x, widened to fp32; -inf at or
// past E.
template <typename T, int EPL>
__device__ __forceinline__ void load_experts(const T* __restrict__ x, int E,
                                             int first, float (&p)[EPL]) {
  // bytes a load: 16, or 8 where the lane's run is 8 bytes
  constexpr int RUN = EPL * static_cast<int>(sizeof(T));
  constexpr int VB = RUN % 16 == 0 ? 16 : (RUN == 8 ? 8 : 0);
  if constexpr (VB > 0) {
    using W = std::conditional_t<VB == 16, uint4, uint2>;
    constexpr int V = VB / static_cast<int>(sizeof(T));
    const T* src = x + first;
    if (first + EPL <= E && reinterpret_cast<uintptr_t>(src) % VB == 0) {
#pragma unroll
      for (int j = 0; j < EPL / V; ++j) {
        const W raw = __ldg(reinterpret_cast<const W*>(src) + j);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int i = 0; i < V; ++i) p[j * V + i] = to_f32(e[i]);
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < EPL; ++i)
    p[i] = first + i < E ? to_f32(x[first + i]) : -INFINITY;
}

// (av, ai) ranks before (bv, bi) in a lane's list: the larger value, the
// lower index on a tie
__device__ __forceinline__ bool before(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Sorts a lane's EPL (value, index) pairs so that each ranks before the
// next: a bitonic network, every compare-exchange on registers.
template <int EPL>
__device__ __forceinline__ void sort_lane(float (&v)[EPL], int (&ix)[EPL]) {
  static_assert((EPL & (EPL - 1)) == 0, "EPL must be a power of two");
#pragma unroll
  for (int size = 2; size <= EPL; size <<= 1)
#pragma unroll
    for (int stride = size / 2; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        const int j = i ^ stride;
        if (j < i) continue;
        const bool swap = (i & size) == 0 ? before(v[j], ix[j], v[i], ix[i])
                                          : before(v[i], ix[i], v[j], ix[j]);
        if (swap) {
          const float tv = v[i];
          v[i] = v[j];
          v[j] = tv;
          const int ti = ix[i];
          ix[i] = ix[j];
          ix[j] = ti;
        }
      }
}

// The G lanes of a group route the row whose experts p holds (lane gl:
// experts gl * EPL + i, from load_experts); p is consumed. Every lane of
// the warp calls it. Lane gl returns rounds r = s * G + gl < k: gate[s],
// the renormalised gate, and expert[s], its expert index.
template <int G, int EPL>
__device__ __forceinline__ void route_row(float (&p)[EPL], int E, int k,
                                          int gl, float (&gate)[kpl<G, EPL>()],
                                          int (&expert)[kpl<G, EPL>()]) {
  constexpr int KPL = kpl<G, EPL>();
  const int first = gl * EPL, lane = threadIdx.x & 31;
  // the group's lanes in a ballot
  const unsigned group = (G == 32 ? 0xffffffffu : (1u << (G % 32)) - 1u)
                         << (lane - gl);
  float t[EPL];  // tree reductions
#pragma unroll
  for (int i = 0; i < EPL; ++i) t[i] = p[i];
#pragma unroll
  for (int w = EPL / 2; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) t[i] = fmaxf(t[i], t[i + w]);
  const float mx = group_max<G>(t[0]);
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    p[i] = first + i < E ? expf(p[i] - mx) : 0.f;
    t[i] = p[i];
  }
#pragma unroll
  for (int w = EPL / 2; w > 0; w >>= 1)
#pragma unroll
    for (int i = 0; i < w; ++i) t[i] += t[i + w];
  const float sum = group_sum<G>(t[0]);

  int ix[EPL];
#pragma unroll
  for (int i = 0; i < EPL; ++i) {
    if (first + i >= E) p[i] = -1.f;  // below every e
    ix[i] = first + i;
  }
  sort_lane<EPL>(p, ix);
#pragma unroll
  for (int s = 0; s < KPL; ++s) {
    gate[s] = 0.f;
    expert[s] = 0;
  }
  for (int r = 0; r < k; ++r) {
    const float bv = group_max<G>(p[0]);
    const int w = __ffs(__ballot_sync(0xffffffffu, p[0] == bv) & group) - 1;
    const int bi = __shfl_sync(0xffffffffu, ix[0], w);
#pragma unroll
    for (int s = 0; s < KPL; ++s)
      if (r == s * G + gl) {
        gate[s] = bv;
        expert[s] = bi;
      }
    const bool won = lane == w;  // this lane's head: drop it
#pragma unroll
    for (int i = 0; i + 1 < EPL; ++i) {
      p[i] = won ? p[i + 1] : p[i];
      ix[i] = won ? ix[i + 1] : ix[i];
    }
    p[EPL - 1] = won ? -1.f : p[EPL - 1];
  }

  float part = 0.f;
#pragma unroll
  for (int s = 0; s < KPL; ++s)
    if (s * G + gl < k) {
      gate[s] = gate[s] / sum;
      part += gate[s];
    }
  const float total = group_sum<G>(part) + 1e-9f;
#pragma unroll
  for (int s = 0; s < KPL; ++s) gate[s] = gate[s] / total;
}

}  // namespace router
