// moe_router — fused softmax + top-k routing on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_router.py:45,
// moe_router_pallas (its pallas_call at :50): logits [T, E] (f32 or bf16)
// -> the fp32 softmax exp(x - max) / sum, then k rounds of "take the max,
// mask it to -1" in which the lower expert index wins a tie, then
// gates / (sum + 1e-9); gates [T, k] f32 and idx [T, k] int32. The grouped
// MoE dispatch uses moe_route_slots.cu, which routes each row with the same
// code (router_row.cuh) and also assigns each pair its slot; this kernel
// serves the callers that want only the routing (moe_dense, every decode
// step; expert parallelism's replicated path).
//
// Bound on an H100: T*E*sizeof(logits) + T*k*8 bytes over 3.35 TB/s; the
// softmax's 3 and the rounds' k fp32 operations a logit are a tenth of that
// at 67 TFLOP/s. At E = 64, k = 6, f32: T = 4 0.0004 us, T = 2048 0.186 us,
// T = 4096 0.372 us, T = 32768 (expert parallelism's prefill_32k) 2.97 us
// (8.39 MB read, 1.57 MB written). Below T = 4096 a launch costs more than
// the bytes: a one-element add_ takes 1.1-1.4 us under the same timing.
//
// What held the first design back: one warp a row. At E = 64 each lane held
// two logits, and a row cost 75 warp shuffles (5 for the max, 5 for the sum,
// k * 10 for the arg-max rounds, 5 for the renormalising sum) in a chain of
// 45 dependent butterfly levels. At T = 32768 the shuffles' issue set the
// time (23.8 us; an SM issues one shuffle a clock). Its loads were 4 (f32)
// or 2 (bf16) bytes a lane.
//
// This design (router_row.cuh): G lanes a row, G from E alone (G = 16 at
// E = 64: 4 contiguous experts a lane, 2 rows a warp), so one shuffle
// serves 32 / G rows and a lane's experts come in one vector load. A lane
// sorts its experts once; a round is a butterfly of head values (log2 G
// shuffles), a ballot and one shuffle, so a row costs 21 shuffles and 3
// ballots at k = 6 where it cost 75 shuffles, and only the k winners are
// divided by the sum. Measured against G = 4 and 8 (16 and 8 experts a
// lane), G = 16 is the fastest at T <= 4096 and within 3 % of G = 8 at
// T = 32768; the code of a row's path grows with the experts a lane (552,
// 888 and 2,008 SASS instructions), and at small T a launch runs it once
// (PERF.md, Findings). One warp routes one group of 32 / G rows, and the
// grid covers every group: a grid of one resident wave whose warps walk
// the groups, loading the next before they reduce the current, timed no
// faster. A warp's 32 / G rows write their k gates and k indices, one
// contiguous run of [T, k], two stores a slot (round s * G + gl of each
// row).
#include "router_row.cuh"

namespace router {

constexpr int THREADS = 256, WARPS = THREADS / 32;

template <typename T, int G, int EPL>
__global__ void __launch_bounds__(THREADS)
router_kernel(const T* __restrict__ logits, float* __restrict__ gates,
              int* __restrict__ idx, int Tn, int E, int k) {
  constexpr int KPL = kpl<G, EPL>();
  const int lane = threadIdx.x & 31, gl = lane % G;
  const int64_t group = static_cast<int64_t>(blockIdx.x) * WARPS +
                        threadIdx.x / 32;
  const int64_t row0 = group * (32 / G);
  if (row0 >= Tn) return;  // the whole warp leaves together
  // rows past T (in the last group) route row T - 1 and store nothing
  const int64_t row = row0 + lane / G;
  float p[EPL];
  load_experts<T, EPL>(logits + (row < Tn ? row : Tn - 1) * E, E, gl * EPL,
                       p);
  float gate[KPL];
  int expert[KPL];
  route_row<G, EPL>(p, E, k, gl, gate, expert);
  if (row >= Tn) return;
#pragma unroll
  for (int s = 0; s < KPL; ++s)
    if (s * G + gl < k) {
      gates[row * k + s * G + gl] = gate[s];
      idx[row * k + s * G + gl] = expert[s];
    }
}

template <typename T, int G, int EPL>
int launch(const void* logits, void* gates, void* idx, int Tn, int E, int k,
           cudaStream_t stream) {
  constexpr int ROWS = WARPS * 32 / G;  // rows a block
  const unsigned blocks = static_cast<unsigned>((Tn + ROWS - 1) / ROWS);
  router_kernel<T, G, EPL><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(logits), static_cast<float*>(gates),
      static_cast<int*>(idx), Tn, E, k);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_e(const void* logits, void* gates, void* idx, int Tn, int E,
             int k, cudaStream_t s) {
  const int rc = dispatch_lanes(E, [&](auto g, auto epl) {
    return launch<T, decltype(g)::value, decltype(epl)::value>(
        logits, gates, idx, Tn, E, k, s);
  });
  return rc < 0 ? static_cast<int>(cudaErrorInvalidValue) : rc;
}

}  // namespace router

extern "C" int moe_router_launch(const void* logits, void* gates, void* idx,
                                 int T, int E, int k, int dtype,
                                 void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > router::MAX_K || k > E || E < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (dtype) {
    case gossip::kF32:
      return router::launch_e<float>(logits, gates, idx, T, E, k, s);
    case gossip::kBF16:
      return router::launch_e<__nv_bfloat16>(logits, gates, idx, T, E, k, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
