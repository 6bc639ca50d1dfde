// moe_router — fused softmax + top-k routing on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_router.py,
// moe_router_pallas: logits [T, E] (f32 or bf16) -> the fp32 softmax
// exp(x - max) / sum, then k rounds of "take the max, mask it to -1" in
// which the lower expert index wins a tie, then gates / (sum + 1e-9);
// gates [T, k] f32 and idx [T, k] int32. The grouped MoE dispatch uses
// moe_route_slots.cu, which routes each row with the same code
// (router_row.cuh) and also assigns each pair its slot; this kernel serves
// the callers that want only the routing (moe_dense, every decode step).
//
// Bound on an H100: T*E*sizeof(logits) + T*k*8 bytes over 3.35 TB/s, under
// 1 MB and a fraction of a microsecond at the serving path's T <= 4096,
// E = 64: the kernel is launch-latency bound, and its design only keeps the
// row out of device memory between the softmax and the top-k (the TPU
// kernel's point) and every lane busy.
//
// Design: one warp per row (router_row.cuh), 8 rows per 256-thread block;
// lane r < k writes round r's gate and index: one coalesced store each.
#include "router_row.cuh"

namespace router {

constexpr int THREADS = 256, ROWS = THREADS / 32;

template <typename T, int EPL>
__global__ void __launch_bounds__(THREADS)
router_kernel(const T* __restrict__ logits, float* __restrict__ gates,
              int* __restrict__ idx, int Tn, int E, int k) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  if (row >= Tn) return;  // the whole warp leaves together
  float gate;
  int expert;
  route_row<T, EPL>(logits + static_cast<int64_t>(row) * E, E, k, lane, gate,
                    expert);
  if (lane < k) {
    const int64_t out = static_cast<int64_t>(row) * k + lane;
    gates[out] = gate;
    idx[out] = expert;
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
