// gossip_mix_sparse — padded-CSR gossip mix on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix_sparse.py,
// gossip_mix_sparse_pallas: out[i] = sum_k val[i, k] * w[idx[i, k]], with
// idx/val [W, K] (a pad slot repeats row i with weight 0), w [W, F] f32 or
// bf16, out [W, F] f32.
//
// Bound on an H100: bytes. The mix does 2*W*K*F flops on
// W*F*sizeof(w) + W*F*4 + W*K*8 bytes (each input row read once, the output
// written once, the slots read once), about 0.25-0.5 flop per byte, far
// below the card's ~20 fp32 flops per byte; so the least time is those bytes
// over 3.35 TB/s.
//
// Design against that bound (csr_mix.cuh): the slots are loaded once per
// block into shared memory; each gathered row is read with 16-byte vector
// loads by neighbouring threads on neighbouring addresses; the K FMAs stay
// in registers, so out is written exactly once; F's tail is masked instead
// of padded to the TPU's 2048-lane tile, so no padded copy of w is made. A
// row is re-read once per slot that names it (K times over the whole mix);
// those re-reads mostly hit the 50 MB L2 at the main path's sizes.
#include "csr_mix.cuh"

extern "C" int gossip_mix_sparse_launch(const void* idx, const void* val,
                                        const void* w, void* out, int W, int K,
                                        long long F, int dtype,
                                        void* stream) {
  using namespace gossip;
  const auto* i32 = static_cast<const int32_t*>(idx);
  const auto* v = static_cast<const float*>(val);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_csr_mix<float>(i32, v, nullptr, w, o, W, K, F, s);
    case kBF16:
      return launch_csr_mix<__nv_bfloat16>(i32, v, nullptr, w, o, W, K, F, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
