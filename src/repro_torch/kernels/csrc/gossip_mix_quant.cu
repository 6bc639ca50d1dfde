// gossip_mix_quant — fused int8 dequantize -> padded-CSR gossip mix on
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix_quant.py,
// gossip_mix_quant_pallas: out[i] = sum_k val[i, k] * scale[idx[i, k]] *
// q[idx[i, k]], with q [W, F] int8, scale [W] f32, idx/val [W, K], out
// [W, F] f32.
//
// Bound on an H100: bytes, W*F*1 + W*F*4 + W*K*8 + W*4 over 3.35 TB/s (the
// output in fp32 is four fifths of it).
//
// Design against that bound (csr_mix.cuh, instantiated for int8): the
// dequant scale is folded into the slot weight once per block
// (sval = val * scale[idx]), and each thread reads 16 int8 values of a
// gathered row with one 16-byte load and widens them in registers, so no
// fp32 copy of the stack ever lands in device memory — the copy the TPU
// kernel exists to avoid. Accumulation and the single store are fp32.
#include "csr_mix.cuh"

extern "C" int gossip_mix_quant_launch(const void* idx, const void* val,
                                       const void* scale, const void* q,
                                       void* out, int W, int K, long long F,
                                       void* stream) {
  using namespace gossip;
  return launch_csr_mix<int8_t>(
      static_cast<const int32_t*>(idx), static_cast<const float*>(val),
      static_cast<const float*>(scale), q, static_cast<float*>(out), W, K, F,
      static_cast<cudaStream_t>(stream));
}
