// Shared pieces of the gossip-mix kernels: payload type codes, widening to
// fp32, and one 16-byte vector load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace gossip {

// Payload type codes passed by the Python wrappers (kernels/build.py).
enum Dtype : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

// Elements of T in one 16-byte load.
template <typename T> struct Vec;
template <> struct Vec<float> { static constexpr int N = 4; };
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec<int8_t> { static constexpr int N = 16; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// Loads N = Vec<T>::N consecutive elements at p (16-byte aligned) with one
// 16-byte load and widens them to fp32 in registers.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[Vec<T>::N]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) v[j] = to_f32(e[j]);
}

}  // namespace gossip
