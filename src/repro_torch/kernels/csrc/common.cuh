// Shared pieces of the gossip-mix kernels: payload type codes, widening to
// fp32, one 16-byte vector load, asynchronous copies to shared memory and
// the 3xTF32 split and product of the dense mix's tensor-core regime.
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
// int8 -> fp32 without the conversion unit (I2F issues 16 lanes a clock
// per SM on Hopper, an eighth of the FMA rate): 0x4B000080 + x is the float
// 2^23 + 128 + x, exactly, and one subtraction leaves x
__device__ __forceinline__ float to_f32(int8_t x) {
  return __int_as_float(0x4B000080 + x) - 8388736.f;
}
// four int8 packed in a word (byte j is element j), the same way: the
// bytes biased by 128, then each placed under the exponent of 2^23
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* v) {
  const uint32_t b = w ^ 0x80808080u;
  v[0] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7650)) - 8388736.f;
  v[1] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7651)) - 8388736.f;
  v[2] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7652)) - 8388736.f;
  v[3] = __uint_as_float(__byte_perm(b, 0x4B000000u, 0x7653)) - 8388736.f;
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

// The payload's raw bits, for copies that never widen.
template <typename T> struct Bits;
template <> struct Bits<float> { using type = uint32_t; };
template <> struct Bits<__nv_bfloat16> { using type = uint16_t; };
template <> struct Bits<int8_t> { using type = uint8_t; };

// Four consecutive payload elements at p in shared memory (4 * sizeof(T)
// aligned) with one load, widened to fp32.
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
}
__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(x.x << 16), v[1] = __uint_as_float(x.x & 0xFFFF0000u);
  v[2] = __uint_as_float(x.y << 16), v[3] = __uint_as_float(x.y & 0xFFFF0000u);
}
__device__ __forceinline__ void lds4(const int8_t* p, float (&v)[4]) {
  i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes from global to shared memory; zero-filled when !valid (src is
// then not read, but must be a valid address)
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes from global to shared memory (4-byte aligned); zero-filled when
// !valid
__device__ __forceinline__ void cp4(uint32_t dst, const void* src,
                                    bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// every group but the newest N complete
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away from zero,
// as cvt.rna.tf32.f32 rounds, in two integer operations: the carry of the
// rounding add runs into the exponent as it should), lo = v - hi exactly;
// lo goes to the tensor cores as it is, which read its top 19 bits (its
// TF32 truncation)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a . b on the tensor cores, mma.m16n8k8 TF32 with fp32 accumulate
// (not volatile: the compiler may interleave independent products; lane =
// 4 g + t: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); b0 (k t, n g), b1 (k t + 4, n g); d0, d1 (g, 2t + {0, 1}), d2, d3
// (g + 8, 2t + {0, 1}))
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace gossip
