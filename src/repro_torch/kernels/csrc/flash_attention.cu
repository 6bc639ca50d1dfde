// flash_attention — online-softmax attention on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention_pallas: q [B*H, Sq, D] and k, v [B*H, Sk, D] (here
// addressed as [B, H, S, D] through strides, q's and k's own), f32 or
// bf16, out in q's type; scale 1/sqrt(D); causal and sliding-window masks
// (only at Sk = Sq: the wrapper refuses them otherwise, so Sk != Sq is the
// unmasked cross-attention); kv blocks no query of the block can reach are
// skipped; running max m, sum l and the accumulator in fp32; the output is
// acc / max(l, 1e-20).
//
// Bound on an H100: 2*B*H*(Sq + Sk)*D*sizeof(T) bytes over 3.35 TB/s
// against 4*D*(visible (q, k) pairs) flops. At the serving path's shapes
// the bytes bound [64, 512, 128] (10 us) and the flops bound [16, 4096,
// 128] (69 us at the bf16 tensor-core peak). This kernel is the simple,
// right first version: it multiplies on the CUDA cores in fp32, not on
// the tensor cores, so at long S it sits far above the flop bound
// (PERF.md).
//
// Design: one 256-thread block per (b*h, 64-query tile). The TPU's
// sequential kv grid axis becomes a loop inside the block over 64-key tiles
// [k_begin, k_end) that some query of the tile can see. The q, k and v
// tiles stay in their input type in shared memory (q and k rows padded to
// an odd number of 4-byte words, so 16 threads reading 16 rows at one
// column hit 16 banks); rows past Sq or Sk are zero-filled and the scores
// of keys past Sk masked with kpos < Sk, so a ragged length needs no
// padding in device memory. The head dim D is any width up to 128 whose
// rows are whole 4-byte words: the kernel is instantiated at DP, the next
// of {32, 64, 128}, and masks the ragged columns itself. Columns D..DP-1
// are zero-filled in shared memory, so they add nothing to q.k, and their
// accumulators are never stored (the reduced Whisper's D = 42 runs at
// DP = 64). The column masks are compiled in only where D < DP (RAGGED):
// at D = DP the loads and stores carry no per-word compare.
// Thread (ty, tx) owns query rows ty + 16m (m < 4): it computes the 4 x 4
// scores of those rows against keys tx + 16n, takes the row max and sum
// across the 16 threads of a row with __shfl_xor, writes p to shared memory
// and accumulates p @ v for columns tx + 16j (j < DP/16) in registers.
// Fully masked scores are -inf and a row that has seen no key yet keeps
// m = -inf with alpha = p = 0, so nothing is counted twice.
#include "common.cuh"

#include <math.h>

namespace flash {

using gossip::to_f32;

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr int P_STRIDE = BK + 16;  // two rows per warp land 16 banks apart
constexpr int kMaxDevices = 64;

// Row stride (elements) of a q or k tile in shared memory: an odd number
// of 4-byte words for DP in {32, 64, 128}.
template <typename T, int DP> struct Pad;
template <int DP> struct Pad<float, DP> {
  static constexpr int STRIDE = DP + 1;
};
template <int DP> struct Pad<__nv_bfloat16, DP> {
  static constexpr int STRIDE = DP + 2;
};

template <typename T, int DP>
constexpr size_t smem_bytes() {
  return (2 * BQ * Pad<T, DP>::STRIDE + BK * DP) * sizeof(T) +
         BQ * P_STRIDE * sizeof(float);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copies rows [row0, row0 + 64) of one (b, h) slice into a shared tile of
// row stride dst_stride, 4-byte words at a time (coalesced along D); rows
// at or past S and, when RAGGED, the words of columns at or past D
// (row_words words of a row are data, DP's are kept) are zero-filled.
template <typename T, int DP, bool RAGGED>
__device__ __forceinline__ void load_tile(T* dst, int dst_stride,
                                          const T* src, int64_t stride_s,
                                          int row0, int S, int row_words) {
  constexpr int WORDS = DP * static_cast<int>(sizeof(T)) / 4;
  const int dst_words = dst_stride * static_cast<int>(sizeof(T)) / 4;
  uint32_t* d = reinterpret_cast<uint32_t*>(dst);
  for (int e = threadIdx.x; e < 64 * WORDS; e += THREADS) {
    const int r = e / WORDS, c = e % WORDS;
    const int s = row0 + r;
    uint32_t w = 0u;
    if (s < S && (!RAGGED || c < row_words))
      w = reinterpret_cast<const uint32_t*>(src + s * stride_s)[c];
    d[r * dst_words + c] = w;
  }
}

template <typename T, int DP, bool RAGGED>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int Sq,
             int Sk, int D, int64_t q_sb, int64_t q_sh, int64_t q_ss,
             int64_t k_sb, int64_t k_sh, int64_t k_ss, int64_t ob, int64_t oh,
             int64_t os, int causal, int window, float scale_log2) {
  constexpr int QK = Pad<T, DP>::STRIDE;
  constexpr int DN = DP / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* sK = sQ + BQ * QK;
  T* sV = sK + BK * QK;
  float* sP = reinterpret_cast<float*>(sV + BK * DP);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * k_sb + h * k_sh;
  T* obase = o + b * ob + h * oh;
  const int row_words = D * static_cast<int>(sizeof(T)) / 4;

  load_tile<T, DP, RAGGED>(sQ, QK, qb, q_ss, q0, Sq, row_words);

  float acc[4][DN], mrow[4], lrow[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    mrow[m] = -INFINITY;
    lrow[m] = 0.f;
#pragma unroll
    for (int j = 0; j < DN; ++j) acc[m][j] = 0.f;
  }

  // key tiles some (q, k) pair of this block can reach
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q0 + BQ);
  if (window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's reads of sK, sV, sP are done
    load_tile<T, DP, RAGGED>(sK, QK, kb, k_ss, k0, Sk, row_words);
    load_tile<T, DP, RAGGED>(sV, DP, vb, k_ss, k0, Sk, row_words);
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) sc[m][n] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) a[m] = to_f32(sQ[(ty + 16 * m) * QK + d]);
#pragma unroll
      for (int n = 0; n < 4; ++n) bk[n] = to_f32(sK[(tx + 16 * n) * QK + d]);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 4; ++n) sc[m][n] = fmaf(a[m], bk[n], sc[m][n]);
    }

#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int qpos = q0 + ty + 16 * m;
      float rmax = -INFINITY;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int kpos = k0 + tx + 16 * n;
        bool ok = kpos < Sk;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        sc[m][n] = ok ? sc[m][n] * scale_log2 : -INFINITY;
        rmax = fmaxf(rmax, sc[m][n]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
      const float m_new = fmaxf(mrow[m], rmax);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(mrow[m] - m_use);
      float rsum = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const float p = exp2f(sc[m][n] - m_use);
        sP[(ty + 16 * m) * P_STRIDE + tx + 16 * n] = p;
        rsum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, off);
      lrow[m] = lrow[m] * alpha + rsum;
      mrow[m] = m_new;
#pragma unroll
      for (int j = 0; j < DN; ++j) acc[m][j] *= alpha;
    }
    __syncthreads();  // sP holds the whole 64 x 64 tile

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float p[4], vv[DN];
#pragma unroll
      for (int m = 0; m < 4; ++m) p[m] = sP[(ty + 16 * m) * P_STRIDE + j];
#pragma unroll
      for (int jn = 0; jn < DN; ++jn)
        vv[jn] = to_f32(sV[j * DP + tx + 16 * jn]);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int jn = 0; jn < DN; ++jn)
          acc[m][jn] = fmaf(p[m], vv[jn], acc[m][jn]);
    }
  }

#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int qpos = q0 + ty + 16 * m;
    if (qpos >= Sq) continue;
    const float inv = 1.f / fmaxf(lrow[m], 1e-20f);
#pragma unroll
    for (int jn = 0; jn < DN; ++jn)
      if (!RAGGED || tx + 16 * jn < D)
        store(obase + qpos * os + tx + 16 * jn, acc[m][jn] * inv);
  }
}

template <typename T, int DP, bool RAGGED>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int H, int Sq, int Sk, int D, int64_t qb, int64_t qh, int64_t qs,
           int64_t kb, int64_t kh, int64_t ks, int64_t ob, int64_t oh,
           int64_t os, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP>();
  auto kern = flash_kernel<T, DP, RAGGED>;
  // raise the dynamic shared-memory limit once per device, outside any
  // CUDA-graph capture (the first launch on a device is never captured:
  // capture follows a warm-up call)
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const dim3 grid(static_cast<unsigned>((Sq + BQ - 1) / BQ),
                  static_cast<unsigned>(BH));
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, Sq, Sk, D, qb, qh, qs,
      kb, kh, ks, ob, oh, os, causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of width DP: RAGGED (the column masks) only where D
// falls short of DP.
template <typename T, int DP>
int launch_dp(int D, const void* q, const void* k, const void* v, void* o,
              int BH, int H, int Sq, int Sk, int64_t qb, int64_t qh,
              int64_t qs, int64_t kb, int64_t kh, int64_t ks, int64_t ob,
              int64_t oh, int64_t os, int causal, int window,
              cudaStream_t s) {
  if (D == DP)
    return launch<T, DP, false>(q, k, v, o, BH, H, Sq, Sk, D, qb, qh, qs, kb,
                                kh, ks, ob, oh, os, causal, window, s);
  return launch<T, DP, true>(q, k, v, o, BH, H, Sq, Sk, D, qb, qh, qs, kb,
                             kh, ks, ob, oh, os, causal, window, s);
}

// D: any width in [1, 128] whose rows are whole 4-byte words, run at the
// next instantiated width DP in {32, 64, 128}.
template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             int BH, int H, int Sq, int Sk, int64_t qb, int64_t qh,
             int64_t qs, int64_t kb, int64_t kh, int64_t ks, int64_t ob,
             int64_t oh, int64_t os, int causal, int window,
             cudaStream_t s) {
  if (D < 1 || D > 128 || D * static_cast<int>(sizeof(T)) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32)
    return launch_dp<T, 32>(D, q, k, v, o, BH, H, Sq, Sk, qb, qh, qs, kb, kh,
                            ks, ob, oh, os, causal, window, s);
  if (D <= 64)
    return launch_dp<T, 64>(D, q, k, v, o, BH, H, Sq, Sk, qb, qh, qs, kb, kh,
                            ks, ob, oh, os, causal, window, s);
  return launch_dp<T, 128>(D, q, k, v, o, BH, H, Sq, Sk, qb, qh, qs, kb, kh,
                           ks, ob, oh, os, causal, window, s);
}

}  // namespace flash

// q has the element strides (qb, qh, qs) of its [B, H, Sq, D] view, k and
// v share (kb, kh, ks) of their [B, H, Sk, D] views, o has (ob, oh, os);
// D is contiguous in all four.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int BH, int H,
    int Sq, int Sk, int D, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long ob, long long oh,
    long long os, int causal, int window, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gossip::kF32:
      return flash::launch_d<float>(D, q, k, v, o, BH, H, Sq, Sk, qb, qh, qs,
                                    kb, kh, ks, ob, oh, os, causal, window,
                                    s);
    case gossip::kBF16:
      return flash::launch_d<__nv_bfloat16>(D, q, k, v, o, BH, H, Sq, Sk, qb,
                                            qh, qs, kb, kh, ks, ob, oh, os,
                                            causal, window, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
