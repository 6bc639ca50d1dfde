// flash_attention_tc — bf16 attention forward on Hopper's tensor cores
// (sm_90a), with TMA loads, wgmma products and warp specialisation.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py,
// flash_attention_pallas, for bf16 q, k, v at D in {64, 128}: attention of
// q [B, H, Sq, D] over k, v [B, H, Sk, D] (addressed through strides, q's
// and k's own, so the model's [B, S, H, D] tensors are read in place),
// scale 1/sqrt(D), causal and sliding-window masks (at Sk = Sq only: the
// wrapper refuses them otherwise, so Sk != Sq is the unmasked
// cross-attention), key tiles no query of the block can reach skipped;
// running max m, sum l and the output accumulator in fp32; out = acc /
// max(l, 1e-20) in bf16. f32 inputs and every other D stay on the SIMT
// kernel (flash_attention.cu).
//
// Bound on an H100 SXM: q, k, v read and out written once (2*B*H*(Sq +
// Sk)*D*2 bytes at 3.35 TB/s) against 4*D flops per visible (q, k) pair
// at the bf16 tensor-core peak of 989 TFLOP/s. DeepSeekMoE-16B's prefill
// at B=4, S=512 ([64, 512, 128]) is bytes-bound (10.0 us); at B=1, S=4096
// ([16, 4096, 128]) it is operations-bound (69.5 us). Only wgmma reaches
// the tensor cores' rate, so both products run on it, and loads overlap
// compute through a ring of shared-memory stages.
//
// Design.
// - One CTA per (128-query tile, b, h), 384 threads: warpgroups 0 and 1
//   are consumers, 64 query rows each; warpgroup 2 is the producer, whose
//   first thread issues every TMA load. The producer lowers its registers
//   to 24 (setmaxnreg), the consumers raise theirs to 240. Tiles are
//   numbered longest first: blockIdx.x 0 is the last (longest) causal
//   query tile of every (b, h), so the uneven causal work spreads over the
//   132 SMs.
// - Shared memory: Q [128 x D], and STAGES stages of a K and a V tile of
//   [128 keys x D], all bf16 in TMA's 128-byte swizzle, every tile
//   1024-byte aligned. A row of D = 128 is two 64-column boxes (a swizzled
//   box is at most 128 bytes wide), stored one after the other. D = 128:
//   2 stages, 160 KB; D = 64: 4 stages, 144 KB (a tile is half as long to
//   compute, so more loads are kept in flight). One CTA per SM, opted in
//   with cudaFuncSetAttribute once per device.
// - Loads: each of q, k, v has a 4-D tensor map {D, S, H, B}, innermost
//   first, with the tensor's own byte strides (q's from Sq, k's and v's
//   from Sk), so a [B, S, H, D] tensor's transposed view and a contiguous
//   [B, H, S, D] tensor are read in place. TMA zero-fills rows at or past
//   the map's S inside each (b, h) slice, so a ragged length needs no
//   padding; scores of keys at or past Sk are masked all the same. Query
//   tiles are counted by Sq, key tiles by Sk. Barriers: Q full; per
//   stage K full, V full (TMA transaction counts) and empty (256
//   consumer arrivals).
// - S = Q.K^T: wgmma m64n128k16, A = Q and B = K from shared memory, both
//   K-major (D contiguous). O += P.V: wgmma m64nDk16 with A = P in
//   registers (the fp32 score accumulator's layout is the A fragment's
//   layout, so P is packed to bf16 pairs in place) and B = V, MN-major (D
//   contiguous, transpose bit set). Both accumulate in fp32 registers.
// - Online softmax in registers in the exp2 domain (1/sqrt(D) * log2(e)
//   folded in). Only tiles that hold an invisible (q, k) pair for some row
//   of the warpgroup (the diagonal, the window edge, the ragged end) are
//   masked elementwise. A fully masked row keeps m = -inf with alpha = p =
//   0. l is summed from the fp32 p, per thread, and reduced over the four
//   threads of a row once at the end.
// - The output is written once per element from registers, bf16 pairs,
//   into q's layout; rows at or past Sq are never written.
//
// Numerics: P enters the second product as bf16 (as in every flash kernel
// and in SDPA), which the SIMT kernel does not do. The limit against the
// plain version, per element, is
//   |got - want| <= |want| * 2^-6 + 2^-8 * (P.|v|) + 1e-5,
// with P.|v| = sum_k p_k |v_k| / l (the plain version applied to |v|).
// bf16 keeps 8 significant bits, so rounding p moves each term p_k v_k by
// at most 2^-8 relative: 2^-8 * P.|v| in all. l is summed from the fp32 p
// here as in the plain version, so it adds no rounding. got and want are
// each rounded once to bf16, half an ulp each (ulp(x) <= |x| * 2^-7):
// together at most |want| * 2^-7, which 2^-6 covers twice over, with the
// fp32 summation order (~1e-6 relative) and the 1e-5 near zero.

// cuTensorMapEncodeTiled (libcuda) is looked up through the runtime with
// cudaGetDriverEntryPoint, so the library needs no -lcuda.
#include <cuda.h>  // CUtensorMap and its enums; no libcuda link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash_tc {

using bf16 = __nv_bfloat16;

constexpr int BQ = 128;          // query rows per CTA
constexpr int BK = 128;          // keys per tile
constexpr int CONSUMERS = 2;     // consumer warpgroups of 64 query rows
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int ROW_BYTES = 128;   // one swizzled box row: 64 bf16
constexpr int kMaxDevices = 64;
// returned when the tensor map cannot be encoded: 10000 + the CUresult
// (or + 999 when the driver entry point is missing)
constexpr int kEncodeError = 10000;

template <int D>
struct Cfg {
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int BOXES = D / 64;  // 64-column boxes per row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  static constexpr int BARS = 1 + 3 * STAGES;  // q, full_k, full_v, empty
  static constexpr int SMEM = OFF_BAR + BARS * 8 + 1024;  // + base alignment
};

// ---------------------------------------------------------------------------
// PTX wrappers: mbarriers, TMA, wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Waits until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 4-D tensor map into shared memory at dst, completing on bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Orders reads and writes of accumulator registers against the async
// wgmma instructions (the compiler sees no dependency through the wait).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_D8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define FA_D32(i) FA_D8(i), FA_D8(i + 8), FA_D8(i + 16), FA_D8(i + 24)
#define FA_R32                                                            \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define FA_R64                                                             \
  FA_R32                                                                   \
  ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, " \
  "%46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "  \
  "%60, %61, %62, %63"

// d[64] (+)= A[64 x 16] . B[16 x 128]^T, A and B K-major in shared memory.
__device__ __forceinline__ void mma_ss_n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FA_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : FA_D32(0), FA_D32(32)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64] += A[64 x 16] (registers) . B[16 x 128], B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[64], const uint32_t* a,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" FA_R64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : FA_D32(0), FA_D32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[32] += A[64 x 16] (registers) . B[16 x 64], B MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t* a,
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" FA_R32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FA_D32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x (ex2.approx: relative error ~2^-22; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// Accumulator layout of wgmma m64nN (fp32), thread (warp w, lane = 4g + t)
// of the warpgroup: element i is row 16w + g + 8*((i >> 1) & 1), column
// 8*(i >> 2) + 2t + (i & 1).
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ o, int H, int Sq, int Sk, int n_qt,
                    int BH, int64_t ob, int64_t oh, int64_t os, int causal,
                    int window, float scale_log2) {
  using C = Cfg<D>;
  constexpr int ST = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + C::OFF_K, sV = base + C::OFF_V;
  const uint32_t q_full = base + C::OFF_BAR;
  auto full_k = [&](int s) { return q_full + 8u * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8u * (1 + ST + s); };
  auto empty = [&](int s) { return q_full + 8u * (1 + 2 * ST + s); };

  // longest first: the last query tile of every (b, h) comes first
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.x / BH);
  const int bh = static_cast<int>(blockIdx.x % BH);
  const int b = bh / H, h = bh % H;
  const int q0 = qt * BQ;
  // key tiles some (q, k) pair of this CTA can reach
  int k_begin = 0, k_end = Sk;
  if (causal) k_end = min(Sk, q0 + BQ);
  if (window > 0) k_begin = max(0, q0 - window + 1) / BK * BK;
  const int n_k = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty(s), CONSUMERS * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---------------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == CONSUMERS * 128) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < C::BOXES; ++c)
        tma_load(sQ + c * BQ * ROW_BYTES, &tq, q_full, 64 * c, q0, h, b);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % ST;
        mbar_wait(empty(s), ((i / ST) & 1) ^ 1);
        const int k0 = k_begin + i * BK;
        const uint32_t off = s * C::KV_BYTES;
        mbar_expect_tx(full_k(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::BOXES; ++c)
          tma_load(sK + off + c * BK * ROW_BYTES, &tk, full_k(s), 64 * c, k0,
                   h, b);
        mbar_expect_tx(full_v(s), C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < C::BOXES; ++c)
          tma_load(sV + off + c * BK * ROW_BYTES, &tv, full_v(s), 64 * c, k0,
                   h, b);
      }
    }
  } else {
    // --------------------------------------------------------------- consumer
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, w = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int qa = q0 + 64 * wg, qb = qa + 63;  // this warpgroup's rows
    const int row0 = qa + 16 * w + g;           // and row0 + 8

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    mbar_wait(q_full, 0);
    for (int i = 0; i < n_k; ++i) {
      const int s = i % ST;
      const uint32_t ph = (i / ST) & 1;
      const int k0 = k_begin + i * BK;
      const uint32_t off = s * C::KV_BYTES;

      // S = Q . K^T over D in steps of 16 (32 bytes inside a 128-byte row)
      float sc[64];
      mbar_wait(full_k(s), ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // box kk / 4
        const uint64_t da = sw128_desc(
            sQ + (kk / 4) * BQ * ROW_BYTES + wg * 64 * ROW_BYTES + col, 16,
            1024);
        const uint64_t db =
            sw128_desc(sK + off + (kk / 4) * BK * ROW_BYTES + col, 16, 1024);
        mma_ss_n128(sc, da, db, kk > 0);
      }
      wg_commit();
      wg_wait0();
      reg_fence(sc);

      const bool need_mask = (causal && k0 + BK - 1 > qa) ||
                             (window > 0 && k0 <= qb - window) ||
                             k0 + BK > Sk;
      if (need_mask) {
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const int kpos = k0 + 8 * (e >> 2) + 2 * t + (e & 1);
          const int qpos = row0 + 8 * ((e >> 1) & 1);
          bool ok = kpos < Sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window > 0) ok = ok && kpos > qpos - window;
          if (!ok) sc[e] = -INFINITY;
        }
      }

      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int e = 0; e < 64; ++e)
        mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
      float m_use[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = fast_exp2(m[r] - m_use[r]);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t pa[32];  // P in bf16 pairs: the A fragments of P . V
#pragma unroll
      for (int e = 0; e < 64; e += 2) {
        const int r = (e >> 1) & 1;
        const float p0 = fast_exp2(fmaf(sc[e], scale_log2, -m_use[r]));
        const float p1 = fast_exp2(fmaf(sc[e + 1], scale_log2, -m_use[r]));
        l[r] += p0 + p1;
        pa[e / 2] = pack_bf16(p0, p1);
      }
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];

      // O += P . V over the tile's keys in steps of 16 (two 8-row groups)
      mbar_wait(full_v(s), ph);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = sw128_desc(sV + off + kk * 16 * ROW_BYTES,
                                       BK * ROW_BYTES, 1024);
        mma_rs(acc, pa + 4 * kk, db);
      }
      wg_commit();
      wg_wait0();
      reg_fence(acc);
      mbar_arrive(empty(s));
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / fmaxf(l[r], 1e-20f);
    }
    bf16* obase = o + b * ob + h * oh;
#pragma unroll
    for (int e = 0; e < D / 2; e += 2) {
      const int r = (e >> 1) & 1;
      const int qpos = row0 + 8 * r;
      if (qpos < Sq)
        *reinterpret_cast<__nv_bfloat162*>(obase + qpos * os + 8 * (e >> 2) +
                                           2 * t) =
            __floats2bfloat162_rn(acc[e] * inv[r], acc[e + 1] * inv[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A {D, S, H, B} map of bf16 with element strides (ss, sh, sb), boxes of
// 64 columns x 128 rows, 128-byte swizzle, zero fill out of bounds.
int make_map(CUtensorMap* map, const void* ptr, int B, int H, int S, int D,
             int64_t sb, int64_t sh, int64_t ss) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kEncodeError + 999;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, BK, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeError + static_cast<int>(res);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int Sq, int Sk, int64_t qb, int64_t qh, int64_t qs,
           int64_t kb, int64_t kh, int64_t ks, int64_t ob, int64_t oh,
           int64_t os, int causal, int window, cudaStream_t stream) {
  auto kern = flash_tc_kernel<D>;
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
                               Cfg<D>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  CUtensorMap tq, tk, tv;
  int rc = make_map(&tq, q, B, H, Sq, D, qb, qh, qs);
  if (rc == 0) rc = make_map(&tk, k, B, H, Sk, D, kb, kh, ks);
  if (rc == 0) rc = make_map(&tv, v, B, H, Sk, D, kb, kh, ks);
  if (rc != 0) return rc;
  const float scale_log2 = 1.4426950408889634f / sqrtf(static_cast<float>(D));
  const int n_qt = (Sq + BQ - 1) / BQ;
  const unsigned grid = static_cast<unsigned>(n_qt) * B * H;
  kern<<<grid, THREADS, Cfg<D>::SMEM, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), H, Sq, Sk, n_qt, B * H, ob, oh, os,
      causal, window, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace flash_tc

// bf16 q [B, H, Sq, D] has the element strides (qb, qh, qs), k and v [B,
// H, Sk, D] share (kb, kh, ks) (each a multiple of 8, i.e. 16 bytes, as
// TMA needs; base addresses 16-byte aligned); o has (ob, oh, os); D in
// {64, 128}, contiguous in all four. Returns 0, a cudaError_t, or 10000 +
// a CUresult of the tensor-map encode.
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Sq, int Sk, int D, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long ob, long long oh,
    long long os, int causal, int window, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return flash_tc::launch<64>(q, k, v, o, B, H, Sq, Sk, qb, qh, qs, kb, kh,
                                  ks, ob, oh, os, causal, window, s);
    case 128:
      return flash_tc::launch<128>(q, k, v, o, B, H, Sq, Sk, qb, qh, qs, kb,
                                   kh, ks, ob, oh, os, causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
