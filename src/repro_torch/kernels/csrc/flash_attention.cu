// flash_attention — online-softmax attention on Hopper's tensor cores
// (sm_90a) through mma.sync: 3xTF32 for f32 inputs, bf16 products for bf16.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:87,
// flash_attention_pallas: q [B*H, Sq, D] and k, v [B*H, Sk, D] (here
// addressed as [B, H, S, D] through strides, q's and k's own), f32 or
// bf16, out in q's type; scale 1/sqrt(D); causal and sliding-window masks
// (only at Sk = Sq: the wrapper refuses them otherwise, so Sk != Sq is the
// unmasked cross-attention); kv tiles no query of the tile can reach are
// skipped; running max m, sum l and the accumulator in fp32; the output is
// acc / max(l, 1e-20). Any D <= 128 whose rows are whole 4-byte words (any
// D in f32, an even D in bf16), masked in the kernel, never padded in
// device memory. bf16 at D in {64, 128} goes to flash_attention_tc.cu.
//
// Bound on an H100 SXM: 2*B*H*(Sq + Sk)*D*sizeof(T) bytes over 3.35 TB/s
// against 4*D flops per visible (q, k) pair. This kernel runs the products
// of f32 inputs as three TF32 products each (495/3 TFLOP/s) and those of
// bf16 inputs at the bf16 rate with P.V twice (p in two parts, below), so
// its own floor is max(bytes, 3 * flops / 495 TFLOP/s) in f32 and max(bytes,
// 1.5 * flops / 989 TFLOP/s) in bf16. At [64, 512, 128] bf16 causal the
// bytes bound (10.02 us); at f32 [1, 4, 512, 64] causal the operations
// (0.82 us in 3xTF32; 2.01 us at the fp32 CUDA-core rate); at Kimi-K2's
// [1, 64, 4096, 112] bf16 causal the operations (243 us at 989 TFLOP/s,
// 365 us with P.V twice).
//
// Numerics, held to the plain version's fp32 result (chip_smoke.py's
// flash_err): f32 5e-5 absolute; bf16 one ulp of each element + 1e-5.
// - f32 inputs: every product is 3xTF32, as in ssd_chunk_tc.cu and the
//   dense gossip mix (common.cuh's split: hi rounded as cvt.rna rounds,
//   lo = x - hi exactly, read by the tensor cores truncated to TF32; the
//   three products lo.hi' + hi.lo' + hi.hi' summed in fp32, the small
//   terms first or apart). About 2^-20 relative per product, against
//   2^-11 for one TF32 product, which breaks 5e-5.
// - bf16 inputs: q, k and v are exact in bf16, so S = Q.K^T is one bf16
//   product with fp32 accumulation. p is not: P.V takes p = hi + lo, hi =
//   bf16(p), lo = bf16(p - hi) (p to ~2^-17), two products, lo first.
//   Rounding p to bf16 once (as flash_attention_tc.cu does) moves an
//   output by up to 2^-9 * P.|v|, far past one ulp where the terms cancel.
//
// Design, against what held the first (CUDA-core) version back:
// - Tensor cores. 4 warps, each owning 16 query rows of a 64-row tile.
//   f32: mma.m16n8k8 TF32; the k-slots of each 8-wide step are permuted
//   (slot t is column 2t, slot t + 4 column 2t + 1), so every A and B
//   fragment pair of Q.K^T is one 8-byte shared-memory load; the score
//   accumulator (keys 2t, 2t + 1 of rows g, g + 8) is then P.V's A
//   fragment as it stands, with V's rows read in the same permuted key
//   order; Q's raw values stay in registers for the whole key range,
//   split anew at each use; the small products of Q.K^T go to
//   accumulators of their own, so no chain of dependent products is
//   longer than 2 D / 8. bf16: mma.m16n8k16; Q's and K's fragments with
//   ldmatrix, V's with ldmatrix.trans; each p is packed into its hi and lo
//   A fragments in place. (Warps of 32 rows, each K and V fragment serving
//   two m-tiles, were 4 % faster at D >= 112 but spilled there, at 255
//   registers: benchmarks/flash_simt_probe.py.)
// - S, P, the running max and sum and O stay in registers: no P round
//   trip through shared memory and no barrier for it. The row max is two
//   shuffles within a quad; l is summed per thread and reduced once.
// - K and V in a ring of three shared-memory stages (two in f32 at D >=
//   112, where three would leave one CTA an SM), 32 keys a tile, filled by
//   cp.async: 16-byte copies where the rows and D * sizeof(T) allow, else
//   8 or 4 (f32 D = 42 rows are 168 bytes). Two tiles are in flight while
//   one is multiplied; one barrier per tile. The copy loop is not unrolled
//   (an unrolled one held the next tile's addresses in registers across
//   the products and spilled). Rows past S and columns past D are
//   zero-filled through the copy's source size. Row strides are padded so
//   every fragment load and ldmatrix is free of bank conflicts.
// - The grid fills the 132 SMs: where B*H*ceil(Sq/64) CTAs fill fewer
//   than half of them the wrapper asks for `splits` > 1 (as many as bring
//   the CTAs to two an SM, each part >= 64 keys, at most 16; above half,
//   the second pass costs more than it saves): CTA z of a query tile
//   takes the z-th of `splits` equal parts of the tile's visible key tiles
//   and writes its unnormalised O and its (m, l) into scratch the wrapper
//   allocates; a second kernel, launched by the same C entry, merges the
//   parts (a part that saw no key writes m = -inf and is skipped). Query
//   tiles are numbered longest first (causal), so the uneven causal work
//   spreads over the SMs.
// - Masks only where a tile needs them (the diagonal, the window edge,
//   the ragged end), per warp; a warp whose rows see none of a tile, or
//   lie past Sq, skips it. Fully masked scores are -inf; a row that has
//   seen no key keeps m = -inf with alpha = p = 0.
// - Instantiated at DP in {32, 64, 96, 112, 128}, the smallest at or above
//   D; columns D..DP-1 are zero-filled and never stored. No instantiation
//   spills (chip_smoke.py [1] fails on a spill).
//
// What holds it now (PERF.md, benchmarks/flash_simt_probe.py): at the
// long bf16 shapes the loads (a third of the time at Kimi-K2's shape:
// every 64-row CTA streams its key range through the SM's load path) and
// P.V's second product; at the f32 main paths' short shapes one warp an
// SP's latency and a fixed ~5 us of launch, Q load, stores and merge.
#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace flash {

using gossip::cp_commit;
using gossip::mma_tf32;
using gossip::smem_u32;
using gossip::split;

constexpr int BQ = 64, BK = 32, WARPS = 4, THREADS = 32 * WARPS;
constexpr int MERGE_THREADS = 256;
constexpr int kMaxDevices = 64;

// Per type and instantiated width DP: KS and VS, the row strides
// (elements) of the shared Q and K tiles and of the V tile; CTAS, the CTAs
// an SM holds (the registers' bound); STAGES, the ring's depth. f32 KS = 8
// (mod 32) words, so the 16 lanes of a half-warp's 8-byte loads hit 32
// banks; f32 VS = 4 (mod 32), so a warp's four-byte V loads at keys 2t,
// rows apart, do too; bf16 rows of DP + 8 are an odd number of 16-byte
// segments, so each of ldmatrix's eight-row phases does.
template <typename T, int DP> struct Cfg;
template <int DP> struct Cfg<float, DP> {
  static constexpr int KS = DP + 8, VS = DP + 4;
  static constexpr int CTAS = DP <= 64 ? 3 : 2, STAGES = DP <= 96 ? 3 : 2;
};
template <int DP> struct Cfg<__nv_bfloat16, DP> {
  static constexpr int KS = DP + 8, VS = DP + 8, CTAS = 3, STAGES = 3;
};

// the Q tile, then the ring's stages of a K and a V tile
template <typename T, int DP>
constexpr size_t smem_bytes() {
  using C = Cfg<T, DP>;
  return sizeof(T) * (BQ * C::KS + C::STAGES * BK * (C::KS + C::VS));
}

// One launch's arguments: element strides of q's and k's (b, h, s) (v
// shares k's) and out's; `part` the split scratch (null when splits = 1):
// splits x rows x D floats of O, then splits x rows x (m, l), rows =
// B*H*Sq; cb the bytes of each asynchronous copy (16, 8 or 4).
struct Params {
  const void *q, *k, *v;
  void* o;
  float* part;
  int H, Sq, Sk, D;
  int64_t qb, qh, qs, kb, kh, ks, ob, oh, os;
  int causal, window, splits, cb;
  float scale_log2;
};

// CB bytes (16, 8 or 4) from global to shared memory, zero-filled when
// !valid (src is then not read, but must be a valid address)
template <int CB>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  const int n = valid ? CB : 0;
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
                 "l"(src), "n"(CB), "r"(n)
                 : "memory");
}

// Rows [row0, row0 + ROWS) of one (b, h) slice into a shared tile of row
// stride STRIDE elements and DP columns, in copies of CB bytes (a copy's
// row and column are divisions by a constant; the loop is not unrolled,
// so no copy's address is held in registers across the products); rows at
// or past S and the copies past D (row_bytes) are zero-filled.
template <typename T, int ROWS, int DP, int STRIDE, int CB>
__device__ __forceinline__ void load_rows(T* dst, const T* src,
                                          int64_t stride_s, int row0, int S,
                                          int row_bytes) {
  constexpr int PER_ROW = DP * static_cast<int>(sizeof(T)) / CB;
  constexpr int TOTAL = ROWS * PER_ROW;
  const uint32_t base = smem_u32(dst);
  const int64_t step = stride_s * static_cast<int64_t>(sizeof(T));
  const char* s0 = reinterpret_cast<const char*>(src);
  const char* first = s0 + row0 * step;
#pragma unroll 1
  for (int e = static_cast<int>(threadIdx.x); e < TOTAL; e += THREADS) {
    const int r = e / PER_ROW, c = e % PER_ROW;
    const bool valid = row0 + r < S && c * CB < row_bytes;
    cp_async<CB>(base + r * STRIDE * static_cast<int>(sizeof(T)) + c * CB,
                 valid ? first + r * step + c * CB : s0, valid);
  }
}
// the same with the copy width cb (16, 8 or 4; one value for the launch)
template <typename T, int ROWS, int DP, int STRIDE>
__device__ __forceinline__ void load_tile(T* dst, const T* src,
                                          int64_t stride_s, int row0, int S,
                                          int row_bytes, int cb) {
  if (cb == 16)
    load_rows<T, ROWS, DP, STRIDE, 16>(dst, src, stride_s, row0, S,
                                       row_bytes);
  else if (cb == 8)
    load_rows<T, ROWS, DP, STRIDE, 8>(dst, src, stride_s, row0, S,
                                      row_bytes);
  else
    load_rows<T, ROWS, DP, STRIDE, 4>(dst, src, stride_s, row0, S,
                                      row_bytes);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
               "[%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, "
               "%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a . b, mma.m16n8k16 bf16 with fp32 accumulate (lane = 4 g + t: a0
// (g, 2t..2t+1), a1 (g + 8, 2t..), a2 (g, 2t+8..), a3 (g + 8, 2t+8..);
// b0 (k 2t..2t+1, n g), b1 (k 2t+8.., n g); d as in mma_tf32)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as hi = bf16 pair rounded to nearest and lo = the bf16 pair of
// what hi leaves, x in the low half (the smaller column)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Query fragments: f32 keeps the raw values {Q[g][8s+2t], Q[g][8s+2t+1],
// Q[g+8][8s+2t], Q[g+8][8s+2t+1]} of each 8-column step s in registers for
// the whole key range (split anew at each use); bf16 reads its A
// fragments from the shared Q tile with ldmatrix at each key tile.
template <typename T, int DP> struct QFrag;
template <int DP> struct QFrag<float, DP> {
  float x[DP / 8][4];
  __device__ __forceinline__ void load(const float* sQ, int row, int lane) {
    constexpr int KS = Cfg<float, DP>::KS;
    const int g = lane / 4, t = lane % 4;
#pragma unroll
    for (int s = 0; s < DP / 8; ++s) {
      const float2 a = *reinterpret_cast<const float2*>(
          sQ + (row + g) * KS + 8 * s + 2 * t);
      const float2 b = *reinterpret_cast<const float2*>(
          sQ + (row + g + 8) * KS + 8 * s + 2 * t);
      x[s][0] = a.x, x[s][1] = a.y, x[s][2] = b.x, x[s][3] = b.y;
    }
  }
};
template <int DP> struct QFrag<__nv_bfloat16, DP> {
  uint32_t addr;  // this lane's ldmatrix row at column step 0
  __device__ __forceinline__ void load(const __nv_bfloat16* sQ, int row,
                                       int lane) {
    constexpr int KS = Cfg<__nv_bfloat16, DP>::KS;
    const int i = lane / 8;  // ldmatrix's matrix i: a_i
    addr = smem_u32(sQ + (row + lane % 8 + (i & 1) * 8) * KS + (i >> 1) * 8);
  }
};

// S = Q.K^T for the warp's 16 rows against the tile's BK keys: s[n] holds
// keys 8n + 2t, 8n + 2t + 1 of rows g (s[n][0..1]) and g + 8 (s[n][2..3]).
// f32: the small products go to accumulators of their own, added at the
// end, so no chain of dependent products is longer than 2 D / 8.
template <int DP>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4],
                                       const QFrag<float, DP>& qf,
                                       const float* sK, int lane) {
  constexpr int KS = Cfg<float, DP>::KS;
  const int g = lane / 4, t = lane % 4;
  float sl[BK / 8][4];
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sl[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 8; ++ks) {
    // k-slot t is column 8ks + 2t, slot t + 4 column 8ks + 2t + 1
    uint32_t ah[4], al[4];
    split(qf.x[ks][0], ah[0], al[0]);
    split(qf.x[ks][2], ah[1], al[1]);
    split(qf.x[ks][1], ah[2], al[2]);
    split(qf.x[ks][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const float2 kv = *reinterpret_cast<const float2*>(
          sK + (8 * n + g) * KS + 8 * ks + 2 * t);
      uint32_t bh[2], bl[2];
      split(kv.x, bh[0], bl[0]);
      split(kv.y, bh[1], bl[1]);
      mma_tf32(sl[n], al, bh);
      mma_tf32(sl[n], ah, bl);
      mma_tf32(s[n], ah, bh);
    }
  }
#pragma unroll
  for (int n = 0; n < BK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] += sl[n][e];
}
template <int DP>
__device__ __forceinline__ void scores(float (&s)[BK / 8][4],
                                       const QFrag<__nv_bfloat16, DP>& qf,
                                       const __nv_bfloat16* sK, int lane) {
  constexpr int KS = Cfg<__nv_bfloat16, DP>::KS;
  const int i = lane / 8;  // matrices: b0, b1 of key block 2m, then 2m + 1
  const uint32_t kp = smem_u32(sK + (lane % 8 + (i >> 1) * 8) * KS +
                               (i & 1) * 8);
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    uint32_t qa[4];
    ldsm_x4(qa, qf.addr + 2 * 16 * ks);
#pragma unroll
    for (int m = 0; m < BK / 16; ++m) {
      uint32_t kb[4];
      ldsm_x4(kb, kp + 2 * (16 * m * KS + 16 * ks));
      mma_bf16(s[2 * m], qa, kb[0], kb[1]);
      mma_bf16(s[2 * m + 1], qa, kb[2], kb[3]);
    }
  }
}

// O += P.V with P the warp's probabilities in the score layout.
template <int DP>
__device__ __forceinline__ void accumulate(float (&o)[DP / 8][4],
                                           float (&p)[BK / 8][4],
                                           const float* sV, int lane) {
  constexpr int VS = Cfg<float, DP>::VS;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    // k-slot t is key 8j + 2t, slot t + 4 key 8j + 2t + 1: the score
    // accumulator is the A fragment as it stands
    uint32_t ah[4], al[4];
    split(p[j][0], ah[0], al[0]);
    split(p[j][2], ah[1], al[1]);
    split(p[j][1], ah[2], al[2]);
    split(p[j][3], ah[3], al[3]);
    const float* v0 = sV + (8 * j + 2 * t) * VS + g;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      uint32_t bh[2], bl[2];
      split(v0[8 * n], bh[0], bl[0]);
      split(v0[VS + 8 * n], bh[1], bl[1]);
      mma_tf32(o[n], al, bh);
      mma_tf32(o[n], ah, bl);
      mma_tf32(o[n], ah, bh);
    }
  }
}
template <int DP>
__device__ __forceinline__ void accumulate(float (&o)[DP / 8][4],
                                           float (&p)[BK / 8][4],
                                           const __nv_bfloat16* sV,
                                           int lane) {
  constexpr int VS = Cfg<__nv_bfloat16, DP>::VS;
  const int i = lane / 8;  // matrices: b0, b1 of column block 2n, 2n + 1
  const uint32_t vp = smem_u32(sV + (lane % 8 + (i & 1) * 8) * VS +
                               (i >> 1) * 8);
#pragma unroll
  for (int j = 0; j < BK / 16; ++j) {
    uint32_t ah[4], al[4];
    split_bf16(p[2 * j][0], p[2 * j][1], ah[0], al[0]);
    split_bf16(p[2 * j][2], p[2 * j][3], ah[1], al[1]);
    split_bf16(p[2 * j + 1][0], p[2 * j + 1][1], ah[2], al[2]);
    split_bf16(p[2 * j + 1][2], p[2 * j + 1][3], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < DP / 16; ++n) {
      uint32_t vb[4];
      ldsm_x4_t(vb, vp + 2 * (16 * j * VS + 16 * n));
      mma_bf16(o[2 * n], al, vb[0], vb[1]);
      mma_bf16(o[2 * n], ah, vb[0], vb[1]);
      mma_bf16(o[2 * n + 1], al, vb[2], vb[3]);
      mma_bf16(o[2 * n + 1], ah, vb[2], vb[3]);
    }
  }
}

// columns c, c + 1 of one output row (c even; D even in bf16, so the pair
// is whole or wholly past D)
__device__ __forceinline__ void store_pair(float* p, int c, int D, float x,
                                           float y) {
  if (c < D) p[c] = x;
  if (c + 1 < D) p[c + 1] = y;
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, int c, int D,
                                           float x, float y) {
  if (c < D)
    *reinterpret_cast<__nv_bfloat162*>(p + c) = __floats2bfloat162_rn(x, y);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, Cfg<T, DP>::CTAS)
flash_kernel(const Params a) {
  using C = Cfg<T, DP>;
  constexpr int KS = C::KS, VS = C::VS, STAGES = C::STAGES;
  constexpr int STAGE = BK * (KS + VS);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);
  T* ring = sQ + BQ * KS;  // [STAGES][K tile, V tile]

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int n_qt = (a.Sq + BQ - 1) / BQ;
  const int qt = a.causal ? n_qt - 1 - static_cast<int>(blockIdx.x)
                          : static_cast<int>(blockIdx.x);
  const int q0 = qt * BQ, qw = q0 + 16 * warp;  // tile's, warp's first row
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int row_bytes = a.D * static_cast<int>(sizeof(T));

  // the key tiles some (q, k) pair of this query tile can reach, and this
  // CTA's part of them
  int k_begin = 0, k_end = a.Sk;
  if (a.causal) k_end = min(a.Sk, q0 + BQ);
  if (a.window > 0) k_begin = max(0, q0 - a.window + 1);
  const int t_first = k_begin / BK;
  const int n_t = max(0, (k_end + BK - 1) / BK - t_first);
  const int z = blockIdx.z, splits = gridDim.z;
  const int t0 = t_first + n_t * z / splits;
  const int t1 = t_first + n_t * (z + 1) / splits;

  // the (b, h) slices' bases are formed at each use, so no 64-bit
  // pointer holds registers across the products
  auto load_kv = [&](int tile, int stage) {
    T* sK = ring + stage * STAGE;
    const int64_t off = b * a.kb + h * a.kh;
    load_tile<T, BK, DP, KS>(sK, static_cast<const T*>(a.k) + off, a.ks,
                             tile * BK, a.Sk, row_bytes, a.cb);
    load_tile<T, BK, DP, VS>(sK + BK * KS, static_cast<const T*>(a.v) + off,
                             a.ks, tile * BK, a.Sk, row_bytes, a.cb);
  };
  // the ring: tile t0 + i in stage i % STAGES, STAGES - 1 tiles in
  // flight, one commit group per tile (empty past t1); Q with the first.
  // An empty part only writes (m, l) = (-inf, 0).
  if (t0 < t1)
    load_tile<T, BQ, DP, KS>(sQ, static_cast<const T*>(a.q) + b * a.qb +
                                     h * a.qh,
                             a.qs, q0, a.Sq, row_bytes, a.cb);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (t0 + i < t1) load_kv(t0 + i, i);
    cp_commit();
  }

  float o[DP / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  gossip::cp_wait<STAGES - 2>();
  __syncthreads();  // Q and the first key tile have landed
  QFrag<T, DP> qf;
  qf.load(sQ, 16 * warp, lane);

  for (int it = t0; it < t1; ++it) {
    const int stage = (it - t0) % STAGES;
    if (it > t0) {
      gossip::cp_wait<STAGES - 2>();
      __syncthreads();  // tile it has landed; tile it - 1 is done with
    }
    const int next = it + STAGES - 1;  // into tile it - 1's stage
    if (next < t1) load_kv(next, (next - t0) % STAGES);
    cp_commit();
    const int k0 = it * BK;
    // a warp whose rows see none of the tile (or lie past Sq) skips it
    if (qw >= a.Sq || (a.causal && k0 > qw + 15) ||
        (a.window > 0 && k0 + BK - 1 <= qw - a.window))
      continue;
    const T* sK = ring + stage * STAGE;
    float s[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    scores<DP>(s, qf, sK, lane);

    // scale into the exp2 domain; mask only a tile that holds a hidden
    // pair for some row of the warp
    const bool masked = k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > qw) ||
                        (a.window > 0 && k0 <= qw + 15 - a.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * a.scale_log2;
        if (masked) {
          const int qpos = qw + g + (e >> 1) * 8;
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          bool ok = kpos < a.Sk;
          if (a.causal) ok = ok && kpos <= qpos;
          if (a.window > 0) ok = ok && kpos > qpos - a.window;
          x = ok ? x : -INFINITY;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - mu[e >> 1]);
        l[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];
    accumulate<DP>(o, s, sK + BK * KS, lane);
  }

  const int rows = static_cast<int>(gridDim.y) * a.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qpos = qw + g + 8 * r;
    if (qpos >= a.Sq) continue;
    if (a.part == nullptr) {
      const float inv = 1.f / fmaxf(lr, 1e-20f);
      T* orow = static_cast<T*>(a.o) + b * a.ob + h * a.oh + qpos * a.os;
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
        store_pair(orow, 8 * n + 2 * t, a.D, o[n][2 * r] * inv,
                   o[n][2 * r + 1] * inv);
    } else {  // this split's unnormalised part and its (m, l)
      const int64_t row = static_cast<int64_t>(z) * rows + bh * a.Sq + qpos;
      float* prow = a.part + row * a.D;
      if (m[r] != -INFINITY)  // the merge reads no part of m = -inf
#pragma unroll
        for (int n = 0; n < DP / 8; ++n)
          store_pair(prow, 8 * n + 2 * t, a.D, o[n][2 * r], o[n][2 * r + 1]);
      if (t == 0) {
        float* ml = a.part + static_cast<int64_t>(splits) * rows * a.D;
        ml[2 * row] = m[r];
        ml[2 * row + 1] = lr;
      }
    }
  }
}

// The splits' parts merged into out, one thread an element: out = sum_z
// O_z 2^(m_z - M) / max(sum_z l_z 2^(m_z - M), 1e-20) with M = max_z m_z
// (a part that saw no key, m = -inf, adds nothing).
__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS)
merge_kernel(const Params a, int rows) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * MERGE_THREADS +
                    threadIdx.x;
  if (e >= static_cast<int64_t>(rows) * a.D) return;
  const int r = static_cast<int>(e / a.D), c = static_cast<int>(e % a.D);
  const float* ml = a.part + static_cast<int64_t>(a.splits) * rows * a.D;
  float M = -INFINITY;
  for (int z = 0; z < a.splits; ++z)
    M = fmaxf(M, ml[2 * (static_cast<int64_t>(z) * rows + r)]);
  float acc = 0.f, L = 0.f;
  for (int z = 0; z < a.splits; ++z) {
    const int64_t row = static_cast<int64_t>(z) * rows + r;
    const float mz = ml[2 * row];
    if (mz == -INFINITY) continue;
    const float w = exp2f(mz - M);
    L += ml[2 * row + 1] * w;
    acc += a.part[row * a.D + c] * w;
  }
  const int bh = r / a.Sq, q = r % a.Sq, b = bh / a.H, h = bh % a.H;
  store1(static_cast<T*>(a.o) + b * a.ob + h * a.oh + q * a.os + c,
         acc / fmaxf(L, 1e-20f));
}

template <typename T, int DP>
int launch(const Params& p, int BH, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, DP>();
  auto kern = flash_kernel<T, DP>;
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
  const dim3 grid(static_cast<unsigned>((p.Sq + BQ - 1) / BQ),
                  static_cast<unsigned>(BH), static_cast<unsigned>(p.splits));
  kern<<<grid, THREADS, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return static_cast<int>(err);
  const int rows = BH * p.Sq;
  const int64_t n = static_cast<int64_t>(rows) * p.D;
  merge_kernel<T><<<static_cast<unsigned>((n + MERGE_THREADS - 1) /
                                          MERGE_THREADS),
                    MERGE_THREADS, 0, stream>>>(p, rows);
  return static_cast<int>(cudaGetLastError());
}

// D: any width in [1, 128] whose rows are whole 4-byte words, run at the
// smallest instantiated width DP at or above it.
template <typename T>
int launch_d(const Params& p, int BH, cudaStream_t s) {
  const int D = p.D;
  if (D < 1 || D > 128 || D * static_cast<int>(sizeof(T)) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) return launch<T, 32>(p, BH, s);
  if (D <= 64) return launch<T, 64>(p, BH, s);
  if (D <= 96) return launch<T, 96>(p, BH, s);
  if (D <= 112) return launch<T, 112>(p, BH, s);
  return launch<T, 128>(p, BH, s);
}

// The widest asynchronous copy (16, 8 or 4 bytes) that every row start
// and D * size allow: the pointers, the used strides (a dim of size 1 is
// never stepped) and the row's bytes all multiples of it.
int copy_bytes(const Params& p, int B, int size) {
  const int64_t parts[] = {
      static_cast<int64_t>(reinterpret_cast<uintptr_t>(p.q)),
      static_cast<int64_t>(reinterpret_cast<uintptr_t>(p.k)),
      static_cast<int64_t>(reinterpret_cast<uintptr_t>(p.v)),
      static_cast<int64_t>(p.D) * size,
      B > 1 ? p.qb * size : 0, p.H > 1 ? p.qh * size : 0,
      p.Sq > 1 ? p.qs * size : 0, B > 1 ? p.kb * size : 0,
      p.H > 1 ? p.kh * size : 0, p.Sk > 1 ? p.ks * size : 0};
  for (int cb = 16; cb > 4; cb /= 2) {
    bool ok = true;
    for (int64_t x : parts) ok = ok && x % cb == 0;
    if (ok) return cb;
  }
  return 4;
}

}  // namespace flash

// q has the element strides (qb, qh, qs) of its [B, H, Sq, D] view, k and
// v share (kb, kh, ks) of their [B, H, Sk, D] views, o has (ob, oh, os);
// D is contiguous in all four. `part` holds splits x B*H*Sq x (D + 2)
// floats of scratch when splits > 1 (the key range of each query tile
// split over `splits` CTAs, merged by a second kernel); it is not read
// when splits = 1.
extern "C" int flash_attention_split_launch(
    const void* q, const void* k, const void* v, void* o, int BH, int H,
    int Sq, int Sk, int D, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long ob, long long oh,
    long long os, int causal, int window, int dtype, void* part, int splits,
    void* stream) {
  if (H < 1 || BH % H != 0 || splits < 1 || splits > 65535 ||
      (splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  flash::Params p{q,  k,  v,  o,  splits > 1 ? static_cast<float*>(part)
                                              : nullptr,
                  H,  Sq, Sk, D,  qb, qh, qs, kb, kh, ks, ob, oh, os, causal,
                  window, splits, 4,
                  1.4426950408889634f / sqrtf(static_cast<float>(D))};
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case gossip::kF32:
      p.cb = flash::copy_bytes(p, BH / H, 4);
      return flash::launch_d<float>(p, BH, s);
    case gossip::kBF16:
      p.cb = flash::copy_bytes(p, BH / H, 2);
      return flash::launch_d<__nv_bfloat16>(p, BH, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The same with the key range whole (one CTA per query tile, no scratch).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int BH, int H,
    int Sq, int Sk, int D, long long qb, long long qh, long long qs,
    long long kb, long long kh, long long ks, long long ob, long long oh,
    long long os, int causal, int window, int dtype, void* stream) {
  return flash_attention_split_launch(q, k, v, o, BH, H, Sq, Sk, D, qb, qh,
                                      qs, kb, kh, ks, ob, oh, os, causal,
                                      window, dtype, nullptr, 1, stream);
}
