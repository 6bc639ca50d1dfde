// gossip_mix_quant — fused int8 dequantize -> padded-CSR gossip mix on
// Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix_quant.py,
// gossip_mix_quant_pallas: out[i] = sum_k val[i, k] * scale[idx[i, k]] *
// q[idx[i, k]], with q [W, F] int8, scale [W] f32, idx/val [W, K], out
// [W, F] f32.
//
// Bound on an H100 SXM: bytes, W*F*1 + W*F*4 + W*K*8 + W*4 over 3.35 TB/s
// (the output in fp32 is four fifths of it).
//
// Design: the TPU kernel's layout, one (W, cols) tile with the gather inside
// it. The wrapper (kernels/ops.py, gossip_mix_quant_plan) picks the branch,
// the slice width, the rows per slot group and the copy width, and passes
// the dynamic shared-memory bytes, which the entry checks against its own
// reckoning.
//
// Branch 1, column slices. A CTA owns `cols` columns (16..256, so that the
// grid covers the 132 SMs) of all W rows:
// - q[:, slice] is copied into shared memory once, as int8, and scale[:]
//   beside it, every copy in flight together (16- or 4-byte cp.async where
//   q's rows allow, else plain byte loads), so device memory and L2 see each
//   byte of q once;
// - the folded slot weights sval[i, k] = val[i, k] * scale[idx[i, k]] (the
//   scale folded in once per slot, as the TPU kernel does) and the source
//   row offsets are staged for a group of rows (all W rows where they fit
//   the 227 KB beside the slice, else groups of `rows` rows), the first
//   group's idx and val loads issued before the slice is waited for;
// - each thread owns 4 columns of one output row at a time (CPT): per slot
//   one 8-byte load brings the folded weight and the gathered row's offset,
//   one 4-byte load its 4 int8, which are widened in registers without the
//   conversion unit (common.cuh, i8x4_to_f32) and folded in k order with
//   fp32 FMAs; the row is stored once (16-byte stores where F % 4 == 0).
//   256 threads a CTA, or 1024 where the rows need them (W = 500).
// Branch 2, per-row gather, for W so large that one 16-column slice of all
// rows and one row of slots do not fit in shared memory (16 W + 4 W + 8 K
// > 232,448 bytes: W > 11,617 at K = 5): a CTA owns one row and 4096
// columns, stages the row's folded slot weights, and each thread gathers 16
// columns of eight slots at a time, the eight 16-byte loads issued before
// their FMAs.
//
// What holds it now (PERF.md, Findings; benchmarks/gossip_variants.py on an
// NVIDIA H100 80GB HBM3 at 700 W): at W = 22 2.6 us, of which 2.2 are the
// launch, the copies and the slot fold (the gather loop taken out). At
// W = 500, K = 25, F = 4096 13.7 us against a 3.09 us bound: copies and
// slot fold 4.6 us (every CTA folds all W K slots), widening ~3 us, the
// shared-memory gather with its FMAs the other ~6 us. 8 columns a thread
// are 0.7 us faster at W = 500 and 0.1 slower at W = 22; 16 slower at both.
#include "common.cuh"

namespace gossip {
namespace {  // internal linkage, as in gossip_mix.cu

constexpr int G_THREADS = 256;  // branch 2
constexpr int CPT = 4;  // branch 1: columns of a row per thread
constexpr int kMaxDevices = 64;
constexpr int kSmemMax = 232448;
constexpr int GATHER = 8;        // branch 2: slots gathered at a time
constexpr int GATHER_SLOTS = 256;  // branch 2: slots staged at a time

__host__ __device__ inline int64_t round16(int64_t x) {
  return (x + 15) & ~int64_t(15);
}

inline int64_t slice_smem_bytes(int W, int K, int cols, int rows) {
  return round16(static_cast<int64_t>(W) * cols) + 4 * round16(W) +
         8 * static_cast<int64_t>(rows) * K;
}

// THREADS: 256 where rows x column groups fit in 256 threads, else 1024
template <int THREADS>
__global__ void __launch_bounds__(THREADS)
slice_mix_kernel(const int32_t* __restrict__ idx,
                 const float* __restrict__ val,
                 const float* __restrict__ scale,
                 const int8_t* __restrict__ q, float* __restrict__ out,
                 int W, int K, int64_t F, int cols, int rows, int align) {
  // slot loads in flight per thread (1024 threads have 64 registers each)
  constexpr int BATCH = THREADS >= 1024 ? 8 : 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int q_bytes = static_cast<int>(round16(static_cast<int64_t>(W) * cols));
  int8_t* sq = reinterpret_cast<int8_t*>(smem);                  // [W][cols]
  float* s_scale = reinterpret_cast<float*>(smem + q_bytes);     // [W]
  // [rows][K] slots: the folded weight's bits and the source row's offset
  // in sq, read together with one 8-byte load
  int2* s_slot = reinterpret_cast<int2*>(s_scale + round16(W));
  const int tid = threadIdx.x;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * cols;

  // q[:, slice] and scale: every copy in flight together
  if (align >= 4) {
    const int E = align;  // bytes (= columns) per copy
    const int per_row = cols / E;
    for (int e = tid; e < W * per_row; e += THREADS) {
      const int r = e / per_row, c = (e - r * per_row) * E;
      const bool ok = col0 + c < F;
      const int8_t* src = q + static_cast<int64_t>(r) * F + (ok ? col0 + c : 0);
      if (E == 16)
        cp16(smem_u32(sq + r * cols + c), src, ok);
      else
        cp4(smem_u32(sq + r * cols + c), src, ok);
    }
  } else {
    const int n = W * cols;
    for (int e0 = tid; e0 < n; e0 += 8 * THREADS) {
      int8_t v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * THREADS, r = e / cols;
        const int64_t c = col0 + (e - r * cols);
        v[u] = e < n && c < F ? q[static_cast<int64_t>(r) * F + c] : 0;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (e0 + u * THREADS < n) sq[e0 + u * THREADS] = v[u];
    }
  }
  for (int i = tid; i < W; i += THREADS)
    cp4(smem_u32(s_scale + i), scale + i, true);
  cp_commit();

  // thread (row group, column group cg) owns CPT columns of rows rg,
  // rg + n_rg, ...
  const int n_cg = cols / CPT;
  const int cg = tid % n_cg, n_rg = THREADS / n_cg;
  const int64_t col = col0 + CPT * cg;
  for (int g0 = 0; g0 < W; g0 += rows) {
    const int nr = min(rows, W - g0);
    const int n = nr * K;
    const int64_t base = static_cast<int64_t>(g0) * K;
    if (g0 > 0) __syncthreads();  // the previous group's slots are read
    // slots of rows g0 .. g0 + nr: BATCH loads in flight per thread
    for (int e0 = tid; e0 - tid < n; e0 += BATCH * THREADS) {
      int32_t j[BATCH];
      float v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * THREADS;
        j[u] = e < n ? idx[base + e] : 0;
        v[u] = e < n ? val[base + e] : 0.f;
      }
      if (g0 == 0 && e0 == tid) {  // the slice and scale, once
        cp_wait<0>();
        __syncthreads();
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int e = e0 + u * THREADS;
        if (e < n)
          s_slot[e] = make_int2(__float_as_int(v[u] * s_scale[j[u]]),
                                j[u] * cols);
      }
    }
    __syncthreads();
    if (col >= F) continue;
    for (int r = tid / n_cg; r < nr; r += n_rg) {
      const int2* slot = s_slot + r * K;
      const int8_t* sqc = sq + CPT * cg;
      float acc[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
#pragma unroll 4
      for (int k = 0; k < K; ++k) {
        const int2 sl = slot[k];
        alignas(16) uint32_t raw[CPT / 4];  // one 4-, 8- or 16-byte load
        if constexpr (CPT == 16)
          *reinterpret_cast<uint4*>(raw) =
              *reinterpret_cast<const uint4*>(sqc + sl.y);
        else if constexpr (CPT == 8)
          *reinterpret_cast<uint2*>(raw) =
              *reinterpret_cast<const uint2*>(sqc + sl.y);
        else
          raw[0] = *reinterpret_cast<const uint32_t*>(sqc + sl.y);
        const float v = __int_as_float(sl.x);
        float x[CPT];
#pragma unroll
        for (int u = 0; u < CPT / 4; ++u) i8x4_to_f32(raw[u], x + 4 * u);
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[c] = fmaf(v, x[c], acc[c]);
      }
      float* o = out + static_cast<int64_t>(g0 + r) * F + col;
      if ((F & 3) == 0 && col + CPT <= F) {
#pragma unroll
        for (int c = 0; c < CPT; c += 4)
          *reinterpret_cast<float4*>(o + c) =
              make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (col + c < F) o[c] = acc[c];
      }
    }
  }
  cp_wait<0>();  // K = 0 never waited above
}

// 16 int8 of a row at col (masked at F); one 16-byte load where `vec`
__device__ __forceinline__ uint4 load_q16(const int8_t* row, int64_t col,
                                          int64_t F, bool vec) {
  if (vec) return col < F ? __ldg(reinterpret_cast<const uint4*>(row + col))
                          : make_uint4(0, 0, 0, 0);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (col + b < F)
      w[b / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[col + b]))
                  << (8 * (b % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void fma16(float v, uint4 raw, float (&acc)[16]) {
  float x[16];
  i8x4_to_f32(raw.x, x);
  i8x4_to_f32(raw.y, x + 4);
  i8x4_to_f32(raw.z, x + 8);
  i8x4_to_f32(raw.w, x + 12);
#pragma unroll
  for (int b = 0; b < 16; ++b) acc[b] = fmaf(v, x[b], acc[b]);
}

__global__ void __launch_bounds__(G_THREADS)
gather_mix_kernel(const int32_t* __restrict__ idx,
                  const float* __restrict__ val,
                  const float* __restrict__ scale,
                  const int8_t* __restrict__ q, float* __restrict__ out,
                  int K, int64_t F, int64_t n_tiles, int align) {
  __shared__ int32_t s_j[GATHER_SLOTS];
  __shared__ float s_w[GATHER_SLOTS];
  const int64_t bid = blockIdx.x;
  const int64_t i = bid / n_tiles;
  const int64_t col = (bid % n_tiles) * (G_THREADS * 16) +
                      static_cast<int64_t>(threadIdx.x) * 16;
  const bool vec = align == 16;
  float acc[16];
#pragma unroll
  for (int b = 0; b < 16; ++b) acc[b] = 0.f;
  for (int k0 = 0; k0 < K; k0 += GATHER_SLOTS) {
    const int nk = min(GATHER_SLOTS, K - k0);
    const int padded = (nk + GATHER - 1) / GATHER * GATHER;
    if (k0 > 0) __syncthreads();
    for (int t = threadIdx.x; t < padded; t += G_THREADS) {
      // pad slots up to a multiple of GATHER: weight 0 on row i
      const int32_t j = t < nk ? idx[i * K + k0 + t] : static_cast<int32_t>(i);
      s_j[t] = j;
      s_w[t] = t < nk ? val[i * K + k0 + t] * scale[j] : 0.f;
    }
    __syncthreads();
    for (int t0 = 0; t0 < padded; t0 += GATHER) {
      uint4 raw[GATHER];
#pragma unroll
      for (int u = 0; u < GATHER; ++u)
        raw[u] = load_q16(q + static_cast<int64_t>(s_j[t0 + u]) * F, col, F,
                          vec);
#pragma unroll
      for (int u = 0; u < GATHER; ++u) fma16(s_w[t0 + u], raw[u], acc);
    }
  }
  if (col >= F) return;
  float* o = out + i * F + col;
  if (vec) {
#pragma unroll
    for (int b = 0; b < 16; b += 4)
      *reinterpret_cast<float4*>(o + b) =
          make_float4(acc[b], acc[b + 1], acc[b + 2], acc[b + 3]);
  } else {
#pragma unroll
    for (int b = 0; b < 16; ++b)
      if (col + b < F) o[b] = acc[b];
  }
}

int launch_quant(const int32_t* idx, const float* val, const float* scale,
                 const int8_t* q, float* out, int W, int K, int64_t F,
                 int branch, int cols, int rows, int align, int smem,
                 cudaStream_t stream) {
  if (branch == 1) {
    if ((cols & (cols - 1)) || cols < 16 || cols > 256 || rows < 1 ||
        rows > W || (align != 1 && align != 4 && align != 16) ||
        smem != slice_smem_bytes(W, K, cols, rows) || smem > kSmemMax ||
        static_cast<int64_t>(W) * K >= 0x7fffffff)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t grid = (F + cols - 1) / cols;
    if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const bool wide = static_cast<int64_t>(rows) * (cols / CPT) > 256;
    auto kern = wide ? slice_mix_kernel<1024> : slice_mix_kernel<256>;
    static bool configured[2][kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!configured[wide][dev]) {  // once per device, outside graph capture
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured[wide][dev] = true;
    }
    kern<<<static_cast<unsigned>(grid), wide ? 1024 : 256, smem, stream>>>(
        idx, val, scale, q, out, W, K, F, cols, rows, align);
  } else if (branch == 2) {
    if (smem != 0 || (align != 1 && align != 16))
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n_tiles = (F + G_THREADS * 16 - 1) / (G_THREADS * 16);
    const int64_t grid = n_tiles * W;
    if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    gather_mix_kernel<<<static_cast<unsigned>(grid), G_THREADS, 0,
                        stream>>>(idx, val, scale, q, out, K, F, n_tiles,
                                  align);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gossip

// branch 1 (column slices) or 2 (per-row gather); cols, rows: branch 1's
// slice width and rows per slot group; align: bytes per copy of q's rows
// (16, 4 or 1); smem: dynamic shared-memory bytes (0 for branch 2), which
// must equal the branch's own reckoning.
extern "C" int gossip_mix_quant_launch(const void* idx, const void* val,
                                       const void* scale, const void* q,
                                       void* out, int W, int K, long long F,
                                       int branch, int cols, int rows,
                                       int align, int smem, void* stream) {
  return gossip::launch_quant(
      static_cast<const int32_t*>(idx), static_cast<const float*>(val),
      static_cast<const float*>(scale), static_cast<const int8_t*>(q),
      static_cast<float*>(out), W, K, F, branch, cols, rows, align, smem,
      static_cast<cudaStream_t>(stream));
}
