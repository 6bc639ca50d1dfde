// gossip_mix_sparse — padded-CSR gossip mix on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix_sparse.py,
// gossip_mix_sparse_pallas: out[i] = sum_k val[i, k] * w[idx[i, k]], with
// idx/val [W, K] (a pad slot repeats row i with weight 0), w [W, F] f32 or
// bf16, out [W, F] f32, accumulated in fp32 in k order. Every slot is
// folded, weight 0 included: 0 * inf is NaN, as in the TPU kernel, its
// reference and the dense mix, so a row holding inf or NaN poisons every
// receiver whose support names it.
//
// Bound on an H100 SXM: bytes. The mix does 2*nnz*F flops on
// W*F*sizeof(w) + W*F*4 + W*K*8 bytes, a fraction of a flop per byte, far
// below the card's ~20 fp32 flops per byte; so the least time is those
// bytes over 3.35 TB/s.
//
// Design: the TPU kernel's layout, one (W, cols) tile with the gather
// inside it. The wrapper (kernels/ops.py, gossip_mix_sparse_plan) picks the
// branch, the slice width, the row split, the rows per slot group, the
// threads per CTA and the copy width, and passes the dynamic shared-memory
// bytes, which the entry checks against its own reckoning.
//
// Branch 1, column slices. CTA (s, y) owns `cols` columns (16..256) of the
// output rows in part y of `split` equal parts, and reads w's slice of
// all W rows:
// - w[:, slice] is copied into shared memory once per CTA, in w's own
//   type (16- or 4-byte cp.async where w's rows allow, else plain element
//   loads), so device memory and L2 see each byte of w `split` times,
//   where a gather straight from global memory reads each row once per
//   slot naming it (K times). A slice row of 128 bytes or more keeps each
//   quarter-warp's (f32) or half-warp's (bf16) loads on one source row, free
//   of bank conflicts; the row split keeps the grid over the 132 SMs when
//   such slices are few;
// - the slots of the CTA's rows are copied by cp.async too, as (source
//   row, weight bits) pairs: all of them with the slice where they fit
//   (one wait, one barrier), else `rows` rows at a time in double-buffered
//   groups, the next group's copies in flight while this one is folded;
// - each thread owns 4 consecutive columns of one output row at a time:
//   per slot one 8-byte load brings row and weight, one 16-byte (f32) or
//   8-byte (bf16) load the 4 gathered values, widened in registers and
//   folded with fp32 FMAs in k order; the row is stored once (16-byte
//   stores where F % 4 == 0). 256 threads a CTA, or 1024 where the rows
//   need them.
// Branch 2, per-row gather, for W so large that one 16-column slice of all
// rows and two slot groups of 2,048 slots do not fit in shared memory
// (16 W sizeof(w) + 32,800 > 232,448 bytes at K = 5: W > 3,119 for f32,
// W > 6,239 for bf16; shorter groups cannot hide their copies and lose to
// the gather). A CTA owns one row and 256 16-byte column groups (1,024
// f32 or 2,048 bf16 columns), stages the row's slots, and each thread
// gathers eight slots at a time, the eight 16-byte loads issued before
// their FMAs. F's tail is masked in both branches; w is never padded.
//
// What holds it now (PERF.md, Findings; benchmarks/gossip_variants.py on
// an NVIDIA H100 80GB HBM3 at 700 W). At W = 22, F = 2048 it takes ~2.2-2.4
// us, ~1.7 of them the launch and the slice copy. At W = 500, K = 25, F =
// 4096 it takes 14.1 us against a 4.92 us bound (f32):
// - 3.3 us launch and slice copy, and 1.8 more for the slots, which every
//   CTA reads whole (the L2 delivers ~45-55 GB/s to each SM);
// - the gather: 4.75 us for w's 16-byte shared-memory loads, ~4.3 for the
//   slot loads, offsets and FMAs (~2.4 clocks a warp and slot).
// bf16 takes 12.5 us, 1.9 of them widening. Four things were tried and
// were slower:
// - slot groups of one pass of the threads, double-buffered (15.3 us);
// - a slot pipeline per warp with no block barriers (15.7-16.0);
// - 8 bf16 columns a thread (bf16 12.4-12.7 against 12.1-12.3);
// - staging the slots through registers, not cp.async (14.5).
// Against the gather branch, slices win 1.2-2.1x from W = 1,000 to 3,000
// at K = 5, 25 and 100 (benchmarks/gossip_probe.py).
#include "common.cuh"

namespace gossip {
namespace {  // internal linkage, as in gossip_mix.cu

constexpr int CPT = 4;             // branch 1: columns of a row per thread
constexpr int G_THREADS = 256;     // branch 2
constexpr int GATHER = 8;          // branch 2: slots gathered at a time
constexpr int GATHER_SLOTS = 256;  // branch 2: slots staged at a time
constexpr int kMaxDevices = 64;
constexpr int kSmemMax = 232448;

__host__ __device__ inline int64_t round16(int64_t x) {
  return (x + 15) & ~int64_t(15);
}

// the slice, then one buffer of `rows` rows of slots where they hold all of
// a CTA's rows (W / split, rounded up), else two
inline int64_t slice_smem_bytes(int W, int K, int cols, int split, int rows,
                                int size) {
  const int part = (W + split - 1) / split;
  return round16(static_cast<int64_t>(W) * cols * size) +
         8 * static_cast<int64_t>(rows) * K * (rows < part ? 2 : 1);
}

// slots e0 .. e0 + n of idx/val into dst as (row, weight bits) pairs
__device__ __forceinline__ void copy_slots(int2* dst,
                                           const int32_t* __restrict__ idx,
                                           const float* __restrict__ val,
                                           int64_t e0, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    cp4(smem_u32(&dst[e].x), idx + e0 + e, true);
    cp4(smem_u32(&dst[e].y), val + e0 + e, true);
  }
}

template <typename T>
__global__ void __launch_bounds__(1024)
slice_mix_kernel(const int32_t* __restrict__ idx,
                 const float* __restrict__ val, const T* __restrict__ w,
                 float* __restrict__ out, int W, int K, int64_t F, int cols,
                 int split, int rows, int align) {
  using B = typename Bits<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int w_bytes =
      static_cast<int>(round16(static_cast<int64_t>(W) * cols * sizeof(T)));
  T* sw = reinterpret_cast<T*>(smem);                       // [W][cols]
  // [2][rows][K] (or [1][part][K]) slots: the source row and the weight's
  // bits, read together with one 8-byte load
  int2* s_slot = reinterpret_cast<int2*>(smem + w_bytes);
  const int tid = threadIdx.x, threads = blockDim.x;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * cols;
  const int part = (W + split - 1) / split;
  const int r_lo = blockIdx.y * part, r_hi = min(W, r_lo + part);
  if (r_lo >= r_hi) return;

  // w[:, slice], every copy in flight together; columns past F are zeros
  if (align >= 4) {
    const int E = align / static_cast<int>(sizeof(T));  // elements a copy
    const int per_row = cols / E;
    for (int e = tid; e < W * per_row; e += threads) {
      const int r = e / per_row, c = (e - r * per_row) * E;
      const bool ok = col0 + c < F;
      const T* src = w + static_cast<int64_t>(r) * F + (ok ? col0 + c : 0);
      if (align == 16)
        cp16(smem_u32(sw + r * cols + c), src, ok);
      else
        cp4(smem_u32(sw + r * cols + c), src, ok);
    }
  } else {
    const B* wb = reinterpret_cast<const B*>(w);
    B* sb = reinterpret_cast<B*>(sw);
    const int n = W * cols;
    for (int e0 = tid; e0 < n; e0 += 8 * threads) {
      B v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * threads, r = e / cols;
        const int64_t c = col0 + (e - r * cols);
        v[u] = e < n && c < F ? wb[static_cast<int64_t>(r) * F + c] : B(0);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (e0 + u * threads < n) sb[e0 + u * threads] = v[u];
    }
  }
  copy_slots(s_slot, idx, val, static_cast<int64_t>(r_lo) * K,
             min(rows, r_hi - r_lo) * K);
  cp_commit();

  // thread (row group, column group cg) owns CPT columns of rows rg,
  // rg + n_rg, ... of each slot group
  const int n_cg = cols / CPT;
  const int cg = tid % n_cg, n_rg = threads / n_cg;
  const int64_t col = col0 + CPT * cg;
  const int n_groups = (r_hi - r_lo + rows - 1) / rows;
  for (int g = 0; g < n_groups; ++g) {
    const int g0 = r_lo + g * rows, nr = min(rows, r_hi - g0);
    if (g + 1 < n_groups) {  // the next group's slots, into the other buffer
      const int g1 = g0 + rows;
      copy_slots(s_slot + ((g + 1) & 1) * rows * K, idx, val,
                 static_cast<int64_t>(g1) * K, min(rows, r_hi - g1) * K);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();  // the slice and this group's slots are in
    if (col < F) {
      for (int r = tid / n_cg; r < nr; r += n_rg) {
        const int2* slot = s_slot + (g & 1) * rows * K + r * K;
        const T* swc = sw + CPT * cg;
        float acc[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[c] = 0.f;
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
          const int2 sl = slot[k];
          float x[CPT];
          lds4(swc + sl.x * cols, x);
          const float v = __int_as_float(sl.y);
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[c] = fmaf(v, x[c], acc[c]);
        }
        float* o = out + static_cast<int64_t>(g0 + r) * F + col;
        if ((F & 3) == 0) {
          *reinterpret_cast<float4*>(o) =
              make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            if (col + c < F) o[c] = acc[c];
        }
      }
    }
    if (g + 2 < n_groups) __syncthreads();  // this buffer is refilled next
  }
}

// The 16 bytes of a row at col (Vec<T>::N elements, masked at F): one
// 16-byte load where `vec`, else element loads
template <typename T>
__device__ __forceinline__ uint4 load_row16(const T* row, int64_t col,
                                            int64_t F, bool vec) {
  using B = typename Bits<T>::type;
  constexpr int N = Vec<T>::N;
  if (vec)
    return col < F ? __ldg(reinterpret_cast<const uint4*>(row + col))
                   : make_uint4(0, 0, 0, 0);
  alignas(16) B b[N];
  const B* rb = reinterpret_cast<const B*>(row);
#pragma unroll
  for (int e = 0; e < N; ++e) b[e] = col + e < F ? rb[col + e] : B(0);
  return *reinterpret_cast<const uint4*>(b);
}

template <typename T>
__device__ __forceinline__ void fma_row16(float v, uint4 raw,
                                          float (&acc)[Vec<T>::N]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) acc[j] = fmaf(v, to_f32(e[j]), acc[j]);
}

template <typename T>
__global__ void __launch_bounds__(G_THREADS)
gather_mix_kernel(const int32_t* __restrict__ idx,
                  const float* __restrict__ val, const T* __restrict__ w,
                  float* __restrict__ out, int K, int64_t F, int64_t n_tiles,
                  int align) {
  constexpr int N = Vec<T>::N;
  __shared__ int32_t s_j[GATHER_SLOTS];
  __shared__ float s_v[GATHER_SLOTS];
  const int64_t bid = blockIdx.x;
  const int64_t i = bid / n_tiles;
  const int64_t col = (bid % n_tiles) * (G_THREADS * N) +
                      static_cast<int64_t>(threadIdx.x) * N;
  const bool vec = align == 16;
  float acc[N];
#pragma unroll
  for (int j = 0; j < N; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += GATHER_SLOTS) {
    const int nk = min(GATHER_SLOTS, K - k0);
    if (k0 > 0) __syncthreads();
    for (int t = threadIdx.x; t < nk; t += G_THREADS) {
      s_j[t] = idx[i * K + k0 + t];
      s_v[t] = val[i * K + k0 + t];
    }
    __syncthreads();
    // eight slots at a time; past nk no slot is read or folded (a padded
    // slot would add 0 * w[i], which is NaN where w[i] holds inf)
    for (int t0 = 0; t0 < nk; t0 += GATHER) {
      uint4 raw[GATHER];
#pragma unroll
      for (int u = 0; u < GATHER; ++u)
        if (t0 + u < nk)
          raw[u] = load_row16(w + static_cast<int64_t>(s_j[t0 + u]) * F,
                              col, F, vec);
#pragma unroll
      for (int u = 0; u < GATHER; ++u)
        if (t0 + u < nk) fma_row16<T>(s_v[t0 + u], raw[u], acc);
    }
  }
  if (col >= F) return;
  float* o = out + i * F + col;
  if (vec) {
#pragma unroll
    for (int j = 0; j < N; j += 4)
      *reinterpret_cast<float4*>(o + j) =
          make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (col + j < F) o[j] = acc[j];
  }
}

template <typename T>
int launch_sparse(const int32_t* idx, const float* val, const void* w,
                  float* out, int W, int K, int64_t F, int branch, int cols,
                  int split, int rows, int threads, int align, int smem,
                  cudaStream_t stream) {
  constexpr int size = static_cast<int>(sizeof(T));
  const T* wt = static_cast<const T*>(w);
  if (static_cast<int64_t>(W) * K >= 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  if (branch == 1) {
    if ((cols & (cols - 1)) || cols < 16 || cols > 256 || split < 1 ||
        split > W || split > 65535 || rows < 1 ||
        rows > (W + split - 1) / split ||
        (threads != 256 && threads != 1024) ||
        (align != 16 && align != 4 && align != size) ||
        smem != slice_smem_bytes(W, K, cols, split, rows, size) ||
        smem > kSmemMax)
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t grid = (F + cols - 1) / cols;
    if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    static bool configured[kMaxDevices] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
    if (!configured[dev]) {  // once per device, outside graph capture
      err = cudaFuncSetAttribute(slice_mix_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemMax);
      if (err != cudaSuccess) return static_cast<int>(err);
      configured[dev] = true;
    }
    slice_mix_kernel<T>
        <<<dim3(static_cast<unsigned>(grid), static_cast<unsigned>(split)),
           threads, smem, stream>>>(idx, val, wt, out, W, K, F, cols, split,
                                    rows, align);
  } else if (branch == 2) {
    if (smem != 0 || threads != G_THREADS || split != 1 || rows != 0 ||
        (align != 16 && align != size))
      return static_cast<int>(cudaErrorInvalidValue);
    const int64_t tile = static_cast<int64_t>(G_THREADS) * Vec<T>::N;
    const int64_t n_tiles = (F + tile - 1) / tile;
    const int64_t grid = n_tiles * W;
    if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    gather_mix_kernel<T><<<static_cast<unsigned>(grid), G_THREADS, 0,
                           stream>>>(idx, val, wt, out, K, F, n_tiles,
                                     align);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace gossip

// dtype: kF32 or kBF16; branch 1 (column slices) or 2 (per-row gather);
// cols, split, rows: branch 1's slice width, the parts its rows are split
// into (grid.y) and the rows per slot group (1, 0 for branch 2); threads:
// per CTA (branch 1: 256 or 1024; branch 2: 256); align: bytes per copy of
// w's rows (16, 4, or the element size: element loads); smem: dynamic
// shared-memory bytes (0 for branch 2), which must equal the branch's own
// reckoning.
extern "C" int gossip_mix_sparse_launch(const void* idx, const void* val,
                                        const void* w, void* out, int W,
                                        int K, long long F, int dtype,
                                        int branch, int cols, int split,
                                        int rows, int threads, int align,
                                        int smem, void* stream) {
  using namespace gossip;
  const auto* i32 = static_cast<const int32_t*>(idx);
  const auto* v = static_cast<const float*>(val);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_sparse<float>(i32, v, w, o, W, K, F, branch, cols, split,
                                  rows, threads, align, smem, s);
    case kBF16:
      return launch_sparse<__nv_bfloat16>(i32, v, w, o, W, K, F, branch,
                                          cols, split, rows, threads, align,
                                          smem, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
