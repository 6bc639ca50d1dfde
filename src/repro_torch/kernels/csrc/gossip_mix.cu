// gossip_mix — dense gossip mix out = P @ w on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix.py,
// gossip_mix_pallas: P [W, W] f32, w [W, F] f32, bf16 or int8 (the pallas
// backend folds the int8 row scales into P's columns and feeds the raw int8
// payload), out [W, F] f32, fp32 accumulate.
//
// Bound on an H100 SXM: W*F*sizeof(w) + W*F*4 + W*W*4 bytes over 3.35 TB/s
// against the products. In fp32 on the CUDA cores (2*W*W*F flops at 67
// TFLOP/s) the two cross near W = 80 for f32 w (W = 50 for int8); on the
// tensor cores in 3xTF32 (3 * 2*W*W*F at 495 TFLOP/s; 2 products for a bf16
// or int8 payload) they cross near W = 330 (f32). At DeFTA's W = 22 the
// bytes bound it by far; at W = 500, F = 4096 the products.
//
// Two regimes, one source; the wrapper (kernels/ops.py, gossip_mix_plan)
// picks by W and passes the regime, the slice width, the alignment flags
// and the dynamic shared-memory bytes, which the entry checks against its
// own reckoning.
//
// Stream regime (small W; the TPU kernel's own layout). A CTA owns a slice
// of `cols` columns (16..128, so that the grid covers the 132 SMs) across
// all W rows:
// - the slice of w is copied into shared memory once, in its own type, with
//   16-byte cp.async copies all issued before anything waits (plain loads
//   where a row start is not 16-byte aligned), columns past F zero-filled;
// - P is copied whole beside it by the same cp.async wave (16 bytes at a
//   time where W % 4 == 0, else 4), rows padded so that 8 consecutive rows
//   fall in 8 bank groups;
// - each thread owns R rows x 4 columns of out (R = 1, 2 or 4, the fewest
//   rows that let 256 threads cover W in one pass; the rows strided by the
//   number of row groups): per contraction step j one 4-element load of the
//   slice (widened in registers) and R values of P feed 4R fp32 FMAs, the
//   W-term chain in j order;
// - every output element is stored once, with 16-byte stores where F % 4
//   == 0. No row is padded to a tile.
//
// Tile regime (large W): fp32-accurate products on the tensor cores.
// - mma.sync.m16n8k8 TF32 in 3xTF32: each fp32 operand v is split into hi
//   (v rounded as cvt.rna rounds) and lo = v - hi (exact; the tensor cores
//   read its top 19 bits), and a product is lo.hi' + hi.lo' + hi.hi', small
//   terms first, accumulated in fp32 (CUTLASS's "fast fp32" split, as in
//   ssd_chunk_tc.cu). A bf16 or int8 payload is exact in TF32 once widened,
//   its lo is zero, so it takes two products, P_lo.w + P_hi.w.
// - Not wgmma: TF32 wgmma takes B only K-major, and w [W, F] is N-major, so
//   every w tile would be transposed in shared memory. mma.sync's B
//   fragment (b0 = B[t][g], b1 = B[t + 4][g]) reads w's row-major tile as it
//   lies, widened from its own type as the fragment is read.
// - A CTA computes a 128 x 64 tile of out with 8 warps (4 x 2, 32 x 32
//   each: 2 x 4 mma tiles); the contraction walks 32 at a time through a
//   3-stage cp.async ring of P and w tiles (83 KB for f32 w: two CTAs per
//   SM). Row strides of 36 floats (P) and 72 / 72 / 80 elements (w in f32 /
//   bf16 / int8) keep the fragment reads free of bank conflicts.
// - Ragged W and F are masked in the kernel, never padded: copies past W or
//   F are zero-filled (src-size 0). Where a row start is not 16-byte
//   aligned (W % 4 for P; F * sizeof(w) % 16 for w), P and f32 w are copied
//   4 bytes at a time (cp.async), bf16 and int8 w with plain loads.
// - Consecutive CTAs take the row tiles of one column tile, so a w tile is
//   read from device memory once and from L2 by the others.
//
// What holds it now (PERF.md, Findings; benchmarks/gossip_variants.py on an
// NVIDIA H100 80GB HBM3 at 700 W): at W = 22 the stream regime takes
// 2.3-2.5 us, a launch and one round trip (the byte bound is 0.11 us). At
// W = 500, F = 4096 the tile regime takes 41.4 us against 12.41 us for its
// three TF32 products at the dense rate; with the two small products taken
// out it still takes 24.1 us, so the loads, the splits and the pipeline's
// fill, more than the tensor cores, set the time. A 128 x 128 CTA tile is
// faster there (37.5 us) but slower at W = 200 (17.6 against 11.9 us).
#include "common.cuh"

namespace gossip {
// internal linkage throughout: the launchers' per-device flags (static
// locals of templates) must not be merged with another library's
namespace {

constexpr int MIX_THREADS = 256;
constexpr int kMaxDevices = 64;
constexpr int kSmemMax = 232448;   // dynamic shared memory a CTA may opt in to

// alignment flags (set by the wrapper)
enum : int { kWRows16 = 1, kOutRows16 = 2, kPRows16 = 4 };

// ------------------------------------------------------------- stream regime

// P's row stride in shared memory: W rounded up to 4 floats (16-byte rows),
// plus 4 where that is a multiple of 8, so that 8 consecutive rows start in
// 8 different bank groups (the stride / 4 is odd)
__host__ __device__ inline int stream_p_stride(int W) {
  const int ps = (W + 3) & ~3;
  return ps % 8 == 0 ? ps + 4 : ps;
}

template <typename T>
inline int64_t stream_smem_bytes(int W, int cols) {
  return static_cast<int64_t>(W) * stream_p_stride(W) * 4 +
         static_cast<int64_t>(W) * cols * sizeof(T);
}

// R: output rows per thread (1, 2 or 4), the fewest that let the CTA's
// threads cover all W rows of the slice in one pass
template <typename T, int R>
__global__ void __launch_bounds__(MIX_THREADS)
stream_mix_kernel(const float* __restrict__ P, const T* __restrict__ w,
                  float* __restrict__ out, int W, int64_t F, int cols,
                  int flags) {
  using B = typename Bits<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int ps = stream_p_stride(W);
  float* sP = reinterpret_cast<float*>(smem);           // [W][ps]
  T* sw = reinterpret_cast<T*>(smem + W * ps * 4);      // [W][cols]
  const int tid = threadIdx.x;
  const int64_t col0 = static_cast<int64_t>(blockIdx.x) * cols;

  // P and the slice of w: every copy in flight before any wait
  if (flags & kPRows16) {
    const int per_row = (W + 3) / 4;
    for (int e = tid; e < W * per_row; e += MIX_THREADS) {
      const int r = e / per_row, c = (e - r * per_row) * 4;
      cp16(smem_u32(sP + r * ps + c), P + static_cast<int64_t>(r) * W + c,
           true);
    }
  } else {
    for (int e = tid; e < W * W; e += MIX_THREADS) {
      const int r = e / W, c = e - r * W;
      cp4(smem_u32(sP + r * ps + c), P + e, true);
    }
  }
  if (flags & kWRows16) {
    constexpr int E = 16 / sizeof(T);  // elements per copy
    const int per_row = cols / E;
    for (int e = tid; e < W * per_row; e += MIX_THREADS) {
      const int r = e / per_row, c = (e - r * per_row) * E;
      const bool ok = col0 + c < F;
      cp16(smem_u32(sw + r * cols + c),
           w + static_cast<int64_t>(r) * F + (ok ? col0 + c : 0), ok);
    }
  } else {
    const B* wb = reinterpret_cast<const B*>(w);
    B* sb = reinterpret_cast<B*>(sw);
    const int n = W * cols;
    for (int e0 = tid; e0 < n; e0 += 8 * MIX_THREADS) {
      B v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = e0 + u * MIX_THREADS, r = e / cols;
        const int64_t c = col0 + (e - r * cols);
        v[u] = e < n && c < F ? wb[static_cast<int64_t>(r) * F + c] : B(0);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (e0 + u * MIX_THREADS < n) sb[e0 + u * MIX_THREADS] = v[u];
    }
  }
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  // thread (row group rg, column group cg) takes rows rg + m * n_rg, m < R:
  // a warp's 8 row groups read 8 consecutive rows of P, in 8 bank groups
  const int n_cg = cols / 4;  // column groups of 4
  const int cg = tid % n_cg, n_rg = MIX_THREADS / n_cg;
  const int64_t col = col0 + 4 * cg;
  const T* wcol = sw + 4 * cg;
  for (int r0 = tid / n_cg; r0 < W; r0 += R * n_rg) {
    const float* prow[R];
#pragma unroll
    for (int m = 0; m < R; ++m)  // rows past W read row 0; never stored
      prow[m] = sP + (r0 + m * n_rg < W ? r0 + m * n_rg : 0) * ps;
    float acc[R][4] = {};
#pragma unroll 4
    for (int j = 0; j < W; ++j) {
      float x[4];
      lds4(wcol + j * cols, x);
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float p = prow[m][j];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(p, x[c], acc[m][c]);
      }
    }
    if (col >= F) continue;
#pragma unroll
    for (int m = 0; m < R; ++m) {
      const int r = r0 + m * n_rg;
      if (r >= W) break;
      float* o = out + static_cast<int64_t>(r) * F + col;
      if (flags & kOutRows16) {
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (col + c < F) o[c] = acc[m][c];
      }
    }
  }
}

// --------------------------------------------------------------- tile regime

// 8 warps, 4 along M x 2 along N, each MT x NT mma tiles of 16 x 8
constexpr int MT = 2, NT = 4;
constexpr int BM = 4 * 16 * MT, BN = 2 * 8 * NT, BK = 32, STAGES = 3;
constexpr int AS = BK + 4;  // P tile row stride (floats)

template <typename T>
struct TileCfg {
  // w tile row stride in elements: BN + 8 (f32, bf16), BN + 16 (int8)
  static constexpr int BS = sizeof(T) == 1 ? BN + 16 : BN + 8;
  static constexpr int A_BYTES = BM * AS * 4;
  static constexpr int B_BYTES = BK * BS * static_cast<int>(sizeof(T));
  static constexpr int STAGE = A_BYTES + B_BYTES;  // a multiple of 16
  static constexpr int SMEM = STAGES * STAGE;
};

// PA, WA: P's and w's rows start on 16-byte boundaries (copied 16 bytes
// at a time); else P and f32 w 4 bytes at a time, bf16 and int8 w by plain
// loads. Separate instantiations keep the unaligned copies' addresses out of
// the aligned kernel's registers.
template <typename T, bool PA, bool WA>
__global__ void __launch_bounds__(MIX_THREADS, 2)
tile_mix_kernel(const float* __restrict__ P, const T* __restrict__ w,
                float* __restrict__ out, int W, int64_t F, int n_rt) {
  using K = TileCfg<T>;
  using Bt = typename Bits<T>::type;
  constexpr bool WIDE = sizeof(T) == 4;  // f32 payload: 3 products
  constexpr int BS = K::BS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp % 4, wn = warp / 4;
  const int64_t bid = blockIdx.x;
  const int row0 = static_cast<int>(bid % n_rt) * BM;
  const int64_t col0 = (bid / n_rt) * BN;
  const int nk = (W + BK - 1) / BK;

  auto load = [&](int kt, int s) {
    const int k0 = kt * BK;
    float* sA = reinterpret_cast<float*>(smem + s * K::STAGE);
    T* sB = reinterpret_cast<T*>(smem + s * K::STAGE + K::A_BYTES);
    // P[row0 .. +BM, k0 .. +BK]
    if constexpr (PA) {
#pragma unroll
      for (int u = 0; u < BM * BK / 4 / MIX_THREADS; ++u) {
        const int e = tid + u * MIX_THREADS, r = e / (BK / 4),
                  c = (e % (BK / 4)) * 4;
        const bool ok = row0 + r < W && k0 + c < W;
        cp16(smem_u32(sA + r * AS + c),
             P + (ok ? static_cast<int64_t>(row0 + r) * W + k0 + c : 0), ok);
      }
    } else {
#pragma unroll 4
      for (int u = 0; u < BM * BK / MIX_THREADS; ++u) {
        const int e = tid + u * MIX_THREADS, r = e / BK, c = e % BK;
        const bool ok = row0 + r < W && k0 + c < W;
        cp4(smem_u32(sA + r * AS + c),
            P + (ok ? static_cast<int64_t>(row0 + r) * W + k0 + c : 0), ok);
      }
    }
    // w[k0 .. +BK, col0 .. +BN]
    if constexpr (WA) {
      constexpr int E = 16 / sizeof(T), PER_ROW = BN / E;
#pragma unroll
      for (int u = 0; u < (BK * PER_ROW + MIX_THREADS - 1) / MIX_THREADS;
           ++u) {
        const int e = tid + u * MIX_THREADS;
        if (e < BK * PER_ROW) {
          const int r = e / PER_ROW, c = (e % PER_ROW) * E;
          const bool ok = k0 + r < W && col0 + c < F;
          cp16(smem_u32(sB + r * BS + c),
               w + (ok ? static_cast<int64_t>(k0 + r) * F + col0 + c : 0),
               ok);
        }
      }
    } else if constexpr (WIDE) {
#pragma unroll 4
      for (int u = 0; u < BK * BN / MIX_THREADS; ++u) {
        const int e = tid + u * MIX_THREADS, r = e / BN, c = e % BN;
        const bool ok = k0 + r < W && col0 + c < F;
        cp4(smem_u32(sB + r * BS + c),
            w + (ok ? static_cast<int64_t>(k0 + r) * F + col0 + c : 0), ok);
      }
    } else {
      const Bt* wb = reinterpret_cast<const Bt*>(w);
      Bt* sb = reinterpret_cast<Bt*>(sB);
      // four loads in flight at a time: eight cost the registers of the
      // fragments
#pragma unroll 1
      for (int u0 = 0; u0 < BK * BN / MIX_THREADS; u0 += 4) {
        Bt v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = tid + (u0 + u) * MIX_THREADS, r = e / BN, c = e % BN;
          v[u] = k0 + r < W && col0 + c < F
                     ? wb[static_cast<int64_t>(k0 + r) * F + col0 + c]
                     : Bt(0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = tid + (u0 + u) * MIX_THREADS;
          sb[(e / BN) * BS + e % BN] = v[u];
        }
      }
    }
  };

  float acc[MT][NT][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1 is read by everyone
    if (kt + STAGES - 1 < nk) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_commit();
    const unsigned char* stage = smem + (kt % STAGES) * K::STAGE;
    const float* sA = reinterpret_cast<const float*>(stage) +
                      (wm * 16 * MT + g) * AS + t;
    const T* sB = reinterpret_cast<const T*>(stage + K::A_BYTES) + t * BS +
                  wn * 8 * NT + g;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* a = sA + mt * 16 * AS + kk;
        split(a[0], ah[mt][0], al[mt][0]);
        split(a[8 * AS], ah[mt][1], al[mt][1]);
        split(a[4], ah[mt][2], al[mt][2]);
        split(a[8 * AS + 4], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const T* b = sB + kk * BS + nt * 8;
        const float b0 = to_f32(b[0]), b1 = to_f32(b[4 * BS]);
        uint32_t bh[2], bl[2];
        if constexpr (WIDE) {
          split(b0, bh[0], bl[0]);
          split(b1, bh[1], bl[1]);
        } else {  // exact in TF32: no lo part
          bh[0] = __float_as_uint(b0);
          bh[1] = __float_as_uint(b1);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_tf32(acc[mt][nt], al[mt], bh);
          if constexpr (WIDE) mma_tf32(acc[mt][nt], ah[mt], bl);
          mma_tf32(acc[mt][nt], ah[mt], bh);
        }
      }
    }
  }
  cp_wait<0>();

  const bool pairs = (F & 1) == 0;  // out rows 8-byte aligned
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row0 + wm * 16 * MT + mt * 16 + g + 8 * half;
      if (r >= W) continue;
      float* o = out + static_cast<int64_t>(r) * F;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int64_t c = col0 + wn * 8 * NT + nt * 8 + 2 * t;
        const float v0 = acc[mt][nt][2 * half], v1 = acc[mt][nt][2 * half + 1];
        if (pairs && c + 1 < F) {
          *reinterpret_cast<float2*>(o + c) = make_float2(v0, v1);
        } else {
          if (c < F) o[c] = v0;
          if (c + 1 < F) o[c + 1] = v1;
        }
      }
    }
  }
}

// ------------------------------------------------------------------ launch

// Raises the kernel's dynamic shared-memory limit to `bytes` once per
// device, outside any CUDA-graph capture (the first launch on a device
// is never captured: capture follows a warm-up call).
template <typename Kern>
int configure(Kern kern, int bytes, bool (&configured)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  return 0;
}

template <typename T, int R>
int launch_stream_r(const float* P, const void* w, float* out, int W,
                    int64_t F, int cols, int flags, int smem,
                    cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  const int rc = configure(stream_mix_kernel<T, R>, kSmemMax, configured);
  if (rc != 0) return rc;
  const int64_t grid = (F + cols - 1) / cols;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  stream_mix_kernel<T, R><<<static_cast<unsigned>(grid), MIX_THREADS, smem,
                            stream>>>(P, static_cast<const T*>(w), out, W, F,
                                      cols, flags);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stream(const float* P, const void* w, float* out, int W,
                  int64_t F, int cols, int flags, int smem,
                  cudaStream_t stream) {
  if ((cols != 16 && cols != 32 && cols != 64 && cols != 128) ||
      smem != stream_smem_bytes<T>(W, cols) || smem > kSmemMax)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t lanes = static_cast<int64_t>(W) * (cols / 4);
  if (lanes <= MIX_THREADS)
    return launch_stream_r<T, 1>(P, w, out, W, F, cols, flags, smem, stream);
  if (lanes <= 2 * MIX_THREADS)
    return launch_stream_r<T, 2>(P, w, out, W, F, cols, flags, smem, stream);
  return launch_stream_r<T, 4>(P, w, out, W, F, cols, flags, smem, stream);
}

template <typename T, bool PA, bool WA>
int launch_tile_as(const float* P, const void* w, float* out, int W,
                   int64_t F, int smem, cudaStream_t stream) {
  static bool configured[kMaxDevices] = {};
  auto kern = tile_mix_kernel<T, PA, WA>;
  const int rc = configure(kern, smem, configured);
  if (rc != 0) return rc;
  const int n_rt = (W + BM - 1) / BM;
  const int64_t grid = n_rt * ((F + BN - 1) / BN);
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(grid), MIX_THREADS, smem, stream>>>(
      P, static_cast<const T*>(w), out, W, F, n_rt);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_tile(const float* P, const void* w, float* out, int W, int64_t F,
                int flags, int smem, cudaStream_t stream) {
  if (smem != TileCfg<T>::SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const bool pa = flags & kPRows16, wa = flags & kWRows16;
  if (pa && wa) return launch_tile_as<T, true, true>(P, w, out, W, F, smem, stream);
  if (pa) return launch_tile_as<T, true, false>(P, w, out, W, F, smem, stream);
  if (wa) return launch_tile_as<T, false, true>(P, w, out, W, F, smem, stream);
  return launch_tile_as<T, false, false>(P, w, out, W, F, smem, stream);
}

template <typename T>
int launch_dense(const float* P, const void* w, float* out, int W, int64_t F,
                 int regime, int cols, int flags, int smem,
                 cudaStream_t stream) {
  if (regime == 0)
    return launch_stream<T>(P, w, out, W, F, cols, flags, smem, stream);
  if (regime == 1)
    return launch_tile<T>(P, w, out, W, F, flags, smem, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace
}  // namespace gossip

// regime 0 (stream) or 1 (tile); cols: the stream regime's slice width;
// flags: kWRows16 | kOutRows16 | kPRows16; smem: dynamic shared-memory
// bytes, which must equal the regime's own reckoning.
extern "C" int gossip_mix_launch(const void* P, const void* w, void* out,
                                 int W, long long F, int dtype, int regime,
                                 int cols, int flags, int smem,
                                 void* stream) {
  using namespace gossip;
  const auto* p = static_cast<const float*>(P);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_dense<float>(p, w, o, W, F, regime, cols, flags, smem, s);
    case kBF16:
      return launch_dense<__nv_bfloat16>(p, w, o, W, F, regime, cols, flags,
                                         smem, s);
    case kI8:
      return launch_dense<int8_t>(p, w, o, W, F, regime, cols, flags, smem,
                                  s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
