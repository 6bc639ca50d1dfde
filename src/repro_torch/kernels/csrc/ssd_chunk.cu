// ssd_chunk — Mamba2 SSD intra-chunk term on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py, ssd_chunk_pallas:
//   y[g, h, q, :] = sum_{k <= q} (C[g, q] . B[g, k])
//                   * exp(acum[g, h, q] - acum[g, h, k]) * dt[g, h, k]
//                   * x[g, h, k, :]
// with C, B [G, T, N], acum, dt [G, H, T] contiguous and x, y [G, H, T, P]
// addressed through (g, h, t) strides (P contiguous), all fp32. In the model
// x and y are views of [G, T, H, P] tensors, read and written without
// copies.
//
// Bound on an H100: at the serving path's shape [G, H, T, N, P] = [32, 48,
// 256, 128, 64] the work is 2*N flops per causal (q, k) pair for the scores
// and 2*P + 4 per pair and head for the weights and w . x: 6.9 GFLOP, 104 us
// at the fp32 CUDA-core peak, against 213 MB of traffic (x and y dominate),
// 64 us at 3.35 TB/s. So operations bound it. This kernel is the simple,
// right first version: fp32 FMAs on the CUDA cores (no TF32, as the port's
// fp32 rule asks), no tensor cores, no TMA.
//
// Design: one 256-thread block per (64-query tile, group of HG = 8 heads, g).
// The TPU grid is (g, h) and recomputes C . B^T for every head (48x the
// score flops at H = 48); here the block computes the score row-block
// C[q tile] . B[k < q0 + 64]^T once into shared memory (64 x up to 256
// fp32), N in chunks of 16, and then loops over its heads. For each head it
// stages the key tile's x rows (64 x P) and the 64 x 64 weight tile
// w[q, k] = score * exp(acum[q] - acum[k]) * dt[k], masked to k <= q < T
// before the exponent is taken (acum falls by up to ~33 per step in the
// real model, so exp(acum[q]) * exp(-acum[k]) would overflow to inf and
// give NaN), and accumulates w . x into a 64 x P fp32 tile in registers:
// thread (ty, tx) owns rows ty + 16m (m < 4) and columns tx + 16j
// (j < P/16). Key tiles above the diagonal are skipped. Rows at or past T
// are zero-filled and masked, so a ragged T (e.g. 200) needs no padding.
// Query tiles run in reverse order of blockIdx.x, so the blocks with the
// most key tiles start first.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ssd {

constexpr int BQ = 64, BK = 64, THREADS = 256, HG = 8, NC = 16;
constexpr int MAX_T = 256;
constexpr int CB_STRIDE = NC + 1;  // 16 rows read at one column: 16 banks
constexpr int W_STRIDE = BK + 4;   // two rows a warp reads: other banks
constexpr int kMaxDevices = 64;

// Row stride of the score row-block: T rounded up to a key tile, + 16, so
// the two rows a warp writes land 16 banks apart.
__host__ __device__ inline int score_stride(int T) {
  return (T + BK - 1) / BK * BK + 16;
}

// Shared memory: the scores, then acum and dt of one head (MAX_T each),
// then a work area that holds either the C and B chunks (score phase) or
// the x tile and the weight tile (head phase).
template <int P>
__host__ __device__ inline size_t smem_bytes(int T) {
  const size_t work_cb = 2 * BQ * CB_STRIDE;
  const size_t work_xw = BK * P + BQ * W_STRIDE;
  return (BQ * static_cast<size_t>(score_stride(T)) + 2 * MAX_T +
          (work_cb > work_xw ? work_cb : work_xw)) *
         sizeof(float);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <int P>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ C, const float* __restrict__ B,
                 const float* __restrict__ acum, const float* __restrict__ dt,
                 const float* __restrict__ x, float* __restrict__ y, int H,
                 int T, int N, int64_t sxg, int64_t sxh, int64_t sxt,
                 int64_t syg, int64_t syh, int64_t syt) {
  constexpr int DP = P / 16;
  extern __shared__ __align__(16) float smem[];
  const int SS = score_stride(T);
  float* sS = smem;                  // [BQ][SS] scores C[q] . B[k]
  float* sA = sS + BQ * SS;          // [MAX_T] acum of one head
  float* sDt = sA + MAX_T;           // [MAX_T] dt of one head
  float* work = sDt + MAX_T;
  float* sC = work;                  // [BQ][CB_STRIDE]
  float* sB = sC + BQ * CB_STRIDE;   // [BK][CB_STRIDE]
  float* sX = work;                  // [BK][P]
  float* sW = sX + BK * P;           // [BQ][W_STRIDE]

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int q0 = qt * BQ;
  const int h0 = blockIdx.y * HG;
  const int g = blockIdx.z;
  const int kend = min(T, q0 + BQ);  // keys some query of the tile sees
  const float* Cg = C + static_cast<int64_t>(g) * T * N;
  const float* Bg = B + static_cast<int64_t>(g) * T * N;

  // ---- scores of the query tile against key tiles 0..qt, once ----
  for (int kt = 0; kt <= qt; ++kt) {
    const int k0 = kt * BK;
    float sc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n) sc[m][n] = 0.f;
    for (int n0 = 0; n0 < N; n0 += NC) {
      __syncthreads();  // the previous chunk's reads are done
      {
        // 64 rows x 16 columns of C and of B: one float4 of each a thread
        const int r = tid / 4, c = (tid % 4) * 4;
        float4 cv = make_float4(0.f, 0.f, 0.f, 0.f), bv = cv;
        if (q0 + r < T) cv = load4(Cg + static_cast<int64_t>(q0 + r) * N +
                                   n0 + c);
        if (k0 + r < T) bv = load4(Bg + static_cast<int64_t>(k0 + r) * N +
                                   n0 + c);
        float* dc = sC + r * CB_STRIDE + c;
        float* db = sB + r * CB_STRIDE + c;
        dc[0] = cv.x; dc[1] = cv.y; dc[2] = cv.z; dc[3] = cv.w;
        db[0] = bv.x; db[1] = bv.y; db[2] = bv.z; db[3] = bv.w;
      }
      __syncthreads();
#pragma unroll
      for (int d = 0; d < NC; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) a[m] = sC[(ty + 16 * m) * CB_STRIDE + d];
#pragma unroll
        for (int n = 0; n < 4; ++n) b[n] = sB[(tx + 16 * n) * CB_STRIDE + d];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n) sc[m][n] = fmaf(a[m], b[n], sc[m][n]);
      }
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 4; ++n)
        sS[(ty + 16 * m) * SS + k0 + tx + 16 * n] = sc[m][n];
  }

  // ---- per head: w . x over the key tiles 0..qt ----
  for (int hi = 0; hi < HG; ++hi) {
    const int h = h0 + hi;
    if (h >= H) break;
    const int64_t gh = static_cast<int64_t>(g) * H + h;
    __syncthreads();  // the previous head's reads of sA, sDt, sX, sW done
    for (int i = tid; i < kend; i += THREADS) {
      sA[i] = acum[gh * T + i];
      sDt[i] = dt[gh * T + i];
    }
    const float* xh = x + g * sxg + h * sxh;

    float acc[4][DP];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int j = 0; j < DP; ++j) acc[m][j] = 0.f;

    for (int kt = 0; kt <= qt; ++kt) {
      const int k0 = kt * BK;
      __syncthreads();  // sA/sDt loaded; the previous tile's reads done
      // x rows k0..k0+63 of head h (zero past T), a float4 at a time
      for (int e = tid; e < BK * P / 4; e += THREADS) {
        const int r = e / (P / 4), c = (e % (P / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + r < T) v = load4(xh + (k0 + r) * sxt + c);
        *reinterpret_cast<float4*>(sX + r * P + c) = v;
      }
      // the weight tile, masked to k <= q < T before the exponent
      for (int e = tid; e < BQ * BK; e += THREADS) {
        const int r = e / BK, c = e % BK;
        const int qpos = q0 + r, kpos = k0 + c;
        float w = 0.f;
        if (kpos <= qpos && qpos < T)
          w = sS[r * SS + kpos] * expf(sA[qpos] - sA[kpos]) * sDt[kpos];
        sW[r * W_STRIDE + c] = w;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float w[4], xv[DP];
#pragma unroll
        for (int m = 0; m < 4; ++m) w[m] = sW[(ty + 16 * m) * W_STRIDE + kk];
#pragma unroll
        for (int j = 0; j < DP; ++j) xv[j] = sX[kk * P + tx + 16 * j];
#pragma unroll
        for (int m = 0; m < 4; ++m)
#pragma unroll
          for (int j = 0; j < DP; ++j) acc[m][j] = fmaf(w[m], xv[j], acc[m][j]);
      }
    }

    float* yh = y + g * syg + h * syh;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int qpos = q0 + ty + 16 * m;
      if (qpos >= T) continue;
#pragma unroll
      for (int j = 0; j < DP; ++j) yh[qpos * syt + tx + 16 * j] = acc[m][j];
    }
  }
}

template <int P>
int launch(const float* C, const float* B, const float* acum, const float* dt,
           const float* x, float* y, int G, int H, int T, int N, int64_t sxg,
           int64_t sxh, int64_t sxt, int64_t syg, int64_t syh, int64_t syt,
           cudaStream_t stream) {
  auto kern = ssd_chunk_kernel<P>;
  // raise the dynamic shared-memory limit to the largest T once per device,
  // outside any CUDA-graph capture (the first launch on a device is never
  // captured: capture follows a warm-up call)
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<P>(MAX_T)));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  const dim3 grid(static_cast<unsigned>((T + BQ - 1) / BQ),
                  static_cast<unsigned>((H + HG - 1) / HG),
                  static_cast<unsigned>(G));
  kern<<<grid, THREADS, smem_bytes<P>(T), stream>>>(
      C, B, acum, dt, x, y, H, T, N, sxg, sxh, sxt, syg, syh, syt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd

// C, B [G, T, N] and acum, dt [G, H, T] contiguous; x and y [G, H, T, P]
// with element strides (sxg, sxh, sxt) and (syg, syh, syt), P contiguous.
// N a multiple of 16, P in {16, 32, 64}, 1 <= T <= 256 (checked by the
// wrapper, kernels/ops.py).
extern "C" int ssd_chunk_launch(const void* C, const void* B,
                                const void* acum, const void* dt,
                                const void* x, void* y, int G, int H, int T,
                                int N, int P, long long sxg, long long sxh,
                                long long sxt, long long syg, long long syh,
                                long long syt, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (T < 1 || T > ssd::MAX_T || N % ssd::NC != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = static_cast<const float*>(C);
  const auto* b = static_cast<const float*>(B);
  const auto* a = static_cast<const float*>(acum);
  const auto* d = static_cast<const float*>(dt);
  const auto* xi = static_cast<const float*>(x);
  auto* yo = static_cast<float*>(y);
  switch (P) {
    case 16: return ssd::launch<16>(c, b, a, d, xi, yo, G, H, T, N, sxg, sxh,
                                    sxt, syg, syh, syt, s);
    case 32: return ssd::launch<32>(c, b, a, d, xi, yo, G, H, T, N, sxg, sxh,
                                    sxt, syg, syh, syt, s);
    case 64: return ssd::launch<64>(c, b, a, d, xi, yo, G, H, T, N, sxg, sxh,
                                    sxt, syg, syh, syt, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
