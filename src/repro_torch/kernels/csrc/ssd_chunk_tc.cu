// ssd_chunk_tc — Mamba2 SSD intra-chunk term on Hopper's tensor cores
// (sm_90a), fp32-accurate through 3xTF32, with asynchronous loads.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py, ssd_chunk_pallas:
//   y[g, h, q, :] = sum_{k <= q} (C[g, q] . B[g, k])
//                   * exp(acum[g, h, q] - acum[g, h, k]) * dt[g, h, k]
//                   * x[g, h, k, :]
// with C, B [G, T, N], acum, dt [G, H, T] contiguous and x, y [G, H, T, P]
// addressed through (g, h, t) strides (P contiguous), all fp32. In the model
// x and y are views of [G, T, H, P] tensors, read and written in place. It
// takes N in {16, 32, 64, 128}, P in {16, 32, 64}, 1 <= T <= 256.
//
// P = 16 (no model runs it) takes the same design with one 8-column n-tile
// of W . X a CTA half where P = 32 takes two (scalar X loads, float2
// stores). Measured on the H100 (PERF.md, Findings): at [32, 192, 256, 128,
// 16] (HG = 48 heads a CTA; head groups for 1 or 4 CTAs an SM time slower)
// 503.7 us against 1,440.4 for the SIMT kernel that held P = 16 before,
// and at [2, 12, 100, 32, 16] 10.9 against 54.9, so that kernel was
// deleted. It is 7.6x its 66.4 us byte bound there: the W . X phase, 240
// items a CTA with two barriers and little work each, not the products,
// holds it (two of the three product passes taken out save 17 %).
//
// Bound on an H100 SXM, at the serving path's shape [G, H, T, N, P] =
// [32, 48, 256, 128, 64]: C, B, acum, dt and x read and y written once are
// 212.86 MB, 63.54 us at 3.35 TB/s. The products are 2N flops per causal
// (q, k) pair for the scores and 2P per pair and head for W . X, 6.74 GFLOP;
// run as three TF32 products each, 40.8 us at the dense TF32 rate of 495
// TFLOP/s. The exponent and the two scalings (4 per pair and head, 0.20
// GFLOP) are 3.0 us at 67 TFLOP/s on the CUDA cores. So bytes bound it, at
// 63.54 us; the fp32 CUDA-core figure of the SIMT kernel (103.57 us) is not
// a floor for a kernel on the tensor cores.
//
// 3xTF32. The port keeps fp32 products fp32-accurate (no plain TF32). Each
// fp32 operand v is split into hi, v rounded to TF32 (to nearest, ties away
// from zero, as cvt.rna.tf32.f32 rounds; done here with an integer add and
// mask, two instructions), and lo = v - hi, exact in fp32, which the
// tensor cores read truncated to TF32. A product is the sum of three
// tensor-core products, lo.hi' + hi.lo' + hi.hi', the small terms first,
// accumulated in fp32: the split CUTLASS's "fast fp32" warp MMA uses
// (cutlass/gemm/warp/mma_tensor_op_fast_f32.h). Dropping lo.lo' and
// truncating lo leave a relative error of about 2^-20 per product, against
// 2^-11 for one TF32 product; chip_smoke's limit, 1e-5 * max|y|, holds with
// room (the worst case on the card is 0.15 of it, the CPU emulation in the
// tests shows one TF32 product breaking it 40x). It costs three products
// and, per operand element, three integer or fp32 instructions, done in
// registers as the fragments are read.
//
// Design, against what held the SIMT kernel back (6.1x its bound):
// - Products on the tensor cores: mma.sync.m16n8k8.tf32 for both S = C.B^T
//   (over N) and Y += W . X (over the keys). Not wgmma: for 32-bit types
//   wgmma reads B only K-major from shared memory, so X [keys x P] would be
//   staged transposed, and 3xTF32 would need the hi and lo parts of B and X
//   staged as separate shared-memory tiles (twice the memory, an extra pass
//   through it). mma.sync takes every operand from registers, so the split
//   is done on the fragments as they are read, X is read straight from a
//   P-contiguous tile, and the W fragment is built from the score
//   accumulator in place: the accumulator holds keys (2t, 2t + 1) of rows
//   (g, g + 8) where the TF32 A fragment wants k-slots (t, t + 4), so k-slot
//   t is key 2t and slot t + 4 is key 2t + 1, and the X fragment is read at
//   those keys. The k-slots of C.B^T pair state columns the same way, and
//   the n-tiles of W.X interleave columns (tile 2m + b takes 16m + 2c + b),
//   so every fragment pair is one 8-byte load and Y leaves in 16-byte
//   stores.
// - Scores once per (g, query tile, head group): a CTA computes the score
//   row-block of its 64-query tile against every key tile at or below the
//   diagonal once, keeps it in shared memory in fragment order (each warp
//   reads back 512 contiguous bytes), and reuses it for HG heads. HG is
//   chosen on the host so that about two CTAs per SM are launched: at
//   [32, 48, ...] HG = 12 (scores computed 4x, against 6x), at G = 64
//   HG = 24 (2x), at Jamba's [16, 128, 256, 16, 64] HG = 16.
// - Eight warps: warp w + 4 half owns query rows 16w..16w+15; the two
//   halves split a key tile's 8-key blocks for the scores and P's columns
//   for W . X (each computes W for its rows). 256 threads at <= 128
//   registers and ~112 KB of shared memory: two CTAs, 16 warps per SM.
// - The decay without an exponent per element: below the diagonal tile,
//   with c = acum at the last key of k's tile, exp(acum[q] - acum[k]) =
//   exp(acum[q] - c) * exp(c - acum[k]), both factors at most 1 (no
//   overflow; if either underflows, so does the product). The key factor
//   exp(c - acum[k]) * dt[k] is computed once per head and key (expf), the
//   row factor once per row and tile, and w is two products; that loop has
//   no branch. On the diagonal tile w is masked to k <= q before the
//   exponent (2^x on the SFU: ex2.approx, ~2^-22 relative, plus |x| 2^-24
//   from rounding x log2 e): the masked difference is -inf, never the
//   positive one (acum falls to -27,644 on the real model's last head), and
//   the select keeps unloaded shared memory out.
// - Diagonal tiles: warp w skips the 8-key blocks above its rows in W . X,
//   so only the 8 x 8 blocks that straddle the diagonal carry masked zeros
//   (the score phase computes them, a few products, to stay branch-free).
// - Balanced causal work: a CTA takes query tiles i and n_qt - 1 - i of one
//   (g, head group), so every CTA at T = 256 runs 5 key tiles per head. The
//   CTAs of one (g, head group) are adjacent in the grid, so the x tiles
//   they all read are shared in L2.
// - Asynchronous loads: the C and B chunks of the score phase and the x
//   tile (with acum and dt at a head's first tile) of the head phase are
//   copied with cp.async into a ring of two stages, the next tile in
//   flight while the current one is multiplied. Rows at or past T are
//   zero-filled by the copy (src-size 0), so a ragged T needs no padding,
//   and a key past T can never bring a NaN from memory into W . X (where
//   0 * NaN would spread to every row). Rows of W at or past T may hold
//   garbage; it stays in those rows of Y, which are never written.
// - The output is written once per element from registers through y's
//   strides; (h, t) offsets inside a g slice are 32-bit (checked).
//
// What holds it now (PERF.md, Findings): ~3.8x the byte bound at the main
// shape. Taking out two of the three product passes of W . X saves over
// a quarter of the time, taking out exponents or splits little: the
// mma.sync products issue far below the rate mma.sync TF32 reaches alone
// on this card (benchmarks/ssd_tc_probe.py measures both).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cstdlib>

#include "common.cuh"

namespace ssd_tc {

constexpr int BQ = 64, BK = 64;   // query rows per tile, keys per tile
// 8 warps: warp w + 4 * half takes query rows 16w..16w+15 of the tile and
// half of the score tile's key blocks, then half of P's columns of W . X
constexpr int WARPS = 8, THREADS = 32 * WARPS;
constexpr int FRAGS = 4 * 32;  // (row group, lane): one score fragment each
constexpr int CTAS_PER_SM = 2;
constexpr int MAX_T = 256;
constexpr int kMaxDevices = 64;

// Shared-memory floats: one ring stage holds the C and B chunks (64 rows of
// NC, row stride NC + 8) or one x tile (64 keys of P, row stride P + 4);
// the strides keep a warp's fragment loads free of bank conflicts.
template <int NC, int P>
struct Cfg {
  static constexpr int CS = NC + 8, XS = P + 4;
  static constexpr int SCORE_STAGE = 2 * BQ * CS, X_STAGE = BK * XS;
  static constexpr int STAGE =
      SCORE_STAGE > X_STAGE ? SCORE_STAGE : X_STAGE;
};

// scores (8 blocks of 8 keys per key tile, a float4 per fragment slot),
// the ring, acum and dt of two heads, the key factors of one
template <int NC, int P>
__host__ __device__ inline size_t smem_bytes(int T) {
  const int n_qt = (T + BQ - 1) / BQ;
  return sizeof(float) * (static_cast<size_t>(n_qt) * 8 * FRAGS * 4 +
                          2 * Cfg<NC, P>::STAGE + 5 * n_qt * BQ);
}

// the asynchronous copies, the 3xTF32 split and the mma.sync product are
// common.cuh's, shared with the dense gossip mix
using gossip::cp16;
using gossip::cp_commit;
using gossip::mma_tf32;
using gossip::smem_u32;
using gossip::split;
// 4 bytes from global to shared memory
__device__ __forceinline__ void cp4(uint32_t dst, const void* src) {
  gossip::cp4(dst, src, true);
}
// all but the newest group complete
__device__ __forceinline__ void cp_wait_prev() { gossip::cp_wait<1>(); }

// e^x as 2^(x log2 e) on the SFU (ex2.approx: relative error ~2^-22; the
// rounding of x log2 e adds |x| 2^-24 relative, below 1e-6 for |x| < 16,
// where the terms that reach y are; e^-inf = 0)
__device__ __forceinline__ float fast_exp(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Fragments of mma.m16n8k8 (lane = 4 gq + tq): A a0 (gq, tq), a1 (gq + 8,
// tq), a2 (gq, tq + 4), a3 (gq + 8, tq + 4); B b0 (k tq, n gq), b1 (k tq +
// 4, n gq); the accumulator c0, c1 (gq, 2tq + {0, 1}), c2, c3 (gq + 8, 2tq
// + {0, 1}).
template <int NC, int P>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
    ssd_tc_kernel(const float* __restrict__ C, const float* __restrict__ B,
                  const float* __restrict__ acum,
                  const float* __restrict__ dt, const float* __restrict__ x,
                  float* __restrict__ y, int H, int T, int N, int HG,
                  int n_hg, int n_pairs, int64_t sxg, int sxh, int sxt,
                  int64_t syg, int syh, int syt) {
  using K = Cfg<NC, P>;
  // NH: 8-column n-tiles of W . X a CTA half
  constexpr int CS = K::CS, XS = K::XS, STAGE = K::STAGE, NH = P / 16;
  extern __shared__ __align__(16) float smem[];
  const int n_qt = (T + BQ - 1) / BQ, TP = n_qt * BQ;
  float* sS = smem;                         // [n_qt * 8][FRAGS] float4
  float* ring = sS + n_qt * 8 * FRAGS * 4;  // [2][STAGE]
  float* sA = ring + 2 * STAGE;              // [2][TP] acum of two heads
  float* sDt = sA + 2 * TP;                  // [2][TP] dt of two heads
  float* sCk = sDt + 2 * TP;  // [TP] key factors of the head (see below)

  const int tid = threadIdx.x, lane = tid % 32;
  const int rw = (tid / 32) % 4, half = tid / 128;  // row group, half
  const int frag = rw * 32 + lane;                  // score fragment slot
  const int gq = lane / 4, tq = lane % 4;
  int bid = static_cast<int>(blockIdx.x);
  const int pair = bid % n_pairs;
  bid /= n_pairs;
  const int hg = bid % n_hg, g = bid / n_hg;
  const int h0 = hg * HG, n_heads = min(H, h0 + HG) - h0;
  const float* Cg = C + static_cast<int64_t>(g) * T * N;
  const float* Bg = B + static_cast<int64_t>(g) * T * N;
  const float* Ag = acum + static_cast<int64_t>(g) * H * T;
  const float* Dg = dt + static_cast<int64_t>(g) * H * T;
  const float* xg = x + g * sxg;
  float* yg = y + g * syg;
  const int n_nc = N / NC;

  for (int side = 0; side < 2; ++side) {
    const int qt = side == 0 ? n_qt - 1 - pair : pair;
    if (side == 1 && qt == n_qt - 1 - pair) break;  // the middle tile
    const int q0 = qt * BQ, kend = min(T, q0 + BQ), nkt = qt + 1;
    const int qr0 = q0 + 16 * rw + gq, qr1 = qr0 + 8;  // this thread's rows
    const bool busy = q0 + 16 * rw < T;  // the warp has a row below T
    const int kb_diag = 2 * rw + 1;      // last 8-key block of the diagonal
    __syncthreads();  // the previous tile's reads of sS, the ring, sA done

    // ---------------------------------------------- scores S = C . B^T
    // items (key tile kt, N chunk c): C rows q0.., B rows kt * BK.., NC wide
    auto load_cb = [&](int item, int stage) {
      constexpr int CH = NC / 4;
      const int kt = item / n_nc, c0 = (item % n_nc) * NC;
      float* sC = ring + stage * STAGE;
      for (int e = tid; e < 2 * BQ * CH; e += THREADS) {
        const int which = e / (BQ * CH), r = (e / CH) % BQ, c = (e % CH) * 4;
        const int row = (which ? kt * BK : q0) + r;
        const bool ok = row < T;
        const float* src = (which ? Bg : Cg) +
                           static_cast<int64_t>(ok ? row : 0) * N + c0 + c;
        cp16(smem_u32(sC + which * BQ * CS + r * CS + c), src, ok);
      }
    };
    const int n_items = nkt * n_nc;
    float sc[4][4];  // key blocks 2i + half of the key tile
    load_cb(0, 0);
    cp_commit();
    for (int it = 0; it < n_items; ++it) {
      if (it + 1 < n_items) load_cb(it + 1, (it + 1) & 1);
      cp_commit();
      cp_wait_prev();
      __syncthreads();
      const int kt = it / n_nc, c = it % n_nc;
      if (c == 0) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
      }
      if (busy) {
        const float* sC = ring + (it & 1) * STAGE;
        const float* sB = sC + BQ * CS;
#pragma unroll
        for (int ks = 0; ks < NC / 8; ++ks) {
          // k-slots tq and tq + 4 are state columns 2tq and 2tq + 1 of
          // the chunk (for C and B alike), so each pair is one 8-byte load
          const float* cr = sC + (16 * rw + gq) * CS + 8 * ks + 2 * tq;
          const float2 c0 = *reinterpret_cast<const float2*>(cr);
          const float2 c1 = *reinterpret_cast<const float2*>(cr + 8 * CS);
          uint32_t ah[4], al[4];
          split(c0.x, ah[0], al[0]);
          split(c1.x, ah[1], al[1]);
          split(c0.y, ah[2], al[2]);
          split(c1.y, ah[3], al[3]);
          // 3xTF32, the small terms first; a pass over the key blocks
          // between two dependent products. Blocks above the diagonal are
          // computed too (a few products, no branch) and never read.
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float2 b = *reinterpret_cast<const float2*>(
                sB + (8 * (2 * i + half) + gq) * CS + 8 * ks + 2 * tq);
            split(b.x, bh[i][0], bl[i][0]);
            split(b.y, bh[i][1], bl[i][1]);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(sc[i], al, bh[i]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(sc[i], ah, bl[i]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_tf32(sc[i], ah, bh[i]);
        }
        if (c == n_nc - 1) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(
                sS + ((kt * 8 + 2 * i + half) * FRAGS + frag) * 4) =
                make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
        }
      }
      __syncthreads();  // this stage is free for item it + 2
    }

    // ---------------------------------------------- per head: Y = W . X
    // items (head hi, key tile kt); acum and dt come with a head's tile 0
    auto load_x = [&](int item, int stage) {
      constexpr int CH = P / 4;
      const int hi = item / nkt, kt = item % nkt, h = h0 + hi;
      const float* xh = xg + h * sxh;
      float* sX = ring + stage * STAGE;
      for (int e = tid; e < BK * CH; e += THREADS) {
        const int r = e / CH, c = (e % CH) * 4, k = kt * BK + r;
        const bool ok = k < T;
        cp16(smem_u32(sX + r * XS + c), xh + (ok ? k : 0) * sxt + c, ok);
      }
      if (kt == 0) {
        float* a = sA + (hi & 1) * TP;
        float* d = sDt + (hi & 1) * TP;
        for (int e = tid; e < kend; e += THREADS) {
          cp4(smem_u32(a + e), Ag + h * T + e);
          cp4(smem_u32(d + e), Dg + h * T + e);
        }
      }
    };
    const int n_items2 = n_heads * nkt;
    float acc[NH][4];  // n-tiles of this warp's half of P
    float aq0 = 0.f, aq1 = 0.f;  // acum at this thread's two query rows
    load_x(0, 0);
    cp_commit();
    for (int it = 0; it < n_items2; ++it) {
      if (it + 1 < n_items2) load_x(it + 1, (it + 1) & 1);
      cp_commit();
      cp_wait_prev();
      __syncthreads();
      const int hi = it / nkt, kt = it % nkt;
      const float* a = sA + (hi & 1) * TP;
      const float* d = sDt + (hi & 1) * TP;
      if (kt == 0) {
#pragma unroll
        for (int n = 0; n < NH; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
        aq0 = qr0 < T ? a[qr0] : 0.f;
        aq1 = qr1 < T ? a[qr1] : 0.f;
        // below the diagonal the decay factors: with c = acum at the last
        // key of k's tile (k <= c's key < q), exp(acum[q] - acum[k]) =
        // exp(acum[q] - c) * exp(c - acum[k]), both at most 1; the key
        // factor exp(c - acum[k]) * dt[k] once per head and key
        for (int e = tid; e < q0; e += THREADS)
          sCk[e] = expf(a[e | (BK - 1)] - a[e]) * d[e];
        __syncthreads();
      }
      if (busy) {
        const float* sX = ring + (it & 1) * STAGE;
        const int kb_max = kt == qt ? kb_diag : 7;
        // off the diagonal: no mask, factored decay. Rows at or past T are
        // never written, and a non-finite value in such a row of W (from
        // unloaded acum or dt) stays in that row of Y, so neither path
        // checks q < T.
        const bool full = kt < qt;
        float r0 = 0.f, r1 = 0.f;  // the row factors exp(acum[q] - c)
        if (full) {
          const float c = a[kt * BK + BK - 1];
          r0 = expf(aq0 - c);
          r1 = expf(aq1 - c);
        }
        // Y += W . X over 8-key block j, W given as the fragment's four
        // values: row gq keys 2tq, 2tq + 1, then row gq + 8 the same
        auto block = [&](int j, float w00, float w01, float w10, float w11) {
          // A fragment: k-slot tq is key 2tq, k-slot tq + 4 is key 2tq + 1
          uint32_t ah[4], al[4];
          split(w00, ah[0], al[0]);
          split(w10, ah[1], al[1]);
          split(w01, ah[2], al[2]);
          split(w11, ah[3], al[3]);
          if constexpr (NH == 1) {  // P = 16: column 8 half + gq
            const float* xr = sX + (8 * j + 2 * tq) * XS + 8 * half + gq;
            uint32_t bh[2], bl[2];
            split(xr[0], bh[0], bl[0]);
            split(xr[XS], bh[1], bl[1]);
            mma_tf32(acc[0], al, bh);
            mma_tf32(acc[0], ah, bl);
            mma_tf32(acc[0], ah, bh);
            return;
          }
          // n-tiles 2m and 2m + 1 take columns 16m + 2gq and 16m + 2gq + 1
          // of the warp's half: one 8-byte load for both
          const float* xr =
              sX + (8 * j + 2 * tq) * XS + 8 * NH * half + 2 * gq;
#pragma unroll
          for (int m = 0; m < NH / 2; ++m) {
            const float2 x0 = *reinterpret_cast<const float2*>(xr + 16 * m);
            const float2 x1 =
                *reinterpret_cast<const float2*>(xr + XS + 16 * m);
            uint32_t bh[2][2], bl[2][2];
            split(x0.x, bh[0][0], bl[0][0]);
            split(x1.x, bh[0][1], bl[0][1]);
            split(x0.y, bh[1][0], bl[1][0]);
            split(x1.y, bh[1][1], bl[1][1]);
            // 3xTF32, the small terms first, two tiles in turn (fewer live
            // registers than all NH tiles at once: no spill at 128)
            mma_tf32(acc[2 * m], al, bh[0]);
            mma_tf32(acc[2 * m + 1], al, bh[1]);
            mma_tf32(acc[2 * m], ah, bl[0]);
            mma_tf32(acc[2 * m + 1], ah, bl[1]);
            mma_tf32(acc[2 * m], ah, bh[0]);
            mma_tf32(acc[2 * m + 1], ah, bh[1]);
          }
        };
        auto score = [&](int j) {
          return *reinterpret_cast<const float4*>(
              sS + ((kt * 8 + j) * FRAGS + frag) * 4);
        };
        if (full) {  // k < q0 <= q for every pair: all 8 blocks, no branch
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float4 s = score(j);
            const float2 ck = *reinterpret_cast<const float2*>(
                sCk + kt * BK + 8 * j + 2 * tq);
            block(j, s.x * r0 * ck.x, s.y * r0 * ck.y, s.z * r1 * ck.x,
                  s.w * r1 * ck.y);
          }
        } else {  // the diagonal tile, up to the warp's last row
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j > kb_max) break;
            const float4 s = score(j);
            const int k0 = kt * BK + 8 * j + 2 * tq, k1 = k0 + 1;
            const float2 ak = *reinterpret_cast<const float2*>(a + k0);
            const float2 dk = *reinterpret_cast<const float2*>(d + k0);
            // w masked to k <= q before the exponent
            const bool v00 = k0 <= qr0, v01 = k1 <= qr0;
            const bool v10 = k0 <= qr1, v11 = k1 <= qr1;
            block(j,
                  v00 ? s.x * fast_exp(v00 ? aq0 - ak.x : -INFINITY) * dk.x
                      : 0.f,
                  v01 ? s.y * fast_exp(v01 ? aq0 - ak.y : -INFINITY) * dk.y
                      : 0.f,
                  v10 ? s.z * fast_exp(v10 ? aq1 - ak.x : -INFINITY) * dk.x
                      : 0.f,
                  v11 ? s.w * fast_exp(v11 ? aq1 - ak.y : -INFINITY) * dk.y
                      : 0.f);
          }
        }
        if (kt == qt) {
          float* yh = yg + (h0 + hi) * syh;
          if constexpr (NH == 1) {  // columns 8 half + 2tq, + 1
            const int col = 8 * half + 2 * tq;
            if (qr0 < T)
              *reinterpret_cast<float2*>(yh + qr0 * syt + col) =
                  make_float2(acc[0][0], acc[0][1]);
            if (qr1 < T)
              *reinterpret_cast<float2*>(yh + qr1 * syt + col) =
                  make_float2(acc[0][2], acc[0][3]);
          }
          // tile 2m + b, accumulator column c is column 16m + 2c + b
#pragma unroll
          for (int m = 0; m < NH / 2; ++m) {
            const int col = 8 * NH * half + 16 * m + 4 * tq;
            const float* e = acc[2 * m];
            const float* o = acc[2 * m + 1];
            if (qr0 < T)
              *reinterpret_cast<float4*>(yh + qr0 * syt + col) =
                  make_float4(e[0], o[0], e[1], o[1]);
            if (qr1 < T)
              *reinterpret_cast<float4*>(yh + qr1 * syt + col) =
                  make_float4(e[2], o[2], e[3], o[3]);
          }
        }
      }
      __syncthreads();  // this stage and the head's acum, dt are free
    }
  }
}

template <int NC, int P>
int launch(const float* C, const float* B, const float* acum, const float* dt,
           const float* x, float* y, int G, int H, int T, int N, int64_t sxg,
           int64_t sxh, int64_t sxt, int64_t syg, int64_t syh, int64_t syt,
           cudaStream_t stream) {
  auto kern = ssd_tc_kernel<NC, P>;
  // raise the dynamic shared-memory limit to the largest T once per device,
  // outside any CUDA-graph capture (the first launch on a device is never
  // captured: capture follows a warm-up call)
  static bool configured[kMaxDevices] = {};
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(kern,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_bytes<NC, P>(MAX_T)));
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout, 100);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[dev] = true;
  }
  // heads per CTA: about CTAS_PER_SM CTAs per SM over (g, tile pair, head
  // group), as few head groups (score recomputations) as that allows
  const int n_qt = (T + BQ - 1) / BQ, n_pairs = (n_qt + 1) / 2;
  const int64_t base = static_cast<int64_t>(G) * n_pairs;
  int64_t splits = (2 * static_cast<int64_t>(CTAS_PER_SM) * sms[dev] + base) /
                   (2 * base);
  splits = splits < 1 ? 1 : (splits > H ? H : splits);
  const int HG = static_cast<int>((H + splits - 1) / splits);
  const int n_hg = (H + HG - 1) / HG;
  const int64_t grid = base * n_hg;
  // (h, t) offsets are taken in 32 bits inside a g slice
  const int64_t lim = 0x7fffffff;
  if (grid > lim || H * std::abs(sxh) + T * std::abs(sxt) > lim ||
      H * std::abs(syh) + T * std::abs(syt) > lim)
    return static_cast<int>(cudaErrorInvalidValue);
  kern<<<static_cast<unsigned>(grid), THREADS, smem_bytes<NC, P>(T),
         stream>>>(C, B, acum, dt, x, y, H, T, N, HG, n_hg, n_pairs, sxg,
                   static_cast<int>(sxh), static_cast<int>(sxt), syg,
                   static_cast<int>(syh), static_cast<int>(syt));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ssd_tc

// C, B [G, T, N] and acum, dt [G, H, T] contiguous; x and y [G, H, T, P]
// with element strides (sxg, sxh, sxt) and (syg, syh, syt), P contiguous,
// multiples of 4 (16-byte rows; C, B and x 16-byte aligned). N in {16, 32,
// 64, 128}, P in {16, 32, 64}, 1 <= T <= 256 (checked by the wrapper,
// kernels/ops.py).
extern "C" int ssd_chunk_tc_launch(const void* C, const void* B,
                                   const void* acum, const void* dt,
                                   const void* x, void* y, int G, int H,
                                   int T, int N, int P, long long sxg,
                                   long long sxh, long long sxt, long long syg,
                                   long long syh, long long syt,
                                   void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (T < 1 || T > ssd_tc::MAX_T || G < 1 || H < 1 || N < 16 || N > 128 ||
      !(N == 16 || N % 32 == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* c = static_cast<const float*>(C);
  const auto* b = static_cast<const float*>(B);
  const auto* a = static_cast<const float*>(acum);
  const auto* d = static_cast<const float*>(dt);
  const auto* xi = static_cast<const float*>(x);
  auto* yo = static_cast<float*>(y);
#define SSD_TC_LAUNCH(NC, PP)                                              \
  ssd_tc::launch<NC, PP>(c, b, a, d, xi, yo, G, H, T, N, sxg, sxh, sxt, syg, \
                         syh, syt, s)
  if (P == 16) return N == 16 ? SSD_TC_LAUNCH(16, 16) : SSD_TC_LAUNCH(32, 16);
  if (P == 32) return N == 16 ? SSD_TC_LAUNCH(16, 32) : SSD_TC_LAUNCH(32, 32);
  if (P == 64) return N == 16 ? SSD_TC_LAUNCH(16, 64) : SSD_TC_LAUNCH(32, 64);
#undef SSD_TC_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
