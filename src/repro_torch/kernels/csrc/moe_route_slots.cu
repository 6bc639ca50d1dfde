// moe_route_slots — MoE routing fused with the grouped dispatch's slot
// assignment, on Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/moe_router.py,
// moe_router_pallas (softmax + top-k + renormalise, routed per row by the
// same code as moe_router.cu: router_row.cuh) together with what the
// grouped dispatch computes right after it (src/repro/models/moe.py:94-100):
// the rank of each (token t, choice j) pair among all pairs routed to the
// same expert, in flattened order t*k + j, there a cumsum over a [T*k, E]
// one-hot, and slot = rank < cap ? rank : cap.
//
// In: logits [T, E] f32 or bf16, k, cap. Out: gates [T, k] f32 and
// idx [T, k] int32, bit for bit those of moe_router; slot [T, k] int32;
// src [E*cap] int32, the inverse map: src[e*cap + s] is the token in slot s
// of expert e, or T where that slot stays empty (the caller gathers its
// buffer from x with a zero row appended at T).
//
// Bound on an H100: logits read once and gates, idx, slot and src written
// once; at T = 2048, E = 64, k = 6 (cap 240) 0.73 MB, 0.22 us at 3.35 TB/s.
// Like the router it is launch-latency bound; its point is what it takes off
// the caller: the [T*k, E] int64 one-hot, its cumsum along the outer axis
// (61 of 122 ms of device time per DeepSeekMoE-16B prefill call at B = 4,
// S = 512 on the H100) and the sorted scatter that packed the buffer.
//
// Design. One 1024-thread CTA per tile of ROWS = 32 consecutive rows; warp r
// routes row r of its tile, keeps the row's k experts in shared memory and
// sets bit r of rows_of[e] for every expert e that the row chose. A row's k
// experts are distinct, so a pair's rank inside its tile is popc(rows_of[e]
// & ((1 << r) - 1)) and the tile's count for e is popc(rows_of[e]). The
// tiles' offsets come from an exclusive scan over tiles, one per expert, in
// the same launch, by decoupled look-back (Merrill and Garland, "Single-pass
// parallel prefix scan with decoupled look-back", 2016):
//  - A tile's number is a ticket from an atomic counter, not blockIdx, so
//    tiles are numbered in the order they started: every tile that a tile
//    waits for is resident or done, and the wait cannot deadlock in
//    whatever order the hardware schedules CTAs.
//  - Each tile publishes, per expert, its count (status AGG) as soon as its
//    rows are routed, then its inclusive prefix (status PREFIX) once it has
//    its exclusive prefix; tile 0 publishes its prefix at once.
//  - The whole CTA looks back for all experts at once: thread t takes
//    expert t % E and window row t / E (Q = THREADS / E rows), U = 4
//    predecessors a row, so a round reads the Q*U newest tiles not yet
//    summed, and a warp's loads of one tile's words are consecutive. Each
//    read is re-issued until the word carries this call's epoch; then a
//    shared atomicMin finds each expert's newest PREFIX in the window, and
//    the values down to and including it are added. With Q*U >= 32, a
//    tile at T = 4096 (128 tiles) needs at most two rounds at E = 64 and
//    one at E = 16; tile 0 skips the look-back.
//  - Each published value is one 64-bit word, epoch (30 bits) | status
//    (2 bits) | value (32 bits), written and read whole with volatile
//    (L2-coherent) accesses. Nothing is read through a word, so no fence
//    has to order a value against a flag.
// Scratch and reset: the words live in a persistent buffer (the wrapper's
// per-device scratch) and the call's state in one 64-bit word, epoch
// (high half) | ticket (low half). Nothing is cleared between calls: a
// word counts only if it carries this call's epoch. A CTA's one atomicAdd
// on the state returns its ticket and the call's epoch together; the CTA
// that draws the last ticket knows that every CTA has drawn, and stores
// the next call's state (epoch + 1, ticket 0) at once, which the next
// call reads, ordered after this one on the stream (also inside a CUDA
// graph). So a call costs one atomic round trip per CTA and no barrier at
// its end. Only the call before the epoch wraps to 0 (one in 2**30) also
// counts its CTAs out, and the last to finish zeroes the scratch, so no
// stale word can carry a current epoch. Two calls that share the scratch
// must not run at the same time (the port runs one stream per device).
// Slots are integers in token order: two calls give equal slots, whatever
// order the CTAs run in.
#include "router_row.cuh"

namespace route_slots {

constexpr int THREADS = 1024, WARPS = THREADS / 32, ROWS = 32;
constexpr int MAX_E = 512, MAX_K = 32, U = 4;
constexpr unsigned kAgg = 1, kPrefix = 2, kEpochMask = (1u << 30) - 1;

struct State {
  unsigned long long ticket;  // epoch << 32 | the next ticket
  unsigned done;              // CTAs finished, counted in the wrap call only
  unsigned unused;
};

struct Args {
  const void* logits;
  float* gates;
  int* idx;
  int* slot;
  int* src;
  unsigned long long* words;  // [tiles, E] look-back words
  State* state;
  int T, E, k, cap;
  long long n_words;  // the scratch's size, zeroed when the epoch wraps
};

__device__ __forceinline__ unsigned long long pack(unsigned epoch,
                                                   unsigned status,
                                                   unsigned value) {
  return static_cast<unsigned long long>(epoch) << 34 |
         static_cast<unsigned long long>(status) << 32 | value;
}

__device__ __forceinline__ unsigned status_of(unsigned long long w) {
  return static_cast<unsigned>(w >> 32) & 3u;
}

__device__ __forceinline__ bool current(unsigned long long w,
                                        unsigned epoch) {
  return static_cast<unsigned>(w >> 34) == epoch && status_of(w) != 0;
}

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* w) {
  return *reinterpret_cast<const volatile unsigned long long*>(w);
}

__device__ __forceinline__ void store_word(unsigned long long* w,
                                           unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(w) = v;
}

// Every expert's count summed over the tiles before `tile`, into
// excl_of[e]; hi_of[e] starts at `tile` and first_of[e] at the window,
// Q*U. Thread t reads expert e = t % E at window row q = t / E (Q =
// THREADS / E rows; threads past Q*E only join the barriers), U
// predecessors each, newest first: a warp's loads of one tile's words are
// consecutive. Each round, the newest PREFIX of each expert's window is
// found by a shared atomicMin over positions, and the values down to and
// including it are added; an expert without one moves its window back.
// Every thread of the CTA calls it.
__device__ void lookback(const unsigned long long* words, int E, int tile,
                         unsigned epoch, unsigned* excl_of, int* hi_of,
                         int* first_of) {
  const int tid = threadIdx.x, Q = THREADS / E, W = Q * U;
  const int e = tid % E, q = tid / E;
  const bool active = q < Q;
  const unsigned long long zero = pack(epoch, kAgg, 0);
  for (;;) {
    const int hi = active ? hi_of[e] : 0;  // tiles hi .. tile-1 are summed
    unsigned long long v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // issue all U loads, then wait on each
      const int p = hi - 1 - (q * U + u);
      v[u] = p >= 0 ? load_word(words + static_cast<int64_t>(p) * E + e)
                    : zero;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = hi - 1 - (q * U + u);
      while (!current(v[u], epoch)) {
        __nanosleep(32);
        v[u] = load_word(words + static_cast<int64_t>(p) * E + e);
      }
    }
    int mine = W;  // this thread's newest PREFIX, as a window position
#pragma unroll
    for (int u = U - 1; u >= 0; --u)
      if (status_of(v[u]) == kPrefix) mine = q * U + u;
    if (mine < W) atomicMin(&first_of[e], mine);
    __syncthreads();
    const int first = active ? first_of[e] : -1;
    unsigned sum = 0;
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (q * U + u <= first) sum += static_cast<unsigned>(v[u]);
    if (sum) atomicAdd(&excl_of[e], sum);
    __syncthreads();
    bool more = false;
    if (active && q == 0) {
      hi_of[e] = first < W ? 0 : hi - W;  // 0: done (tile 0 is a PREFIX)
      first_of[e] = W;
      more = hi_of[e] > 0;
    }
    if (!__syncthreads_or(more)) return;
  }
}

template <typename T, int EPL>
__global__ void __launch_bounds__(THREADS) route_slots_kernel(Args a) {
  __shared__ unsigned rows_of[MAX_E];  // bit r: row r of the tile chose e
  __shared__ unsigned excl_of[MAX_E];  // e's pairs in the tiles before
  __shared__ int hi_of[MAX_E], first_of[MAX_E];  // the look-back's state
  __shared__ int chosen[ROWS][MAX_K];  // each row's k experts
  __shared__ unsigned s_tile, s_epoch;
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int E = a.E, k = a.k;
  for (int e = tid; e < E; e += THREADS) {
    rows_of[e] = 0;
    excl_of[e] = 0;
    first_of[e] = THREADS / E * U;
  }
  if (tid == 0) {
    const unsigned long long t = atomicAdd(&a.state->ticket, 1ull);
    s_tile = static_cast<unsigned>(t);
    s_epoch = static_cast<unsigned>(t >> 32);
    if (s_tile == gridDim.x - 1)  // every CTA has drawn: the next call's
      store_word(&a.state->ticket,
                 static_cast<unsigned long long>((s_epoch + 1) & kEpochMask)
                     << 32);
  }
  __syncthreads();
  const int tile = static_cast<int>(s_tile);
  const unsigned epoch = s_epoch;
  const int row0 = tile * ROWS;
  for (int e = tid; e < E; e += THREADS) hi_of[e] = tile;

  // 1. route the tile's rows, one warp per row
  const T* logits = static_cast<const T*>(a.logits);
  for (int r = warp; r < ROWS && row0 + r < a.T; r += WARPS) {
    const int row = row0 + r;
    float gate;
    int expert;
    router::route_row<T, EPL>(logits + static_cast<int64_t>(row) * E, E, k,
                              lane, gate, expert);
    if (lane < k) {
      const int64_t o = static_cast<int64_t>(row) * k + lane;
      a.gates[o] = gate;
      a.idx[o] = expert;
      chosen[r][lane] = expert;
      atomicOr(&rows_of[expert], 1u << r);
    }
  }
  __syncthreads();

  // 2. per expert (thread e, which writes both states of its word, in
  // order): publish the tile's count (tile 0: its inclusive prefix), look
  // back for the exclusive prefix, publish the inclusive one
  unsigned long long* mine = a.words + static_cast<int64_t>(tile) * E;
  for (int e = tid; e < E; e += THREADS)
    store_word(mine + e, pack(epoch, tile == 0 ? kPrefix : kAgg,
                              __popc(rows_of[e])));
  if (tile > 0) {
    lookback(a.words, E, tile, epoch, excl_of, hi_of, first_of);
    for (int e = tid; e < E; e += THREADS)
      store_word(mine + e,
                 pack(epoch, kPrefix, excl_of[e] + __popc(rows_of[e])));
  }
  __syncthreads();

  // 3. each pair's slot, and the inverse map for the kept ones
  const unsigned cap = static_cast<unsigned>(a.cap);
  for (int p = tid; p < ROWS * k && row0 + p / k < a.T; p += THREADS) {
    const int r = p / k, j = p - r * k, row = row0 + r;
    const int e = chosen[r][j];
    const unsigned rank = excl_of[e] + __popc(rows_of[e] & ((1u << r) - 1u));
    a.slot[static_cast<int64_t>(row) * k + j] =
        static_cast<int>(rank < cap ? rank : cap);
    if (rank < cap) a.src[static_cast<int64_t>(e) * cap + rank] = row;
  }

  // 4. the last tile knows every expert's total: it marks the empty slots
  if (tile == static_cast<int>(gridDim.x) - 1)
    for (int e = warp; e < E; e += WARPS)
      for (unsigned s = excl_of[e] + __popc(rows_of[e]) + lane; s < cap;
           s += 32)
        a.src[static_cast<int64_t>(e) * cap + s] = a.T;

  // 5. before the epoch wraps to 0, the last CTA to finish zeroes the words
  if (epoch != kEpochMask) return;  // the same in every CTA of the call
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&a.state->done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  for (long long i = tid; i < a.n_words; i += THREADS) a.words[i] = 0;
  if (tid == 0) a.state->done = 0;
}

template <typename T, int EPL>
int launch(const Args& a, cudaStream_t stream) {
  const unsigned tiles = static_cast<unsigned>((a.T + ROWS - 1) / ROWS);
  route_slots_kernel<T, EPL><<<tiles, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// EPL = ceil(E / 32) logits a lane
template <typename T>
int launch_e(const Args& a, cudaStream_t s) {
  if (a.E <= 32) return launch<T, 1>(a, s);
  if (a.E <= 64) return launch<T, 2>(a, s);
  if (a.E <= 128) return launch<T, 4>(a, s);
  if (a.E <= 256) return launch<T, 8>(a, s);
  if (a.E <= MAX_E) return launch<T, 16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace route_slots

extern "C" int moe_route_slots_launch(const void* logits, void* gates,
                                      void* idx, void* slot, void* src,
                                      void* words, void* state, int T, int E,
                                      int k, int cap, long long n_words,
                                      int dtype, void* stream) {
  using namespace route_slots;
  auto s = static_cast<cudaStream_t>(stream);
  const long long tiles = (static_cast<long long>(T) + ROWS - 1) / ROWS;
  if (T < 1 || E < 1 || k < 1 || k > MAX_K || k > E || cap < 1 ||
      tiles * E > n_words)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{logits, static_cast<float*>(gates), static_cast<int*>(idx),
               static_cast<int*>(slot), static_cast<int*>(src),
               static_cast<unsigned long long*>(words),
               static_cast<State*>(state), T, E, k, cap, n_words};
  switch (dtype) {
    case gossip::kF32: return launch_e<float>(a, s);
    case gossip::kBF16: return launch_e<__nv_bfloat16>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
