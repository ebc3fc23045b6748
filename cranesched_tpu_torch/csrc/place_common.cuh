// Per-job stages shared by the greedy-placement kernel (greedy_place.cu)
// and its attribution variants (kattr_variants.cu), so that a variant's
// time measures exactly the stages it keeps of the real kernel.
//
// One block walks its stream's jobs in order.  The block OWNS a list of
// node slots (ascending node ids): thread t owns slots t, t + T, ... for
// the whole solve, and only the owner reads or writes a slot's avail and
// cost (except on the rare path for gangs above kKMax, which ends at a
// barrier).  The owned state lives in dynamic shared memory, one 16-byte
// aligned record per slot (avail dims, then cost), when it fits, else in
// device memory.  Every block has kThreads threads.
//
// Stages, in the order a job runs them:
//   stage_chunk  the scalars of the next chunk of jobs into shared memory
//                (two barriers per chunk, none per job);
//   walk_topk    each thread's KK least keys over its owned slots, in
//                registers (sorted insert on the cost alone; KK the
//                job's gang size rounded up to 1, 2, 4 or kKMax);
//   block_topk   the block's nn least keys, known to every thread: a
//                warp merge by shuffles, one shared slot list per warp
//                (double-buffered by parity), ONE barrier, then every
//                warp merges the warps' lists itself.
//
// A key orders slots by signed int32 cost and then by the lowest slot:
// (cost XOR 0x80000000) in the high word, the slot in the low word.  A
// block's slots ascend with the node id, so this is the node order too.
// The biased cost of COST_INF (int32 max) is all ones.

#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace place {

// threads per block, fixed: the best of 256, 512 and 1,024 at 2,500 and
// at 10,000 owned slots (PERF.md).  The kernels' launch bound is this
// many threads and one block per SM (a grid is one block per stream), so
// a thread may use up to 128 registers and none spills.
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxFields = 64;           // R + 4 job scalars
constexpr int kKMax = 8;                 // keys kept per thread (>= the
                                         // scheduler's max_nodes_per_job)
constexpr int kJobWords = 2048;          // the job-scalar chunk, int32s
constexpr int kRegReq = 4;               // request dims held in registers
constexpr unsigned kCostInfBiased = 0xffffffffu;
constexpr unsigned long long kInfKey = ~0ull;

// ---- dynamic shared memory layout (mirrored in models/gpu_solver.py) ----

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline int bit_words(int M) { return (M + 31) / 32; }

// Ints per slot record in shared memory: the R avail dims, then the
// cost, padded to whole int4s so that one 16-byte load reads a slot
// (R = 3: one load for the fit test and the cost).
__host__ __device__ inline int record_ints(int R) {
  return 4 * ((R + 1 + 3) / 4);
}

struct Layout {
  size_t red, bmin, jobs, win, state, bits, total;
};

// red: 2 parities x kKMax ranks x kWarps uint64; bmin: the block
// minimum's kWarps + 1 uint64; jobs: the chunk; win: K int32 winners
// of the rare path; state: M slot records of record_ints(R) int32 when
// smem_state; bits:
// C x bit_words(M) uint32 eligibility bits when smem_bits.
__host__ __device__ inline Layout layout(int M, int R, int C, int K,
                                         bool smem_state, bool smem_bits) {
  Layout l;
  size_t off = 0;
  l.red = off;
  off += align16(sizeof(unsigned long long) * 2 * kKMax * kWarps);
  l.bmin = off;
  off += align16(sizeof(unsigned long long) * (kWarps + 1));
  l.jobs = off;
  off += align16(sizeof(int32_t) * kJobWords);
  l.win = off;
  off += align16(sizeof(int32_t) * static_cast<size_t>(K));
  l.state = off;
  if (smem_state)
    off += align16(sizeof(int32_t) * (size_t)record_ints(R) * M);
  l.bits = off;
  if (smem_bits) off += align16(sizeof(uint32_t) * C * (size_t)bit_words(M));
  l.total = off;
  return l;
}

// ---- keys ----

__device__ __forceinline__ unsigned long long make_key(int32_t cost,
                                                       unsigned slot) {
  return ((unsigned long long)((unsigned)cost ^ 0x80000000u) << 32) | slot;
}

__device__ __forceinline__ int32_t key_cost(unsigned long long key) {
  return (int32_t)((unsigned)(key >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int key_slot(unsigned long long key) {
  return (int)(unsigned)(key & 0xffffffffu);
}

__device__ __forceinline__ bool key_finite(unsigned long long key) {
  return (unsigned)(key >> 32) != kCostInfBiased;
}

// ---- owned state ----

// The block's owned slots.  With SMEM, av holds the shared records
// [M][record_ints(R)] and co is unused; else av is the device [N, R]
// avail and co the device [N] cost, read through ids.  ids[i] is slot
// i's node id.
template <bool SMEM>
struct Owned {
  int32_t* av;
  int32_t* co;
  const int32_t* __restrict__ ids;
  int R;
  int RW;

  // Does the request fit slot i?  rq holds its first four dims
  // (INT32_MIN past R, so that they always pass), q all of them.  c gets
  // the slot's cost.
  __device__ __forceinline__ bool fits(int i, const int (&rq)[kRegReq],
                                       const int32_t* q, int32_t& c) const {
    if (SMEM) {
      const int32_t* rec = av + (size_t)i * RW;
      const int4 v = *reinterpret_cast<const int4*>(rec);
      bool fit = (v.x >= rq[0]) & (v.y >= rq[1]) & (v.z >= rq[2]) &
                 (v.w >= rq[3]);
      for (int r = kRegReq; r < R; ++r) fit &= rec[r] >= q[r];
      c = R == 3 ? v.w : rec[R];
      return fit;
    }
    const int n = ids[i];
    const int32_t* a = av + (size_t)n * R;
    bool fit = true;
#pragma unroll
    for (int r = 0; r < kRegReq; ++r)
      if (r < R) fit &= a[r] >= rq[r];
    for (int r = kRegReq; r < R; ++r) fit &= a[r] >= q[r];
    c = co[n];
    return fit;
  }

  // Take the request from slot i and add d to its cost, in uint32 so a
  // wrap matches the reference's int32 arithmetic.
  __device__ __forceinline__ void take(int i, const int32_t* q,
                                       int32_t d) const {
    int32_t* a = SMEM ? av + (size_t)i * RW : av + (size_t)ids[i] * R;
    for (int r = 0; r < R; ++r)
      a[r] = (int32_t)((unsigned)a[r] - (unsigned)q[r]);
    int32_t& c = SMEM ? a[R] : co[ids[i]];
    c = (int32_t)((unsigned)c + (unsigned)d);
  }
};

// Copy the owned state between device memory (avail [N, R], cost [N])
// and the shared records; each thread its own slots.
template <bool TO_SHARED>
__device__ __forceinline__ void move_state(int32_t* avail, int32_t* cost,
                                           const int32_t* __restrict__ ids,
                                           int Ms, int R, int32_t* s_rec) {
  const int RW = record_ints(R);
  for (int i = threadIdx.x; i < Ms; i += kThreads) {
    const int n = ids[i];
    int32_t* rec = s_rec + (size_t)i * RW;
    for (int r = 0; r < R; ++r) {
      if (TO_SHARED) rec[r] = avail[(size_t)n * R + r];
      else avail[(size_t)n * R + r] = rec[r];
    }
    if (TO_SHARED) {
      rec[R] = cost[n];
      for (int r = R + 1; r < RW; ++r) rec[r] = 0;
    } else {
      cost[n] = rec[R];
    }
  }
}

// The request's first kRegReq dims in registers (static indices only),
// INT32_MIN past R.
__device__ __forceinline__ void load_req(const int32_t* q, int R,
                                         int (&rq)[kRegReq]) {
#pragma unroll
  for (int r = 0; r < kRegReq; ++r) rq[r] = r < R ? q[r] : INT32_MIN;
}

// ---- job scalars ----

// Stage nj jobs of F scalars into s_jobs as rows of F; scalar f of job
// j is src[j * js + f * fs] in device memory.  The first barrier frees
// the previous chunk, the second publishes this one.
__device__ __forceinline__ void stage_chunk(const int32_t* __restrict__ src,
                                            int nj, int F, size_t js,
                                            size_t fs, int32_t* s_jobs) {
  __syncthreads();
  for (int x = threadIdx.x; x < nj * F; x += kThreads) {
    const int j = x / F;
    s_jobs[x] = src[j * js + (x - j * F) * fs];
  }
  __syncthreads();
}

// ---- the walk and the reduction ----
//
// KK is the depth of the lists, a compile-time bucket of the job's gang
// size nn (1, 2, 4 or kKMax): a job pays for the depth it needs.

using Key = unsigned long long;

// Insert (cost c, slot i) into the thread's ascending lists (tc, ts) of
// KK entries, padded with (INT32_MAX, ~0u), without branches.  A thread
// meets its slots in ascending order, so the new entry goes before the
// first strictly greater cost: equal costs keep slot order.  A cost of
// INT32_MAX is never inserted (such a node can never be admitted:
// admission needs the nn-th cost to be finite).
template <int KK>
__device__ __forceinline__ void topk_insert(int32_t (&tc)[KK],
                                            unsigned (&ts)[KK], int32_t c,
                                            unsigned i) {
  bool lt[KK];
#pragma unroll
  for (int k = 0; k < KK; ++k) lt[k] = c < tc[k];
  // entry k: shifted down from k - 1, the new one, or unchanged
#pragma unroll
  for (int k = KK - 1; k > 0; --k) {
    tc[k] = lt[k - 1] ? tc[k - 1] : lt[k] ? c : tc[k];
    ts[k] = lt[k - 1] ? ts[k - 1] : lt[k] ? i : ts[k];
  }
  tc[0] = lt[0] ? c : tc[0];
  ts[0] = lt[0] ? i : ts[0];
}

// Each thread's KK least (cost, slot) keys over its owned slots i = tid,
// tid + T, ... < Ms, ascending, kInfKey-padded.  cand(i, c) says whether
// slot i can take the job and sets c to its cost.  Two slots per step,
// so that their loads overlap.
template <int KK, class Cand>
__device__ __forceinline__ void walk_topk(int Ms, Cand cand,
                                          Key (&top)[KK]) {
  int32_t tc[KK];
  unsigned ts[KK];
#pragma unroll
  for (int k = 0; k < KK; ++k) {
    tc[k] = INT32_MAX;
    ts[k] = ~0u;
  }
  constexpr int T = kThreads;
  int i = threadIdx.x;
  for (; i + T < Ms; i += 2 * T) {
    int32_t ca, cb;
    const bool a = cand(i, ca);
    const bool b = cand(i + T, cb);
    if (a) topk_insert(tc, ts, ca, (unsigned)i);
    if (b) topk_insert(tc, ts, cb, (unsigned)(i + T));
  }
  int32_t c;
  if (i < Ms && cand(i, c)) topk_insert(tc, ts, c, (unsigned)i);
#pragma unroll
  for (int k = 0; k < KK; ++k) top[k] = make_key(tc[k], ts[k]);
}

__device__ __forceinline__ Key warp_min_all(Key v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const Key o = __shfl_xor_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// The warp's nn least keys over its lanes' ascending lists, ascending,
// into win on every lane (kInfKey past nn); pops them from top.  Keys
// are unique, so exactly one lane holds each finite winner.  nn <= KK
// must be the same on every lane.
template <int KK>
__device__ __forceinline__ void warp_topk(Key (&top)[KK], int nn,
                                          Key (&win)[KK]) {
#pragma unroll
  for (int r = 0; r < KK; ++r) {
    win[r] = kInfKey;
    if (r < nn) {
      const Key m = warp_min_all(top[0]);
      if (top[0] == m) {
#pragma unroll
        for (int k = 0; k + 1 < KK; ++k) top[k] = top[k + 1];
        top[KK - 1] = kInfKey;
      }
      win[r] = m;
    }
  }
}

// The block's nn least keys (nn <= KK), ascending, into win on every
// thread, with ONE barrier: each warp's list goes to its slot in s_red
// (parity par: the next call uses the other half, so no second barrier
// is needed before it writes), then every warp merges all the lists.
// Writing parity p again two calls later is safe: every thread has
// passed the barrier in between, after its reads of p.
template <int KK>
__device__ __forceinline__ void block_topk(Key (&top)[KK], int nn,
                                           Key* s_red, int par,
                                           Key (&win)[KK]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Key* red = s_red + par * (kKMax * kWarps);
  warp_topk(top, nn, win);
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < KK; ++r)
      if (r < nn) red[r * kWarps + warp] = win[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < KK; ++r)
    top[r] = (r < nn && lane < kWarps) ? red[r * kWarps + lane] : kInfKey;
  warp_topk(top, nn, win);
}

// win[k] for a k known only at run time (registers need static indices).
template <int KK>
__device__ __forceinline__ Key pick(const Key (&win)[KK], int k) {
  Key v = kInfKey;
#pragma unroll
  for (int r = 0; r < KK; ++r) v = r == k ? win[r] : v;
  return v;
}

// Block-wide minimum with two barriers; every thread gets the result
// (the path for gangs above kKMax).  s_bm holds kWarps + 1 slots.
__device__ __forceinline__ Key block_min(Key v, Key* s_bm) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_min_all(v);
  if (lane == 0) s_bm[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? s_bm[lane] : kInfKey;
    v = warp_min_all(v);
    if (lane == 0) s_bm[kWarps] = v;
  }
  __syncthreads();
  return s_bm[kWarps];
}

}  // namespace place
