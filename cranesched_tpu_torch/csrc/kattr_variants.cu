// Attribution variants of the greedy-placement kernel: where does its
// time per job go?
//
// Replaces the Pallas TPU kernels of tools/kattr.py::make_variant
// (launched by run() through pl.pallas_call).  Each variant computes that
// kernel's checksum, bit for bit, over the same data: job scalars
// int32[F, J] (F = R + 4, field-major, J a multiple of the block BJ),
// avail int32[N, R] and cost int32[N].  With s_j the wrapping int32 sum of
// job j's F scalars and feas_j(n) = AND_r avail[n][r] >= job[r][j]:
//
//   floor   acc += s_j on every lane, cumulative over all jobs;
//   bcast   acc += feas_j(0) on every lane, cumulative;
//   onemin  lane j of its block = s_j + min_n (feas ? cost : INT32_MAX);
//   select  two passes of m = that min, i = the lowest node id whose
//           masked cost is m, then the masked cost of i set to INT32_MAX;
//           lane j = s_j + m2 + i2.
//
// out[b * BJ + l] is lane l after block b.  All sums wrap as int32; they
// are done in uint32, since signed overflow is undefined in C++.
//
// What bounds it on an H100, and the design: nothing but the structure
// it measures.  Each variant is greedy_place.cu's per-job loop cut to a
// prefix of its stages, built from the same code (place_common.cuh): one
// block owns all N nodes (thread t: nodes t, t + T, ...), their avail
// and cost in shared memory (one record a node) when they fit, and walks
// every job in
// order; the job scalars are staged a chunk at a time.  The lists are as
// deep as the real kernel makes them for a gang of the same size.
//   floor   staging, and one barrier per job (the real kernel's one);
//   bcast   + the owned walk with the fit test;
//   onemin  + each thread's least key, the warp merge and the block merge
//           behind that one barrier (the single-key reduction);
//   select  + the top 2 from the same walk (a gang of two).
// The differences of the variants' times attribute greedy_place's time
// per job to its stages.
//
// The reference keys every node with its masked cost (INT32_MAX when the
// job does not fit); the walk keeps only the finite ones, as greedy_place
// does.  onemin reads the least cost only, which is INT32_MAX when no key
// is finite.  select also needs the lowest node that does not fit: with
// the first winner masked to INT32_MAX, the reference's second pass picks
// the lowest id among equal masked costs, which can be the first winner
// itself.  So each thread adds (INT32_MAX, its lowest such node) to its
// list, and the second key is the smaller of the second-least key and
// (INT32_MAX, id of the first).  bcast's checksum reads node 0 only, so
// each thread also counts its feasible nodes into side[tid]: without a
// use of every node's verdict the compiler would drop the walk.
// Never build this file with --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

#include "place_common.cuh"

namespace {

using place::Key;
using place::kMaxFields;
using place::kThreads;

enum Kind { kFloor = 0, kBcast = 1, kOneMin = 2, kSelect = 3 };
constexpr int32_t kCostInf = 0x7fffffff;

// avail and cost are only read; ids[n] = n (the block owns every node).
template <int KIND, bool SMEM>
__global__ void __launch_bounds__(kThreads, 1) kattr_kernel(
    const int32_t* __restrict__ job, int32_t* avail, int32_t* cost,
    const int32_t* __restrict__ ids, int32_t* __restrict__ out,
    int32_t* __restrict__ side, int J, int N, int R, int BJ) {
  extern __shared__ __align__(16) unsigned char smem[];
  const place::Layout lay = place::layout(N, R, 0, 0, SMEM, false);
  auto* s_red = reinterpret_cast<Key*>(smem + lay.red);
  auto* s_acc = reinterpret_cast<unsigned*>(smem + lay.bmin);
  auto* s_jobs = reinterpret_cast<int32_t*>(smem + lay.jobs);
  auto* s_rec = reinterpret_cast<int32_t*>(smem + lay.state);
  const int tid = threadIdx.x;
  const int F = R + 4;

  if (SMEM) place::move_state<true>(avail, cost, ids, N, R, s_rec);
  const place::Owned<SMEM> o{SMEM ? s_rec : avail, cost, ids, R,
                             place::record_ints(R)};
  unsigned acc = 0;        // floor and bcast: thread 0's accumulator
  unsigned feasible = 0;   // bcast: this thread's feasible nodes
  int par = 0;
  const int CH = place::kJobWords / F;
  for (int j0 = 0; j0 < J; j0 += CH) {
    const int nj = min(CH, J - j0);
    place::stage_chunk(job + j0, nj, F, 1, (size_t)J, s_jobs);
    for (int jl = 0; jl < nj; ++jl) {
      const int32_t* q = s_jobs + jl * F;
      const int j = j0 + jl;
      unsigned s = 0;
      for (int f = 0; f < F; ++f) s += (unsigned)q[f];
      int rq[place::kRegReq];
      place::load_req(q, R, rq);

      if (KIND == kFloor) {
        acc += s;
        __syncthreads();   // the real kernel's one barrier per job
      } else if (KIND == kBcast) {
        for (int i = tid; i < N; i += kThreads) {
          int32_t c;
          const bool fit = o.fits(i, rq, q, c);
          feasible += fit ? 1u : 0u;
          if (i == 0) acc += fit ? 1u : 0u;   // node 0 is thread 0's
        }
        __syncthreads();
      } else {
        constexpr int KK = KIND == kOneMin ? 1 : 2;
        // select: the thread's lowest node whose masked cost is
        // INT32_MAX (it does not fit, or its cost is INT32_MAX)
        unsigned lo = ~0u;
        auto cand = [&](int i, int32_t& c) -> bool {
          const bool fit = o.fits(i, rq, q, c);
          if (KIND == kSelect && (!fit || c == kCostInf) && (unsigned)i < lo)
            lo = i;
          return fit;
        };
        Key top[KK], win[KK];
        place::walk_topk(N, cand, top);
        if (KIND == kSelect) {
          // the list of masked keys: (INT32_MAX, lo) ranks after every
          // finite key, and no other INT32_MAX key can change the answer
          const Key inf = place::make_key(kCostInf, lo);
          if (inf < top[0]) {
            top[1] = top[0];
            top[0] = inf;
          } else if (inf < top[1]) {
            top[1] = inf;
          }
        }
        place::block_topk(top, KK, s_red, par, win);
        par ^= 1;
        if (tid == 0) {
          if (KIND == kOneMin) {
            out[j] = (int32_t)(s + (unsigned)place::key_cost(win[0]));
          } else {
            const Key alt =
                place::make_key(kCostInf, (unsigned)place::key_slot(win[0]));
            const Key m2 = win[KK - 1] < alt ? win[KK - 1] : alt;
            out[j] = (int32_t)(s + (unsigned)place::key_cost(m2) +
                               (unsigned)place::key_slot(m2));
          }
        }
      }

      if ((KIND == kFloor || KIND == kBcast) && (j + 1) % BJ == 0) {
        // the end of a block of BJ jobs: every lane holds the accumulator
        // (s_acc is rewritten only after the next job's barrier)
        if (tid == 0) *s_acc = acc;
        __syncthreads();
        for (int l = tid; l < BJ; l += kThreads)
          out[j + 1 - BJ + l] = (int32_t)*s_acc;
      }
    }
  }
  if (KIND == kBcast) side[tid] = (int32_t)feasible;
}

using Kernel = void (*)(const int32_t*, int32_t*, int32_t*, const int32_t*,
                        int32_t*, int32_t*, int, int, int, int);

template <int KIND>
Kernel pick(bool smem) {
  return smem ? kattr_kernel<KIND, true> : kattr_kernel<KIND, false>;
}

}  // namespace

// kind: 0 floor, 1 bcast, 2 onemin, 3 select.  job int32[R + 4, J],
// avail int32[N, R], cost int32[N], ids int32[N] = 0..N-1, out int32[J],
// side int32[place::kThreads].  smem_bytes must be place::layout(N, R, 0, 0,
// smem_state, false).total (tools/kattr.py computes it through
// gpu_solver.launch_plan).
extern "C" int kattr_launch(int kind, const void* job, const void* avail,
                            const void* cost, const void* ids, void* out,
                            void* side, int J, int N, int R, int BJ,
                            int smem_state, int smem_bytes,
                            void* stream) {
  if (R < 1 || R + 4 > kMaxFields || BJ < 1 || J % BJ != 0)
    return (int)cudaErrorInvalidValue;
  if ((size_t)smem_bytes !=
      place::layout(N, R, 0, 0, smem_state != 0, false).total)
    return (int)cudaErrorInvalidValue;
  Kernel kern;
  switch (kind) {
    case kFloor: kern = pick<kFloor>(smem_state != 0); break;
    case kBcast: kern = pick<kBcast>(smem_state != 0); break;
    case kOneMin: kern = pick<kOneMin>(smem_state != 0); break;
    case kSelect: kern = pick<kSelect>(smem_state != 0); break;
    default: return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<1, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const int32_t*)job, (int32_t*)avail, (int32_t*)cost,
      (const int32_t*)ids, (int32_t*)out, (int32_t*)side, J, N, R, BJ);
  return (int)cudaGetLastError();
}
