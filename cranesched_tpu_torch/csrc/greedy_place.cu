// Greedy placement of a priority-ordered job batch, one launch per solve.
//
// Replaces the Pallas TPU kernel cranesched_tpu/models/pallas_solver.py::
// _make_kernel (launched by _launch, entered through _solve_serial_impl
// and _solve_streamed_impl).  It computes what that kernel computes, bit
// for bit: for each job in order, feasibility elig[class] & all_r(avail[r]
// >= req[r]); the node_num cheapest feasible nodes, ties to the lowest
// node id; the decide_job admission and pending reason; on admission,
// req subtracted from the winners' avail and round(tl*cpu*16/cpu_total)
// added to their cost.  S streams whose eligibility classes are pairwise
// disjoint run as S independent thread blocks.
//
// What bounds it on an H100: neither bytes nor operations (both are three
// orders of magnitude below the card's rates) but a serial chain of one
// block-wide reduction per job: J/S jobs per stream, each of which must
// see the state its predecessor left.  The time per job is the walk over
// the block's nodes (issue rate), the reduction's shuffle chain and one
// barrier.
//
// What the design does about it (see place_common.cuh for the stages):
// - each block OWNS the nodes its stream can place on (the union of its
//   classes' rows, built on the host in gpu_solver.kernel_inputs); thread
//   t owns slots t, t + T, ...  A streamed block walks its ~N/S nodes, not
//   all N;
// - the owned avail and cost sit in dynamic shared memory for the whole
//   solve (as the Pallas kernel kept them in VMEM), one 16-byte record
//   per slot (R = 3: one load gives the fit test and the cost), with the
//   class eligibility as bits beside them; the wrapper picks, by size
//   before the launch, device memory for either part that does not fit
//   (the same code, a template flag);
// - ONE walk per job: each thread keeps its least (cost, slot) keys in
//   registers, as many as the gang needs rounded up to 1, 2, 4 or kKMax
//   (a compile-time depth, so a single-node job pays for one compare),
//   a warp merges lists by shuffles, and the block merges the warps'
//   lists behind ONE barrier, double-buffered by job parity;
// - the winners' update is done by their owners, so no barrier ends a
//   job; the job scalars are staged a chunk at a time;
// - gangs above kKMax take "the least key above the previous winner"
//   passes over the owned slots, one block minimum each, and end at a
//   barrier (their updates are made by threads that do not own the node).
// Thread-block clusters (one stream's nodes over several SMs) are left
// for later work.
//
// Arithmetic that must match the reference bit for bit: the cost
// increment uses the round-to-nearest intrinsics in the reference's
// association, with round-half-to-even on the conversion; costs and
// avail are updated in uint32 so a wrap matches the reference's int32
// add.  Never build this file with --use_fast_math.

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "place_common.cuh"

namespace {

using place::Key;
using place::kInfKey;
using place::kKMax;
using place::kMaxFields;
using place::kThreads;

constexpr int kReasonNone = 0;
constexpr int kReasonResource = 1;
constexpr int kReasonConstraint = 2;
constexpr int kMaxK = 1024;   // chosen columns the launcher accepts

template <int KK>
using Depth = std::integral_constant<int, KK>;

// jobs:      int32[S, L, F], F = R + 4: req[R], node_num, time_limit,
//            valid, class (already clipped to [0, C))
// nelig:     int32[C] eligible (alive) node count per class
// elig:      uint8[C, N] class mask AND alive
// cpu_total: float32[N] max(total cpu, 1)
// owned:     int32[S, M] each stream's owned node ids, ascending;
//            n_owned int32[S] how many (the rest is padding)
// avail:     int32[N, R] updated in place (owned rows only)
// cost:      int32[N] updated in place (owned rows only)
// placed, reason: int32[S, L]; chosen: int32[S, L, K]
template <bool SMEM_STATE, bool SMEM_BITS>
__global__ void __launch_bounds__(kThreads, 1) greedy_place_kernel(
    const int32_t* __restrict__ jobs, const int32_t* __restrict__ nelig,
    const uint8_t* __restrict__ elig, const float* __restrict__ cpu_total,
    const int32_t* __restrict__ owned, const int32_t* __restrict__ n_owned,
    int32_t* avail, int32_t* cost, int32_t* __restrict__ placed,
    int32_t* __restrict__ reason, int32_t* __restrict__ chosen, int N,
    int R, int C, int L, int K, int M) {
  extern __shared__ __align__(16) unsigned char smem[];
  const place::Layout lay =
      place::layout(M, R, C, K, SMEM_STATE, SMEM_BITS);
  auto* s_red = reinterpret_cast<Key*>(smem + lay.red);
  auto* s_bm = reinterpret_cast<Key*>(smem + lay.bmin);
  auto* s_jobs = reinterpret_cast<int32_t*>(smem + lay.jobs);
  auto* s_win = reinterpret_cast<int32_t*>(smem + lay.win);
  auto* s_rec = reinterpret_cast<int32_t*>(smem + lay.state);
  auto* s_bits = reinterpret_cast<uint32_t*>(smem + lay.bits);

  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  constexpr int T = kThreads;
  const int F = R + 4;
  const int W = place::bit_words(M);
  const int Ms = n_owned[s];
  const int32_t* ids = owned + (size_t)s * M;

  if (SMEM_STATE) place::move_state<true>(avail, cost, ids, Ms, R, s_rec);
  if (SMEM_BITS) {
    // bit i of word w of class c: elig[c][ids[32 w + i]]; one ballot a word
    const int lane = tid & 31;
    for (int w = tid >> 5; w < C * W; w += T >> 5) {
      const int c = w / W;
      const int i = (w - c * W) * 32 + lane;
      const bool e = i < Ms && elig[(size_t)c * N + ids[i]] != 0;
      const unsigned word = __ballot_sync(0xffffffffu, e);
      if (lane == 0) s_bits[w] = word;
    }
  }
  // stage_chunk's first barrier publishes the state and the bits

  const place::Owned<SMEM_STATE> o{SMEM_STATE ? s_rec : avail, cost, ids, R,
                                   place::record_ints(R)};
  const int CH = place::kJobWords / F;
  int par = 0;
  for (int j0 = 0; j0 < L; j0 += CH) {
    const int nj = min(CH, L - j0);
    place::stage_chunk(jobs + ((size_t)s * L + j0) * F, nj, F, F, 1,
                       s_jobs);
    for (int jl = 0; jl < nj; ++jl) {
      const int32_t* q = s_jobs + jl * F;
      const int nn = q[R];
      const bool valid = q[R + 2] != 0;
      const int cls = q[R + 3];
      const size_t out = (size_t)s * L + j0 + jl;
      int rq[place::kRegReq];
      place::load_req(q, R, rq);
      const uint32_t* bits = s_bits + (size_t)cls * W;
      const uint8_t* erow = elig + (size_t)cls * N;

      // can slot i take the job?  c: its cost
      auto cand = [&](int i, int32_t& c) -> bool {
        const bool e = SMEM_BITS ? ((bits[i >> 5] >> (i & 31)) & 1u) != 0
                                 : erow[ids[i]] != 0;
        if (!SMEM_STATE && !e) return false;   // spare the device loads
        return o.fits(i, rq, q, c) && e;
      };
      // the winner's update, slot i: round(tl * cpu * 16 / cpu_total)
      auto take = [&](int i) {
        const float d = __fdiv_rn(
            __fmul_rn(__fmul_rn((float)q[R + 1], (float)q[0]), 16.0f),
            cpu_total[ids[i]]);
        o.take(i, q, __float2int_rn(d));
      };
      // one walk, one barrier; admission asks whether the nn-th least
      // key has a finite cost
      auto fast = [&](auto depth) -> bool {
        constexpr int KK = decltype(depth)::value;
        Key top[KK], win[KK];
        place::walk_topk(Ms, cand, top);
        place::block_topk(top, nn, s_red, par, win);
        par ^= 1;
        const bool ok = place::key_finite(place::pick(win, nn - 1));
        if (ok) {
#pragma unroll
          for (int r = 0; r < KK; ++r) {
            const int i = place::key_slot(win[r]);
            if (r < nn && (i & (T - 1)) == tid) take(i);
          }
        }
        for (int k = tid; k < K; k += T) {
          chosen[out * K + k] =
              (ok && k < nn) ? ids[place::key_slot(place::pick(win, k))]
                             : -1;
        }
        return ok;
      };

      bool ok = false;
      if (valid && nn >= 1 && nn <= K && nn <= kKMax) {
        ok = nn == 1   ? fast(Depth<1>())
             : nn == 2 ? fast(Depth<2>())
             : nn <= 4 ? fast(Depth<4>())
                       : fast(Depth<kKMax>());
      } else if (valid && nn >= 1 && nn <= K) {
        // a gang above kKMax: the k-th pass takes the least key above the
        // (k-1)-th winner's (keys are unique, so this excludes exactly
        // the earlier winners)
        Key prev = 0;
        for (int k = 0; k < nn; ++k) {
          Key best = kInfKey;
          for (int i = tid; i < Ms; i += T) {
            int32_t c;
            if (!cand(i, c)) continue;
            const Key key = place::make_key(c, (unsigned)i);
            if ((k == 0 || key > prev) && key < best) best = key;
          }
          prev = place::block_min(best, s_bm);
          if (tid == 0) s_win[k] = place::key_slot(prev);
        }
        ok = place::key_finite(prev);
        __syncthreads();  // s_win visible
        if (ok)
          for (int k = tid; k < nn; k += T) take(s_win[k]);
        for (int k = tid; k < K; k += T)
          chosen[out * K + k] = (ok && k < nn) ? ids[s_win[k]] : -1;
        __syncthreads();  // updates visible to the owners, s_win free
      } else {
        for (int k = tid; k < K; k += T) chosen[out * K + k] = -1;
      }
      if (tid == 0) {
        const bool never = !valid || nn <= 0 || nelig[cls] < nn;
        placed[out] = ok ? 1 : 0;
        reason[out] = ok ? kReasonNone
                         : (never ? kReasonConstraint : kReasonResource);
      }
    }
  }
  // each owner writes its own slots back (the rare path ended at a
  // barrier, so every update is visible to its owner)
  if (SMEM_STATE) place::move_state<false>(avail, cost, ids, Ms, R, s_rec);
}

using Kernel = void (*)(const int32_t*, const int32_t*, const uint8_t*,
                        const float*, const int32_t*, const int32_t*,
                        int32_t*, int32_t*, int32_t*, int32_t*, int32_t*,
                        int, int, int, int, int, int);

}  // namespace

// smem_bytes must be place::layout(M, R, C, K, smem_state,
// smem_bits).total: the wrapper computes it (gpu_solver.launch_plan) and
// this checks it.  One block of place::kThreads threads per stream.
extern "C" int greedy_place_launch(
    const void* jobs, const void* nelig, const void* elig,
    const void* cpu_total, const void* owned, const void* n_owned,
    void* avail, void* cost, void* placed, void* reason, void* chosen,
    int S, int N, int R, int C, int L, int K, int M, int smem_state,
    int smem_bits, int smem_bytes, void* stream) {
  if (R < 1 || R + 4 > kMaxFields || K < 0 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  const place::Layout lay =
      place::layout(M, R, C, K, smem_state != 0, smem_bits != 0);
  if ((size_t)smem_bytes != lay.total) return (int)cudaErrorInvalidValue;
  const Kernel kern =
      smem_state ? (smem_bits ? greedy_place_kernel<true, true>
                              : greedy_place_kernel<true, false>)
                 : (smem_bits ? greedy_place_kernel<false, true>
                              : greedy_place_kernel<false, false>);
  // above 48 KB a block's dynamic shared memory must be asked for
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  kern<<<S, kThreads, smem_bytes, (cudaStream_t)stream>>>(
      (const int32_t*)jobs, (const int32_t*)nelig, (const uint8_t*)elig,
      (const float*)cpu_total, (const int32_t*)owned,
      (const int32_t*)n_owned, (int32_t*)avail, (int32_t*)cost,
      (int32_t*)placed, (int32_t*)reason, (int32_t*)chosen, N, R, C, L, K,
      M);
  return (int)cudaGetLastError();
}
