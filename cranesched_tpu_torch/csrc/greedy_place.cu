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
// What bounds it on an H100: a serial chain of J/S jobs per stream, each
// doing up to K block-wide arg-min reductions over the N nodes, with two
// or more block barriers per reduction and no work for the other
// 132 - S SMs.  Arithmetic (about N*(R+1+2K) integer ops per job) and
// bytes (the state, ~240 KB at N=10k, stays in L2) are far below the
// card's rates, so the time is barrier and memory latency per job.
//
// What the design does about it: one launch per solve (no per-job
// launches), the whole job loop inside one block per stream, the cluster
// state updated in place in device memory (L2-resident), one 64-bit key
// per node so that a single min reduction orders by cost and then by the
// lowest id, only node_num passes per job (not K), and no passes at all
// for jobs that cannot be admitted (invalid, or node_num outside
// [1, K]).  Staging the state in shared memory, thread-block clusters
// and more blocks per stream are left for later work.  The per-job
// stages (staging, node walk, block minimum) live in place_common.cuh,
// shared with the attribution variants in kattr_variants.cu.
//
// Arithmetic that must match the reference bit for bit: the cost
// increment uses the round-to-nearest intrinsics in the reference's
// association, with round-half-to-even on the conversion; costs and
// avail are updated in uint32 so a wrap matches the reference's int32
// add.  Never build this file with --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

#include "place_common.cuh"

namespace {

using place::kCostInfBiased;
using place::kInfKey;
using place::kMaxFields;
using place::kThreads;

constexpr int kReasonNone = 0;
constexpr int kReasonResource = 1;
constexpr int kReasonConstraint = 2;

// jobs:      int32[S, L, F], F = R + 4: req[R], node_num, time_limit,
//            valid, class (already clipped to [0, C))
// nelig:     int32[C] eligible (alive) node count per class
// elig:      uint8[C, N] class mask AND alive
// cpu_total: float32[N] max(total cpu, 1)
// avail:     int32[N, R] updated in place
// cost:      int32[N] updated in place
// placed, reason: int32[S, L]; chosen: int32[S, L, K]
__global__ void __launch_bounds__(kThreads) greedy_place_kernel(
    const int32_t* __restrict__ jobs, const int32_t* __restrict__ nelig,
    const uint8_t* __restrict__ elig, const float* __restrict__ cpu_total,
    int32_t* avail, int32_t* cost, int32_t* __restrict__ placed,
    int32_t* __restrict__ reason, int32_t* __restrict__ chosen, int N,
    int R, int L, int K) {
  __shared__ int32_t s_job[kMaxFields];
  __shared__ unsigned long long s_red[33];
  const int F = R + 4;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;

  for (int j = 0; j < L; ++j) {
    place::stage_job(jobs + ((size_t)s * L + j) * F, 1, F, s_job);
    const int nn = s_job[R];
    const int tl = s_job[R + 1];
    const bool valid = s_job[R + 2] != 0;
    const int cls = s_job[R + 3];
    const uint8_t* erow = elig + (size_t)cls * N;

    // The k-th pass takes the least key above the (k-1)-th winner's:
    // keys are unique (node id in the low word), so this excludes
    // exactly the earlier winners.  Only node_num passes are needed:
    // admission asks whether the node_num-th minimum is finite.
    unsigned long long prev = 0, mine = kInfKey;
    bool ok = false;
    if (valid && nn >= 1 && nn <= K) {
      for (int k = 0; k < nn; ++k) {
        unsigned long long best = kInfKey;
        for (int n = tid; n < N; n += blockDim.x) {
          if (!erow[n] || !place::node_fits(avail, n, R, s_job)) continue;
          const unsigned long long key = place::node_key(cost[n], n);
          if ((k == 0 || key > prev) && key < best) best = key;
        }
        prev = place::block_min(best, s_red);
        if (k == tid) mine = prev;
      }
      ok = (unsigned)(prev >> 32) != kCostInfBiased;
    }

    // winners: thread k owns the k-th cheapest node (distinct nodes)
    if (ok && tid < nn) {
      const int n = place::key_node(mine);
      int32_t* a = avail + (size_t)n * R;
      for (int r = 0; r < R; ++r)
        a[r] = (int32_t)((unsigned)a[r] - (unsigned)s_job[r]);
      const float d = __fdiv_rn(
          __fmul_rn(__fmul_rn((float)tl, (float)s_job[0]), 16.0f),
          cpu_total[n]);
      cost[n] = (int32_t)((unsigned)cost[n] + (unsigned)__float2int_rn(d));
    }
    const size_t out = (size_t)s * L + j;
    if (tid < K) {
      chosen[out * K + tid] =
          (ok && tid < nn) ? place::key_node(mine) : -1;
    }
    if (tid == 0) {
      const bool never = !valid || nn <= 0 || nelig[cls] < nn;
      placed[out] = ok ? 1 : 0;
      reason[out] = ok ? kReasonNone
                       : (never ? kReasonConstraint : kReasonResource);
    }
    __syncthreads();  // updates visible, s_job free for the next job
  }
}

}  // namespace

extern "C" int greedy_place_launch(const void* jobs, const void* nelig,
                                   const void* elig, const void* cpu_total,
                                   void* avail, void* cost, void* placed,
                                   void* reason, void* chosen, int S, int N,
                                   int R, int L, int K, void* stream) {
  if (R + 4 > kMaxFields) return (int)cudaErrorInvalidValue;
  greedy_place_kernel<<<S, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)jobs, (const int32_t*)nelig, (const uint8_t*)elig,
      (const float*)cpu_total, (int32_t*)avail, (int32_t*)cost,
      (int32_t*)placed, (int32_t*)reason, (int32_t*)chosen, N, R, L, K);
  return (int)cudaGetLastError();
}

extern "C" int greedy_place_max_fields() { return kMaxFields; }
