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
// it measures.  Each variant is greedy_place.cu's per-job loop stripped
// to a prefix of its stages, built from the same code (place_common.cuh):
// one 1024-thread block walks every job in order, stages the job's
// scalars in shared memory behind a barrier (all variants), walks the
// nodes with a stride of the block size testing the request against
// avail (bcast and on), reduces a 64-bit (cost, id) key per node to the
// block minimum (onemin: one pass; select: two, as greedy_place does for
// a gang of two), and ends the job at a barrier.  The differences of the
// variants' times attribute greedy_place's time per job to its stages.
//
// select does not use greedy_place's "least key above the previous
// winner": with no feasible node the reference's second pass picks node 0
// again (every masked cost is INT32_MAX), which that trick would not.
// Every node takes part in the minimum with its masked cost, and the
// first winner is masked by id.  bcast's checksum reads node 0 only, so
// each thread also counts its feasible nodes into side[tid]: without a
// use of every node's verdict the compiler would drop the walk.
// Never build this file with --use_fast_math.

#include <cstdint>
#include <cuda_runtime.h>

#include "place_common.cuh"

namespace {

using place::kInfKey;
using place::kMaxFields;
using place::kThreads;

enum Kind { kFloor = 0, kBcast = 1, kOneMin = 2, kSelect = 3 };
constexpr int32_t kCostInf = 0x7fffffff;

// One pass of the masked minimum over every node; ``skip`` is masked to
// INT32_MAX by id (the previous winner), -1 for none.
__device__ __forceinline__ unsigned long long masked_min_pass(
    const int32_t* __restrict__ avail, const int32_t* __restrict__ cost,
    int N, int R, const int32_t* s_job, int skip,
    unsigned long long* s_red) {
  unsigned long long best = kInfKey;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const bool fit = n != skip && place::node_fits(avail, n, R, s_job);
    const unsigned long long key = place::node_key(fit ? cost[n] : kCostInf,
                                                   n);
    if (key < best) best = key;
  }
  return place::block_min(best, s_red);
}

template <int KIND>
__global__ void __launch_bounds__(kThreads) kattr_kernel(
    const int32_t* __restrict__ job, const int32_t* __restrict__ avail,
    const int32_t* __restrict__ cost, int32_t* __restrict__ out,
    int32_t* __restrict__ side, int J, int N, int R, int BJ) {
  __shared__ int32_t s_job[kMaxFields];
  __shared__ unsigned long long s_red[33];
  __shared__ unsigned s_acc;
  const int F = R + 4;
  const int tid = threadIdx.x;
  unsigned acc = 0;        // floor and bcast: thread 0's accumulator
  unsigned feasible = 0;   // bcast: this thread's feasible nodes

  for (int j = 0; j < J; ++j) {
    place::stage_job(job + j, (size_t)J, F, s_job);
    unsigned s = 0;
    for (int f = 0; f < F; ++f) s += (unsigned)s_job[f];

    if (KIND == kFloor) {
      acc += s;
    } else if (KIND == kBcast) {
      for (int n = tid; n < N; n += blockDim.x) {
        const bool fit = place::node_fits(avail, n, R, s_job);
        feasible += fit ? 1u : 0u;
        if (n == 0) acc += fit ? 1u : 0u;   // node 0 is thread 0's
      }
    } else if (KIND == kOneMin) {
      const unsigned long long m =
          masked_min_pass(avail, cost, N, R, s_job, -1, s_red);
      if (tid == 0) out[j] = (int32_t)(s + (unsigned)place::key_cost(m));
    } else {
      const unsigned long long m1 =
          masked_min_pass(avail, cost, N, R, s_job, -1, s_red);
      const unsigned long long m2 = masked_min_pass(
          avail, cost, N, R, s_job, place::key_node(m1), s_red);
      if (tid == 0) {
        out[j] = (int32_t)(s + (unsigned)place::key_cost(m2) +
                           (unsigned)place::key_node(m2));
      }
    }

    if ((KIND == kFloor || KIND == kBcast) && (j + 1) % BJ == 0) {
      // the end of a block of BJ jobs: every lane holds the accumulator
      if (tid == 0) s_acc = acc;
      __syncthreads();
      for (int l = tid; l < BJ; l += blockDim.x)
        out[j + 1 - BJ + l] = (int32_t)s_acc;
    }
    __syncthreads();  // s_job free for the next job
  }
  if (KIND == kBcast) side[tid] = (int32_t)feasible;
}

}  // namespace

// kind: 0 floor, 1 bcast, 2 onemin, 3 select.  job int32[R + 4, J],
// avail int32[N, R], cost int32[N], out int32[J], side int32[1024].
extern "C" int kattr_launch(int kind, const void* job, const void* avail,
                            const void* cost, void* out, void* side, int J,
                            int N, int R, int BJ, void* stream) {
  if (R + 4 > kMaxFields || BJ < 1 || J % BJ != 0)
    return (int)cudaErrorInvalidValue;
  const int32_t* jb = (const int32_t*)job;
  const int32_t* av = (const int32_t*)avail;
  const int32_t* co = (const int32_t*)cost;
  int32_t* o = (int32_t*)out;
  int32_t* sd = (int32_t*)side;
  cudaStream_t st = (cudaStream_t)stream;
  switch (kind) {
    case kFloor:
      kattr_kernel<kFloor><<<1, kThreads, 0, st>>>(jb, av, co, o, sd, J, N,
                                                   R, BJ);
      break;
    case kBcast:
      kattr_kernel<kBcast><<<1, kThreads, 0, st>>>(jb, av, co, o, sd, J, N,
                                                   R, BJ);
      break;
    case kOneMin:
      kattr_kernel<kOneMin><<<1, kThreads, 0, st>>>(jb, av, co, o, sd, J,
                                                    N, R, BJ);
      break;
    case kSelect:
      kattr_kernel<kSelect><<<1, kThreads, 0, st>>>(jb, av, co, o, sd, J,
                                                    N, R, BJ);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
