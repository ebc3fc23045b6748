// Per-job building blocks shared by the greedy-placement kernel
// (greedy_place.cu) and its attribution variants (kattr_variants.cu), so
// that a variant's time measures exactly the stage it keeps of the real
// kernel.  One 1024-thread block walks the jobs in order; for each job it
// stages the job's scalars in shared memory, walks the nodes with a
// stride of the block size, and reduces a 64-bit key per node to the
// block minimum.
//
// The key orders nodes by signed int32 cost and then by the lowest node
// id: (cost XOR 0x80000000) in the high word, the id in the low word.
// The biased cost of COST_INF (int32 max) is all ones.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace place {

constexpr int kThreads = 1024;
constexpr int kMaxFields = 64;           // R + 4 job scalars
constexpr unsigned kCostInfBiased = 0xffffffffu;
constexpr unsigned long long kInfKey = ~0ull;

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
  for (int off = 16; off > 0; off >>= 1) {
    unsigned long long o = __shfl_down_sync(0xffffffffu, v, off);
    v = o < v ? o : v;
  }
  return v;
}

// Block-wide minimum; every thread gets the result.  s_red holds one
// slot per warp plus the broadcast slot.
__device__ __forceinline__ unsigned long long block_min(
    unsigned long long v, unsigned long long* s_red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    v = lane < nwarps ? s_red[lane] : kInfKey;
    v = warp_min(v);
    if (lane == 0) s_red[32] = v;
  }
  __syncthreads();
  return s_red[32];
}

// Copy one job's F scalars (stride apart in global memory) into shared
// memory and make them visible to the block.
__device__ __forceinline__ void stage_job(const int32_t* __restrict__ row,
                                          size_t stride, int F,
                                          int32_t* s_job) {
  if ((int)threadIdx.x < F) s_job[threadIdx.x] = row[threadIdx.x * stride];
  __syncthreads();
}

// Does the request s_job[0..R) fit node n of avail[N, R]?
__device__ __forceinline__ bool node_fits(const int32_t* avail, int n, int R,
                                          const int32_t* s_job) {
  const int32_t* a = avail + (size_t)n * R;
  bool fit = true;
  for (int r = 0; r < R; ++r) fit &= a[r] >= s_job[r];
  return fit;
}

__device__ __forceinline__ unsigned long long node_key(int32_t cost, int n) {
  return ((unsigned long long)((unsigned)cost ^ 0x80000000u) << 32) |
         (unsigned)n;
}

__device__ __forceinline__ int32_t key_cost(unsigned long long key) {
  return (int32_t)((unsigned)(key >> 32) ^ 0x80000000u);
}

__device__ __forceinline__ int key_node(unsigned long long key) {
  return (int)(unsigned)(key & 0xffffffffu);
}

}  // namespace place
