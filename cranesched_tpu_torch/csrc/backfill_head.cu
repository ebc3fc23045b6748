// The backfill head: the time-axis solve of a priority-ordered batch of
// jobs over the [N, T, R] time map, in ONE launch.
//
// Replaces no Pallas kernel.  It is the on-card form of the JAX package's
// cranesched_tpu/models/solver_time.py::solve_backfill (a lax.scan over the
// jobs), whose port as a per-job PyTorch loop is
// models/solver_time.py::solve_backfill_plain.  It computes what that loop
// computes, bit for bit: for each job in order, the buckets each eligible
// node fits the request in; per start bucket s the nodes that fit over the
// whole window [s, e(s)); the first s with node_num such nodes (else
// NO_START); the decide_job admission and pending reason; on admission the
// node_num cheapest of them at s (ties to the lowest node id), the request
// subtracted from their rows over [s, e(s)) and round(tl*cpu*16/cpu_total)
// added to their cost.
//
// What bounds it on an H100: at the benchmark's shapes (N = 10,000 nodes,
// T = 64 buckets, R = 3 dims, J = 1,024 jobs, gangs of 1-2) the bytes are
// the time map read and written once (2 x 7.7 MB) plus the J part_mask rows
// (10 MB), ~25 MB or ~8 us at 3.35 TB/s; the operations are fewer still.
// The floor is the dependence between jobs: each job must see the time map
// its predecessor left, and its nodes are spread over the whole card, so a
// job costs two grid-wide barriers.  The design is latency-bound by those
// 2 x J barriers.
//
// What the design does about it:
// - one persistent, cooperative launch: every block is resident for the
//   whole solve, and block b OWNS the contiguous node slice [b * slice,
//   (b + 1) * slice).  Its slice of the time map and of the cost ledger sits
//   in dynamic shared memory for all J jobs (76 x 64 x 3 int32 = 58 KB at
//   the benchmark's shapes) and is written back once at the end; the wrapper
//   picks, by size before the launch, device memory for a slice that does
//   not fit (the same code, a template flag);
// - per job, (a) each node's fit mask, one 64-bit word per 64 buckets from
//   two warp ballots, so that "every bucket of [s, e) fits" is a masked
//   compare; (b) the block's per-start counts and eligible count into a
//   global [T + 1] array by integer atomics; grid barrier 1; (c) every block
//   takes the same decision from the counts and offers its own node_num
//   cheapest candidates at s (place_common.cuh's walk and block top-k, or a
//   rank count for gangs above kKMax); grid barrier 2; (d) each offer's rank
//   among all the blocks' offers (a lower bound in each sorted list), and
//   the owners of the winners update their rows and write the output;
// - two grid barriers a job are all it takes.  The counts are
//   double-buffered by the parity of the job: the counts of job j - 1 are
//   zeroed during job j by block 0, after every block read them before
//   barrier 2 of job j - 1.  The offers need no second buffer: a block
//   writes job j + 1's only after barrier 1 of job j + 1, which every
//   block reaches after it has read job j's in (d).
//
// Arithmetic that must match the reference bit for bit: the window end is
// edges[s] + max(tl, 1) in int32 (wrapping as the reference's add does)
// and a lower-bound search over the edges, clipped to T; the cost increment
// uses the round-to-nearest intrinsics in the reference's association, with
// round-half-to-even on the conversion; costs and the time map are updated
// in uint32 so a wrap matches the reference's int32 add.  Never build this
// file with --use_fast_math.

#include <cooperative_groups.h>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

#include "place_common.cuh"

namespace {

namespace cg = cooperative_groups;
using place::Key;
using place::kInfKey;
using place::kKMax;
using place::kThreads;
using place::kWarps;

constexpr int kReasonNone = 0;
constexpr int kReasonResource = 1;
constexpr int kReasonConstraint = 2;
constexpr int kNoStart = 1 << 30;  // solver_time.NO_START
constexpr int kMaxK = 1024;        // chosen columns the launcher accepts

template <int KK>
using Depth = std::integral_constant<int, KK>;

// ---- dynamic shared memory layout (mirrored in models/solver_time.py) ----

__host__ __device__ inline int mask_words(int T) { return (T + 63) / 64; }

struct HeadLayout {
  size_t red, first, cnt, edges, ends, own, rank, elig, fit, keys, state,
      cost, total;
};

// red: block_topk's 2 parities x kKMax ranks x kWarps keys; first: the
// first start, 2 parities; cnt: the block's T per-start counts and its
// eligible count; edges: T + 1; ends: T; own: the block's K offered keys;
// rank: their K ranks; elig: a byte per owned node; fit: W words per
// owned node; keys: a key per owned node (gangs above kKMax); state, when
// smem_state: the owned rows of the time map (slice x T x R int32), then
// the owned costs (slice int32).
__host__ __device__ inline HeadLayout head_layout(int slice, int T, int R,
                                                  int K, bool smem_state) {
  using place::align16;
  HeadLayout l;
  size_t off = 0;
  l.red = off;
  off += align16(sizeof(Key) * 2 * kKMax * kWarps);
  l.first = off;
  off += align16(sizeof(int32_t) * 2);
  l.cnt = off;
  off += align16(sizeof(int32_t) * (T + 1));
  l.edges = off;
  off += align16(sizeof(int32_t) * (T + 1));
  l.ends = off;
  off += align16(sizeof(int32_t) * T);
  l.own = off;
  off += align16(sizeof(Key) * K);
  l.rank = off;
  off += align16(sizeof(int32_t) * K);
  l.elig = off;
  off += align16((size_t)slice);
  l.fit = off;
  off += align16(sizeof(uint64_t) * slice * (size_t)mask_words(T));
  l.keys = off;
  off += align16(sizeof(Key) * slice);
  l.state = off;
  if (smem_state) off += align16(sizeof(int32_t) * (size_t)slice * T * R);
  l.cost = off;
  if (smem_state) off += align16(sizeof(int32_t) * (size_t)slice);
  l.total = off;
  return l;
}

// Are bits [lo, hi) of the node's fit mask all set?  (lo == hi: yes.)
__device__ __forceinline__ bool all_set(const uint64_t* fit, int lo, int hi) {
  for (int w = lo >> 6; (w << 6) < hi; ++w) {
    const int a = max(lo - (w << 6), 0);
    const int b = min(hi - (w << 6), 64);
    const uint64_t m =
        (b == 64 ? ~0ull : (1ull << b) - 1) & ~((1ull << a) - 1);
    if ((fit[w] & m) != m) return false;
  }
  return true;
}

// time_avail: int32[N, T, R] updated in place; cost: int32[N] updated in
//             place; cpu_total: float32[N] max(total cpu, 1); alive:
//             uint8[N]; edges: int32[T + 1]
// req: int32[J, R]; node_num, time_limit: int32[J]; valid: uint8[J];
//             part_mask: uint8[J, N]
// placed: uint8[J]; start, reason: int32[J]; nodes: int32[J, K]
// cnt: int32[2, T + 1] zeroed; pub: uint64[B, K] (the offers)
template <bool SMEM>
__global__ void __launch_bounds__(kThreads, 1) backfill_head_kernel(
    int32_t* time_avail, int32_t* cost, const float* __restrict__ cpu_total,
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ edges,
    const int32_t* __restrict__ req, const int32_t* __restrict__ node_num,
    const int32_t* __restrict__ time_limit,
    const uint8_t* __restrict__ valid, const uint8_t* __restrict__ part_mask,
    uint8_t* __restrict__ placed, int32_t* __restrict__ start,
    int32_t* __restrict__ nodes, int32_t* __restrict__ reason, int32_t* cnt,
    Key* pub, int N, int T, int R, int J, int K, int slice) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const HeadLayout lay = head_layout(slice, T, R, K, SMEM);
  auto* s_red = reinterpret_cast<Key*>(smem + lay.red);
  auto* s_first = reinterpret_cast<int32_t*>(smem + lay.first);
  auto* s_cnt = reinterpret_cast<int32_t*>(smem + lay.cnt);
  auto* s_edges = reinterpret_cast<int32_t*>(smem + lay.edges);
  auto* s_ends = reinterpret_cast<int32_t*>(smem + lay.ends);
  auto* s_own = reinterpret_cast<Key*>(smem + lay.own);
  auto* s_rank = reinterpret_cast<int32_t*>(smem + lay.rank);
  auto* s_elig = smem + lay.elig;
  auto* s_fit = reinterpret_cast<uint64_t*>(smem + lay.fit);
  auto* s_keys = reinterpret_cast<Key*>(smem + lay.keys);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int B = gridDim.x;
  const int b = blockIdx.x;
  const int n0 = b * slice;
  const int m = max(0, min(slice, N - n0));
  const int W = mask_words(T);
  const size_t row = (size_t)T * R;  // ints of one node's time map
  int32_t* ta = SMEM ? reinterpret_cast<int32_t*>(smem + lay.state)
                     : time_avail + (size_t)n0 * row;
  int32_t* co = SMEM ? reinterpret_cast<int32_t*>(smem + lay.cost)
                     : cost + n0;

  if (SMEM) {
    for (size_t x = tid; x < (size_t)m * row; x += kThreads)
      ta[x] = time_avail[(size_t)n0 * row + x];
    for (int x = tid; x < m; x += kThreads) co[x] = cost[n0 + x];
  }
  for (int x = tid; x <= T; x += kThreads) {
    s_edges[x] = edges[x];
    s_cnt[x] = 0;
  }
  if (tid < 2) s_first[tid] = kNoStart;
  __syncthreads();

  for (int j = 0; j < J; ++j) {
    const int p = j & 1;
    int32_t* gcnt = cnt + p * (T + 1);
    const int32_t* q = req + (size_t)j * R;
    const int nn = __ldg(node_num + j);
    const int tl = __ldg(time_limit + j);

    // (a) the window ends, the owned nodes' eligibility and fit masks
    for (int s = tid; s < T; s += kThreads) {
      const int32_t t_end =
          (int32_t)((uint32_t)s_edges[s] + (uint32_t)max(tl, 1));
      int lo = 0, hi = T + 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (s_edges[mid] < t_end) lo = mid + 1;
        else hi = mid;
      }
      s_ends[s] = min(lo, T);
    }
    int ne = 0;
    for (int i = tid; i < m; i += kThreads) {
      const bool e = __ldg(alive + n0 + i) != 0 &&
                     __ldg(part_mask + (size_t)j * N + n0 + i) != 0;
      s_elig[i] = e;
      ne += e;
    }
    if (ne) atomicAdd(s_cnt + T, ne);
    // a warp per (node, word), a ballot per 32 buckets
    for (int x = warp; x < m * W; x += kWarps) {
      const int i = x / W;
      const int w = x - i * W;
      uint64_t word = 0;
      for (int h = 0; h < 2; ++h) {
        const int t = w * 64 + h * 32 + lane;
        bool fit = t < T;
        if (fit) {
          const int32_t* a = ta + (size_t)i * row + (size_t)t * R;
          for (int r = 0; r < R; ++r) fit &= __ldg(q + r) <= a[r];
        }
        word |= (uint64_t)__ballot_sync(0xffffffffu, fit) << (32 * h);
      }
      if (lane == 0) s_fit[(size_t)i * W + w] = word;
    }
    __syncthreads();

    // (b) per start s, the owned nodes that fit over [s, e(s)); G groups
    // of nodes per start when T leaves threads over
    const int G = max(1, kThreads / T);
    for (int x = tid; x < T * G; x += kThreads) {
      const int s = x % T;
      const int g = x / T;
      const int e = s_ends[s];
      const int lo = min(s, e), hi = max(s, e);
      int c = 0;
      for (int i = g; i < m; i += G)
        c += s_elig[i] && all_set(s_fit + (size_t)i * W, lo, hi);
      if (c) atomicAdd(s_cnt + s, c);
    }
    __syncthreads();
    for (int s = tid; s <= T; s += kThreads) {
      const int c = s_cnt[s];
      if (c) atomicAdd(gcnt + s, c);
      s_cnt[s] = 0;
    }
    if (b == 0) {
      // job j - 1's counts (and job j + 1's): every block read them
      // before barrier 2 of job j - 1
      int32_t* other = cnt + (p ^ 1) * (T + 1);
      for (int s = tid; s <= T; s += kThreads) other[s] = 0;
      for (int k = tid; k < K; k += kThreads) nodes[(size_t)j * K + k] = -1;
    }

    grid.sync();  // 1: the counts are whole

    // (c) the same decision in every block: the first start with nn nodes
    {
      int first = kNoStart;
      for (int s = tid; s < T; s += kThreads) {
        if (__ldcg(gcnt + s) >= nn) {
          first = s;
          break;
        }
      }
      first = __reduce_min_sync(0xffffffffu, first);
      if (lane == 0 && first != kNoStart) atomicMin(s_first + p, first);
      if (tid == 0) s_first[p ^ 1] = kNoStart;
    }
    const int nelig = __ldcg(gcnt + T);
    __syncthreads();
    const int s = s_first[p];
    const bool row_ok = __ldg(valid + j) != 0;
    const bool ok = row_ok && nn > 0 && nn <= K && s != kNoStart;
    if (b == 0 && tid == 0) {
      placed[j] = ok;
      start[j] = s;
      reason[j] = ok ? kReasonNone
                     : (!row_ok || nn <= 0 || nelig < nn ? kReasonConstraint
                                                         : kReasonResource);
    }
    const int es = s_ends[min(s, T - 1)];  // e(s); s < T when ok
    if (ok) {
      // the block's offer: its nn least (cost, node) keys at column s,
      // ascending, kInfKey-padded
      const int lo = min(s, es), hi = max(s, es);
      auto cand = [&](int i, int32_t& c) -> bool {
        c = co[i];
        return s_elig[i] && c != INT32_MAX &&
               all_set(s_fit + (size_t)i * W, lo, hi);
      };
      if (nn <= kKMax) {
        auto offer = [&](auto depth) {
          constexpr int KK = decltype(depth)::value;
          Key top[KK], win[KK];
          place::walk_topk(m, cand, top);
          place::block_topk(top, nn, s_red, p, win);
          if (tid < nn) {
            Key k = place::pick(win, tid);
            // the node id in place of the slot: the same order
            if (place::key_finite(k))
              k = place::make_key(place::key_cost(k),
                                  (unsigned)(n0 + place::key_slot(k)));
            pub[(size_t)b * K + tid] = k;
            s_own[tid] = k;
          }
        };
        if (nn == 1) offer(Depth<1>());
        else if (nn == 2) offer(Depth<2>());
        else if (nn <= 4) offer(Depth<4>());
        else offer(Depth<kKMax>());
      } else {
        // a gang above kKMax: each candidate's rank among the block's
        for (int i = tid; i < m; i += kThreads) {
          int32_t c;
          s_keys[i] = cand(i, c) ? place::make_key(c, (unsigned)(n0 + i))
                                 : kInfKey;
        }
        for (int r = tid; r < nn; r += kThreads) {
          pub[(size_t)b * K + r] = kInfKey;
          s_own[r] = kInfKey;
        }
        __syncthreads();
        for (int i = tid; i < m; i += kThreads) {
          const Key k = s_keys[i];
          if (k == kInfKey) continue;
          int r = 0;
          for (int x = 0; x < m; ++x) r += s_keys[x] < k;
          if (r < nn) {
            pub[(size_t)b * K + r] = k;
            s_own[r] = k;
          }
        }
      }
      for (int r = tid; r < nn; r += kThreads) s_rank[r] = 0;
    }

    grid.sync();  // 2: the offers are whole

    if (ok) {
      // (d) each own offer's rank among every block's (keys are unique,
      // so the lower bounds sum to it)
      for (int x = tid; x < nn * B; x += kThreads) {
        const int i = x / B;
        const Key k = s_own[i];
        if (!place::key_finite(k)) continue;
        const Key* list = pub + (size_t)(x - i * B) * K;
        int lo = 0, hi = nn;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (__ldcg(list + mid) < k) lo = mid + 1;
          else hi = mid;
        }
        if (lo) atomicAdd(s_rank + i, lo);
      }
      __syncthreads();
      // the winners' owners take the job: req over [s, e(s)) of their rows
      // and round(tl * cpu * 16 / cpu_total) on their cost
      for (int x = tid; x < nn * T; x += kThreads) {
        const int i = x / T;
        const int t = x - i * T;
        const Key k = s_own[i];
        if (!place::key_finite(k) || s_rank[i] >= nn) continue;
        const int node = place::key_slot(k);
        const int li = node - n0;
        if (t >= s && t < es) {
          int32_t* a = ta + (size_t)li * row + (size_t)t * R;
          for (int r = 0; r < R; ++r)
            a[r] = (int32_t)((uint32_t)a[r] - (uint32_t)__ldg(q + r));
        }
        if (t == 0) {
          const float d = __fdiv_rn(
              __fmul_rn(__fmul_rn((float)tl, (float)__ldg(q)), 16.0f),
              cpu_total[node]);
          co[li] = (int32_t)((uint32_t)co[li] + (uint32_t)__float2int_rn(d));
          nodes[(size_t)j * K + s_rank[i]] = node;
        }
      }
    }
    __syncthreads();  // the updates, before the next job's masks
  }

  if (SMEM) {
    for (size_t x = tid; x < (size_t)m * row; x += kThreads)
      time_avail[(size_t)n0 * row + x] = ta[x];
    for (int x = tid; x < m; x += kThreads) cost[n0 + x] = co[x];
  }
}

using Kernel = void (*)(int32_t*, int32_t*, const float*, const uint8_t*,
                        const int32_t*, const int32_t*, const int32_t*,
                        const int32_t*, const uint8_t*, const uint8_t*,
                        uint8_t*, int32_t*, int32_t*, int32_t*, int32_t*,
                        Key*, int, int, int, int, int, int);

}  // namespace

// One cooperative launch of `blocks` blocks of place::kThreads threads,
// block b owning nodes [b * slice, min((b + 1) * slice, N)).  blocks,
// slice and smem_bytes come from the wrapper's plan
// (solver_time.head_launch_plan); this checks them: every block owns at
// least one node, smem_bytes is head_layout(...).total, and the blocks fit
// on the card at once.  cnt must be zeroed; nothing else is read before it
// is written.
extern "C" int backfill_head_launch(
    void* time_avail, void* cost, const void* cpu_total, const void* alive,
    const void* edges, const void* req, const void* node_num,
    const void* time_limit, const void* valid, const void* part_mask,
    void* placed, void* start, void* nodes, void* reason, void* cnt,
    void* pub, int N, int T, int R, int J, int K, int blocks, int slice,
    int smem_state, int smem_bytes, void* stream) {
  if (N < 1 || T < 1 || R < 1 || J < 0 || K < 0 || K > kMaxK ||
      blocks < 1 || slice < 1 || (long long)(blocks - 1) * slice >= N ||
      (long long)blocks * slice < N)
    return (int)cudaErrorInvalidValue;
  const HeadLayout lay = head_layout(slice, T, R, K, smem_state != 0);
  if ((size_t)smem_bytes != lay.total) return (int)cudaErrorInvalidValue;
  const Kernel kern = smem_state ? backfill_head_kernel<true>
                                 : backfill_head_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem_bytes);
  if (e != cudaSuccess) return (int)e;
  if (blocks > sms * per_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  auto* a_ta = static_cast<int32_t*>(time_avail);
  auto* a_cost = static_cast<int32_t*>(cost);
  auto* a_cpu = static_cast<const float*>(cpu_total);
  auto* a_alive = static_cast<const uint8_t*>(alive);
  auto* a_edges = static_cast<const int32_t*>(edges);
  auto* a_req = static_cast<const int32_t*>(req);
  auto* a_nn = static_cast<const int32_t*>(node_num);
  auto* a_tl = static_cast<const int32_t*>(time_limit);
  auto* a_valid = static_cast<const uint8_t*>(valid);
  auto* a_pm = static_cast<const uint8_t*>(part_mask);
  auto* a_placed = static_cast<uint8_t*>(placed);
  auto* a_start = static_cast<int32_t*>(start);
  auto* a_nodes = static_cast<int32_t*>(nodes);
  auto* a_reason = static_cast<int32_t*>(reason);
  auto* a_cnt = static_cast<int32_t*>(cnt);
  auto* a_pub = static_cast<Key*>(pub);
  void* args[] = {&a_ta,     &a_cost,   &a_cpu,    &a_alive, &a_edges,
                  &a_req,    &a_nn,     &a_tl,     &a_valid, &a_pm,
                  &a_placed, &a_start,  &a_nodes,  &a_reason, &a_cnt,
                  &a_pub,    &N,        &T,        &R,       &J,
                  &K,        &slice};
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(blocks),
                                  dim3(kThreads), args, (size_t)smem_bytes,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
