"""The greedy placement cycle as ONE hand-written CUDA kernel (port of
``cranesched_tpu/models/pallas_solver.py``).

``greedy_place`` is the kernel wrapper.  Its inputs are the solve laid
out for the kernel (``csrc/greedy_place.cu``):

* ``jobs``   int32[S, L, R+4]: per job the req dims, node_num,
  time_limit, valid and eligibility class — S streams of L jobs;
* ``nelig``  int32[C]: eligible (alive) nodes per class;
* ``elig``   bool[C, N]: class masks AND alive;
* ``cpu_total`` float32[N]; ``avail`` int32[N, R] and ``cost`` int32[N],
  both updated in place.

On a CUDA tensor it launches the kernel, or raises; on a CPU tensor it
runs ``greedy_place_plain``, the same function as a per-job loop over
``models/solver.py``.  ``greedy_place.launches`` counts kernel launches.

The entry points mirror the JAX package's Pallas ones:
``solve_greedy_gpu`` (one serial stream), ``solve_greedy_gpu_auto``
(S streams when the eligibility classes are pairwise disjoint and
balanced, else serial) and ``solve_greedy_gpu_from_batch`` (dense
part_mask adapter).  Semantics are bit-identical to
``solver.solve_greedy``; the cluster state is updated in place.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cranesched_tpu_torch.models.solver import (
    REASON_CONSTRAINT,
    ClusterState,
    JobBatch,
    Placements,
    _place_one,
    cpu_total_of,
)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def classes_from_part_mask(part_mask) -> tuple[np.ndarray, np.ndarray]:
    """Host-side helper: compress a dense [J, N] eligibility matrix into
    (job_class[J], class_masks[C, N])."""
    pm = _host(part_mask).astype(bool)
    classes, inverse = np.unique(pm, axis=0, return_inverse=True)
    return inverse.reshape(-1).astype(np.int32), classes


# ---- the kernel and its plain version ----


def greedy_place_plain(jobs, nelig, elig, cpu_total, avail, cost, k: int):
    """Plain PyTorch version of the kernel: the S streams one after the
    other, each job through ``solver._place_one``.  Same signature and
    outputs as ``greedy_place``: ``(placed, reason, chosen)`` int32
    ``[S, L]``, ``[S, L]``, ``[S, L, K]``; avail/cost updated in place.
    ``nelig`` is implied by ``elig`` here (the eligible count of the
    job's class row)."""
    S, L, F = jobs.shape
    R = F - 4
    dev = jobs.device
    # an invalid row (stream padding) is refused with CONSTRAINT and
    # touches nothing — what _place_one returns for it — so it is
    # written directly instead of run
    placed = torch.zeros((S, L), dtype=torch.int32, device=dev)
    reason = torch.full((S, L), REASON_CONSTRAINT, dtype=torch.int32,
                        device=dev)
    chosen = torch.full((S, L, k), -1, dtype=torch.int32, device=dev)
    live = (jobs[:, :, R + 2] != 0).cpu().numpy()
    for s in range(S):
        rows = np.nonzero(live[s])[0].tolist()
        oks, whys, chs = [], [], []
        for j in rows:
            row = jobs[s, j]
            erow = elig.index_select(0, row[R + 3:R + 4].long())[0]
            ok, ch, why = _place_one(
                avail, cost, cpu_total, erow, row[:R], row[R], row[R + 1],
                erow, row[R + 2] != 0, k)
            oks.append(ok)
            whys.append(why)
            chs.append(ch)
        if rows:
            idx = torch.as_tensor(rows, device=dev)
            placed[s, idx] = torch.stack(oks).to(torch.int32)
            reason[s, idx] = torch.stack(whys)
            chosen[s, idx] = torch.stack(chs).to(torch.int32)
    return placed, reason, chosen


def _kernel():
    from cranesched_tpu_torch.kernels.build import load

    lib = load("greedy_place")
    fn = lib.greedy_place_launch
    if fn.argtypes is None:
        # without argtypes ctypes passes each pointer as a 32-bit int
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


# threads per block in greedy_place.cu; thread k owns the k-th winner
_KERNEL_THREADS = 1024
_MAX_FIELDS = 64


def _check(jobs, nelig, elig, cpu_total, avail, cost, k):
    dev = jobs.device
    for name, t, dtypes in (("jobs", jobs, (torch.int32,)),
                            ("nelig", nelig, (torch.int32,)),
                            ("elig", elig, (torch.bool, torch.uint8)),
                            ("cpu_total", cpu_total, (torch.float32,)),
                            ("avail", avail, (torch.int32,)),
                            ("cost", cost, (torch.int32,))):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, jobs on {dev}")
        if t.dtype not in dtypes:
            raise TypeError(f"{name} has dtype {t.dtype}, want {dtypes}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if jobs.dim() != 3 or avail.dim() != 2 or elig.dim() != 2:
        raise ValueError("jobs must be [S, L, R+4], avail [N, R], "
                         "elig [C, N]")
    n, r = avail.shape
    if jobs.shape[2] != r + 4 or r + 4 > _MAX_FIELDS:
        raise ValueError(f"jobs has {jobs.shape[2]} fields, avail has "
                         f"{r} dims (need R + 4 <= {_MAX_FIELDS})")
    if (elig.shape[1] != n or cost.shape != (n,)
            or cpu_total.shape != (n,) or nelig.shape != (elig.shape[0],)):
        raise ValueError("elig/cost/cpu_total/nelig shapes disagree with "
                         "avail")
    if not 0 <= k <= min(n, _KERNEL_THREADS):
        raise ValueError(f"K={k} outside [0, min(N, {_KERNEL_THREADS})]")


def greedy_place(jobs, nelig, elig, cpu_total, avail, cost, k: int):
    """Kernel wrapper: see the module docstring.  CPU tensors take
    ``greedy_place_plain``; CUDA tensors launch the kernel on the current
    stream or raise.  Outputs are allocated here."""
    if jobs.device.type == "cpu":
        return greedy_place_plain(jobs, nelig, elig, cpu_total, avail,
                                  cost, k)
    _check(jobs, nelig, elig, cpu_total, avail, cost, k)
    S, L, _ = jobs.shape
    n, r = avail.shape
    dev = jobs.device
    placed = torch.empty((S, L), dtype=torch.int32, device=dev)
    reason = torch.empty((S, L), dtype=torch.int32, device=dev)
    chosen = torch.empty((S, L, k), dtype=torch.int32, device=dev)
    if S == 0 or L == 0:
        return placed, reason, chosen
    fn = _kernel()
    rc = fn(jobs.data_ptr(), nelig.data_ptr(), elig.data_ptr(),
            cpu_total.data_ptr(), avail.data_ptr(), cost.data_ptr(),
            placed.data_ptr(), reason.data_ptr(), chosen.data_ptr(),
            S, n, r, L, k, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"greedy_place launch failed: CUDA error {rc}")
    greedy_place.launches += 1
    return placed, reason, chosen


greedy_place.launches = 0


# ---- layout around the kernel ----


def _fold_cluster(state: ClusterState, class_masks: torch.Tensor):
    """Per-class eligibility (class mask AND alive), eligible counts and
    the cost divisor."""
    elig = (class_masks.to(torch.bool) & state.alive[None, :]).contiguous()
    nelig = elig.sum(dim=1, dtype=torch.int32)
    return elig, nelig, cpu_total_of(state)


def _job_scalars(req, node_num, time_limit, valid, job_class, C):
    return torch.cat([
        req.to(torch.int32),
        node_num.to(torch.int32)[:, None],
        time_limit.to(torch.int32)[:, None],
        valid.to(torch.int32)[:, None],
        job_class.to(torch.int32).clamp(0, C - 1)[:, None],
    ], dim=1)                                          # [J, R + 4]


def kernel_inputs(state: ClusterState, req, node_num, time_limit, valid,
                  job_class, class_masks, max_nodes: int, plan=None):
    """Lay one solve out for the kernel: ``(jobs, nelig, elig,
    cpu_total, K, slot)``.  ``jobs`` is [1, J, R+4] for the serial
    kernel (``plan`` None) or [S, L, R+4] with the jobs regrouped per
    stream (classes were packed into streams by ``plan_streams``, which
    verified their disjointness); ``slot[j]`` is job j's flat index into
    the [S * L] outputs."""
    dev = state.device
    J = req.shape[0]
    K = min(max_nodes, state.num_nodes)
    C = class_masks.shape[0]
    elig, nelig, cpu_total = _fold_cluster(state, class_masks)
    scal = _job_scalars(req, node_num, time_limit, valid, job_class, C)
    if plan is None:
        return (scal[None].contiguous(), nelig, elig, cpu_total, K,
                torch.arange(J, device=dev))
    stream_of_class, S, L = plan
    soc = torch.as_tensor(np.asarray(stream_of_class), dtype=torch.int64,
                          device=dev)
    stream = soc[scal[:, -1].to(torch.int64)]           # [J]
    order = torch.argsort(stream, stable=True)          # stream-major
    sorted_stream = stream[order]
    # slot within stream = position among same-stream jobs (original
    # relative order preserved — the within-class greedy order)
    within = (torch.arange(J, device=dev)
              - torch.searchsorted(sorted_stream, sorted_stream))
    lin = sorted_stream * L + within                    # [J] flat slots
    jobs = torch.zeros((S * L, scal.shape[1]), dtype=torch.int32,
                       device=dev)
    jobs[lin] = scal[order]
    slot = torch.empty_like(lin)
    slot[order] = lin
    return jobs.view(S, L, -1), nelig, elig, cpu_total, K, slot


def _solve(state: ClusterState, req, node_num, time_limit, valid,
           job_class, class_masks, max_nodes: int, plan
           ) -> tuple[Placements, ClusterState]:
    jobs, nelig, elig, cpu_total, K, slot = kernel_inputs(
        state, req, node_num, time_limit, valid, job_class, class_masks,
        max_nodes, plan)
    placed, reason, chosen = greedy_place(jobs, nelig, elig, cpu_total,
                                          state.avail, state.cost, K)
    return Placements(placed=placed.reshape(-1)[slot].to(torch.bool),
                      nodes=chosen.reshape(-1, K)[slot],
                      reason=reason.reshape(-1)[slot]), state


def solve_greedy_gpu(state: ClusterState, req, node_num, time_limit,
                     valid, job_class, class_masks, max_nodes: int = 1
                     ) -> tuple[Placements, ClusterState]:
    """Single-kernel greedy solve (one serial job stream).  Same contract
    as ``solve_greedy`` with eligibility given as (job_class,
    class_masks); ``state`` is updated in place and returned."""
    return _solve(state, req, node_num, time_limit, valid, job_class,
                  class_masks, max_nodes, plan=None)


def plan_streams(job_class, class_masks, max_streams: int = 4,
                 block_jobs: int = 256, known_disjoint: bool = False):
    """Host-side stream planner.  Returns (stream_of_class[C],
    num_streams, stream_len) when the class masks are pairwise disjoint
    and the packing is worthwhile, else None (serial kernel).  Classes
    are LPT-packed into at most ``max_streams`` streams balanced by job
    count; stream_len is the longest stream rounded up to a multiple of
    8 blocks of ``block_jobs`` (the JAX package's quantum, kept so both
    packages plan identically).

    ``known_disjoint=True`` skips the [C, N] overlap reduction (the
    scheduler's mask table proves disjointness once per epoch)."""
    cm = _host(class_masks).astype(bool)
    C = cm.shape[0]
    if C < 2 or max_streams < 2:
        return None
    if not known_disjoint and (cm.sum(axis=0) > 1).any():
        return None                 # overlapping eligibility: serial
    counts = np.bincount(_host(job_class), minlength=C)[:C]
    S = min(max_streams, int((counts > 0).sum()))
    if S < 2:
        return None
    # LPT: biggest class first onto the lightest stream
    load = np.zeros(S, np.int64)
    stream_of_class = np.zeros(C, np.int32)
    for c in np.argsort(-counts):
        s = int(np.argmin(load))
        stream_of_class[c] = s
        load[s] += int(counts[c])
    longest = int(load.max())
    total = int(counts.sum())
    if longest * 2 > total:
        return None                 # too skewed: streams mostly padding
    nb = -(-max(longest, 1) // block_jobs)
    stream_len = (-(-nb // 8) * 8) * block_jobs
    return stream_of_class, S, stream_len


def solve_greedy_gpu_auto(state: ClusterState, req, node_num, time_limit,
                          valid, job_class, class_masks,
                          max_nodes: int = 1, block_jobs: int = 256,
                          max_streams: int = 4, plan=None,
                          return_plan: bool = False):
    """Dispatch: the streamed kernel when eligibility classes are
    disjoint and balanced enough to profit, the serial kernel otherwise.
    Semantics are identical either way.

    ``plan`` short-circuits the host-side planner with a precomputed
    ``plan_streams`` result.  ``return_plan=True`` appends the plan this
    call actually ran with (None for the serial kernel)."""
    if plan is None:
        plan = plan_streams(job_class, class_masks,
                            max_streams=max_streams, block_jobs=block_jobs)
    if plan is None:
        out = solve_greedy_gpu(state, req, node_num, time_limit, valid,
                               job_class, class_masks, max_nodes=max_nodes)
        return (*out, None) if return_plan else out
    # S-stream solve: one kernel block per stream, results scattered
    # back to the original order; bit-identical to the serial path
    # because the streams' class masks are pairwise disjoint
    out = _solve(state, req, node_num, time_limit, valid, job_class,
                 class_masks, max_nodes, plan)
    return (*out, plan) if return_plan else out


def solve_greedy_gpu_from_batch(state: ClusterState, jobs: JobBatch,
                                max_nodes: int = 1, block_jobs: int = 256,
                                max_streams: int = 4,
                                return_plan: bool = False):
    """Adapter for callers holding a dense part_mask (tests, small
    cycles): compress to eligibility classes host-side, then run the
    auto dispatch."""
    job_class, class_masks = classes_from_part_mask(jobs.part_mask)
    dev = state.device
    return solve_greedy_gpu_auto(
        state, jobs.req, jobs.node_num, jobs.time_limit, jobs.valid,
        torch.as_tensor(job_class, device=dev),
        torch.as_tensor(class_masks, device=dev),
        max_nodes=max_nodes, block_jobs=block_jobs,
        max_streams=max_streams, return_plan=return_plan)
