"""Placement over the time axis: duration-aware fit and conservative
backfill (port of ``cranesched_tpu/models/solver_time.py``).

The time axis is a grid of buckets with boundary times ``edges[T+1]``
(seconds from now; bucket t covers ``[edges[t], edges[t+1])``):

* ``time_avail[N, T, R]`` holds the free resources of node n during
  bucket t.  It is built in one shot from the running jobs: a scatter-add
  of each job's release at (node, end bucket), then a cumulative sum over
  time (``make_timed_state``).
* Per job, in priority order, ``solve_backfill`` finds the earliest start
  bucket at which ``node_num`` eligible nodes fit the job for its whole
  window (a prefix sum over the per-bucket fit turns "every bucket of
  [s, e) fits" into one subtraction), takes the ``node_num`` cheapest of
  them (ties to the lowest node id) and writes the allocation into
  ``[s, e)`` of their rows.  Start bucket 0 dispatches now; a later start
  holds a reservation that lower-priority jobs cannot violate.

``solve_backfill`` is the JAX package's ``lax.scan`` written as a per-job
PyTorch loop, bit for bit.  The loop has no host synchronisation: every
decision stays a tensor, so on the card the whole head of a cycle is
queued without a round trip.  State is updated in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cranesched_tpu_torch.device import resolve_device
from cranesched_tpu_torch.models.solver import (
    COST_INF,
    apply_placement,
    cheapest_k,
    cpu_total_of,
    decide_job,
    normalize_cost_ledger,
)

# start_bucket of a job that could not be scheduled inside the window
NO_START = 2**30


class TimeGrid:
    """Bucket boundaries of the time axis (host side, numpy).

    ``edges[T+1]`` are int64 seconds from now, ``edges[0] == 0``,
    strictly increasing.  The first ``linear_head`` buckets are uniform at
    ``resolution``; the rest widen geometrically so that ``edges[T] ==
    horizon``.  With ``horizon <= T * resolution`` the grid is uniform."""

    def __init__(self, num_buckets: int = 64, resolution: float = 60.0,
                 horizon: float | None = None, linear_head: int = 32):
        T = int(num_buckets)
        res = float(resolution)
        if horizon is None or horizon <= T * res:
            edges = np.round(np.arange(T + 1) * res).astype(np.int64)
        else:
            L = min(max(int(linear_head), 1), T - 1)
            head = np.round(np.arange(L + 1) * res).astype(np.int64)
            # geometric tail: res * (r + r^2 + ... + r^(T-L)) covers
            # horizon - L*res; r by bisection
            need = float(horizon) - L * res
            G = T - L

            def tail_sum(r):
                return res * sum(r ** k for k in range(1, G + 1))

            lo, hi = 1.0, 2.0
            while tail_sum(hi) < need:
                hi *= 2.0
            for _ in range(80):
                mid = (lo + hi) / 2.0
                if tail_sum(mid) < need:
                    lo = mid
                else:
                    hi = mid
            r = hi
            widths = res * np.power(r, np.arange(1, G + 1))
            tail = head[-1] + np.cumsum(widths)
            tail[-1] = horizon          # pin the far edge exactly
            edges = np.concatenate([head, np.round(tail)]).astype(
                np.int64)
            # rounding can collapse adjacent coarse edges; keep them
            # strictly increasing (widths >= 1 s)
            for i in range(1, T + 1):
                if edges[i] <= edges[i - 1]:
                    edges[i] = edges[i - 1] + 1
        self.edges = edges
        self.num_buckets = T
        self.resolution = res

    @classmethod
    def from_edges(cls, edges, resolution: float) -> "TimeGrid":
        """A grid with the given boundaries (e.g. another grid's)."""
        grid = cls(1, resolution)
        grid.edges = np.asarray(edges, np.int64).copy()
        grid.num_buckets = len(grid.edges) - 1
        return grid

    def release_bucket(self, remaining_seconds) -> np.ndarray:
        """Bucket at which a running job's allocation frees: the first
        boundary >= its remaining time, never bucket 0 (an overdue job
        still holds its allocation now)."""
        rem = np.asarray(remaining_seconds)
        eb = np.searchsorted(self.edges, rem, side="left")
        return np.maximum(eb, 1).astype(np.int32)

    def edges_tensor(self, device) -> torch.Tensor:
        """The edges as int32 on ``device`` (the solver's ``edges``)."""
        return torch.as_tensor(self.edges.astype(np.int32),
                               device=resolve_device(device))


def end_buckets_for(edges, starts, duration_seconds) -> torch.Tensor:
    """First boundary index >= ``edges[start] + duration`` for each start
    bucket: a job starting at bucket s occupies ``[s, end)``.  ``edges``
    int32[T+1], ``starts`` int32[S], ``duration_seconds`` a scalar
    (a 0-d tensor is fine)."""
    dur = torch.clamp(torch.as_tensor(duration_seconds, device=edges.device),
                      min=1).to(torch.int32)
    t_end = edges[starts.long()] + dur
    return torch.searchsorted(edges, t_end, right=False).to(torch.int32)


@dataclasses.dataclass
class TimedClusterState:
    """Cluster state with the time axis materialized.

    time_avail: int32[N, T, R]  free resources per node per bucket
    total:      int32[N, R]
    alive:      bool[N]
    cost:       int32[N]
    """

    time_avail: torch.Tensor
    total: torch.Tensor
    alive: torch.Tensor
    cost: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.time_avail.shape[0]

    @property
    def num_buckets(self) -> int:
        return self.time_avail.shape[1]


@dataclasses.dataclass
class TimedJobBatch:
    """Priority-ordered pending jobs with their durations.

    req int32[J, R]; node_num int32[J]; time_limit int32[J] seconds (the
    window on the grid and what drives the cost update); part_mask bool[J, N];
    valid bool[J]."""

    req: torch.Tensor
    node_num: torch.Tensor
    time_limit: torch.Tensor
    part_mask: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass
class TimedPlacements:
    """Solve output: ``placed`` means scheduled somewhere in the window;
    only ``start_bucket == 0`` rows dispatch now.

    placed bool[J]; start_bucket int32[J] (NO_START if unschedulable);
    nodes int32[J, K] (-1 padded); reason int32[J]."""

    placed: torch.Tensor
    start_bucket: torch.Tensor
    nodes: torch.Tensor
    reason: torch.Tensor


def _tensor(x, dtype, dev) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=dev).to(dtype)


def make_timed_state(avail, total, alive, run_nodes, run_req,
                     run_end_bucket, num_buckets: int, cost=None,
                     device=None) -> TimedClusterState:
    """``time_avail`` from the live ledger and the running jobs.

    avail/total int32[N, R] (running jobs already subtracted); alive
    bool[N]; run_nodes int32[M, K] node ids of each running job (-1
    padded); run_req int32[M, R] its per-node allocation; run_end_bucket
    int32[M] the bucket at which it frees (>= num_buckets: never inside
    the window).  Padding slots and ends beyond the window are dropped.
    ``device`` defaults to the CUDA card."""
    dev = resolve_device(device)
    avail = _tensor(avail, torch.int32, dev)
    total = _tensor(total, torch.int32, dev)
    n, r = avail.shape
    T = int(num_buckets)
    releases = torch.zeros((n * T, r), dtype=torch.int32, device=dev)
    run_nodes = _tensor(run_nodes, torch.int64, dev)
    if run_nodes.dim() == 2 and run_nodes.numel() > 0:
        k = run_nodes.shape[1]
        nodes = run_nodes.reshape(-1)
        bucket = _tensor(run_end_bucket, torch.int64,
                         dev).repeat_interleave(k)
        req = _tensor(run_req, torch.int32, dev).repeat_interleave(k, dim=0)
        drop = (nodes < 0) | (nodes >= n) | (bucket >= T)
        # dropped rows add zero at row 0: index_add_ accumulates repeated
        # (node, bucket) pairs, as the reference's scatter-add does
        flat = torch.where(drop, 0, nodes * T + bucket.clamp(min=0))
        releases.index_add_(0, flat, torch.where(drop[:, None], 0, req))
    time_avail = avail[:, None, :] + torch.cumsum(
        releases.view(n, T, r), dim=1, dtype=torch.int32)
    return TimedClusterState(
        time_avail=time_avail, total=total,
        alive=_tensor(alive, torch.bool, dev),
        cost=normalize_cost_ledger(cost, n, dev))


def _place_one_timed(time_avail, cost, cpu_total, alive, edges, starts,
                     req, node_num, time_limit, part_mask, valid,
                     max_nodes: int):
    """Place one job on the time grid, updating ``time_avail`` and
    ``cost`` in place; returns ``(ok, start, chosen int64[K], reason)``,
    all tensors."""
    n, T, _ = time_avail.shape
    eligible = alive & part_mask
    # does req fit node n during bucket t?
    fits_t = torch.all(req[None, None, :] <= time_avail, dim=-1)  # [N, T]
    # prefix sums: every bucket of [s, e) fits <=> csum[e] - csum[s] ==
    # e - s, with e the per-start end bucket clipped to the horizon
    # (buckets past T hold the steady state, which is bucket T-1)
    csum = torch.cat([torch.zeros((n, 1), dtype=torch.int32,
                                  device=time_avail.device),
                      torch.cumsum(fits_t, dim=1, dtype=torch.int32)],
                     dim=1)                                       # [N, T+1]
    ends = torch.clamp(end_buckets_for(edges, starts, time_limit), max=T)
    window = csum[:, ends.long()] - csum[:, starts.long()]
    ok = (window == (ends - starts)[None, :]) & eligible[:, None]  # [N, T]

    # earliest start bucket with enough simultaneously feasible nodes
    counts = ok.sum(dim=0, dtype=torch.int32)                     # [T]
    can = counts >= node_num
    any_can = can.any()
    s = torch.where(any_can, torch.argmax(can.to(torch.int32)),
                    NO_START).to(torch.int32)
    placed_ok, reason = decide_job(
        valid, node_num, max_nodes,
        torch.where(any_can, node_num, 0),   # feasible count at s
        eligible.sum(dtype=torch.int32))

    # node selection at s: the node_num cheapest of ok[:, s]
    s_col = torch.clamp(s, 0, T - 1).long().reshape(1)
    ok_at_s = ok.index_select(1, s_col)[:, 0]
    masked_cost = torch.where(ok_at_s & placed_ok, cost, COST_INF)
    sel_cost, idx = cheapest_k(masked_cost, max_nodes)
    k_mask = torch.arange(max_nodes, device=cost.device) < node_num
    sel = placed_ok & k_mask & (sel_cost < COST_INF)

    # the allocation (or reservation) over [s, e(s)) of the chosen rows
    e_s = ends.index_select(0, s_col)
    tmask = (starts >= s) & (starts < e_s)                        # [T]
    delta = torch.where(sel[:, None, None] & tmask[None, :, None],
                        req[None, None, :], 0)                    # [K,T,R]
    time_avail.index_add_(0, idx, -delta)
    apply_placement(None, cost, cpu_total, req, time_limit, idx, sel)
    return placed_ok, s, torch.where(sel, idx, -1), reason


def solve_backfill(state: TimedClusterState, jobs: TimedJobBatch,
                   edges=None, max_nodes: int = 1
                   ) -> tuple[TimedPlacements, TimedClusterState]:
    """Greedy in-priority-order scheduling over the time grid.

    ``edges`` are the grid's boundary seconds (``TimeGrid.edges_tensor``);
    None means a unit grid (bucket = 1 s).  Every schedulable job gets a
    start bucket and nodes; jobs that must wait hold reservations that
    later jobs cannot violate.  ``state.time_avail`` and ``state.cost``
    are updated in place and ``state`` is returned.  (The reference
    unrolls ``group`` jobs per scan step; that is a schedule of the same
    sequential placement and has no counterpart here.)"""
    dev = state.time_avail.device
    n, T, _ = state.time_avail.shape
    k = min(max_nodes, n)
    edges = (torch.arange(T + 1, dtype=torch.int32, device=dev)
             if edges is None else _tensor(edges, torch.int32, dev))
    starts = torch.arange(T, dtype=torch.int32, device=dev)
    cpu_total = cpu_total_of(state)
    J = jobs.req.shape[0]
    placed = torch.zeros(J, dtype=torch.bool, device=dev)
    start = torch.full((J,), NO_START, dtype=torch.int32, device=dev)
    nodes = torch.full((J, k), -1, dtype=torch.int32, device=dev)
    reason = torch.zeros(J, dtype=torch.int32, device=dev)
    for j in range(J):
        ok, s, chosen, why = _place_one_timed(
            state.time_avail, state.cost, cpu_total, state.alive, edges,
            starts, jobs.req[j], jobs.node_num[j], jobs.time_limit[j],
            jobs.part_mask[j], jobs.valid[j], k)
        placed[j] = ok
        start[j] = s
        nodes[j] = chosen.to(torch.int32)
        reason[j] = why
    return TimedPlacements(placed=placed, start_bucket=start, nodes=nodes,
                           reason=reason), state
