"""QoS preemption over the bucketed time axis (port of
``cranesched_tpu/models/preempt_time.py``).

``solve_preempt`` answers the what-if at t = now only; here a preemptor
may combine evictions with waiting for natural releases, on the grid of
the backfill solve (``models/solver_time.py``):

* every victim row carries its natural release bucket; the boost it
  offers its node is ``alloc * (t < end_row)`` (evicting a job cannot
  free what it would release anyway);
* per preemptor: (1) the full-eviction potential ``time_avail +
  pre_sum_t`` gives the feasible start buckets by the backfill solve's
  prefix-sum window test, and the earliest bucket with ``node_num``
  simultaneously feasible nodes wins; (2) the minimal victim prefix is
  then evaluated on the chosen nodes only: row i is evicted iff some
  bucket of the placement window still lacks resources given what the
  earlier rows on its node (in the host's victim order) free.
* ``s == 0`` evicts and starts now; ``s > 0`` leaves the preemptor
  pending and the host records deferred evictions due at the start
  bucket's edge (``JobScheduler._drain_deferred_evictions``).

The JAX package evaluates step (2) on ``[M, K, T, R]`` tensors; here the
rows' exclusive sums come from one segmented cumulative sum over the
node-sorted rows (``preempt.NodeSegments``), ``[M, T, R]``, bit for bit
the same.  ``solve_preempt_timed`` is a per-job torch loop with no host
synchronisation; ``time_avail`` and ``cost`` are updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from cranesched_tpu_torch.models.preempt import (
    NodeSegments,
    VictimRows,
    _evicted_victims,
)
from cranesched_tpu_torch.models.solver import (
    COST_INF,
    cheapest_k,
    quantized_dcost,
    stack_rows,
)
from cranesched_tpu_torch.models.solver_time import NO_START, end_buckets_for
from cranesched_tpu_torch.ops.resources import DIM_CPU


@dataclasses.dataclass
class TimedVictimRows:
    """``VictimRows`` plus the bucket at which each row frees naturally
    (``>= T``: beyond the horizon).  end_bucket int32[M]."""

    rows: VictimRows
    end_bucket: torch.Tensor


@dataclasses.dataclass
class TimedPreemptorBatch:
    """``PreemptorBatch`` over the time grid; the placement window comes
    from time_limit and the grid edges inside the solve."""

    req: torch.Tensor
    node_num: torch.Tensor
    time_limit: torch.Tensor
    part_mask: torch.Tensor
    exclusive: torch.Tensor
    can_prey: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass
class TimedPreemptDecisions:
    """placed bool[J]; start_bucket int32[J] (NO_START if unschedulable);
    nodes int32[J, K]; evict bool[J, V]."""

    placed: torch.Tensor
    start_bucket: torch.Tensor
    nodes: torch.Tensor
    evict: torch.Tensor


def _window_ok(fits_t, ends):
    """[N, T] bool -> [N, T] bool: every bucket of ``[s, ends[s])``
    fits (the backfill solve's prefix-sum window test)."""
    n, T = fits_t.shape
    csum = torch.cat([torch.zeros((n, 1), dtype=torch.int32,
                                  device=fits_t.device),
                      torch.cumsum(fits_t, 1, dtype=torch.int32)], dim=1)
    starts = torch.arange(T, device=fits_t.device)
    wlen = ends - starts
    window_sum = csum[:, ends.long()] - csum[:, starts]
    return window_sum == wlen[None, :]


def _whatif_one_timed(time_avail, cost, total, alive, victim_alive,
                      tv: TimedVictimRows, seg: NodeSegments, live_t,
                      ends, tgrid, req, node_num, part_mask, exclusive,
                      can_prey, valid, max_nodes: int, num_victims: int):
    """One preemptor's timed what-if; updates ``time_avail`` (the
    evictions' frees) in place and returns ``(ok, s, e_s, sel, idx,
    evict_v)``."""
    rows = tv.rows
    n, T, r = time_avail.shape
    dev = time_avail.device
    vid = rows.vid.to(torch.int64)
    in_range = seg.in_range
    row_on = rows.valid & victim_alive[vid] & can_prey[vid]          # [M]
    row_alloc = torch.where((row_on & in_range)[:, None], rows.alloc, 0)

    # full-eviction potential over time: a row boosts its node only
    # while it would still be running (t < end_bucket)
    total_pre = torch.zeros((n, r), dtype=torch.int32,
                            device=dev).index_add_(0, seg.node, row_alloc)
    end = tv.end_bucket
    beyond = end >= T
    released = torch.zeros((n * T, r), dtype=torch.int32, device=dev)
    released.index_add_(0, seg.node * T + torch.clamp(end, 0, T - 1).long(),
                        torch.where(beyond[:, None], 0, row_alloc))
    cum_released = torch.cumsum(released.view(n, T, r), 1,
                                dtype=torch.int32)
    potential = time_avail + (total_pre[:, None, :] - cum_released)

    eligible = alive & part_mask
    fits_t = torch.all(req[None, None, :] <= potential, dim=-1)      # [N, T]
    ok_t = _window_ok(fits_t, ends) & eligible[:, None]
    whole_t = torch.all(potential == total[:, None, :], dim=-1)
    ok_t = ok_t & (_window_ok(whole_t, ends) | ~exclusive)

    counts = ok_t.sum(dim=0, dtype=torch.int32)                       # [T]
    can = counts >= node_num
    any_can = can.any()
    s = torch.where(any_can, torch.argmax(can.to(torch.int32)),
                    NO_START).to(torch.int32)
    ok = valid & (node_num > 0) & (node_num <= max_nodes) & any_can

    s_col = torch.clamp(s, 0, T - 1).long().reshape(1)
    ok_at_s = ok_t.index_select(1, s_col)[:, 0]
    masked_cost = torch.where(ok_at_s & ok, cost, COST_INF)
    sel_cost, idx = cheapest_k(masked_cost, max_nodes)
    k_mask = torch.arange(max_nodes, device=dev) < node_num
    sel = ok & k_mask & (sel_cost < COST_INF)                         # [K]

    # minimal victim prefix on the chosen nodes: each chosen row's
    # exclusive sum over the earlier chosen rows on its node, per bucket
    is_chosen = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    is_chosen[torch.where(sel, idx, n)] = True
    row_chosen = row_on & in_range & is_chosen[seg.node]              # [M]
    contrib = torch.where((row_chosen[:, None] & live_t)[:, :, None],
                          rows.alloc[:, None, :], 0)                  # [M,T,R]
    # only chosen rows (at most K nodes' worth) contribute: int32 holds
    own_excl = seg.exclusive_cumsum(contrib, torch.int32)
    avail_at_row = time_avail[seg.node] + own_excl
    e_s = ends.index_select(0, s_col)
    in_window = (tgrid >= s) & (tgrid < e_s)                          # [T]
    short_t = torch.any(req[None, None, :] > avail_at_row, dim=-1)     # [M,T]
    still_short = torch.any(short_t & in_window[None, :], dim=-1)
    evict_row = row_chosen & (still_short | exclusive)
    evict_v = _evicted_victims(evict_row, vid, num_victims) & ok

    # evicted victims free [0, end) on every node they occupy
    row_freed = evict_v[vid] & rows.valid & in_range
    time_avail.index_add_(0, seg.node, torch.where(
        (row_freed[:, None] & live_t)[:, :, None], rows.alloc[:, None, :],
        0))
    victim_alive &= ~evict_v
    return ok, s, e_s, sel, idx, evict_v


def solve_preempt_timed(time_avail, total, alive, cost,
                        tv: TimedVictimRows, jobs: TimedPreemptorBatch,
                        num_victims: int, max_nodes: int = 1, edges=None
                        ) -> tuple[TimedPreemptDecisions, torch.Tensor]:
    """Greedy what-if over (victims x time) in priority order; returns
    the decisions and the final victim_alive mask.  ``edges`` as in
    ``solve_backfill`` (None: a unit grid).  ``time_avail`` and ``cost``
    are updated in place."""
    n, T, r = time_avail.shape
    dev = time_avail.device
    k = min(max_nodes, n)
    edges = (torch.arange(T + 1, dtype=torch.int32, device=dev)
             if edges is None else torch.as_tensor(edges, device=dev).to(
                 torch.int32))
    tgrid = torch.arange(T, dtype=torch.int32, device=dev)
    rows = tv.rows
    # a row with a node outside [0, N) frees nothing (the JAX package's
    # dropped scatter); the exclusive sums group it at node 0
    seg = NodeSegments(rows.node, n)
    live_t = tgrid[None, :] < tv.end_bucket[:, None]                  # [M, T]
    cpu_total = total[:, DIM_CPU].clamp(min=1).to(torch.float32)
    out = [[], [], [], []]
    v_alive = torch.ones(num_victims, dtype=torch.bool, device=dev)
    for j in range(jobs.req.shape[0]):
        req, ex, tl = jobs.req[j], jobs.exclusive[j], jobs.time_limit[j]
        ends = torch.clamp(end_buckets_for(edges, tgrid, tl), max=T)
        ok, s, e_s, sel, idx, evict_v = _whatif_one_timed(
            time_avail, cost, total, alive, v_alive, tv, seg, live_t, ends,
            tgrid, req, jobs.node_num[j], jobs.part_mask[j], ex,
            jobs.can_prey[j], jobs.valid[j], k, num_victims)
        # the preemptor's own occupancy: req (or the whole node when
        # exclusive) over [s, e(s)) on the chosen rows
        eff_req = torch.where(ex, total[idx], req[None, :])           # [K,R]
        in_w = (tgrid >= s) & (tgrid < e_s)                           # [T]
        delta = torch.where((sel[:, None] & in_w[None, :])[:, :, None],
                            eff_req[:, None, :], 0)                   # [K,T,R]
        time_avail.index_add_(0, idx, -delta)
        dcost = quantized_dcost(tl, eff_req[:, DIM_CPU], cpu_total[idx])
        cost.index_add_(0, idx, torch.where(sel, dcost, 0))
        for acc, x in zip(out, (ok, s, torch.where(sel, idx, -1), evict_v)):
            acc.append(x)
    placed, start, nodes, evict = (
        stack_rows(rows, shape, dtype, dev) for rows, shape, dtype in zip(
            out, ((), (), (k,), (num_victims,)),
            (torch.bool, torch.int32, torch.int32, torch.bool)))
    return TimedPreemptDecisions(placed=placed, start_bucket=start,
                                 nodes=nodes, evict=evict), v_alive
