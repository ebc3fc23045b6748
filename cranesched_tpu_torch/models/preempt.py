"""QoS preemption as a device-side what-if solve (port of
``cranesched_tpu/models/preempt.py``).

For each blocked preemptor in priority order: which minimal set of
lower-QoS running jobs must die for it to start now?

* Victim state is a flat SoA of (victim, node) allocation rows, sorted
  on the host once by the victim order (QoS priority ascending, youngest
  first); that global order induces the per-node victim order.
* For one preemptor and one node, the minimal victim prefix is a prefix
  sum: row i is evicted iff the preemptor still does not fit on its node
  given the avail plus everything the EARLIER preemptable rows on that
  node free: ``any(req > avail + sum_{j<i, node_j = node_i} alloc_j)``.
* Feasibility per node: ``all(req <= avail + preemptable_sum)``; an
  exclusive preemptor also needs the whole node after the evictions.
* Preemptors run one after the other (victims consumed by one are gone
  for the next; a multi-node victim frees on every node it occupies).

The JAX package takes the per-node exclusive sum from ``[M, N, R]``
one-hot tensors (tens of GB at a 60,000-victim pool on 10,000 nodes).
Here the rows are sorted stably by node once per solve, and each step
takes one segmented exclusive cumulative sum over them: exact integer
arithmetic, so the result is bit for bit the same, in ``[M, R]`` memory.
``solve_preempt`` is a per-job torch loop with no host synchronisation;
the host commits the decisions and performs the evictions.
"""

from __future__ import annotations

import dataclasses

import torch

from cranesched_tpu_torch.models.solver import (
    COST_INF,
    cheapest_k,
    quantized_dcost,
    stack_rows,
)
from cranesched_tpu_torch.ops.resources import DIM_CPU


@dataclasses.dataclass
class VictimRows:
    """Flat (victim, node) allocation rows, pre-sorted by the victim
    order.  ``vid`` groups the rows of one victim, so evicting it frees
    every row.

    vid int32[M] victim index in [0, V); node int32[M]; alloc int32[M, R]
    the per-node allocation; valid bool[M] padding mask."""

    vid: torch.Tensor
    node: torch.Tensor
    alloc: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass
class PreemptorBatch:
    """Blocked jobs whose QoS may preempt, in priority order.

    req int32[J, R] per-node requirement; node_num int32[J]; time_limit
    int32[J]; part_mask bool[J, N]; exclusive bool[J] (whole
    idle-after-eviction nodes only); can_prey bool[J, V] (preemptor j may
    evict victim v); valid bool[J]."""

    req: torch.Tensor
    node_num: torch.Tensor
    time_limit: torch.Tensor
    part_mask: torch.Tensor
    exclusive: torch.Tensor
    can_prey: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass
class PreemptDecisions:
    """placed bool[J]; nodes int32[J, K] chosen nodes (-1 pad); evict
    bool[J, V] the victims each preemptor kills."""

    placed: torch.Tensor
    nodes: torch.Tensor
    evict: torch.Tensor


class NodeSegments:
    """The victim rows grouped by node, built once per solve: ``order``
    sorts the rows stably by node (so within a node the victim order is
    kept), ``start[i]`` is the sorted position where sorted row i's node
    begins.  Rows with a node outside ``[0, n)`` are grouped at node 0
    (the JAX package's clipped gather); their contributions are masked
    by ``in_range``."""

    def __init__(self, node: torch.Tensor, n: int):
        self.in_range = (node >= 0) & (node < n)
        self.node = torch.clamp(node.to(torch.int64), 0, max(n - 1, 0))
        self.order = torch.argsort(self.node, stable=True)
        sorted_node = self.node[self.order]
        self.start = torch.searchsorted(sorted_node, sorted_node)

    def exclusive_cumsum(self, x: torch.Tensor, dtype) -> torch.Tensor:
        """Per row, the sum of ``x`` over the EARLIER rows on its node
        (rows in their given order): a cumulative sum over the node-sorted
        rows minus each node's base, scattered back.  Exact in
        ``dtype``.  The scan runs along the innermost axis of the
        transposed ``[C, M]`` rows: a scan along the outer axis of
        ``[M, C]`` is one sequential walk per column on CUDA."""
        m = x.shape[0]
        xs = x[self.order].to(dtype).reshape(m, -1).t().contiguous()
        excl = torch.cumsum(xs, 1, dtype=dtype) - xs               # [C, M]
        excl = (excl - excl[:, self.start]).t()
        out = torch.empty_like(excl)
        out[self.order] = excl
        return out.reshape(x.shape)


def _evicted_victims(evict_row, vid, num_victims: int) -> torch.Tensor:
    """bool[V]: victims with any evicted row (``.at[vid].max``)."""
    out = torch.zeros(num_victims, dtype=torch.int32, device=vid.device)
    keep = (vid >= 0) & (vid < num_victims)
    out.scatter_reduce_(0, torch.where(keep, vid, 0).to(torch.int64),
                        (evict_row & keep).to(torch.int32), "amax")
    return out != 0


def _whatif_one(avail, cost, total, alive, victim_alive, rows: VictimRows,
                seg: NodeSegments, req, node_num, part_mask, exclusive,
                can_prey, valid, max_nodes: int, num_victims: int):
    """One preemptor's what-if; updates ``avail`` (the evictions' frees)
    in place and returns ``(ok, sel, idx, evict_v)``."""
    n = avail.shape[0]
    dev = avail.device
    vid = rows.vid.to(torch.int64)
    # rows usable by THIS preemptor: alive victim + allowed QoS
    row_on = rows.valid & victim_alive[vid] & can_prey[vid]          # [M]
    in_range = seg.in_range
    pre_sum = torch.zeros_like(avail).index_add_(
        0, seg.node, torch.where((row_on & in_range)[:, None], rows.alloc, 0))
    potential = avail + pre_sum
    eligible = alive & part_mask
    fits = torch.all(req[None, :] <= potential, dim=-1)
    whole = torch.all(potential == total, dim=-1)
    feasible = eligible & fits & (whole | ~exclusive)

    masked_cost = torch.where(feasible, cost, COST_INF)
    sel_cost, idx = cheapest_k(masked_cost, max_nodes)
    k_mask = torch.arange(max_nodes, device=dev) < node_num
    enough = feasible.sum(dtype=torch.int32) >= node_num
    ok = valid & (node_num > 0) & (node_num <= max_nodes) & enough
    sel = ok & k_mask & (sel_cost < COST_INF)                         # [K]

    # minimal victim prefix per chosen node: the segmented exclusive sum
    # of the chosen rows' allocations in the global victim order
    is_chosen = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    is_chosen[torch.where(sel, idx, n)] = True
    row_chosen = row_on & is_chosen[seg.node]                         # [M]
    contrib = torch.where((row_chosen & in_range)[:, None], rows.alloc, 0)
    own_excl = seg.exclusive_cumsum(contrib, torch.int64)
    avail_at_row = avail[seg.node].to(torch.int64) + own_excl
    still_short = torch.any(req[None, :] > avail_at_row, dim=-1)
    # an exclusive preemptor needs the whole node: every preemptable
    # victim on a chosen node dies
    evict_row = row_chosen & (still_short | exclusive)
    evict_v = _evicted_victims(evict_row, vid, num_victims) & ok

    # the evicted victims free every row they hold
    row_freed = evict_v[vid] & rows.valid & in_range
    avail.index_add_(0, seg.node, torch.where(row_freed[:, None],
                                              rows.alloc, 0))
    victim_alive &= ~evict_v
    return ok, sel, idx, evict_v


def solve_preempt(avail, total, alive, cost, rows: VictimRows,
                  jobs: PreemptorBatch, num_victims: int,
                  max_nodes: int = 1
                  ) -> tuple[PreemptDecisions, torch.Tensor]:
    """Greedy what-if in priority order; returns the decisions and the
    final victim_alive mask.  ``avail`` and ``cost`` (int32 tensors on
    the solve's device) are updated in place."""
    n = avail.shape[0]
    dev = avail.device
    k = min(max_nodes, n)
    seg = NodeSegments(rows.node, n)
    cpu_total = total[:, DIM_CPU].clamp(min=1).to(torch.float32)
    out = [[], [], []]
    v_alive = torch.ones(num_victims, dtype=torch.bool, device=dev)
    for j in range(jobs.req.shape[0]):
        req, ex = jobs.req[j], jobs.exclusive[j]
        ok, sel, idx, evict_v = _whatif_one(
            avail, cost, total, alive, v_alive, rows, seg, req,
            jobs.node_num[j], jobs.part_mask[j], ex, jobs.can_prey[j],
            jobs.valid[j], k, num_victims)
        # the preemptor's own allocation and cost: the whole node when
        # exclusive (the host commit charges node totals)
        eff_req = torch.where(ex, total[idx], req[None, :])
        avail.index_add_(0, idx, -torch.where(sel[:, None], eff_req, 0))
        dcost = quantized_dcost(jobs.time_limit[j], eff_req[:, DIM_CPU],
                                cpu_total[idx])
        cost.index_add_(0, idx, torch.where(sel, dcost, 0))
        for acc, x in zip(out, (ok, torch.where(sel, idx, -1), evict_v)):
            acc.append(x)
    placed, nodes, evict = (
        stack_rows(rows, shape, dtype, dev) for rows, shape, dtype in zip(
            out, ((), (k,), (num_victims,)),
            (torch.bool, torch.int32, torch.bool)))
    return PreemptDecisions(placed=placed, nodes=nodes, evict=evict), v_alive
