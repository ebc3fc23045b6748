"""Full-fidelity placement: multi-task packing and exclusive nodes (port
of ``cranesched_tpu/models/packing.py``).

* A job asks for ``ntasks`` tasks over ``node_num`` nodes, each node
  hosting between ``ntasks_min`` and ``ntasks_max`` of them; a node's
  requirement is ``node_req + task_req * tasks_on_node``.
* A node's capacity is the number of tasks it can host: the minimum
  must fit, then one ``fit_count`` of ``task_req`` into the headroom.
* ``exclusive`` jobs need completely idle nodes and consume them whole.
* The job takes the ``node_num`` cheapest capacity-positive nodes (ties
  to the lowest node id) and fails if their combined capacity misses
  ``ntasks``.  Tasks distribute smallest-capacity-first (ties to the
  lowest node id), each node taking ``min(rest, cap - 1) + 1``.

``solve_packed`` is the JAX package's ``lax.scan`` written as a per-job
PyTorch loop with no host synchronisation, bit for bit; the cluster
state is updated in place, as in ``models/solver.py``.  The task
distribution, a sequential recurrence over the chosen nodes in the JAX
package, is evaluated here in closed form: ``rest`` after the i-th node
is ``max(rest0 - sum_{j<i} d_j, 0)`` with ``d_j = cap_j - 1``, exact in
integers.
"""

from __future__ import annotations

import dataclasses

import torch

from cranesched_tpu_torch.models.solver import (
    COST_INF,
    REASON_RESOURCE,
    ClusterState,
    cheapest_k,
    cpu_total_of,
    decide_job,
    quantized_dcost,
    stack_rows,
)
from cranesched_tpu_torch.ops.resources import DIM_CPU, fit_count

# the distribution key of an unused slot: sorts after every capacity
_LAST = 2**30


@dataclasses.dataclass
class PackedJobBatch:
    """Priority-ordered pending jobs with the full request shape.

    node_req int32[J, R] per-node base requirement; task_req int32[J, R]
    per-task requirement; ntasks int32[J] total tasks across the gang;
    ntasks_min / ntasks_max int32[J] tasks per node; node_num int32[J];
    time_limit int32[J]; part_mask bool[J, N]; exclusive bool[J]; valid
    bool[J]."""

    node_req: torch.Tensor
    task_req: torch.Tensor
    ntasks: torch.Tensor
    ntasks_min: torch.Tensor
    ntasks_max: torch.Tensor
    node_num: torch.Tensor
    time_limit: torch.Tensor
    part_mask: torch.Tensor
    exclusive: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass
class PackedPlacements:
    """placed/nodes/reason as ``Placements``, plus the task layout:
    ``tasks[J, K]``, the tasks assigned to ``nodes[J, K]`` (0 where
    unused)."""

    placed: torch.Tensor
    nodes: torch.Tensor
    tasks: torch.Tensor
    reason: torch.Tensor


def _node_capacity(avail, total, node_req, task_req, ntasks_min,
                   ntasks_max, exclusive):
    """Max tasks each node could host; exclusive jobs size capacity from
    the node's TOTAL resources.  -> int32[N]"""
    base = torch.where(exclusive, total, avail)
    min_req = node_req + task_req * ntasks_min
    fits_min = torch.all(min_req[None, :] <= base, dim=-1)
    headroom = torch.clamp(base - min_req[None, :], min=0)
    extra = fit_count(headroom, task_req[None, :])
    cap = torch.minimum(torch.clamp(ntasks_min + extra, min=0), ntasks_max)
    return torch.where(fits_min, cap, 0).to(torch.int32)


def _place_one_packed(avail, cost, total, cpu_total, alive, node_req,
                      task_req, ntasks, nt_min, nt_max, node_num,
                      time_limit, part_mask, exclusive, valid,
                      max_nodes: int):
    """Place one job, updating ``avail`` and ``cost`` in place; returns
    ``(ok, chosen int64[K], tasks int32[K], reason)``, all tensors."""
    n = avail.shape[0]
    dev = avail.device
    eligible = alive & part_mask
    free_full = torch.all(avail == total, dim=-1)
    cap = _node_capacity(avail, total, node_req, task_req, nt_min, nt_max,
                         exclusive)
    feasible = eligible & (cap > 0) & (free_full | ~exclusive)
    ok, reason = decide_job(valid, node_num, max_nodes,
                            feasible.sum(dtype=torch.int32),
                            eligible.sum(dtype=torch.int32))

    # the node_num cheapest feasible nodes
    masked_cost = torch.where(feasible, cost, COST_INF)
    sel_cost, idx = cheapest_k(masked_cost, max_nodes)
    k_mask = torch.arange(max_nodes, device=dev) < node_num
    sel = ok & k_mask & (sel_cost < COST_INF)

    # combined capacity must cover ntasks (and every node hosts >= 1)
    cap_sel = torch.where(sel, cap[idx], 0)
    cap_ok = (cap_sel.sum() >= ntasks) & (ntasks >= node_num)
    reason = torch.where(ok & ~cap_ok, REASON_RESOURCE, reason).to(
        torch.int32)
    ok = ok & cap_ok
    sel = sel & ok

    # distribute smallest-capacity-first, ties to the lowest node index,
    # unused slots last: one int64 key in place of the two-key lexsort
    dist_key = torch.where(sel, cap_sel, _LAST).to(torch.int64)
    order = torch.argsort(dist_key * (n + 1) + torch.where(sel, idx, n),
                          stable=True)
    sel_sorted = sel[order]
    d = torch.where(sel_sorted, torch.clamp(dist_key[order] - 1, min=0), 0)
    rest0 = torch.clamp(ntasks - node_num, min=0).to(torch.int64)
    rest = torch.clamp(rest0 - (torch.cumsum(d, 0) - d), min=0)
    tasks_sorted = torch.where(sel_sorted, torch.minimum(rest, d) + 1, 0)
    tasks = torch.zeros(max_nodes, dtype=torch.int64, device=dev)
    tasks[order] = tasks_sorted
    tasks = tasks.to(torch.int32)

    # per-node allocation: the whole node when exclusive, else base +
    # tasks * task
    alloc = torch.where(exclusive, total[idx],
                        node_req[None, :] + task_req[None, :] * tasks[:, None])
    avail.index_add_(0, idx, -torch.where(sel[:, None], alloc, 0))
    dcost = quantized_dcost(time_limit.expand(max_nodes), alloc[:, DIM_CPU],
                            cpu_total[idx])
    cost.index_add_(0, idx, torch.where(sel, dcost, 0))
    return ok, torch.where(sel, idx, -1), tasks, reason


def solve_packed(state: ClusterState, jobs: PackedJobBatch,
                 max_nodes: int = 1
                 ) -> tuple[PackedPlacements, ClusterState]:
    """Greedy in-priority-order placement with task packing and exclusive
    nodes.  A batch whose jobs all have ntasks == node_num, task_req == 0
    and exclusive False gives exactly ``solve_greedy``'s result.
    ``state`` is updated in place and returned."""
    dev = state.device
    k = min(max_nodes, state.num_nodes)
    cpu_total = cpu_total_of(state)
    out = [[], [], [], []]
    for j in range(jobs.node_req.shape[0]):
        for acc, x in zip(out, _place_one_packed(
                state.avail, state.cost, state.total, cpu_total,
                state.alive, jobs.node_req[j], jobs.task_req[j],
                jobs.ntasks[j], jobs.ntasks_min[j], jobs.ntasks_max[j],
                jobs.node_num[j], jobs.time_limit[j], jobs.part_mask[j],
                jobs.exclusive[j], jobs.valid[j], k)):
            acc.append(x)
    placed, nodes, tasks, reason = (
        stack_rows(rows, shape, dtype, dev) for rows, shape, dtype in zip(
            out, ((), (k,), (k,), ()),
            (torch.bool, torch.int32, torch.int32, torch.int32)))
    return PackedPlacements(placed=placed, nodes=nodes, tasks=tasks,
                            reason=reason), state
