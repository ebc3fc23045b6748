"""Batched best-fit-block gang placement (port of
``cranesched_tpu/topo/place.py``).

``solve_greedy_topo`` is ``models.solver.solve_greedy`` with a
topology-restriction stage between feasibility and node selection.  Per
job, in priority order:

1. Count the job's feasible nodes per group at every topology level: an
   integer segment sum (``index_add_`` of int32 into ``[G + 1]``, the
   last bin for ungrouped nodes), exact and order-free.
2. **Best fit**: at the leaf level, the group with the smallest ``size``
   among those whose feasible count covers the whole gang (ties to the
   lowest group id).
3. If no leaf block fits, restrict to the lowest *ancestor* level where
   some group fits, then span the fewest leaf blocks inside it: blocks by
   descending feasible count (stable sort: ties to the lowest id; the
   ungrouped pool is one more pseudo-block), the minimal prefix covering
   ``node_num``.  Nodes outside that set get the sentinel cost.
4. ``cheapest_k`` over the restricted cost, allocation and cost update as
   in the base solver.

Single-node jobs skip the restriction; locality for them comes from the
block-major permutation (``topo/model.py``).  The JAX package selects
between the spanning and the local restriction with ``lax.cond``; here
both are computed and selected, so the per-job loop never waits on the
device.  State is updated in place.
"""

from __future__ import annotations

import dataclasses

import torch

from cranesched_tpu_torch.models.solver import (
    COST_INF,
    ClusterState,
    JobBatch,
    Placements,
    apply_placement,
    cheapest_k,
    cpu_total_of,
    decide_job,
    job_feasibility,
    stack_rows,
)


@dataclasses.dataclass
class TopoInfo:
    """Per-job placement-locality verdicts, aligned with the job order.

    in_block bool[J]: gang placed entirely inside one leaf block;
    cross bool[J]: gang placed by the cross-block spanning fallback;
    block int32[J]: leaf block id when in_block, else -1."""

    in_block: torch.Tensor
    cross: torch.Tensor
    block: torch.Tensor


def _bins(gon: torch.Tensor, num_groups: int) -> torch.Tensor:
    """int64[N] segment id per node; ungrouped nodes in bin G."""
    return torch.where(gon >= 0, gon, num_groups).to(torch.int64)


def _counts(feasible, bins, num_groups: int) -> torch.Tensor:
    """int32[G + 1] feasible nodes per segment."""
    counts = torch.zeros(num_groups + 1, dtype=torch.int32,
                         device=feasible.device)
    return counts.index_add_(0, bins, feasible.to(torch.int32))


def _level_fit(feasible, bins, gon, sizes, node_num):
    """Smallest group at one level that fits the whole gang: ``(have,
    group id, member mask)``; ties to the lowest group id (argmin returns
    the first occurrence)."""
    num_groups = sizes.shape[0]
    fits = _counts(feasible, bins, num_groups)[:num_groups] >= node_num
    key = torch.where(fits, sizes, COST_INF)
    g = torch.argmin(key)
    return fits[g], g.to(torch.int32), gon == g


def _span_mask(feasible, bins, num_groups: int, node_num):
    """Minimal leaf-block spanning set: blocks by descending feasible
    count (stable), the minimal prefix whose cumulative count reaches
    ``node_num``."""
    counts = _counts(feasible, bins, num_groups)
    order = torch.argsort(-counts, stable=True)
    sorted_counts = counts[order]
    cum = torch.cumsum(sorted_counts, 0, dtype=torch.int32)
    needed = ((cum - sorted_counts) < node_num) & (sorted_counts > 0)
    sel = torch.zeros(num_groups + 1, dtype=torch.bool,
                      device=feasible.device)
    sel[order] = needed
    return sel[bins]


def solve_greedy_topo(state: ClusterState, jobs: JobBatch, levels,
                      max_nodes: int = 1
                      ) -> tuple[Placements, ClusterState, TopoInfo]:
    """Topology-restricted greedy solve.

    ``levels`` is the leaf-first tuple of ``(group_of_node int32[N],
    group_sizes int32[G])`` pairs (``Topology.levels(device)``); -1 marks
    a node outside every group at that level.  Admission uses the global
    feasible count, so a gang the cluster can hold is never refused by
    the restriction: at worst it spans blocks and is flagged ``cross``.
    ``state`` is updated in place and returned."""
    dev = state.device
    k = min(max_nodes, state.num_nodes)
    cpu_total = cpu_total_of(state)
    prepped = [(gon, sizes, _bins(gon, sizes.shape[0]))
               for gon, sizes in levels]
    leaf_gon, leaf_sizes, leaf_bins = prepped[0]
    out = [[], [], [], [], [], []]
    kk = torch.arange(k, device=dev)
    for j in range(jobs.num_jobs):
        req, node_num = jobs.req[j], jobs.node_num[j]
        eligible, feasible = job_feasibility(state.avail, state.alive,
                                             jobs.part_mask[j], req)
        ok, why = decide_job(jobs.valid[j], node_num, k,
                             feasible.sum(dtype=torch.int32),
                             eligible.sum(dtype=torch.int32))
        have_leaf, blk, leaf_mask = _level_fit(
            feasible, leaf_bins, leaf_gon, leaf_sizes, node_num)
        gang = node_num > 1
        # the spanning fallback: the lowest fitting ancestor level bounds
        # the spanning set (no fitting level: the whole cluster)
        anc_mask = torch.ones_like(feasible)
        for gon, sizes, bins in reversed(prepped[1:]):
            have, _, mask = _level_fit(feasible, bins, gon, sizes, node_num)
            anc_mask = torch.where(have, mask, anc_mask)
        span = _span_mask(feasible & anc_mask, leaf_bins,
                          leaf_sizes.shape[0], node_num)
        restrict = torch.where(gang & ~have_leaf, span, leaf_mask | ~gang)
        masked_cost = torch.where(feasible & restrict, state.cost, COST_INF)
        sel_cost, idx = cheapest_k(masked_cost, k)
        sel = ok & (kk < node_num) & (sel_cost < COST_INF)
        apply_placement(state.avail, state.cost, cpu_total, req,
                        jobs.time_limit[j], idx, sel)
        ib = ok & gang & have_leaf
        for acc, x in zip(out, (ok, torch.where(sel, idx, -1), why, ib,
                                ok & gang & ~have_leaf,
                                torch.where(ib, blk, -1))):
            acc.append(x)
    placed, nodes, reason, in_block, cross, block = (
        stack_rows(rows, shape, dtype, dev) for rows, shape, dtype in zip(
            out, ((), (k,), (), (), (), ()),
            (torch.bool, torch.int32, torch.int32, torch.bool, torch.bool,
             torch.int32)))
    return (Placements(placed=placed, nodes=nodes, reason=reason), state,
            TopoInfo(in_block=in_block, cross=cross, block=block))


def solve_greedy_topo_permuted(state: ClusterState, jobs: JobBatch, topo,
                               max_nodes: int = 1
                               ) -> tuple[Placements, ClusterState,
                                          TopoInfo]:
    """Run the topo solve in block-major node order and map the results
    back to real node ids: the permutation plumbing the scheduler applies
    to the single-node solve, for equivalence testing.  Block ids are
    invariant under the permutation and the stable block-major sort keeps
    within-block id order, so with a tie-free cost vector this returns
    exactly the direct solve's placements.  ``state`` is updated in place
    (in real node order) and returned."""
    dev = state.device
    perm = topo.perm_tensor(dev).long()
    inv = topo.inv_perm_tensor(dev).long()
    pstate = ClusterState(state.avail[perm], state.total[perm],
                          state.alive[perm], state.cost[perm])
    pjobs = dataclasses.replace(jobs, part_mask=jobs.part_mask[:, perm])
    plevels = tuple((gon[perm], sizes) for gon, sizes in topo.levels(dev))
    placements, pstate, info = solve_greedy_topo(pstate, pjobs, plevels,
                                                 max_nodes=max_nodes)
    nodes = placements.nodes
    real = torch.where(nodes >= 0, perm.to(torch.int32)[nodes.clamp(min=0)
                                                        .long()], -1)
    state.avail.copy_(pstate.avail[inv])
    state.cost.copy_(pstate.cost[inv])
    return (dataclasses.replace(placements, nodes=real.to(torch.int32)),
            state, info)
