"""Exact greedy placement by speculation (port of
``cranesched_tpu/models/speculative.py``): candidate pre-selection with a
narrow per-job step, and block speculation with exact validation.

``solve_greedy`` (models/solver.py) is the semantics-defining loop: one
job a step, each step doing O(N·R) feasibility and an O(N) selection.
Both solvers here keep its results bit for bit and move most of the work
into passes over many jobs at once:

``solve_speculative``
  Phase 1 (one pass over all jobs, chunked over J so the ``[J, N]``
  intermediates stay bounded): for every job, its ``r_cand`` cheapest
  entry-feasible nodes in the solver's (cost, index) order, plus the
  next one as a *threshold pair*.  Availability only shrinks and costs
  only grow during a solve, so a node infeasible at entry is never
  chosen, and a node outside the list keeps a pair at or above the
  threshold.
  Phase 2 (per job): the job re-evaluates its candidate rows on the live
  state and picks its ``node_num`` best.  That pick is provably the full
  solver's when the entry-feasible set fit in the list (infinite
  threshold) or the worst chosen pair is still strictly below the
  threshold pair; otherwise the job takes the full-width selection on the
  live state.  Both selections are computed and the exact one is taken
  with ``torch.where`` (the JAX package's ``lax.cond``), so no step syncs
  with the host, and on the card the step is a CUDA graph replayed once
  a job (``device.run_steps``); ``stats["fallbacks"]`` counts the
  full-width ones.

``solve_blocked``
  Per block of B jobs: every job proposes the nodes at positions
  ``[g, g + node_num)`` of its own entry cost order, ``g`` being the gang
  sizes of earlier in-block jobs with the same eligibility row; the
  sequential state each job would see if the earlier proposals were the
  outcome is rebuilt with exclusive prefix sums, the true selection is
  recomputed there, and the longest prefix of matching proposals is
  accepted (at least one job).  Cost increments are integers, so the
  rebuilt states are exact.  Same-row detection uses an integer hash of
  the row with weights from a seeded ``torch.Generator`` (the JAX package
  projects the row on ``jax.random.normal(PRNGKey(0))``, which the port
  cannot reproduce without JAX); a collision only costs prediction
  quality, never exactness.  The accepted count is read on the host once
  a block (the JAX package's ``while_loop``); ``stats["blocks"]`` counts
  the blocks.

The state is updated in place and returned, as by every solve of the
port.  Bit-identical outputs to ``solve_greedy`` and to the JAX package's
functions are asserted in ``tests/test_torch_speculative.py``, including
tie pile-ups that force a fallback or a one-job block every step.
"""

from __future__ import annotations

import torch

from cranesched_tpu_torch.device import run_steps
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
    quantized_dcost,
)
from cranesched_tpu_torch.ops.resources import DIM_CPU

# phase 1 handles at most this many [job, node] pairs at once (the
# int64 keys of one chunk: 128 MiB)
_PHASE1_ELEMS = 1 << 24


def _row_keys(masked: torch.Tensor) -> torch.Tensor:
    """Unique int64 keys ``cost * n + index`` of the rows of an int32
    ``[M, n]`` masked cost: ascending key order is the solver's (cost,
    index) order."""
    n = masked.shape[1]
    return (masked.to(torch.int64) * n
            + torch.arange(n, device=masked.device)[None, :])


def _smallest(masked: torch.Tensor, k: int):
    """Row-wise k cheapest (cost int32, index int64) of ``[M, n]``,
    ascending, ties to the lowest index."""
    n = masked.shape[1]
    top = torch.topk(_row_keys(masked), k, dim=1, largest=False,
                     sorted=True).values
    return (top // n).to(torch.int32), top % n


def _feasibility_rows(avail, alive, part_mask, req):
    """eligible/feasible ``[M, n]`` of M jobs against one state."""
    eligible = alive[None, :] & part_mask
    fits = torch.all(req[:, None, :] <= avail, dim=-1)
    return eligible, eligible & fits


def _entry_candidates(state: ClusterState, req, part_mask, r_cand: int):
    """Top ``r_cand`` entry-feasible nodes by (cost, index) of a chunk of
    jobs, and each job's threshold pair.  Returns (cand int64[M, r] with
    ``n`` for no node, thr_cost int32[M], thr_idx int64[M], feasible and
    eligible counts int32[M])."""
    n = state.num_nodes
    eligible, feasible = _feasibility_rows(state.avail[None], state.alive,
                                           part_mask, req)
    masked = torch.where(feasible, state.cost[None, :], COST_INF)
    if r_cand >= n:
        # every node is a candidate: no outside node can exist
        cand_cost, idx = _smallest(masked, n)
        cand = torch.where(cand_cost < COST_INF, idx, n)
        m = masked.shape[0]
        thr_cost = torch.full((m,), COST_INF, dtype=torch.int32,
                              device=masked.device)
        thr_idx = torch.full((m,), n, dtype=torch.int64,
                             device=masked.device)
    else:
        cand_cost, idx = _smallest(masked, r_cand + 1)
        cand = torch.where(cand_cost < COST_INF, idx, n)
        thr_cost, thr_idx = cand_cost[:, r_cand], cand[:, r_cand]
        cand = cand[:, :r_cand]
    return (cand, thr_cost, thr_idx, feasible.sum(1, dtype=torch.int32),
            eligible.sum(1, dtype=torch.int32))


def _pair_less(c1, i1, c2, i2):
    """(cost, idx) lexicographic strict less-than."""
    return (c1 < c2) | ((c1 == c2) & (i1 < i2))


def _empty(state: ClusterState, k: int) -> Placements:
    dev = state.device
    return Placements(
        placed=torch.zeros(0, dtype=torch.bool, device=dev),
        nodes=torch.zeros((0, k), dtype=torch.int32, device=dev),
        reason=torch.zeros(0, dtype=torch.int32, device=dev))


def solve_speculative(state: ClusterState, jobs: JobBatch,
                      max_nodes: int = 1, r_cand: int = 32,
                      group: int = 8, stats: dict | None = None
                      ) -> tuple[Placements, ClusterState]:
    """Bit-identical to ``solve_greedy``; the per-job step re-evaluates
    ``r_cand`` candidate rows, and the full-width selection decides only
    where the narrow one is inconclusive.  ``group`` is the JAX
    package's unroll width; it does not change the result (a job's step
    follows the previous job's either way).  With ``stats`` given,
    ``stats["fallbacks"]`` is an int64 device scalar: the jobs whose
    narrow pick was inconclusive."""
    del group
    n = state.num_nodes
    max_nodes = min(max_nodes, n)
    # the candidate list must at least cover one full gang
    r_cand = min(max(r_cand, max_nodes), n)
    J = jobs.num_jobs
    dev = state.device
    fallbacks = torch.zeros((), dtype=torch.int64, device=dev)
    if stats is not None:
        stats["fallbacks"] = fallbacks
    if J == 0:
        return _empty(state, max_nodes), state

    # ---- phase 1: per-job candidates at entry state, in chunks ----
    chunk = max(1, _PHASE1_ELEMS // max(n, 1))
    parts = [_entry_candidates(state, jobs.req[lo:lo + chunk],
                               jobs.part_mask[lo:lo + chunk], r_cand)
             for lo in range(0, J, chunk)]
    cand, thr_cost, thr_idx, _n_feas0, n_elig = (
        torch.cat([p[i] for p in parts]) for i in range(5))

    # ---- phase 2: the narrow step, with the full-width selection ----
    cpu_total = cpu_total_of(state)
    avail, cost, alive = state.avail, state.cost, state.alive
    ar = torch.arange(max_nodes, device=dev)
    placed = torch.zeros(J, dtype=torch.bool, device=dev)
    nodes = torch.full((J, max_nodes), -1, dtype=torch.int32, device=dev)
    reasons = torch.zeros(J, dtype=torch.int32, device=dev)
    t = torch.zeros(1, dtype=torch.int64, device=dev)

    def at(x):
        return x.index_select(0, t)[0]

    def body():
        req, node_num, valid = at(jobs.req), at(jobs.node_num), \
            at(jobs.valid)
        jcand, thrc, thri = at(cand), at(thr_cost), at(thr_idx)
        # narrow: the candidate rows of the live state
        safe = jcand.clamp(max=n - 1)
        vfeas = torch.all(req[None, :] <= avail[safe], dim=-1) & (jcand < n)
        vcost = torch.where(vfeas, cost[safe], COST_INF)
        # (cost, idx) order over the r rows; candidate ids are <= n
        key = vcost.to(torch.int64) * (n + 1) + jcand
        top = torch.topk(key, max_nodes, largest=False, sorted=True).values
        ncost, nidx = (top // (n + 1)).to(torch.int32), top % (n + 1)
        vcount = vfeas.sum(dtype=torch.int32)
        enough = vcount >= node_num
        # the node_num-th pick, gathered on the device (indexing with a
        # 0-d tensor would read it on the host)
        kth = (node_num - 1).clamp(0, max_nodes - 1).long().reshape(1)
        worst_ok = _pair_less(ncost.index_select(0, kth)[0],
                              nidx.index_select(0, kth)[0], thrc, thri)
        conclusive = (thrc == COST_INF) | (enough & worst_ok & valid)
        # full width on the live state (the fallback)
        eligible, feasible = job_feasibility(avail, alive,
                                             at(jobs.part_mask), req)
        fcost, fidx = cheapest_k(torch.where(feasible, cost, COST_INF),
                                 max_nodes)
        n_feas = torch.where(conclusive, vcount,
                             feasible.sum(dtype=torch.int32))
        idx = torch.where(conclusive, nidx, fidx)
        sel_cost = torch.where(conclusive, ncost, fcost)
        fallbacks.add_(~conclusive)
        ok, reason = decide_job(valid, node_num, max_nodes, n_feas,
                                at(n_elig))
        sel = ok & (ar < node_num) & (sel_cost < COST_INF)
        apply_placement(avail, cost, cpu_total, req, at(jobs.time_limit),
                        idx.clamp(max=n - 1), sel)
        placed.index_copy_(0, t, ok[None])
        nodes.index_copy_(0, t, torch.where(sel, idx, -1)[None].to(
            torch.int32))
        reasons.index_copy_(0, t, reason[None])
        t.add_(1)

    run_steps(body, J, [dev])
    return Placements(placed=placed, nodes=nodes, reason=reasons), state


def _mask_hash_weights(n: int, device) -> torch.Tensor:
    """Seeded int64 weights in [1, 2^31) for the same-row hash (sums of
    up to 2^22 rows stay exact in int64)."""
    gen = torch.Generator().manual_seed(0)
    w = torch.randint(1, 2**31 - 1, (n,), generator=gen, dtype=torch.int64)
    return w.to(device)


def solve_blocked(state: ClusterState, jobs: JobBatch, max_nodes: int = 1,
                  block_size: int = 128, stats: dict | None = None
                  ) -> tuple[Placements, ClusterState]:
    """Block speculation with exact validation: bit-identical to
    ``solve_greedy``, in ~J/B blocks of batched work in the spread
    regime and one job a block in the worst case (cost ties that persist).
    With ``stats`` given, ``stats["blocks"]`` is the block count."""
    n = state.num_nodes
    max_nodes = min(max_nodes, n)
    J = jobs.num_jobs
    B = block_size
    dev = state.device
    if stats is not None:
        stats["blocks"] = 0
    if J == 0:
        return _empty(state, max_nodes), state
    k_list = min(B * max_nodes + max_nodes, n)
    R = state.num_dims

    def pad(x, value=0):
        tail = torch.full((B,) + tuple(x.shape[1:]), value, dtype=x.dtype,
                          device=x.device)
        return torch.cat([x, tail])

    req_p = pad(jobs.req)
    nn_p = pad(jobs.node_num)
    tl_p = pad(jobs.time_limit)
    pm_p = pad(jobs.part_mask, False)
    v_p = pad(jobs.valid, False)
    weights = _mask_hash_weights(n, dev)
    cpu_total = cpu_total_of(state)
    avail, cost, alive = state.avail, state.cost, state.alive
    ar = torch.arange(max_nodes, device=dev)
    rows = torch.arange(B, device=dev)[:, None]
    lower = torch.tril(torch.ones((B, B), dtype=torch.bool, device=dev), -1)

    placed_o = torch.zeros(J, dtype=torch.bool, device=dev)
    nodes_o = torch.full((J, max_nodes), -1, dtype=torch.int32, device=dev)
    reason_o = torch.zeros(J, dtype=torch.int32, device=dev)
    ptr = 0
    blocks = 0
    while ptr < J:
        breq, bnn, btl = req_p[ptr:ptr + B], nn_p[ptr:ptr + B], \
            tl_p[ptr:ptr + B]
        bpm, bv = pm_p[ptr:ptr + B], v_p[ptr:ptr + B]

        # --- propose ---
        _, feasible = _feasibility_rows(avail[None], alive, bpm, breq)
        cand_cost, cand_idx = _smallest(
            torch.where(feasible, cost[None, :], COST_INF), k_list)
        n_finite = (cand_cost < COST_INF).sum(1, dtype=torch.int32)
        h = (bpm.to(torch.int64) * weights[None, :]).sum(1)
        same = h[:, None] == h[None, :]
        g = torch.where(same & lower, bnn[None, :], 0).sum(
            1, dtype=torch.int32)
        pos = g[:, None] + ar[None, :]
        k_mask = ar[None, :] < bnn[:, None]
        prop_ok = (bv & (bnn > 0) & (bnn <= max_nodes)
                   & (g + bnn <= n_finite))
        prop_sel = prop_ok[:, None] & k_mask
        prop_idx = torch.gather(cand_idx, 1,
                                pos.clamp(0, k_list - 1).long())
        prop_chosen = torch.where(prop_sel, prop_idx, -1)

        # --- rebuild the sequential states (exclusive prefix sums) ---
        sc_idx = torch.where(prop_sel, prop_idx, n)              # [B, K]
        req_delta = torch.zeros((B, n + 1, R), dtype=torch.int32,
                                device=dev)
        req_delta.index_put_(
            (rows.expand_as(sc_idx), sc_idx),
            torch.where(prop_sel[:, :, None], breq[:, None, :], 0),
            accumulate=True)
        dcost = quantized_dcost(btl[:, None], breq[:, DIM_CPU, None],
                                cpu_total[sc_idx.clamp(max=n - 1)])
        dc_delta = torch.zeros((B, n + 1), dtype=torch.int32, device=dev)
        dc_delta.index_put_((rows.expand_as(sc_idx), sc_idx),
                            torch.where(prop_sel, dcost, 0),
                            accumulate=True)
        cum_req = torch.cat([
            torch.zeros((1, n, R), dtype=torch.int32, device=dev),
            torch.cumsum(req_delta[:, :n], 0, dtype=torch.int32)])
        cum_dc = torch.cat([
            torch.zeros((1, n), dtype=torch.int32, device=dev),
            torch.cumsum(dc_delta[:, :n], 0, dtype=torch.int32)])

        # --- validate: the true selections on the rebuilt states ---
        eligible, feasible = _feasibility_rows(avail[None] - cum_req[:B],
                                               alive, bpm, breq)
        sel_cost, idx = _smallest(
            torch.where(feasible, cost[None, :] + cum_dc[:B], COST_INF),
            max_nodes)
        ok_true, reason_true = decide_job(
            bv, bnn, max_nodes, feasible.sum(1, dtype=torch.int32),
            eligible.sum(1, dtype=torch.int32))
        sel = ok_true[:, None] & k_mask & (sel_cost < COST_INF)
        chosen_true = torch.where(sel, idx, -1)
        match = (ok_true == prop_ok) & torch.all(
            chosen_true == prop_chosen, dim=1)
        # the accepted prefix: read once a block (job 0 always matches,
        # its rebuilt state IS the block's entry state)
        miss = torch.nonzero(~match)
        n_acc = max(int(miss[0, 0]) if miss.numel() else B, 1)

        # --- apply the accepted prefix in one shot ---
        avail -= cum_req[n_acc]
        cost += cum_dc[n_acc]
        m = min(n_acc, J - ptr)
        placed_o[ptr:ptr + m] = ok_true[:m]
        nodes_o[ptr:ptr + m] = chosen_true[:m].to(torch.int32)
        reason_o[ptr:ptr + m] = reason_true[:m]
        ptr += n_acc
        blocks += 1
    if stats is not None:
        stats["blocks"] = blocks
    return Placements(placed=placed_o, nodes=nodes_o, reason=reason_o), \
        state
