"""Node-axis-sharded greedy solve (port of
``cranesched_tpu/parallel/sharded.py``): the multi-device scheduling path.

The node axis of every cluster tensor is split into contiguous slabs, one
per shard of a *mesh*, and each placement step is:

1. each shard computes feasibility and masked cost for its own nodes and
   proposes its k cheapest feasible nodes (local work on its device);
2. the counts (``psum``) are the per-shard int32 counts summed on
   ``mesh[0]``, and the candidate merge (``all_gather``) is a
   ``torch.cat`` of the per-shard candidates in shard order on
   ``mesh[0]``.  Each shard lists its candidates in ascending cost, ties
   to the lowest local index, so a stable sort of the concatenation
   resolves ties to the lowest global node index, as the single-device
   solver does;
3. the winners go back to every shard (``.to(dev, non_blocking=True)``)
   and each shard subtracts the resources of the winners it owns.

A mesh is an ordered tuple of ``torch.device``; repeats are allowed, so a
mesh of four ``cuda:0`` shards exercises the merge on one card (and
``(torch.device("cpu"),) * 8`` mirrors the JAX tests' eight virtual CPU
devices).  A slab on the device of the state it came from is a view of
it: the solve updates it in place, as every solve of the port does.

No step syncs with the host: the admission decision and the winners stay
tensors, and every branch of ``decide_job`` is a ``torch.where``.  On a
mesh whose shards all live on one card a step's launches are recorded
once as a CUDA graph and replayed a step at a time (the step reads its
index from the card), so the host issues one replay a step instead of
~90 launches.

Parity contract: bit-identical placements, reasons and ledgers to
``models.solver.solve_greedy`` and to the JAX package's sharded solves
(``tests/test_torch_sharded.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cranesched_tpu_torch.device import run_steps, same_device
from cranesched_tpu_torch.models.solver import (
    COST_INF,
    ClusterState,
    JobBatch,
    Placements,
    cpu_total_of,
    decide_job,
    quantized_dcost,
)
from cranesched_tpu_torch.ops.resources import DIM_CPU

NODE_AXIS = "nodes"


def make_node_mesh(devices=None) -> tuple:
    """The 1-D mesh over which the node axis is sharded: every visible
    CUDA device by default (raises without one), or the given devices in
    order (repeats allowed)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible: the port runs on the card; pass "
                "devices=(torch.device('cpu'),) * n to shard on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(torch.device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


@dataclasses.dataclass
class ShardedClusterState:
    """A cluster state as one contiguous node slab per mesh shard.

    ``shards[d]`` holds nodes ``[offsets[d], offsets[d] + local_n)`` on
    ``mesh[d]``.  ``base`` is the unsharded state when every slab is a
    view of it (every shard on that state's device), else None."""

    mesh: tuple
    shards: list
    offsets: list
    base: ClusterState | None = None

    @property
    def num_nodes(self) -> int:
        return sum(s.num_nodes for s in self.shards)

    @property
    def local_n(self) -> int:
        return self.shards[0].num_nodes

    def gather(self) -> ClusterState:
        """The whole state on ``mesh[0]``: the base itself when the slabs
        are its views, else a concatenation of the slabs."""
        if self.base is not None:
            return self.base
        dev = self.mesh[0]

        def cat(name):
            return torch.cat([getattr(s, name).to(dev)
                              for s in self.shards])

        return ClusterState(avail=cat("avail"), total=cat("total"),
                            alive=cat("alive"), cost=cat("cost"))

    @property
    def avail(self) -> torch.Tensor:
        return self.gather().avail

    @property
    def cost(self) -> torch.Tensor:
        return self.gather().cost


def shard_cluster_state(state, mesh) -> ShardedClusterState:
    """Split the cluster tensors into one node slab per shard.  The node
    count must divide by the mesh size (callers pad with dead nodes,
    which never match).  A state already sharded over this mesh is
    returned as it is."""
    if isinstance(state, ShardedClusterState):
        if state.mesh == tuple(mesh):
            return state
        state = state.gather()
    mesh = tuple(mesh)
    d = len(mesh)
    n = state.num_nodes
    if n % d:
        raise ValueError(f"{n} nodes do not divide over a mesh of {d}; "
                         "pad with dead nodes")
    local_n = n // d
    shards, offsets = [], []
    views = True
    for i, dev in enumerate(mesh):
        lo = i * local_n
        offsets.append(lo)
        on_dev = same_device(state.device, dev)
        views &= on_dev

        def slab(x):
            part = x.narrow(0, lo, local_n)
            return part if on_dev else part.to(dev, copy=True)

        shards.append(ClusterState(avail=slab(state.avail),
                                   total=slab(state.total),
                                   alive=slab(state.alive),
                                   cost=slab(state.cost)))
    return ShardedClusterState(mesh=mesh, shards=shards, offsets=offsets,
                               base=state if views else None)


# ---- one placement step, S jobs at once ----
#
# A step places one job of each of S streams.  The streams' eligibility
# is pairwise disjoint (``plan_streams``), so their selections read the
# pre-step state and their updates touch disjoint nodes: the S rows are
# computed as one batch, exactly equal to placing them one after another.

def _shard_candidates(sh: ClusterState, pm, req, k: int, offset: int):
    """Counts and the k cheapest feasible nodes of S jobs on one slab.
    ``pm`` bool[S, n], ``req`` int32[S, R] (on the slab's device).
    Returns (feasible int32[S], eligible int32[S], cost int32[S, k],
    global index int64[S, k]); the cost slots past the last feasible
    node hold COST_INF."""
    n = sh.num_nodes
    eligible = sh.alive[None, :] & pm
    feasible = eligible & torch.all(req[:, None, :] <= sh.avail[None],
                                    dim=-1)
    masked = torch.where(feasible, sh.cost[None, :], COST_INF)
    # the unique int64 key cost * n + index: one topk gives ascending
    # cost with ties to the lowest local index (models.solver.cheapest_k)
    key = masked.to(torch.int64) * n + torch.arange(n, device=pm.device)
    top = torch.topk(key, k, dim=1, largest=False, sorted=True).values
    return (feasible.sum(1, dtype=torch.int32),
            eligible.sum(1, dtype=torch.int32),
            (top // n).to(torch.int32), top % n + offset)


def _sum_counts(counts: list, dev):
    """The per-shard int32 counts [S] summed on ``dev`` (``psum``)."""
    if len(counts) == 1:
        return counts[0].to(dev, non_blocking=True)
    return torch.stack([c.to(dev, non_blocking=True) for c in counts]).sum(
        0, dtype=torch.int32)


def _merge(cand_cost: list, cand_gidx: list, dev, width: int):
    """Merge per-shard candidate blocks [S, k_d] in shard order on
    ``dev``: the ``width`` cheapest of each row, ties to the earliest
    position (a stable sort), i.e. the lowest global index.  One shard's
    block is already in that order (and holds ``width`` columns)."""
    if len(cand_cost) == 1:
        return (cand_cost[0].to(dev, non_blocking=True)[:, :width],
                cand_gidx[0].to(dev, non_blocking=True)[:, :width])
    all_c = torch.cat([c.to(dev, non_blocking=True) for c in cand_cost],
                      dim=1)
    all_g = torch.cat([g.to(dev, non_blocking=True) for g in cand_gidx],
                      dim=1)
    sorted_c, order = torch.sort(all_c, dim=1, stable=True)
    order = order[:, :width]
    return sorted_c[:, :width], torch.gather(all_g, 1, order)


def _decide(valid, node_num, max_nodes: int, num_feasible, num_eligible,
            sel_cost, sel_gidx):
    """The admission decision of S jobs and their chosen global node
    ids (-1 padded).  Returns (ok, reason, sel bool[S, K], chosen)."""
    ok, reason = decide_job(valid, node_num, max_nodes, num_feasible,
                            num_eligible)
    k_mask = (torch.arange(max_nodes, device=ok.device)[None, :]
              < node_num[:, None])
    sel = ok[:, None] & k_mask & (sel_cost < COST_INF)
    chosen = torch.where(sel, sel_gidx, -1)
    return ok, reason, sel, chosen


def _apply_owned(sh: ClusterState, cpu_total, req, time_limit, sel,
                 sel_gidx, offset: int) -> None:
    """Subtract the S jobs' requests from the winners this slab owns and
    add their cost increments, in place (one scatter each)."""
    n = sh.num_nodes
    local = sel_gidx - offset
    owned = sel & (local >= 0) & (local < n)
    idx = torch.where(owned, local, 0).reshape(-1)
    delta = torch.where(owned[:, :, None], req[:, None, :], 0)
    sh.avail.index_add_(0, idx, -delta.reshape(-1, req.shape[1]))
    dcost = quantized_dcost(time_limit[:, None], req[:, DIM_CPU, None],
                            cpu_total[idx].reshape(owned.shape))
    sh.cost.index_add_(0, idx, torch.where(owned, dcost, 0).reshape(-1))


class _Replicas:
    """A tensor replicated once onto every distinct device of a mesh
    (job data, the same on every shard, as in ``P(None)`` specs)."""

    def __init__(self, x: torch.Tensor, mesh):
        self._on = {}
        for dev in mesh:
            if not any(same_device(dev, d) for d in self._on):
                self._on[dev] = (x if same_device(x.device, dev)
                                 else x.to(dev, non_blocking=True))

    def on(self, dev) -> torch.Tensor:
        for d, x in self._on.items():
            if same_device(d, dev):
                return x
        raise KeyError(dev)


def _step(sharded: ShardedClusterState, cpu_totals, tables, rows_r, req_r,
          tl_r, nn, valid, t, k: int, max_nodes: int):
    """One step of S jobs: candidates on every shard, the merge and the
    decision on ``mesh[0]``, the winners applied on their shards.  The
    step's index is ``t``, an int64 [1] tensor on ``mesh[0]``, read on
    the device (a replayed graph reads it there).  Returns (ok, reason,
    chosen) of the S jobs on ``mesh[0]``."""
    mesh = sharded.mesh
    dev0 = mesh[0]

    def at(x):
        return x.index_select(0, t.to(x.device, non_blocking=True))[0]

    f_cnt, e_cnt, cc, cg = [], [], [], []
    for d, (sh, off) in enumerate(zip(sharded.shards, sharded.offsets)):
        dev = mesh[d]
        pm = tables[d].index_select(0, at(rows_r.on(dev)))
        f, e, c, g = _shard_candidates(sh, pm, at(req_r.on(dev)), k, off)
        f_cnt.append(f)
        e_cnt.append(e)
        cc.append(c)
        cg.append(g)
    num_f = _sum_counts(f_cnt, dev0)
    num_e = _sum_counts(e_cnt, dev0)
    sel_cost, sel_gidx = _merge(cc, cg, dev0, max_nodes)
    ok, reason, sel, chosen = _decide(at(valid), at(nn), max_nodes, num_f,
                                      num_e, sel_cost, sel_gidx)
    for d, (sh, off) in enumerate(zip(sharded.shards, sharded.offsets)):
        dev = mesh[d]
        _apply_owned(sh, cpu_totals[d], at(req_r.on(dev)), at(tl_r.on(dev)),
                     sel.to(dev, non_blocking=True),
                     sel_gidx.to(dev, non_blocking=True), off)
    return ok, reason, chosen


def _solve_steps(sharded: ShardedClusterState, tables, rows, req, nn, tl,
                 valid, max_nodes: int):
    """Run the steps of S jobs each: ``rows`` int64 [steps, S] are the
    jobs' rows of each shard's eligibility table ``tables[d]`` (bool[T,
    local_n] on ``mesh[d]``), ``req`` int32 [steps, S, R], ``tl``, ``nn``
    int32 and ``valid`` bool [steps, S] on ``mesh[0]``.  Returns (placed
    [steps, S], nodes int32 [steps, S, K], reason [steps, S]) on
    ``mesh[0]``.  A mesh on one card replays the step as a CUDA graph
    (``device.run_steps``)."""
    mesh = sharded.mesh
    dev0 = mesh[0]
    steps, S = rows.shape
    k = min(max_nodes, sharded.local_n)
    args = (sharded, [cpu_total_of(sh) for sh in sharded.shards], tables,
            _Replicas(rows, mesh), _Replicas(req, mesh), _Replicas(tl, mesh),
            nn, valid)
    placed = torch.zeros((steps, S), dtype=torch.bool, device=dev0)
    nodes = torch.full((steps, S, max_nodes), -1, dtype=torch.int32,
                       device=dev0)
    reason = torch.zeros((steps, S), dtype=torch.int32, device=dev0)
    t = torch.zeros(1, dtype=torch.int64, device=dev0)

    def body():
        ok, why, chosen = _step(*args, t, k, max_nodes)
        placed.index_copy_(0, t, ok[None])
        nodes.index_copy_(0, t, chosen[None].to(torch.int32))
        reason.index_copy_(0, t, why[None])
        t.add_(1)

    run_steps(body, steps, mesh)
    return placed, nodes, reason


def solve_greedy_sharded(state, jobs: JobBatch, mesh,
                         max_nodes: int = 1
                         ) -> tuple[Placements, ShardedClusterState]:
    """Greedy in-priority-order placement with the node axis sharded.

    Same contract as ``models.solver.solve_greedy``: the node count must
    divide by the mesh size (callers pad dead nodes).  The state is
    updated in place and returned sharded, so successive cycles never
    regather it; the placements live on ``mesh[0]``."""
    sharded = shard_cluster_state(state, mesh)
    max_nodes = min(max_nodes, sharded.num_nodes)
    mesh = sharded.mesh
    dev0 = mesh[0]
    J = jobs.num_jobs
    local_n = sharded.local_n
    tables = []
    for dev, off in zip(mesh, sharded.offsets):
        slab = jobs.part_mask.narrow(1, off, local_n)
        tables.append(slab if same_device(slab.device, dev)
                      else slab.to(dev, non_blocking=True))
    # one job a step: [J, 1, ...], each job's own row of part_mask
    placed, nodes, reason = _solve_steps(
        sharded, tables,
        torch.arange(J, device=dev0)[:, None],
        jobs.req.to(dev0, torch.int32)[:, None, :],
        jobs.node_num.to(dev0, torch.int32)[:, None],
        jobs.time_limit.to(dev0, torch.int32)[:, None],
        jobs.valid.to(dev0, torch.bool)[:, None], max_nodes)
    return (Placements(placed=placed.reshape(J),
                       nodes=nodes.reshape(J, max_nodes),
                       reason=reason.reshape(J)), sharded)


def solve_greedy_sharded_classes(state, req, node_num, time_limit, valid,
                                 job_class, class_masks, mesh,
                                 max_nodes: int = 1, max_streams: int = 4,
                                 plan=None, class_rows=None
                                 ) -> tuple[Placements,
                                            ShardedClusterState]:
    """Factored-eligibility sharded solve with stream dispatch.

    Eligibility arrives as ``job_class[J]`` + ``class_masks[C, N]``;
    each shard keeps its slab of the class table, so no ``[J, N]`` mask
    exists anywhere.  When ``plan_streams`` finds a worthwhile
    class-disjoint packing each step places one job of each of its S
    streams (one batch of candidates and one merge for the S), else S =
    1, the plain serial order.  ``plan`` overrides the planner;
    ``class_rows`` is the masks' host copy, read by the planner without
    a device round trip.  Bit-identical to the serial solve."""
    from cranesched_tpu_torch.models.gpu_solver import plan_streams

    sharded = shard_cluster_state(state, mesh)
    mesh = sharded.mesh
    dev0 = mesh[0]
    J = int(req.shape[0])
    C = int(class_masks.shape[0])
    K = min(max_nodes, sharded.num_nodes)
    if plan is None:
        # block_jobs=1: stream_len quantizes to ceil(longest/8)*8 —
        # steps, not kernel blocks, so no 256-job padding quantum
        rows = class_rows if class_rows is not None else class_masks
        plan = plan_streams(job_class, rows, max_streams=max_streams,
                            block_jobs=1)
    if plan is None:
        plan = (np.zeros(C, np.int32), 1, -(-max(J, 1) // 8) * 8)
    stream_of_class, S, L = plan

    # stream-major regrouping: the jobs of stream s keep their order and
    # fill slots s * L, s * L + 1, ...
    cls = job_class.to(dev0, torch.int64).clamp(0, C - 1)
    stream = torch.as_tensor(np.asarray(stream_of_class), dtype=torch.int64,
                             device=dev0)[cls]
    order = torch.argsort(stream, stable=True)
    sorted_stream = stream[order]
    lin = sorted_stream * L + (torch.arange(J, device=dev0)
                               - torch.searchsorted(sorted_stream,
                                                    sorted_stream))

    def slots(x, fill, dtype):
        x = x.to(dev0, dtype)
        flat = torch.full((S * L,) + tuple(x.shape[1:]), fill, dtype=dtype,
                          device=dev0)
        flat[lin] = x[order]
        # [S*L, ..] -> [S, L, ..] -> step-major [L, S, ..]
        return flat.reshape((S, L) + tuple(x.shape[1:])).transpose(0, 1)

    local_n = sharded.local_n
    tables = []
    for dev, off in zip(mesh, sharded.offsets):
        slab = class_masks.narrow(1, off, local_n)
        tables.append(slab if same_device(slab.device, dev)
                      else slab.to(dev, non_blocking=True))
    placed, nodes, reason = _solve_steps(
        sharded, tables, slots(cls, 0, torch.int64).contiguous(),
        slots(req, 0, torch.int32).contiguous(),
        slots(node_num, 0, torch.int32).contiguous(),
        slots(time_limit, 0, torch.int32).contiguous(),
        slots(valid, False, torch.bool).contiguous(), K)

    # [L, S, ..] -> [S, L, ..] -> flat, then gather each original job
    inv = torch.zeros(J, dtype=torch.int64, device=dev0)
    inv[order] = lin
    placed_j = placed.transpose(0, 1).reshape(-1)[inv]
    nodes_j = nodes.transpose(0, 1).reshape(S * L, K)[inv]
    reason_j = reason.transpose(0, 1).reshape(-1)[inv]
    return (Placements(placed=placed_j, nodes=nodes_j, reason=reason_j),
            sharded)
