"""The greedy placement solve in PyTorch (port of
``cranesched_tpu/models/solver.py``).

For each pending job in priority order, find the ``node_num`` cheapest
alive nodes (MinCpuTimeRatioFirst cost) on which the job's per-node
requirement fits *right now*, allocate, and update the node costs.

* Cluster state is a dense SoA: ``avail[N, R]`` / ``total[N, R]`` int32
  resource vectors, ``alive[N]`` and an int32 ``cost[N]`` ledger.
* ``solve_greedy`` is a per-job torch loop.  It defines the semantics
  every faster path is held to (the CUDA kernel in
  ``models/gpu_solver.py``), exactly as the JAX package's ``lax.scan``
  version does there, and matches it bit for bit.
* Ties in cost resolve to the lowest node index.
* A job that cannot be placed leaves state untouched and is reported
  unplaced with a pending-reason code.

State is updated IN PLACE: the solve subtracts from ``state.avail`` and
adds to ``state.cost`` and returns the same object.  This is the port's
counterpart of the JAX package's buffer donation: the cluster state
stays on the device across cycles and is never copied per solve.  A
caller that needs the input state afterwards passes a ``clone()``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cranesched_tpu_torch.device import resolve_device
from cranesched_tpu_torch.ops.resources import DIM_CPU

# The node-cost ledger is int32 fixed point: unit = 1/COST_SCALE
# cpu-seconds.  Integer addition is associative, so any grouping of cost
# updates yields bit-identical ledgers, with none of float32's 2^24
# exactness cliff.
COST_SCALE = 16
COST_INF = 2**31 - 1  # "infeasible" sentinel cost (int32 max)

# Pending-reason codes.
REASON_NONE = 0  # placed
REASON_RESOURCE = 1  # feasible nodes exist but not enough free now
REASON_CONSTRAINT = 2  # partition/include/exclude/alive masks rule nodes out
REASON_PRIORITY = 3  # cut off by batch limit (set host-side)
REASON_HELD = 4  # held / dependency / begin-time (set host-side)


def quantized_dcost(time_limit, req_cpu, cpu_total_f32):
    """int32 MinCpuTimeRatioFirst increment
    ``round(seconds * cpu * COST_SCALE / cpu_total)`` in float32, with
    the JAX package's association and round-half-to-even."""
    return torch.round(time_limit.to(torch.float32)
                       * req_cpu.to(torch.float32) * COST_SCALE
                       / cpu_total_f32).to(torch.int32)


def normalize_cost_ledger(cost, n: int, device) -> torch.Tensor:
    """Coerce a cost seed into the int32 ledger.  Float inputs (ledger
    units) are rounded; integer inputs never round-trip through float32
    (that would reintroduce the 2^24 exactness cliff for large seeds)."""
    if cost is None:
        return torch.zeros(n, dtype=torch.int32, device=device)
    t = cost if isinstance(cost, torch.Tensor) else torch.tensor(
        np.asarray(cost))
    if t.is_floating_point():
        t = torch.round(t.to(torch.float32))
    return t.to(device=device, dtype=torch.int32)


def cheapest_k(masked_cost: torch.Tensor, k: int):
    """The k smallest entries of an int32 cost vector, ascending, ties to
    the lowest index (argmin returns the first occurrence).  Each winner
    is masked to the sentinel before the next argmin.  Returns
    ``(values int32[k], indices int64[k])``."""
    c = masked_cost.clone()
    vals, idxs = [], []
    for _ in range(k):
        i = torch.argmin(c).reshape(1)
        vals.append(c.index_select(0, i))
        idxs.append(i)
        c.index_fill_(0, i, COST_INF)
    return torch.cat(vals), torch.cat(idxs)


@dataclasses.dataclass
class ClusterState:
    """Device-resident cluster state.

    avail: int32[N, R]  free resources per node
    total: int32[N, R]  total resources per node
    alive: bool[N]      node is up and not drained
    cost:  int32[N]     MinCpuTimeRatioFirst running cost per node in
                        1/COST_SCALE cpu-second units
    """

    avail: torch.Tensor
    total: torch.Tensor
    alive: torch.Tensor
    cost: torch.Tensor

    @property
    def num_nodes(self) -> int:
        return self.avail.shape[0]

    @property
    def num_dims(self) -> int:
        return self.avail.shape[1]

    @property
    def device(self) -> torch.device:
        return self.avail.device

    def clone(self) -> "ClusterState":
        return ClusterState(self.avail.clone(), self.total.clone(),
                            self.alive.clone(), self.cost.clone())


@dataclasses.dataclass
class JobBatch:
    """Priority-ordered pending jobs for one cycle (SoA, padded to J).

    req:        int32[J, R] per-node resource requirement
    node_num:   int32[J]    gang size
    time_limit: int32[J]    seconds; drives the cost update
    part_mask:  bool[J, N]  per-job node eligibility
    valid:      bool[J]     padding mask (False rows are no-ops)
    """

    req: torch.Tensor
    node_num: torch.Tensor
    time_limit: torch.Tensor
    part_mask: torch.Tensor
    valid: torch.Tensor

    @property
    def num_jobs(self) -> int:
        return self.req.shape[0]


@dataclasses.dataclass
class FactoredJobBatch:
    """A job batch whose eligibility is factored: a per-job class id into
    a small device table ``class_masks[C, N]`` instead of the dense
    ``part_mask[J, N]`` matrix (1 GB at 100k jobs x 10k nodes).

    req int32[J, R], node_num int32[J], time_limit int32[J], valid
    bool[J], job_class int32[J] and class_masks bool[C, N] live on the
    device; ``job_class_np`` and ``class_rows_np`` are their host mirrors,
    read by the stream planner without a device round trip."""

    req: torch.Tensor
    node_num: torch.Tensor
    time_limit: torch.Tensor
    valid: torch.Tensor
    job_class: torch.Tensor
    class_masks: torch.Tensor
    job_class_np: np.ndarray
    class_rows_np: np.ndarray

    @property
    def num_jobs(self) -> int:
        return self.req.shape[0]


@dataclasses.dataclass
class Placements:
    """Solve output, aligned with the input job order.

    placed: bool[J]
    nodes:  int32[J, K] chosen node indices, -1 padded (K = max gang size)
    reason: int32[J]    REASON_* for unplaced jobs
    """

    placed: torch.Tensor
    nodes: torch.Tensor
    reason: torch.Tensor


def make_cluster_state(avail, total, alive, cost=None,
                       device=None) -> ClusterState:
    """Upload a cluster snapshot.  ``device`` defaults to the CUDA card
    (raises without one); pass ``device="cpu"`` to stay on the CPU."""
    dev = resolve_device(device)
    # copies: the state is updated in place and must never alias the
    # caller's host arrays
    avail = torch.tensor(np.asarray(avail, np.int32), device=dev)
    total = torch.tensor(np.asarray(total, np.int32), device=dev)
    alive = torch.tensor(np.asarray(alive, bool), device=dev)
    return ClusterState(avail=avail, total=total, alive=alive,
                        cost=normalize_cost_ledger(cost, avail.shape[0],
                                                   dev))


def _rows(x, dtype, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x)).to(device=device, dtype=dtype)


def patch_cluster_state(state: ClusterState, dirty_idx, avail_rows,
                        total_rows, alive_rows, cost) -> ClusterState:
    """Overwrite rows ``dirty_idx`` of avail/total/alive IN PLACE with
    the host's current values and replace the whole cost ledger (the
    cost seed changes for every node every cycle, so it ships full as
    [N] int32; the [N, R] tensors ship only dirty rows).

    ``dirty_idx`` may be padded with out-of-range indices (>= N); those
    rows are dropped before the ``index_copy_``.  Returns ``state``."""
    dev, n = state.device, state.num_nodes
    idx = _rows(dirty_idx, torch.int64, dev)
    keep = idx < n
    idx = idx[keep]
    state.avail.index_copy_(0, idx,
                            _rows(avail_rows, torch.int32, dev)[keep])
    state.total.index_copy_(0, idx,
                            _rows(total_rows, torch.int32, dev)[keep])
    state.alive.index_copy_(0, idx, _rows(alive_rows, torch.bool, dev)[keep])
    state.cost.copy_(normalize_cost_ledger(cost, n, dev))
    return state


def refresh_cost_ledger(state: ClusterState, cost) -> ClusterState:
    """The empty-delta form of patch_cluster_state: no rows moved, so
    only the time-dependent [N] cost ledger ships (in place)."""
    state.cost.copy_(normalize_cost_ledger(cost, state.num_nodes,
                                           state.device))
    return state


def job_feasibility(avail, alive, part_mask, req):
    """eligible/feasible node masks for one job against the cluster."""
    eligible = alive & part_mask
    fits_now = torch.all(req[None, :] <= avail, dim=-1)
    return eligible, eligible & fits_now


def decide_job(valid, node_num, max_nodes, num_feasible, num_eligible):
    """Admission decision + pending reason from the counts.

    node_num > max_nodes violates the static gang bound; refuse rather
    than allocating a partial gang.  Reason: constraint for invalid jobs
    or when eligibility alone rules the job out; resource when enough
    eligible nodes exist but are busy."""
    ok = (valid & (node_num > 0) & (node_num <= max_nodes)
          & (num_feasible >= node_num))
    bad = (~valid) | (node_num <= 0)
    any_could_ever = num_eligible >= node_num
    reason = torch.where(
        ok, REASON_NONE,
        torch.where(bad | ~any_could_ever, REASON_CONSTRAINT,
                    REASON_RESOURCE))
    return ok, reason.to(torch.int32)


def apply_placement(avail, cost, cpu_total, req, time_limit, idx,
                    apply_mask) -> None:
    """Subtract ``req`` from rows ``idx`` where ``apply_mask`` and add
    the MinCpuTimeRatioFirst increment to their cost, in place.  Rows
    with ``apply_mask`` False add zero."""
    delta = torch.where(apply_mask[:, None], req[None, :], 0)
    avail.index_add_(0, idx, -delta)
    dcost = quantized_dcost(time_limit, req[DIM_CPU], cpu_total[idx])
    cost.index_add_(0, idx, torch.where(apply_mask, dcost, 0))


def _place_one(avail, cost, cpu_total, alive, req, node_num, time_limit,
               part_mask, valid, max_nodes: int):
    """Try to place one job, updating (avail, cost) in place; returns
    ``(ok, chosen int64[K], reason)``."""
    eligible, feasible = job_feasibility(avail, alive, part_mask, req)
    ok, reason = decide_job(valid, node_num, max_nodes,
                            feasible.sum(), eligible.sum())
    # "first node_num feasible nodes in ascending cost order": mask
    # infeasible nodes to the sentinel and take the k smallest
    masked_cost = torch.where(feasible, cost, COST_INF)
    sel_cost, idx = cheapest_k(masked_cost, max_nodes)
    k_mask = torch.arange(max_nodes, device=avail.device) < node_num
    sel = ok & k_mask & (sel_cost < COST_INF)
    apply_placement(avail, cost, cpu_total, req, time_limit, idx, sel)
    return ok, torch.where(sel, idx, -1), reason


def cpu_total_of(state: ClusterState) -> torch.Tensor:
    """float32[N] cpu capacity divisor of the cost increment."""
    return state.total[:, DIM_CPU].clamp(min=1).to(torch.float32)


def solve_greedy(state: ClusterState, jobs: JobBatch,
                 max_nodes: int = 1) -> tuple[Placements, ClusterState]:
    """Greedy in-priority-order placement, one job at a time.

    jobs must already be in descending priority order.  ``max_nodes`` is
    the bound on gang size for this batch; jobs with node_num >
    max_nodes are refused.  ``state`` is updated in place and returned.
    """
    k = min(max_nodes, state.num_nodes)
    cpu_total = cpu_total_of(state)
    placed, nodes, reason = [], [], []
    for j in range(jobs.num_jobs):
        ok, chosen, why = _place_one(
            state.avail, state.cost, cpu_total, state.alive, jobs.req[j],
            jobs.node_num[j], jobs.time_limit[j], jobs.part_mask[j],
            jobs.valid[j], k)
        placed.append(ok)
        nodes.append(chosen)
        reason.append(why)
    dev = state.device
    if not placed:
        return Placements(
            placed=torch.zeros(0, dtype=torch.bool, device=dev),
            nodes=torch.zeros((0, k), dtype=torch.int32, device=dev),
            reason=torch.zeros(0, dtype=torch.int32, device=dev)), state
    return Placements(placed=torch.stack(placed),
                      nodes=torch.stack(nodes).to(torch.int32),
                      reason=torch.stack(reason)), state
