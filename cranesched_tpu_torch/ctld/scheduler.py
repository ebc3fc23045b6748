"""JobScheduler: the submit → cycle → dispatch → status-change loop
(port of ``cranesched_tpu/ctld/scheduler.py``).

A cycle runs:

1. the candidate scan over the PendingTable (or the per-job walk), with
   the license gate;
2. the multifactor priority sort (``models/priority.py``);
3. the factored job batch (``_MaskTable`` + ``_build_batch``);
4. the solve, one of five routes:
   - ``packed``: a cycle holding a packed or exclusive job
     (``models/packing.py``; immediate fit, no backfill that cycle);
   - ``topo``: a gang cycle under an attached topology
     (``topo/place.py``; best-fit leaf block, no backfill that cycle);
   - ``backfill=False``: the greedy placement by the CUDA kernel on the
     device-resident cluster state (``models/gpu_solver.py``,
     ``ctld/resident.py``);
   - ``backfill=True`` (the default) with at most ``backfill_max_jobs``
     candidates: the time-axis solve over every candidate
     (``models/solver_time.py``), whose future starts hold reservations;
   - ``backfill=True`` with more candidates: that solve for the
     ``backfill_max_jobs`` head, then the greedy kernel for the tail
     against the head's min-over-horizon availability;
   under a topology the greedy kernel sees the node axis in block-major
   order (``Topology.perm``) and its picks are mapped back;
5. the host commit against the authoritative ledger, with the license
   and QoS run-limit admission (``ctld/licenses.py``,
   ``ctld/accounting.py``);
6. with accounts and a ``preempt_mode``, the preemption what-if after
   every route (``models/preempt.py``, or ``models/preempt_time.py``
   with backfill), its evictions and starts; then the dispatch.

Semantics on this path are the JAX package's, bit for bit.  What the
port does not carry yet raises ``NotImplementedError`` naming its
ROADMAP item instead of pretending: other solver backends, reservations
named by a job, arrays, dependencies, begin times, allocation-only jobs
and submit hooks.  The WAL, HA, federation, events, job trace, flight
recorder, SLO and metrics planes are left out.

The cycle is an explicit ``schedule_cycle(now)`` call with virtual time;
``cycle_phases`` exposes it as a generator whose yielded closures (the
solve, the dispatch drain) may run with the caller's lock released.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from cranesched_tpu_torch.ctld.accounting import AccountMetaContainer
from cranesched_tpu_torch.ctld.defs import (
    Job,
    JobSpec,
    JobStatus,
    PendingReason,
    Step,
    StepSpec,
    StepStatus,
)
from cranesched_tpu_torch.ctld.licenses import LicenseManager
from cranesched_tpu_torch.ctld.meta import MetaContainer
from cranesched_tpu_torch.ctld.pending_table import (
    GATE_BEGIN,
    GATE_CANDIDATE,
    GATE_DEP,
    GATE_DEP_NEVER,
    GATE_HELD,
    GATE_LICENSE,
    PendingTable,
)
from cranesched_tpu_torch.ctld.resident import ResidentClusterState
from cranesched_tpu_torch.ctld.runledger import RunLedger
from cranesched_tpu_torch.device import resolve_device
from cranesched_tpu_torch.models.gpu_solver import (
    plan_streams,
    solve_greedy_gpu,
    solve_greedy_gpu_auto,
)
from cranesched_tpu_torch.models.packing import PackedJobBatch, solve_packed
from cranesched_tpu_torch.models.preempt import (
    PreemptorBatch,
    VictimRows,
    solve_preempt,
)
from cranesched_tpu_torch.models.preempt_time import (
    TimedPreemptorBatch,
    TimedVictimRows,
    solve_preempt_timed,
)
from cranesched_tpu_torch.models.priority import (
    PendingPriorityAttrs,
    PriorityWeights,
    RunningPriorityAttrs,
    multifactor_priority,
    priority_order,
)
from cranesched_tpu_torch.models.solver import (
    REASON_CONSTRAINT,
    REASON_RESOURCE,
    FactoredJobBatch,
    JobBatch,
    Placements,
    make_cluster_state,
)
from cranesched_tpu_torch.models.solver_time import (
    TimedClusterState,
    TimedJobBatch,
    TimeGrid,
    make_timed_state,
    solve_backfill,
)
from cranesched_tpu_torch.ops.resources import DIM_CPU, DIM_MEM
from cranesched_tpu_torch.topo.place import solve_greedy_topo

_REASON_MAP = {
    REASON_RESOURCE: PendingReason.RESOURCE,
    REASON_CONSTRAINT: PendingReason.CONSTRAINT,
}

# PendingTable gate code -> the pending reason of a blocked job
_GATE_REASON = {
    GATE_HELD: PendingReason.HELD,
    GATE_BEGIN: PendingReason.BEGIN_TIME,
    GATE_DEP: PendingReason.DEPENDENCY,
    GATE_DEP_NEVER: PendingReason.DEPENDENCY_NEVER_SATISFIED,
    GATE_LICENSE: PendingReason.LICENSE,
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the port yet (ROADMAP.md {item})")


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Scheduler knobs, with the JAX package's defaults."""

    schedule_batch_size: int = 100_000
    pending_queue_max_size: int = 900_000
    max_nodes_per_job: int = 8          # gang bound of the solve
    priority_type: str = "multifactor"  # or "basic" (FIFO)
    priority_weights: PriorityWeights = dataclasses.field(
        default_factory=PriorityWeights)
    max_requeue_count: int = 3
    # time axis: duration-aware fit and conservative backfill on a grid
    # of ``time_buckets`` buckets of ``time_resolution`` seconds; a
    # ``time_horizon`` beyond resolution * buckets stretches the tail
    # buckets geometrically to reach it (models/solver_time.TimeGrid)
    backfill: bool = True
    time_resolution: float = 60.0
    time_buckets: int = 64
    time_horizon: float | None = None
    # bounded backfill lookahead: a cycle with more candidates runs the
    # time-axis solve for the top ``backfill_max_jobs`` only and places
    # the tail with the greedy kernel against the head's
    # min-over-horizon availability (strictly conservative)
    backfill_max_jobs: int = 1024
    # QoS preemption (needs ``accounts``): "off" | "requeue" | "cancel"
    preempt_mode: str = "off"
    # the immediate-fit backend: the CUDA greedy-placement kernel
    solver: str = "cuda"
    # incremental cycle state: the PendingTable candidate pass, delta
    # meta snapshots and the no-op-cycle fingerprint.  False rebuilds
    # from scratch every cycle (the parity oracle).
    incremental: bool = True
    # keep the solve's ClusterState on the device across cycles and
    # patch only dirty rows (ctld/resident.py); effective only with
    # ``incremental`` (the dirty feed is the delta-snapshot machinery)
    resident_state: bool = True
    # stream planner knobs (plan_streams)
    max_streams: int = 4
    block_jobs: int = 256

    def __post_init__(self):
        if self.preempt_mode not in ("off", "requeue", "cancel"):
            raise ValueError(
                f"preempt_mode must be off|requeue|cancel, "
                f"got {self.preempt_mode!r}")
        if self.solver != "cuda":
            raise _not_ported(f"solver {self.solver!r} (the port's solver "
                              "is 'cuda')", "A8-A11")
        if self.priority_type not in ("multifactor", "basic"):
            raise ValueError(f"priority_type must be multifactor|basic, "
                             f"got {self.priority_type!r}")
        if self.max_streams < 1 or self.block_jobs < 1:
            raise ValueError(
                f"max_streams/block_jobs must be >= 1, got "
                f"{self.max_streams}/{self.block_jobs}")


@dataclasses.dataclass
class StatusChange:
    """One craned→ctld status report.  ``incarnation`` (requeue_count)
    guards against a report for an earlier run finalizing a later one;
    None trusts the caller."""

    job_id: int
    status: JobStatus
    exit_code: int
    time: float
    incarnation: int | None = None


class _ObservedDict(dict):
    """dict with membership hooks: every insert/removal notifies the
    scheduler so derived indexes (the PendingTable, the running-set
    epoch) stay in sync at the mutation site.  Hooks fire after the
    mutation, with the key's final value."""

    def __init__(self, on_set, on_del):
        super().__init__()
        self._on_set = on_set
        self._on_del = on_del

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        self._on_set(key, value)

    def __delitem__(self, key):
        value = super().pop(key)
        self._on_del(key, value)

    def pop(self, key, *default):
        if key in self:
            value = super().pop(key)
            self._on_del(key, value)
            return value
        if default:
            return default[0]
        raise KeyError(key)

    def popitem(self):
        key, value = super().popitem()
        self._on_del(key, value)
        return key, value

    def clear(self):
        while self:
            self.popitem()

    def update(self, *args, **kwargs):
        for key, value in dict(*args, **kwargs).items():
            self[key] = value

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default
        return super().__getitem__(key)


class _MaskTable:
    """Device-resident ``[C, N]`` eligibility-row table — the factored
    form of the per-job ``part_mask``.

    Rows are pure functions of a job's class key, deduplicated by
    content.  The table is padded to a power-of-two row count with
    all-False rows, and row 0 is always the all-False row.  A
    ``resv_epoch`` bump or node-count change drops everything; within an
    epoch rows never mutate, so the host→device copy happens only when a
    new class appears."""

    def __init__(self):
        self.epoch = -1
        self.num_nodes = -1
        # monotonic reset counter: PendingTable rows cache their class
        # id stamped with this
        self.generation = 0
        self.key_to_class: dict[tuple, int] = {}
        self._bytes_to_class: dict[bytes, int] = {}
        self.rows: list[np.ndarray] = []
        self.rows_np: np.ndarray | None = None  # padded [Cpad, N] mirror
        self.table: torch.Tensor | None = None  # device twin of rows_np
        self.disjoint = True      # no node is in 2+ rows

    def reset(self, epoch: int, num_nodes: int) -> None:
        self.epoch = epoch
        self.num_nodes = num_nodes
        self.generation += 1
        self.key_to_class.clear()
        self._bytes_to_class.clear()
        row0 = np.zeros(max(num_nodes, 1), bool)
        self.rows = [row0]
        self._bytes_to_class[row0.tobytes()] = 0
        self.rows_np = None
        self.table = None
        self.disjoint = True

    def class_for(self, key: tuple, row_fn) -> int:
        """Class id for ``key``; ``row_fn()`` builds the [N] bool row
        only on first sight of the key."""
        cid = self.key_to_class.get(key)
        if cid is None:
            row = np.ascontiguousarray(row_fn(), dtype=bool)
            b = row.tobytes()
            cid = self._bytes_to_class.get(b)
            if cid is None:
                cid = len(self.rows)
                self.rows.append(row)
                self._bytes_to_class[b] = cid
                self.rows_np = None
                self.table = None
            self.key_to_class[key] = cid
        return cid

    def tables(self, device: torch.device):
        """``(host [Cpad, N] bool, device twin)``."""
        if self.rows_np is None or self.table is None:
            c = 1
            while c < len(self.rows):
                c *= 2
            padded = np.zeros((c, self.rows[0].shape[0]), bool)
            padded[: len(self.rows)] = self.rows
            self.rows_np = padded
            self.disjoint = bool(
                (padded.sum(axis=0, dtype=np.int64) <= 1).all())
            self.table = torch.from_numpy(padded).to(device)
        return self.rows_np, self.table


class JobScheduler:
    """Owns the pending/running maps and drives scheduling cycles.

    ``dispatch`` is called with (job, node_ids) for every committed
    placement — the seam where a node plane (or ``craned.sim``) plugs
    in.  ``device`` is where the cycle's device work runs: the CUDA card
    unless the caller passes ``device="cpu"``; without a card the
    constructor raises.  ``accounts`` (a ``ctld.accounting.AccountManager``)
    turns on QoS resolution, submit and run limits and, with a
    ``preempt_mode``, preemption; None is an open system.  Licenses are
    configured on ``self.licenses``; a topology is attached with
    ``meta.set_topology``."""

    def __init__(self, meta: MetaContainer,
                 config: SchedulerConfig | None = None,
                 dispatch: Callable[[Job, list[int]], None] | None = None,
                 device=None, accounts=None, submit_hook=None):
        if submit_hook is not None:
            raise _not_ported("submit hooks", "A8")
        self.device = resolve_device(device)
        self.meta = meta
        self.config = config = config or SchedulerConfig()
        self.dispatch = dispatch or (lambda job, nodes: None)
        # accounting: None = open system, no limit enforcement
        self.accounts = accounts
        self.account_meta = (AccountMetaContainer(meta.layout)
                             if accounts is not None else None)
        self.licenses = LicenseManager()
        # timed preemption's deferred evictions: victim job_id -> (due
        # time, preemptor job_id); the prelude fires due entries
        self._deferred_evictions: dict[int, tuple[float, int]] = {}
        # ordered post-commit dispatch ring: (job, node_ids) queued by
        # _commit, drained by the cycle's final phase
        self._dispatch_ring: collections.deque = collections.deque()
        # persistent SoA mirror of the pending queue
        self._ptable = PendingTable(meta.layout.num_dims)
        # no-op short-circuit state: fingerprint + nearest time edge
        self._noop_fp: tuple | None = None
        self._noop_edge: float = float("inf")
        self._cycle_fp0: tuple | None = None
        # PendingTable rows aligned with the in-flight cycle's
        # candidates/ordered lists (the vectorized gathers)
        self._cand_rows: np.ndarray | None = None
        self._ordered_rows: np.ndarray | None = None
        # running-set priority attrs, rebuilt only when running-set
        # membership changes (the dict hooks bump _run_epoch)
        self._run_attrs: tuple | None = None
        self._run_epoch = 0
        meta.delta_snapshot = config.incremental
        self.pending: dict[int, Job] = _ObservedDict(
            self._on_pending_set, self._on_pending_del)
        self.running: dict[int, Job] = _ObservedDict(
            self._on_running_set, self._on_running_del)
        self.history: dict[int, Job] = {}    # terminal jobs
        self._status_queue: collections.deque[StatusChange] = (
            collections.deque())
        self._next_job_id = 1
        self._account_index: dict[str, int] = {}
        self._mask_cache: dict[tuple, np.ndarray] = {}
        self._mask_cache_epoch = -1
        self._mask_table = _MaskTable()
        # per-cycle state of running allocations (the cost seed)
        self._ledger = RunLedger(meta.layout.num_dims)
        self._resident = ResidentClusterState(
            meta, self.device,
            enabled=config.resident_state and config.incremental)
        # one time axis for every duration-aware solve: time limits stay
        # in seconds and the solve derives windows from these edges
        self._grid = TimeGrid(config.time_buckets, config.time_resolution,
                              horizon=config.time_horizon)
        self._grid_edges = self._grid.edges_tensor(self.device)
        self.stats = {
            "cycles": 0, "skipped_cycles": 0, "jobs_started_total": 0,
            "jobs_submitted_total": 0, "jobs_finished_total": 0,
            "last_cycle": {}, "last_cycle_walltime": 0.0,
        }
        # the in-flight cycle's accumulator of phase times and labels
        self._cur_trace: dict = {}

    # ------------------------------------------------------------------
    # incremental cycle state: membership hooks, the PendingTable row
    # derivation and the no-op-cycle fingerprint
    # ------------------------------------------------------------------

    def _on_pending_set(self, job_id: int, job: Job) -> None:
        self._table_upsert(job)

    def _on_pending_del(self, job_id: int, job: Job) -> None:
        self._ptable.remove(job_id)

    def _on_running_set(self, job_id: int, job: Job) -> None:
        self._run_epoch += 1

    def _on_running_del(self, job_id: int, job: Job) -> None:
        self._run_epoch += 1

    def _table_upsert(self, job: Job) -> None:
        """Derive one PendingTable row from the Job.  Jobs of the port
        carry no begin time, dependency or array, so those gates are
        constant."""
        spec = job.spec
        req, node_num, time_limit = self._job_row(job)
        part = self.meta.partitions.get(spec.partition)
        self._ptable.upsert(
            job.job_id,
            template=False,
            held=job.held,
            begin=float("-inf"),
            dep=float("-inf"), dep_never=False,
            lic=self._ptable.lic_key(spec.licenses),
            submit=job.submit_time,
            qos=job.qos_priority,
            part=part.priority if part is not None else 0,
            nnum=node_num,
            cpus=float(req[DIM_CPU]) / 256.0 * spec.node_num,
            mem=float(req[DIM_MEM]) * spec.node_num,
            acct=self._account_id(spec.account),
            tlimit=time_limit,
            packed=self._is_packed(spec),
            req=req)

    def _cycle_fingerprint(self) -> tuple:
        """Everything a zero-placement solve's outcome depends on, as
        epochs: queue content, node availability/liveness, license seats,
        reservations."""
        return (self._ptable.epoch, self.meta.meta_epoch,
                self.licenses.epoch, self.meta.resv_epoch)

    def _arm_noop(self, now: float) -> None:
        """Arm the no-op short-circuit after a cycle that placed nothing
        and queued no dispatch: until an epoch moves or the nearest time
        edge passes, an identical cycle would place nothing again.  Never
        armed with preemption on: a preemptor's eligibility depends on
        running-set age, which no epoch tracks."""
        if not self.config.incremental:
            return
        if self.config.preempt_mode != "off" and self.accounts is not None:
            return
        fp = self._cycle_fp0
        if fp is None or self._cycle_fingerprint() != fp:
            return   # something moved mid-cycle; next cycle must look
        edge = self._ptable.next_edge(now)
        for resv in self.meta.reservations.values():
            if resv.start_time > now:
                edge = min(edge, resv.start_time)
            if resv.end_time > now:
                edge = min(edge, resv.end_time)
        self._noop_fp = fp
        self._noop_edge = edge

    def _skip_cycle(self, t0, now: float, reason: str) -> list[int]:
        """The short-circuited cycle: count it; only the snapshot /
        sort / solve / commit machinery is skipped."""
        self.stats["cycles"] += 1
        self.stats["skipped_cycles"] += 1
        ms = round((time.perf_counter() - t0) * 1e3, 3)
        self.stats["last_cycle_walltime"] = time.time()
        self.stats["last_cycle"] = {
            "solver": "skip", "skip_reason": reason, "prelude_ms": ms,
            "total_ms": ms, "pending": 0, "started": 0,
            "running": len(self.running)}
        return []

    # ------------------------------------------------------------------
    # submit / cancel
    # ------------------------------------------------------------------

    @staticmethod
    def _check_supported(spec: JobSpec) -> None:
        """Refuse, loudly, the specs this slice does not carry."""
        if spec.reservation:
            raise _not_ported("jobs in a reservation", "A8")
        if spec.array is not None:
            raise _not_ported("job arrays", "A8")
        if spec.dependencies:
            raise _not_ported("dependencies", "A8")
        if spec.begin_time is not None:
            raise _not_ported("begin times", "A8")
        if spec.alloc_only:
            raise _not_ported("allocation-only jobs and steps", "A8")

    def submit(self, spec: JobSpec, now: float) -> int:
        """Validate and enqueue; returns job_id (0 = rejected).  Raises
        NotImplementedError for a spec outside the slice."""
        self._check_supported(spec)
        if len(self.pending) >= self.config.pending_queue_max_size:
            return 0
        part = self.meta.partitions.get(spec.partition)
        if part is None or not part.account_allowed(spec.account):
            return 0
        # gangs beyond the configured bound (or the partition size) can
        # never be placed — reject at submit
        if not (1 <= spec.node_num
                <= min(self.config.max_nodes_per_job, len(part.node_ids))):
            return 0
        # unknown GRES pairs can never be satisfied
        known_gres = set(self.meta.layout.gres_dims)
        for res in (spec.res, spec.task_res):
            if res is not None and res.gres:
                if not set(res.gres) <= known_gres:
                    return 0
        # the per-node minimum request (base + task_res * min tasks)
        # must fit at least one node's total in the partition
        req = spec.res.encode(self.meta.layout)
        if spec.task_res is not None:
            req = req + (spec.task_res.encode(self.meta.layout)
                         * spec.ntasks_per_node_min)
        if not (req <= self.meta.partition_max_total(spec.partition)).all():
            return 0
        if spec.ntasks is not None:
            # every chosen node hosts at least ntasks_per_node_min tasks
            # (>= 1) and the gang's combined per-node cap covers ntasks
            nt_max = max(spec.ntasks_per_node_max,
                         spec.ntasks_per_node_min)
            nt_min = spec.ntasks_per_node_min
            if not (max(spec.node_num, spec.node_num * nt_min)
                    <= spec.ntasks <= spec.node_num * nt_max):
                return 0
        if spec.licenses and self.licenses.legal(spec.licenses):
            return 0  # unknown license or count beyond the total

        qos_name, qos_priority = "", spec.qos_priority
        if self.accounts is not None:
            qos, err = self.accounts.resolve_submit(
                spec.user, spec.account, spec.partition, spec.qos or None)
            if err:
                return 0
            if qos is not None:
                err = self.account_meta.try_malloc_submit(
                    spec.user, spec.account, qos, spec)
                if err:
                    return 0
                qos_name, qos_priority = qos.name, qos.priority

        job_id = self._next_job_id
        self._next_job_id += 1
        self.stats["jobs_submitted_total"] += 1
        job = Job(job_id=job_id, spec=spec, submit_time=now,
                  qos_name=qos_name, qos_priority=qos_priority,
                  held=spec.held)
        if spec.held:
            job.pending_reason = PendingReason.HELD
        self.pending[job_id] = job
        return job_id

    def job_info(self, job_id: int) -> Job | None:
        """The job in any state: pending, running or finished."""
        return (self.pending.get(job_id) or self.running.get(job_id)
                or self.history.get(job_id))

    def cancel(self, job_id: int, now: float) -> bool:
        if job_id in self.pending:
            job = self.pending.pop(job_id)
            job.status = JobStatus.CANCELLED
            job.end_time = now
            self._finalize_terminal(job)
            return True
        if job_id in self.running:
            job = self.running[job_id]
            job.cancel_requested = True
            # the node plane owns the kill; the Cancelled status change
            # comes back through step_status_change
            for step in job.steps.values():
                if not step.status.is_terminal:
                    step.cancel_requested = True
            self.dispatch_terminate(job_id, now)
            return True
        return False

    def dispatch_terminate(self, job_id: int, now: float,
                           incarnation: int | None = None,
                           skip_node: int | None = None) -> None:
        """Transport seam: kill the job's steps on its nodes (a
        simulated cluster delivers a Cancelled status change).
        ``incarnation`` guards the kill to that requeue_count."""

    # ------------------------------------------------------------------
    # status changes
    # ------------------------------------------------------------------

    def step_status_change(self, job_id: int, status: JobStatus,
                           exit_code: int, now: float,
                           incarnation: int | None = None) -> None:
        """A whole-job status report from the node plane, queued for the
        next cycle's drain.  (Per-node reports and their aggregation come
        with the real node plane, ROADMAP A9.)"""
        self._status_queue.append(
            StatusChange(job_id, status, exit_code, now,
                         incarnation=incarnation))

    def process_status_changes(self) -> int:
        """Drain the status queue (cycle step 1).  Returns #processed."""
        n = 0
        while self._status_queue:
            ch = self._status_queue.popleft()
            job = self.running.get(ch.job_id)
            if job is None:
                continue
            if (ch.incarnation is not None
                    and ch.incarnation != job.requeue_count):
                continue  # stale report for a pre-requeue incarnation
            n += 1
            self._release_job_resources(job)
            del self.running[ch.job_id]
            job.end_time = ch.time
            job.exit_code = ch.exit_code
            job.status = ch.status
            if self._should_requeue(job, ch):
                job.reset_for_requeue()
                if job.requeue_count > self.config.max_requeue_count:
                    job.held = True
                    job.pending_reason = PendingReason.HELD
                self.pending[job.job_id] = job
            else:
                self._finalize_terminal(job)
        return n

    @staticmethod
    def _should_requeue(job: Job, ch: StatusChange) -> bool:
        if job.cancel_requested:
            return False
        return ch.status == JobStatus.FAILED and job.spec.requeue_if_failed

    def _job_alloc(self, job: Job) -> list[np.ndarray]:
        """Per-node allocation vectors (exclusive jobs own whole nodes;
        packed jobs scale with their task layout), cached per
        incarnation."""
        if (job.alloc_cache is not None
                and len(job.alloc_cache) == len(job.node_ids)):
            return job.alloc_cache
        spec = job.spec
        if spec.exclusive:
            alloc = [self.meta.nodes[n].total.copy()
                     for n in job.node_ids]
        else:
            base = spec.res.encode(self.meta.layout)
            if spec.task_res is None:
                alloc = [base] * len(job.node_ids)
            else:
                task = spec.task_res.encode(self.meta.layout)
                layout = (job.task_layout
                          or [spec.ntasks_per_node_min]
                          * len(job.node_ids))
                alloc = [base + task * t for t in layout]
        job.alloc_cache = alloc
        return alloc

    def _release_job_resources(self, job: Job) -> None:
        self.meta.free_resource(job.job_id, job.node_ids,
                                self._job_alloc(job))
        self._ledger.remove(job.job_id)
        self.licenses.free(job.spec.licenses or {})
        self._free_run_limits(job)

    def _malloc_run_limits(self, job: Job) -> bool:
        """Schedule-time QoS limit check and usage take.  The take is
        recorded on the job so the free stays symmetric even if the QoS
        is deleted and re-created while the job runs."""
        job.run_usage_taken = False
        if self.account_meta is not None and job.qos_name:
            qos = self.accounts.qos.get(job.qos_name)
            if qos is not None:
                err = self.account_meta.check_and_malloc_run(
                    job.spec.user, job.spec.account, qos, job.spec)
                if err:
                    return False
                job.run_usage_taken = True
        return True

    def _free_run_limits(self, job: Job) -> None:
        if self.account_meta is not None and job.run_usage_taken:
            self.account_meta.free_run(job.spec.user, job.spec.account,
                                       job.qos_name, job.spec)
            job.run_usage_taken = False

    def _effective_end(self, job: Job, now: float) -> float:
        """Expected end with suspended time credited back."""
        start = job.start_time if job.start_time is not None else now
        suspended = job.suspended_total
        if job.suspend_time is not None:
            suspended += max(now - job.suspend_time, 0.0)
        return start + job.spec.time_limit + suspended

    def _ledger_add(self, job: Job, now: float) -> None:
        """Register one just-started job's allocation rows."""
        self._ledger.add(
            job.job_id, job.node_ids, self._job_alloc(job),
            self._effective_end(job, now),
            [self.meta.nodes[n].total[DIM_CPU] for n in job.node_ids])

    def _ledger_add_batch(self, jobs: list[Job], now: float) -> None:
        """Register a just-started set's allocation rows in the ledger
        in one call."""
        if not jobs:
            return
        nodes = self.meta.nodes
        self._ledger.add_batch(
            [(job.job_id, job.node_ids, self._job_alloc(job),
              self._effective_end(job, now),
              [nodes[n].total[DIM_CPU] for n in job.node_ids])
             for job in jobs])

    def _finalize_terminal(self, job: Job) -> None:
        """Terminal processing: close the step records with the
        allocation, then move the job to history."""
        for step in job.steps.values():
            if step.status.is_terminal:
                continue
            if step.step_id == 0:
                step.status = StepStatus(job.status.value)
                step.exit_code = (job.exit_code
                                  if job.exit_code is not None else 0)
            else:
                step.status = StepStatus.CANCELLED
                step.exit_code = 130
            step.end_time = job.end_time
        self._finalize(job)

    def _finalize(self, job: Job) -> None:
        self.stats["jobs_finished_total"] += 1
        if self.account_meta is not None and job.qos_name:
            self.account_meta.free_submit(job.spec.user, job.spec.account,
                                          job.qos_name)
        self.history[job.job_id] = job

    def _init_steps(self, job: Job, now: float) -> None:
        """The allocation starts: a batch job materializes its implicit
        step 0 (the batch script)."""
        spec = job.spec
        job.steps = {0: Step(
            step_id=0,
            spec=StepSpec(name="batch", script=spec.script, res=None,
                          node_num=0, time_limit=spec.time_limit,
                          output_path=spec.output_path,
                          interactive_address=spec.interactive_address,
                          pty=spec.pty,
                          interactive_token=spec.interactive_token,
                          sim_runtime=spec.sim_runtime,
                          sim_exit_code=spec.sim_exit_code),
            submit_time=now, status=StepStatus.RUNNING,
            start_time=now, node_ids=list(job.node_ids))}
        job.next_step_id = 1

    # ------------------------------------------------------------------
    # THE scheduling cycle
    # ------------------------------------------------------------------

    def schedule_cycle(self, now: float) -> list[int]:
        """One cycle: drain status changes, snapshot, device solve,
        commit, dispatch.  Returns the job_ids started this cycle.
        Per-phase wall-clock times land in ``stats['last_cycle']``."""
        gen = self.cycle_phases(now)
        try:
            fn = next(gen)
            while True:
                fn = gen.send(fn())
        except StopIteration as stop:
            return stop.value or []

    def cycle_phases(self, now: float):
        """The cycle as a generator: code between yields mutates
        scheduler state and must run under the caller's lock; each
        yielded closure (the solve, the dispatch drain) is safe to run
        with the lock released.  Mid-solve mutations are caught at
        commit (the meta event window and the pending-membership and
        spec-identity re-checks)."""
        try:
            started = yield from self._cycle_body(now)
            return started
        finally:
            # a job committed to RUNNING must still get its dispatch
            # even if the generator is closed early
            self._drain_dispatch_ring()

    def _queue_dispatch(self, job: Job, node_ids: list[int]) -> None:
        self._dispatch_ring.append((job, list(node_ids)))

    def _drain_dispatch_ring(self) -> int:
        """Issue every queued dispatch in commit order."""
        ring = self._dispatch_ring
        n = len(ring)
        while ring:
            job, node_ids = ring.popleft()
            self.dispatch(job, node_ids)
        return n

    def _dispatch_phase(self):
        """The cycle's final yielded closure: drain the dispatch ring."""
        def run():
            t0 = time.perf_counter()
            n = self._drain_dispatch_ring()
            return n, (time.perf_counter() - t0) * 1e3

        return run

    def _note_dispatch(self, result) -> None:
        _n, ms = result
        lc = self.stats.get("last_cycle")
        if isinstance(lc, dict):
            lc["dispatch_ms"] = round(ms, 3)

    def _cycle_body(self, now: float):
        t0 = time.perf_counter()
        self._cur_trace = {"now": now, "solve_ms": 0.0, "num_streams": 1,
                           "preempted": 0}
        self.process_status_changes()
        self._drain_deferred_evictions(now)
        self.meta.purge_expired_reservations(now)
        t_prelude = time.perf_counter()

        # no-op short-circuit: if no epoch moved since the last armed
        # zero-placement solve and no time edge passed, this cycle would
        # rebuild the identical inputs and place nothing
        fp = self._cycle_fingerprint()
        if (self.config.incremental and self._noop_fp is not None
                and fp == self._noop_fp and now < self._noop_edge
                and not self._dispatch_ring):
            return self._skip_cycle(t0, now, "fingerprint")
        self._cycle_fp0 = fp
        self._noop_fp = None

        self.stats["cycles"] += 1
        candidates = self._pending_candidates(now)
        if not candidates:
            self.stats["last_cycle_walltime"] = time.time()
            self.stats["last_cycle"] = {
                "prelude_ms": round((t_prelude - t0) * 1e3, 3),
                "pending": 0, "started": 0,
                "running": len(self.running)}
            self._arm_noop(now)
            return []
        limit = self.config.schedule_batch_size
        if len(candidates) > limit:
            for job in candidates[limit:]:
                job.pending_reason = PendingReason.PRIORITY
            candidates = candidates[:limit]
            if self._cand_rows is not None:
                self._cand_rows = self._cand_rows[:limit]

        # snapshot + event capture window
        self.meta.start_logging()
        avail, total, alive = self.meta.snapshot()

        t_sort = time.perf_counter()
        ordered = self._priority_sort(candidates, now)
        t_batch = time.perf_counter()
        for job in ordered:
            # spec epoch for the lock-free solve window: _commit voids
            # the placement of a job whose spec object changed mid-solve
            job._plan_spec = job.spec
        jobs_batch, max_nodes = self._build_batch(ordered, avail.shape[0],
                                                  now)
        cost0 = self._ledger.cost0(now, total.shape[0])
        trace = self._cur_trace
        trace["priority_ms"] = (t_batch - t_sort) * 1e3
        trace["batch_ms"] = (time.perf_counter() - t_batch) * 1e3

        # a cycle holding a packed or exclusive job takes the packed
        # solve (immediate fit; such jobs get no backfill reservation)
        orows = self._ordered_rows
        vec = orows is not None and len(orows) == len(ordered)
        if (bool(self._ptable.packed[orows].any()) if vec
                else any(self._is_packed(j.spec) for j in ordered)):
            state = make_cluster_state(avail, total, alive, cost0,
                                       device=self.device)
            pbatch = self._packed_batch(jobs_batch.dense(), ordered)
            placements = yield self._traced_solve(
                lambda: solve_packed(state, pbatch, max_nodes=max_nodes)[0])
            started = self._commit(ordered, placements, now,
                                   tasks=placements.tasks)
            started += self._try_preemption(ordered, now)
            self._record_cycle_stats(t0, candidates, started,
                                     time.perf_counter(), "packed")
            if self._dispatch_ring:
                self._note_dispatch((yield self._dispatch_phase()))
            return started

        topo = self._active_topology()
        if topo is not None:
            self._update_topo_fragmentation(topo, avail, total, alive)
        if topo is not None and (
                bool((self._ptable.nnum[orows] > 1).any()) if vec
                else any(j.spec.node_num > 1 for j in ordered)):
            # a gang cycle under a topology: the best-fit-block solve,
            # without backfill this cycle (locality first for gangs)
            state = make_cluster_state(avail, total, alive, cost0,
                                       device=self.device)
            dense = jobs_batch.dense()
            levels = topo.levels(self.device)
            placements, _, info = yield self._traced_solve(
                lambda: solve_greedy_topo(state, dense, levels,
                                          max_nodes=max_nodes))
            self._note_topo(topo, ordered, info)
            started = self._commit(ordered, placements, now)
            started += self._try_preemption(ordered, now)
            self._record_cycle_stats(t0, candidates, started,
                                     time.perf_counter(), "topo")
            if self._dispatch_ring:
                self._note_dispatch((yield self._dispatch_phase()))
            return started

        if self.config.backfill:
            if len(ordered) > max(1, self.config.backfill_max_jobs):
                started = yield from self._split_backfill_phases(
                    ordered, jobs_batch, avail, total, alive, cost0,
                    max_nodes, now)
                started += self._try_preemption(ordered, now)
                self._record_cycle_stats(t0, candidates, started,
                                         time.perf_counter(),
                                         "backfill-split")
                if self._dispatch_ring:
                    self._note_dispatch((yield self._dispatch_phase()))
                return started
            state = self._timed_state(now, avail, total, alive, cost0)
            tbatch = self._timed_batch(jobs_batch.dense())
            placements = yield self._traced_solve(
                lambda: solve_backfill(state, tbatch,
                                       edges=self._grid_edges,
                                       max_nodes=max_nodes)[0])
            started = self._commit(ordered, placements, now,
                                   placements.start_bucket)
            solver_name = "backfill"
        else:
            placements, solver_name = yield self._traced_solve(
                lambda: self._solve_gpu(
                    avail, total, alive, cost0, jobs_batch, max_nodes,
                    resident_ok=True))
            started = self._commit(ordered, placements, now)
        started += self._try_preemption(ordered, now)
        # double buffer: copy the rows this commit dirtied ahead of the
        # next cycle's resident patch
        self._resident.stage()
        self._record_cycle_stats(t0, candidates, started,
                                 time.perf_counter(), solver_name)
        if self._dispatch_ring:
            self._note_dispatch((yield self._dispatch_phase()))
        return started

    def _split_backfill_phases(self, ordered, jobs_batch, avail, total,
                               alive, cost0, max_nodes, now):
        """Bounded backfill lookahead: the time-axis solve with full
        reservation semantics covers the top ``backfill_max_jobs`` jobs;
        the tail is placed by the greedy kernel against the MIN over the
        horizon of the post-reservation time map, so no tail placement
        can violate a head reservation.  Each part is committed after its
        own solve."""
        bf_max = max(1, self.config.backfill_max_jobs)
        head, tail = ordered[:bf_max], ordered[bf_max:]
        # dense rows for the head only; the tail stays factored for the
        # kernel, with the head's rows invalid so nothing places twice
        head_batch = self._timed_batch(jobs_batch.dense(bf_max))
        rows = torch.arange(jobs_batch.num_jobs, device=self.device)
        tail_batch = jobs_batch.with_valid(jobs_batch.valid
                                           & (rows >= bf_max))
        state = self._timed_state(now, avail, total, alive, cost0)
        placements, tstate = yield self._traced_solve(
            lambda: solve_backfill(state, head_batch,
                                   edges=self._grid_edges,
                                   max_nodes=max_nodes), part="head")
        started = self._commit(head, placements, now,
                               placements.start_bucket)

        # pass 2: the tail against the tightest bucket of the horizon
        self.meta.start_logging()   # a fresh event window for its commit

        def tail_solve():
            # the min stays on the device and is never adopted as, or
            # patched into, the resident state
            min_avail = tstate.time_avail.amin(dim=1)
            return self._solve_gpu(min_avail, total, alive, tstate.cost,
                                   tail_batch, max_nodes,
                                   resident_ok=False)

        out, _ = yield self._traced_solve(tail_solve, part="tail")
        started += self._commit(tail, Placements(
            placed=out.placed[bf_max:], nodes=out.nodes[bf_max:],
            reason=out.reason[bf_max:]), now)
        return started

    def _timed_state(self, now, avail, total, alive, cost0
                     ) -> TimedClusterState:
        """The time map from the snapshot and the running jobs' release
        rows (one per (job, node), straight from the run ledger)."""
        T = self.config.time_buckets
        run_nodes, run_req, run_end = self._ledger.timed_rows(
            now, self.config.time_resolution, T, grid=self._grid)
        return make_timed_state(avail, total, alive, run_nodes, run_req,
                                run_end, T, cost0, device=self.device)

    @staticmethod
    def _timed_batch(batch: JobBatch) -> TimedJobBatch:
        # time limits stay in seconds: the solve derives each window
        # from the grid edges passed beside the batch
        return TimedJobBatch(req=batch.req, node_num=batch.node_num,
                             time_limit=batch.time_limit,
                             part_mask=batch.part_mask, valid=batch.valid)

    def _solve_gpu(self, avail, total, alive, cost0, jobs_batch,
                   max_nodes, resident_ok=False):
        """The immediate-fit solve: greedy placement by the CUDA kernel
        (models/gpu_solver.py), returning ``(placements, label)``.
        Class-disjoint batches run the S-stream decomposition, labeled
        ``cuda-stream`` with ``num_streams`` recorded; overlapping
        classes run the serial kernel, labeled ``cuda``.  The cluster
        state is updated in place on the device; with ``resident_ok`` it
        is the cross-cycle resident state (dirty-row patch) instead of a
        fresh upload of ``avail`` (an array or a device tensor).

        Under a topology the kernel sees the node axis in block-major
        order (``Topology.perm``): its ascending-cost, lowest-id walk
        then clusters picks inside blocks.  The snapshot, the cost seed
        and the class masks with their host copy (from which the streams
        and the owned slots are planned) are permuted; the picks are
        mapped back to real node ids; the resident state, whose rows are
        real node ids, is dropped for the solve."""
        cfg = self.config
        topo = self._active_topology()
        perm = None
        if topo is not None:
            perm = topo.perm_tensor(self.device).long()

            def permuted(x):
                return (x[perm] if isinstance(x, torch.Tensor)
                        else np.asarray(x)[topo.perm])

            avail, total, alive, cost0 = (permuted(x) for x in (
                avail, total, alive, cost0))
            jobs_batch = dataclasses.replace(
                jobs_batch, class_masks=jobs_batch.class_masks[:, perm],
                class_rows_np=jobs_batch.class_rows_np[:, topo.perm])
            self._resident.invalidate()
            resident_ok = False
        use_resident = resident_ok and self._resident.enabled
        if use_resident:
            state, _mode = self._resident.acquire(
                avail, total, alive, cost0,
                key=("cuda", int(avail.shape[0]), int(avail.shape[1]),
                     self._mask_table.generation))
        else:
            state = make_cluster_state(avail, total, alive, cost0,
                                       device=self.device)
        b = jobs_batch
        args = (b.req, b.node_num, b.time_limit, b.valid, b.job_class,
                b.class_masks)
        plan = None
        if self._mask_table.disjoint:
            # the table proved its rows disjoint once per epoch: the
            # planner skips its [C, N] reduction
            plan = plan_streams(b.job_class_np, b.class_rows_np,
                                max_streams=cfg.max_streams,
                                block_jobs=cfg.block_jobs,
                                known_disjoint=True)
        if plan is None:
            placements, new_state = solve_greedy_gpu(
                state, *args, max_nodes=max_nodes,
                class_rows=b.class_rows_np)
        else:
            placements, new_state = solve_greedy_gpu_auto(
                state, *args, max_nodes=max_nodes, plan=plan,
                class_rows=b.class_rows_np)
        if use_resident:
            self._resident.adopt(new_state)
        if perm is not None:
            nodes = placements.nodes
            real = torch.where(
                nodes >= 0, perm.to(torch.int32)[nodes.clamp(min=0).long()],
                -1).to(torch.int32)
            placements = Placements(placed=placements.placed, nodes=real,
                                    reason=placements.reason)
        num_streams = plan[1] if plan is not None else 1
        self._cur_trace["num_streams"] = num_streams
        return placements, ("cuda-stream" if num_streams > 1 else "cuda")

    def _traced_solve(self, fn, part: str | None = None):
        """Wrap a yielded solve closure: time it, settling the device
        work before the clock stops (otherwise the commit's read-back
        would absorb the kernel time).  A split cycle's solves also
        record their own time as ``solve_<part>_ms``."""
        trace = self._cur_trace

        def run():
            t0 = time.perf_counter()
            # the cycle's prelude ends when the solve starts
            trace.setdefault("_prelude_end", t0)
            out = fn()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            ms = (time.perf_counter() - t0) * 1e3
            trace["solve_ms"] += ms
            if part is not None:
                trace[f"solve_{part}_ms"] = ms
            return out

        return run

    def _record_cycle_stats(self, t0, candidates, started, t_end,
                            solver: str) -> None:
        self.stats["jobs_started_total"] += len(started)
        trace = self._cur_trace
        total_ms = (t_end - t0) * 1e3
        prelude_ms = (trace.pop("_prelude_end") - t0) * 1e3
        solve_ms = trace["solve_ms"]
        res = self._resident
        mode = res.pop_cycle_mode()
        self.stats["last_cycle"] = {
            "solver": solver,
            "num_streams": trace["num_streams"],
            "prelude_ms": round(prelude_ms, 3),
            "priority_ms": round(trace["priority_ms"], 3),
            "batch_ms": round(trace["batch_ms"], 3),
            "solve_ms": round(solve_ms, 3),
            # everything after the prelude but the solve: the commit
            "commit_ms": round(max(total_ms - prelude_ms - solve_ms, 0.0),
                               3),
            # updated in place once the ring drains (_note_dispatch)
            "dispatch_ms": 0.0,
            "total_ms": round(total_ms, 3),
            "pending": len(candidates),
            "started": len(started),
            "running": len(self.running),
            "resident": mode,
            "h2d_rows": res.last_h2d_rows if mode else 0,
            "h2d_bytes": res.last_h2d_bytes if mode else 0,
            "patch_overlap": bool(res.last_overlap) if mode else False,
        }
        # backfill cycles: jobs holding a future start, and a split
        # cycle's solve time by part; preemption and topology counts
        for key in ("backfilled", "solve_head_ms", "solve_tail_ms",
                    "preempted", "preempt_solve_ms", "preempt_inputs_ms",
                    "preempt_shape", "topo_frag", "topo_in_block",
                    "topo_cross"):
            if key in trace:
                value = trace[key]
                self.stats["last_cycle"][key] = (
                    round(value, 3) if isinstance(value, float) else value)
        self.stats["last_cycle_walltime"] = time.time()
        # a zero-placement solve with nothing in flight arms the no-op
        # fingerprint
        if not started and not self._dispatch_ring:
            self._arm_noop(trace["now"])

    # ------------------------------------------------------------------
    # candidates, priority, batch
    # ------------------------------------------------------------------

    def _pending_candidates(self, now: float) -> list[Job]:
        """Candidate scan: one vectorized pass over the PendingTable
        (incremental mode) or the per-job walk.  Both produce the same
        candidate list and pending_reason writes."""
        if not self.config.incremental:
            self._cand_rows = None
            return self._pending_candidates_rebuild(now)
        pt = self._ptable
        lic_ok = pt.license_mask(self.licenses.sufficient)
        cand_rows, changed, gates = pt.candidates(now, lic_ok)
        pending = self.pending
        jid = pt.job_id
        for row, gate in zip(changed.tolist(), gates.tolist()):
            job = pending.get(int(jid[row]))
            if job is None or gate == GATE_CANDIDATE:
                continue
            job.pending_reason = _GATE_REASON[gate]
        self._cand_rows = cand_rows
        return [pending[int(j)] for j in jid[cand_rows]]

    def _pending_candidates_rebuild(self, now: float) -> list[Job]:
        """Skip held jobs and jobs whose licenses are short (the gates a
        job of the port can hit)."""
        out = []
        for job in self.pending.values():  # id order == insertion order
            if job.held:
                job.pending_reason = PendingReason.HELD
                continue
            if job.spec.licenses and not self.licenses.sufficient(
                    job.spec.licenses):
                # checked before the solve, so a blocked job never idles
                # nodes the solver set aside for it
                job.pending_reason = PendingReason.LICENSE
                continue
            out.append(job)
        return out

    def _account_id(self, account: str) -> int:
        if account not in self._account_index:
            self._account_index[account] = len(self._account_index)
        return self._account_index[account]

    def _priority_sort(self, candidates: list[Job], now: float
                       ) -> list[Job]:
        if self.config.priority_type == "basic" or not candidates:
            self._ordered_rows = self._cand_rows
            return candidates  # FIFO: id order

        dev = self.device
        prows = self._cand_rows
        vec = prows is not None and len(prows) == len(candidates)
        if not vec:
            for job in candidates:
                self._account_id(job.spec.account)

        def job_row(job: Job):
            req = self._job_row(job)[0]
            total_cpu = float(req[DIM_CPU]) / 256.0 * job.spec.node_num
            total_mem = float(req[DIM_MEM]) * job.spec.node_num
            return (job.qos_priority,
                    self.meta.partitions[job.spec.partition].priority,
                    job.spec.node_num, total_cpu, total_mem,
                    self._account_id(job.spec.account))

        def col(rows, k, dt):
            return torch.from_numpy(
                np.asarray([r[k] for r in rows], dt).reshape(-1)).to(dev)

        # running-set attrs: none change while a job runs (only
        # run_time ages), so the device columns are cached until the
        # running-set epoch moves; job_row registers every running
        # account then, which is why this precedes num_accounts
        ra = self._run_attrs
        if ra is None or ra[0] != self._run_epoch:
            r_jobs = list(self.running.values())
            r_rows = [job_row(j) for j in r_jobs]
            start = np.asarray([j.start_time if j.start_time is not None
                                else np.inf for j in r_jobs], np.float64)
            ra = (self._run_epoch, start,
                  tuple(col(r_rows, k, dt) for k, dt in (
                      (0, np.int32), (1, np.int32), (2, np.int32),
                      (3, np.float32), (4, np.float32), (5, np.int32))),
                  torch.ones(len(r_jobs), dtype=torch.bool, device=dev))
            self._run_attrs = ra
        num_accounts = len(self._account_index)

        kN = len(candidates)
        valid = torch.ones(kN, dtype=torch.bool, device=dev)
        if vec:
            pt = self._ptable

            def pcol(src, dt):
                return torch.from_numpy(src[prows].astype(dt)).to(dev)

            age = np.maximum(now - pt.submit[prows], 0.0).astype(np.int32)
            pending = PendingPriorityAttrs(
                age=torch.from_numpy(age).to(dev),
                qos_prio=pcol(pt.qos, np.int32),
                part_prio=pcol(pt.part, np.int32),
                node_num=pcol(pt.nnum, np.int32),
                cpus=pcol(pt.cpus, np.float32),
                mem=pcol(pt.mem, np.float32),
                account=pcol(pt.acct, np.int32),
                valid=valid)
        else:
            p_rows = [job_row(j) for j in candidates]
            age = np.asarray([max(now - j.submit_time, 0.0)
                              for j in candidates]).astype(np.int32)
            pending = PendingPriorityAttrs(
                age=torch.from_numpy(age).to(dev),
                qos_prio=col(p_rows, 0, np.int32),
                part_prio=col(p_rows, 1, np.int32),
                node_num=col(p_rows, 2, np.int32),
                cpus=col(p_rows, 3, np.float32),
                mem=col(p_rows, 4, np.float32),
                account=col(p_rows, 5, np.int32),
                valid=valid)

        _, r_start, r_cols, r_valid = ra
        # start == +inf encodes "not started yet" and clamps to 0
        run_time = np.maximum(now - r_start, 0.0).astype(np.int32)
        running = RunningPriorityAttrs(
            qos_prio=r_cols[0], part_prio=r_cols[1], node_num=r_cols[2],
            cpus=r_cols[3], mem=r_cols[4], account=r_cols[5],
            run_time=torch.from_numpy(run_time).to(dev), valid=r_valid)

        pri_t = multifactor_priority(pending, running,
                                     self.config.priority_weights,
                                     num_accounts)
        order = priority_order(pri_t).cpu().numpy()
        pri = pri_t.cpu().numpy()
        for job, p in zip(candidates, pri):
            job.priority = float(p)
        self._ordered_rows = prows[order] if vec else None
        return [candidates[i] for i in order]

    def _mask_for(self, job: Job, now: float = 0.0) -> np.ndarray:
        if self._mask_cache_epoch != self.meta.resv_epoch:
            self._mask_cache.clear()
            self._mask_cache_epoch = self.meta.resv_epoch
        key = (job.spec.partition, tuple(job.spec.include_nodes),
               tuple(job.spec.exclude_nodes), len(self.meta.nodes))
        mask = self._mask_cache.get(key)
        if mask is None:
            mask = self.meta.partition_mask(
                job.spec.partition, job.spec.include_nodes,
                job.spec.exclude_nodes)
            self._mask_cache[key] = mask
        # jobs stay clear of any reservation whose window overlaps the
        # job's would-be runtime [now, now + limit]
        if self.meta.reservations:
            mask = mask.copy()
            end = now + job.spec.time_limit
            for resv in self.meta.reservations.values():
                if now < resv.end_time and resv.start_time < end:
                    for n in resv.node_ids:
                        mask[n] = False
        return mask

    def _job_row(self, job: Job) -> tuple:
        """``(encoded req, node_num, time_limit)`` cached on the Job; a
        replaced spec object invalidates the cache."""
        cached = job.row_cache
        if cached is not None and cached[0] is job.spec:
            return cached[1]
        row = (job.spec.res.encode(self.meta.layout),
               int(job.spec.node_num), int(job.spec.time_limit))
        job.row_cache = (job.spec, row)
        return row

    def _class_key(self, job: Job, now: float) -> tuple:
        """Eligibility-class key: equal keys give identical ``_mask_for``
        rows within one resv_epoch (the set of reservations overlapping
        the job's runtime window is folded in)."""
        spec = job.spec
        base = (spec.partition, tuple(spec.include_nodes),
                tuple(spec.exclude_nodes), spec.reservation)
        if not self.meta.reservations:
            return base
        end = now + spec.time_limit
        return base + (frozenset(
            name for name, r in self.meta.reservations.items()
            if now < r.end_time and r.start_time < end),)

    def _refresh_mask_table(self) -> None:
        """Reset on a resv_epoch bump or node-count change, or when the
        table outgrows its backstop; called once per cycle, before the
        batch loop."""
        table = self._mask_table
        if (table.epoch != self.meta.resv_epoch
                or table.num_nodes != len(self.meta.nodes)
                or len(table.rows) > 512):
            table.reset(self.meta.resv_epoch, len(self.meta.nodes))

    def _class_for(self, job: Job, now: float) -> int:
        return self._mask_table.class_for(
            self._class_key(job, now), lambda: self._mask_for(job, now))

    def _build_batch(self, ordered: list[Job], num_nodes: int,
                     now: float = 0.0) -> tuple[FactoredJobBatch, int]:
        """The factored job batch on the device: per-job rows gathered
        from the PendingTable (or the Jobs), class ids into the mask
        table, and the gang bound ``max_nodes`` of the solve."""
        lay = self.meta.layout
        kN = len(ordered)
        req = np.zeros((kN, lay.num_dims), np.int32)
        node_num = np.zeros(kN, np.int32)
        time_limit = np.zeros(kN, np.int32)
        job_class = np.zeros(kN, np.int32)
        self._refresh_mask_table()
        orows = self._ordered_rows
        if orows is not None and len(orows) == kN:
            pt = self._ptable
            req[:] = pt.req[orows]
            node_num[:] = pt.nnum[orows]
            time_limit[:] = pt.tlimit[orows]
            if self.meta.reservations:
                # reservation-dependent class keys change with now
                for i, job in enumerate(ordered):
                    job_class[i] = self._class_for(job, now)
            else:
                gen = self._mask_table.generation
                stale = np.nonzero(pt.cls_gen[orows] != gen)[0]
                for i in stale.tolist():
                    r = int(orows[i])
                    pt.cls[r] = self._class_for(ordered[i], now)
                    pt.cls_gen[r] = gen
                job_class[:] = pt.cls[orows]
        else:
            for i, job in enumerate(ordered):
                req[i], node_num[i], time_limit[i] = self._job_row(job)
                job_class[i] = self._class_for(job, now)
        max_nodes = max(1, min(int(node_num.max(initial=1)),
                               self.config.max_nodes_per_job))
        dev = self.device
        rows_np, table = self._mask_table.tables(dev)
        batch = FactoredJobBatch(
            req=torch.from_numpy(req).to(dev),
            node_num=torch.from_numpy(node_num).to(dev),
            time_limit=torch.from_numpy(time_limit).to(dev),
            valid=torch.ones(kN, dtype=torch.bool, device=dev),
            job_class=torch.from_numpy(job_class).to(dev),
            class_masks=table, job_class_np=job_class,
            class_rows_np=rows_np)
        return batch, max_nodes

    # ------------------------------------------------------------------
    # commit
    # ------------------------------------------------------------------

    def _commit(self, ordered: list[Job], placements, now: float,
                start_buckets: torch.Tensor | None = None,
                tasks: torch.Tensor | None = None) -> list[int]:
        """Host authoritative commit: re-check against the live ledger
        and the cycle's reduce events; jobs whose nodes died mid-cycle
        stay pending for the next cycle.  The placements come back from
        the device in ONE copy; the ledger commit is one batched meta
        call over the whole placed set; dispatches are queued on the
        ring and issued by the cycle's final phase.

        With the time axis, ``start_buckets`` marks future-start jobs:
        they hold reservations inside the solve and do not dispatch.
        Each reports ``Priority`` when its chosen nodes have room for it
        now (after this commit's allocations) and ``Resource``
        otherwise.  ``tasks`` (the packed solve's ``[J, K]``) becomes each
        started job's task layout.  Licenses and QoS run limits are
        taken per job before the batch malloc and given back if it
        fails."""
        events = self.meta.stop_logging()
        dirty_nodes = {ev.node_id for ev in events}

        cols = [placements.placed.to(torch.int32)[:, None],
                placements.reason[:, None]]
        if start_buckets is not None:
            cols.append(start_buckets.to(torch.int32)[:, None])
        k = placements.nodes.shape[1]
        if tasks is not None:
            cols.append(tasks.to(torch.int32))
        cols.append(placements.nodes.to(torch.int32))
        host = torch.cat(cols, dim=1).cpu().numpy()
        placed = host[:, 0] != 0
        reasons = host[:, 1]
        future = np.zeros(len(host), bool)
        if start_buckets is not None:
            future = placed & (host[:, 2] > 0)
            self._cur_trace["backfilled"] = (
                self._cur_trace.get("backfilled", 0) + int(future.sum()))
        nodes_mat = host[:, host.shape[1] - k:]
        tasks_mat = (host[:, host.shape[1] - 2 * k:host.shape[1] - k]
                     if tasks is not None else None)
        valid_nodes = nodes_mat >= 0
        # one gather flags every placement row touching a node some
        # mid-cycle event dirtied
        dirty_row = None
        if dirty_nodes:
            size = max(len(self.meta.nodes), max(dirty_nodes) + 1)
            dirty_vec = np.zeros(size, dtype=bool)
            dirty_vec[list(dirty_nodes)] = True
            dirty_row = (dirty_vec[np.clip(nodes_mat, 0, size - 1)]
                         & valid_nodes).any(axis=1)
        started: list[int] = []
        admitted: list[Job] = []
        admitted_rows: list[int] = []
        # rows the solver took on device but the host rejects: the
        # device state subtracted resources the ledger never allocated
        rejected_rows: list[int] = []
        future_start: list[tuple[Job, list[int]]] = []
        for i, job in enumerate(ordered):
            if (job.job_id not in self.pending or job.held
                    or job.spec is not getattr(job, "_plan_spec",
                                               job.spec)):
                # cancelled / held / modified while the solve ran: the
                # placement is void and the job stays pending
                if placed[i]:
                    rejected_rows.append(i)
                continue
            if not placed[i]:
                job.pending_reason = _REASON_MAP.get(
                    int(reasons[i]), PendingReason.RESOURCE)
                continue
            if future[i]:
                # its reason reads the avail after this commit's batch
                # malloc, below
                future_start.append(
                    (job, nodes_mat[i][valid_nodes[i]].tolist()))
                continue
            if dirty_row is not None and dirty_row[i]:
                job.pending_reason = PendingReason.RESOURCE
                rejected_rows.append(i)
                continue
            if job.spec.licenses and not self.licenses.malloc(
                    job.spec.licenses):
                job.pending_reason = PendingReason.LICENSE
                rejected_rows.append(i)
                continue
            if not self._malloc_run_limits(job):
                self.licenses.free(job.spec.licenses or {})
                job.pending_reason = PendingReason.QOS_LIMIT
                rejected_rows.append(i)
                continue
            job.node_ids = nodes_mat[i][valid_nodes[i]].tolist()
            job.task_layout = (tasks_mat[i][valid_nodes[i]].tolist()
                               if tasks_mat is not None else [])
            admitted.append(job)
            admitted_rows.append(i)
        # each entry sees earlier subtractions exactly as per-job
        # malloc calls would
        oks = self.meta.malloc_resource_batch(
            [(job.job_id, job.node_ids, self._job_alloc(job))
             for job in admitted])
        started_jobs: list[Job] = []
        for job, row, ok in zip(admitted, admitted_rows, oks):
            if not ok:
                self.licenses.free(job.spec.licenses or {})
                self._free_run_limits(job)
                job.node_ids = []
                job.task_layout = []
                job.alloc_cache = None
                job.pending_reason = PendingReason.RESOURCE
                rejected_rows.append(row)
                continue
            del self.pending[job.job_id]
            job.status = JobStatus.RUNNING
            job.start_time = now
            job.pending_reason = PendingReason.NONE
            self._init_steps(job, now)
            self.running[job.job_id] = job
            started_jobs.append(job)
            started.append(job.job_id)
        for job, node_ids in future_start:
            req = self._job_row(job)[0]
            fits_now = bool(node_ids) and all(
                (req <= self.meta.nodes[n].avail).all() for n in node_ids)
            job.pending_reason = (PendingReason.PRIORITY if fits_now
                                  else PendingReason.RESOURCE)
        if rejected_rows:
            bad = nodes_mat[rejected_rows]
            self._resident.mark_diverged(np.unique(bad[bad >= 0]))
        self._ledger_add_batch(started_jobs, now)
        for job in started_jobs:
            self._queue_dispatch(job, job.node_ids)
        return started

    # ------------------------------------------------------------------
    # packed / exclusive jobs
    # ------------------------------------------------------------------

    @staticmethod
    def _is_packed(spec: JobSpec) -> bool:
        """A packed or exclusive job: its cycle takes the packed solve."""
        return bool(spec.exclusive or spec.task_res is not None
                    or (spec.ntasks is not None
                        and spec.ntasks != spec.node_num)
                    or spec.ntasks_per_node_max > 1)

    def _packed_batch(self, batch: JobBatch, ordered: list[Job]
                      ) -> PackedJobBatch:
        """The packed solve's batch: the dense batch plus each job's task
        shape, in priority order."""
        lay = self.meta.layout
        J = len(ordered)
        node_req = np.zeros((J, lay.num_dims), np.int32)
        task_req = np.zeros((J, lay.num_dims), np.int32)
        ntasks = np.ones(J, np.int32)
        nt_min = np.ones(J, np.int32)
        nt_max = np.ones(J, np.int32)
        exclusive = np.zeros(J, bool)
        for i, job in enumerate(ordered):
            spec = job.spec
            node_req[i] = self._job_row(job)[0]
            if spec.task_res is not None:
                task_req[i] = spec.task_res.encode(lay)
            ntasks[i] = (spec.ntasks if spec.ntasks is not None
                         else spec.node_num)
            nt_min[i] = spec.ntasks_per_node_min
            nt_max[i] = max(spec.ntasks_per_node_max,
                            spec.ntasks_per_node_min)
            exclusive[i] = spec.exclusive
        dev = self.device

        def t(x):
            return torch.from_numpy(x).to(dev)

        return PackedJobBatch(
            node_req=t(node_req), task_req=t(task_req), ntasks=t(ntasks),
            ntasks_min=t(nt_min), ntasks_max=t(nt_max),
            node_num=batch.node_num, time_limit=batch.time_limit,
            part_mask=batch.part_mask, exclusive=t(exclusive),
            valid=batch.valid)

    # ------------------------------------------------------------------
    # topology-aware placement (topo/)
    # ------------------------------------------------------------------

    def _active_topology(self):
        """The attached Topology, or None when absent or stale (nodes
        registered after it was built: its arrays no longer line up with
        the snapshot)."""
        topo = self.meta.topology
        if topo is not None and topo.num_nodes != len(self.meta.nodes):
            return None
        return topo

    def _update_topo_fragmentation(self, topo, avail, total, alive) -> None:
        """Leaf-level free-capacity fragmentation of the cycle snapshot
        (a free node is alive with its full capacity available)."""
        free = np.asarray(alive) & (np.asarray(avail)
                                    == np.asarray(total)).all(axis=1)
        self._cur_trace["topo_frag"] = topo.fragmentation(free)[0][1]

    def _note_topo(self, topo, ordered: list[Job], info) -> None:
        """Per-gang locality verdicts: trace fields, stats and each job's
        topo_block / cross_block."""
        host = torch.stack([info.in_block.to(torch.int32),
                            info.cross.to(torch.int32),
                            info.block.to(torch.int32)]).cpu().numpy()
        in_b, crs, blocks = host.tolist()
        n_in, n_cross = sum(in_b), sum(crs)
        self._cur_trace["topo_in_block"] = n_in
        self._cur_trace["topo_cross"] = n_cross
        self.stats["topo_in_block_total"] = (
            self.stats.get("topo_in_block_total", 0) + n_in)
        self.stats["topo_cross_block_total"] = (
            self.stats.get("topo_cross_block_total", 0) + n_cross)
        for i, job in enumerate(ordered):
            job.cross_block = bool(crs[i])
            job.topo_block = (
                topo.block_names[blocks[i]]
                if in_b[i] and blocks[i] >= 0
                else ("spanning" if crs[i] else ""))

    # ------------------------------------------------------------------
    # QoS preemption: a blocked job whose QoS lists lower QoS as
    # preemptable evicts their running jobs; victims lowest QoS first,
    # then youngest first
    # ------------------------------------------------------------------

    def _preemptor_req(self, job: Job) -> tuple[np.ndarray, list[int]]:
        """Per-node requirement a preemptor needs freed, and its task
        layout.  Packed jobs use the balanced layout's MAX per-node
        requirement in the what-if (the commit gives later nodes the
        floor, which can only need less)."""
        spec = job.spec
        base = spec.res.encode(self.meta.layout).astype(np.int64)
        ntasks = spec.ntasks if spec.ntasks is not None else spec.node_num
        # balanced layout always (all ones for ntasks == node_num)
        hi = int(np.ceil(ntasks / spec.node_num))
        lo = ntasks // spec.node_num
        n_hi = ntasks - lo * spec.node_num
        layout = [hi] * n_hi + [lo] * (spec.node_num - n_hi)
        if spec.task_res is None:
            return base, layout
        task = spec.task_res.encode(self.meta.layout).astype(np.int64)
        return base + task * hi, layout

    def _preempt_inputs(self, cands: list[Job], prey_sets: list,
                        victims: list[Job], now: float) -> dict:
        """The what-if's host arrays, vectorised: the flat (victim, node)
        rows in victim order (``vid``, ``node``, ``alloc``, and with
        backfill ``end``, the release bucket), the preemptors' rows
        (``req``, ``node_num``, ``time_limit``, ``part_mask``,
        ``exclusive``, ``layouts``) and ``can_prey[J, V]``, a gather of a
        ``[J, Q]`` QoS membership table by each victim's QoS id."""
        R = self.meta.layout.num_dims
        allocs = [self._job_alloc(v) for v in victims]
        lens = np.fromiter((len(v.node_ids) for v in victims), np.int64,
                           len(victims))
        M = int(lens.sum())
        out = {
            "vid": np.repeat(np.arange(len(victims), dtype=np.int32), lens),
            "node": np.fromiter(
                (n for v in victims for n in v.node_ids), np.int32, M),
            "alloc": (np.stack([a for al in allocs for a in al]).astype(
                np.int32) if M else np.zeros((0, R), np.int32)),
        }
        qid = {name: q for q, name in enumerate(sorted(set().union(
            *prey_sets)))}
        table = np.zeros((len(cands), len(qid)), bool)
        for i, prey in enumerate(prey_sets):
            table[i, [qid[name] for name in prey]] = True
        v_qos = np.fromiter((qid[v.qos_name] for v in victims), np.int64,
                            len(victims))
        out["can_prey"] = table[:, v_qos]
        reqs, layouts = zip(*(self._preemptor_req(job) for job in cands))
        out["req"] = np.stack(reqs).astype(np.int32)
        out["layouts"] = list(layouts)
        out["node_num"] = np.array([j.spec.node_num for j in cands], np.int32)
        out["time_limit"] = np.array([j.spec.time_limit for j in cands],
                                     np.int32)
        out["part_mask"] = np.stack([self._mask_for(j, now) for j in cands])
        out["exclusive"] = np.array([j.spec.exclusive for j in cands], bool)
        if self.config.backfill:
            T = self.config.time_buckets
            start = np.array([v.start_time or now for v in victims],
                             np.float64)
            limit = np.array([v.spec.time_limit for v in victims],
                             np.float64)
            remain = np.maximum(start + limit - now, 0.0)
            end = np.minimum(self._grid.release_bucket(remain), T + 1)
            out["end"] = end.astype(np.int32)[out["vid"]]
        return out

    def _try_preemption(self, ordered: list[Job], now: float) -> list[int]:
        """The device what-if (``models/preempt.py``, or the time-axis
        ``models/preempt_time.py`` with backfill) and the host commit.
        Runs after the normal solve, so a job that got only a
        future-start reservation can still preempt its way to an
        immediate start."""
        if self.config.preempt_mode == "off" or self.accounts is None:
            return []
        # blocked preemptor candidates, in priority order
        cands, prey_sets = [], []
        for job in ordered:
            if job.job_id not in self.pending:
                continue  # it placed normally
            if job.pending_reason not in (PendingReason.RESOURCE,
                                          PendingReason.PRIORITY):
                continue
            qos = self.accounts.qos.get(job.qos_name)
            if qos is None or not qos.preempt:
                continue
            cands.append(job)
            prey_sets.append(qos.preempt)
        if not cands:
            return []
        # the victim pool: only jobs some candidate may prey on, sorted
        # once by the victim order; the global order induces each node's
        prey_union = set().union(*prey_sets)
        victims = sorted(
            (j for j in self.running.values() if j.qos_name in prey_union),
            key=lambda v: (v.qos_priority, -(v.start_time or 0.0)))
        if not victims:
            return []

        t0 = time.perf_counter()
        x = self._preempt_inputs(cands, prey_sets, victims, now)
        dev = self.device

        def t(a, dtype=None):
            out = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            return out if dtype is None else out.to(dtype)

        J, V, M = len(cands), len(victims), len(x["vid"])
        vrows = VictimRows(vid=t(x["vid"]), node=t(x["node"]),
                           alloc=t(x["alloc"]),
                           valid=torch.ones(M, dtype=torch.bool, device=dev))
        jobs = dict(req=t(x["req"]), node_num=t(x["node_num"]),
                    time_limit=t(x["time_limit"]),
                    part_mask=t(x["part_mask"]),
                    exclusive=t(x["exclusive"]), can_prey=t(x["can_prey"]),
                    valid=torch.ones(J, dtype=torch.bool, device=dev))
        max_nodes = max(1, min(int(x["node_num"].max(initial=1)),
                               self.config.max_nodes_per_job))
        avail, total, alive = self.meta.snapshot()
        N = total.shape[0]
        cost0 = self._ledger.cost0(now, N)
        t1 = time.perf_counter()
        start_buckets = None
        if self.config.backfill:
            # s == 0 starts now; s > 0 defers the evictions to the start
            # bucket (the victims keep running until then)
            tstate = self._timed_state(now, avail, total, alive, cost0)
            decisions, _ = solve_preempt_timed(
                tstate.time_avail, tstate.total, tstate.alive, tstate.cost,
                TimedVictimRows(rows=vrows, end_bucket=t(x["end"])),
                TimedPreemptorBatch(**jobs), num_victims=V,
                max_nodes=max_nodes, edges=self._grid_edges)
            start_buckets = decisions.start_bucket.cpu().numpy()
        else:
            state = make_cluster_state(avail, total, alive, cost0,
                                       device=dev)
            decisions, _ = solve_preempt(
                state.avail, state.total, state.alive, state.cost, vrows,
                PreemptorBatch(**jobs), num_victims=V, max_nodes=max_nodes)
        placed = decisions.placed.cpu().numpy()
        nodes_mat = decisions.nodes.cpu().numpy()
        evict_mat = decisions.evict.cpu().numpy()
        t2 = time.perf_counter()
        trace = self._cur_trace
        trace["preempt_solve_ms"] = (t2 - t1) * 1e3
        trace["preempt_inputs_ms"] = (t1 - t0) * 1e3
        trace["preempt_shape"] = (J, V, M)

        started: list[int] = []
        T = self.config.time_buckets
        for i, job in enumerate(cands):
            if not placed[i]:
                continue
            chosen = [int(n) for n in nodes_mat[i] if n >= 0]
            evict_ids = [victims[vi].job_id
                         for vi in np.nonzero(evict_mat[i])[0]]
            if start_buckets is not None and start_buckets[i] > 0:
                # a future start: killing the victims now would leave
                # their resources idle until the start bucket, so the
                # evictions are deferred to its edge; each cycle's solve
                # rewrites the claims
                if evict_ids:
                    due = now + float(self._grid.edges[
                        min(int(start_buckets[i]), T)])
                    for victim_id in evict_ids:
                        self._deferred_evictions[victim_id] = (
                            due, job.job_id)
                    job.pending_reason = PendingReason.PRIORITY
                continue
            if self._commit_preemption(job, chosen, evict_ids,
                                       x["layouts"][i], now):
                started.append(job.job_id)
            else:
                # later candidates' decisions assumed this one placed:
                # stop, they retry next cycle against fresh state
                break
        return started

    def _commit_preemption(self, job: Job, chosen: list[int],
                           evict_ids: list[int], layout: list[int],
                           now: float) -> bool:
        """Host-authoritative commit of one preemption decision:
        admission checks BEFORE any eviction (victims never die for a
        preemptor that cannot start), then evict, then malloc."""
        if len(chosen) < job.spec.node_num:
            return False
        if job.spec.licenses and not self.licenses.malloc(
                job.spec.licenses):
            job.pending_reason = PendingReason.LICENSE
            return False
        if not self._malloc_run_limits(job):
            self.licenses.free(job.spec.licenses or {})
            job.pending_reason = PendingReason.QOS_LIMIT
            return False

        for victim_id in evict_ids:
            self._evict(victim_id, now)
        job.node_ids = chosen
        job.task_layout = list(layout)
        job.alloc_cache = None
        if not self.meta.malloc_resource(job.job_id, chosen,
                                         self._job_alloc(job)):
            # only a mid-cycle reduce event gets here: undo admission
            self.licenses.free(job.spec.licenses or {})
            self._free_run_limits(job)
            job.node_ids = []
            job.task_layout = []
            job.alloc_cache = None
            job.pending_reason = PendingReason.RESOURCE
            return False
        del self.pending[job.job_id]
        job.status = JobStatus.RUNNING
        job.start_time = now
        job.pending_reason = PendingReason.NONE
        self._init_steps(job, now)
        self.running[job.job_id] = job
        self._ledger_add(job, now)
        self._queue_dispatch(job, chosen)
        return True

    def _drain_deferred_evictions(self, now: float) -> None:
        """Fire timed-preemption evictions whose start bucket arrived.
        A claim is void once its preemptor left the pending queue (placed,
        cancelled) or was held, or the victim ended on its own: void
        claims are dropped without killing anything."""
        for victim_id in list(self._deferred_evictions):
            due, preemptor_id = self._deferred_evictions[victim_id]
            preemptor = self.pending.get(preemptor_id)
            if (preemptor is None or preemptor.held
                    or victim_id not in self.running):
                del self._deferred_evictions[victim_id]
                continue
            if due <= now:
                del self._deferred_evictions[victim_id]
                self._evict(victim_id, now)

    def _evict(self, victim_id: int, now: float) -> None:
        """Evict a running job for a preemptor: kill its steps, free its
        resources, then requeue or cancel it per ``preempt_mode``."""
        victim = self.running.get(victim_id)
        if victim is None:
            return
        self._cur_trace["preempted"] = (
            self._cur_trace.get("preempted", 0) + 1)
        self.stats["jobs_preempted_total"] = (
            self.stats.get("jobs_preempted_total", 0) + 1)
        self.dispatch_terminate(victim_id, now,
                                incarnation=victim.requeue_count)
        self._release_job_resources(victim)
        del self.running[victim_id]
        if victim.cancel_requested:
            # the user already cancelled it (kill in flight): honour the
            # cancel instead of requeueing it as preempted
            victim.status = JobStatus.CANCELLED
            victim.end_time = now
            victim.exit_code = 130
            self._finalize_terminal(victim)
            return
        if self.config.preempt_mode == "requeue":
            victim.reset_for_requeue()
            victim.pending_reason = PendingReason.PREEMPTED
            if victim.requeue_count > self.config.max_requeue_count:
                victim.held = True
                victim.pending_reason = PendingReason.HELD
            self.pending[victim_id] = victim
        else:  # cancel
            victim.status = JobStatus.CANCELLED
            victim.end_time = now
            victim.exit_code = 143
            self._finalize_terminal(victim)
