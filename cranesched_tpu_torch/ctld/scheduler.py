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
   - ``backfill=False``: the immediate fit, by the configured
     ``solver``: the greedy placement by the CUDA kernel on the
     device-resident cluster state (``"cuda"``, the default, and
     ``"pallas"``; ``models/gpu_solver.py``, ``ctld/resident.py``), the
     native C++ solver (``"native"``, and ``"auto"`` while it can take
     the shape; ``utils/native.py``) or the plain ``solve_greedy`` on
     the scheduler's device (``"device"``);
   - ``backfill=True`` (the default) with at most ``backfill_max_jobs``
     candidates: the time-axis solve over every candidate
     (``models/solver_time.py``), whose future starts hold reservations;
   - ``backfill=True`` with more candidates: that solve for the
     ``backfill_max_jobs`` head, then the immediate fit for the tail
     against the head's min-over-horizon availability;
   under a topology the greedy kernel sees the node axis in block-major
   order (``Topology.perm``) and its picks are mapped back;
5. the host commit against the authoritative ledger, with the license
   and QoS run-limit admission (``ctld/licenses.py``,
   ``ctld/accounting.py``);
6. with accounts and a ``preempt_mode``, the preemption what-if after
   every route (``models/preempt.py``, or ``models/preempt_time.py``
   with backfill), its evictions and starts; then the dispatch.

Around the cycle sits the job lifecycle: dependencies, begin times,
job arrays (one child per template per cycle), reservations named by a
job, hold / requeue / ``modify_job`` / suspend / resume, node deaths,
cancel intents that are renewed until confirmed, steps inside an
allocation (``alloc_only`` jobs), and a submit hook.  With a
``WriteAheadLog`` every durable mutation is logged before it takes
effect: each lock-held segment of a cycle is one WAL group (one write,
one fsync), and the dispatch ring drops any entry whose start record
is not durable.  ``recover`` rebuilds the queues from a replay and
``rebuild_device_state`` drops every device-side cache, so the first
cycle after a restart pays one full rebuild of the resident state.

The observability planes run beside the cycle as in the JAX package:
the cycle trace ring, the event log, the per-job timelines with their
SLOs, the flight recorder, the ``torch.profiler`` capture window and
``explain_pending`` (``obs/``, ``ctld/explain.py``).

Semantics are the JAX package's, bit for bit, under every solver name,
``"sharded"`` included (the node-axis-sharded solve over a device mesh,
``parallel/sharded.py``).  A federation shard carries the JAX package's
hooks at its places: ``fed`` (``fed/shard.py``'s lease and migration
plane), ``global_usage`` (``fed/usage.py``'s cluster-wide limits and
fair-share input), ``sealed_partitions`` and ``shard_name``; with
``fed`` and ``global_usage`` None every cycle is a single controller's.

The cycle is an explicit ``schedule_cycle(now)`` call with virtual time;
``cycle_phases`` exposes it as a generator whose yielded closures (the
solve, the dispatch drain) may run with the caller's lock released.
A server (``rpc/server.py``) points ``cycle_kick`` at its loop's wakeup;
every mutation that can change the next cycle's outcome calls it.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
import traceback
from typing import Callable

import numpy as np
import torch

from cranesched_tpu_torch.ctld.accounting import AccountMetaContainer
from cranesched_tpu_torch.ctld.defs import (
    DEP_NEVER,
    DepType,
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
    greedy_place,
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
    solve_greedy,
)
from cranesched_tpu_torch.models.solver_time import (
    TimedClusterState,
    TimedJobBatch,
    TimeGrid,
    make_timed_state,
    solve_backfill,
)
from cranesched_tpu_torch.obs import introspect
from cranesched_tpu_torch.obs.events import EventLog
from cranesched_tpu_torch.obs.flight import FlightRecorder
from cranesched_tpu_torch.obs.jobtrace import JobTraceRecorder
from cranesched_tpu_torch.obs.metrics import REGISTRY as _OBS
from cranesched_tpu_torch.obs.slo import SloEngine
from cranesched_tpu_torch.obs.trace import CycleSpans, CycleTraceRing
from cranesched_tpu_torch.ops.resources import DIM_CPU, DIM_MEM
from cranesched_tpu_torch.topo.place import solve_greedy_topo

_LOG = logging.getLogger("cranesched.ctld")

# cycle-plane metrics, under the JAX package's names (served by the
# ctld's /metrics endpoint and QueryStats)
_MET_CYCLES = _OBS.counter(
    "crane_cycles_total", "scheduling cycles completed")
_MET_PHASE = _OBS.histogram(
    "crane_cycle_phase_seconds",
    "wall time per cycle phase "
    "(label phase=prelude|solve|commit|dispatch)")
_MET_COMMIT_BATCH = _OBS.histogram(
    "crane_commit_batch_jobs", "jobs committed per _commit batch",
    buckets=tuple(float(2 ** k) for k in range(18)))
_MET_LOCK = _OBS.histogram(
    "crane_lock_held_seconds",
    "server-lock-held time per cycle (prelude + commit, never solve)")
_MET_SOLVE = _OBS.histogram(
    "crane_solve_seconds",
    "lock-released solve closure time (label backend)")
_MET_STARTED = _OBS.counter(
    "crane_jobs_started_total", "jobs started by the scheduler")
_MET_PREEMPTED = _OBS.counter(
    "crane_preempted_total", "running jobs evicted by preemption")
_MET_PENDING = _OBS.gauge(
    "crane_pending_jobs",
    "pending queue depth (updated on submit/finish events)")
_MET_RUNNING = _OBS.gauge(
    "crane_running_jobs",
    "running job count (updated on start/finish events)")
_MET_SKIPS = _OBS.counter(
    "crane_cycle_skips_total",
    "cycles short-circuited by the no-op fingerprint (label reason)")
_MET_TOPO_FRAG = _OBS.gauge(
    "crane_topo_fragmentation",
    "free-capacity fragmentation per topology level "
    "(1 - largest free group / total free; label level)")
_MET_TOPO_CROSS = _OBS.counter(
    "crane_topo_cross_block_gangs_total",
    "gangs placed across blocks by the spanning fallback")
_MET_H2D = _OBS.counter(
    "crane_solver_h2d_bytes_total",
    "host->device bytes shipped for the solve's cluster state "
    "(label mode=rebuild|patch)")
_MET_RESIDENT = _OBS.counter(
    "crane_resident_cycles_total",
    "immediate-fit cycles served by the device-resident state "
    "(label mode=rebuild|patch)")
_MET_OVERLAP = _OBS.gauge(
    "crane_resident_patch_overlap_share",
    "share of resident patch cycles whose delta upload was pre-staged "
    "(double-buffered) by the previous cycle")

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


#: ``SchedulerConfig.solver`` values the port runs
SOLVERS = ("cuda", "pallas", "native", "auto", "device", "sharded")


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
    # a craned that expects pings and misses them this long is down
    craned_timeout: float = 30.0
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
    # bounded ring of structured per-cycle traces (obs/trace.py)
    cycle_trace_ring: int = 64
    # the immediate-fit backend (the split backfill's tail too): "cuda"
    # the CUDA greedy-placement kernel, and "pallas" (the JAX package's
    # name for its kernel) the same; "native" the C++ solver
    # (utils/native.py; raises when it cannot take the shape or build);
    # "auto" the C++ solver where it can take the shape, else the
    # kernel; "device" the plain solve_greedy on the scheduler's device.
    # All are bit-identical on placements.  "sharded" is ROADMAP A10.
    solver: str = "cuda"
    # post-commit dispatch fan-out width (YAML ``DispatchWorkers``).
    # None sizes the dispatcher pool from the cluster:
    # max(8, nodes // 64), capped at 128 (rpc/dispatcher.py)
    dispatch_workers: int | None = None
    # incremental cycle state: the PendingTable candidate pass, delta
    # meta snapshots and the no-op-cycle fingerprint.  False rebuilds
    # from scratch every cycle (the parity oracle).
    incremental: bool = True
    # the longest the server's event-driven loop sleeps when the next
    # cycle is provably a no-op (rpc/server.py ``_sleep_interval``)
    cycle_idle_sleep: float = 30.0
    # keep the solve's ClusterState on the device across cycles and
    # patch only dirty rows (ctld/resident.py); effective only with
    # ``incremental`` (the dirty feed is the delta-snapshot machinery)
    resident_state: bool = True
    # stream planner knobs (plan_streams)
    max_streams: int = 4
    block_jobs: int = 256
    # per-job lifecycle tracing (obs/jobtrace.py): timelines stamped at
    # submit / candidate / commit / durable-dispatch / terminal edges
    # and by the node plane.  False removes every stamp from the cycle.
    job_trace: bool = True
    # bounded timeline store size (live + closed, each)
    job_trace_capacity: int = 4096
    # SLO targets over trace edges (obs/slo.py): tuple of
    # (name, from_edge, to_edge, percentile, target_seconds, windows)
    slo: tuple = ()

    def __post_init__(self):
        if self.preempt_mode not in ("off", "requeue", "cancel"):
            raise ValueError(
                f"preempt_mode must be off|requeue|cancel, "
                f"got {self.preempt_mode!r}")
        if self.solver not in SOLVERS:
            raise ValueError(f"solver must be one of {'|'.join(SOLVERS)}, "
                             f"got {self.solver!r}")
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
        self.disjoint = True      # no node is in 2+ rows (see node_class)
        self._node_class: np.ndarray | None = None

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
        self._node_class = None

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
                self._node_class = None
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

    def node_class(self) -> np.ndarray | None:
        """Per-node owner class id iff the rows are pairwise disjoint —
        then ``rows[c] == (node_class == c)`` exactly, which feeds the
        native solver's partition-id mode (no dense [J, N] mask).
        Unowned nodes get a label no job carries.  None when rows
        overlap.  Call after ``tables``."""
        if not self.disjoint:
            return None
        if self._node_class is None:
            rows_np = self.rows_np
            owner = np.full(rows_np.shape[1], rows_np.shape[0], np.int32)
            cls, node = np.nonzero(rows_np)
            owner[node] = cls
            self._node_class = owner
        return self._node_class


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
    ``meta.set_topology``.  ``wal`` (a ``ctld.wal.WriteAheadLog``) makes
    the lifecycle durable; ``archive`` (a ``ctld.archive.JobArchive``)
    keeps terminal jobs past WAL compaction.  ``submit_hook`` maps a
    JobSpec to a JobSpec (possibly rewritten) or None (reject); a hook
    that raises or returns anything else rejects the job and counts in
    ``stats['submit_hook_failures']``."""

    # history the RAM dict may hold with an archive attached (without
    # one, RAM is the only record and nothing is evicted)
    HISTORY_CACHE_MAX = 10_000

    # minimum seconds between kill re-sends for one unconfirmed cancel
    CANCEL_RENEW_INTERVAL = 5.0

    def __init__(self, meta: MetaContainer,
                 config: SchedulerConfig | None = None,
                 dispatch: Callable[[Job, list[int]], None] | None = None,
                 device=None, wal=None, accounts=None, submit_hook=None,
                 archive=None):
        self.device = resolve_device(device)
        self.meta = meta
        self.config = config = config or SchedulerConfig()
        self.dispatch = dispatch or (lambda job, nodes: None)
        # optional batched dispatch seam (GrpcDispatcher.wire sets it):
        # one call for the whole post-commit ring with per-craned
        # coalescing; None falls back to per-job self.dispatch
        self.dispatch_batch = None
        self.wal = wal
        # HA fencing term stamped on dispatch ring entries; 0 until HA
        # is in the port
        self.fencing_epoch = 0
        # attached at the end of __init__: attach_archive seeds the
        # job-id counter
        self.archive = None
        # accounting: None = open system, no limit enforcement
        self.accounts = accounts
        self.account_meta = (AccountMetaContainer(meta.layout)
                             if accounts is not None else None)
        # cluster-wide accounting (fed/usage.py UsageBook): conservative
        # global MaxJobs/MaxSubmitJobs gate + fair-share service input.
        # None = per-shard limits only (single-controller behavior)
        self.global_usage = None
        # live partition migration (fed/rebalance.py): a sealed
        # partition stops admitting — its jobs are mid-handoff to
        # another shard and a new local submit would be stranded
        self.sealed_partitions: set[str] = set()
        # federated control plane (fed/): this controller's shard name
        # ("" outside a federation) and the lease plane that
        # fed.shard.FedShardPlane grafts on — None for a single
        # controller, so every fed hook is a cheap attribute check
        self.shard_name = ""
        self.fed = None
        self.licenses = LicenseManager()
        self.submit_hook = submit_hook
        # event-driven loop plumbing: the server points cycle_kick at
        # its wakeup event; mutations that can change the next cycle's
        # outcome call _kick() so a sleeping loop wakes immediately
        self.cycle_kick: Callable[[], None] | None = None
        # timed preemption's deferred evictions: victim job_id -> (due
        # time, preemptor job_id); the prelude fires due entries
        self._deferred_evictions: dict[int, tuple[float, int]] = {}
        # ordered post-commit dispatch ring: (job, node_ids, incarnation,
        # fencing epoch, WAL seq) queued by the commits, drained by the
        # cycle's final phase once the WAL group holding the start
        # records is durable
        self._dispatch_ring: collections.deque = collections.deque()
        # persistent SoA mirror of the pending queue
        self._ptable = PendingTable(meta.layout.num_dims)
        # membership indexes kept by the dict hooks: array templates
        # awaiting materialization, alloc_only jobs whose time limit the
        # scheduler enforces itself
        self._array_templates: set[int] = set()
        self._alloc_only: set[int] = set()
        # dependee job -> waiting dependents
        self._dependents: dict[int, set[int]] = {}
        # job_id -> last kill send for unconfirmed cancel intents; the
        # same per (job_id, step_id) for step cancels
        self._cancel_kill_sent: dict[int, float] = {}
        self._step_cancel_sent: dict[tuple[int, int], float] = {}
        # job_id -> (new time limit, last send) for unconfirmed pushes
        self._limit_intents: dict[int, tuple[float, float]] = {}
        self._finalized_since_compact = 0
        # WAL (fsyncs, groups, bytes, records) at the start of the
        # in-flight cycle
        self._wal_cycle_base = (0, 0, 0, 0)
        # no-op short-circuit state: fingerprint + nearest time edge
        self._noop_fp: tuple | None = None
        self._noop_edge: float = float("inf")
        self._cycle_fp0: tuple | None = None
        # the usage gate's denial count at the cycle's start: a cycle in
        # which it refused a candidate never arms the no-op skip
        self._cycle_usage_denied0: int = 0
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
        # step-level reports from transport threads, drained by
        # process_status_changes
        self._step_report_queue: collections.deque[tuple] = (
            collections.deque())
        self._next_job_id = 1
        self._account_index: dict[str, int] = {}
        self._mask_cache: dict[tuple, np.ndarray] = {}
        self._mask_cache_epoch = -1
        self._mask_table = _MaskTable()
        self._mesh = None  # lazy device mesh for solver == "sharded"
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
        # node lifecycle events: ``node_event_hook`` (callable(record))
        # runs on one worker thread, in order; ``node_events`` keeps the
        # last 200 records
        self.node_event_hook = None
        self.node_events: list[dict] = []
        self._node_event_queue = None  # lazily-started ordered worker
        # structured per-cycle traces (obs/trace.py); _cur_trace is the
        # in-flight cycle's accumulator, pushed to the ring at its end;
        # consecutive skipped cycles coalesce into one ring row
        self.cycle_trace = CycleTraceRing(config.cycle_trace_ring)
        # the cycle's span tree, written into its row (a server adds its
        # own lock wait and plane advance before the root)
        self.cycle_spans = CycleSpans()
        self._cur_trace: dict = {}
        self._skip_trace: dict | None = None
        # per-job lifecycle tracing + SLO plane (obs/jobtrace.py,
        # obs/slo.py): None when job_trace is off, and every stamp site
        # guards on it
        self.slo_engine = SloEngine.from_config(config.slo)
        self.jobtrace = (JobTraceRecorder(
            capacity=config.job_trace_capacity, slo=self.slo_engine)
            if config.job_trace else None)
        # structured cluster event log (obs/events.py)
        self.events = EventLog()
        if self.slo_engine is not None:
            self.slo_engine.event_sink = self._slo_event
        # introspection plane (obs/introspect.py): per-cycle build
        # attribution is delta-based off the process-wide counter; the
        # profiler window is ticked at cycle boundaries
        self._cycle_compile_base = introspect.total_compiles()
        # greedy_place's launches in this cycle (a delta off its count)
        self._cycle_launch_base = greedy_place.launches
        self.profiler_window = introspect.ProfilerWindow(
            event_sink=lambda type, sev, detail="": self.events.emit(
                type, sev, detail=detail),
            namespace=lambda: self.shard_name)
        # stall forensics (obs/flight.py): the phase ring the cycle
        # stamps, and the stall sentry a server loop arms per cycle
        self.flight = FlightRecorder(
            event_sink=lambda type, sev, detail="": self.events.emit(
                type, sev, detail=detail))
        # the in-flight cycle's ``now``: the dispatch-ring drain stamps
        # committed_durable/dispatched on the clock the cycle used
        self._cycle_now = 0.0
        if archive is not None:
            self.attach_archive(archive)

    # cycles before a fresh build counts as a steady-state violation
    # (the first cycles legitimately build each kernel they launch)
    WARMUP_CYCLES = 3

    def emit_node_event(self, event: str, node_name: str,
                        detail: str = "", now: float = 0.0) -> None:
        """Record + fan out one node lifecycle event.  The hook runs on
        one worker thread draining a queue: operator code never blocks a
        cycle, and back-to-back transitions (drain then undrain) reach
        the hook in order, never concurrently."""
        record = {"event": event, "node": node_name, "detail": detail,
                  "time": now}
        self.node_events.append(record)
        if len(self.node_events) > 200:
            del self.node_events[: len(self.node_events) - 200]
        # mirror into the typed event ring (flap detection included)
        self.events.emit_node_transition(event, node_name, detail=detail,
                                         now=now)
        if self.node_event_hook is None:
            return
        if self._node_event_queue is None:
            self._node_event_queue = queue.Queue()

            def worker():
                while True:
                    rec = self._node_event_queue.get()
                    hook = self.node_event_hook
                    if hook is None:
                        continue
                    try:
                        hook(rec)
                    except Exception:
                        _LOG.error("node event hook raised:\n%s",
                                   traceback.format_exc())

            threading.Thread(target=worker, daemon=True,
                             name="node-event-hook").start()
        self._node_event_queue.put(record)

    def _slo_event(self, name: str, window: float, burn: float,
                   breaching: bool) -> None:
        """SloEngine breach-edge sink -> typed event ring."""
        if breaching:
            self.events.emit(
                "slo_breach", "error",
                detail="%s window=%ds burn=%.2f" % (name, window, burn))
        else:
            self.events.emit(
                "slo_clear",
                detail="%s window=%ds recovered" % (name, window))

    def explain_pending(self, job_id: int, now: float) -> dict:
        """First-failing-gate decomposition for one job (ctld/explain.py).
        The caller holds the scheduler's lock."""
        from cranesched_tpu_torch.ctld.explain import explain_pending
        return explain_pending(self, job_id, now)

    def attach_archive(self, archive) -> None:
        """Wire the durable history store.  Seeds the job-id counter
        past every archived id: a restart whose WAL was compacted would
        otherwise reuse ids."""
        self.archive = archive
        self._next_job_id = max(self._next_job_id,
                                archive.max_job_id() + 1)

    # ------------------------------------------------------------------
    # incremental cycle state: membership hooks, the PendingTable row
    # derivation and the no-op-cycle fingerprint
    # ------------------------------------------------------------------

    def _kick(self) -> None:
        """Wake the server's event-driven cycle loop (no-op standalone)."""
        kick = self.cycle_kick
        if kick is not None:
            kick()

    def _on_pending_set(self, job_id: int, job: Job) -> None:
        self._table_upsert(job)
        if job.spec.array is not None:
            self._array_templates.add(job_id)
        _MET_PENDING.set(len(self.pending))
        self._kick()

    def _on_pending_del(self, job_id: int, job: Job) -> None:
        self._ptable.remove(job_id)
        self._array_templates.discard(job_id)
        _MET_PENDING.set(len(self.pending))
        self._kick()

    def _on_running_set(self, job_id: int, job: Job) -> None:
        if job.spec.alloc_only:
            self._alloc_only.add(job_id)
        self._run_epoch += 1
        _MET_RUNNING.set(len(self.running))
        if self.global_usage is not None:
            self.global_usage.note_run(job.spec.user, job.spec.account, 1)
            if job.global_run_reserved:
                # admission's held slot becomes the real running count
                self.global_usage.unreserve_run(job.spec.user,
                                                job.spec.account)
                job.global_run_reserved = False

    def _on_running_del(self, job_id: int, job: Job) -> None:
        self._alloc_only.discard(job_id)
        self._run_epoch += 1
        _MET_RUNNING.set(len(self.running))
        if self.global_usage is not None:
            self.global_usage.note_run(job.spec.user, job.spec.account, -1)

    @staticmethod
    def _dep_cols(job: Job) -> tuple[float, bool]:
        """``(dep_ready_time, never)`` table columns mirroring
        ``_deps_runnable``: the row is dep-blocked while
        ``dep_ready_time > now``; ``never`` selects the
        DEPENDENCY_NEVER_SATISFIED reason.  Edges still waiting on an
        event map to +inf with never=False: only ``_trigger_dep_event``
        (which refreshes the row) unblocks them."""
        if not job.dep_state:
            return float("-inf"), False
        states = list(job.dep_state.values())
        if job.spec.deps_is_or:
            finite = [v for v in states
                      if v is not None and v != DEP_NEVER]
            if finite:
                return min(finite), False
            if all(v == DEP_NEVER for v in states):
                return float("inf"), True
            return float("inf"), False
        if any(v == DEP_NEVER for v in states):
            return float("inf"), True
        if any(v is None for v in states):
            return float("inf"), False
        return max(states), False

    def _table_upsert(self, job: Job) -> None:
        """Derive one PendingTable row from the Job.  Every value the
        cycle's vectorized passes gather is re-derived here on any event
        that can change it."""
        spec = job.spec
        dep, dep_never = self._dep_cols(job)
        req, node_num, time_limit = self._job_row(job)
        part = self.meta.partitions.get(spec.partition)
        self._ptable.upsert(
            job.job_id,
            template=spec.array is not None,
            held=job.held,
            begin=(spec.begin_time if spec.begin_time is not None
                   else float("-inf")),
            dep=dep, dep_never=dep_never,
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

    def _table_refresh(self, job: Job) -> None:
        """Re-derive a pending job's row after an in-place mutation
        (hold, modify, a dependency trigger) and wake the loop."""
        if job.job_id in self.pending:
            self._table_upsert(job)
            self._kick()

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
        if (self.global_usage is not None
                and self.global_usage.denied
                != self._cycle_usage_denied0):
            # the cluster-wide usage gate refused a candidate this
            # cycle; its answer depends on gossip state (publish
            # throttle, peer summaries) that no epoch tracks
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
        """The short-circuited cycle: count it, and coalesce consecutive
        skips into one trace-ring row (an idle night must not flush real
        cycles out of the ring); only the snapshot / sort / solve /
        commit machinery is skipped."""
        self.stats["cycles"] += 1
        _MET_CYCLES.inc()
        self.stats["skipped_cycles"] += 1
        _MET_SKIPS.inc(reason=reason)
        self.flight.stamp("skip", detail=reason)
        ms = round((time.perf_counter() - t0) * 1e3, 3)
        self.stats["last_cycle_walltime"] = time.time()
        self.stats["last_cycle"] = {
            "solver": "skip", "skip_reason": reason, "prelude_ms": ms,
            "total_ms": ms, "pending": 0, "started": 0,
            "running": len(self.running)}
        st = self._skip_trace
        if st is not None:
            st["skips"] = st.get("skips", 0) + 1
            st["now"] = now
            st["total_ms"] = ms
            st.update(self.cycle_spans.fields(), **self._wal_cycle_io())
        else:
            trace = {
                "now": now, "queue_depth": len(self.pending),
                "solver": "skip", "skip_reason": reason, "skips": 1,
                "prelude_ms": ms, "solve_ms": 0.0, "commit_ms": 0.0,
                "dispatch_ms": 0.0, "total_ms": ms, "lock_held_ms": ms,
                "candidates": 0, "placed": 0, "preempted": 0,
                "backfilled": 0, "running": len(self.running),
                **self.cycle_spans.fields(), **self._wal_cycle_io()}
            self.cycle_trace.push(trace)
            self._skip_trace = trace
        return []

    def can_idle(self) -> bool:
        """True when an event-driven loop may sleep: the no-op
        fingerprint is armed and still matches, and no queued work
        (dispatch ring, status or step reports, unconfirmed kill or
        time-limit intents, deferred evictions) needs the next cycle."""
        return (self.config.incremental
                and self._noop_fp is not None
                and self._cycle_fingerprint() == self._noop_fp
                and not self._dispatch_ring
                and not self._status_queue
                and not self._step_report_queue
                and not self._cancel_kill_sent
                and not self._step_cancel_sent
                and not self._limit_intents
                and not self._deferred_evictions)

    def next_wake_time(self, now: float) -> float:
        """Earliest future moment a sleeping loop must cycle even without
        an event: a begin/dependency/reservation edge, an alloc_only
        job's time limit, the next craned ping-timeout sweep, or a
        deferred eviction.  +inf when nothing is time-gated."""
        wake = self._noop_edge
        for job_id in self._alloc_only:
            job = self.running.get(job_id)
            if job is not None and job.status == JobStatus.RUNNING:
                wake = min(wake, self._effective_end(job, now))
        if any(node.alive and node.expect_pings
               for node in self.meta.nodes.values()):
            wake = min(wake, now + self.config.craned_timeout / 2)
        for due, _preemptor in self._deferred_evictions.values():
            wake = min(wake, due)
        return wake

    # ------------------------------------------------------------------
    # submit / cancel / hold / requeue / modify
    # ------------------------------------------------------------------

    def _hook_failed(self, msg: str, *args) -> int:
        _LOG.error(msg, *args)
        self.stats["submit_hook_failures"] = (
            self.stats.get("submit_hook_failures", 0) + 1)
        return 0

    def submit(self, spec: JobSpec, now: float) -> int:
        """Validate and enqueue; returns job_id (0 = rejected)."""
        if self.submit_hook is not None:
            # operator code: a crashing or misbehaving hook rejects the
            # job, never the control plane, and is logged and counted
            try:
                spec = self.submit_hook(spec)
            except Exception:
                return self._hook_failed("submit hook raised:\n%s",
                                         traceback.format_exc())
            if spec is None:
                return 0
            if not isinstance(spec, JobSpec):
                return self._hook_failed(
                    "submit hook returned %r (expected JobSpec or None)",
                    type(spec).__name__)
        if len(self.pending) >= self.config.pending_queue_max_size:
            return 0
        part = self.meta.partitions.get(spec.partition)
        if part is None or not part.account_allowed(spec.account):
            return 0
        if spec.partition in self.sealed_partitions:
            return 0  # mid-migration: the successor map owns it now
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
        if spec.reservation:
            resv = self.meta.reservations.get(spec.reservation)
            if resv is None or not resv.account_allowed(spec.account):
                return 0
        if spec.licenses and self.licenses.legal(spec.licenses):
            return 0  # unknown license or count beyond the total
        if spec.array is not None and not spec.array.task_ids():
            return 0

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
        if self.global_usage is not None:
            # federation-wide MaxSubmitJobs (fed/usage.py): conservative
            # under bounded staleness — deny early, never overshoot
            if self.global_usage.check_submit(spec.user, spec.account):
                if self.account_meta is not None and qos_name:
                    self.account_meta.free_submit(
                        spec.user, spec.account, qos_name)
                return 0
            self.global_usage.note_submit(spec.user, spec.account)

        job_id = self._next_job_id
        self._next_job_id += 1
        self.stats["jobs_submitted_total"] += 1
        job = Job(job_id=job_id, spec=spec, submit_time=now,
                  qos_name=qos_name, qos_priority=qos_priority,
                  held=spec.held)
        if spec.held:
            job.pending_reason = PendingReason.HELD
        if spec.array is not None:
            job.array_remaining = spec.array.task_ids()
        self._register_dependencies(job)
        self.pending[job_id] = job
        if self.wal is not None:
            self.wal.job_submitted(job)
        if self.jobtrace is not None:
            self.jobtrace.stamp(job_id, 0, "submit", now)
        return job_id

    def job_summary(self, user: str = "", partition: str = ""
                    ) -> dict[str, int]:
        """Per-status job counts (reference QueryJobSummary,
        Crane.proto:1588) over pending + running + in-RAM history."""
        counts: dict[str, int] = {}
        for col in (self.pending, self.running, self.history):
            for job in col.values():
                if user and job.spec.user != user:
                    continue
                if partition and job.spec.partition != partition:
                    continue
                key = job.status.name
                counts[key] = counts.get(key, 0) + 1
        return counts

    def queue(self) -> list[Job]:
        """Pending then running jobs (the live queue a query reads)."""
        return list(self.pending.values()) + list(self.running.values())

    def job_info(self, job_id: int) -> Job | None:
        """The job in any state: pending, running or finished."""
        return (self.pending.get(job_id) or self.running.get(job_id)
                or self.history.get(job_id))

    # ---- dependencies: event-driven edges; AFTER fires on start, the
    # terminal kinds on the dependee's end, a failed branch never ----

    def _register_dependencies(self, job: Job) -> None:
        for dep in job.spec.dependencies:
            target = self.job_info(dep.job_id)
            if target is None:
                job.dep_state[dep.job_id] = DEP_NEVER
                continue
            sat = self._dep_satisfied_time(dep, target)
            job.dep_state[dep.job_id] = sat
            if sat is None:   # still waiting on an event
                self._dependents.setdefault(dep.job_id, set()).add(
                    job.job_id)

    @staticmethod
    def _dep_satisfied_time(dep, target: Job) -> float | None:
        """Edge state from the dependee's current state: a timestamp
        (satisfiable from then + delay), DEP_NEVER, or None (waiting)."""
        if dep.type == DepType.AFTER:
            if target.start_time is not None:
                return target.start_time + dep.delay_seconds
            if target.status.is_terminal:   # never started and never will
                return (target.end_time or 0.0) + dep.delay_seconds \
                    if target.status == JobStatus.COMPLETED else DEP_NEVER
            return None
        if not target.status.is_terminal:
            return None
        end = target.end_time or 0.0
        if dep.type == DepType.AFTER_ANY:
            return end + dep.delay_seconds
        if dep.type == DepType.AFTER_OK:
            return (end + dep.delay_seconds
                    if target.status == JobStatus.COMPLETED else DEP_NEVER)
        # AFTER_NOT_OK
        return (end + dep.delay_seconds
                if target.status.is_failed_kind else DEP_NEVER)

    def _trigger_dep_event(self, target: Job) -> None:
        """Re-evaluate the waiting edges of this job's dependents."""
        waiting = self._dependents.get(target.job_id)
        if not waiting:
            return
        done = set()
        for jid in waiting:
            dep_job = self.pending.get(jid)
            if dep_job is None:
                done.add(jid)
                continue
            changed = False
            for dep in dep_job.spec.dependencies:
                if dep.job_id != target.job_id:
                    continue
                sat = self._dep_satisfied_time(dep, target)
                if sat is not None:
                    dep_job.dep_state[dep.job_id] = sat
                    changed = True
            if changed:
                # dep_state mutated in place: the table row must see the
                # new ready time or NEVER verdict
                self._table_refresh(dep_job)
            if all(v is not None for v in dep_job.dep_state.values()):
                done.add(jid)
        if target.status.is_terminal:
            self._dependents.pop(target.job_id, None)
        else:
            waiting -= done

    @staticmethod
    def _deps_runnable(job: Job, now: float) -> PendingReason | None:
        """None = runnable; else the pending reason to surface."""
        if not job.dep_state:
            return None
        states = list(job.dep_state.values())
        if job.spec.deps_is_or:
            if any(v is not None and v != DEP_NEVER and v <= now
                   for v in states):
                return None
            if all(v == DEP_NEVER for v in states):
                return PendingReason.DEPENDENCY_NEVER_SATISFIED
            return PendingReason.DEPENDENCY
        if any(v == DEP_NEVER for v in states):
            return PendingReason.DEPENDENCY_NEVER_SATISFIED
        if all(v is not None and v <= now for v in states):
            return None
        return PendingReason.DEPENDENCY

    def cancel(self, job_id: int, now: float) -> bool:
        if job_id in self.pending:
            job = self.pending.pop(job_id)
            job.status = JobStatus.CANCELLED
            job.end_time = now
            if job.spec.array is not None:
                # a template: drop the unmaterialized tasks and cancel
                # the live children
                job.array_remaining = []
                for c in list(job.array_children):
                    self.cancel(c, now)
            self._finalize_terminal(job)
            return True
        if job_id in self.running:
            job = self.running[job_id]
            job.cancel_requested = True
            if job.spec.alloc_only:
                # no batch step will ever report: the scheduler owns the
                # allocation's end, so it finalizes now
                self._teardown_alloc_job(job, now, JobStatus.CANCELLED,
                                         130)
                return True
            # the node plane owns the kill; the Cancelled status change
            # comes back through step_status_change.  The intent is on
            # the job and in the WAL, so neither a node death racing the
            # kill nor a crash resurrects the job
            for step in job.steps.values():
                if not step.status.is_terminal:
                    step.cancel_requested = True
            if self.wal is not None:
                self.wal.job_updated(job)
            self._cancel_kill_sent[job_id] = now
            self.dispatch_terminate(job_id, now)
            self._kick()   # kill-intent renewal runs on the cycle thread
            return True
        return False

    def dispatch_terminate(self, job_id: int, now: float,
                           incarnation: int | None = None,
                           skip_node: int | None = None) -> None:
        """Transport seam: kill the job's steps on its nodes (a
        simulated cluster delivers a Cancelled status change).
        ``incarnation`` guards the kill to that requeue_count;
        ``skip_node`` omits a node already declared dead."""

    def hold(self, job_id: int, held: bool, now: float) -> bool:
        job = self.pending.get(job_id)
        if job is None:
            return False
        job.held = held
        job.pending_reason = (PendingReason.HELD if held
                              else PendingReason.NONE)
        if self.wal is not None:
            self.wal.job_updated(job)
        self._table_refresh(job)
        return True

    def requeue(self, job_id: int, now: float) -> str:
        """Operator requeue: kill the running incarnation and return the
        job to pending.  Returns "" on success, else the refusal."""
        if job_id in self.pending:
            return "job is pending; nothing to requeue"
        job = self.running.get(job_id)
        if job is None:
            return "no such running job"
        if job.cancel_requested:
            return "cancel already requested"
        if job.status == JobStatus.SUSPENDED:
            return "job is suspended; resume it first"
        self.dispatch_terminate(job_id, now,
                                incarnation=job.requeue_count)
        self._release_job_resources(job)
        del self.running[job_id]
        self._cancel_kill_sent.pop(job_id, None)
        if self.jobtrace is not None:
            self.jobtrace.stamp(job_id, job.requeue_count, "requeue",
                                now)
        job.reset_for_requeue()
        if job.requeue_count > self.config.max_requeue_count:
            job.held = True
            job.pending_reason = PendingReason.HELD
        self.pending[job_id] = job
        self.events.emit("requeue", job_id=job_id, detail="operator",
                         time=now)
        if self.wal is not None:
            self.wal.job_requeued(job)
        return ""

    def modify_job(self, job_id: int, now: float, *,
                   time_limit: float | None = None,
                   priority: int | None = None,
                   partition: str | None = None) -> str:
        """Modify a job in place.  Returns "" on success, else the
        refusal.  A time limit applies to pending and running jobs (a
        running job's new deadline goes to its nodes through
        ``dispatch_change_time_limit``); priority and partition change
        pending jobs only."""
        job = self.pending.get(job_id) or self.running.get(job_id)
        if job is None:
            return f"job {job_id} not found or already terminal"
        running = job_id in self.running
        if running and (priority is not None or partition is not None):
            return "only the time limit of a running job can change"
        if time_limit is not None:
            if time_limit <= 0:
                return "time limit must be positive"
            if self.accounts is not None and job.qos_name:
                qos = self.accounts.qos.get(job.qos_name)
                if qos is not None and (
                        time_limit > qos.max_time_limit_per_job
                        or time_limit > qos.max_wall):
                    return ("time limit exceeds qos "
                            f"{job.qos_name} bound")
        if partition is not None:
            # full submit-time validation against the new partition
            part = self.meta.partitions.get(partition)
            if part is None:
                return f"partition {partition} not found"
            if not part.node_ids:
                return f"partition {partition} has no nodes"
            if not part.account_allowed(job.spec.account):
                return (f"account {job.spec.account} not allowed in "
                        f"partition {partition}")
            if job.spec.node_num > len(part.node_ids):
                return (f"gang of {job.spec.node_num} exceeds "
                        f"partition {partition} size")
            req = job.spec.res.encode(self.meta.layout)
            if job.spec.task_res is not None:
                req = req + (job.spec.task_res.encode(self.meta.layout)
                             * job.spec.ntasks_per_node_min)
            if not (req <= self.meta.partition_max_total(partition)
                    ).all():
                return (f"request exceeds every node in partition "
                        f"{partition}")
            if self.accounts is not None:
                _qos, err = self.accounts.resolve_submit(
                    job.spec.user, job.spec.account, partition,
                    job.spec.qos or None)
                if err:
                    return err
        if time_limit is not None:
            job.spec = dataclasses.replace(job.spec,
                                           time_limit=float(time_limit))
            if running:
                # the ledger's release row follows the new deadline
                self._ledger.set_end_time(
                    job_id, self._effective_end(job, now))
                self._limit_intents[job_id] = (float(time_limit), now)
                self.dispatch_change_time_limit(job_id, float(time_limit),
                                                now)
                self._kick()   # intent re-sends run on the cycle thread
        if priority is not None:
            job.qos_priority = int(priority)
        if partition is not None:
            job.spec = dataclasses.replace(job.spec, partition=partition)
            job.pending_reason = PendingReason.NONE
        if self.wal is not None:
            self.wal.job_updated(job)
        if not running:
            self._table_refresh(job)
        return ""

    def dispatch_change_time_limit(self, job_id: int, time_limit: float,
                                   now: float) -> None:
        """Transport seam: push the new deadline to the job's nodes.  The
        simulated plane re-reads spec.time_limit, so the base seam just
        confirms the intent."""
        self._limit_intents.pop(job_id, None)

    # ------------------------------------------------------------------
    # status changes
    # ------------------------------------------------------------------

    def step_status_change(self, job_id: int, status: JobStatus,
                           exit_code: int, now: float,
                           node_id: int = -1,
                           incarnation: int | None = None) -> None:
        """A status report from the node plane, queued for the next
        cycle's drain.  ``node_id >= 0`` is one node's report: the job is
        terminal once every allocated node reported (the first failure
        kills the rest), worst status winning.  ``node_id == -1`` is a
        whole-job report (the simulated plane, dispatch failures)."""
        queue_incarnation = incarnation
        if node_id >= 0:
            job = self.running.get(job_id)
            if job is None or node_id not in job.node_ids:
                return   # stale: a previous incarnation's node
            if (incarnation is not None
                    and incarnation != job.requeue_count):
                return
            ok = (JobStatus.COMPLETED, JobStatus.CANCELLED)
            is_failure = status not in ok
            had_failure = any(st not in ok
                              for st, _ in job.node_reports.values())
            job.node_reports[node_id] = (status, exit_code)
            if is_failure and not had_failure:
                # first failure: kill the remaining steps; their
                # Cancelled reports complete the set
                self.dispatch_terminate(job_id, now,
                                        incarnation=job.requeue_count)
            if not all(n in job.node_reports for n in job.node_ids):
                return
            reports = list(job.node_reports.values())
            agg_status, agg_code = JobStatus.COMPLETED, 0
            for st, code in reports:
                if st not in ok:
                    agg_status, agg_code = st, code
                    break
            else:
                cancelled = [st == JobStatus.CANCELLED for st, _ in reports]
                if all(cancelled):
                    agg_status, agg_code = JobStatus.CANCELLED, 130
                elif any(cancelled):
                    # our kill next to completions: a user cancel or the
                    # collateral of another node's failure
                    agg_status = (JobStatus.CANCELLED
                                  if job.cancel_requested
                                  else JobStatus.COMPLETED)
            status, exit_code = agg_status, agg_code
            queue_incarnation = job.requeue_count
        self._status_queue.append(
            StatusChange(job_id, status, exit_code, now,
                         incarnation=queue_incarnation))
        self._kick()   # Event.set is thread-safe (transport threads)

    def record_remote_spans(self, job_id: int, incarnation: int,
                            spans) -> int:
        """Merge node-side spans (craned_received / cgroup_ready /
        step_start, as dicts or objects with ``edge``, ``time``, ``seq``,
        ``node_id``, ``skew``) into the job's timeline.  Each keeps its
        original seq; stamp-once drops duplicates from retried reports.
        Returns the number of spans newly recorded."""
        if self.jobtrace is None:
            return 0
        n = 0
        for s in spans:
            edge = s["edge"] if isinstance(s, dict) else s.edge
            if isinstance(s, dict):
                t, seq = s["t"], s.get("seq")
                node_id = s.get("node_id", -1)
                skew = s.get("skew", 0.0)
            else:
                t, seq, node_id, skew = s.time, s.seq, s.node_id, s.skew
            if self.jobtrace.stamp(job_id, incarnation, edge, float(t),
                                   node_id=int(node_id),
                                   skew=float(skew), seq=int(seq)):
                n += 1
        return n

    def trace_seq(self, job_id: int, incarnation: int) -> int:
        """Next span seq for (job_id, incarnation): the base a node plane
        numbers its local spans after."""
        if self.jobtrace is None:
            return 0
        return self.jobtrace.next_seq(job_id, incarnation)

    def step_report_async(self, job_id: int, step_id: int,
                          status: StepStatus, exit_code: int, now: float,
                          incarnation: int | None = None) -> None:
        """Thread-safe step report enqueue (drained at the next
        ``process_status_changes``)."""
        self._step_report_queue.append(
            (job_id, step_id, status, exit_code, now, incarnation))
        self._kick()

    def process_status_changes(self) -> int:
        """Drain the queues (cycle step 1).  Returns #processed.  Every
        WAL event of one drain commits as one group: inside a cycle it
        nests into the cycle's group."""
        self._wal_begin()
        try:
            return self._process_status_changes()
        finally:
            self._wal_flush()

    def _process_status_changes(self) -> int:
        while self._step_report_queue:
            job_id, step_id, status, exit_code, now, incarnation = (
                self._step_report_queue.popleft())
            self.step_report(job_id, step_id, status, exit_code, now,
                             incarnation=incarnation)
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
            self._cancel_kill_sent.pop(ch.job_id, None)
            job.end_time = ch.time
            job.exit_code = ch.exit_code
            job.status = ch.status
            if self._should_requeue(job, ch):
                if self.jobtrace is not None:
                    self.jobtrace.stamp(job.job_id, job.requeue_count,
                                        "requeue", ch.time)
                job.reset_for_requeue()
                if job.requeue_count > self.config.max_requeue_count:
                    job.held = True
                    job.pending_reason = PendingReason.HELD
                self.pending[job.job_id] = job
                if self.wal is not None:
                    self.wal.job_requeued(job)
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
        self._kick()   # freed capacity: pending jobs may now place

    def _malloc_run_limits(self, job: Job) -> bool:
        """Schedule-time QoS limit check and usage take.  The take is
        recorded on the job so the free stays symmetric even if the QoS
        is deleted and re-created while the job runs."""
        job.run_usage_taken = False
        gu = self.global_usage
        if gu is not None and gu.check_run(job.spec.user,
                                           job.spec.account):
            # federation-wide MaxJobs: the job stays pending
            return False
        if self.account_meta is not None and job.qos_name:
            qos = self.accounts.qos.get(job.qos_name)
            if qos is not None:
                err = self.account_meta.check_and_malloc_run(
                    job.spec.user, job.spec.account, qos, job.spec)
                if err:
                    return False
                job.run_usage_taken = True
        if gu is not None:
            # hold the slot now: batch commits check every candidate
            # before any lands in the running dict, so later same-cycle
            # checks must see this admission (the dict hook converts
            # the reservation into the real count)
            gu.reserve_run(job.spec.user, job.spec.account)
            job.global_run_reserved = True
        return True

    def _free_run_limits(self, job: Job) -> None:
        if self.account_meta is not None and job.run_usage_taken:
            self.account_meta.free_run(job.spec.user, job.spec.account,
                                       job.qos_name, job.spec)
            job.run_usage_taken = False
        if self.global_usage is not None and job.global_run_reserved:
            self.global_usage.unreserve_run(job.spec.user,
                                            job.spec.account)
            job.global_run_reserved = False

    def _effective_end(self, job: Job, now: float) -> float:
        """Expected end with suspended time credited back."""
        start = job.start_time if job.start_time is not None else now
        suspended = job.suspended_total
        if job.suspend_time is not None:
            suspended += max(now - job.suspend_time, 0.0)
        return start + job.spec.time_limit + suspended

    def _ledger_add(self, job: Job, now: float) -> None:
        """Register one just-started (or re-adopted) job's allocation
        rows."""
        self._ledger.add(
            job.job_id, job.node_ids, self._job_alloc(job),
            self._effective_end(job, now),
            [self.meta.nodes[n].total[DIM_CPU] for n in job.node_ids])
        if job.status == JobStatus.SUSPENDED:
            self._ledger.suspend(job.job_id, now)

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
        """Full terminal processing: close the step records with the
        allocation, move the job to history (archive, WAL tombstone),
        fire its dependency events and the array-parent bookkeeping.
        Every path that ends a job outside the status drain uses this:
        dependency edges are event-driven, never polled."""
        for step in job.steps.values():
            if step.status.is_terminal:
                continue
            if step.step_id == 0 and not job.spec.alloc_only:
                step.status = StepStatus(job.status.value)
                step.exit_code = (job.exit_code
                                  if job.exit_code is not None else 0)
            else:
                step.status = StepStatus.CANCELLED
                step.exit_code = 130
            step.end_time = job.end_time
        if self.jobtrace is not None:
            t = (job.end_time if job.end_time is not None
                 else (job.start_time or job.submit_time))
            self.jobtrace.stamp(job.job_id, job.requeue_count, "end", t,
                                epoch=self.fencing_epoch)
        self._finalize(job)
        self._trigger_dep_event(job)
        if job.array_parent_id is not None:
            self._on_array_child_terminal(job)

    def _finalize(self, job: Job) -> None:
        self.stats["jobs_finished_total"] += 1
        # array children never took a submit slot (the template owns it)
        if (self.account_meta is not None and job.qos_name
                and job.array_parent_id is None):
            self.account_meta.free_submit(job.spec.user, job.spec.account,
                                          job.qos_name)
        if self.global_usage is not None and job.array_parent_id is None:
            self.global_usage.note_release_submit(job.spec.user,
                                                  job.spec.account)
        self.history[job.job_id] = job
        if self.archive is not None:
            # archive before the WAL tombstone: once both exist the job
            # survives compaction and restart in the durable store, and
            # RAM history becomes a bounded recency cache
            self.archive.append(job)
            while len(self.history) > self.HISTORY_CACHE_MAX:
                self.history.pop(next(iter(self.history)))
        if self.wal is not None:
            self.wal.job_finalized(job)
            # the periodic purge of finalized records is safe only with
            # a durable archive: without one the tombstones are the
            # whole history
            if self.archive is not None:
                self._finalized_since_compact += 1
                if self._finalized_since_compact >= 1000:
                    self._finalized_since_compact = 0
                    self.wal.compact()

    # ------------------------------------------------------------------
    # suspend / resume: suspended time is credited back to the limit
    # ------------------------------------------------------------------

    def suspend(self, job_id: int, now: float) -> bool:
        job = self.running.get(job_id)
        if job is None or job.status != JobStatus.RUNNING:
            return False
        job.status = JobStatus.SUSPENDED
        job.suspend_time = now
        self._ledger.suspend(job_id, now)
        if self.wal is not None:
            self.wal.job_updated(job)
        self.dispatch_suspend(job_id, now)
        return True

    def resume(self, job_id: int, now: float) -> bool:
        job = self.running.get(job_id)
        if job is None or job.status != JobStatus.SUSPENDED:
            return False
        job.suspended_total += max(now - (job.suspend_time or now), 0.0)
        job.suspend_time = None
        job.status = JobStatus.RUNNING
        self._ledger.resume(job_id, now)
        if self.wal is not None:
            self.wal.job_updated(job)
        self.dispatch_resume(job_id, now)
        return True

    def dispatch_suspend(self, job_id: int, now: float) -> None:
        """Transport seam: freeze the job's cgroups on its nodes."""

    def dispatch_resume(self, job_id: int, now: float) -> None:
        """Transport seam: thaw the job's cgroups."""

    # ------------------------------------------------------------------
    # steps within an allocation: a batch job carries an implicit step
    # 0; an ``alloc_only`` job holds the allocation while steps are
    # submitted, packed into its capacity, and complete on their own
    # ------------------------------------------------------------------

    def _init_steps(self, job: Job, now: float) -> None:
        """The allocation starts: a batch job materializes its implicit
        step 0 (the batch script); an alloc_only job starts empty."""
        spec = job.spec
        if spec.alloc_only:
            job.steps = {}
            job.next_step_id = 0
            return
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

    def submit_step(self, job_id: int, spec: StepSpec, now: float) -> int:
        """Add a step to a running allocation; returns its step_id (-1 =
        rejected).  It starts at once if its per-node share fits the
        allocation's free internal capacity, else waits PENDING until an
        earlier step ends."""
        job = self.running.get(job_id)
        if job is None or job.status != JobStatus.RUNNING:
            return -1
        if job.cancel_requested:
            return -1
        if spec.node_num > len(job.node_ids):
            return -1
        if spec.res is not None:
            req = spec.res.encode(self.meta.layout)
            # it must fit the allocation's per-node share at all
            if not all((req <= alloc).all()
                       for alloc in self._job_alloc(job)):
                return -1
        step_id = job.next_step_id
        job.next_step_id += 1
        job.steps[step_id] = Step(step_id=step_id, spec=spec,
                                  submit_time=now)
        self._try_start_steps(job, now)
        if self.wal is not None:
            self.wal.job_updated(job)
        return step_id

    def _step_req(self, step: Step) -> np.ndarray | None:
        """Per-node vector the step occupies; None = whole nodes."""
        if step.spec.res is None:
            return None
        return step.spec.res.encode(self.meta.layout)

    def _try_start_steps(self, job: Job, now: float) -> list[int]:
        """Start the pending steps (id order) that fit the allocation's
        free internal capacity.  A step with res=None takes whole nodes,
        so such steps serialize; sized steps pack.  Overlap steps start
        at once and hold no share."""
        started = []
        allocs = self._job_alloc(job)
        free = [a.astype(np.int64).copy() for a in allocs]
        whole_busy = [False] * len(job.node_ids)
        for st in job.steps.values():
            if st.status != StepStatus.RUNNING or st.spec.overlap:
                continue
            req = self._step_req(st)
            for n in st.node_ids:
                i = job.node_ids.index(n)
                if req is None:
                    whole_busy[i] = True
                else:
                    free[i] -= req
        for step_id in sorted(job.steps):
            step = job.steps[step_id]
            if step.status != StepStatus.PENDING:
                continue
            want = step.spec.node_num or len(job.node_ids)
            if step.spec.overlap:
                # an observation channel starts on the observed step's
                # nodes (or the allocation's prefix)
                nodes = None
                if step.spec.follow_step is not None:
                    tgt = job.steps.get(step.spec.follow_step)
                    if tgt is not None and not tgt.status.is_terminal:
                        if tgt.status != StepStatus.RUNNING:
                            continue   # wait for the target to place
                        nodes = list(tgt.node_ids)[:want]
                step.status = StepStatus.RUNNING
                step.start_time = now
                step.node_ids = nodes if nodes else job.node_ids[:want]
                started.append(step_id)
                self.dispatch_step(job, step)
                continue
            req = self._step_req(step)
            picked = []
            for i in range(len(job.node_ids)):
                if len(picked) == want:
                    break
                if whole_busy[i]:
                    continue
                if req is None:
                    if (free[i] == allocs[i]).all():
                        picked.append(i)
                elif (req <= free[i]).all():
                    picked.append(i)
            if len(picked) < want:
                continue
            step.status = StepStatus.RUNNING
            step.start_time = now
            step.node_ids = [job.node_ids[i] for i in picked]
            for i in picked:
                if req is None:
                    whole_busy[i] = True
                else:
                    free[i] -= req
            started.append(step_id)
            self.dispatch_step(job, step)
        return started

    def dispatch_step(self, job: Job, step: Step) -> None:
        """Transport seam: push the step to the allocation's nodes."""

    def dispatch_terminate_step(self, job_id: int, step_id: int,
                                now: float) -> None:
        """Transport seam: kill exactly one step."""

    def dispatch_free_alloc(self, job_id: int, now: float,
                            incarnation: int | None = None,
                            skip_node: int | None = None) -> None:
        """Transport seam: release the job's allocation on its nodes.
        Defaults to a plain terminate (the simulated plane has no
        allocation state to free)."""
        self.dispatch_terminate(job_id, now, incarnation=incarnation,
                                skip_node=skip_node)

    def cancel_step(self, job_id: int, step_id: int, now: float) -> bool:
        job = self.running.get(job_id)
        if job is None:
            return False
        step = job.steps.get(step_id)
        if step is None or step.status.is_terminal:
            return False
        step.cancel_requested = True
        if step.status == StepStatus.PENDING:
            step.status = StepStatus.CANCELLED
            step.end_time = now
            step.exit_code = 130
        else:
            self.dispatch_terminate_step(job_id, step_id, now)
            self._step_cancel_sent[(job_id, step_id)] = now
            self._kick()   # kill-intent renewal runs on the cycle thread
        if self.wal is not None:
            self.wal.job_updated(job)
        return True

    def _teardown_alloc_job(self, job: Job, now: float,
                            status: JobStatus, exit_code: int) -> None:
        """The end of an allocation (cancel, free, time limit): free it
        on the nodes, return the resources, finalize with the outcome.
        Live steps are closed by _finalize_terminal (CANCELLED, 130)."""
        self.dispatch_free_alloc(job.job_id, now,
                                 incarnation=job.requeue_count)
        self._release_job_resources(job)
        del self.running[job.job_id]
        self._cancel_kill_sent.pop(job.job_id, None)
        job.status = status
        job.end_time = now
        job.exit_code = exit_code
        self._finalize_terminal(job)

    def free_allocation(self, job_id: int, now: float) -> bool:
        """End an alloc_only job COMPLETED: kill its running steps and
        release its resources."""
        job = self.running.get(job_id)
        if job is None or not job.spec.alloc_only:
            return False
        self._teardown_alloc_job(job, now, JobStatus.COMPLETED, 0)
        return True

    def step_report(self, job_id: int, step_id: int, status: StepStatus,
                    exit_code: int, now: float, node_id: int = -1,
                    incarnation: int | None = None,
                    cpu_seconds: float = 0.0,
                    max_rss_bytes: int = 0) -> None:
        """A step's status report (per node, or whole-step from the
        simulated plane).  Steps aggregate per node like jobs; a
        terminal step frees its share and pulls the next pending step
        in.  Step 0 of a batch job closes the whole job through the
        job-level queue, keeping the requeue semantics."""
        job = self.running.get(job_id)
        if job is None:
            return
        if incarnation is not None and incarnation != job.requeue_count:
            return
        step = job.steps.get(step_id)
        if step is None or step.status.is_terminal:
            return

        def fold_usage():
            # accepted first-time reports only: cpu-seconds add up,
            # RSS keeps the peak, the job aggregates its steps
            if cpu_seconds or max_rss_bytes:
                step.cpu_seconds += cpu_seconds
                step.max_rss_bytes = max(step.max_rss_bytes,
                                         max_rss_bytes)
                job.cpu_seconds += cpu_seconds
                job.max_rss_bytes = max(job.max_rss_bytes, max_rss_bytes)

        if node_id >= 0:
            if node_id not in step.node_ids:
                return
            if node_id not in step.node_reports:
                fold_usage()
            ok = (StepStatus.COMPLETED, StepStatus.CANCELLED)
            is_failure = status not in ok
            had_failure = any(st not in ok
                              for st, _ in step.node_reports.values())
            step.node_reports[node_id] = (status, exit_code)
            if is_failure and not had_failure:
                self.dispatch_terminate_step(job_id, step_id, now)
            if not all(n in step.node_reports for n in step.node_ids):
                return
            status, exit_code = self._aggregate_step(step)
        else:
            fold_usage()
        step.status = status
        step.end_time = now
        step.exit_code = exit_code
        self._step_cancel_sent.pop((job_id, step_id), None)
        if self.wal is not None:
            self.wal.job_updated(job)
        if step_id == 0 and not job.spec.alloc_only:
            # the batch step is the job: feed the job-level machine and
            # wake the loop, which may be deep in an idle sleep
            self._status_queue.append(StatusChange(
                job_id, JobStatus(status.value), exit_code, now,
                incarnation=job.requeue_count))
            self._kick()
            return
        self._try_start_steps(job, now)

    @staticmethod
    def _aggregate_step(step: Step) -> tuple[StepStatus, int]:
        """Worst status wins over the step's node reports."""
        for st, code in step.node_reports.values():
            if st not in (StepStatus.COMPLETED, StepStatus.CANCELLED):
                return st, code
        reports = list(step.node_reports.values())
        if any(st == StepStatus.CANCELLED for st, _ in reports):
            if (all(st == StepStatus.CANCELLED for st, _ in reports)
                    or step.cancel_requested):
                return StepStatus.CANCELLED, 130
        return StepStatus.COMPLETED, 0

    def _check_alloc_timeouts(self, now: float) -> None:
        """alloc_only jobs have no batch supervisor enforcing their time
        limit: the cycle does."""
        for job_id in sorted(self._alloc_only):
            job = self.running.get(job_id)
            if job is None or job.status != JobStatus.RUNNING:
                continue
            if now >= self._effective_end(job, now):
                self._teardown_alloc_job(job, now,
                                         JobStatus.EXCEED_TIME_LIMIT, 124)

    # ------------------------------------------------------------------
    # node failure and kill intents
    # ------------------------------------------------------------------

    def on_craned_down(self, node_id: int, now: float) -> list[int]:
        """A node died: end its jobs; a system failure requeues up to
        ``max_requeue_count``, then holds."""
        node = self.meta.nodes.get(node_id)
        self.emit_node_event("node_down",
                             node.name if node else str(node_id),
                             now=now)
        victim_ids = self.meta.craned_down(node_id)
        for job_id in victim_ids:
            job = self.running.get(job_id)
            if job is None:
                continue
            # kill the gang's steps on the surviving nodes before the
            # resources are freed (incarnation-guarded, the dead node
            # skipped); an allocation is freed there too
            if len(job.node_ids) > 1:
                kill = (self.dispatch_free_alloc if job.spec.alloc_only
                        else self.dispatch_terminate)
                kill(job_id, now, incarnation=job.requeue_count,
                     skip_node=node_id)
            self._release_job_resources(job)
            del self.running[job_id]
            self._cancel_kill_sent.pop(job_id, None)
            if job.cancel_requested:
                # the kill can no longer be confirmed: honour the cancel
                job.status = JobStatus.CANCELLED
                job.end_time = now
                job.exit_code = 130
                self._finalize_terminal(job)
                continue
            job.reset_for_requeue()
            if job.requeue_count > self.config.max_requeue_count:
                job.held = True
                job.pending_reason = PendingReason.HELD
            self.pending[job_id] = job
            self.events.emit("requeue", job_id=job_id,
                             detail="node down", time=now)
            if self.wal is not None:
                self.wal.job_requeued(job)
        return victim_ids

    def _check_craned_timeouts(self, now: float) -> None:
        """Ping-miss failure detection: a node that expects pings and
        stopped sending them is declared dead."""
        for node in self.meta.nodes.values():
            if (node.alive and node.expect_pings
                    and now - node.last_ping > self.config.craned_timeout):
                self.on_craned_down(node.node_id, now)

    def _renew_cancel_intents(self, now: float) -> None:
        """Re-send the kill for running jobs (and steps) whose cancel is
        still unconfirmed, at most every ``CANCEL_RENEW_INTERVAL``: a
        kill that reaches a node before the launch is lost there.  Time
        limit pushes renew every cycle until confirmed."""
        for job_id, last in list(self._cancel_kill_sent.items()):
            job = self.running.get(job_id)
            if job is None or not job.cancel_requested:
                self._cancel_kill_sent.pop(job_id, None)
                continue
            if now - last < self.CANCEL_RENEW_INTERVAL:
                continue
            self._cancel_kill_sent[job_id] = now
            self.dispatch_terminate(job_id, now)
        for key, last in list(self._step_cancel_sent.items()):
            job_id, step_id = key
            job = self.running.get(job_id)
            step = job.steps.get(step_id) if job is not None else None
            if (step is None or step.status.is_terminal
                    or not step.cancel_requested):
                self._step_cancel_sent.pop(key, None)
                continue
            if now - last < self.CANCEL_RENEW_INTERVAL:
                continue
            self._step_cancel_sent[key] = now
            self.dispatch_terminate_step(job_id, step_id, now)
        for job_id, (limit, _last) in list(self._limit_intents.items()):
            job = self.running.get(job_id)
            if job is None or job.spec.time_limit != limit:
                self._limit_intents.pop(job_id, None)
                continue
            self.dispatch_change_time_limit(job_id, limit, now)

    # ------------------------------------------------------------------
    # job arrays: the template stays pending; the cycle materializes at
    # most one child per template, bounded by max_concurrent
    # ------------------------------------------------------------------

    def _materialize_array_children(self, now: float) -> None:
        for parent_id in sorted(self._array_templates):
            parent = self.pending.get(parent_id)
            if parent is None:
                continue
            if parent.spec.array is None or not parent.array_remaining:
                continue
            if parent.held:
                continue
            if self._deps_runnable(parent, now) is not None:
                continue
            limit = parent.spec.array.max_concurrent
            live = sum(1 for c in parent.array_children
                       if not (self.job_info(c) or parent).status
                       .is_terminal)
            if limit and live >= limit:
                continue
            task_id = parent.array_remaining.pop(0)
            child_spec = dataclasses.replace(
                parent.spec, array=None,
                name=f"{parent.spec.name}_{task_id}")
            child_id = self._next_job_id
            self._next_job_id += 1
            child = Job(job_id=child_id, spec=child_spec,
                        submit_time=parent.submit_time,
                        qos_name=parent.qos_name,
                        qos_priority=parent.qos_priority,
                        array_parent_id=parent.job_id,
                        array_task_id=task_id)
            parent.array_children.append(child_id)
            self.pending[child_id] = child
            if self.wal is not None:
                self.wal.job_submitted(child)
                self.wal.job_updated(parent)

    def _on_array_child_terminal(self, child: Job) -> None:
        """The template finishes once every task id materialized and
        reached a terminal state: COMPLETED if all completed, else
        FAILED."""
        parent = self.pending.get(child.array_parent_id)
        if parent is None:
            return
        if parent.array_remaining:
            return
        children = [self.job_info(c) for c in parent.array_children]
        if not all(c is not None and c.status.is_terminal
                   for c in children):
            return
        del self.pending[parent.job_id]
        parent.status = (
            JobStatus.COMPLETED
            if all(c.status == JobStatus.COMPLETED for c in children)
            else JobStatus.FAILED)
        parent.end_time = child.end_time
        self._finalize_terminal(parent)

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
        spec-identity re-checks).

        WAL group commit: every lock-held segment of the cycle runs
        inside one WAL group (one write and one fsync for its records),
        flushed before each yield, so no group stays open across a lock
        release.  The last yielded closure drains the dispatch ring, so
        no dispatch is issued before its job's start record is
        durable."""
        spans = self.cycle_spans
        spans.begin()
        wal = self.wal
        self._wal_cycle_base = ((wal.fsync_total, wal.groups_total,
                                 wal.bytes_total, wal.records_total)
                                if wal is not None else (0, 0, 0, 0))
        # introspection: per-cycle build attribution and the armed
        # profiler window's tick (cheap no-ops when idle)
        self._cycle_compile_base = introspect.total_compiles()
        self._cycle_launch_base = greedy_place.launches
        self.profiler_window.tick()
        self.flight.stamp("cycle_begin")
        self._wal_begin()
        try:
            started = yield from self._cycle_body(now)
            return started
        finally:
            # no WAL record may stay buffered across cycles, and a job
            # committed to RUNNING must still get its dispatch even if
            # the generator is closed early
            self._wal_flush()
            self._drain_dispatch_ring()
            self.flight.stamp("cycle_end")
            spans.end()

    def _wal_begin(self) -> None:
        if self.wal is not None:
            self.wal.begin_batch()

    def _wal_flush(self) -> None:
        if self.wal is not None:
            with self.cycle_spans.span("wal:flush"):
                self.wal.commit_batch()

    def _wal_cycle_io(self) -> dict:
        """The WAL's bytes and records written since the cycle began."""
        wal = self.wal
        if wal is None:
            return {"wal_bytes": 0, "wal_records": 0}
        _f, _g, base_bytes, base_records = self._wal_cycle_base
        return {"wal_bytes": wal.bytes_total - base_bytes,
                "wal_records": wal.records_total - base_records}

    def _queue_dispatch(self, job: Job, node_ids: list[int]) -> None:
        """Ring entries capture the incarnation, the fencing epoch and
        the current WAL seq (the durability watermark: the job's start
        record has seq <= it) at commit time."""
        self._dispatch_ring.append((job, list(node_ids),
                                    job.requeue_count, self.fencing_epoch,
                                    self.wal.seq
                                    if self.wal is not None else 0))

    def _drain_dispatch_ring(self) -> int:
        """Issue every queued dispatch in commit order.  Entries whose
        WAL watermark is not durable are dropped and counted in
        ``stats['dispatch_dropped']``: that happens only when the
        group's fsync failed, and pushing work whose start record never
        reached the disk would leave a ghost allocation after recovery
        requeues the job."""
        ring = self._dispatch_ring
        if not ring:
            return 0
        items = list(ring)
        ring.clear()
        if self.wal is not None:
            durable = self.wal.durable_seq
            kept = [it for it in items if it[4] <= durable]
            if len(kept) != len(items):
                self.stats["dispatch_dropped"] = (
                    self.stats.get("dispatch_dropped", 0)
                    + len(items) - len(kept))
            items = kept
            if not items:
                return 0
        trace = self.jobtrace
        if trace is not None:
            # past the durability filter: the WAL group holding each
            # job's start record is on disk.  "dispatched" is stamped as
            # the push is issued (a simulated node plane stamps its own
            # spans during the call below, which must come after these)
            t = self._cycle_now
            for job, _nodes, inc, epoch, _seq in items:
                trace.stamp(job.job_id, inc, "committed_durable", t,
                            epoch=epoch)
                trace.stamp(job.job_id, inc, "dispatched", t,
                            epoch=epoch)
        self.flight.stamp("dispatch", detail=str(len(items)))
        if self.dispatch_batch is not None:
            self.dispatch_batch(items)
        else:
            for job, node_ids, *_ in items:
                self.dispatch(job, node_ids)
        return len(items)

    def _dispatch_phase(self):
        """The cycle's final yielded closure: drain the dispatch ring."""
        def run():
            with self.cycle_spans.span("dispatch"):
                t0 = time.perf_counter()
                n = self._drain_dispatch_ring()
                return n, (time.perf_counter() - t0) * 1e3

        return run

    def _note_dispatch(self, result) -> None:
        _n, ms = result
        # the ring row was pushed before the drain: update it in place
        self._cur_trace["dispatch_ms"] = round(ms, 3)
        lc = self.stats.get("last_cycle")
        if isinstance(lc, dict):
            lc["dispatch_ms"] = round(ms, 3)
        _MET_PHASE.observe(ms / 1e3, phase="dispatch")

    def _cycle_body(self, now: float):
        span = self.cycle_spans.span
        t0 = time.perf_counter()
        self._cur_trace = {
            "now": now, "queue_depth": len(self.pending),
            "solver": "", "solve_ms": 0.0,
            "preempted": 0, "backfilled": 0, "num_streams": 1,
            **self.cycle_spans.fields(),
        }
        _MET_PENDING.set(len(self.pending))
        self._cycle_now = now
        with span("drain"):
            with span("status_drain"):
                self.process_status_changes()
            with span("lifecycle"):
                self._check_craned_timeouts(now)
                self._check_alloc_timeouts(now)
                self._drain_deferred_evictions(now)
                self._renew_cancel_intents(now)
                self.meta.purge_expired_reservations(now)
                self._materialize_array_children(now)
        t_prelude = time.perf_counter()
        self.flight.stamp("prelude")

        with span("candidates"):
            # no-op short-circuit: if no epoch moved since the last armed
            # zero-placement solve and no time edge passed, this cycle
            # would rebuild the identical inputs and place nothing
            fp = self._cycle_fingerprint()
            if (self.config.incremental and self._noop_fp is not None
                    and fp == self._noop_fp and now < self._noop_edge
                    and not self._dispatch_ring):
                return self._skip_cycle(t0, now, "fingerprint")
            self._cycle_fp0 = fp
            self._noop_fp = None
            self._cycle_usage_denied0 = (self.global_usage.denied
                                         if self.global_usage is not None
                                         else 0)

            self.stats["cycles"] += 1
            _MET_CYCLES.inc()
            candidates = self._pending_candidates(now)
            if self.jobtrace is not None and candidates:
                # first-sight "eligible" stamp per incarnation; the Job
                # attribute guard keeps repeat cycles at one attribute
                # probe per candidate
                fresh = []
                for job in candidates:
                    if getattr(job, "_trace_eligible", -1) != \
                            job.requeue_count:
                        job._trace_eligible = job.requeue_count
                        fresh.append((job.job_id, job.requeue_count))
                if fresh:
                    self.jobtrace.stamp_many("eligible", fresh, now)
            if not candidates:
                # an empty cycle does not enter the trace ring (an idle
                # cluster would flush every interesting trace out of it)
                self.stats["last_cycle_walltime"] = time.time()
                self.stats["last_cycle"] = {
                    "prelude_ms": round((t_prelude - t0) * 1e3, 3),
                    "pending": 0, "started": 0,
                    "running": len(self.running)}
                self._skip_trace = None
                self._arm_noop(now)
                return []
            limit = self.config.schedule_batch_size
            if len(candidates) > limit:
                for job in candidates[limit:]:
                    job.pending_reason = PendingReason.PRIORITY
                candidates = candidates[:limit]
                if self._cand_rows is not None:
                    self._cand_rows = self._cand_rows[:limit]

        with span("snapshot"):
            # snapshot + event capture window
            self.meta.start_logging()
            avail, total, alive = self.meta.snapshot()

        with span("priority"):
            t_sort = time.perf_counter()
            ordered = self._priority_sort(candidates, now)
        with span("batch"):
            t_batch = time.perf_counter()
            for job in ordered:
                # spec epoch for the lock-free solve window: _commit
                # voids the placement of a job whose spec object changed
                # mid-solve
                job._plan_spec = job.spec
            jobs_batch, max_nodes = self._build_batch(
                ordered, avail.shape[0], now)
            cost0 = self._ledger.cost0(now, total.shape[0])
            trace = self._cur_trace
            trace["priority_ms"] = (t_batch - t_sort) * 1e3
            trace["batch_ms"] = (time.perf_counter() - t_batch) * 1e3

            # a cycle holding a packed or exclusive job takes the packed
            # solve (immediate fit; such jobs get no backfill
            # reservation); a gang cycle under a topology the
            # best-fit-block solve, without backfill this cycle
            # (locality first for gangs)
            orows = self._ordered_rows
            vec = orows is not None and len(orows) == len(ordered)
            packed = (bool(self._ptable.packed[orows].any()) if vec
                      else any(self._is_packed(j.spec) for j in ordered))
            gang = stage = False
            if packed:
                state = make_cluster_state(avail, total, alive, cost0,
                                           device=self.device)
                pbatch = self._packed_batch(jobs_batch.dense(), ordered)
            else:
                topo = self._active_topology()
                if topo is not None:
                    self._update_topo_fragmentation(topo, avail, total,
                                                    alive)
                gang = topo is not None and (
                    bool((self._ptable.nnum[orows] > 1).any()) if vec
                    else any(j.spec.node_num > 1 for j in ordered))
                if gang:
                    state = make_cluster_state(avail, total, alive, cost0,
                                               device=self.device)
                    dense = jobs_batch.dense()
                    levels = topo.levels(self.device)

        if packed:
            placements = yield from self._unlocked(
                "packed",
                lambda: solve_packed(state, pbatch, max_nodes=max_nodes)[0])
            with span("commit"):
                started = self._commit(ordered, placements, now,
                                       tasks=placements.tasks)
            solver_name = "packed"
        elif gang:
            placements, _, info = yield from self._unlocked(
                "topo", lambda: solve_greedy_topo(state, dense, levels,
                                                  max_nodes=max_nodes))
            with span("commit"):
                self._note_topo(topo, ordered, info)
                started = self._commit(ordered, placements, now)
            solver_name = "topo"
        elif self.config.backfill and \
                len(ordered) > max(1, self.config.backfill_max_jobs):
            started = yield from self._split_backfill_phases(
                ordered, jobs_batch, avail, total, alive, cost0,
                max_nodes, now)
            solver_name = "backfill-split"
        elif self.config.backfill:
            with span("timed_state"):
                state = self._timed_state(now, avail, total, alive, cost0)
                tbatch = self._timed_batch(jobs_batch.dense())
            placements = yield from self._unlocked(
                "backfill", lambda: solve_backfill(
                    state, tbatch, edges=self._grid_edges,
                    max_nodes=max_nodes)[0])
            with span("commit"):
                started = self._commit(ordered, placements, now,
                                       placements.start_bucket)
            solver_name, stage = "backfill", True
        else:
            placements, solver_name = yield from self._unlocked(
                "immediate", lambda: self._immediate_solve(
                    avail, total, alive, cost0, jobs_batch, max_nodes,
                    resident_ok=True))
            with span("commit"):
                started = self._commit(ordered, placements, now)
            stage = True
        with span("preempt"):
            started += self._try_preemption(ordered, now)
        self._wal_flush()
        if stage:
            # double buffer: copy the rows this commit dirtied ahead of
            # the next cycle's resident patch
            with span("stage"):
                self._resident.stage()
        t_end = time.perf_counter()
        with span("record"):
            self._record_cycle_stats(t0, t_prelude, candidates, started,
                                     t_end, solver_name)
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
        span = self.cycle_spans.span
        bf_max = max(1, self.config.backfill_max_jobs)
        with span("timed_state"):
            head, tail = ordered[:bf_max], ordered[bf_max:]
            # dense rows for the head only; the tail stays factored for
            # the kernel, with the head's rows invalid so nothing places
            # twice
            head_batch = self._timed_batch(jobs_batch.dense(bf_max))
            rows = torch.arange(jobs_batch.num_jobs, device=self.device)
            tail_batch = jobs_batch.with_valid(jobs_batch.valid
                                               & (rows >= bf_max))
            state = self._timed_state(now, avail, total, alive, cost0)
        placements, tstate = yield from self._unlocked(
            "backfill", lambda: solve_backfill(
                state, head_batch, edges=self._grid_edges,
                max_nodes=max_nodes), part="head")
        with span("commit:head"):
            started = self._commit(head, placements, now,
                                   placements.start_bucket)
            # pass 2: the tail against the tightest bucket of the
            # horizon, with a fresh event window for its commit
            self.meta.start_logging()

        def tail_solve():
            # the min stays on the device and is never adopted as, or
            # patched into, the resident state
            min_avail = tstate.time_avail.amin(dim=1)
            return self._immediate_solve(min_avail, total, alive,
                                         tstate.cost, tail_batch,
                                         max_nodes, resident_ok=False)

        out, _ = yield from self._unlocked("immediate", tail_solve,
                                           part="tail")
        with span("commit:tail"):
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

    def _immediate_solve(self, avail, total, alive, cost0, jobs_batch,
                         max_nodes, resident_ok=False):
        """The immediate-fit solve through the configured ``solver``,
        returning ``(placements, label)``.  Every backend is
        bit-identical on placements:

        - ``"cuda"`` and ``"pallas"``: the greedy placement by the CUDA
          kernel (models/gpu_solver.py).  Class-disjoint batches run the
          S-stream decomposition, labeled ``cuda-stream`` with
          ``num_streams`` recorded; overlapping classes run the serial
          kernel, labeled ``cuda``;
        - ``"native"``: the C++ solver (utils/native.py), labeled
          ``native``; raises when the library cannot be built or cannot
          take the shape;
        - ``"auto"``: the C++ solver where it can, else the kernel;
        - ``"device"``: the plain ``solve_greedy`` on the scheduler's
          device, labeled ``device``.

        The kernel and the plain solve update the cluster state in place
        on the device; with ``resident_ok`` it is the cross-cycle
        resident state (dirty-row patch) instead of a fresh upload of
        ``avail`` (an array or a device tensor).  The C++ solver works on
        host copies and leaves the resident state alone.

        Under a topology the solve sees the node axis in block-major
        order (``Topology.perm``): its ascending-cost, lowest-id walk
        then clusters picks inside blocks.  The snapshot, the cost seed
        and the class masks with their host copies (from which the
        streams and the owned slots are planned) are permuted; the picks
        are mapped back to real node ids; the resident state, whose rows
        are real node ids, is dropped for the solve."""
        topo = self._active_topology()
        perm = None
        if topo is not None:
            perm = topo.perm_tensor(self.device).long()

            def permuted(x):
                return (x[perm] if isinstance(x, torch.Tensor)
                        else np.asarray(x)[topo.perm])

            avail, total, alive, cost0 = (permuted(x) for x in (
                avail, total, alive, cost0))
            node_class = jobs_batch.node_class_np
            jobs_batch = dataclasses.replace(
                jobs_batch, class_masks=jobs_batch.class_masks[:, perm],
                class_rows_np=jobs_batch.class_rows_np[:, topo.perm],
                node_class_np=(node_class[topo.perm]
                               if node_class is not None else None))
            self._resident.invalidate()
            resident_ok = False
        placements = None
        solver = self.config.solver
        if solver in ("auto", "native"):
            placements = self._solve_native(avail, total, alive, cost0,
                                            jobs_batch, max_nodes)
            if placements is not None:
                label = "native"
            elif solver == "native":
                raise RuntimeError("native solver unavailable")
        if placements is None and solver == "sharded":
            placements = self._solve_sharded(avail, total, alive, cost0,
                                             jobs_batch, max_nodes,
                                             resident_ok=resident_ok)
            label = "sharded"
        if placements is None:
            placements, label = self._solve_on_device(
                avail, total, alive, cost0, jobs_batch, max_nodes,
                resident_ok, plain=solver == "device")
        if perm is not None:
            nodes = placements.nodes
            real = torch.where(
                nodes >= 0, perm.to(torch.int32)[nodes.clamp(min=0).long()],
                -1).to(torch.int32)
            placements = Placements(placed=placements.placed, nodes=real,
                                    reason=placements.reason)
        return placements, label

    def _solve_on_device(self, avail, total, alive, cost0, jobs_batch,
                         max_nodes, resident_ok, plain):
        """The greedy kernel, or with ``plain`` the plain ``solve_greedy``,
        on the scheduler's device (see ``_immediate_solve``)."""
        cfg = self.config
        use_resident = resident_ok and self._resident.enabled
        if use_resident:
            state, _mode = self._resident.acquire(
                avail, total, alive, cost0,
                key=("device" if plain else "cuda", int(avail.shape[0]),
                     int(avail.shape[1]), self._mask_table.generation))
        else:
            state = make_cluster_state(avail, total, alive, cost0,
                                       device=self.device)
        b = jobs_batch
        plan = None
        if plain:
            placements, new_state = solve_greedy(state, b.dense(),
                                                 max_nodes=max_nodes)
        else:
            args = (b.req, b.node_num, b.time_limit, b.valid, b.job_class,
                    b.class_masks)
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
        if plain:
            return placements, "device"
        num_streams = plan[1] if plan is not None else 1
        self._cur_trace["num_streams"] = num_streams
        return placements, ("cuda-stream" if num_streams > 1 else "cuda")

    def _solve_sharded(self, avail, total, alive, cost0, jobs_batch,
                       max_nodes, resident_ok=False):
        """The node-axis-sharded solve (parallel/sharded.py) over the
        scheduler's mesh: every visible card on the card (one shard each),
        the scheduler's own device otherwise; ``_mesh`` may be set to any
        mesh, repeats allowed.  Bit-identical placements to
        ``solve_greedy``.

        The node axis is padded with permanently dead nodes to a multiple
        of the mesh size, and the class masks with ``False``: the pad
        rows are never eligible, so placements and the first N ledger
        rows are unaffected.  With ``resident_ok`` the padded state comes
        from the cross-cycle resident store, keyed by the padded shape
        and the mesh descriptor (processes x devices), so a node-count
        change or another mesh drops the state instead of patching it."""
        from cranesched_tpu_torch.parallel.sharded import (
            make_node_mesh,
            solve_greedy_sharded_classes,
        )

        if self._mesh is None:
            self._mesh = (make_node_mesh() if self.device.type == "cuda"
                          else make_node_mesh([self.device]))
        mesh = self._mesh
        d = len(mesh)
        # a single-process scheduler: 1 process x d devices
        mesh_desc = f"1x{d}"
        self._cur_trace["mesh"] = mesh_desc
        b = jobs_batch
        n = int(avail.shape[0])
        pad = (-n) % d
        class_masks, class_rows = b.class_masks, b.class_rows_np
        if pad:
            def padded(x, fill=0):
                if isinstance(x, torch.Tensor):
                    tail = torch.full((pad,) + tuple(x.shape[1:]), fill,
                                      dtype=x.dtype, device=x.device)
                    return torch.cat([x, tail])
                x = np.asarray(x)
                return np.concatenate(
                    [x, np.full((pad,) + x.shape[1:], fill, x.dtype)])

            avail, total, alive, cost0 = (padded(x) for x in (
                avail, total, alive, cost0))
            class_masks = torch.cat([class_masks, torch.zeros(
                (class_masks.shape[0], pad), dtype=torch.bool,
                device=class_masks.device)], dim=1)
            class_rows = np.concatenate([np.asarray(class_rows, bool),
                                         np.zeros((class_rows.shape[0], pad),
                                                  bool)], axis=1)
        use_resident = resident_ok and self._resident.enabled
        if use_resident:
            state, _mode = self._resident.acquire(
                avail, total, alive, cost0,
                key=("sharded", n + pad, int(total.shape[1]),
                     self._mask_table.generation, mesh_desc))
        else:
            state = make_cluster_state(avail, total, alive, cost0,
                                       device=self.device)
        placements, sharded = solve_greedy_sharded_classes(
            state, b.req, b.node_num, b.time_limit, b.valid, b.job_class,
            class_masks, mesh, max_nodes=max_nodes, class_rows=class_rows)
        if use_resident:
            self._resident.adopt(sharded.gather())
        dev = self.device
        return Placements(placed=placements.placed.to(dev),
                          nodes=placements.nodes.to(dev),
                          reason=placements.reason.to(dev))

    def _solve_native(self, avail, total, alive, cost0, jobs_batch,
                      max_nodes):
        """The C++ treap solver (utils/native.py; bit-identical to
        solve_greedy) on host copies of the inputs: Placements on the
        scheduler's device, or None when the library cannot be built or
        cannot take the shape.  Disjoint class rows go in as class ids
        (no [J, N] mask anywhere); overlapping ones as the host gather of
        the class rows."""
        from cranesched_tpu_torch.utils import native

        def hostify(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else x

        b = jobs_batch
        common = (hostify(avail), hostify(total),
                  np.asarray(hostify(alive)).astype(np.uint8),
                  hostify(cost0), hostify(b.req), hostify(b.node_num),
                  hostify(b.time_limit),
                  hostify(b.valid).astype(np.uint8))
        node_class = b.node_class_np
        if node_class is not None:
            out = native.solve_greedy_native(
                *common, max_nodes=max_nodes, job_part=b.job_class_np,
                node_part=node_class)
        else:
            out = native.solve_greedy_native(
                *common, max_nodes=max_nodes, mask=b.dense_mask_np())
        if out is None:
            return None
        dev = self.device
        return Placements(placed=torch.from_numpy(out[0]).to(dev),
                          nodes=torch.from_numpy(out[1]).to(dev),
                          reason=torch.from_numpy(out[2]).to(dev))

    def _unlocked(self, label: str, fn, part: str | None = None):
        """Yield a solve closure to run with the caller's lock released:
        the cycle's open WAL group is flushed first and a new one opened
        once the solve is back."""
        self._wal_flush()
        out = yield self._traced_solve(label, fn, part)
        self._wal_begin()
        return out

    def _traced_solve(self, label: str, fn, part: str | None = None):
        """Wrap a yielded solve closure: time it, settling the device
        work before the clock stops (otherwise the commit's read-back
        would absorb the kernel time), inside the cycle's
        ``solve:<label>[:<part>]`` span.  A split cycle's solves also
        record their own time as ``solve_<part>_ms``."""
        trace = self._cur_trace
        name = f"solve:{label}" + (f":{part}" if part else "")

        def run():
            t0 = time.perf_counter()
            # the cycle's prelude ends when the solve starts
            trace.setdefault("_prelude_end", t0)
            with self.cycle_spans.span(name):
                out = fn()
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
            ms = (time.perf_counter() - t0) * 1e3
            trace["solve_ms"] += ms
            if part is not None:
                trace[f"solve_{part}_ms"] = ms
            _MET_SOLVE.observe(ms / 1e3, backend=label)
            return out

        return run

    def _record_cycle_stats(self, t0, t_prelude, candidates, started,
                            t_end, solver: str) -> None:
        self.stats["jobs_started_total"] += len(started)
        _MET_STARTED.inc(len(started))
        self.flight.stamp("commit", detail=str(len(started)))
        trace = self._cur_trace
        total_ms = (t_end - t0) * 1e3
        drain_ms = (t_prelude - t0) * 1e3
        prelude_ms = (trace.pop("_prelude_end") - t0) * 1e3
        solve_ms = trace["solve_ms"]
        # everything after the prelude but the solve: the commit
        commit_ms = max(total_ms - prelude_ms - solve_ms, 0.0)
        res = self._resident
        mode = res.pop_cycle_mode()
        self.stats["last_cycle"] = {
            "solver": solver,
            "num_streams": trace["num_streams"],
            "prelude_ms": round(prelude_ms, 3),
            "priority_ms": round(trace["priority_ms"], 3),
            "batch_ms": round(trace["batch_ms"], 3),
            "solve_ms": round(solve_ms, 3),
            "commit_ms": round(commit_ms, 3),
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
        wal = self.wal
        base_fsync, base_groups, _b, _r = self._wal_cycle_base
        wal_fsyncs = wal.fsync_total - base_fsync if wal is not None else 0
        wal_groups = (wal.groups_total - base_groups
                      if wal is not None else 0)
        if wal is not None:
            self.stats["last_cycle"].update(wal_fsyncs=wal_fsyncs,
                                            wal_groups=wal_groups)
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
        trace.update(
            solver=solver,
            drain_ms=round(drain_ms, 3),
            prelude_ms=round(prelude_ms, 3),
            solve_ms=round(solve_ms, 3),
            commit_ms=round(commit_ms, 3),
            # updated in place once the ring drains (_note_dispatch)
            dispatch_ms=0.0,
            total_ms=round(total_ms, 3),
            lock_held_ms=round(prelude_ms + commit_ms, 3),
            wal_fsyncs=wal_fsyncs,
            wal_groups=wal_groups,
            **self._wal_cycle_io(),
            candidates=len(candidates),
            placed=len(started),
            dirty_jobs=self._ptable.last_dirty,
            dirty_nodes=self.meta.last_snapshot_dirty,
            # where the cycle ran, and greedy_place's launches in it
            device=self.device.type,
            kernel_launches=greedy_place.launches - self._cycle_launch_base,
        )
        if mode is not None:
            trace.update(resident=mode, h2d_rows=res.last_h2d_rows,
                         h2d_bytes=res.last_h2d_bytes,
                         patch_overlap=bool(res.last_overlap))
            _MET_H2D.inc(res.last_h2d_bytes, mode=mode)
            _MET_RESIDENT.inc(mode=mode)
            _MET_OVERLAP.set(res.overlap_share())
        # introspection plane: the builds this cycle paid (delta off the
        # process-wide counter) and the card's memory.  A warm cycle
        # that pays a build is surfaced as an event, not just a counter.
        recompiles = introspect.total_compiles() - self._cycle_compile_base
        mem = introspect.sample_device_memory()
        trace.update(recompiles=recompiles, device_bytes=mem["bytes"],
                     device_peak_bytes=mem["peak_bytes"],
                     device_buffers=mem["buffers"])
        if recompiles > 0 and self.stats["cycles"] >= self.WARMUP_CYCLES:
            self.events.emit(
                "recompile_steady", "warning",
                detail="cycle %d paid %d recompile(s)" % (
                    self.stats["cycles"], recompiles))
        self.cycle_trace.push(trace)
        self._skip_trace = None
        _MET_PHASE.observe(prelude_ms / 1e3, phase="prelude")
        _MET_PHASE.observe(solve_ms / 1e3, phase="solve")
        _MET_PHASE.observe(commit_ms / 1e3, phase="commit")
        _MET_LOCK.observe((prelude_ms + commit_ms) / 1e3)
        # a zero-placement solve with nothing preempted or in flight arms
        # the no-op fingerprint
        if (not started and trace.get("preempted", 0) == 0
                and not self._dispatch_ring):
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
        """Skip array templates, held jobs, jobs before their begin time,
        jobs whose dependencies are unmet and jobs whose licenses are
        short."""
        out = []
        for job in self.pending.values():  # id order == insertion order
            if job.spec.array is not None:
                continue  # templates never run; children materialize
            if job.held:
                job.pending_reason = PendingReason.HELD
                continue
            if job.spec.begin_time is not None and (
                    job.spec.begin_time > now):
                job.pending_reason = PendingReason.BEGIN_TIME
                continue
            dep_reason = self._deps_runnable(job, now)
            if dep_reason is not None:
                job.pending_reason = dep_reason
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

        extra_service = None
        if self.global_usage is not None:
            remote = self.global_usage.remote_account_jobs()
            if remote:
                # cluster-wide fair-share: remote running-job counts per
                # account feed the service sum (fed/usage.py); accounts
                # the gossip names but this shard has never seen get no
                # dense index yet — they have no local jobs to sort, so
                # their remote burn cannot change this shard's order
                es = np.zeros(num_accounts, np.float32)
                for acct, jobs in remote.items():
                    idx = self._account_index.get(acct)
                    if idx is not None and idx < num_accounts:
                        es[idx] = float(jobs)
                if es.any():
                    extra_service = torch.from_numpy(es).to(dev)
        pri_t = multifactor_priority(pending, running,
                                     self.config.priority_weights,
                                     num_accounts,
                                     extra_service=extra_service)
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
        spec = job.spec
        key = (spec.partition, tuple(spec.include_nodes),
               tuple(spec.exclude_nodes), len(self.meta.nodes),
               spec.reservation)
        mask = self._mask_cache.get(key)
        if mask is None:
            mask = self.meta.partition_mask(
                spec.partition, spec.include_nodes, spec.exclude_nodes)
            if spec.reservation:
                # a reservation's jobs run only inside its carve-out
                resv = self.meta.reservations.get(spec.reservation)
                rmask = np.zeros(len(self.meta.nodes), bool)
                if resv is not None:
                    rmask[list(resv.node_ids)] = True
                mask = mask & rmask
            self._mask_cache[key] = mask
        if spec.reservation:
            # outside the reservation's window the job places nowhere
            resv = self.meta.reservations.get(spec.reservation)
            if resv is None or not resv.active(now):
                return np.zeros(len(self.meta.nodes), bool)
            return mask
        # other jobs stay clear of any reservation whose window overlaps
        # the job's would-be runtime [now, now + limit]
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
        if spec.reservation:
            resv = self.meta.reservations.get(spec.reservation)
            return base + (resv is not None and resv.active(now),)
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
            class_rows_np=rows_np,
            node_class_np=self._mask_table.node_class())
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
        _MET_COMMIT_BATCH.observe(len(started_jobs))
        wal = self.wal
        trace = self.jobtrace
        for job in started_jobs:
            if wal is not None:
                wal.job_started(job)   # buffered into the cycle's group
            if trace is not None:
                trace.stamp(job.job_id, job.requeue_count, "placed",
                            now, epoch=self.fencing_epoch)
            self._trigger_dep_event(job)   # AFTER edges fire on start
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
        """Free-capacity fragmentation of the cycle snapshot: the gauge
        per level, the leaf level's in the trace (a free node is alive
        with its full capacity available)."""
        free = np.asarray(alive) & (np.asarray(avail)
                                    == np.asarray(total)).all(axis=1)
        frags = topo.fragmentation(free)
        for name, frag in frags:
            _MET_TOPO_FRAG.set(frag, level=name)
        self._cur_trace["topo_frag"] = frags[0][1]

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
        if n_cross:
            _MET_TOPO_CROSS.inc(n_cross)
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
        if self.wal is not None:
            self.wal.job_started(job)
        if self.jobtrace is not None:
            self.jobtrace.stamp(job.job_id, job.requeue_count, "placed",
                                now, epoch=self.fencing_epoch)
        self._trigger_dep_event(job)
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
        _MET_PREEMPTED.inc()
        self._cur_trace["preempted"] = (
            self._cur_trace.get("preempted", 0) + 1)
        self.stats["jobs_preempted_total"] = (
            self.stats.get("jobs_preempted_total", 0) + 1)
        self.events.emit("preemption", "warning", job_id=victim_id,
                         detail="mode=%s" % self.config.preempt_mode,
                         time=now)
        kill = (self.dispatch_free_alloc if victim.spec.alloc_only
                else self.dispatch_terminate)
        kill(victim_id, now, incarnation=victim.requeue_count)
        self._release_job_resources(victim)
        del self.running[victim_id]
        self._cancel_kill_sent.pop(victim_id, None)
        if victim.cancel_requested:
            # the user already cancelled it (kill in flight): honour the
            # cancel instead of requeueing it as preempted
            victim.status = JobStatus.CANCELLED
            victim.end_time = now
            victim.exit_code = 130
            self._finalize_terminal(victim)
            return
        if self.config.preempt_mode == "requeue":
            if self.jobtrace is not None:
                self.jobtrace.stamp(victim_id, victim.requeue_count,
                                    "requeue", now)
            victim.reset_for_requeue()
            victim.pending_reason = PendingReason.PREEMPTED
            if victim.requeue_count > self.config.max_requeue_count:
                victim.held = True
                victim.pending_reason = PendingReason.HELD
            self.pending[victim_id] = victim
            if self.wal is not None:
                self.wal.job_requeued(victim)
        else:  # cancel
            victim.status = JobStatus.CANCELLED
            victim.end_time = now
            victim.exit_code = 143
            self._finalize_terminal(victim)

    # ------------------------------------------------------------------
    # recovery: pending jobs re-queue, running and suspended jobs are
    # re-adopted with their resources re-applied to the ledger
    # ------------------------------------------------------------------

    def _readopt(self, job: Job, now: float) -> bool:
        """Take a replayed RUNNING or SUSPENDED job's allocation, license
        seats and QoS run usage again; False when its nodes no longer
        have room (a node vanished while the controller was down)."""
        if not self.meta.malloc_resource(job.job_id, job.node_ids,
                                         self._job_alloc(job)):
            return False
        if (job.status == JobStatus.RUNNING and not job.spec.alloc_only
                and 0 not in job.steps):
            # a record from before the step model: re-create the batch
            # step so the live supervisors' reports land
            self._init_steps(job, job.start_time or now)
        self.licenses.restore(job.spec.licenses or {})
        if self.account_meta is not None and job.qos_name:
            self.account_meta.restore_run(job.spec.user, job.spec.account,
                                          job.qos_name, job.spec)
            job.run_usage_taken = True
        self.running[job.job_id] = job
        self._ledger_add(job, now)
        return True

    def recover(self, replayed: dict, now: float = 0.0) -> None:
        """Rebuild the queues from a WAL replay
        (``WriteAheadLog.replay``).  Jobs are classified by their
        recorded status, so any durable mutation (cancel intent, hold)
        recovers too: terminal -> history; RUNNING -> re-adopted with
        its implicit step 0 and a re-sent kill for a cancel intent;
        SUSPENDED -> re-adopted, still holding its allocation; anything
        else -> pending.  A job whose nodes are gone requeues, unless it
        was being cancelled."""
        for job_id, (_event, job) in sorted(replayed.items()):
            self._next_job_id = max(self._next_job_id, job_id + 1)
            if not job.status.is_terminal and (
                    self.account_meta is not None and job.qos_name
                    and job.array_parent_id is None):
                self.account_meta.restore_submit(
                    job.spec.user, job.spec.account, job.qos_name)
            if not job.status.is_terminal and (
                    self.global_usage is not None
                    and job.array_parent_id is None):
                # restore without re-checking: the slot was legitimately
                # admitted before the crash (fed/usage.py note_submit)
                self.global_usage.note_submit(job.spec.user,
                                              job.spec.account)
            if job.status.is_terminal:
                self.history[job_id] = job
                if self.archive is not None and job_id not in self.archive:
                    # a crash between finalize and the archive write: the
                    # WAL tombstone still has the record
                    self.archive.append(job)
            elif job.status == JobStatus.RUNNING:
                if self._readopt(job, now):
                    if job.cancel_requested:
                        # the kill may have been lost with the crash:
                        # re-send it and keep renewing until confirmed
                        self._cancel_kill_sent[job_id] = now
                        self.dispatch_terminate(job_id, now)
                elif job.cancel_requested:
                    job.status = JobStatus.CANCELLED
                    job.end_time = now
                    self._finalize(job)  # frees the submit slot too
                else:
                    job.reset_for_requeue()
                    self.pending[job_id] = job
            elif job.status == JobStatus.SUSPENDED:
                if not self._readopt(job, now):
                    job.reset_for_requeue()
                    self.pending[job_id] = job
            else:
                job.status = JobStatus.PENDING
                self.pending[job_id] = job
        if self.jobtrace is not None:
            # seed timelines for every replayed job: synthetic spans
            # back-date the edges the WAL proves were passed (stamp-once
            # makes this a no-op for spans already held)
            for job_id, (_event, job) in sorted(replayed.items()):
                self.jobtrace.seed_recovered(job, now)
        # re-derive waiting edges against each dependee's current state
        # (events between the last record and the crash would otherwise
        # be lost), then rebuild the dependents map
        for job in self.pending.values():
            for dep in job.spec.dependencies:
                if job.dep_state.get(dep.job_id) is not None:
                    continue
                target = self.job_info(dep.job_id)
                if target is None:
                    job.dep_state[dep.job_id] = DEP_NEVER
                    continue
                sat = self._dep_satisfied_time(dep, target)
                job.dep_state[dep.job_id] = sat
                if sat is None:
                    self._dependents.setdefault(dep.job_id, set()).add(
                        job.job_id)
        # the rows written as jobs were inserted predate the dependency
        # re-derivation
        for job in self.pending.values():
            self._table_upsert(job)

    def rebuild_device_state(self) -> None:
        """Drop every device-side and incremental cache after
        ``recover``: the ``[C, N]`` class-row table, the per-job row and
        allocation caches, the dense mask cache, the PendingTable (built
        again from the pending jobs), the delta snapshot, the no-op
        fingerprint and the resident cluster state, so the first cycle
        pays one full rebuild."""
        self._mask_table = _MaskTable()
        self._mask_cache.clear()
        self._mask_cache_epoch = -1
        for col in (self.pending, self.running):
            for job in col.values():
                job.row_cache = None
                job.alloc_cache = None
        self._ptable = PendingTable(self.meta.layout.num_dims)
        for job in self.pending.values():
            self._table_upsert(job)
        self.meta._snap = None
        self._noop_fp = None
        self._cand_rows = None
        self._ordered_rows = None
        self._run_attrs = None
        self._mesh = None
        self._resident.invalidate()
