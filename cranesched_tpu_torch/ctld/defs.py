"""Job/step lifecycle types for the control plane.

Mirrors the capability surface of the reference's public defs (reference:
src/CraneCtld/CtldPublicDefs.h — JobInCtld :782, job status space
protos/PublicDefs.proto TaskStatus, pending-reason strings
docs/en/reference/pending_reason.md) without porting its object design:
jobs here are small frozen specs + a mutable runtime record, and every
resource quantity lives in the dense vector encoding of ops/resources.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Sequence

import numpy as np

from cranesched_tpu_torch.ops.resources import ResourceLayout


class JobStatus(enum.Enum):
    """Job lifecycle (reference PublicDefs.proto TaskStatus)."""

    PENDING = "Pending"
    RUNNING = "Running"
    SUSPENDED = "Suspended"         # frozen via cgroup freezer; keeps
                                    # its allocation
    COMPLETED = "Completed"         # exit code 0
    FAILED = "Failed"               # nonzero exit
    EXCEED_TIME_LIMIT = "ExceedTimeLimit"
    CANCELLED = "Cancelled"

    @property
    def is_terminal(self) -> bool:
        return self not in (JobStatus.PENDING, JobStatus.RUNNING,
                            JobStatus.SUSPENDED)

    @property
    def is_failed_kind(self) -> bool:
        """The 'not ok' terminal family for AFTER_NOT_OK dependencies."""
        return self in (JobStatus.FAILED, JobStatus.EXCEED_TIME_LIMIT,
                        JobStatus.CANCELLED)


class DepType(enum.Enum):
    """Job dependency types (reference PublicDefs.proto:136-152)."""

    AFTER = "after"              # satisfied when the dependee STARTS
    AFTER_ANY = "afterany"       # satisfied when it reaches ANY terminal
    AFTER_OK = "afterok"         # terminal Completed; else never
    AFTER_NOT_OK = "afternotok"  # terminal failed-kind; else never


@dataclasses.dataclass(frozen=True)
class Dependency:
    """One dependency edge with optional per-edge delay
    (reference Dependencies, PublicDefs.proto:136-152)."""

    job_id: int
    type: DepType = DepType.AFTER_OK
    delay_seconds: float = 0.0


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Job array shape (reference ArraySpec, PublicDefs.proto:154-159):
    task ids start..end step stride; at most max_concurrent children run
    at once (0 = unlimited — the %N suffix)."""

    start: int
    end: int
    stride: int = 1
    max_concurrent: int = 0

    def task_ids(self) -> list[int]:
        return list(range(self.start, self.end + 1, self.stride))


# dependency edge state sentinel: edge can never be satisfied
DEP_NEVER = float("inf")


class PendingReason(str, enum.Enum):
    """User-visible pending reasons (reference
    docs/en/reference/pending_reason.md; set throughout NodeSelect and the
    submit/cycle paths)."""

    NONE = ""
    RESOURCE = "Resource"
    CONSTRAINT = "Constraint"  # partition/nodelist rules nodes out
    PRIORITY = "Priority"      # cut off by the schedule batch limit, or
                               # resources free but a higher-priority
                               # reservation would be delayed
    HELD = "Held"
    BEGIN_TIME = "BeginTime"
    DEPENDENCY = "Dependency"
    DEPENDENCY_NEVER_SATISFIED = "DependencyNeverSatisfied"
    QOS_LIMIT = "QOSResourceLimit"
    LICENSE = "Licenses"
    PREEMPTED = "Preempted"
    INVALID = "InvalidSpec"


@dataclasses.dataclass(frozen=True)
class ResourceSpec:
    """Per-node resource request in human units; encoded once at submit."""

    cpu: float = 1.0
    mem_bytes: int = 0
    memsw_bytes: int = 0
    gres: Mapping[tuple[str, str], int] | None = None

    def encode(self, layout: ResourceLayout) -> np.ndarray:
        return layout.encode(cpu=self.cpu, mem_bytes=self.mem_bytes,
                             memsw_bytes=self.memsw_bytes, gres=self.gres)


class StepStatus(enum.Enum):
    """Step lifecycle (reference StepInCtld status machines,
    CtldPublicDefs.h:521-782): PENDING = accepted, waiting for room in
    the allocation; RUNNING = supervisors spawned; terminal mirrors the
    job status space."""

    PENDING = "Pending"
    RUNNING = "Running"
    COMPLETED = "Completed"
    FAILED = "Failed"
    EXCEED_TIME_LIMIT = "ExceedTimeLimit"
    CANCELLED = "Cancelled"

    @property
    def is_terminal(self) -> bool:
        return self not in (StepStatus.PENDING, StepStatus.RUNNING)


@dataclasses.dataclass(frozen=True)
class StepSpec:
    """One unit of execution inside a job allocation (reference
    StepInCtld / crun within calloc, CtldPublicDefs.h:521;
    AllocSteps dispatch JobScheduler.cpp:1793-1839).

    ``res`` is the per-node share of the ALLOCATION the step occupies
    while running; None = the whole allocation (steps then serialize).
    ``node_num`` = how many of the job's nodes the step spans (0 = all).
    ``time_limit`` 0 inherits the job's remaining time."""

    name: str = "step"
    script: str = ""
    res: ResourceSpec | None = None
    node_num: int = 0
    time_limit: int = 0
    output_path: str = ""
    # interactive I/O: the submitting client's embedded CraneFored
    # endpoint; the supervisor streams stdout/stderr there and accepts
    # stdin (reference CforedClient, CforedClient.h:28-95).  The token
    # is the per-submission stream secret the first chunk must present.
    interactive_address: str = ""
    pty: bool = False
    interactive_token: str = ""
    # container step: run the script inside this OCI image via the
    # node's runtime (reference ContainerInstance, TaskManager.h:353)
    container_image: str = ""
    container_mounts: Sequence[str] = ()
    # observation channel (cattach): starts immediately, holds no
    # share of the allocation (Slurm --overlap analog)
    overlap: bool = False
    # overlap placement: run on the nodes of this RUNNING step (the
    # cattach target); None = allocation prefix
    follow_step: int | None = None
    # X11 forwarding (crun --x11 inside an allocation)
    x11: bool = False
    x11_cookie: str = ""
    # simulation-only (real planes learn these from the supervisor)
    sim_runtime: float | None = None
    sim_exit_code: int = 0


@dataclasses.dataclass
class Step:
    """Runtime record of one step (reference CommonStepInCtld /
    DaemonStepInCtld, CtldPublicDefs.h:713-782)."""

    step_id: int
    spec: StepSpec
    submit_time: float
    status: StepStatus = StepStatus.PENDING
    start_time: float | None = None
    end_time: float | None = None
    exit_code: int | None = None
    node_ids: list[int] = dataclasses.field(default_factory=list)
    # per-node terminal reports, same aggregation rule as the job's
    node_reports: dict[int, tuple] = dataclasses.field(
        default_factory=dict)
    cancel_requested: bool = False
    # efficiency sample (ceff): summed over the step's nodes / peak
    cpu_seconds: float = 0.0
    max_rss_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """What a user submits (reference JobToCtld / cbatch flags)."""

    name: str = "job"
    user: str = "user"
    account: str = "default"
    partition: str = "default"
    res: ResourceSpec = dataclasses.field(default_factory=ResourceSpec)
    node_num: int = 1
    # task packing (reference min_res_view = node res + task res * ntasks,
    # JobScheduler.cpp:6152; get_max_tasks :6171): per-node requirement is
    # ``res`` plus ``task_res`` per task.  Defaults collapse to the simple
    # one-allocation-per-node shape.
    task_res: ResourceSpec | None = None
    ntasks: int | None = None         # total tasks; None = node_num
    ntasks_per_node_min: int = 1
    ntasks_per_node_max: int = 1
    exclusive: bool = False           # whole idle nodes only (cpp:6248)
    time_limit: int = 3600            # seconds
    qos: str = ""                     # QoS name (resolved via accounting;
                                      # account default when empty)
    qos_priority: int = 0             # direct priority when accounting is
                                      # not configured
    held: bool = False
    include_nodes: Sequence[str] = ()
    exclude_nodes: Sequence[str] = ()
    begin_time: float | None = None   # epoch seconds; None = now
    requeue_if_failed: bool = False
    # dependencies (4 types w/ per-edge delay; AND by default, OR when
    # deps_is_or — reference Dependencies.is_or)
    dependencies: Sequence[Dependency] = ()
    deps_is_or: bool = False
    # job arrays: this spec becomes a pending template; children
    # materialize one per cycle (reference ArrayManager, Array.h:124)
    array: ArraySpec | None = None
    # named reservation to run inside (reference ResvMeta)
    reservation: str = ""
    # consumable licenses: name -> count (reference LicenseManager)
    licenses: Mapping[str, int] | None = None
    # batch script (run as bash -c by the supervisor) and output path
    # pattern (%j substitutes the job id; reference batch meta)
    script: str = ""
    output_path: str = ""
    # calloc-style allocation: hold resources WITHOUT an implicit batch
    # step; steps are submitted separately (SubmitStep) and the job ends
    # on FreeAllocation / cancel / time limit (reference InteractiveMeta
    # + calloc semantics, CtldPublicDefs.h:282)
    alloc_only: bool = False
    # interactive batch (crun without an allocation): step 0 streams to
    # this client-side CraneFored endpoint instead of output files
    interactive_address: str = ""
    pty: bool = False
    interactive_token: str = ""
    # container job: the batch step runs inside this OCI image
    # (reference ContainerInstance/PodInstance, TaskManager.h:293-353;
    # ccon run).  Mounts are host:ctr[:ro] specs passed to the runtime.
    container_image: str = ""
    container_mounts: Sequence[str] = ()
    # X11 forwarding for the interactive step (reference
    # SetupX11forwarding_, CforedClient.h:29-66)
    x11: bool = False
    x11_cookie: str = ""
    # simulation-only: how long the job actually runs and its exit code
    # (real clusters learn these when the step exits)
    sim_runtime: float | None = None
    sim_exit_code: int = 0


@dataclasses.dataclass
class Job:
    """Runtime record the scheduler owns (reference JobInCtld,
    CtldPublicDefs.h:782 — submit/start/end times, status, craned_ids,
    pending reason, requeue count)."""

    job_id: int
    spec: JobSpec
    submit_time: float
    status: JobStatus = JobStatus.PENDING
    qos_name: str = ""                    # resolved QoS (accounting)
    qos_priority: int = 0                 # effective qos priority
    held: bool = False                    # runtime hold flag (mutable;
                                          # seeded from spec.held at submit)
    cancel_requested: bool = False        # persisted cancel intent: survives
                                          # races with node death (the kill
                                          # may never be confirmed)
    pending_reason: PendingReason = PendingReason.NONE
    start_time: float | None = None
    end_time: float | None = None
    exit_code: int | None = None
    node_ids: list[int] = dataclasses.field(default_factory=list)
    task_layout: list[int] = dataclasses.field(default_factory=list)
    # per-node terminal reports for multi-node jobs (real node plane):
    # the job is terminal once every allocated node reported
    node_reports: dict[int, tuple] = dataclasses.field(
        default_factory=dict)
    requeue_count: int = 0
    # efficiency accounting (ceff): summed cpu-seconds across all step
    # reports and the peak RSS any of them observed
    cpu_seconds: float = 0.0
    max_rss_bytes: int = 0
    # dependency edge state: dep job_id -> earliest satisfiable time, or
    # DEP_NEVER (event-driven, reference AddDependent /
    # TriggerTerminalDependencyEvents, CtldPublicDefs.cpp:1750-1775)
    dep_state: dict[int, float | None] = dataclasses.field(
        default_factory=dict)
    # array bookkeeping: children carry (parent, task id); the parent is
    # a template tracking materialization (reference ArrayMeta)
    array_parent_id: int | None = None
    array_task_id: int | None = None
    array_remaining: list[int] = dataclasses.field(default_factory=list)
    array_children: list[int] = dataclasses.field(default_factory=list)
    # suspend/resume: suspended wall time is credited back to the time
    # limit (reference JobScheduler.cpp:118-126)
    suspend_time: float | None = None
    suspended_total: float = 0.0
    # steps inside the allocation (reference job->steps;
    # batch jobs get an implicit step 0 at start, alloc_only jobs start
    # empty and accept SubmitStep).  next_step_id survives requeue resets
    # per the reference's step-id-counter-reset-on-requeue rule.
    steps: dict[int, "Step"] = dataclasses.field(default_factory=dict)
    next_step_id: int = 0
    # cached per-node allocation vectors for the current incarnation
    # (derived state — not persisted; cleared on requeue)
    alloc_cache: list | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # cached solver-batch row ``(spec, (encoded req, node_num,
    # time_limit))`` — modify_job REPLACES job.spec
    # (dataclasses.replace), so a plain identity check on the first
    # element invalidates exactly when the row could change (derived
    # state — not persisted)
    row_cache: tuple | None = dataclasses.field(
        default=None, repr=False, compare=False)
    # run-limit usage actually taken for this incarnation (keeps the
    # accounting free symmetric even if the QoS is deleted mid-run)
    run_usage_taken: bool = dataclasses.field(
        default=False, repr=False, compare=False)
    # global (federation-wide) run slot reserved at admission but not
    # yet converted by the running-dict hook — batch commits check the
    # whole set before any insert, so the gate must see earlier
    # same-cycle admissions through these reservations
    global_run_reserved: bool = dataclasses.field(
        default=False, repr=False, compare=False)
    priority: float = 0.0
    # topology placement record (topo/): the leaf block name when the
    # gang landed inside one block, "" otherwise; cross_block marks the
    # spanning fallback (exported as crane_topo_cross_block_gangs_total)
    topo_block: str = ""
    cross_block: bool = False

    def reset_for_requeue(self) -> None:
        """Return to pending after a failure/node-death (reference
        ResetForRequeue, JobScheduler.cpp:6950-6965)."""
        self.status = JobStatus.PENDING
        self.pending_reason = PendingReason.NONE
        self.start_time = None
        self.end_time = None
        self.exit_code = None
        self.node_ids = []
        self.task_layout = []
        self.node_reports = {}
        self.alloc_cache = None
        self.requeue_count += 1
        self.priority = 0.0
        # step-id counters reset on requeue (reference
        # PersistAndRequeueJobs_/ResetForRequeue, JobScheduler.cpp:
        # 6950-6965: "step-id counters reset")
        self.steps = {}
        self.next_step_id = 0
