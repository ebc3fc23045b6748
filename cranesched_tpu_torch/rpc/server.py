"""The ctld gRPC service (port of ``cranesched_tpu/rpc/server.py``; the
reference's CtldGrpcServer, hand-glued).

(reference: src/CraneCtld/RpcService/CtldGrpcServer.cpp — SubmitBatchJob
:691, SubmitBatchJobs :790, the ~60-RPC external surface of
protos/Crane.proto:1401-1683, and the CraneCtldForInternal craned-facing
service :1620.)

The scheduler is single-threaded by design; a coarse lock serializes all
RPC handlers onto it (the reference serializes through per-purpose
lock-free queues drained by its scheduler threads — same effect, more
machinery than a Python control plane needs).  The cycle thread holds the
lock only for the scheduler's state phases: every solve closure, and so
every launch on the card, runs with it released, on the cycle thread.
Handler threads launch nothing on the card; what they report of it
(``QueryStats``' device fields, the profiler window) is what the cycle
thread recorded.

Two clock modes:
* real time: a daemon thread runs the cycle every cycle_interval;
* virtual time (``tick_mode=True``): nothing runs until a ``Tick`` RPC
  supplies ``now`` — deterministic for tests, replays, and simulations.

This is the single controller.  The federation RPCs abort
``UNIMPLEMENTED`` naming ROADMAP.md A14, the HA replication RPCs naming
A13.  A real node plane passes ``dispatcher=`` (``rpc/dispatcher.py``):
``CranedRegister`` opens its push channel to the craned, and ``stop()``
closes it.
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent import futures

import grpc

from cranesched_tpu_torch.craned.sim import SimCluster, SimCraned
from cranesched_tpu_torch.ctld.defs import JobStatus, StepStatus
from cranesched_tpu_torch.ctld.scheduler import JobScheduler
from cranesched_tpu_torch.rpc import crane_pb2 as pb
from cranesched_tpu_torch.rpc.consts import SERVICE
from cranesched_tpu_torch.rpc.convert import (
    job_to_pb,
    spec_from_pb,
    step_spec_from_pb,
    step_to_pb,
)

#: RPCs of the JAX package's surface that the port refuses, with the
#: ROADMAP.md item that brings each
NOT_PORTED = {
    "QueryShardMap": "A14", "LeaseNodes": "A14", "ConfirmGang": "A14",
    "ReleaseLease": "A14", "FetchUsage": "A14", "MigratePartition": "A14",
    "HaStatus": "A13", "HaFetchSnapshot": "A13", "HaFetchWal": "A13",
}
_NOT_PORTED_WHAT = {"A14": "federation", "A13": "HA replication"}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not in the port yet (ROADMAP.md {item})")


def _node_state(node) -> str:
    if node.power_state == "POWEREDOFF":
        return "POWEREDOFF"
    if not node.alive:
        return "DOWN"
    if node.drained or node.health_drained:
        return "DRAIN"
    if (node.avail == node.total).all():
        return "IDLE"
    if (node.avail == 0).all():
        return "ALLOC"
    return "MIXED"


class CtldServer:
    """Wraps a JobScheduler (and optionally a simulated node plane)
    behind the CraneCtld service."""

    def __init__(self, scheduler: JobScheduler,
                 sim: SimCluster | None = None,
                 cycle_interval: float = 1.0, tick_mode: bool = False,
                 dispatcher=None, auth=None, tls=None,
                 metrics_port: int | None = None,
                 standby: bool = False):
        if standby:
            raise _not_ported("a hot standby (standby=True)", "A13")
        self.scheduler = scheduler
        self.sim = sim
        # real node plane: per-node push stubs (wired into the
        # scheduler's dispatch seam by the caller)
        self.dispatcher = dispatcher
        # AuthManager (ctld/auth.py) or None = open system (the
        # reference's equivalent seam is CheckCertAndUIDAllowed_ on
        # every external RPC, CtldGrpcServer.h:568)
        self.auth = auth
        # utils.pki.TlsConfig or None = plaintext (sims/tests); with
        # require_client_cert set, callers must present a cluster-CA
        # cert — the reference's internal mTLS domain
        # (CtldPublicDefs.h:133-143)
        self.tls = tls
        self.cycle_interval = cycle_interval
        self.tick_mode = tick_mode
        # Prometheus /metrics endpoint: None = off, 0 = ephemeral port
        # (tests); the bound port lands in self.metrics_port after
        # start()
        self.metrics_port = metrics_port
        self._metrics_server = None
        self._lock = threading.Lock()
        self._server: grpc.Server | None = None
        self._cycle_thread: threading.Thread | None = None
        self._stop = threading.Event()
        # event-driven cycle wakeup (the reference's
        # m_task_scheduler_thread_ condition variable): submits, status
        # changes, and node/reservation events set this so the loop
        # never sleeps through work, and an idle cluster can sleep past
        # the base tick (SchedulerConfig.cycle_idle_sleep)
        self._cycle_kick = threading.Event()
        scheduler.cycle_kick = self._cycle_kick.set

    # ---- authentication helpers ----

    def _ident(self, context) -> str | None:
        """Authenticated identity of the caller, or None.  With auth
        disabled returns the sentinel "" meaning 'trust the claim'."""
        if self.auth is None:
            return ""
        return self.auth.identity(context.invocation_metadata())

    def _deny_job_mutation(self, ident, job_id) -> str:
        """Owner-or-admin check for job mutations; returns the denial
        message or ''."""
        if self.auth is None:
            return ""
        if ident is None:
            return "authentication required"
        job = self.scheduler.job_info(job_id)
        if job is None:
            return ""  # fall through: handler reports no-such-job
        if not self.auth.may_act_on_job(ident, job):
            return f"permission denied (job belongs to {job.spec.user})"
        return ""

    def _require_authenticated(self, ident, context) -> None:
        """Read surface: any authenticated identity suffices, but an
        anonymous caller must not enumerate jobs/steps/topology
        (the information-disclosure half of the cert check).  Aborts
        the RPC — queries have no error field to carry a denial."""
        if self.auth is not None and ident is None:
            context.abort(grpc.StatusCode.UNAUTHENTICATED,
                          "authentication required")

    def _deny_admin(self, ident) -> str:
        if self.auth is None:
            return ""
        if ident is None:
            return "authentication required"
        if not self.auth.is_admin(ident):
            return "permission denied (admin required)"
        return ""

    def _deny_internal(self, ident, node_id: int | None = None,
                       node_name: str | None = None) -> str:
        """Craned-internal surface: a craned identity or an admin.

        A per-node token (identity ``@craned/<name>``, ADVICE r3) is
        additionally bound to the node it names: an RPC that claims a
        ``node_id``/name is denied when the token belongs to a different
        node, so one compromised craned cannot forge reports for the
        rest of the plane.  The shared ``@craned`` cluster secret (and
        admins) keep plane-wide access for sim/small deployments."""
        if self.auth is None:
            return ""
        from cranesched_tpu_torch.ctld.auth import craned_node_of
        bound = craned_node_of(ident)
        if bound is None:
            if self.auth.is_admin(ident):
                return ""
            return "craned authentication required"
        if bound == "*":
            return ""
        if node_name is None and node_id is not None:
            node = self.scheduler.meta.nodes.get(node_id)
            node_name = node.name if node is not None else None
        if node_name is None:
            # fail CLOSED: an unresolvable node claim (unknown id, or
            # the node_id=-1 whole-job report form only the sim plane
            # uses) would otherwise let a node-bound token act outside
            # its binding — exactly the impersonation it exists to stop
            return (f"token is bound to node {bound!r} but the request "
                    "names no resolvable node")
        if node_name != bound:
            return (f"token is bound to node {bound!r}, not "
                    f"{node_name!r}")
        return ""

    # ---- handlers (each is unary-unary; the lock serializes) ----

    def _check_submit_identity(self, ident, spec):
        """The submit-side uid check (reference: the cert identity must
        match the claimed uid): the spec's user must be the caller
        unless the caller is an admin."""
        if self.auth is None:
            return ""
        if ident is None:
            return "authentication required"
        if spec.user != ident and not self.auth.is_admin(ident):
            return (f"permission denied (authenticated as {ident}, "
                    f"spec claims {spec.user})")
        return ""

    def SubmitBatchJob(self, request, context):
        try:
            spec = spec_from_pb(request.spec)
        except ValueError as exc:
            return pb.SubmitJobReply(job_id=0, error=str(exc))
        deny = self._check_submit_identity(self._ident(context), spec)
        if deny:
            return pb.SubmitJobReply(job_id=0, error=deny)
        with self._lock:
            job_id = self.scheduler.submit(spec, now=self._now())
        return pb.SubmitJobReply(job_id=job_id,
                                 error="" if job_id else "rejected")

    def SubmitBatchJobs(self, request, context):
        now = self._now()
        ident = self._ident(context)
        replies: list = [None] * len(request.specs)
        local = []
        # parse + check OUTSIDE the lock
        for i, spec_pb in enumerate(request.specs):
            try:
                spec = spec_from_pb(spec_pb)
            except ValueError as exc:
                replies[i] = pb.SubmitJobReply(job_id=0, error=str(exc))
                continue
            deny = self._check_submit_identity(ident, spec)
            if deny:
                replies[i] = pb.SubmitJobReply(job_id=0, error=deny)
                continue
            local.append((i, spec))
        # chunked insert: batch submit is not atomic (every spec gets
        # its own reply), so release the lock between chunks — a
        # whole-batch hold kept readers waiting for the full insert
        # and set the query-plane p99.  Each chunk's WAL records commit
        # as one group (one fsync, before any reply goes out) where the
        # JAX server fsyncs each record: the same records in the same
        # order, acknowledged only once durable
        chunk = 32
        wal = self.scheduler.wal
        for start in range(0, len(local), chunk):
            with self._lock, (wal.group() if wal is not None
                              else contextlib.nullcontext()):
                for i, spec in local[start:start + chunk]:
                    job_id = self.scheduler.submit(spec, now=now)
                    replies[i] = pb.SubmitJobReply(
                        job_id=job_id,
                        error="" if job_id else "rejected")
        return pb.SubmitJobsReply(replies=replies)

    def CancelJob(self, request, context):
        with self._lock:
            deny = self._deny_job_mutation(self._ident(context),
                                           request.job_id)
            if deny:
                return pb.OkReply(ok=False, error=deny)
            ok = self.scheduler.cancel(request.job_id, now=self._now())
        return pb.OkReply(ok=ok, error="" if ok else "no such job")

    def HoldJob(self, request, context):
        with self._lock:
            deny = self._deny_job_mutation(self._ident(context),
                                           request.job_id)
            if deny:
                return pb.OkReply(ok=False, error=deny)
            ok = self.scheduler.hold(request.job_id, request.held,
                                     now=self._now())
        return pb.OkReply(ok=ok, error="" if ok else "not pending")

    def ModifyJob(self, request, context):
        """Job modification (reference ModifyJob, Crane.proto:1447).
        Owner-or-admin; two refinements mirroring the reference's
        operator gating: only an admin may RAISE a time limit (owners
        may lower their own), and priority changes are admin-only."""
        with self._lock:
            ident = self._ident(context)
            deny = self._deny_job_mutation(ident, request.job_id)
            if deny:
                return pb.OkReply(ok=False, error=deny)
            time_limit = (request.time_limit
                          if request.HasField("time_limit") else None)
            priority = (request.priority
                        if request.HasField("priority") else None)
            partition = (request.partition
                         if request.HasField("partition") else None)
            if self.auth is not None and not self.auth.is_admin(ident):
                if priority is not None:
                    return pb.OkReply(
                        ok=False,
                        error="permission denied (priority changes "
                              "require admin)")
                job = self.scheduler.job_info(request.job_id)
                if (time_limit is not None and job is not None
                        and time_limit > job.spec.time_limit):
                    return pb.OkReply(
                        ok=False,
                        error="permission denied (raising a time "
                              "limit requires admin)")
            err = self.scheduler.modify_job(
                request.job_id, now=self._now(), time_limit=time_limit,
                priority=priority, partition=partition)
        return pb.OkReply(ok=not err, error=err)

    def SuspendJob(self, request, context):
        with self._lock:
            deny = self._deny_job_mutation(self._ident(context),
                                           request.job_id)
            if deny:
                return pb.OkReply(ok=False, error=deny)
            ok = self.scheduler.suspend(request.job_id, now=self._now())
        return pb.OkReply(ok=ok, error="" if ok else "not running")

    def ResumeJob(self, request, context):
        with self._lock:
            deny = self._deny_job_mutation(self._ident(context),
                                           request.job_id)
            if deny:
                return pb.OkReply(ok=False, error=deny)
            ok = self.scheduler.resume(request.job_id, now=self._now())
        return pb.OkReply(ok=ok, error="" if ok else "not suspended")

    def SubmitStep(self, request, context):
        try:
            spec = step_spec_from_pb(request.spec)
        except ValueError as exc:
            return pb.SubmitStepReply(step_id=-1, error=str(exc))
        with self._lock:
            deny = self._deny_job_mutation(self._ident(context),
                                           request.job_id)
            if deny:
                return pb.SubmitStepReply(step_id=-1, error=deny)
            step_id = self.scheduler.submit_step(request.job_id, spec,
                                                 now=self._now())
        return pb.SubmitStepReply(
            step_id=step_id,
            error="" if step_id >= 0 else "rejected (no such running "
                                          "allocation or bad share)")

    def QueryStepsInfo(self, request, context):
        self._require_authenticated(self._ident(context), context)
        with self._lock:
            names = {i: n.name
                     for i, n in self.scheduler.meta.nodes.items()}
            job = self.scheduler.job_info(request.job_id)
            steps = (sorted(job.steps.values(), key=lambda s: s.step_id)
                     if job is not None else [])
            return pb.QueryStepsReply(
                steps=[step_to_pb(request.job_id, s, names)
                       for s in steps])

    def CancelStep(self, request, context):
        with self._lock:
            deny = self._deny_job_mutation(self._ident(context),
                                           request.job_id)
            if deny:
                return pb.OkReply(ok=False, error=deny)
            ok = self.scheduler.cancel_step(
                request.job_id, request.step_id, now=self._now())
        return pb.OkReply(ok=ok, error="" if ok else "no such live step")

    def FreeAllocation(self, request, context):
        with self._lock:
            deny = self._deny_job_mutation(self._ident(context),
                                           request.job_id)
            if deny:
                return pb.OkReply(ok=False, error=deny)
            ok = self.scheduler.free_allocation(request.job_id,
                                                now=self._now())
        return pb.OkReply(ok=ok,
                          error="" if ok else "not a running allocation")

    # default page size for cursor reads that don't set a limit — also
    # the bare-read archive cap
    DEFAULT_PAGE = 10_000

    def _job_snapshot(self, request) -> tuple[list, dict]:
        """Filtered job list + node-name map, under the lock.  Returns
        refs (cheap); pb conversion happens in bounded chunks so large
        queues never pin the scheduler for the whole result set."""
        if request.after_job_id and not request.limit:
            # a cursor without a limit gets the default page size — so
            # the handlers' truncation math (limit-based) marks the
            # reply truncated instead of silently dropping the tail
            request.limit = self.DEFAULT_PAGE
        names = {i: n.name
                 for i, n in self.scheduler.meta.nodes.items()}
        jobs = list(self.scheduler.queue())
        if request.include_history:
            jobs += list(self.scheduler.history.values())
            if self.scheduler.archive is not None:
                # durable rows not in RAM (pre-restart /
                # post-compaction history); RAM wins on overlap.
                # Capped: a bare cacct on a long-lived cluster must
                # not deserialize the whole archive under the
                # server lock (newest rows are returned first)
                seen = {j.job_id for j in jobs}
                # a paginated read (after_job_id set) pages the archive
                # by keyset so every archived row is reachable; the
                # bare read keeps the newest-10k cap
                # paginated reads (limit set) page the archive by
                # keyset from the cursor (0 = start) so every row is
                # reachable; +1 row lets the truncated flag tell a
                # full final page from a continued one.  Bare reads
                # keep the newest-10k cap.
                paged = bool(request.limit or request.after_job_id)
                # cursor reads always carry a limit here (normalized
                # above): limit+1 rows let the truncated flag tell a
                # full final page from a continued one
                jobs += [j for j in self.scheduler.archive.query(
                             job_ids=list(request.job_ids),
                             user=request.user,
                             partition=request.partition,
                             limit=(request.limit + 1 if paged
                                    else self.DEFAULT_PAGE),
                             after_job_id=request.after_job_id,
                             keyset=paged)
                         if j.job_id not in seen]
        if request.job_ids:
            wanted = set(request.job_ids)
            jobs = [j for j in jobs if j.job_id in wanted]
        if request.user:
            jobs = [j for j in jobs if j.spec.user == request.user]
        if request.partition:
            jobs = [j for j in jobs
                    if j.spec.partition == request.partition]
        if request.after_job_id:
            # keyset pagination: results ascend by job id, so resume
            # strictly after the cursor
            jobs = [j for j in jobs if j.job_id > request.after_job_id]
        jobs.sort(key=lambda j: j.job_id)
        return jobs, names

    # conversion batch: bounds both the message size of one streamed
    # chunk and the lock hold per chunk
    QUERY_CHUNK = 1000

    def _durable_seq(self) -> int:
        """The durability watermark the answers reflect: the WAL's
        fsync'd seq."""
        wal = self.scheduler.wal
        return wal.durable_seq if wal is not None else 0

    def QueryJobsInfo(self, request, context):
        self._require_authenticated(self._ident(context), context)
        limit = request.limit or 0
        with self._lock:
            jobs, names = self._job_snapshot(request)
            truncated = bool(limit) and len(jobs) > limit
            if truncated:
                jobs = jobs[:limit]
            return pb.QueryJobsReply(
                jobs=[job_to_pb(j, names) for j in jobs],
                truncated=truncated,
                durable_seq=self._durable_seq())

    def QueryJobsStream(self, request, context):
        """Server-streaming query (reference Crane.proto:1576-1590):
        chunks of QUERY_CHUNK jobs, converted under short lock holds —
        a 100k-job cqueue neither builds one giant message nor stalls
        the scheduling cycle for its whole duration."""
        self._require_authenticated(self._ident(context), context)
        with self._lock:
            jobs, names = self._job_snapshot(request)
        remaining = request.limit or len(jobs)
        end = min(len(jobs), remaining)
        truncated = len(jobs) > remaining
        for lo in range(0, end, self.QUERY_CHUNK):
            hi = min(lo + self.QUERY_CHUNK, end)
            batch = jobs[lo:hi]
            # re-take the lock per chunk: Job objects are mutable and
            # the cycle runs between chunks
            with self._lock:
                chunk = [job_to_pb(j, names) for j in batch]
            yield pb.QueryJobsReply(jobs=chunk,
                                    truncated=truncated and hi == end)

    def QueryClusterInfo(self, request, context):
        self._require_authenticated(self._ident(context), context)
        from cranesched_tpu_torch.ops.resources import (
            CPU_SCALE, DIM_CPU, DIM_MEM, MEM_UNIT_BYTES)
        with self._lock:
            out = []
            for node in self.scheduler.meta.nodes.values():
                out.append(pb.NodeInfo(
                    name=node.name,
                    state=_node_state(node),
                    cpu_total=float(node.total[DIM_CPU]) / CPU_SCALE,
                    cpu_avail=float(node.avail[DIM_CPU]) / CPU_SCALE,
                    mem_total=int(node.total[DIM_MEM]) * MEM_UNIT_BYTES,
                    mem_avail=int(node.avail[DIM_MEM]) * MEM_UNIT_BYTES,
                    partitions=sorted(node.partitions),
                    running_jobs=len(node.running_jobs)))
            return pb.QueryClusterReply(
                nodes=out, durable_seq=self._durable_seq())

    def CreateReservation(self, request, context):
        deny = self._deny_admin(self._ident(context))
        if deny:
            return pb.OkReply(ok=False, error=deny)
        with self._lock:
            resv = self.scheduler.meta.create_reservation(
                request.name, request.partition,
                list(request.node_names), request.start_time,
                request.end_time,
                allowed_accounts=(list(request.allowed_accounts)
                                  if request.allowed_accounts else None),
                denied_accounts=list(request.denied_accounts))
        if resv is not None:
            self._cycle_kick.set()
        return pb.OkReply(ok=resv is not None,
                          error="" if resv else "conflict")

    def DeleteReservation(self, request, context):
        deny = self._deny_admin(self._ident(context))
        if deny:
            return pb.OkReply(ok=False, error=deny)
        with self._lock:
            ok = self.scheduler.meta.delete_reservation(request.name)
        if ok:
            self._cycle_kick.set()
        return pb.OkReply(ok=ok, error="" if ok else "no such reservation")

    def ModifyNode(self, request, context):
        """Node control ops (reference control states
        PublicDefs.proto:98-106 + PowerStateChange,
        CtldGrpcServer.cpp:2583-2649)."""
        deny = self._deny_admin(self._ident(context))
        if deny:
            return pb.OkReply(ok=False, error=deny)
        with self._lock:
            meta = self.scheduler.meta
            if request.name not in meta._name_to_id:
                return pb.OkReply(ok=False, error="unknown node")
            node = meta.node_by_name(request.name)
            action = request.action.lower()
            if action == "drain":
                meta.drain(node.node_id, True)
                self.scheduler.emit_node_event("drain", node.name,
                                               "operator",
                                               now=self._now())
            elif action == "resume":
                meta.drain(node.node_id, False)
                # the operator's resume is the recovery path for hook-
                # failure drains too (they ride the health flag and
                # nothing else would ever clear them without a
                # configured health program)
                node.health_drained = False
                node.health_message = ""
                self.scheduler.emit_node_event("undrain", node.name,
                                               "operator",
                                               now=self._now())
            elif action == "poweroff":
                node.power_state = "POWEREDOFF"
                self.scheduler.emit_node_event("poweroff", node.name,
                                               now=self._now())
                self.scheduler.on_craned_down(node.node_id, self._now())
            elif action == "wake":
                node.power_state = "ACTIVE"
                self.scheduler.emit_node_event("wake", node.name,
                                               now=self._now())
                if not node.expect_pings:
                    node.alive = True  # sim nodes wake immediately;
                                       # real ones wake at re-register
            else:
                return pb.OkReply(ok=False,
                                  error=f"unknown action {action!r}")
            self._cycle_kick.set()
            return pb.OkReply(ok=True)

    def QueryStats(self, request, context):
        self._require_authenticated(self._ident(context), context)
        import json as _json

        from cranesched_tpu_torch.obs import REGISTRY
        with self._lock:
            doc = dict(self.scheduler.stats)
            doc["licenses"] = {
                name: {"total": lic.total, "in_use": lic.in_use,
                       "external_used": lic.external_used,
                       "free": lic.free, "remote": lic.remote}
                for name, lic in
                self.scheduler.licenses.licenses.items()}
            # obs layer: full metric snapshot + the cycle-trace ring +
            # liveness, so `cstats --metrics/--cycles` needs no extra
            # RPC and can flag "scheduler stalled" client-side
            doc["metrics"] = REGISTRY.snapshot()
            doc["cycle_trace"] = self.scheduler.cycle_trace.snapshot()
            # per-job tracing + SLO plane (cstats --slo): evaluating on
            # query refreshes the burn-rate gauges, so /metrics scraped
            # right after a cstats --slo shows the same numbers
            if self.scheduler.jobtrace is not None:
                doc["jobtrace"] = self.scheduler.jobtrace.stats()
            if self.scheduler.slo_engine is not None:
                doc["slo"] = self.scheduler.slo_engine.evaluate(
                    time.time())
            topo = getattr(self.scheduler.meta, "topology", None)
            if topo is not None:
                from cranesched_tpu_torch.topo.model import topology_doc
                avail_np, total_np, alive_np = \
                    self.scheduler.meta.snapshot()
                free = alive_np & (avail_np == total_np).all(axis=1)
                doc["topology"] = topology_doc(topo, free)
            # stall forensics (cflight): recent phase ring + the last
            # sentry-captured stall with its all-thread stacks
            doc["flight"] = self.scheduler.flight.report()
            doc["watchdog"] = {
                "now": time.time(),
                "cycle_interval": self.cycle_interval,
                "idle_sleep": float(getattr(
                    self.scheduler.config, "cycle_idle_sleep", 0.0)),
                "tick_mode": self.tick_mode,
                "last_cycle_walltime":
                    self.scheduler.stats.get("last_cycle_walltime", 0.0),
                "cycle_crashes_total":
                    self.scheduler.stats.get("cycle_crashes_total", 0),
                "last_crash": self.scheduler.stats.get("last_crash"),
            }
            wal = self.scheduler.wal
            doc["ha"] = {
                "role": "leader",
                "fencing_epoch": self.scheduler.fencing_epoch,
                "wal_seq": wal.durable_seq if wal is not None else 0,
                "replication_lag": 0,
                "failovers_total": 0,
                "peer": "",
            }
            return pb.StatsReply(json=_json.dumps(doc),
                                 durable_seq=self._durable_seq())

    def AcctMgr(self, request, context):
        """Accounting CRUD (reference cacctmgr -> AccountManager RPC
        surface, AccountManager.h:33-445): one multiplexed action with a
        JSON payload; RBAC enforced by the manager via ``actor``."""
        import json as _json
        from cranesched_tpu_torch.ctld.accounting import (
            Account, AccountingError, AdminLevel, Qos, User)
        mgr = self.scheduler.accounts
        if mgr is None:
            return pb.AcctMgrReply(ok=False,
                                   error="accounting is not enabled")
        try:
            args = _json.loads(request.payload) if request.payload \
                else {}
        except _json.JSONDecodeError as exc:
            return pb.AcctMgrReply(ok=False, error=f"bad payload: {exc}")
        if self.auth is not None:
            # the actor is the AUTHENTICATED identity — never a request
            # field (round-2 advisor: any client could claim
            # actor="root" over the insecure port)
            ident = self._ident(context)
            if ident is None:
                return pb.AcctMgrReply(ok=False,
                                       error="authentication required")
            actor = ident
        else:
            actor = request.actor
        try:
            with self._lock:
                action = request.action
                if action == "add_qos":
                    preempt = set(args.pop("preempt", []))
                    mgr.add_qos(actor, Qos(preempt=preempt, **args))
                elif action == "add_account":
                    allowed_qos = set(args.pop("allowed_qos", []))
                    mgr.add_account(actor, Account(
                        allowed_qos=allowed_qos, **args))
                elif action == "add_user":
                    account = args.pop("account")
                    mgr.add_user(actor, User(**args), account)
                elif action == "block_user":
                    mgr.block_user(actor, args["name"], args["account"],
                                   args.get("blocked", True))
                elif action == "block_account":
                    mgr.block_account(actor, args["name"],
                                      args.get("blocked", True))
                elif action == "set_admin_level":
                    mgr.set_admin_level(actor, args["name"],
                                        AdminLevel[args["level"].upper()])
                elif action == "show":
                    doc = {
                        "accounts": {
                            name: {"parent": a.parent,
                                   "users": sorted(a.users),
                                   "allowed_qos": sorted(a.allowed_qos),
                                   "default_qos": a.default_qos,
                                   "blocked": a.blocked}
                            for name, a in mgr.accounts.items()},
                        "users": {
                            name: {"accounts": sorted(u.accounts),
                                   "admin_level": u.admin_level.name}
                            for name, u in mgr.users.items()},
                        "qos": {
                            name: {"priority": q.priority,
                                   "preempt": sorted(q.preempt)}
                            for name, q in mgr.qos.items()},
                    }
                    return pb.AcctMgrReply(ok=True,
                                           json=_json.dumps(doc))
                else:
                    return pb.AcctMgrReply(
                        ok=False, error=f"unknown action {action!r}")
            return pb.AcctMgrReply(ok=True)
        except AccountingError as exc:
            return pb.AcctMgrReply(ok=False, error=str(exc))
        except Exception as exc:  # malformed payloads of any shape come
            # back as a legible reply, never a raw gRPC error
            return pb.AcctMgrReply(
                ok=False, error=f"bad payload for {request.action}: "
                                f"{type(exc).__name__}: {exc}")

    def CranedHealth(self, request, context):
        """Health-check report (reference HealthCheck config,
        Craned.cpp:731-751): unhealthy nodes drain until they report
        healthy again."""
        deny = self._deny_internal(self._ident(context),
                                   node_id=request.node_id)
        if deny:
            return pb.OkReply(ok=False, error=deny)
        with self._lock:
            node = self.scheduler.meta.nodes.get(request.node_id)
            if node is None:
                return pb.OkReply(ok=False, error="unknown node")
            was_drained = node.health_drained
            node.health_message = request.message
            node.health_drained = not request.healthy
            if not request.healthy:
                from cranesched_tpu_torch.ctld.meta import ResReduceEvent
                self.scheduler.meta._log_event(
                    ResReduceEvent(node.node_id))
            if was_drained != node.health_drained:
                self.scheduler.emit_node_event(
                    "drain" if node.health_drained else "undrain",
                    node.name, f"health: {request.message}",
                    now=self._now())
                self._cycle_kick.set()
            return pb.OkReply(ok=True)

    def IssueToken(self, request, context):
        """Admin-only token issuance (the SignUserCertificate analog)."""
        if self.auth is None:
            return pb.TokenReply(ok=False,
                                 error="authentication is not enabled")
        token = self.auth.issue(self._ident(context), request.user)
        if token is None:
            return pb.TokenReply(ok=False,
                                 error="permission denied "
                                       "(admin required)")
        return pb.TokenReply(ok=True, token=token)

    def RevokeToken(self, request, context):
        if self.auth is None:
            return pb.OkReply(ok=False,
                              error="authentication is not enabled")
        n = self.auth.revoke(self._ident(context), request.user)
        if n < 0:
            return pb.OkReply(ok=False, error="permission denied "
                                              "(admin required)")
        return pb.OkReply(ok=True)

    # ---- internal (node plane + virtual time) ----

    def CranedRegister(self, request, context):
        deny = self._deny_internal(self._ident(context),
                                   node_name=request.name)
        if deny:
            return pb.CranedRegisterReply(ok=False, error=deny)
        with self._lock:
            meta = self.scheduler.meta
            if request.name in meta._name_to_id:
                node = meta.node_by_name(request.name)
                if node.power_state == "POWEREDOFF":
                    # refused until the operator wakes it (cnode wake)
                    return pb.CranedRegisterReply(
                        ok=False, error="node is powered off "
                                        "(wake it with cnode wake)")
                # a re-registration may report CHANGED capacity
                # (hardware swap, cgroup limits): re-encode and apply it
                # through update_node_total, which also invalidates the
                # partition max-total cache — skipping this left the
                # cache stale and submit-time feasibility wrong
                if request.total.cpu or request.total.mem_bytes:
                    known = set(meta.layout.gres_dims)
                    gres = {}
                    for key, count in request.total.gres.items():
                        name, _, typ = key.partition(":")
                        if (name, typ) in known:
                            gres[(name, typ)] = count
                    meta.update_node_total(
                        node.node_id,
                        meta.layout.encode(
                            cpu=request.total.cpu,
                            mem_bytes=request.total.mem_bytes,
                            memsw_bytes=request.total.memsw_bytes,
                            gres=gres,
                            is_capacity=True))
            else:
                # only GRES pairs in the cluster's configured layout can
                # be represented; unknown pairs are ignored (the craned
                # still tracks its local slots)
                known = set(meta.layout.gres_dims)
                gres = {}
                for key, count in request.total.gres.items():
                    name, _, typ = key.partition(":")
                    if (name, typ) in known:
                        gres[(name, typ)] = count
                node = meta.add_node(
                    request.name,
                    meta.layout.encode(
                        cpu=request.total.cpu,
                        mem_bytes=request.total.mem_bytes,
                        memsw_bytes=request.total.memsw_bytes,
                        gres=gres,
                        is_capacity=True),
                    partitions=tuple(request.partitions) or ("default",))
            was_alive = node.alive
            meta.craned_up(node.node_id)
            if not was_alive:
                self.scheduler.emit_node_event("node_up", node.name,
                                               now=self._now())
            if request.address:
                # a REAL craned: remember its push address and expect
                # pings (missed pings -> CranedDown in the cycle)
                node.address = request.address
                node.expect_pings = True
                node.last_ping = self._now()
                if self.dispatcher is not None:
                    self.dispatcher.node_registered(node.node_id,
                                                    request.address)
            # keep the simulated plane in sync so dispatch to the new
            # node has a craned to land on
            elif self.sim is not None and node.node_id not in \
                    self.sim.craneds:
                self.sim.craneds[node.node_id] = SimCraned(node.node_id)
            # tell the craned which steps ctld still expects on it;
            # anything else running locally is stale (Configure flow)
            expected = [jid for jid, job in
                        self.scheduler.running.items()
                        if node.node_id in job.node_ids]
            # the craned latches this epoch and fences lower-epoch
            # pushes — the deposed leader's in-flight RPCs die here
            self._cycle_kick.set()
            return pb.CranedRegisterReply(
                ok=True, node_id=node.node_id, expected_jobs=expected,
                fencing_epoch=self.scheduler.fencing_epoch)

    def CranedPing(self, request, context):
        deny = self._deny_internal(self._ident(context),
                                   node_id=request.node_id)
        if deny:
            return pb.OkReply(ok=False, error=deny)
        with self._lock:
            node = self.scheduler.meta.nodes.get(request.node_id)
            if node is None:
                return pb.OkReply(ok=False, error="unknown node")
            if not node.alive and node.expect_pings:
                # ctld declared this node down (its jobs were requeued):
                # a bare ping cannot resurrect it — force the craned back
                # through registration so stale steps get reconciled
                return pb.OkReply(ok=False, error="re-register")
            node.last_ping = self._now()
            return pb.OkReply(ok=True)

    def StepStatusChange(self, request, context):
        deny = self._deny_internal(self._ident(context),
                                   node_id=request.node_id)
        if deny:
            return pb.OkReply(ok=False, error=deny)
        with self._lock:
            if request.spans:
                # craned-side lifecycle spans land BEFORE the status
                # change is queued, so the timeline holds them when the
                # next cycle stamps the terminal ``end`` edge
                self.scheduler.record_remote_spans(
                    request.job_id, request.incarnation, request.spans)
            if request.HasField("step_id"):
                # step-level report (real craneds): routes through the
                # per-step machine; batch step 0 closes the job
                self.scheduler.step_report(
                    request.job_id, request.step_id,
                    StepStatus(request.status), request.exit_code,
                    request.time, node_id=request.node_id,
                    incarnation=request.incarnation,
                    cpu_seconds=request.cpu_seconds,
                    max_rss_bytes=request.max_rss_bytes)
            else:
                self.scheduler.step_status_change(
                    request.job_id, JobStatus(request.status),
                    request.exit_code, request.time,
                    node_id=request.node_id,
                    incarnation=request.incarnation)
        return pb.OkReply(ok=True)

    def Tick(self, request, context):
        """Run one virtual-time cycle (advance the sim plane first).
        Admin-gated under auth: it drives the cluster clock."""
        deny = self._deny_admin(self._ident(context))
        if deny:
            return pb.TickReply(now=request.now, error=deny)
        with self._lock:
            if self.sim is not None:
                self.sim.advance_to(request.now)
            started = self.scheduler.schedule_cycle(request.now)
        return pb.TickReply(started=started, now=request.now)

    # ---- HA + summary ----

    def RequeueJob(self, request, context):
        """Kill-and-repend a running job (reference RequeueJob,
        Crane.proto:1407)."""
        with self._lock:
            deny = self._deny_job_mutation(self._ident(context),
                                           request.job_id)
            if deny:
                return pb.OkReply(ok=False, error=deny)
            err = self.scheduler.requeue(request.job_id,
                                         now=self._now())
        return pb.OkReply(ok=not err, error=err)

    def QueryJobSummary(self, request, context):
        """Per-status counts (reference QueryJobSummary,
        Crane.proto:1588).  job_id != 0 additionally returns that job's
        recorded timeline and its pending explanation."""
        self._require_authenticated(self._ident(context), context)
        import json as _json
        timeline = explain = ""
        with self._lock:
            counts = self.scheduler.job_summary(request.user,
                                                request.partition)
            if request.job_id:
                if self.scheduler.jobtrace is not None:
                    doc = self.scheduler.jobtrace.timeline(request.job_id)
                    if doc is not None:
                        timeline = _json.dumps(doc)
                explain = _json.dumps(self.scheduler.explain_pending(
                    request.job_id, self._now()))
        reply = pb.QueryJobSummaryReply(total=sum(counts.values()),
                                        timeline_json=timeline,
                                        explain_json=explain,
                                        durable_seq=self._durable_seq())
        for status in sorted(counts):
            reply.states.add(status=status, count=counts[status])
        return reply

    def QueryEvents(self, request, context):
        """Structured cluster-event ring with min-severity / time /
        cursor / type filters (``cevents``)."""
        self._require_authenticated(self._ident(context), context)
        with self._lock:
            recs = self.scheduler.events.since(
                after_seq=request.after_seq,
                severity=request.severity,
                since_time=request.since,
                type=request.type,
                limit=request.limit)
        reply = pb.QueryEventsReply(durable_seq=self._durable_seq())
        for r in recs:
            reply.events.add(seq=r["seq"], time=r["time"],
                             type=r["type"], severity=r["severity"],
                             node=r["node"], job_id=r["job_id"],
                             detail=r["detail"])
        return reply

    def CaptureProfile(self, request, context):
        """Arm an on-demand torch.profiler window spanning the next N
        scheduling cycles.  The cycle thread starts and stops the
        profiler as it ticks the window; this handler only arms it."""
        self._require_authenticated(self._ident(context), context)
        with self._lock:
            ok, detail = self.scheduler.profiler_window.request(
                request.cycles or 1, out_dir=request.dir)
        if ok:
            return pb.CaptureProfileReply(ok=True, dir=detail)
        return pb.CaptureProfileReply(ok=False, error=detail)

    def _refuse(self, name: str):
        """Handler of an RPC the port does not serve yet: aborts
        UNIMPLEMENTED naming the ROADMAP.md item that brings it."""
        item = NOT_PORTED[name]

        def handler(request, context):
            context.abort(
                grpc.StatusCode.UNIMPLEMENTED,
                f"{name} ({_NOT_PORTED_WHAT[item]}) is not in the port "
                f"yet (ROADMAP.md {item})")
        return handler

    # ---- lifecycle ----

    _RPCS = {
        "SubmitBatchJob": (pb.SubmitJobRequest, pb.SubmitJobReply),
        "SubmitBatchJobs": (pb.SubmitJobsRequest, pb.SubmitJobsReply),
        "CancelJob": (pb.JobIdRequest, pb.OkReply),
        "HoldJob": (pb.HoldRequest, pb.OkReply),
        "ModifyJob": (pb.ModifyJobRequest, pb.OkReply),
        "SuspendJob": (pb.JobIdRequest, pb.OkReply),
        "ResumeJob": (pb.JobIdRequest, pb.OkReply),
        "QueryJobsInfo": (pb.QueryJobsRequest, pb.QueryJobsReply),
        "SubmitStep": (pb.SubmitStepRequest, pb.SubmitStepReply),
        "QueryStepsInfo": (pb.QueryStepsRequest, pb.QueryStepsReply),
        "CancelStep": (pb.JobIdRequest, pb.OkReply),
        "FreeAllocation": (pb.JobIdRequest, pb.OkReply),
        "QueryClusterInfo": (pb.QueryClusterRequest, pb.QueryClusterReply),
        "CreateReservation": (pb.CreateReservationRequest, pb.OkReply),
        "DeleteReservation": (pb.NameRequest, pb.OkReply),
        "ModifyNode": (pb.ModifyNodeRequest, pb.OkReply),
        "QueryStats": (pb.StatsRequest, pb.StatsReply),
        "AcctMgr": (pb.AcctMgrRequest, pb.AcctMgrReply),
        "IssueToken": (pb.IssueTokenRequest, pb.TokenReply),
        "RevokeToken": (pb.IssueTokenRequest, pb.OkReply),
        "CranedHealth": (pb.CranedHealthRequest, pb.OkReply),
        "CranedRegister": (pb.CranedRegisterRequest,
                           pb.CranedRegisterReply),
        "CranedPing": (pb.CranedPingRequest, pb.OkReply),
        "StepStatusChange": (pb.StepStatusChangeRequest, pb.OkReply),
        "Tick": (pb.TickRequest, pb.TickReply),
        "RequeueJob": (pb.JobIdRequest, pb.OkReply),
        "QueryJobSummary": (pb.QueryJobSummaryRequest,
                            pb.QueryJobSummaryReply),
        "QueryEvents": (pb.QueryEventsRequest, pb.QueryEventsReply),
        "CaptureProfile": (pb.CaptureProfileRequest,
                           pb.CaptureProfileReply),
        "HaStatus": (pb.HaStatusRequest, pb.HaStatusReply),
        "HaFetchSnapshot": (pb.HaSnapshotRequest, pb.HaSnapshotReply),
        "HaFetchWal": (pb.HaFetchRequest, pb.HaFetchReply),
        "QueryShardMap": (pb.QueryShardMapRequest,
                          pb.QueryShardMapReply),
        "LeaseNodes": (pb.LeaseNodesRequest, pb.LeaseNodesReply),
        "ConfirmGang": (pb.ConfirmGangRequest, pb.ConfirmGangReply),
        "ReleaseLease": (pb.ReleaseLeaseRequest, pb.OkReply),
        "FetchUsage": (pb.FetchUsageRequest, pb.FetchUsageReply),
        "MigratePartition": (pb.MigratePartitionRequest,
                             pb.MigratePartitionReply),
    }

    def _now(self) -> float:
        return self.sim.now if (self.tick_mode and self.sim is not None) \
            else time.time()

    def start(self, address: str = "127.0.0.1:0") -> int:
        """Start serving; returns the bound port."""
        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                (self._refuse(name) if name in NOT_PORTED
                 else getattr(self, name)),
                request_deserializer=req.FromString,
                response_serializer=reply.SerializeToString)
            for name, (req, reply) in self._RPCS.items()
        }
        handlers["QueryJobsStream"] = \
            grpc.unary_stream_rpc_method_handler(
                self.QueryJobsStream,
                request_deserializer=pb.QueryJobsRequest.FromString,
                response_serializer=(
                    pb.QueryJobsReply.SerializeToString))
        from cranesched_tpu_torch.rpc.interceptors import MetricsInterceptor
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8),
            interceptors=(MetricsInterceptor(plane="ctld"),))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(SERVICE, handlers),))
        if self.tls is not None:
            from cranesched_tpu_torch.utils.pki import server_credentials
            port = self._server.add_secure_port(
                address, server_credentials(self.tls))
        else:
            port = self._server.add_insecure_port(address)
        self._server.start()
        if self.metrics_port is not None:
            from cranesched_tpu_torch.obs import serve_metrics
            self._metrics_server = serve_metrics(self.metrics_port)
            self.metrics_port = self._metrics_server.server_address[1]
        if not self.tick_mode:
            self._cycle_thread = threading.Thread(
                target=self._cycle_loop, daemon=True)
            self._cycle_thread.start()
        return port

    def _cycle_loop(self) -> None:
        """The 1 Hz ScheduleThread_ analog (JobScheduler.cpp:1321,1981).

        Snapshot-in / commit-out: the lock is held only for the
        scheduler's state phases (prelude, snapshot, commit); each
        solve closure yielded by ``cycle_phases`` — the expensive 99%
        of a big cycle — runs with the lock RELEASED, so submits and
        queries landing mid-cycle wait microseconds, not a full solve
        (reference: 9 scheduler threads + per-entry-locked maps,
        JobScheduler.h:1290-1335; here one cycle thread + a lock whose
        hold time excludes the solve).

        WATCHDOG: any exception escaping a cycle — prelude, solve
        closure, or commit — used to kill this thread and silently stop
        scheduling forever.  Now each iteration is fenced: the
        traceback is logged and kept in stats["last_crash"],
        crane_cycle_crashes_total is bumped, the half-run generator is
        closed, and the NEXT tick schedules normally (fault-injection
        test: tests/test_torch_rpc.py)."""
        while not self._stop.is_set():
            # condition-variable tick: any event ends the sleep early;
            # with no events the timeout is the base cadence, or the
            # idle bound when the scheduler proves the next cycle would
            # be a no-op anyway (_sleep_interval)
            self._cycle_kick.wait(self._sleep_interval())
            self._cycle_kick.clear()
            if self._stop.is_set():
                break
            now = time.time()
            # arm the stall sentry around the cycle: a cycle that
            # neither finishes nor raises (a wedged solve, a stuck
            # fsync) fires the flight recorder — all-thread stacks into
            # flight.last_stall — instead of hanging silently.  The
            # deadline mirrors the cstats staleness heuristic.
            stall_after = max(3.0 * self.cycle_interval,
                              2.0 * float(getattr(
                                  self.scheduler.config,
                                  "cycle_idle_sleep", 0.0)),
                              5.0)
            self.scheduler.flight.arm(stall_after, label="cycle")
            try:
                self._cycle_once(now)
            except Exception:
                self._record_cycle_crash(now)
            finally:
                self.scheduler.flight.disarm()

    def _sleep_interval(self) -> float:
        """Upper bound for the loop's event wait.  The base cadence
        unless the scheduler can prove the next tick would short-circuit
        (armed no-op fingerprint, nothing in flight) — then sleep up to
        ``cycle_idle_sleep``, clipped to the nearest time-dependent edge
        (begin_time/dep deadline, reservation boundary, alloc-only
        expiry, ping-timeout check).  Events still wake us instantly."""
        base = self.cycle_interval
        sched = self.scheduler
        idle = float(getattr(sched.config, "cycle_idle_sleep", 0.0))
        if idle <= base:
            return base
        with self._lock:
            if not sched.can_idle():
                return base
            wake = sched.next_wake_time(time.time())
        if wake == float("inf"):
            return idle
        return min(idle, max(wake - time.time(), base))

    def _cycle_once(self, now: float) -> None:
        """One lock-break cycle: state phases under the lock, solve
        closures outside it."""
        gen = None
        try:
            with self._lock:
                if self.sim is not None:
                    self.sim.advance_to(now)
                gen = self.scheduler.cycle_phases(now)
                try:
                    fn = next(gen)
                except StopIteration:
                    return
            while True:
                result = fn()          # lock released: the solve
                with self._lock:
                    try:
                        fn = gen.send(result)
                    except StopIteration:
                        return
        except Exception:
            if gen is not None:
                with self._lock:
                    try:
                        gen.close()    # unwind the half-run cycle
                    except Exception:
                        pass
            raise

    def _record_cycle_crash(self, now: float) -> None:
        import logging
        import traceback

        from cranesched_tpu_torch.obs import REGISTRY
        tb = traceback.format_exc()
        logging.getLogger("cranesched.ctld").error(
            "scheduling cycle crashed (next tick continues):\n%s", tb)
        REGISTRY.counter(
            "crane_cycle_crashes_total",
            "scheduling cycles that died with an exception").inc()
        with self._lock:
            st = self.scheduler.stats
            st["cycle_crashes_total"] = (
                st.get("cycle_crashes_total", 0) + 1)
            st["last_crash"] = {"time": now, "traceback": tb,
                                "flight": self.scheduler.flight.report(
                                    tail=16)}
            self.scheduler.events.emit(
                "watchdog_crash", "error", time=now,
                detail=tb.strip().rsplit("\n", 1)[-1][:200])

    # the longest stop() waits for an in-flight cycle to finish
    STOP_JOIN_S = 120.0

    def stop(self) -> None:
        self._stop.set()
        self._cycle_kick.set()  # wake a possibly long idle sleep
        if self._server is not None:
            self._server.stop(grace=0.5)
        # let an in-flight cycle finish: a process that exits while the
        # cycle thread is inside a launch on the card can die in the CUDA
        # runtime's teardown instead of exiting 0
        if self._cycle_thread is not None:
            self._cycle_thread.join(timeout=self.STOP_JOIN_S)
        self.scheduler.flight.close()
        if self.dispatcher is not None:
            self.dispatcher.close()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server = None


def serve(scheduler: JobScheduler, sim: SimCluster | None = None,
          address: str = "127.0.0.1:0", **kw) -> tuple[CtldServer, int]:
    server = CtldServer(scheduler, sim=sim, **kw)
    port = server.start(address)
    return server, port
