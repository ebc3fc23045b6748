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

A controller is a leader or a hot standby (``standby=True``): a standby
serves the read surface from its shadow state (``ha/follower.py`` keeps
it), answers every mutation and every craned RPC ``FAILED_PRECONDITION``
("not leader"), runs no cycle, and becomes the leader through
``promote_to_leader``.  ``HaStatus``, ``HaFetchSnapshot`` and
``HaFetchWal`` are the replication surface a standby polls.  A federation
shard (``shard_name=``, ``shard_map=``) forwards a misrouted submit one hop
to its partition's owner, stamps its name and map epoch on replies, serves
the arbiter's lease plane (``LeaseNodes``, ``ConfirmGang``,
``ReleaseLease``), the usage gossip (``FetchUsage``) and live partition
migration (``MigratePartition``), and pulls its peers' usage and settles
unresolved migrations on background threads.  A real node plane passes
``dispatcher=`` (``rpc/dispatcher.py``): ``CranedRegister`` opens its push
channel to the craned, and ``stop()`` closes it.
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
from cranesched_tpu_torch.obs import REGISTRY as _OBS
from cranesched_tpu_torch.rpc import crane_pb2 as pb
from cranesched_tpu_torch.rpc.consts import SERVICE
from cranesched_tpu_torch.rpc.convert import (
    job_to_pb,
    res_from_pb,
    spec_from_pb,
    step_spec_from_pb,
    step_to_pb,
)

_MET_FWD = _OBS.counter(
    "crane_fed_forwards_total",
    "misrouted submits forwarded to the partition's owning shard")
_MET_STALE = _OBS.counter(
    "crane_fed_stale_reads_refused_total",
    "follower reads refused for exceeding the caller's max_staleness")


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
                 standby: bool = False, peer_address: str = "",
                 shard_name: str = "", shard_map=None):
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
        self._usage_thread: threading.Thread | None = None
        self._stop = threading.Event()
        # event-driven cycle wakeup (the reference's
        # m_task_scheduler_thread_ condition variable): submits, status
        # changes, and node/reservation events set this so the loop
        # never sleeps through work, and an idle cluster can sleep past
        # the base tick (SchedulerConfig.cycle_idle_sleep)
        self._cycle_kick = threading.Event()
        scheduler.cycle_kick = self._cycle_kick.set
        # HA: a standby serves the read surface from its shadow state
        # and aborts mutations with FAILED_PRECONDITION so failover-
        # aware clients (HaCtldClient, craned's address rotation) move
        # on; promote_to_leader() flips the role and the cycle-loop gate
        self.ha_role = "standby" if standby else "leader"
        self.ha_peer = peer_address  # the other ctld (redirect hint)
        self.ha_follower = None      # set by ctld_main on a standby
        self.failovers = 0
        # federation (fed/): this ctld's shard identity plus the static
        # partition -> shard routing table.  A populated map turns on
        # misrouted-submit forwarding and reply shard stamping; None
        # keeps the single-controller behavior bit-for-bit.
        self.shard_name = shard_name or getattr(scheduler,
                                                "shard_name", "")
        self.shard_map = shard_map
        scheduler.shard_name = self.shard_name
        self._fwd_clients: dict = {}  # address -> CtldClient (forwards)

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

    def _trusted_forward(self, request) -> bool:
        """True for a forwarded submit arriving from a known peer shard
        of this federation.  The identity check already ran at the
        ingress shard — the shard that forwarded it — and the
        shard-to-shard hop carries no user credential, so re-running it
        here would deny every forwarded submit under auth (and
        double-count the denial metrics without it).  Trust is scoped:
        a request claiming ``forwarded`` outside a federation, or
        naming an unknown shard, still gets the full check."""
        if self.shard_map is None or not request.forwarded:
            return False
        peer = request.forwarded_from
        return bool(peer) and peer != self.shard_name \
            and self.shard_map.spec(peer) is not None

    def _fed_owner(self, partition: str):
        """(owner shard, leader address) when ``partition`` belongs to
        a DIFFERENT shard of the federation, else None — local
        partitions and unknown ones (the scheduler's own diagnostics
        handle those) take the normal path."""
        if self.shard_map is None:
            return None
        owner = self.shard_map.shard_for_partition(partition)
        if not owner or owner == self.shard_name:
            return None
        spec = self.shard_map.spec(owner)
        return owner, (spec.address if spec is not None else "")

    def _map_epoch(self) -> int:
        """The shard-map epoch this server currently routes by; stamped
        on submit/shard-map replies so clients detect a live partition
        migration and re-learn routes instead of redirect-bouncing on a
        stale map."""
        return self.shard_map.epoch if self.shard_map is not None else 0

    def _fed_client(self, address: str):
        cli = self._fwd_clients.get(address)
        if cli is None:
            from cranesched_tpu_torch.rpc.client import CtldClient
            cli = CtldClient(address, tls=self.tls, local_subchannels=True)
            self._fwd_clients[address] = cli
        return cli

    def _fed_call(self, address: str, call):
        """``call(client)`` on the peer shard's cached client.  A call
        that raises drops that client, so that the next one dials anew:
        a channel left in gRPC's reconnect backoff by the peer's outage
        fails every fail-fast call at once, for up to two minutes after
        the peer is back (ROADMAP C9)."""
        cli = self._fed_client(address)
        try:
            return call(cli)
        except Exception:
            if self._fwd_clients.get(address) is cli:
                self._fwd_clients.pop(address, None)
            raise

    def _query_dest_import(self, address: str, mid: str,
                           attempts: int = 3
                           ) -> tuple[bool, int] | None:
        """Ask the dest whether it durably adopted handoff ``mid``
        (``phase="query"`` -> has_import).  Returns (adopted, jobs) on
        an answer, None when the dest stays unreachable — the ONLY
        outcome that may leave the begin unresolved; never guess."""
        for i in range(max(attempts, 1)):
            try:
                r = self._fed_call(address, lambda c: c.migrate_partition(
                    "", "", phase="query", mid=mid))
                if r.ok:
                    return bool(r.adopted), int(r.jobs_moved)
            except Exception:
                pass
            if i + 1 < attempts:
                time.sleep(0.2)
        return None

    def _forward_submit(self, spec_pb, partition: str, owner: str,
                        address: str, already_forwarded: bool):
        """One-hop forward of a misrouted submit to the owning shard.
        The reply always carries the owner's address as a redirect hint
        so shard-aware clients (HaCtldClient) learn the route and stop
        paying the extra hop.  An ``already_forwarded`` request is never
        re-forwarded: two shards with skewed maps redirect-bounce the
        client instead of building a forwarding loop."""
        if already_forwarded or not address:
            return pb.SubmitJobReply(
                job_id=0, shard=self.shard_name,
                redirect_address=address,
                map_epoch=self._map_epoch(),
                error=f"partition {partition!r} belongs to shard "
                      f"{owner!r}")
        try:
            # trace context rides the forward: the owner stamps a
            # fed_forwarded span at (when the hop left, from which
            # shard) so the job's waterfall shows the boundary crossing
            reply = self._fed_client(address).submit(
                spec_pb, forwarded=True, forwarded_at=self._now(),
                forwarded_from=self.shard_name)
        except grpc.RpcError as exc:
            # drop the cached channel: the next misroute redials
            cli = self._fwd_clients.pop(address, None)
            if cli is not None:
                try:
                    cli.close()
                except Exception:
                    pass
            return pb.SubmitJobReply(
                job_id=0, shard=self.shard_name,
                redirect_address=address,
                map_epoch=self._map_epoch(),
                error=f"forward to shard {owner!r} failed: "
                      f"{exc.code().name}")
        self.scheduler.events.emit(
            "fed_forward", "info", time=self._now(),
            job_id=reply.job_id,
            detail=f"partition={partition} -> shard={owner}")
        _MET_FWD.inc()
        return pb.SubmitJobReply(job_id=reply.job_id, error=reply.error,
                                 shard=owner, redirect_address=address,
                                 map_epoch=self._map_epoch())

    def SubmitBatchJob(self, request, context):
        try:
            spec = spec_from_pb(request.spec)
        except ValueError as exc:
            return pb.SubmitJobReply(job_id=0, error=str(exc))
        # the identity check runs exactly once, at the INGRESS shard: a
        # trusted forward was already checked where the client connected
        if not self._trusted_forward(request):
            deny = self._check_submit_identity(self._ident(context),
                                               spec)
            if deny:
                return pb.SubmitJobReply(job_id=0, error=deny)
        owner = self._fed_owner(spec.partition)
        if owner is not None:
            return self._forward_submit(request.spec, spec.partition,
                                        *owner, request.forwarded)
        now = self._now()
        with self._lock:
            job_id = self.scheduler.submit(spec, now=now)
            if (request.forwarded and job_id
                    and self.scheduler.jobtrace is not None):
                # span the shard hop on the fresh (job_id, 0) timeline:
                # t = when the forward LEFT the misrouted shard, so the
                # submit->fed_forwarded segment shows the hop latency
                # (clocks are the federation's, skew rides as detail)
                t_fwd = request.forwarded_at or now
                self.scheduler.jobtrace.stamp(
                    job_id, 0, "fed_forwarded", t_fwd,
                    skew=round(now - t_fwd, 6))
        return pb.SubmitJobReply(
            job_id=job_id, error="" if job_id else "rejected",
            shard=self.shard_name, map_epoch=self._map_epoch())

    def SubmitBatchJobs(self, request, context):
        now = self._now()
        ident = self._ident(context)
        replies: list = [None] * len(request.specs)
        local = []
        # parse + route OUTSIDE the lock: forwarding a misrouted spec
        # is an RPC and must not stall the local scheduler
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
            owner = self._fed_owner(spec.partition)
            if owner is not None:
                replies[i] = self._forward_submit(
                    spec_pb, spec.partition, *owner, False)
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
                        error="" if job_id else "rejected",
                        shard=self.shard_name)
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

    def _staleness_guard(self, max_staleness: float, context) -> None:
        """Bounded-staleness read contract: a follower may serve this
        read only if it was fully caught up with its leader within the
        last ``max_staleness`` seconds; otherwise it refuses with
        FAILED_PRECONDITION so the client rotates to the leader.
        ``max_staleness == 0`` keeps the old contract — any replica
        answers with whatever it has.  Leaders always pass."""
        if max_staleness <= 0 or self.ha_follower is None:
            return
        stale = self.ha_follower.staleness()
        if stale > max_staleness:
            _MET_STALE.inc()
            context.abort(
                grpc.StatusCode.FAILED_PRECONDITION,
                "staleness %.3fs exceeds max_staleness %.3fs%s" % (
                    stale, max_staleness,
                    "; try " + self.ha_peer if self.ha_peer else ""))

    def _durable_seq(self) -> int:
        """The durability watermark this replica's answers reflect:
        applied_seq on a follower, the WAL's fsync'd seq on a leader."""
        if self.ha_follower is not None:
            return self.ha_follower.applied_seq
        wal = self.scheduler.wal
        return wal.durable_seq if wal is not None else 0

    def QueryJobsInfo(self, request, context):
        self._require_authenticated(self._ident(context), context)
        self._staleness_guard(request.max_staleness, context)
        limit = request.limit or 0
        with self._lock:
            jobs, names = self._job_snapshot(request)
            truncated = bool(limit) and len(jobs) > limit
            if truncated:
                jobs = jobs[:limit]
            return pb.QueryJobsReply(
                jobs=[job_to_pb(j, names) for j in jobs],
                truncated=truncated,
                durable_seq=self._durable_seq(), shard=self.shard_name)

    def QueryJobsStream(self, request, context):
        """Server-streaming query (reference Crane.proto:1576-1590):
        chunks of QUERY_CHUNK jobs, converted under short lock holds —
        a 100k-job cqueue neither builds one giant message nor stalls
        the scheduling cycle for its whole duration."""
        self._require_authenticated(self._ident(context), context)
        self._staleness_guard(request.max_staleness, context)
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
        self._staleness_guard(request.max_staleness, context)
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
                nodes=out, durable_seq=self._durable_seq(),
                shard=self.shard_name)

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
        self._staleness_guard(request.max_staleness, context)
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
            lag = 0
            if self.ha_follower is not None:
                lag = max(0, self.ha_follower.leader_seq
                          - self.ha_follower.applied_seq)
            doc["ha"] = {
                "role": self.ha_role,
                "fencing_epoch": self.scheduler.fencing_epoch,
                "wal_seq": (self.ha_follower.applied_seq
                            if self.ha_follower is not None
                            else (wal.durable_seq
                                  if wal is not None else 0)),
                "replication_lag": lag,
                "failovers_total": self.failovers,
                "peer": self.ha_peer,
            }
            if self.shard_name or self.shard_map is not None:
                doc["fed"] = {
                    "shard": self.shard_name,
                    "map_epoch": self._map_epoch(),
                    "shards": (self.shard_map.doc()
                               if self.shard_map is not None else []),
                }
                if self.scheduler.fed is not None:
                    doc["fed"].update(self.scheduler.fed.stats())
                if self.scheduler.global_usage is not None:
                    doc["fed"]["usage"] = \
                        self.scheduler.global_usage.stats()
            return pb.StatsReply(json=_json.dumps(doc),
                                 durable_seq=self._durable_seq(),
                                 shard=self.shard_name)

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
        t_req = time.perf_counter()
        with self._lock:
            self._advance_plane(t_req, request.now)
            started = self.scheduler.schedule_cycle(request.now)
        return pb.TickReply(started=started, now=request.now)

    def _advance_plane(self, t_req: float, now: float) -> None:
        """Under the lock, before a cycle: the simulated plane's advance
        to ``now``, and the wait for the lock since ``t_req`` and the
        advance as spans of the cycle's row."""
        spans = self.scheduler.cycle_spans
        t_lock = time.perf_counter()
        spans.before("lock_wait", t_req, t_lock)
        if self.sim is not None:
            self.sim.advance_to(now)
            spans.before("sim_advance", t_lock, time.perf_counter())

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
        self._staleness_guard(request.max_staleness, context)
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
                                        durable_seq=self._durable_seq(),
                                        shard=self.shard_name)
        for status in sorted(counts):
            reply.states.add(status=status, count=counts[status])
        return reply

    def QueryEvents(self, request, context):
        """Structured cluster-event ring with min-severity / time /
        cursor / type filters (``cevents``)."""
        self._require_authenticated(self._ident(context), context)
        self._staleness_guard(request.max_staleness, context)
        with self._lock:
            recs = self.scheduler.events.since(
                after_seq=request.after_seq,
                severity=request.severity,
                since_time=request.since,
                type=request.type,
                limit=request.limit)
        reply = pb.QueryEventsReply(durable_seq=self._durable_seq(),
                                    shard=self.shard_name)
        for r in recs:
            reply.events.add(seq=r["seq"], time=r["time"],
                             type=r["type"], severity=r["severity"],
                             node=r["node"], job_id=r["job_id"],
                             detail=r["detail"])
        return reply

    # ---- federation: shard map + the arbiter's lease plane ----

    def QueryShardMap(self, request, context):
        """The static partition -> shard routing table, served by every
        shard (and every follower — the map is config, not state) so
        clients can learn routes from whichever replica answered."""
        self._require_authenticated(self._ident(context), context)
        if self.shard_map is None:
            return pb.QueryShardMapReply(shard=self.shard_name,
                                         error="not federated")
        reply = pb.QueryShardMapReply(shard=self.shard_name,
                                      map_epoch=self.shard_map.epoch)
        for doc in self.shard_map.doc():
            reply.shards.add(name=doc["name"],
                             partitions=doc["partitions"],
                             address=doc["address"],
                             followers=doc["followers"])
        return reply

    def LeaseNodes(self, request, context):
        """Phase one of the arbiter's cross-partition gang commit:
        durably reserve nodes under this shard's fencing epoch."""
        deny = self._deny_admin(self._ident(context))
        if deny:
            return pb.LeaseNodesReply(ok=False, error=deny)
        fed = self.scheduler.fed
        if fed is None:
            return pb.LeaseNodesReply(ok=False,
                                      error="not a federation shard")
        req = res_from_pb(request.res).encode(self.scheduler.meta.layout)
        with self._lock:
            try:
                names, epoch, seq = fed.lease_nodes(
                    request.lease_id, request.partition,
                    int(request.node_num), req, request.ttl,
                    self._now())
            except ValueError as exc:
                return pb.LeaseNodesReply(ok=False, error=str(exc))
        return pb.LeaseNodesReply(ok=True, node_names=names,
                                  fencing_epoch=epoch, durable_seq=seq)

    def ConfirmGang(self, request, context):
        """Phase two: turn a lease into a RUNNING local gang member in
        one WAL group (the only record that creates the job)."""
        deny = self._deny_admin(self._ident(context))
        if deny:
            return pb.ConfirmGangReply(ok=False, error=deny)
        fed = self.scheduler.fed
        if fed is None:
            return pb.ConfirmGangReply(ok=False,
                                       error="not a federation shard")
        try:
            spec = spec_from_pb(request.spec)
        except ValueError as exc:
            return pb.ConfirmGangReply(ok=False, error=str(exc))
        with self._lock:
            try:
                job_id = fed.confirm_gang(
                    request.lease_id, request.gang_id, spec,
                    list(request.node_names), self._now(),
                    epoch=request.fencing_epoch)
            except ValueError as exc:
                return pb.ConfirmGangReply(ok=False, error=str(exc))
        return pb.ConfirmGangReply(ok=True, job_id=job_id,
                                   durable_seq=self._durable_seq())

    def ReleaseLease(self, request, context):
        """Drop an unconfirmed reservation (arbiter abort)."""
        deny = self._deny_admin(self._ident(context))
        if deny:
            return pb.OkReply(ok=False, error=deny)
        fed = self.scheduler.fed
        if fed is None:
            return pb.OkReply(ok=False, error="not a federation shard")
        with self._lock:
            ok = fed.release_lease(request.lease_id, self._now())
        return pb.OkReply(ok=ok, error="" if ok else "no such lease")

    # ---- elastic federation: usage gossip + live migration ----

    def FetchUsage(self, request, context):
        """This shard's per-user/per-account usage summary, stamped
        with its WAL watermark (``durable_seq``).  Peers poll this and
        feed the payload to their own UsageBook.ingest — the gossip
        transport for cluster-wide MaxJobs / fair-share.  The request
        names the PULLING shard: serving it is confirmed delivery to
        that peer, and only the slowest peer's confirmation releases
        the publish-slack throttle (an anonymous pull — the CLI —
        acks nobody)."""
        import json as _json
        self._require_authenticated(self._ident(context), context)
        book = self.scheduler.global_usage
        if book is None:
            return pb.FetchUsageReply(ok=False, shard=self.shard_name,
                                      error="no global accounting")
        with self._lock:
            doc = book.publish(self._now(), peer=request.shard or "")
            seq = self._durable_seq()
        return pb.FetchUsageReply(ok=True, shard=self.shard_name,
                                  payload=_json.dumps(doc),
                                  durable_seq=seq)

    def MigratePartition(self, request, context):
        """Live partition migration (admin-only).  Two phases share the
        verb:

        * ``phase=""`` — drive the whole handoff.  Must land on the
          partition's source shard (``cfed migrate`` dials it from the
          map); runs seal -> export locally, ships the payload to the
          dest with ``phase="import"``, flips this shard's map, then
          commits.  An import failure aborts durably and re-opens the
          partition in place.
        * ``phase="import"`` — adopt an exported payload: one WAL group
          creates every job under fresh local ids, then this shard's
          map flips so it starts routing the partition to itself.
        * ``phase="query"`` — answer :meth:`has_import` for ``mid``:
          the source's resolution path keys commit-vs-abort on this
          after an ambiguous import RPC (timeout/drop) or a crash.
        """
        import json as _json
        deny = self._deny_admin(self._ident(context))
        if deny:
            return pb.MigratePartitionReply(ok=False, error=deny)
        fed = self.scheduler.fed
        if fed is None or self.shard_map is None:
            return pb.MigratePartitionReply(
                ok=False, error="not a federation shard")
        now = self._now()
        if request.phase == "query":
            with self._lock:
                adopted = fed.has_import(request.mid)
                jobs = len(fed.imports.get(str(request.mid)) or [])
            return pb.MigratePartitionReply(
                ok=True, mid=request.mid, adopted=adopted,
                jobs_moved=jobs, map_epoch=self._map_epoch())
        if request.phase == "import":
            try:
                payload = _json.loads(request.payload)
            except _json.JSONDecodeError as exc:
                return pb.MigratePartitionReply(
                    ok=False, error=f"bad payload: {exc}")
            with self._lock:
                try:
                    imported, new_nodes = fed.import_partition(payload,
                                                               now)
                except ValueError as exc:
                    return pb.MigratePartitionReply(ok=False,
                                                    error=str(exc))
                if self.sim is not None:
                    # a simulated plane mirrors the adopted meta, as
                    # fed/sim.py's handle does: craneds for the new
                    # nodes (a placement there dispatches to them), the
                    # running jobs re-armed (ROADMAP.md C7)
                    for nid in new_nodes:
                        self.sim.craneds.setdefault(nid, SimCraned(nid))
                    for jid in imported:
                        job = self.scheduler.running.get(jid)
                        if job is not None:
                            self.sim.dispatch(job, job.node_ids)
                try:
                    self.shard_map = self.shard_map.with_partition_moved(
                        payload["partition"], self.shard_name)
                except ValueError:
                    pass  # already ours (idempotent re-import)
            self._cycle_kick.set()
            return pb.MigratePartitionReply(
                ok=True, mid=payload.get("mid", ""),
                jobs_moved=len(imported), map_epoch=self._map_epoch())
        if request.phase:
            return pb.MigratePartitionReply(
                ok=False, error=f"unknown phase {request.phase!r}")
        partition, dest = request.partition, request.dest_shard
        owner = self.shard_map.shard_for_partition(partition)
        if owner != self.shard_name:
            spec = self.shard_map.spec(owner) if owner else None
            return pb.MigratePartitionReply(
                ok=False,
                error=f"partition {partition!r} belongs to shard "
                      f"{owner!r}"
                      + (f" at {spec.address}" if spec is not None
                         and spec.address else ""))
        dspec = self.shard_map.spec(dest)
        if dspec is None or dest == self.shard_name:
            return pb.MigratePartitionReply(
                ok=False, error=f"bad destination shard {dest!r}")
        mid = (f"mig:{partition}:{self.shard_map.epoch}"
               f":{self.shard_name}->{dest}")
        with self._lock:
            try:
                fed.seal_partition(mid, partition, dest, now)
                payload = fed.export_partition(mid, partition)
            except ValueError as exc:
                return pb.MigratePartitionReply(ok=False, error=str(exc))
        adopted = None
        jobs_moved = 0
        err = ""
        try:
            dreply = self._fed_call(
                dspec.address, lambda c: c.migrate_partition(
                    partition, dest, phase="import",
                    payload=_json.dumps(payload), mid=mid))
            if dreply.ok:
                adopted = True
                jobs_moved = int(dreply.jobs_moved)
            else:
                # a structured refusal: the dest's two-phase import
                # validates+mallocs everything BEFORE its first WAL
                # write, so "not ok" genuinely means nothing adopted
                adopted = False
                err = dreply.error
        except Exception as exc:
            # the RPC died in flight — AMBIGUOUS.  The dest may have
            # durably imported (and flipped its map) before the
            # channel dropped; a blind abort here would leave BOTH
            # shards owning the jobs.  Ask the dest what it holds.
            err = str(exc)
            verdict = self._query_dest_import(dspec.address, mid)
            if verdict is not None:
                adopted, jobs_moved = verdict
        if adopted is False:
            with self._lock:
                fed.abort_migration(mid, partition, now)
            return pb.MigratePartitionReply(
                ok=False, mid=mid,
                error=f"dest import failed (aborted): {err}")
        if adopted is None:
            # dest unreachable AND adoption unknown: the ONLY safe
            # move is none.  The partition stays sealed (no local
            # admits, no duplicate execution either way) and the
            # resolver loop settles the begin once the dest answers.
            with self._lock:
                if not any(r.get("mid") == mid
                           for r in fed.unresolved_migrations):
                    fed.unresolved_migrations.append({
                        "mid": mid, "partition": partition,
                        "dest": dest,
                        "job_ids": [e["job"]["job_id"]
                                    for e in payload.get("jobs", [])]})
                self.scheduler.events.emit(
                    "fed_migrate_unresolved", "warning", time=now,
                    detail=f"mid={mid} part={partition} dest={dest} "
                           "(import RPC died; partition sealed "
                           "pending resolution)")
            return pb.MigratePartitionReply(
                ok=False, mid=mid,
                error=f"dest unreachable after import RPC ({err}); "
                      "partition stays sealed pending resolution")
        # the dest holds the jobs durably: flip BEFORE commit, so a
        # crash here still routes the partition to the shard that has
        # the jobs; recovery resolves the bare begin against the dest
        with self._lock:
            self.shard_map = self.shard_map.with_partition_moved(
                partition, dest)
            fed.commit_migration(mid, partition, now)
        self.scheduler.events.emit(
            "fed_migrate", "info", time=now,
            detail=f"partition={partition} -> shard={dest} "
                   f"jobs={jobs_moved} "
                   f"epoch={self.shard_map.epoch}")
        return pb.MigratePartitionReply(
            ok=True, mid=mid, jobs_moved=jobs_moved,
            map_epoch=self.shard_map.epoch)

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

    def HaStatus(self, request, context):
        self._require_authenticated(self._ident(context), context)
        with self._lock:
            wal = self.scheduler.wal
            seq = wal.durable_seq if wal is not None else 0
            lag = 0
            leader = "" if self.ha_role == "leader" else self.ha_peer
            if self.ha_follower is not None:
                seq = self.ha_follower.applied_seq
                lag = max(0, self.ha_follower.leader_seq - seq)
            return pb.HaStatusReply(
                role=self.ha_role,
                fencing_epoch=self.scheduler.fencing_epoch,
                wal_seq=seq, leader_address=leader,
                replication_lag=lag)

    def HaFetchSnapshot(self, request, context):
        """Serve a point-in-time snapshot to a syncing standby."""
        self._require_authenticated(self._ident(context), context)
        import json as _json

        from cranesched_tpu_torch.ha.snapshot import capture_snapshot
        with self._lock:
            doc = capture_snapshot(self.scheduler)
            epoch = self.scheduler.fencing_epoch
        return pb.HaSnapshotReply(ok=True, seq=doc["seq"],
                                  payload=_json.dumps(
                                      doc, separators=(",", ":")),
                                  fencing_epoch=epoch)

    def HaFetchWal(self, request, context):
        """Cursor-based WAL tail for the polling standby."""
        self._require_authenticated(self._ident(context), context)
        with self._lock:
            wal = self.scheduler.wal
            if wal is None:
                return pb.HaFetchReply(ok=False,
                                       error="no WAL on this ctld")
            out = wal.tail_since(request.after_seq,
                                 limit=request.limit or 512)
            # the follower's replication cursor must never run ahead of
            # the durability barrier — inside an open group `seq` does
            seq = wal.durable_seq
            epoch = self.scheduler.fencing_epoch
            # event-ring piggyback: the ring is bounded and events are
            # advisory, so no resync protocol — a follower that missed
            # evicted entries just starts from what is still in the ring
            events = self.scheduler.events.since(
                after_seq=request.after_event_seq)
            event_seq = self.scheduler.events.last_seq
        reply = pb.HaFetchReply(ok=True, wal_seq=seq,
                                fencing_epoch=epoch, event_seq=event_seq)
        for r in events:
            reply.events.add(seq=r["seq"], time=r["time"], type=r["type"],
                             severity=r["severity"], node=r["node"],
                             job_id=r["job_id"], detail=r["detail"])
        if out is None:
            reply.resync = True
        else:
            for s, line in out:
                reply.records.add(seq=s, payload=line)
        return reply

    def promote_to_leader(self, epoch: int) -> None:
        """Flip a standby to leader: the cycle-loop gate opens on the
        next tick and the mutation surface starts answering.  The
        scheduler-side rebuild (recover + device state + epoch) is the
        follower's job BEFORE calling this."""
        self.ha_role = "leader"
        self.ha_follower = None
        self.failovers += 1
        self.scheduler.events.emit(
            "failover", "critical",
            detail="standby promoted to leader (epoch %d)" % epoch,
            time=self._now())
        # seed push channels from the replicated node addresses so a
        # re-sent kill (recover's cancel-intent redelivery) can land
        # BEFORE the craneds get around to re-registering
        if self.dispatcher is not None:
            for node in self.scheduler.meta.nodes.values():
                if node.alive and node.address:
                    self.dispatcher.node_registered(node.node_id,
                                                    node.address)

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

    # the surface a standby may serve from its shadow state; everything
    # else aborts FAILED_PRECONDITION ("not leader") so failover-aware
    # callers rotate to the leader.  Craned-internal RPCs are
    # deliberately NOT here: craneds must register/report to the leader
    # only, or the standby's shadow state would fork from the WAL.
    _STANDBY_OK = frozenset({
        "QueryJobsInfo", "QueryJobsStream", "QueryStepsInfo",
        "QueryClusterInfo", "QueryStats", "QueryJobSummary", "HaStatus",
        "QueryEvents", "QueryShardMap",
    })

    def _now(self) -> float:
        return self.sim.now if (self.tick_mode and self.sim is not None) \
            else time.time()

    def _leader_only(self, name, fn):
        """Gate one handler on leadership.  The abort code is part of
        the failover contract: HaCtldClient and the craned's ctld
        address rotation both treat FAILED_PRECONDITION as 'ask the
        other ctld'."""
        def handler(request, context):
            if self.ha_role != "leader":
                context.abort(
                    grpc.StatusCode.FAILED_PRECONDITION,
                    f"not leader (standby"
                    f"{'; try ' + self.ha_peer if self.ha_peer else ''})")
            return fn(request, context)
        return handler

    def start(self, address: str = "127.0.0.1:0") -> int:
        """Start serving; returns the bound port."""
        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                (getattr(self, name) if name in self._STANDBY_OK
                 else self._leader_only(name, getattr(self, name))),
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
        if (self.shard_map is not None
                and self.scheduler.global_usage is not None):
            self._usage_thread = threading.Thread(
                target=self._usage_gossip_loop, daemon=True)
            self._usage_thread.start()
        if (self.shard_map is not None
                and self.scheduler.fed is not None):
            self._resolve_thread = threading.Thread(
                target=self._fed_resolve_loop, daemon=True)
            self._resolve_thread.start()
        return port

    def _usage_gossip_loop(self) -> None:
        """Cluster-wide accounting pump (fed/usage.py): pull every
        peer's latest summary via FetchUsage and ingest it under the
        lock.  The request carries OUR shard name — serving it is that
        peer's confirmed delivery to us, and symmetrically our
        FetchUsage handler marks our counters delivered per pulling
        peer.  Only the SLOWEST peer's confirmation releases the
        publish-slack throttle (UsageBook.unconfirmed), so a peer that
        cannot fetch for several intervals tightens our own admissions
        instead of letting global limits overshoot.  A peer outage
        only ages that peer's summary and withholds its acks; it never
        blocks this loop or the cycle thread."""
        import json as _json
        interval = max(self.cycle_interval, 0.5)
        while not self._stop.wait(interval):
            if self.ha_role != "leader":
                continue
            book = self.scheduler.global_usage
            for name, spec in self.shard_map.shards.items():
                if name == self.shard_name or not spec.address:
                    continue
                try:
                    reply = self._fed_call(
                        spec.address, lambda c: c.fetch_usage(
                            shard=self.shard_name))
                    doc = _json.loads(reply.payload) if reply.ok \
                        else None
                except Exception:
                    continue
                if doc:
                    with self._lock:
                        book.ingest(doc, self._now())

    def _fed_resolve_loop(self) -> None:
        """Background settlement of unresolved migration begins (a
        crash or a dropped import RPC left a durable begin with no
        commit/abort).  Each pass asks every begin's dest for its
        has_import answer: adopted -> flip the map and commit; not
        adopted -> abort and re-open.  Unreachable dests just stay
        queued — the partition remains sealed, which is safe on both
        sides."""
        interval = max(self.cycle_interval * 5.0, 2.0)
        while not self._stop.wait(interval):
            if self.ha_role != "leader":
                continue
            try:
                self._resolve_migrations_once()
            except Exception:
                pass  # never kill the loop; next tick retries

    def _resolve_migrations_once(self) -> int:
        """One resolution pass; returns how many begins settled."""
        fed = self.scheduler.fed
        if fed is None or self.shard_map is None:
            return 0
        with self._lock:
            pending = [dict(r) for r in fed.unresolved_migrations]
        settled = 0
        for rec in pending:
            mid = str(rec.get("mid", ""))
            partition = str(rec.get("partition", ""))
            dest = str(rec.get("dest", ""))
            spec = self.shard_map.spec(dest) if dest else None
            if spec is None or not spec.address:
                continue
            verdict = self._query_dest_import(spec.address, mid,
                                              attempts=1)
            if verdict is None:
                continue  # still unreachable; stay sealed
            adopted, _jobs = verdict
            now = self._now()
            with self._lock:
                if not any(r.get("mid") == mid
                           for r in fed.unresolved_migrations):
                    continue  # settled concurrently
                if adopted:
                    try:
                        self.shard_map = \
                            self.shard_map.with_partition_moved(
                                partition, dest)
                    except ValueError:
                        pass  # map already routes it to the dest
                    fed.commit_migration(mid, partition, now)
                else:
                    fed.abort_migration(mid, partition, now)
                self.scheduler.events.emit(
                    "fed_migrate_resolved", "info", time=now,
                    detail=f"mid={mid} part={partition} -> "
                           + ("commit" if adopted else "abort"))
            settled += 1
        return settled

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
            if self.ha_role != "leader":
                continue  # standby: shadow state only, never schedule
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
        if self.ha_role != "leader" or idle <= base:
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
            t_req = time.perf_counter()
            with self._lock:
                self._advance_plane(t_req, now)
                if self.scheduler.fed is not None:
                    # a dead arbiter's leases self-expire here, so
                    # reserved-but-never-confirmed nodes rejoin the
                    # local pool without operator action
                    self.scheduler.fed.expire(now)
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
        for cli in self._fwd_clients.values():
            try:
                cli.close()
            except Exception:
                pass
        self._fwd_clients.clear()
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server = None


def serve(scheduler: JobScheduler, sim: SimCluster | None = None,
          address: str = "127.0.0.1:0", **kw) -> tuple[CtldServer, int]:
    server = CtldServer(scheduler, sim=sim, **kw)
    port = server.start(address)
    return server, port
