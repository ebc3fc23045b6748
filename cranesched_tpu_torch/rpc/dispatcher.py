"""Per-node push dispatch: the reference's CranedKeeper + scheduler
fan-out (reference: src/CraneCtld/RpcService/CranedKeeper.h:74-107 — one
stub per craned on shared channels; AllocJobs/AllocSteps fan-out with a
thread pool + latch, JobScheduler.cpp:1732-1839).

Wire-up::

    dispatcher = GrpcDispatcher(scheduler)
    scheduler.dispatch = dispatcher.dispatch
    scheduler.dispatch_step = dispatcher.dispatch_step
    scheduler.dispatch_terminate = dispatcher.terminate
    scheduler.dispatch_terminate_step = dispatcher.terminate_step
    scheduler.dispatch_free_alloc = dispatcher.free_alloc
    scheduler.dispatch_suspend = dispatcher.suspend
    scheduler.dispatch_resume = dispatcher.resume
    server = CtldServer(scheduler, dispatcher=dispatcher)

The port's copy of ``cranesched_tpu/rpc/dispatcher.py``,
with the port's imports.
"""

from __future__ import annotations

import threading
import time
from concurrent import futures

import grpc

from cranesched_tpu_torch.ctld.defs import Job, JobStatus
from cranesched_tpu_torch.rpc import crane_pb2 as pb
from cranesched_tpu_torch.rpc.consts import CRANED_SERVICE
from cranesched_tpu_torch.rpc.convert import spec_to_pb, step_spec_to_pb
from cranesched_tpu_torch.rpc.stub import GrpcStub


class _CranedStub(GrpcStub):
    """One channel per craned (reference CranedStub)."""

    #: duck-typed capability flag — the dispatcher only passes the
    #: crane-trace metadata kwarg to stubs that advertise it (test
    #: fakes keep the plain (name, request) signature)
    trace_metadata = True

    def __init__(self, address: str, timeout: float = 10.0, tls=None):
        super().__init__(address, CRANED_SERVICE, timeout, tls=tls)

    def call(self, name, request, reply_cls=pb.OkReply, metadata=()):
        return super().call(name, request, reply_cls, metadata=metadata)


class _PushState:
    """Per-job completion latch for the coalesced fan-out: a job's
    pushes run on different per-node pool tasks, so the LAST node to
    finish (success or not) fires the rollback if any node errored."""

    __slots__ = ("_lock", "_remaining", "_errors", "_rollback")

    def __init__(self, remaining: int, rollback):
        self._lock = threading.Lock()
        self._remaining = remaining
        self._errors: list[str] = []
        self._rollback = rollback

    def done(self, error: str) -> None:
        with self._lock:
            if error:
                self._errors.append(error)
            self._remaining -= 1
            fire = self._remaining == 0 and bool(self._errors)
        if fire:
            self._rollback()


class GrpcDispatcher:
    def __init__(self, scheduler, max_workers: int | None = None,
                 tls=None):
        self.scheduler = scheduler
        # utils.pki.TlsConfig: push channels to craneds dial TLS,
        # verified against the cluster CA (craneds serve their node
        # certs) — the internal fabric's encrypted half
        self.tls = tls
        # fan-out width: explicit arg > SchedulerConfig.dispatch_workers
        # (YAML DispatchWorkers) > derived from cluster size, so a
        # 10k-node cycle's pushes are not serialized a few at a time.
        if max_workers is None:
            max_workers = getattr(scheduler.config, "dispatch_workers",
                                  None)
        if max_workers is None:
            max_workers = self.default_workers(
                len(scheduler.meta.nodes))
        self.max_workers = int(max_workers)
        self._stubs: dict[int, _CranedStub] = {}
        self._lock = threading.Lock()
        self._pool = futures.ThreadPoolExecutor(
            max_workers=self.max_workers)

    @staticmethod
    def default_workers(num_nodes: int) -> int:
        """max(8, nodes // 64), capped at 128: wide enough that a
        10k-node commit wave drains in ~nodes/width push rounds, small
        enough not to oversubscribe the ctld host."""
        return min(max(8, num_nodes // 64), 128)

    def wire(self, scheduler) -> None:
        """Attach every dispatch seam in one place, so that none is
        missed."""
        scheduler.dispatch = self.dispatch
        scheduler.dispatch_batch = self.dispatch_batch
        scheduler.dispatch_step = self.dispatch_step
        scheduler.dispatch_terminate = self.terminate
        scheduler.dispatch_terminate_step = self.terminate_step
        scheduler.dispatch_free_alloc = self.free_alloc
        scheduler.dispatch_suspend = self.suspend
        scheduler.dispatch_resume = self.resume
        scheduler.dispatch_change_time_limit = self.change_time_limit

    def node_registered(self, node_id: int, address: str) -> None:
        tls = self.tls
        if tls is not None:
            # pin the channel to the node's own cert identity: a
            # compromised node redirecting its address at another
            # node's port cannot answer as it (certs are per-name)
            node = self.scheduler.meta.nodes.get(node_id)
            if node is not None:
                tls = tls.pinned(node.name)
        with self._lock:
            old = self._stubs.get(node_id)
            if old is not None and old.address != address:
                old.close()
                old = None
            if old is None:
                self._stubs[node_id] = _CranedStub(address, tls=tls)

    def _stub(self, node_id: int) -> _CranedStub | None:
        with self._lock:
            return self._stubs.get(node_id)

    # ---- the dispatch seam ----

    def dispatch(self, job: Job, node_ids: list[int]) -> None:
        """ExecuteStep/AllocJob fan-out, ASYNCHRONOUS: pushes must not
        block the caller on craned RPCs (an unreachable craned would
        stall pings from healthy nodes and cascade false CranedDown
        events).  A failed push fails the job via the normal
        status-change path (the reference frees resources and marks
        Failed on dispatch errors, JobScheduler.cpp:1908-1967).

        Batch jobs push ExecuteStep (implicit allocation + step 0 in
        one); alloc_only jobs push AllocJob (the allocation sits until
        steps arrive via dispatch_step)."""
        self.dispatch_batch([(job, node_ids, job.requeue_count,
                              self.scheduler.fencing_epoch)])

    def dispatch_batch(self, items) -> None:
        """Coalesced post-commit fan-out: the scheduler's dispatch ring
        arrives as ONE call; requests are grouped per craned so N jobs
        landing on one node become one pool task pushing back-to-back
        on that node's channel, instead of N independent fan-outs
        threading through the pool.  Per-job semantics are unchanged —
        if any of a job's nodes fails, whatever DID land is rolled back
        and the job fails via the status-change path.

        ``items`` entries are ``(job, node_ids, incarnation,
        fencing_epoch)`` (or 2-tuples, which re-read both from live
        state).  The 4-tuple values are captured synchronously under
        the ctld lock at commit time: the async pushes below can
        outlive a requeue (node death while a push blocks on its RPC
        timeout), and a stale failure report stamped with the job's
        *current* requeue_count would defeat the staleness guard and
        kill the healthy new incarnation; likewise a push built after
        this ctld lost its lease must carry the OLD fencing epoch so
        craneds that learned the new one reject it."""
        by_node: dict[int, list[tuple]] = {}
        for item in items:
            job, node_ids = item[0], list(item[1])
            if not node_ids:
                continue
            incarnation = (item[2] if len(item) > 2
                           else job.requeue_count)
            epoch = (item[3] if len(item) > 3
                     else self.scheduler.fencing_epoch)
            push, rollback, tasks = self._build_push(
                job, node_ids, incarnation, epoch)
            state = _PushState(len(node_ids), rollback)
            for rank, node_id in enumerate(node_ids):
                ntasks = tasks[rank] if rank < len(tasks) else 1
                by_node.setdefault(node_id, []).append(
                    (push, node_id, ntasks, state))
        for entries in by_node.values():
            self._pool.submit(self._push_node_batch, entries)

    @staticmethod
    def _push_node_batch(entries) -> None:
        """One pool task per craned: push every job bound for this node
        sequentially; a job's LAST completing node triggers its
        rollback if any node errored."""
        for push, node_id, ntasks, state in entries:
            err = push(node_id, ntasks)
            state.done(err)

    def _build_push(self, job: Job, node_ids: list[int],
                    incarnation: int, epoch: int):
        """One job's push closure + rollback, built once per dispatch
        (the pb encode + gang context are the per-job cost; per-node
        work is just the request stamp + the RPC)."""
        verb = "AllocJob" if job.spec.alloc_only else "ExecuteStep"
        step0 = job.steps.get(0)
        step_pb = (step_spec_to_pb(step0.spec)
                   if step0 is not None else None)
        spec_pb = spec_to_pb(job.spec)
        tasks = job.task_layout or [1] * len(node_ids)
        gang = self._gang_ctx(job.job_id, node_ids,
                              int(sum(tasks[: len(node_ids)])))
        # trace context (jobtrace): the base span seq lets the craned
        # number its local spans after the ctld-side ones, so the merged
        # timeline sorts monotonically by seq.  Captured here, at build
        # time, right after the ring drain stamped committed_durable +
        # dispatched for this incarnation.
        trace_md = ()
        if getattr(self.scheduler, "jobtrace", None) is not None:
            base_seq = self.scheduler.trace_seq(job.job_id, incarnation)
            trace_md = (("crane-trace",
                         f"{job.job_id}/{incarnation}/{epoch}/"
                         f"{base_seq}"),)

        def push(node_id, ntasks):
            stub = self._stub(node_id)
            if stub is None:
                return f"node {node_id} has no stub"
            # transient refusals (e.g. GRES slots still held by a
            # previous incarnation mid-teardown) retry briefly
            for attempt in range(10):
                req = pb.ExecuteStepRequest(
                    job_id=job.job_id, spec=spec_pb,
                    tasks_on_node=ntasks, now=time.time(),
                    incarnation=incarnation, step_id=0,
                    fencing_epoch=epoch,
                    nodelist=gang["nodelist"],
                    node_rank=gang["rank"][node_id],
                    nnodes=len(node_ids),
                    ntasks=gang["ntasks"],
                    rendezvous=gang["rendezvous"],
                    rendezvous_token=gang["token"])
                if step_pb is not None:
                    req.step.CopyFrom(step_pb)
                try:
                    if trace_md and getattr(stub, "trace_metadata",
                                            False):
                        reply = stub.call(verb, req,
                                          metadata=trace_md)
                    else:
                        reply = stub.call(verb, req)
                except grpc.RpcError as exc:
                    return f"push to node {node_id} failed: {exc.code()}"
                if reply.ok:
                    return ""
                if not reply.error.startswith("retryable:"):
                    self._note_fenced(node_id, reply.error)
                    return reply.error
                time.sleep(0.5)
            return reply.error

        def rollback():
            # roll back whatever DID land — guarded by OUR incarnation,
            # so if the job was requeued and re-placed while a push
            # blocked on its RPC timeout, this late cleanup cannot
            # touch the healthy new incarnation.  AllocJob pushes must
            # be undone with FreeJob (an explicit allocation with zero
            # steps ignores TerminateStep and would leak its cgroup +
            # GRES).
            undo = "FreeJob" if verb == "AllocJob" else "TerminateStep"
            for node_id in node_ids:
                self._try_call(node_id, undo,
                               pb.JobIdRequest(job_id=job.job_id,
                                               incarnation=incarnation,
                                               fencing_epoch=epoch))
            self.scheduler.step_status_change(
                job.job_id, JobStatus.FAILED, 254, time.time(),
                incarnation=incarnation)

        return push, rollback, tasks

    def _gang_ctx(self, job_id: int, node_ids: list[int],
                  ntasks: int, step_id: int = 0) -> dict:
        """Per-gang rendezvous context (the PMIx role per SURVEY §2.4):
        compressed nodelist, per-node rank, and a deterministic
        rank-0 rendezvous endpoint — enough for members to enumerate
        each other and bootstrap a torch.distributed-style init."""
        from cranesched_tpu_torch.utils.hostlist import compress_hostlist
        nodes = self.scheduler.meta.nodes
        names = [nodes[n].name if n in nodes else f"?{n}"
                 for n in node_ids]
        # deterministic per-(job, step, incarnation) port in a high
        # range: two concurrent steps of one allocation must not share a
        # coordinator endpoint.  Hashing leaves no lattice correlation
        # between job ids, but the port space is 20000, so two
        # concurrently live gangs sharing a rank-0 host collide with
        # ~1/20000 probability per pair (birthday regime near ~170 such
        # gangs).  Residual risk accepted for the env-only bootstrap;
        # the fix-proper (rank-0 picks a free port and reports back)
        # needs a supervisor round-trip this path deliberately avoids
        incarnation = self.scheduler.running[job_id].requeue_count \
            if job_id in self.scheduler.running else 0
        import hashlib
        import secrets
        digest = hashlib.blake2b(
            f"{job_id}/{step_id}/{incarnation}".encode(),
            digest_size=8).digest()
        port = 28000 + (int.from_bytes(digest, "big") % 20000)
        return {
            "nodelist": compress_hostlist(names),
            "rank": {n: i for i, n in enumerate(node_ids)},
            "ntasks": ntasks,
            "rendezvous": f"{names[0]}:{port}" if names else "",
            # gates the rank-0 fence/modex service: unguessable,
            # one per dispatched gang
            "token": secrets.token_urlsafe(12),
        }

    def dispatch_step(self, job: Job, step) -> None:
        """Push one step into an existing allocation (the AllocSteps
        half).  Failure cancels just the step via step_report."""
        spec_pb = spec_to_pb(job.spec)
        step_pb = step_spec_to_pb(step.spec)
        incarnation = job.requeue_count
        epoch = self.scheduler.fencing_epoch
        node_ids = list(step.node_ids)
        step_id = step.step_id
        gang = self._gang_ctx(job.job_id, node_ids, len(node_ids),
                              step_id=step_id)

        def push():
            from cranesched_tpu_torch.ctld.defs import StepStatus
            errors = []
            for node_id in node_ids:
                stub = self._stub(node_id)
                if stub is None:
                    errors.append(f"node {node_id} has no stub")
                    continue
                req = pb.ExecuteStepRequest(
                    job_id=job.job_id, spec=spec_pb, tasks_on_node=1,
                    now=time.time(), incarnation=incarnation,
                    step_id=step_id, fencing_epoch=epoch,
                    nodelist=gang["nodelist"],
                    node_rank=gang["rank"][node_id],
                    nnodes=len(node_ids),
                    ntasks=gang["ntasks"],
                    rendezvous=gang["rendezvous"],
                    rendezvous_token=gang["token"])
                req.step.CopyFrom(step_pb)
                try:
                    reply = stub.call("ExecuteStep", req)
                except grpc.RpcError as exc:
                    errors.append(f"push to node {node_id}: {exc.code()}")
                    continue
                if not reply.ok:
                    self._note_fenced(node_id, reply.error)
                    errors.append(reply.error)
            if errors:
                for node_id in node_ids:
                    self._try_call(node_id, "TerminateStep",
                                   pb.JobIdRequest(job_id=job.job_id,
                                                   step_id=step_id,
                                                   incarnation=incarnation,
                                                   fencing_epoch=epoch))
                # enqueue, never mutate: this runs on a pool thread
                # without the server lock (step_report would race the
                # cycle thread's _try_start_steps and WAL writes)
                self.scheduler.step_report_async(
                    job.job_id, step_id, StepStatus.FAILED, 254,
                    time.time(), incarnation=incarnation)

        self._pool.submit(push)

    def terminate_step(self, job_id: int, step_id: int,
                       now: float) -> None:
        job = self.scheduler.running.get(job_id)
        if job is None:
            return
        step = job.steps.get(step_id)
        nodes = list(step.node_ids) if step is not None else []
        incarnation = job.requeue_count
        epoch = self.scheduler.fencing_epoch
        self._pool.submit(lambda: [
            self._try_call(n, "TerminateStep",
                           pb.JobIdRequest(job_id=job_id, step_id=step_id,
                                           incarnation=incarnation,
                                           fencing_epoch=epoch))
            for n in nodes])

    def free_alloc(self, job_id: int, now: float,
                   incarnation: int | None = None,
                   skip_node: int | None = None) -> None:
        """Release the allocation on every node (FreeJob fan-out)."""
        nodes = [n for n in self._job_nodes(job_id) if n != skip_node]
        epoch = self.scheduler.fencing_epoch
        req = (pb.JobIdRequest(job_id=job_id, incarnation=incarnation,
                               fencing_epoch=epoch)
               if incarnation is not None
               else pb.JobIdRequest(job_id=job_id, fencing_epoch=epoch))
        self._pool.submit(lambda: [
            self._try_call(n, "FreeJob", req) for n in nodes])

    def terminate(self, job_id: int, now: float,
                  incarnation: int | None = None,
                  skip_node: int | None = None) -> None:
        nodes = [n for n in self._job_nodes(job_id) if n != skip_node]
        epoch = self.scheduler.fencing_epoch
        req = (pb.JobIdRequest(job_id=job_id, incarnation=incarnation,
                               fencing_epoch=epoch)
               if incarnation is not None
               else pb.JobIdRequest(job_id=job_id, fencing_epoch=epoch))
        self._pool.submit(lambda: [
            self._try_call(n, "TerminateStep", req) for n in nodes])

    def suspend(self, job_id: int, now: float) -> None:
        nodes = self._job_nodes(job_id)
        epoch = self.scheduler.fencing_epoch
        self._pool.submit(lambda: [
            self._try_call(n, "SuspendStep",
                           pb.JobIdRequest(job_id=job_id,
                                           fencing_epoch=epoch))
            for n in nodes])

    def resume(self, job_id: int, now: float) -> None:
        nodes = self._job_nodes(job_id)
        epoch = self.scheduler.fencing_epoch
        self._pool.submit(lambda: [
            self._try_call(n, "ResumeStep",
                           pb.JobIdRequest(job_id=job_id,
                                           fencing_epoch=epoch))
            for n in nodes])

    def change_time_limit(self, job_id: int, time_limit: float,
                          now: float) -> None:
        """Push a modified deadline to the job's batch supervisors
        (reference ChangeJobTimeConstraint, Crane.proto:1654).  The push
        can beat the supervisor spawn (the craned then answers
        ok=False), so the scheduler renews the intent each cycle; once
        EVERY node accepts, the intent is popped here."""
        job = self.scheduler.running.get(job_id)
        if job is None:
            return
        nodes = list(job.node_ids)
        incarnation = job.requeue_count
        epoch = self.scheduler.fencing_epoch
        request = pb.TimeLimitRequest(job_id=job_id,
                                      time_limit=time_limit,
                                      incarnation=incarnation,
                                      fencing_epoch=epoch)

        def push():
            all_ok = True
            for n in nodes:
                stub = self._stub(n)
                if stub is None:
                    all_ok = False
                    continue
                try:
                    reply = stub.call("ChangeTimeLimit", request)
                    all_ok &= bool(reply.ok)
                except grpc.RpcError:
                    all_ok = False
            if all_ok:
                # racy-but-benign pop: a concurrent renewal just sends
                # one extra idempotent update
                self.scheduler._limit_intents.pop(job_id, None)

        self._pool.submit(push)

    def _job_nodes(self, job_id: int) -> list[int]:
        job = self.scheduler.running.get(job_id)
        return list(job.node_ids) if job is not None else []

    def _note_fenced(self, node_id, error: str) -> None:
        """Surface a craned-side fencing rejection in the event ring:
        the craned is a separate process, so the ctld whose push was
        refused is the one that can record it (the deposed leader's
        ring — the test harness and post-mortems read it there)."""
        if not error or not error.startswith("fenced"):
            return
        try:
            self.scheduler.events.emit("fencing_rejection", "error",
                                       node=str(node_id), detail=error)
        except Exception:
            pass  # observability must never break a dispatch path

    def _try_call(self, node_id, name, request) -> None:
        stub = self._stub(node_id)
        if stub is None:
            return
        try:
            reply = stub.call(name, request)
        except grpc.RpcError:
            return  # the ping timeout will reap a dead node
        if not getattr(reply, "ok", True):
            self._note_fenced(node_id, reply.error)

    def close(self) -> None:
        self._pool.shutdown(wait=False)
        with self._lock:
            for stub in self._stubs.values():
                stub.close()
