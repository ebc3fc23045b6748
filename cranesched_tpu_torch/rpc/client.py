"""Client stub for the CraneCtld service (hand-glued; used by the CLI
and by node daemons).

:class:`HaCtldClient` wraps one :class:`CtldClient` per configured ctld
address and retries leader-affine: a call that fails with UNAVAILABLE
(endpoint dead) or FAILED_PRECONDITION (a standby's not-leader refusal)
rotates to the next address, so cbatch/cqueue keep working across a
failover without the caller knowing which ctld currently leads.
"""

from __future__ import annotations

import grpc

from cranesched_tpu_torch.rpc import crane_pb2 as pb
from cranesched_tpu_torch.rpc.consts import SERVICE
from cranesched_tpu_torch.rpc.stub import GrpcStub


class StreamResult:
    """Out-parameter for streaming queries: did the server truncate?"""

    truncated = False


class CtldClient:
    def __init__(self, address: str, timeout: float = 30.0,
                 token: str = "", tls=None,
                 max_receive_bytes: int | None = None,
                 local_subchannels: bool = False):
        self.address = address
        self.timeout = timeout
        self._stub = GrpcStub(address, SERVICE, timeout, token=token,
                              tls=tls, max_receive_bytes=max_receive_bytes,
                              local_subchannels=local_subchannels)
        # kept for tests that introspect the channel
        self._channel = self._stub._channel

    def close(self) -> None:
        self._stub.close()

    def _call(self, name, request, reply_cls):
        return self._stub.call(name, request, reply_cls)

    # ---- external ----

    def submit(self, spec: pb.JobSpec, forwarded: bool = False,
               forwarded_at: float = 0.0,
               forwarded_from: str = "") -> pb.SubmitJobReply:
        return self._call(
            "SubmitBatchJob",
            pb.SubmitJobRequest(spec=spec, forwarded=forwarded,
                                forwarded_at=forwarded_at,
                                forwarded_from=forwarded_from),
            pb.SubmitJobReply)

    def submit_many(self, specs) -> pb.SubmitJobsReply:
        return self._call("SubmitBatchJobs",
                          pb.SubmitJobsRequest(specs=list(specs)),
                          pb.SubmitJobsReply)

    def cancel(self, job_id: int) -> pb.OkReply:
        return self._call("CancelJob", pb.JobIdRequest(job_id=job_id),
                          pb.OkReply)

    def hold(self, job_id: int, held: bool = True) -> pb.OkReply:
        return self._call("HoldJob",
                          pb.HoldRequest(job_id=job_id, held=held),
                          pb.OkReply)

    def modify_job(self, job_id: int, time_limit: float | None = None,
                   priority: int | None = None,
                   partition: str | None = None) -> pb.OkReply:
        req = pb.ModifyJobRequest(job_id=job_id)
        if time_limit is not None:
            req.time_limit = time_limit
        if priority is not None:
            req.priority = priority
        if partition is not None:
            req.partition = partition
        return self._call("ModifyJob", req, pb.OkReply)

    def suspend(self, job_id: int) -> pb.OkReply:
        return self._call("SuspendJob", pb.JobIdRequest(job_id=job_id),
                          pb.OkReply)

    def resume(self, job_id: int) -> pb.OkReply:
        return self._call("ResumeJob", pb.JobIdRequest(job_id=job_id),
                          pb.OkReply)

    def query_jobs(self, job_ids=(), user: str = "", partition: str = "",
                   include_history: bool = False, limit: int = 0,
                   after_job_id: int = 0,
                   max_staleness: float = 0.0) -> pb.QueryJobsReply:
        return self._call(
            "QueryJobsInfo",
            pb.QueryJobsRequest(job_ids=list(job_ids), user=user,
                                partition=partition,
                                include_history=include_history,
                                limit=limit,
                                after_job_id=after_job_id,
                                max_staleness=max_staleness),
            pb.QueryJobsReply)

    def query_jobs_stream(self, job_ids=(), user: str = "",
                          partition: str = "",
                          include_history: bool = False,
                          limit: int = 0, after_job_id: int = 0,
                          result=None, max_staleness: float = 0.0):
        """Yield JobInfo messages from the server-streaming query
        (chunked on the wire; flattened here).  Pass a
        ``StreamResult`` as ``result`` to learn whether the server
        truncated (more rows exist past the last yielded id)."""
        request = pb.QueryJobsRequest(
            job_ids=list(job_ids), user=user, partition=partition,
            include_history=include_history, limit=limit,
            after_job_id=after_job_id, max_staleness=max_staleness)
        for reply in self._stub.call_stream("QueryJobsStream", request,
                                            pb.QueryJobsReply):
            if reply.truncated and result is not None:
                result.truncated = True
            yield from reply.jobs

    def query_cluster(self, max_staleness: float = 0.0
                      ) -> pb.QueryClusterReply:
        return self._call(
            "QueryClusterInfo",
            pb.QueryClusterRequest(max_staleness=max_staleness),
            pb.QueryClusterReply)

    def create_reservation(self, name, partition, node_names, start_time,
                           end_time, allowed_accounts=(),
                           denied_accounts=()) -> pb.OkReply:
        return self._call(
            "CreateReservation",
            pb.CreateReservationRequest(
                name=name, partition=partition,
                node_names=list(node_names), start_time=start_time,
                end_time=end_time,
                allowed_accounts=list(allowed_accounts),
                denied_accounts=list(denied_accounts)),
            pb.OkReply)

    def delete_reservation(self, name: str) -> pb.OkReply:
        return self._call("DeleteReservation", pb.NameRequest(name=name),
                          pb.OkReply)

    def modify_node(self, name: str, action: str) -> pb.OkReply:
        return self._call("ModifyNode",
                          pb.ModifyNodeRequest(name=name, action=action),
                          pb.OkReply)

    def query_stats(self, max_staleness: float = 0.0) -> pb.StatsReply:
        return self._call("QueryStats",
                          pb.StatsRequest(max_staleness=max_staleness),
                          pb.StatsReply)

    def acct_mgr(self, actor: str, action: str,
                 payload: dict | None = None) -> pb.AcctMgrReply:
        import json as _json
        return self._call(
            "AcctMgr",
            pb.AcctMgrRequest(actor=actor, action=action,
                              payload=_json.dumps(payload or {})),
            pb.AcctMgrReply)

    def craned_health(self, node_id: int, healthy: bool,
                      message: str = "") -> pb.OkReply:
        return self._call(
            "CranedHealth",
            pb.CranedHealthRequest(node_id=node_id, healthy=healthy,
                                   message=message),
            pb.OkReply)

    # ---- internal ----

    def craned_register(self, name, total: pb.ResourceSpec,
                        partitions=("default",)
                        ) -> pb.CranedRegisterReply:
        return self._call(
            "CranedRegister",
            pb.CranedRegisterRequest(name=name, total=total,
                                     partitions=list(partitions)),
            pb.CranedRegisterReply)

    def craned_ping(self, node_id: int) -> pb.OkReply:
        return self._call("CranedPing",
                          pb.CranedPingRequest(node_id=node_id),
                          pb.OkReply)

    def step_status_change(self, job_id, status, exit_code, time,
                           node_id: int = -1, incarnation: int = 0,
                           step_id: int | None = None,
                           cpu_seconds: float = 0.0,
                           max_rss_bytes: int = 0,
                           spans=()) -> pb.OkReply:
        req = pb.StepStatusChangeRequest(job_id=job_id, status=status,
                                         exit_code=exit_code, time=time,
                                         node_id=node_id,
                                         incarnation=incarnation,
                                         cpu_seconds=cpu_seconds,
                                         max_rss_bytes=max_rss_bytes)
        if step_id is not None:
            req.step_id = step_id
        # craned-side lifecycle spans (obs/jobtrace.py ship-back)
        for s in spans or ():
            req.spans.append(pb.JobSpan(
                edge=s["edge"], seq=int(s["seq"]), time=float(s["t"]),
                node_id=int(s.get("node_id", -1)),
                skew=float(s.get("skew", 0.0))))
        return self._call("StepStatusChange", req, pb.OkReply)

    # ---- steps within an allocation ----

    def submit_step(self, job_id: int,
                    spec: pb.StepSpec) -> pb.SubmitStepReply:
        return self._call("SubmitStep",
                          pb.SubmitStepRequest(job_id=job_id, spec=spec),
                          pb.SubmitStepReply)

    def query_steps(self, job_id: int) -> pb.QueryStepsReply:
        return self._call("QueryStepsInfo",
                          pb.QueryStepsRequest(job_id=job_id),
                          pb.QueryStepsReply)

    def cancel_step(self, job_id: int, step_id: int) -> pb.OkReply:
        return self._call("CancelStep",
                          pb.JobIdRequest(job_id=job_id, step_id=step_id),
                          pb.OkReply)

    def free_allocation(self, job_id: int) -> pb.OkReply:
        return self._call("FreeAllocation",
                          pb.JobIdRequest(job_id=job_id), pb.OkReply)

    def issue_token(self, user: str) -> pb.TokenReply:
        return self._call("IssueToken", pb.IssueTokenRequest(user=user),
                          pb.TokenReply)

    def revoke_token(self, user: str) -> pb.OkReply:
        return self._call("RevokeToken",
                          pb.IssueTokenRequest(user=user), pb.OkReply)

    def tick(self, now: float) -> pb.TickReply:
        return self._call("Tick", pb.TickRequest(now=now), pb.TickReply)

    # ---- HA + summary ----

    def requeue(self, job_id: int) -> pb.OkReply:
        return self._call("RequeueJob", pb.JobIdRequest(job_id=job_id),
                          pb.OkReply)

    def query_job_summary(self, user: str = "", partition: str = "",
                          job_id: int = 0, max_staleness: float = 0.0
                          ) -> pb.QueryJobSummaryReply:
        """job_id != 0 additionally returns that job's timeline as
        JSON (standby-servable, like the summary itself)."""
        return self._call(
            "QueryJobSummary",
            pb.QueryJobSummaryRequest(user=user, partition=partition,
                                      job_id=job_id,
                                      max_staleness=max_staleness),
            pb.QueryJobSummaryReply)

    def ha_status(self) -> pb.HaStatusReply:
        return self._call("HaStatus", pb.HaStatusRequest(),
                          pb.HaStatusReply)

    def ha_fetch_snapshot(self) -> pb.HaSnapshotReply:
        return self._call("HaFetchSnapshot", pb.HaSnapshotRequest(),
                          pb.HaSnapshotReply)

    def ha_fetch_wal(self, after_seq: int, limit: int = 0,
                     after_event_seq: int = 0) -> pb.HaFetchReply:
        return self._call(
            "HaFetchWal",
            pb.HaFetchRequest(after_seq=after_seq, limit=limit,
                              after_event_seq=after_event_seq),
            pb.HaFetchReply)

    def query_events(self, severity: str = "", since: float = 0.0,
                     after_seq: int = 0, limit: int = 0,
                     type: str = "",
                     max_staleness: float = 0.0) -> pb.QueryEventsReply:
        """Structured cluster-event ring (standby-servable)."""
        return self._call(
            "QueryEvents",
            pb.QueryEventsRequest(severity=severity, since=since,
                                  after_seq=after_seq, limit=limit,
                                  type=type,
                                  max_staleness=max_staleness),
            pb.QueryEventsReply)

    def capture_profile(self, cycles: int = 1,
                        dir: str = "") -> pb.CaptureProfileReply:
        """Arm a torch.profiler window over the next N cycles."""
        return self._call(
            "CaptureProfile",
            pb.CaptureProfileRequest(cycles=cycles, dir=dir),
            pb.CaptureProfileReply)

    # ---- federation (fed/) ----

    def query_shard_map(self) -> pb.QueryShardMapReply:
        return self._call("QueryShardMap", pb.QueryShardMapRequest(),
                          pb.QueryShardMapReply)

    def lease_nodes(self, lease_id: str, partition: str, node_num: int,
                    res: pb.ResourceSpec | None = None,
                    ttl: float = 0.0) -> pb.LeaseNodesReply:
        req = pb.LeaseNodesRequest(lease_id=lease_id, partition=partition,
                                   node_num=node_num, ttl=ttl)
        if res is not None:
            req.res.CopyFrom(res)
        return self._call("LeaseNodes", req, pb.LeaseNodesReply)

    def confirm_gang(self, lease_id: str, gang_id: str,
                     spec: pb.JobSpec, node_names=(),
                     fencing_epoch: int = 0) -> pb.ConfirmGangReply:
        return self._call(
            "ConfirmGang",
            pb.ConfirmGangRequest(lease_id=lease_id, gang_id=gang_id,
                                  spec=spec,
                                  node_names=list(node_names),
                                  fencing_epoch=fencing_epoch),
            pb.ConfirmGangReply)

    def release_lease(self, lease_id: str,
                      fencing_epoch: int = 0) -> pb.OkReply:
        return self._call(
            "ReleaseLease",
            pb.ReleaseLeaseRequest(lease_id=lease_id,
                                   fencing_epoch=fencing_epoch),
            pb.OkReply)

    def fetch_usage(self, shard: str = "") -> pb.FetchUsageReply:
        """This shard's usage-gossip summary (cluster-wide
        accounting).  ``shard`` names the PULLING shard — serving the
        fetch is confirmed delivery to it, which is what releases the
        server's publish-slack throttle; leave it empty for a CLI
        query that should ack nobody."""
        return self._call("FetchUsage",
                          pb.FetchUsageRequest(shard=shard),
                          pb.FetchUsageReply)

    def migrate_partition(self, partition: str, dest_shard: str,
                          phase: str = "", payload: str = "",
                          mid: str = "") -> pb.MigratePartitionReply:
        """Live partition migration: ``phase=""`` drives the whole
        handoff (dial the source shard), ``phase="import"`` ships an
        exported payload to the destination (shard-to-shard), and
        ``phase="query"`` asks the destination whether it durably
        adopted handoff ``mid`` (the source's resolution path)."""
        return self._call(
            "MigratePartition",
            pb.MigratePartitionRequest(partition=partition,
                                       dest_shard=dest_shard,
                                       phase=phase, payload=payload,
                                       mid=mid),
            pb.MigratePartitionReply)


# gRPC codes that mean "try the next ctld": the endpoint is down/
# unreachable, or it answered but refused as a standby
_ROTATE_CODES = (grpc.StatusCode.UNAVAILABLE,
                 grpc.StatusCode.FAILED_PRECONDITION,
                 grpc.StatusCode.DEADLINE_EXCEEDED)


class HaCtldClient(CtldClient):
    """Leader-finding client over a list of ctld addresses.

    Shares :class:`CtldClient`'s full method surface — only ``_call``
    (and the stream dial) differ: the sticky index remembers the last
    address that answered as leader, and every failure in
    ``_ROTATE_CODES`` advances it.  One full rotation without an answer
    re-raises the last error.
    """

    def __init__(self, addresses, timeout: float = 30.0,
                 token: str = "", tls=None):
        if isinstance(addresses, str):
            addresses = [a.strip() for a in addresses.split(",")
                         if a.strip()]
        if not addresses:
            raise ValueError("HaCtldClient needs at least one address")
        self.addresses = list(addresses)
        self.timeout = timeout
        self._token = token
        self._tls = tls
        self._idx = 0
        self._clients: dict[int, CtldClient] = {}
        # CtldClient API compat (tests introspect .address/._stub)
        self.address = self.addresses[0]
        # federation routing: partition -> shard leader address,
        # learned from SubmitJobReply redirect hints (or pre-seeded by
        # learn_shard_map); addresses here may lie OUTSIDE the HA
        # rotation list, so their clients live in their own cache
        self._shard_routes: dict[str, str] = {}
        self._route_clients: dict[str, CtldClient] = {}
        # the shard-map epoch the routes were learned at: a reply
        # stamped with a NEWER epoch means a live partition migration
        # flipped the map — re-learn instead of redirect-bouncing
        self._map_epoch = 0

    def _at(self, idx: int) -> CtldClient:
        cli = self._clients.get(idx)
        if cli is None:
            cli = CtldClient(self.addresses[idx], timeout=self.timeout,
                             token=self._token, tls=self._tls)
            self._clients[idx] = cli
        return cli

    @property
    def _stub(self):
        return self._at(self._idx)._stub

    def close(self) -> None:
        for cli in self._clients.values():
            cli.close()
        self._clients.clear()
        for cli in self._route_clients.values():
            cli.close()
        self._route_clients.clear()

    # -- federation: shard-aware submit routing --

    def learn_shard_map(self) -> int:
        """Pre-seed partition routes from any reachable ctld's
        QueryShardMap.  Returns the number of partitions learned (0 on
        a non-federated cluster)."""
        try:
            reply = self.query_shard_map()
        except grpc.RpcError:
            return 0
        n = 0
        self._shard_routes.clear()
        self._map_epoch = reply.map_epoch
        for shard in reply.shards:
            if not shard.address:
                continue
            for part in shard.partitions:
                self._shard_routes[part] = shard.address
                n += 1
        return n

    def _route(self, address: str) -> CtldClient:
        cli = self._route_clients.get(address)
        if cli is None:
            cli = CtldClient(address, timeout=self.timeout,
                             token=self._token, tls=self._tls)
            self._route_clients[address] = cli
        return cli

    def submit(self, spec: pb.JobSpec, forwarded: bool = False,
               forwarded_at: float = 0.0,
               forwarded_from: str = "") -> pb.SubmitJobReply:
        """Route the submit to the partition's owning shard when the
        route is known; otherwise fall back to the HA rotation (the
        server forwards misrouted submits and answers with a redirect
        hint, which teaches us the route for next time)."""
        addr = self._shard_routes.get(spec.partition)
        if addr:
            try:
                reply = self._route(addr).submit(
                    spec, forwarded=forwarded,
                    forwarded_at=forwarded_at,
                    forwarded_from=forwarded_from)
                if reply.map_epoch > self._map_epoch:
                    self.learn_shard_map()
                if reply.redirect_address:
                    self._shard_routes[spec.partition] = \
                        reply.redirect_address
                return reply
            except grpc.RpcError as e:
                if e.code() not in _ROTATE_CODES:
                    raise
                # the learned route went stale — drop it and fall back
                self._shard_routes.pop(spec.partition, None)
                cli = self._route_clients.pop(addr, None)
                if cli is not None:
                    try:
                        cli.close()
                    except Exception:
                        pass
        reply = super().submit(spec, forwarded=forwarded,
                               forwarded_at=forwarded_at,
                               forwarded_from=forwarded_from)
        if reply.redirect_address:
            self._shard_routes[spec.partition] = reply.redirect_address
        if reply.map_epoch > self._map_epoch:
            # a migration flipped the map since we learned it: refresh
            # every route in one query rather than paying a redirect
            # bounce per moved partition
            self.learn_shard_map()
        return reply

    def _call(self, name, request, reply_cls):
        last_err = None
        for attempt in range(len(self.addresses)):
            idx = (self._idx + attempt) % len(self.addresses)
            try:
                reply = self._at(idx)._call(name, request, reply_cls)
            except grpc.RpcError as e:
                if e.code() not in _ROTATE_CODES:
                    raise
                last_err = e
                # drop the dead channel so a later retry re-dials
                cli = self._clients.pop(idx, None)
                if cli is not None:
                    try:
                        cli.close()
                    except Exception:
                        pass
                continue
            self._idx = idx
            self.address = self.addresses[idx]
            return reply
        raise last_err

    def query_jobs_stream(self, *args, **kwargs):
        """The streaming query dials ``self._stub`` directly, so it
        needs its own rotation: a stream that dies BEFORE yielding a
        row advances to the next address (cqueue right after a
        failover); one that dies mid-stream re-raises — the caller
        must not see a silently restarted (duplicated) listing."""
        last_err = None
        for attempt in range(len(self.addresses)):
            idx = (self._idx + attempt) % len(self.addresses)
            yielded = False
            try:
                for item in self._at(idx).query_jobs_stream(*args,
                                                            **kwargs):
                    yielded = True
                    yield item
            except grpc.RpcError as e:
                if yielded or e.code() not in _ROTATE_CODES:
                    raise
                last_err = e
                cli = self._clients.pop(idx, None)
                if cli is not None:
                    try:
                        cli.close()
                    except Exception:
                        pass
                continue
            self._idx = idx
            self.address = self.addresses[idx]
            return
        raise last_err


def make_client(addresses, timeout: float = 30.0, token: str = "",
                tls=None) -> CtldClient:
    """One address -> plain client; a comma-separated list (or an
    actual list) -> failover-aware :class:`HaCtldClient`."""
    if isinstance(addresses, str):
        parts = [a.strip() for a in addresses.split(",") if a.strip()]
    else:
        parts = list(addresses)
    if len(parts) == 1:
        return CtldClient(parts[0], timeout=timeout, token=token,
                          tls=tls)
    return HaCtldClient(parts, timeout=timeout, token=token, tls=tls)
