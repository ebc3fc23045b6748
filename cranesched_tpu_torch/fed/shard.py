"""Per-shard lease plane: the shard-side half of the arbiter's
two-phase cross-partition gang commit.

A shard owns its partitions outright — local jobs schedule through the
normal cycle with no federation awareness.  The only cross-shard
authority is the placement arbiter, and its entire contract with a
shard is three operations grafted onto the local ``JobScheduler`` here:

``lease_nodes``
    Reserve concrete nodes for an arbiter solve.  The reservation is a
    durable ``fed_reserve`` WAL record plus ``NodeMeta.fed_leased``
    flags; the flag folds into ``schedulable``, so leased nodes vanish
    from the local snapshot AND fail local mallocs — a shard cycle can
    never race the arbiter onto a leased node.  The lease carries the
    shard's CURRENT fencing epoch and a TTL: a dead arbiter's leases
    self-expire, and a confirm under a stale epoch is refused (the
    dispatch-ring fencing discipline, reused).

``confirm_gang``
    Turn one lease into a RUNNING local gang member.  The member is a
    normal local job (submitted, committed, WAL'd, dispatched through
    the ordinary dispatch ring) created inside one WAL group together
    with the ``fed_confirm`` record — the ONLY record that creates a
    job.  A crash before the group's fsync leaves a bare reserve, which
    recovery drops; a crash after leaves the job durable exactly once.
    Never double-placed, never half-placed.

``release_lease``
    Drop an unconfirmed reservation (arbiter abort, TTL expiry, or
    recovery finding a reserve without a confirm).

Recovery: :meth:`recover` replays ``fed_*`` records after the normal
job replay.  Leases whose last record is ``fed_reserve`` are released
(durable ``fed_release`` tombstone) — their gang was never committed
here, and the arbiter's own retry logic re-places it from scratch.

Live partition migration (fed/rebalance.py drives it) adds a second
WAL protocol on the same plane.  A partition moves shard-to-shard in
four durable phases, each its own record:

``fed_migrate_begin`` (source)
    The partition is sealed — local submits refuse, arbiter leases on
    its nodes release — and the intent (mid, dest, job_ids) is durable.

``fed_migrate_import`` (dest)
    The ONLY record that creates jobs on the destination.  The import
    validates and mallocs EVERY job first, before a single record is
    appended — a refusal (unknown node, placement that no longer
    fits) rolls the mallocs back and writes NOTHING, so a structured
    import error genuinely means "not adopted".  Then the whole
    handoff lands in one WAL group: node inventory adopted by NAME
    (ids are shard-local), every pending/running job re-created under
    a fresh dest-local id, then the import record.  A crash before
    the group's fsync imports nothing; after, everything — never half
    a partition.

``fed_migrate_commit`` (source)
    Written once the dest durably holds the jobs and the successor map
    is live.  The source then DROPS the migrated jobs — resources,
    licenses, run limits, submit slots freed; no terminal stamps, this
    is removal, not completion — and marks the partition's nodes dead.
    ``compact`` keeps this record forever: it is what filters the
    migrated jobs out of every future source replay.

``fed_migrate_abort`` (source)
    The handoff never reached the dest: unseal, keep everything.

A source SIGKILL mid-handoff leaves a begin without commit/abort;
recovery surfaces it and the coordinator/resolver settles it by
asking the dest :meth:`has_import` — imported means commit (the jobs
live there), not imported means abort (they never left).  Exactly one
shard ends up owning every job either way.

Recovery splits in two around the ordinary job replay:

:meth:`prepare_recovery`
    BEFORE ``scheduler.recover``: rebuild imported partitions' node
    meta (in original adoption order, so node ids renumber
    identically and replayed placements stay valid), filter
    committed-migration job_ids out of the replay (they live on the
    dest now), re-seal in-flight/migrated partitions, and re-seed the
    imports/begun tables.  State comes from the HA snapshot's ``fed``
    document first — the snapshotter prunes WAL segments a snapshot
    covers, fed_migrate_* records included — then the surviving WAL
    records overlay it.

:meth:`recover_migrations`
    AFTER ``scheduler.recover``: re-mark migrated-away partitions'
    nodes dead and surface begins with no commit/abort as
    :attr:`unresolved_migrations` for the resolver.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from cranesched_tpu_torch.ctld.defs import (
    DEP_NEVER,
    JobSpec,
    JobStatus,
    PendingReason,
)
from cranesched_tpu_torch.ctld.meta import ResReduceEvent
from cranesched_tpu_torch.ctld.wal import (
    WriteAheadLog,
    _job_from_dict,
    _job_to_dict,
)
from cranesched_tpu_torch.obs import REGISTRY as _OBS

_MET_LEASES = _OBS.counter(
    "crane_fed_leases_granted_total",
    "arbiter node leases granted by this shard")
_MET_REVOKED = _OBS.counter(
    "crane_fed_leases_revoked_total",
    "arbiter node leases released, expired, or dropped by recovery")
_MET_MIG_JOBS = _OBS.counter(
    "crane_fed_migrated_jobs_total",
    "jobs adopted by this shard through live partition migration")


@dataclasses.dataclass
class Lease:
    """One live reservation: which nodes, under which fencing epoch,
    and when the shard self-expires it."""

    lease_id: str
    partition: str
    node_ids: list[int]
    epoch: int
    deadline: float
    seq: int = 0  # the fed_reserve record's WAL seq
    reserved_at: float = 0.0  # when granted (the arbiter_reserve span)


class FedShardPlane:
    """Lease/confirm/release surface grafted onto one shard's
    JobScheduler.  Callers (the RPC handlers, the in-process sim) hold
    the shard's server lock — the plane itself is lock-free."""

    def __init__(self, scheduler, shard_name: str):
        self.scheduler = scheduler
        self.shard = shard_name
        scheduler.shard_name = shard_name
        scheduler.fed = self
        self.leases: dict[str, Lease] = {}
        #: mid -> dest-local job ids adopted (the source's crash
        #: recovery asks :meth:`has_import` to resolve a bare begin)
        self.imports: dict[str, list[int]] = {}
        #: partitions this shard handed away (their nodes stay in meta,
        #: dead, so shard-local node ids never renumber)
        self.migrated_away: set[str] = set()
        #: ordered adoption records (mid, partition, priority, nodes)
        #: — the HA snapshot carries these so a dest restart can
        #: rebuild imported node meta even after the covering WAL
        #: segments were pruned; order IS the node-id renumbering
        self.import_meta: list[dict] = []
        #: mid -> begin payload for migrations this shard STARTED and
        #: has not yet committed/aborted; snapshotted alongside
        #: import_meta so an in-flight begin survives segment pruning
        self.begun: dict[str, dict] = {}
        #: begins recovery could not settle locally — the partition
        #: stays sealed until a resolver confirms the dest's
        #: has_import answer (rpc/server.py's resolve loop, the
        #: coordinator's resolve(), or an operator)
        self.unresolved_migrations: list[dict] = []

    # -- reserve --

    def free_count(self, partition: str, req: np.ndarray) -> int:
        """How many nodes of ``partition`` could be leased for a
        per-node requirement ``req`` right now (advisory — the answer
        can go stale the moment the lock drops; the arbiter treats it
        as a split hint, never a promise)."""
        part = self.scheduler.meta.partitions.get(partition)
        if part is None:
            return 0
        nodes = self.scheduler.meta.nodes
        return sum(1 for nid in part.node_ids
                   if nodes[nid].schedulable
                   and (req <= nodes[nid].avail).all())

    def lease_nodes(self, lease_id: str, partition: str, node_num: int,
                    req: np.ndarray, ttl: float, now: float):
        """Reserve ``node_num`` schedulable nodes of ``partition`` with
        ``avail >= req`` each.  Returns (node_names, epoch, durable_seq)
        or raises ValueError with the refusal reason."""
        self.expire(now)
        sched = self.scheduler
        meta = sched.meta
        if lease_id in self.leases:
            raise ValueError(f"lease {lease_id!r} already held")
        part = meta.partitions.get(partition)
        if part is None:
            raise ValueError(f"partition {partition!r} not owned by "
                             f"shard {self.shard!r}")
        chosen: list[int] = []
        for nid in sorted(part.node_ids):
            node = meta.nodes[nid]
            if node.schedulable and (req <= node.avail).all():
                chosen.append(nid)
                if len(chosen) == node_num:
                    break
        if len(chosen) < node_num:
            raise ValueError(
                f"{partition}: only {len(chosen)}/{node_num} nodes free")
        names = []
        for nid in chosen:
            node = meta.nodes[nid]
            node.fed_leased = lease_id
            # same revalidation trigger as a node death: an in-flight
            # local cycle must not commit onto a node leased mid-solve
            meta._log_event(ResReduceEvent(nid))
            names.append(node.name)
        epoch = sched.fencing_epoch
        deadline = now + ttl if ttl > 0 else float("inf")
        seq = 0
        if sched.wal is not None:
            seq = sched.wal.fed_event("fed_reserve", {
                "lease_id": lease_id, "partition": partition,
                "node_names": names, "epoch": epoch,
                "deadline": deadline})
        self.leases[lease_id] = Lease(lease_id, partition, list(chosen),
                                      epoch, deadline, seq,
                                      reserved_at=now)
        sched.events.emit(
            "fed_lease_granted", "info", time=now,
            detail=f"lease={lease_id} part={partition} "
                   f"nodes={len(chosen)} epoch={epoch}")
        _MET_LEASES.inc()
        return names, epoch, seq

    # -- confirm (phase two) --

    def confirm_gang(self, lease_id: str, gang_id: str, spec: JobSpec,
                     node_names: list[str], now: float,
                     epoch: int = 0) -> int:
        """Commit one gang member onto (a subset of) a lease's nodes.
        Returns the shard-local job id; raises ValueError on refusal —
        the lease stays held for the arbiter to release."""
        sched = self.scheduler
        meta = sched.meta
        lease = self.leases.get(lease_id)
        if lease is None:
            raise ValueError(f"no such lease {lease_id!r}")
        if epoch and epoch != sched.fencing_epoch:
            raise ValueError(
                f"fencing: lease epoch {epoch} != current "
                f"{sched.fencing_epoch}")
        if not node_names:
            node_ids = list(lease.node_ids)
        else:
            name_to_id = meta._name_to_id
            node_ids = []
            for name in node_names:
                nid = name_to_id.get(name)
                if nid is None or nid not in lease.node_ids:
                    raise ValueError(f"node {name!r} not in lease")
                node_ids.append(nid)
        # the whole lease returns to the local pool NOW: the confirmed
        # subset is about to be malloc'd to the member, the rest frees.
        # Safe against local racing because the caller holds the shard's
        # server lock until the commit below is durable.
        for nid in lease.node_ids:
            meta.nodes[nid].fed_leased = ""
        del self.leases[lease_id]

        wal = sched.wal
        try:
            if wal is not None:
                wal.begin_batch()
            job_id = sched.submit(spec, now)
            if not job_id:
                raise ValueError("member spec rejected by submit")
            job = sched.pending[job_id]
            # the _commit_preemption template, minus eviction: admission
            # first, then malloc with the leased nodes
            if job.spec.licenses and not sched.licenses.malloc(
                    job.spec.licenses):
                sched.cancel(job_id, now)
                raise ValueError("licenses exhausted")
            if not sched._malloc_run_limits(job):
                sched.licenses.free(job.spec.licenses or {})
                sched.cancel(job_id, now)
                raise ValueError("QoS run limit")
            job.node_ids = list(node_ids)
            job.alloc_cache = None
            if not meta.malloc_resource(job.job_id, node_ids,
                                        sched._job_alloc(job)):
                sched.licenses.free(job.spec.licenses or {})
                sched._free_run_limits(job)
                job.node_ids = []
                job.alloc_cache = None
                sched.cancel(job_id, now)
                raise ValueError("leased nodes no longer fit the spec")
            del sched.pending[job_id]
            job.status = JobStatus.RUNNING
            job.start_time = now
            job.pending_reason = PendingReason.NONE
            sched._init_steps(job, now)
            sched.running[job_id] = job
            sched._ledger_add(job, now)
            if wal is not None:
                wal.job_started(job)
                wal.fed_event("fed_confirm", {
                    "lease_id": lease_id, "gang_id": gang_id,
                    "job_id": job_id, "epoch": sched.fencing_epoch})
            if sched.jobtrace is not None:
                # the arbiter's two-phase hop, spanned on the member's
                # own timeline (sequenced BEFORE placed so the
                # waterfall reads reserve -> confirm -> placed):
                # arbiter_reserve at lease-grant time, arbiter_confirm
                # now — their gap is the cross-shard coordination cost
                sched.jobtrace.stamp(
                    job_id, job.requeue_count, "arbiter_reserve",
                    lease.reserved_at or now,
                    epoch=lease.epoch)
                sched.jobtrace.stamp(
                    job_id, job.requeue_count, "arbiter_confirm", now,
                    epoch=sched.fencing_epoch)
                sched.jobtrace.stamp(job_id, job.requeue_count, "placed",
                                     now, epoch=sched.fencing_epoch)
            sched._trigger_dep_event(job)
            sched._queue_dispatch(job, node_ids)
        finally:
            if wal is not None:
                wal.commit_batch()
        # durable-before-dispatch, the dispatch-ring discipline: the
        # group's fsync returned above, so the drain pushes immediately
        sched._drain_dispatch_ring()
        return job_id

    # -- release / expiry / recovery --

    def release_lease(self, lease_id: str, now: float,
                      detail: str = "released") -> bool:
        sched = self.scheduler
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return False
        for nid in lease.node_ids:
            node = sched.meta.nodes.get(nid)
            if node is not None and node.fed_leased == lease_id:
                node.fed_leased = ""
        if sched.wal is not None:
            sched.wal.fed_event("fed_release", {
                "lease_id": lease_id, "epoch": lease.epoch})
        sched.events.emit(
            "fed_lease_revoked", "warning", time=now,
            detail=f"lease={lease_id} {detail}")
        _MET_REVOKED.inc()
        if sched.cycle_kick is not None:
            sched.cycle_kick()  # freed nodes may unblock local pending
        return True

    def expire(self, now: float) -> int:
        """Drop leases past their TTL (a dead arbiter never holds
        capacity hostage).  Returns the number expired."""
        due = [lid for lid, lease in self.leases.items()
               if lease.deadline <= now]
        for lid in due:
            self.release_lease(lid, now, detail="ttl expired")
        return len(due)

    def recover(self, now: float) -> int:
        """Post-replay cleanup: any lease whose last WAL record is a
        bare ``fed_reserve`` was reserved but never confirmed before the
        crash — write its release tombstone.  (Only ``fed_confirm``
        creates a job, so nothing placed can be lost here; the arbiter
        re-places the gang against fresh leases.)  Returns the number of
        leases dropped."""
        sched = self.scheduler
        if sched.wal is None:
            return 0
        dropped = 0
        state = sched.wal.replay_fed(sched.wal.path)
        for lease_id, (ev, payload) in sorted(state.items()):
            if ev != "fed_reserve":
                continue
            sched.wal.fed_event("fed_release", {
                "lease_id": lease_id,
                "epoch": payload.get("epoch", 0)})
            sched.events.emit(
                "fed_lease_revoked", "warning", time=now,
                detail=f"lease={lease_id} dropped by recovery "
                       "(reserve without confirm)")
            _MET_REVOKED.inc()
            dropped += 1
        return dropped

    # ------------------------------------------------------------------
    # live partition migration (the four-phase WAL protocol; see the
    # module docstring — fed/rebalance.py MigrationCoordinator drives)
    # ------------------------------------------------------------------

    def partition_jobs(self, partition: str) -> list[int]:
        """Live (pending + running) job ids of one partition."""
        sched = self.scheduler
        ids = [jid for jid, j in sched.pending.items()
               if j.spec.partition == partition]
        ids += [jid for jid, j in sched.running.items()
                if j.spec.partition == partition]
        return sorted(ids)

    def seal_partition(self, mid: str, partition: str, dest: str,
                       now: float) -> list[int]:
        """Phase one on the SOURCE: stop admitting into ``partition``
        and make the intent durable.  Local submits into a sealed
        partition return 0 (the successor map owns it), and any arbiter
        lease on its nodes releases — the gang re-places against the
        successor map.  Returns the job ids that will travel."""
        sched = self.scheduler
        if partition not in sched.meta.partitions:
            raise ValueError(f"partition {partition!r} not owned by "
                             f"shard {self.shard!r}")
        if partition in sched.sealed_partitions:
            raise ValueError(f"partition {partition!r} already sealed "
                             "(migration in flight)")
        for lid in [lid for lid, lease in self.leases.items()
                    if lease.partition == partition]:
            self.release_lease(lid, now, detail="partition migrating")
        sched.sealed_partitions.add(partition)
        job_ids = self.partition_jobs(partition)
        self.begun[str(mid)] = {"mid": str(mid), "partition": partition,
                                "dest": dest, "job_ids": list(job_ids)}
        if sched.wal is not None:
            sched.wal.fed_event("fed_migrate_begin", {
                "mid": str(mid), "partition": partition, "dest": dest,
                "job_ids": job_ids})
        sched.events.emit(
            "fed_migrate_begin", "info", time=now,
            detail=f"mid={mid} part={partition} dest={dest} "
                   f"jobs={len(job_ids)}")
        return job_ids

    def export_partition(self, mid: str, partition: str) -> dict:
        """The handoff payload: partition metadata, node inventory, and
        every live job.  Nodes and per-job placements travel by NAME —
        node ids are shard-local and the dest assigns its own.  The
        dispatch ring is empty by the time this runs (the caller holds
        the shard lock and every committed dispatch drained before it
        was taken), so the payload is the complete partition state."""
        sched = self.scheduler
        meta = sched.meta
        part = meta.partitions.get(partition)
        if part is None:
            raise ValueError(f"partition {partition!r} not owned by "
                             f"shard {self.shard!r}")
        nodes = []
        for nid in sorted(part.node_ids):
            node = meta.nodes[nid]
            nodes.append({"name": node.name,
                          "total": [int(x) for x in node.total],
                          "partitions": sorted(node.partitions)})
        jobs = []
        for jid in self.partition_jobs(partition):
            job = sched.pending.get(jid) or sched.running.get(jid)
            jobs.append({"job": _job_to_dict(job),
                         "node_names": [meta.nodes[n].name
                                        for n in job.node_ids]})
        return {"mid": str(mid), "partition": partition,
                "source": self.shard, "priority": part.priority,
                "nodes": nodes, "jobs": jobs}

    def import_partition(self, payload: dict, now: float
                         ) -> tuple[list[int], list[int]]:
        """Phase two on the DEST: adopt the partition in ONE WAL group.

        Jobs are re-created under fresh dest-local ids (ascending in
        source-id order, preserving relative queue age); running jobs
        re-malloc their named nodes and re-enter the running set exactly
        as :meth:`JobScheduler.recover` re-adopts survivors — the
        physical tasks never stopped, only their controller moved.
        Idempotent per mid: a retried handoff returns the first
        import's ids.  Returns (job_ids, node_ids-added)."""
        sched = self.scheduler
        meta = sched.meta
        mid = str(payload["mid"])
        partition = str(payload["partition"])
        if mid in self.imports:
            return list(self.imports[mid]), []
        if partition not in meta.partitions:
            meta.add_partition(partition,
                               priority=int(payload.get("priority", 0)))
        new_nodes: list[int] = []
        for doc in payload.get("nodes", []) or []:
            nid = meta._name_to_id.get(doc["name"])
            if nid is None:
                node = meta.add_node(
                    doc["name"], np.asarray(doc["total"], np.int32),
                    partitions=doc.get("partitions") or (partition,))
                nid = node.node_id
                meta.craned_up(nid)
                new_nodes.append(nid)
            elif (not meta.nodes[nid].alive
                  and partition in meta.nodes[nid].partitions):
                # a prior refused attempt left the node parked dead —
                # revive it for this retry
                meta.craned_up(nid)
                new_nodes.append(nid)
        entries = sorted(payload.get("jobs", []) or [],
                         key=lambda e: e["job"]["job_id"])
        idmap: dict[int, int] = {}
        for entry in entries:
            idmap[int(entry["job"]["job_id"])] = sched._next_job_id
            sched._next_job_id += 1
        # Phase A — validate and malloc EVERYTHING before a single
        # record is appended: commit_batch flushes partial groups even
        # on error, so a refusal discovered mid-write would half-import
        # durably.  An exception here rolls back every malloc, parks
        # the adopted nodes dead, and writes NOTHING — a structured
        # import error genuinely means "not adopted".
        jobs: list = []
        mallocd: list[tuple[int, list[int], object]] = []
        try:
            for entry in entries:
                job = _job_from_dict(entry["job"])
                job.job_id = idmap[int(entry["job"]["job_id"])]
                self._remap_job(job, idmap,
                                entry.get("node_names") or [])
                if job.status in (JobStatus.RUNNING,
                                  JobStatus.SUSPENDED):
                    alloc = sched._job_alloc(job)
                    if not meta.malloc_resource(job.job_id,
                                                job.node_ids, alloc):
                        raise ValueError(
                            f"imported nodes cannot hold job "
                            f"{entry['job']['job_id']} "
                            f"(mid={mid}, part={partition})")
                    mallocd.append((job.job_id, list(job.node_ids),
                                    alloc))
                jobs.append(job)
        except Exception:
            for jid, nids, alloc in mallocd:
                meta.free_resource(jid, nids, alloc)
            for nid in new_nodes:
                meta.craned_down(nid)
            raise
        # Phase B — everything fits: bookkeeping plus ONE WAL group.
        wal = sched.wal
        imported: list[int] = []
        try:
            if wal is not None:
                wal.begin_batch()
            for job in jobs:
                if job.status in (JobStatus.RUNNING,
                                  JobStatus.SUSPENDED):
                    sched.licenses.restore(job.spec.licenses or {})
                    if sched.account_meta is not None and job.qos_name:
                        sched.account_meta.restore_run(
                            job.spec.user, job.spec.account,
                            job.qos_name, job.spec)
                        job.run_usage_taken = True
                    sched.running[job.job_id] = job
                    sched._ledger_add(job, now)
                    if wal is not None:
                        wal.job_started(job)
                else:
                    sched.pending[job.job_id] = job
                    # waiting edges re-register so co-migrated
                    # dependees still fire events on this shard
                    for dep_id, v in job.dep_state.items():
                        if v is None:
                            sched._dependents.setdefault(
                                dep_id, set()).add(job.job_id)
                    if wal is not None:
                        wal.job_submitted(job)
                if (sched.account_meta is not None and job.qos_name
                        and job.array_parent_id is None):
                    sched.account_meta.restore_submit(
                        job.spec.user, job.spec.account, job.qos_name)
                if (sched.global_usage is not None
                        and job.array_parent_id is None):
                    sched.global_usage.note_submit(job.spec.user,
                                                   job.spec.account)
                if sched.jobtrace is not None:
                    sched.jobtrace.stamp(job.job_id, job.requeue_count,
                                         "migrated_in", now,
                                         epoch=sched.fencing_epoch)
                imported.append(job.job_id)
                _MET_MIG_JOBS.inc()
            if wal is not None:
                # node inventory rides the import record: recovery must
                # rebuild these meta entries BEFORE replaying the jobs
                wal.fed_event("fed_migrate_import", {
                    "mid": mid, "partition": partition,
                    "source": str(payload.get("source", "")),
                    "priority": int(payload.get("priority", 0)),
                    "nodes": payload.get("nodes", []) or [],
                    "job_ids": imported})
        finally:
            if wal is not None:
                wal.commit_batch()
        self.imports[mid] = list(imported)
        self.import_meta.append({
            "mid": mid, "partition": partition,
            "priority": int(payload.get("priority", 0)),
            "nodes": [dict(d) for d in payload.get("nodes", []) or []]})
        sched.events.emit(
            "fed_migrate_import", "info", time=now,
            detail=f"mid={mid} part={partition} jobs={len(imported)} "
                   f"nodes={len(new_nodes)}")
        sched._kick()
        return imported, new_nodes

    def _remap_job(self, job, idmap: dict[int, int],
                   node_names: list[str]) -> None:
        """Rewrite every shard-local id in an imported job: placement
        by node NAME, dependency/array edges through ``idmap``.  A
        waiting dependency whose dependee did NOT co-migrate can never
        fire here — it becomes DEP_NEVER (cross-shard dependencies are
        out of contract, same as at submit routing)."""
        meta = self.scheduler.meta
        node_ids = []
        for name in node_names:
            nid = meta._name_to_id.get(name)
            if nid is None:
                raise ValueError(f"imported job placed on unknown "
                                 f"node {name!r}")
            node_ids.append(nid)
        job.node_ids = node_ids
        job.alloc_cache = None
        if job.spec.dependencies:
            job.spec = dataclasses.replace(job.spec, dependencies=tuple(
                dataclasses.replace(dep, job_id=idmap.get(dep.job_id,
                                                          dep.job_id))
                for dep in job.spec.dependencies))
        dep_state = {}
        for old_id, v in job.dep_state.items():
            if old_id in idmap:
                dep_state[idmap[old_id]] = v
            elif v is None:
                dep_state[old_id] = DEP_NEVER
            else:
                dep_state[old_id] = v  # resolved on the source: keep
        job.dep_state = dep_state
        if job.array_parent_id is not None:
            job.array_parent_id = idmap.get(job.array_parent_id,
                                            job.array_parent_id)
        if job.array_children:
            job.array_children = [idmap.get(c, c)
                                  for c in job.array_children]

    def has_import(self, mid: str) -> bool:
        """Did this shard durably adopt handoff ``mid``?  The answer
        the source's crash recovery keys commit-vs-abort on."""
        return str(mid) in self.imports

    def commit_migration(self, mid: str, partition: str,
                         now: float) -> list[int]:
        """Final phase on the SOURCE, once the dest holds the jobs and
        the successor map is live: write the commit record, then DROP
        the migrated jobs — free resources/licenses/limits/slots,
        remove from the queues with no terminal stamps (removal, not
        completion) — and mark the partition's nodes dead.  The
        partition stays sealed forever here; compact keeps the commit
        record forever so no future replay resurrects the jobs."""
        sched = self.scheduler
        meta = sched.meta
        job_ids = self.partition_jobs(partition)
        if sched.wal is not None:
            sched.wal.fed_event("fed_migrate_commit", {
                "mid": str(mid), "partition": partition,
                "job_ids": job_ids})
        for jid in job_ids:
            job = sched.running.get(jid)
            if job is not None:
                meta.free_resource(jid, job.node_ids,
                                   sched._job_alloc(job))
                sched._ledger.remove(jid)
                sched.licenses.free(job.spec.licenses or {})
                sched._free_run_limits(job)
                del sched.running[jid]
            else:
                job = sched.pending.pop(jid)
            # the submit slot travels with the job (the dest restored
            # its own at import)
            if (sched.account_meta is not None and job.qos_name
                    and job.array_parent_id is None):
                sched.account_meta.free_submit(
                    job.spec.user, job.spec.account, job.qos_name)
            if (sched.global_usage is not None
                    and job.array_parent_id is None):
                sched.global_usage.note_release_submit(
                    job.spec.user, job.spec.account)
            sched._dependents.pop(jid, None)
        part = meta.partitions.get(partition)
        if part is not None:
            for nid in sorted(part.node_ids):
                if meta.nodes[nid].alive:
                    meta.craned_down(nid)
        self.migrated_away.add(partition)
        self.begun.pop(str(mid), None)
        self.unresolved_migrations = [
            r for r in self.unresolved_migrations
            if r.get("mid") != str(mid)]
        sched.events.emit(
            "fed_migrate_commit", "info", time=now,
            detail=f"mid={mid} part={partition} "
                   f"handed_off={len(job_ids)}")
        return job_ids

    def abort_migration(self, mid: str, partition: str,
                        now: float) -> None:
        """The handoff never reached the dest: unseal and keep
        everything — the begin record is annulled durably."""
        sched = self.scheduler
        if sched.wal is not None:
            sched.wal.fed_event("fed_migrate_abort", {
                "mid": str(mid), "partition": partition})
        sched.sealed_partitions.discard(partition)
        self.begun.pop(str(mid), None)
        self.unresolved_migrations = [
            r for r in self.unresolved_migrations
            if r.get("mid") != str(mid)]
        sched.events.emit(
            "fed_migrate_abort", "warning", time=now,
            detail=f"mid={mid} part={partition}")

    def _adopt_meta(self, rec: dict) -> None:
        """Recreate one adoption's partition + node meta (recovery
        path; mirrors the live import's inventory adoption, so node
        ids renumber identically and replayed placements stay valid)."""
        meta = self.scheduler.meta
        partition = str(rec["partition"])
        if partition not in meta.partitions:
            meta.add_partition(partition,
                               priority=int(rec.get("priority", 0)))
        for doc in rec.get("nodes", []) or []:
            nid = meta._name_to_id.get(doc["name"])
            if nid is None:
                node = meta.add_node(
                    doc["name"], np.asarray(doc["total"], np.int32),
                    partitions=doc.get("partitions") or (partition,))
                meta.craned_up(node.node_id)

    def snapshot_doc(self) -> dict:
        """Migration state for the HA snapshot.  The snapshotter
        prunes WAL segments a snapshot covers — ``fed_migrate_*``
        records included — so the snapshot itself must carry enough to
        rebuild imported node meta, the committed-migration replay
        filter, and in-flight begins across a restart."""
        return {
            "imports": {m: list(ids)
                        for m, ids in sorted(self.imports.items())},
            "import_meta": [dict(e) for e in self.import_meta],
            "migrated_away": sorted(self.migrated_away),
            "sealed": sorted(self.scheduler.sealed_partitions),
            "begun": [dict(self.begun[m]) for m in sorted(self.begun)],
        }

    def prepare_recovery(self, wal_path, replayed: dict,
                         snap_fed: dict | None = None) -> None:
        """BEFORE ``scheduler.recover``: fold migration history into
        the replay.  ``replayed`` is the job_id -> job dict the WAL
        replay assembled (mutated in place); ``snap_fed`` is the HA
        snapshot's ``fed`` document, applied first, with the surviving
        WAL records overlaid on top.

        * imported partitions' node meta is rebuilt in original
          adoption order and :attr:`imports` re-seeds (the source may
          still ask :meth:`has_import`),
        * committed migrations' job_ids drop out of ``replayed`` (the
          jobs live on the dest now) and the partition re-seals,
        * a begin with no commit/abort re-seals its partition and
          re-seeds :attr:`begun` for :meth:`recover_migrations` to
          surface as unresolved.
        """
        sched = self.scheduler
        if snap_fed:
            for rec in snap_fed.get("import_meta", []) or []:
                self._adopt_meta(rec)
                self.import_meta.append(dict(rec))
            for m, ids in (snap_fed.get("imports") or {}).items():
                self.imports[str(m)] = list(ids)
            self.migrated_away.update(
                str(p) for p in snap_fed.get("migrated_away", []) or [])
            for p in snap_fed.get("sealed", []) or []:
                sched.sealed_partitions.add(str(p))
            for rec in snap_fed.get("begun", []) or []:
                self.begun[str(rec["mid"])] = dict(rec)
        migs = (WriteAheadLog.replay_migrations(wal_path)
                if wal_path else {})
        for mid, entry in sorted(migs.items(),
                                 key=lambda kv: kv[1].get("seq", 0)):
            ev = entry.get("ev", "")
            partition = str(entry.get("partition", ""))
            if ev == "fed_migrate_import":
                if mid in self.imports:
                    continue  # the snapshot already carried it
                self._adopt_meta(entry)
                self.imports[mid] = list(entry.get("job_ids") or [])
                self.import_meta.append({
                    "mid": mid, "partition": partition,
                    "priority": int(entry.get("priority", 0)),
                    "nodes": [dict(d)
                              for d in entry.get("nodes", []) or []]})
            elif ev == "fed_migrate_begin":
                sched.sealed_partitions.add(partition)
                self.begun[mid] = {
                    "mid": mid, "partition": partition,
                    "dest": str(entry.get("dest", "")),
                    "job_ids": list(entry.get("job_ids") or [])}
            elif ev == "fed_migrate_commit":
                for jid in entry.get("job_ids") or []:
                    replayed.pop(jid, None)
                sched.sealed_partitions.add(partition)
                self.migrated_away.add(partition)
                self.begun.pop(mid, None)
            elif ev == "fed_migrate_abort":
                self.begun.pop(mid, None)
                if partition not in self.migrated_away:
                    sched.sealed_partitions.discard(partition)

    def recover_migrations(self, now: float) -> list[dict]:
        """AFTER ``scheduler.recover``: re-mark migrated-away
        partitions' nodes dead (recover marks observed nodes up) and
        surface begins with no commit/abort as
        :attr:`unresolved_migrations` — each partition stays sealed
        until the resolver settles its begin against the dest's
        :meth:`has_import` answer (commit if adopted, abort if not)."""
        sched = self.scheduler
        meta = sched.meta
        for partition in sorted(self.migrated_away):
            sched.sealed_partitions.add(partition)
            part = meta.partitions.get(partition)
            if part is not None:
                for nid in sorted(part.node_ids):
                    if meta.nodes[nid].alive:
                        meta.craned_down(nid)
        unresolved = [dict(self.begun[m]) for m in sorted(self.begun)]
        for rec in unresolved:
            sched.events.emit(
                "fed_migrate_unresolved", "warning", time=now,
                detail=f"mid={rec['mid']} part={rec['partition']} "
                       "(begin without commit/abort — resolving "
                       "against the destination)")
        self.unresolved_migrations = unresolved
        return unresolved

    def stats(self) -> dict:
        return {"shard": self.shard, "leases": len(self.leases),
                "sealed": sorted(self.scheduler.sealed_partitions),
                "migrated_away": sorted(self.migrated_away),
                "imports": len(self.imports),
                "begun": len(self.begun),
                "unresolved": len(self.unresolved_migrations)}
