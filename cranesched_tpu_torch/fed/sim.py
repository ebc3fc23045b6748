"""In-process federation harness (port of ``cranesched_tpu/fed/sim.py``):
N controller shards + the placement arbiter on one virtual clock.

Every shard's scheduler runs on the device the caller names
(``device=``; None is the CUDA card, as for every entry point of the
port): the shards of one process share that card, each with its own
resident state, and each solves its partitions through ``greedy_place``.

Each :class:`SimShard` is a COMPLETE shard — its own MetaContainer,
JobScheduler, WAL, simulated node plane, and
:class:`~cranesched_tpu_torch.fed.shard.FedShardPlane` — isolated exactly as
a separate ctld process would be: shards share nothing but the arbiter
handles and the shard map.  A lock per shard stands in for its RPC
server's; :class:`ShardHandle` takes it around every arbiter call.

Failure injection mirrors a SIGKILL, not a clean shutdown:
:meth:`SimShard.kill` abandons the scheduler mid-flight (the WAL file
keeps whatever was fsync'd, nothing is flushed on the way out) and
every subsequent handle call raises.  :meth:`SimShard.recover` rebuilds
the shard from its WAL alone — the same replay a restarted ctld runs —
then :meth:`FedShardPlane.recover` drops reserved-but-unconfirmed
leases.  Tests and the ``--federation`` replay assert the two-phase
invariant on top: a kill between reserve and confirm never loses a
placed job and never places one twice.
"""

from __future__ import annotations

import threading

from cranesched_tpu_torch.craned.sim import SimCluster
from cranesched_tpu_torch.ctld.defs import JobSpec
from cranesched_tpu_torch.ctld.meta import MetaContainer
from cranesched_tpu_torch.ctld.scheduler import JobScheduler, SchedulerConfig
from cranesched_tpu_torch.ctld.wal import WriteAheadLog
from cranesched_tpu_torch.fed.arbiter import GangRequest, PlacementArbiter
from cranesched_tpu_torch.fed.rebalance import MigrationCoordinator
from cranesched_tpu_torch.fed.shard import FedShardPlane
from cranesched_tpu_torch.fed.shardmap import ShardMap, ShardSpec
from cranesched_tpu_torch.fed.usage import UsageBook
from cranesched_tpu_torch.ops.resources import ResourceLayout


class SimShard:
    """One in-process controller shard over disjoint partitions."""

    def __init__(self, name: str, partitions: dict[str, int],
                 cpu: float = 16.0, mem_gb: int = 64,
                 wal_path: str | None = None, config_kw=None,
                 global_limits=None, n_shards: int = 1,
                 publish_slack: int = 1, peers=(), device=None):
        self.name = name
        self.device = device
        self.partitions = dict(partitions)
        self.cpu = cpu
        self.mem_gb = mem_gb
        self.wal_path = wal_path
        self.config_kw = dict(config_kw or {})
        self.global_limits = global_limits
        self.n_shards = n_shards
        self.publish_slack = publish_slack
        self.peers = tuple(peers)
        self.lock = threading.Lock()
        self.alive = True
        #: failure injection: die immediately after the NEXT successful
        #: lease (reserve durable, confirm never answered) — the
        #: arbiter's phase-two then hits a dead shard mid-gang
        self.crash_after_lease = False
        #: bare fed_migrate_begin records found by the last recovery —
        #: MigrationCoordinator.resolve settles them against the dest
        self.unresolved_migrations: list[dict] = []
        self._fresh_wal = True
        self._build(now=0.0, replayed=None)

    # -- construction / recovery --

    def _build(self, now: float, replayed, snap_fed=None) -> None:
        self.meta = MetaContainer(ResourceLayout())
        nid = 0
        # native partitions build in sorted order, ALWAYS — including
        # ones migrated away (their nodes go dead below, never absent),
        # so shard-local node ids stay stable across every recovery
        for part in sorted(self.partitions):
            for i in range(self.partitions[part]):
                self.meta.add_node(
                    f"{self.name}-{part}-n{i:04d}",
                    self.meta.layout.encode(
                        cpu=self.cpu, mem_bytes=self.mem_gb << 30,
                        memsw_bytes=self.mem_gb << 30,
                        is_capacity=True),
                    partitions=(part,))
                self.meta.craned_up(nid)
                nid += 1
        kw = dict(self.config_kw)
        kw.setdefault("job_trace", True)
        kw.setdefault("job_trace_capacity", 65536)
        self.scheduler = JobScheduler(self.meta, SchedulerConfig(**kw),
                                      device=self.device)
        # the fed plane attaches BEFORE recovery — prepare_recovery is
        # what rebuilds imported partitions' meta (in original adoption
        # order, so node ids renumber identically), filters committed
        # migrations' jobs out of the replay, and re-seals in-flight
        # partitions.  The production boot (ctld_main + ha/snapshot)
        # runs the same sequence.
        self.fed = FedShardPlane(self.scheduler, self.name)
        if self.global_limits is not None:
            # before recover: restored jobs must re-take their global
            # submit slots (fed/usage.py)
            self.scheduler.global_usage = UsageBook(
                self.name, self.global_limits, n_shards=self.n_shards,
                publish_slack=self.publish_slack,
                seq_source=lambda: (self.scheduler.wal.durable_seq
                                    if self.scheduler.wal is not None
                                    else 0),
                peers=self.peers)
        if replayed is not None:
            self.fed.prepare_recovery(self.wal_path, replayed,
                                      snap_fed=snap_fed)
            self.scheduler.recover(replayed, now)
        if self.wal_path is not None:
            if self._fresh_wal:
                open(self.wal_path, "w").close()
                self._fresh_wal = False
            self.scheduler.wal = WriteAheadLog(self.wal_path)
        self.sim = SimCluster(self.scheduler)
        self.sim.now = now
        self.sim.wire(self.scheduler)
        self.unresolved_migrations = []
        if replayed is not None:
            self.fed.recover(now)
            self.unresolved_migrations = self.fed.recover_migrations(now)
            # the craneds of a real shard still run the re-adopted
            # jobs; the simulated plane re-dispatches them instead
            for job in self.scheduler.running.values():
                self.sim.dispatch(job, job.node_ids)

    def kill(self) -> None:
        """SIGKILL analog: nothing is flushed or released — only what
        the WAL already fsync'd survives into :meth:`recover`."""
        self.alive = False

    def recover(self, now: float) -> None:
        """Restart from the local snapshot (if one exists beside the
        WAL — the same ``<wal>.snap`` the HA snapshotter writes) plus
        the WAL tail, or a full WAL replay otherwise.  The snapshot's
        ``fed`` document stands in for fed_migrate_* records that
        segment pruning dropped."""
        if self.wal_path is None:
            raise RuntimeError("recover needs a WAL-backed shard")
        from cranesched_tpu_torch.ha.snapshot import (
            SnapshotStore,
            snapshot_to_replay,
        )
        doc = SnapshotStore(self.wal_path).load()
        snap_fed = None
        if doc is not None:
            replayed = snapshot_to_replay(doc)
            replayed.update(WriteAheadLog.replay(
                self.wal_path, after_seq=int(doc.get("seq", 0))))
            snap_fed = doc.get("fed")
        else:
            replayed = WriteAheadLog.replay(self.wal_path)
        self._build(now=now, replayed=replayed, snap_fed=snap_fed)
        if doc is not None:
            self.scheduler._next_job_id = max(
                self.scheduler._next_job_id,
                int(doc.get("next_job_id", 1)))
        self.alive = True

    # -- the local control surface (what the RPC handlers would do) --

    def submit(self, spec: JobSpec, now: float) -> int:
        if not self.alive:
            raise RuntimeError(f"shard {self.name} is down")
        with self.lock:
            return self.scheduler.submit(spec, now)

    def tick(self, now: float) -> list[int]:
        """One scheduling cycle at virtual time ``now``."""
        if not self.alive:
            return []
        with self.lock:
            self.sim.advance_to(now)
            self.fed.expire(now)
            return self.scheduler.schedule_cycle(now)

    def drained(self) -> bool:
        return (not self.alive
                or (not self.scheduler.pending
                    and not self.scheduler.running))


class ShardHandle:
    """Arbiter-side handle over one :class:`SimShard` — the in-process
    equivalent of the LeaseNodes/ConfirmGang/ReleaseLease RPC client,
    including its failure mode (a dead shard raises)."""

    def __init__(self, shard: SimShard):
        self.shard = shard

    def _check(self) -> None:
        if not self.shard.alive:
            raise RuntimeError(f"shard {self.shard.name} unreachable")

    def _req(self, spec: JobSpec):
        return spec.res.encode(self.shard.meta.layout)

    def free_count(self, partition: str, spec: JobSpec) -> int:
        self._check()
        with self.shard.lock:
            return self.shard.fed.free_count(partition, self._req(spec))

    def lease(self, lease_id: str, partition: str, count: int,
              spec: JobSpec, ttl: float, now: float):
        self._check()
        with self.shard.lock:
            out = self.shard.fed.lease_nodes(
                lease_id, partition, count, self._req(spec), ttl, now)
        if self.shard.crash_after_lease:
            # one-shot: the reserve IS durable — the kill lands after
            # the WAL fsync but before any confirm can be served
            self.shard.crash_after_lease = False
            self.shard.kill()
        return out

    def confirm(self, lease_id: str, gang_id: str, spec: JobSpec,
                node_names, now: float, epoch: int = 0) -> int:
        self._check()
        with self.shard.lock:
            return self.shard.fed.confirm_gang(
                lease_id, gang_id, spec, list(node_names), now,
                epoch=epoch)

    def release(self, lease_id: str, now: float) -> bool:
        self._check()
        with self.shard.lock:
            return self.shard.fed.release_lease(lease_id, now)

    def cancel(self, job_id: int, now: float) -> bool:
        self._check()
        with self.shard.lock:
            return self.shard.scheduler.cancel(job_id, now)

    # -- the migration surface (MigrationCoordinator endpoints) --

    def seal(self, mid: str, partition: str, dest: str,
             now: float) -> list[int]:
        self._check()
        with self.shard.lock:
            return self.shard.fed.seal_partition(mid, partition, dest,
                                                 now)

    def export(self, mid: str, partition: str) -> dict:
        self._check()
        with self.shard.lock:
            return self.shard.fed.export_partition(mid, partition)

    def import_(self, payload: dict, now: float):
        self._check()
        with self.shard.lock:
            imported, new_nodes = self.shard.fed.import_partition(
                payload, now)
            # the simulated node plane must mirror the adopted meta:
            # craneds for the new nodes, re-dispatch for the running
            # jobs (their physical tasks never stopped — a real craned
            # re-registers; the sim re-arms their completions)
            from cranesched_tpu_torch.craned.sim import SimCraned
            for nid in new_nodes:
                self.shard.sim.craneds.setdefault(nid, SimCraned(nid))
            for jid in imported:
                job = self.shard.scheduler.running.get(jid)
                if job is not None:
                    self.shard.sim.dispatch(job, job.node_ids)
            return imported, new_nodes

    def commit(self, mid: str, partition: str, now: float) -> list[int]:
        self._check()
        with self.shard.lock:
            return self.shard.fed.commit_migration(mid, partition, now)

    def abort(self, mid: str, partition: str, now: float) -> None:
        self._check()
        with self.shard.lock:
            self.shard.fed.abort_migration(mid, partition, now)

    def has_import(self, mid: str) -> bool:
        self._check()
        with self.shard.lock:
            return self.shard.fed.has_import(mid)

    def unresolved(self) -> list[dict]:
        self._check()
        out = self.shard.unresolved_migrations
        self.shard.unresolved_migrations = []
        return out


class FederatedCluster:
    """N shards + one arbiter on a shared virtual clock.

    ``shards`` maps shard name -> {partition -> node count}.  Submits
    route by partition through the shard map (exactly the lookup the
    RPC layer does); cross-partition gangs go through the arbiter.
    ``device`` is handed to every shard's scheduler."""

    def __init__(self, shards: dict[str, dict[str, int]],
                 cpu: float = 16.0, mem_gb: int = 64,
                 wal_dir: str | None = None, config_kw=None,
                 global_limits=None, publish_slack: int = 1,
                 device=None):
        self.shards: dict[str, SimShard] = {}
        specs = []
        for name in sorted(shards):
            wal_path = (f"{wal_dir}/{name}.wal"
                        if wal_dir is not None else None)
            self.shards[name] = SimShard(
                name, shards[name], cpu=cpu, mem_gb=mem_gb,
                wal_path=wal_path, config_kw=config_kw,
                global_limits=global_limits, n_shards=len(shards),
                publish_slack=publish_slack,
                peers=tuple(p for p in sorted(shards) if p != name),
                device=device)
            specs.append(ShardSpec(
                name=name,
                partitions=tuple(sorted(shards[name]))))
        self.shard_map = ShardMap(specs)
        self.handles = {name: ShardHandle(s)
                        for name, s in self.shards.items()}
        self.arbiter = PlacementArbiter(self.shard_map, self.handles)
        self.coordinator = MigrationCoordinator(
            self.shard_map, self.handles, self._install_map)
        self.now = 0.0

    # -- routing --

    def shard_for(self, partition: str) -> SimShard | None:
        name = self.shard_map.shard_for_partition(partition)
        return self.shards.get(name)

    def submit(self, spec: JobSpec, now: float | None = None
               ) -> tuple[str, int]:
        """Route a partition-local submit; returns (shard, job_id)."""
        shard = self.shard_for(spec.partition)
        if shard is None:
            raise ValueError(f"no shard owns partition "
                             f"{spec.partition!r}")
        return shard.name, shard.submit(
            spec, self.now if now is None else now)

    def submit_gang(self, gang: GangRequest) -> str:
        return self.arbiter.submit_gang(gang)

    # -- the clock --

    def tick(self, now: float | None = None) -> int:
        """Advance every live shard one cycle, then pump the arbiter.
        Returns the number of jobs started across the federation."""
        self.now = self.now + 1.0 if now is None else now
        started = 0
        for shard in self.shards.values():
            started += len(shard.tick(self.now))
        started += sum(
            len(self.arbiter.committed[gid])
            for gid in self.arbiter.pump(self.now))
        return started

    def run_until_drained(self, max_cycles: int = 100_000) -> float:
        """Alternate ticks until every live shard drained and the
        arbiter queue is empty (virtual clock, like the single-cluster
        ``SimCluster.run_until_drained``)."""
        for _ in range(max_cycles):
            self.tick()
            if self.arbiter.queue:
                continue
            if all(s.drained() for s in self.shards.values()):
                return self.now
        return self.now

    # -- live partition migration / cluster-wide accounting --

    def _install_map(self, new_map: ShardMap) -> None:
        """The coordinator's flip hook: routing and the arbiter adopt
        the successor map in one assignment each — every later lookup
        (submit routing, gang planning) sees the new owner."""
        self.shard_map = new_map
        self.arbiter.shard_map = new_map

    def migrate(self, partition: str, dest: str,
                on_exported=None) -> dict:
        """Drive one live partition migration at the current virtual
        time (see MigrationCoordinator.migrate; ``on_exported`` is the
        chaos seam where a source SIGKILL lands)."""
        return self.coordinator.migrate(partition, dest, self.now,
                                        on_exported=on_exported)

    def resolve_migrations(self, source: str) -> list[dict]:
        """Settle a restarted source's in-flight handoffs."""
        return self.coordinator.resolve(source, self.now)

    def pump_usage(self, now: float | None = None) -> int:
        """One gossip round: every live shard PULLS every live peer's
        summary, exactly as the RPC loop does — each pull publishes
        with the puller's name, so the publisher marks its counters
        delivered to that peer (per-peer acks are what release the
        publish-slack throttle; a dead peer withholds its ack and the
        publisher's own admissions tighten instead of overshooting).
        Returns the number of documents exchanged.  Call cadence IS
        the staleness bound — every tick approximates staleness 0,
        sparser pumping exercises the conservative slack
        (fed/usage.py)."""
        now = self.now if now is None else now
        exchanged = 0
        names = sorted(self.shards)
        for dst_name in names:
            dst = self.shards[dst_name]
            dbook = dst.scheduler.global_usage
            if not dst.alive or dbook is None:
                continue
            for src_name in names:
                if src_name == dst_name:
                    continue
                src = self.shards[src_name]
                sbook = src.scheduler.global_usage
                if not src.alive or sbook is None:
                    continue
                with src.lock:
                    doc = sbook.publish(now, peer=dst_name)
                with dst.lock:
                    dbook.ingest(doc, now)
                exchanged += 1
        return exchanged

    # -- failure injection / audit --

    def kill(self, name: str) -> None:
        self.shards[name].kill()

    def recover(self, name: str, now: float | None = None) -> None:
        self.shards[name].recover(self.now if now is None else now)
        # the rebuilt FedShardPlane is a new object — rebind the handle
        self.handles[name].shard = self.shards[name]

    def ledger(self) -> dict:
        """Cross-shard lost/doubled audit from each shard's jobtrace
        ledger, keyed by shard."""
        out = {"lost": 0, "doubled": 0, "checked": 0, "shards": {}}
        for name, shard in self.shards.items():
            sched = shard.scheduler
            ids = sorted(set(sched.history) | set(sched.running)
                         | set(sched.pending))
            doc = (sched.jobtrace.ledger(ids)
                   if sched.jobtrace is not None else
                   {"lost": 0, "doubled": 0, "checked": 0})
            out["shards"][name] = doc
            out["lost"] += (doc["lost"] if isinstance(doc["lost"], int)
                            else len(doc["lost"]))
            out["doubled"] += (doc["doubled"]
                               if isinstance(doc["doubled"], int)
                               else len(doc["doubled"]))
            out["checked"] += doc["checked"]
        return out

    def ledger_by_name(self, names) -> dict:
        """Exactly-once audit ACROSS shards, keyed by job NAME (ids are
        shard-local and change when a job migrates): every submitted
        name must reach exactly one terminal state federation-wide.
        ``lost`` = names with no terminal anywhere, ``doubled`` = names
        terminal on more than one job."""
        ends: dict[str, int] = {}
        live: dict[str, int] = {}
        for shard in self.shards.values():
            sched = shard.scheduler
            for job in sched.history.values():
                if job.status.is_terminal:
                    ends[job.spec.name] = ends.get(job.spec.name, 0) + 1
            for store in (sched.pending, sched.running):
                for job in store.values():
                    live[job.spec.name] = live.get(job.spec.name, 0) + 1
        names = list(names)
        return {
            "checked": len(names),
            "lost": [n for n in names
                     if not ends.get(n) and not live.get(n)],
            "doubled": [n for n in names
                        if ends.get(n, 0) + live.get(n, 0) > 1],
            "still_live": [n for n in names if live.get(n)],
        }

    def stats(self) -> dict:
        return {
            "now": self.now,
            "arbiter": dict(self.arbiter.stats),
            "shards": {
                name: {
                    "alive": s.alive,
                    "pending": len(s.scheduler.pending),
                    "running": len(s.scheduler.running),
                    "finished": len(s.scheduler.history),
                    "leases": len(s.fed.leases),
                } for name, s in self.shards.items()},
        }
