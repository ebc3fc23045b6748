"""Hot-standby replication + promotion (port of
``cranesched_tpu/ha/follower.py``; the records, the snapshot and the RPCs
are the JAX package's, so a port standby follows a JAX leader and the
other way round).

The follower is a full ctld process whose server answers queries but
refuses mutations (the leader-only guard in rpc/server.py).  A
background thread here:

1. pulls a full snapshot from the leader (``HaFetchSnapshot``), persists
   it locally, and seeds the shadow state;
2. polls ``HaFetchWal`` with its applied-seq cursor, appends each raw
   record to its OWN local WAL (durability: a standby restart while the
   leader is dead can still promote), and applies it to the shadow
   ``JobScheduler`` — job dicts only, no resources, no cycles, no
   dispatch — so cqueue against the standby shows live state;
3. counts consecutive poll failures; past the miss threshold it tries
   the leader lease.  The lease is an flock that dies with its holder,
   so a SIGKILL'd leader frees it immediately while a live-but-slow
   leader still holds it (the acquisition fails and the standby keeps
   following — no split brain).

Promotion: take the lease (which bumps the fencing epoch), clear the
shadow dicts, run ``scheduler.recover`` over snapshot+replicated state
(re-mallocs resources, rebuilds the run ledger, re-creates implicit
steps, re-sends lost kills), rebuild the device-resident caches
(``rebuild_device_state``), open the local WAL for writing, and flip the
server to leader — its cycle-loop gate opens and craneds re-register
(their ctld address list includes us), learning the new epoch that
fences the deposed leader's in-flight pushes.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

import grpc

from cranesched_tpu_torch.ctld.defs import JobStatus
from cranesched_tpu_torch.ctld.wal import WriteAheadLog, _job_from_dict
from cranesched_tpu_torch.ha.lease import LeaderLease
from cranesched_tpu_torch.ha.snapshot import (
    SnapshotStore,
    restore_snapshot,
    snapshot_to_replay,
)
from cranesched_tpu_torch.utils.filelock import FileLockHeld

log = logging.getLogger("ctld.ha")


class HaFollower(threading.Thread):
    """Replication puller + failover trigger for a standby ctld."""

    def __init__(self, server, leader_address: str, wal_path: str,
                 poll_interval: float = 1.0, miss_threshold: int = 3,
                 fetch_limit: int = 512, token: str = "", tls=None,
                 on_promote=None):
        super().__init__(daemon=True, name="ha-follower")
        self.server = server
        self.scheduler = server.scheduler
        self.leader_address = leader_address
        self.wal_path = wal_path
        self.poll_interval = poll_interval
        self.miss_threshold = miss_threshold
        self.fetch_limit = fetch_limit
        self.token = token
        self.tls = tls
        self.on_promote = on_promote
        self.lease = LeaderLease(wal_path)
        self.store = SnapshotStore(wal_path)

        self.applied_seq = 0
        self.leader_seq = 0
        # monotonic timestamp of the last poll that left us caught up
        # with the leader's durable tail; feeds the bounded-staleness
        # read contract (fed/query.py, rpc/server.py max_staleness)
        self._caught_up_at = 0.0
        self.promoted = threading.Event()
        self._stop = threading.Event()
        self._misses = 0
        self._client = None
        # replay-shaped shadow state: job_id -> (ev, Job); the same Job
        # objects are mirrored into the scheduler dicts for queries
        self._state: dict = {}
        # the leader snapshot's "fed" document — migration state that
        # promotion must fold into the replay (prune_segments already
        # dropped the covered fed_migrate_* records on the leader)
        self._snap_fed: dict | None = None
        self._have_snapshot = False
        self._seed_from_disk()

    # -- local durability --

    def _seed_from_disk(self) -> None:
        """A restarting standby resumes from its local snapshot + WAL
        tail instead of an empty cursor — and can promote even if the
        leader never comes back."""
        doc = self.store.load()
        if doc is not None:
            self._state = snapshot_to_replay(doc)
            self._snap_fed = doc.get("fed")
            self.applied_seq = int(doc.get("seq", 0))
            self._have_snapshot = True
        tail = WriteAheadLog.replay(self.wal_path,
                                    after_seq=self.applied_seq)
        if tail:
            self._state.update(tail)
            self._have_snapshot = True
        self.applied_seq = max(
            self.applied_seq,
            WriteAheadLog._scan_max_seq(self.wal_path))
        if doc is not None:
            with self.server._lock:
                restore_snapshot(self.scheduler, doc)
        self._mirror_all()

    # -- shadow apply --

    def _mirror_job(self, job) -> None:
        s = self.scheduler
        for col in (s.pending, s.running, s.history):
            col.pop(job.job_id, None)
        if job.status.is_terminal:
            s.history[job.job_id] = job
        elif job.status in (JobStatus.RUNNING, JobStatus.SUSPENDED):
            s.running[job.job_id] = job
        else:
            s.pending[job.job_id] = job
        s._next_job_id = max(s._next_job_id, job.job_id + 1)

    def _mirror_all(self) -> None:
        with self.server._lock:
            self.scheduler.pending.clear()
            self.scheduler.running.clear()
            self.scheduler.history.clear()
            for _ev, job in self._state.values():
                self._mirror_job(job)

    def _apply_records(self, records) -> int:
        """Append raw lines to the local WAL and apply to the shadow.
        Records are already durable on the leader; the local append is
        batched-fsync'd (one fsync per fetch, not per record)."""
        if not records:
            return 0
        with open(self.wal_path, "a", encoding="utf-8") as fh:
            for rec in records:
                fh.write(rec.payload + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        with self.server._lock:
            for rec in records:
                parsed = json.loads(rec.payload)
                self.applied_seq = max(self.applied_seq,
                                       int(rec.seq))
                if "job" not in parsed:
                    # federation lease record (fed_reserve/confirm/
                    # release): durable in the local WAL above for a
                    # post-promotion replay_fed, but not shadow state
                    continue
                job = _job_from_dict(parsed["job"])
                self._state[job.job_id] = (parsed["ev"], job)
                self._mirror_job(job)
        return len(records)

    def staleness(self) -> float:
        """Upper bound, in seconds, on how stale this follower's view
        is: time since the last replication poll that left us caught up
        with the leader's durable tail.  ``inf`` before the first full
        sync — a follower that has never caught up must refuse any
        bounded-staleness read."""
        at = self._caught_up_at
        if at <= 0.0:
            return float("inf")
        return max(0.0, time.monotonic() - at)

    # -- leader polling --

    # the leader's snapshot is one reply: ~1.2 KB a job, past gRPC's
    # 4 MiB default from ~3,500 jobs on, so the standby takes any size
    # (the JAX package's follower keeps the default; ROADMAP.md C6)
    MAX_REPLY_BYTES = -1

    def _dial(self):
        if self._client is None:
            from cranesched_tpu_torch.rpc.client import CtldClient
            self._client = CtldClient(
                self.leader_address, timeout=5.0, token=self.token,
                tls=self.tls, max_receive_bytes=self.MAX_REPLY_BYTES)
        return self._client

    def _pull_snapshot(self) -> None:
        rep = self._dial().ha_fetch_snapshot()
        if not rep.ok:
            raise RuntimeError(rep.error or "snapshot refused")
        doc = json.loads(rep.payload)
        # record the leader's term durably: a later promotion must bump
        # strictly past it even when the epoch files aren't shared
        self.lease.epoch_store.observe(rep.fencing_epoch)
        self.store.save(doc)
        # the local WAL restarts at the snapshot: records <= seq are
        # absorbed, the tail re-accumulates from the fetch loop
        with open(self.wal_path, "w", encoding="utf-8") as fh:
            fh.flush()
            os.fsync(fh.fileno())
        with self.server._lock:
            restore_snapshot(self.scheduler, doc)
        self._state = snapshot_to_replay(doc)
        self._snap_fed = doc.get("fed")
        self.applied_seq = int(doc.get("seq", 0))
        self._have_snapshot = True
        self._mirror_all()
        log.info("pulled snapshot @seq=%d (%d jobs)",
                 self.applied_seq, len(self._state))

    def poll_once(self) -> bool:
        """One replication round-trip.  Returns True on success."""
        from cranesched_tpu_torch import ha as _ha
        try:
            if not self._have_snapshot:
                self._pull_snapshot()
            events = self.scheduler.events
            rep = self._dial().ha_fetch_wal(
                self.applied_seq, limit=self.fetch_limit,
                after_event_seq=events.remote_seq)
            if rep.resync:
                log.warning("cursor %d fell off the leader's tail; "
                            "resyncing from snapshot", self.applied_seq)
                self._pull_snapshot()
                return True
            if not rep.ok:
                raise RuntimeError(rep.error or "fetch refused")
            self._apply_records(rep.records)
            # event-ring piggyback: advisory, best-effort, never blocks
            # WAL replication
            for ev in rep.events:
                events.ingest({"seq": ev.seq, "time": ev.time,
                               "type": ev.type, "severity": ev.severity,
                               "node": ev.node, "job_id": ev.job_id,
                               "detail": ev.detail})
            if rep.event_seq > events.remote_seq:
                events.remote_seq = int(rep.event_seq)
            self.lease.epoch_store.observe(rep.fencing_epoch)
            self.leader_seq = int(rep.wal_seq)
            _ha.LAG_GAUGE.set(max(0, self.leader_seq - self.applied_seq))
            self._misses = 0
            if self.applied_seq >= self.leader_seq:
                self._caught_up_at = time.monotonic()
            return True
        except grpc.RpcError as e:
            # only an UNREACHABLE leader is evidence for failover
            self._misses += 1
            log.warning("replication poll failed (%d/%d): %s",
                        self._misses, self.miss_threshold, e)
            # the channel may be wedged on a dead endpoint — redial
            if self._client is not None:
                try:
                    self._client.close()
                except Exception:
                    pass
                self._client = None
            return False
        except (RuntimeError, OSError) as e:
            # a refused fetch or a LOCAL apply/persist error means the
            # leader may well be alive — retry, never promote on it
            log.error("replication apply failed (leader still "
                      "considered alive): %s", e)
            return False

    # -- failover --

    def try_promote(self) -> bool:
        """Attempt to take the lease; promote on success.  A held lease
        means the leader is still alive — keep following."""
        try:
            epoch = self.lease.acquire()
        except FileLockHeld:
            log.info("lease still held; leader alive, not promoting")
            self._misses = 0
            return False
        self.promote(epoch)
        return True

    def promote(self, epoch: int) -> None:
        from cranesched_tpu_torch import ha as _ha
        now = time.time()
        s = self.scheduler
        with self.server._lock:
            # shadow dicts hold bare replicated Jobs; recover() re-adopts
            # them properly (resources, ledger, steps, accounting usage)
            s.pending.clear()
            s.running.clear()
            s.history.clear()
            # nodes that host replicated RUNNING work were alive at the
            # leader's death: mark them so recover() can re-malloc; the
            # real craneds re-register within a ping interval and the
            # ping timeout reaps any that actually died with the leader
            for _ev, job in self._state.values():
                if job.status in (JobStatus.RUNNING,
                                  JobStatus.SUSPENDED):
                    for nid in job.node_ids:
                        node = s.meta.nodes.get(nid)
                        if node is not None and not node.alive:
                            node.alive = True
                            node.last_ping = now
            # migration history first: drop committed handoffs' jobs,
            # rebuild imported node meta, re-seal in-flight partitions
            fed = getattr(s, "fed", None)
            if fed is not None:
                fed.prepare_recovery(self.wal_path, self._state,
                                     snap_fed=self._snap_fed)
            s.recover(self._state, now=now)
            s.rebuild_device_state()
            s.fencing_epoch = epoch
            s.wal = WriteAheadLog(self.wal_path)
            if fed is not None:
                fed.recover(now)
                unresolved = fed.recover_migrations(now)
                if unresolved:
                    log.warning(
                        "%d unresolved migration(s) after promotion "
                        "[%s] — partitions stay sealed until the "
                        "destination's has_import answer settles them",
                        len(unresolved),
                        ", ".join(r["mid"] for r in unresolved))
        self.server.promote_to_leader(epoch)
        self.promoted.set()
        _ha.FAILOVERS.inc()
        _ha.ROLE_GAUGE.set(1)
        _ha.LAG_GAUGE.set(0)
        log.warning("PROMOTED to leader (epoch %d, %d jobs, wal seq %d)",
                    epoch, len(self._state), s.wal.seq)
        if self.on_promote is not None:
            self.on_promote(epoch)

    # -- thread loop --

    def run(self) -> None:
        from cranesched_tpu_torch import ha as _ha
        _ha.ROLE_GAUGE.set(0)
        while not self._stop.wait(self.poll_interval):
            if self.promoted.is_set():
                return
            ok = self.poll_once()
            if not ok and self._misses >= self.miss_threshold:
                if self.try_promote():
                    return

    def stop(self) -> None:
        self._stop.set()
        if self._client is not None:
            try:
                self._client.close()
            except Exception:
                pass
