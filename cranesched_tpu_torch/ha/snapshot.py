"""Snapshots (port of ``cranesched_tpu/ha/snapshot.py``): periodic,
fsync'd, atomically-renamed captures of scheduler + meta + accounting
state, consistent with a WAL sequence number.

Recovery (a leader's boot) loads the snapshot and replays only the WAL
tail (records with seq > snapshot seq) instead of the full history; after a durable snapshot the leader rotates the active
WAL file into a sealed segment and prunes segments the snapshot covers,
so the log stops growing without ever losing a committed record.

Accounting note: the account/user/QoS *hierarchy* lives in the sqlite
acct store (its own file, shared by both ctlds); the per-user usage
counters are re-derived from the job records themselves during
``JobScheduler.recover`` (restore_submit/restore_run), so the snapshot
carries job + node state and the accounting state follows from it.
"""

from __future__ import annotations

import json
import os
import threading

from cranesched_tpu_torch.ctld.wal import _job_from_dict, _job_to_dict

SNAPSHOT_VERSION = 1

# in-RAM history is unbounded; the archive (sqlite) is the authoritative
# terminal-job store, so the snapshot carries only the most recent slice
# for post-failover cacct/cqueue continuity
MAX_HISTORY_JOBS = 2000


def capture_snapshot(scheduler, seq: int | None = None) -> dict:
    """Build the snapshot document.  Caller must hold the server lock —
    the document must be consistent with one WAL position."""
    if seq is None:
        seq = (scheduler.wal.durable_seq
               if scheduler.wal is not None else 0)
    jobs = []
    for col in (scheduler.pending, scheduler.running):
        for job in col.values():
            jobs.append(_job_to_dict(job))
    hist = sorted(scheduler.history.values(),
                  key=lambda j: (j.end_time or 0.0, j.job_id))
    for job in hist[-MAX_HISTORY_JOBS:]:
        jobs.append(_job_to_dict(job))
    nodes = {}
    for node in scheduler.meta.nodes.values():
        nodes[node.name] = {
            "alive": node.alive,
            "drained": node.drained,
            "health_drained": node.health_drained,
            "power_state": node.power_state,
            "address": node.address,
        }
    doc = {
        "version": SNAPSHOT_VERSION,
        "seq": seq,
        "next_job_id": scheduler._next_job_id,
        "jobs": jobs,
        "nodes": nodes,
    }
    # prune_segments deletes fed_migrate_* records along with the
    # covered segments — the snapshot must carry the migration state
    # (imported node meta, replay filter, in-flight begins) itself
    fed = getattr(scheduler, "fed", None)
    if fed is not None:
        doc["fed"] = fed.snapshot_doc()
    return doc


def snapshot_to_replay(doc: dict) -> dict:
    """The snapshot's jobs in ``WriteAheadLog.replay`` shape, ready to
    merge with the WAL tail and feed to ``scheduler.recover``."""
    return {d["job_id"]: ("snap", _job_from_dict(d))
            for d in doc.get("jobs", ())}


def restore_snapshot(scheduler, doc: dict) -> dict:
    """Apply the snapshot's meta/node flags and id counter; returns the
    replay-shaped job dict (caller overlays the WAL tail, then calls
    ``scheduler.recover``)."""
    scheduler._next_job_id = max(scheduler._next_job_id,
                                 int(doc.get("next_job_id", 1)))
    for name, st in (doc.get("nodes") or {}).items():
        node_id = scheduler.meta._name_to_id.get(name)
        if node_id is None:
            continue  # node removed from config since the snapshot
        node = scheduler.meta.nodes[node_id]
        node.drained = bool(st.get("drained", False))
        node.health_drained = bool(st.get("health_drained", False))
        node.power_state = st.get("power_state", "ACTIVE")
        if st.get("address"):
            node.address = st["address"]
    return snapshot_to_replay(doc)


class SnapshotStore:
    """Durable snapshot file beside the WAL (``<wal>.snap``): written to
    a temp file, fsync'd, atomically renamed, directory fsync'd — a
    crash mid-save leaves the previous snapshot intact."""

    def __init__(self, wal_path: str):
        self.path = wal_path + ".snap"

    def save(self, doc: dict) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(doc, fh, separators=(",", ":"))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.path)
        d = os.path.dirname(self.path) or "."
        try:
            fd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        except OSError:
            pass

    def load(self) -> dict | None:
        try:
            with open(self.path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError):
            return None
        if doc.get("version") != SNAPSHOT_VERSION:
            return None
        return doc


def recover_from_snapshot(scheduler, wal_cls, wal_path: str,
                          now: float) -> tuple[int, int]:
    """Boot-time recovery: snapshot + WAL tail when a snapshot exists,
    full replay otherwise.  Returns (#jobs recovered, snapshot seq)."""
    store = SnapshotStore(wal_path)
    doc = store.load()
    snap_seq = 0
    if doc is not None:
        snap_seq = int(doc.get("seq", 0))
        replayed = restore_snapshot(scheduler, doc)
        replayed.update(wal_cls.replay(wal_path, after_seq=snap_seq))
    else:
        replayed = wal_cls.replay(wal_path)
    # migration history rewrites the replay BEFORE recover: committed
    # handoffs' jobs drop out (they live on the dest), imported
    # partitions' node meta rebuilds in adoption order, in-flight
    # begins re-seal.  Requires the plane attached pre-recovery.
    fed = getattr(scheduler, "fed", None)
    if fed is not None:
        fed.prepare_recovery(wal_path, replayed,
                             snap_fed=(doc or {}).get("fed"))
    if replayed:
        scheduler.recover(replayed, now=now)
    return len(replayed), snap_seq


class Snapshotter(threading.Thread):
    """Leader-side periodic snapshot loop: capture under the server
    lock, rotate the WAL, persist durably, then prune covered segments.

    A crash between rotate and save only leaves extra sealed segments —
    replay still covers every record; pruning happens strictly after the
    snapshot hit disk."""

    def __init__(self, scheduler, wal, lock, wal_path: str,
                 interval: float = 60.0, min_records: int = 1):
        super().__init__(daemon=True, name="ha-snapshotter")
        self.scheduler = scheduler
        self.wal = wal
        self.lock = lock
        self.store = SnapshotStore(wal_path)
        self.interval = interval
        self.min_records = min_records
        self.snapshots_taken = 0
        self.last_seq = 0
        self._stop = threading.Event()

    def run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.snap_once()
            except Exception:  # never kill the loop; next tick retries
                pass

    def snap_once(self) -> int:
        """One capture+rotate+persist+prune pass.  Returns the snapshot
        seq (0 = skipped, nothing new)."""
        from cranesched_tpu_torch import ha as _ha
        with self.lock:
            seq = self.wal.durable_seq
            if seq - self.last_seq < self.min_records:
                return 0
            doc = capture_snapshot(self.scheduler, seq)
            self.wal.rotate()
        self.store.save(doc)
        self.wal.prune_segments(seq)
        self.last_seq = seq
        self.snapshots_taken += 1
        _ha.SNAPSHOTS.inc()
        _ha.WAL_SEQ_GAUGE.set(seq)
        return seq

    def stop(self) -> None:
        self._stop.set()
