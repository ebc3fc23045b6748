"""Structured cluster event log: a bounded ring of typed, severity-
tagged events (the port's copy of ``cranesched_tpu/obs/events.py``).

Where the cycle trace answers "how long did cycle N take" and the job
timeline answers "where did job J spend its latency", the event log
answers "what HAPPENED": a node flapped, a deposed leader's push was
fenced, the watchdog ate a cycle crash, an SLO started burning, a job
was preempted or requeued, a steady-state cycle paid a recompile.  Each
event is a small dict with a monotonically increasing sequence number
so clients (``cevents``) and the HA follower can cursor over it.

Design points:

* Per-process instances, NOT a module singleton: tests (and the HA
  harness) run a leader and a standby ctld in one process, and each
  must keep its own ring.  The scheduler owns the ctld instance.
* The ring is bounded (``capacity``): emission is O(1) append under a
  lock; ``since()`` filters are O(ring).  Nothing here is on the solve
  hot path — the busiest emitter is preemption, which is already a
  WAL-write-sized operation.
* Follower replication does NOT go through the WAL (the WAL replay
  path is job-records-only by contract).  Instead the leader's ring is
  cursored by ``after_event_seq`` piggybacked on ``HaFetchWal``;
  :meth:`ingest` adopts replicated events on the follower, assigning
  LOCAL seq numbers but remembering the leader's seq as the cursor
  (``remote_seq``) so a promoted follower keeps emitting without a seq
  collision.

Event types (severity in parens) — the closed vocabulary the tests and
docs assert on lives in :data:`EVENT_TYPES`:

    node_up (info)            craned registered / came back
    node_down (warning)       ping timeout or explicit down
    node_flap (warning)       node_up within FLAP_WINDOW of a down
    node_drain / node_undrain / node_poweroff / node_wake (info)
    fencing_rejection (error) a craned refused a push from a stale epoch
    watchdog_crash (error)    a scheduling cycle raised and was contained
    failover (critical)       this ctld promoted itself to leader
    slo_breach (error)        an SLO edge crossed its burn threshold
    slo_clear (info)          the breach condition cleared
    preemption (warning)      a running job was evicted for a higher one
    requeue (info)            a job went back to pending
    recompile_steady (warning) a warm cycle paid a fresh build (nvcc/g++)
    profile_capture (info)    a profiler window started/stopped
    fed_lease_granted (info)  this shard leased nodes to the arbiter
    fed_lease_revoked (warning) a lease expired/aborted and was dropped
    fed_forward (info)        a misrouted submit was forwarded
    fed_arbiter_commit (info) a cross-partition gang fully confirmed
    fed_arbiter_abort (warning) a partially-confirmed gang was undone
    flight_stall (error)      the flight-recorder stall sentry fired
                              (cycle deadline passed; stacks captured)
    cgroup_adopt_fallback (warning) PAM adoption granted access without
                              cgroup containment (cgroupfs unavailable)
"""

from __future__ import annotations

import itertools
import threading
import time as _time
from collections import deque

from cranesched_tpu_torch.obs.metrics import REGISTRY as _OBS

SEVERITIES = ("debug", "info", "warning", "error", "critical")
_SEV_RANK = {s: i for i, s in enumerate(SEVERITIES)}

EVENT_TYPES = frozenset({
    "node_up", "node_down", "node_flap", "node_drain", "node_undrain",
    "node_poweroff", "node_wake", "fencing_rejection", "watchdog_crash",
    "failover", "slo_breach", "slo_clear", "preemption", "requeue",
    "recompile_steady", "profile_capture",
    # federated control plane (fed/): lease lifecycle on the shard,
    # misrouted-submit forwarding, arbiter two-phase outcomes
    "fed_lease_granted", "fed_lease_revoked", "fed_forward",
    "fed_arbiter_commit", "fed_arbiter_abort",
    # stall forensics (obs/flight.py): the armed cycle deadline passed
    # and the sentry captured all-thread stacks into last_stall
    "flight_stall",
    # craned PAM adoption fell back past cgroup containment (the
    # best-effort gap in craned/daemon.py, surfaced so drills can
    # assert on it instead of grepping logs)
    "cgroup_adopt_fallback",
})

#: a node_up this many seconds after a node_down counts as a flap
FLAP_WINDOW = 300.0

_MET_EVENTS = _OBS.counter(
    "crane_events_total",
    "structured cluster events emitted, by type and severity")


def severity_rank(severity: str) -> int:
    """Ordinal for severity filtering; unknown severities rank lowest."""
    return _SEV_RANK.get(severity, -1)


class EventLog:
    """Bounded, thread-safe ring of cluster events."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._seq = itertools.count(1)
        self._last_seq = 0
        #: highest LEADER seq ingested via replication (follower cursor)
        self.remote_seq = 0
        # node -> last node_down time, for flap detection
        self._down_at: dict[str, float] = {}

    # -- emission --

    def emit(self, type: str, severity: str = "info", *, node: str = "",
             job_id: int = 0, detail: str = "", time: float = 0.0) -> dict:
        """Append one event; returns the stored record (with its seq)."""
        if severity not in _SEV_RANK:
            severity = "info"
        rec = {
            "seq": 0,  # assigned under the lock below
            "time": float(time) if time else _time.time(),
            "type": str(type),
            "severity": severity,
            "node": str(node),
            "job_id": int(job_id),
            "detail": str(detail),
        }
        with self._lock:
            rec["seq"] = next(self._seq)
            self._last_seq = rec["seq"]
            self._ring.append(rec)
        _MET_EVENTS.inc(type=rec["type"], severity=severity)
        return rec

    def emit_node_transition(self, event: str, node: str,
                             detail: str = "", now: float = 0.0) -> dict:
        """Node lifecycle emission with flap detection: a ``node_up``
        within :data:`FLAP_WINDOW` seconds of the node's last
        ``node_down`` additionally emits a ``node_flap`` warning."""
        now = float(now) if now else _time.time()
        event = (event if event.startswith("node_") else f"node_{event}")
        sev = "warning" if event == "node_down" else "info"
        rec = self.emit(event, severity=sev, node=node, detail=detail,
                        time=now)
        if rec["type"] == "node_down":
            with self._lock:
                self._down_at[node] = now
        elif rec["type"] == "node_up":
            with self._lock:
                down = self._down_at.pop(node, None)
            if down is not None and now - down <= FLAP_WINDOW:
                self.emit("node_flap", severity="warning", node=node,
                          detail="up %.1fs after down" % (now - down),
                          time=now)
        return rec

    def ingest(self, rec: dict) -> bool:
        """Adopt one REPLICATED event (follower side).  The leader's seq
        becomes the replication cursor; the stored copy gets a local
        seq so post-promotion emissions stay monotonic.  Returns False
        for duplicates (at-least-once fetches)."""
        origin = int(rec.get("seq", 0))
        with self._lock:
            if origin and origin <= self.remote_seq:
                return False
            local = dict(rec)
            local["seq"] = next(self._seq)
            self._last_seq = local["seq"]
            if origin:
                self.remote_seq = origin
            self._ring.append(local)
        return True

    # -- queries --

    @property
    def last_seq(self) -> int:
        with self._lock:
            return self._last_seq

    def since(self, after_seq: int = 0, severity: str = "",
              since_time: float = 0.0, type: str = "",
              limit: int = 0) -> list:
        """Events after ``after_seq``, optionally filtered by minimum
        severity, start time, and exact type; oldest first, capped at
        ``limit`` NEWEST matches when limit > 0."""
        min_rank = severity_rank(severity) if severity else -1
        with self._lock:
            out = [dict(r) for r in self._ring
                   if r["seq"] > after_seq
                   and severity_rank(r["severity"]) >= min_rank
                   and r["time"] >= since_time
                   and (not type or r["type"] == type)]
        if limit > 0 and len(out) > limit:
            out = out[-limit:]
        return out

    def stats(self) -> dict:
        with self._lock:
            return {"events": len(self._ring), "last_seq": self._last_seq,
                    "capacity": self.capacity,
                    "remote_seq": self.remote_seq}
