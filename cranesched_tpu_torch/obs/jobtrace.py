"""Per-job distributed tracing: event-sourced lifecycle timelines (the
port's copy of ``cranesched_tpu/obs/jobtrace.py``).

One append-only span per lifecycle edge, stamped at the existing hook
points of the control plane (scheduler submit/candidates/commit, the
dispatch ring's durability watermark, the craned register/spawn/cgroup
FSM) so "where did job 4711 spend its 3 s between submit and first step
launch" has an answer that survives requeues and HA failover:

    submit -> eligible -> placed -> committed_durable -> dispatched
           -> craned_received -> cgroup_ready -> step_start
           -> end | requeue

A timeline is keyed by (job_id, incarnation) — incarnation is the job's
``requeue_count`` at the time of the stamp, exactly the staleness tag
the dispatch/fencing paths already use, so a requeued job opens a fresh
timeline instead of interleaving spans from two runs.  ``requeue``
closes an incarnation; ``end`` closes the job.  Stamps are idempotent
per (incarnation, edge): a promoted standby that re-derives state from
the WAL can re-stamp freely without double-counting (the HA
completeness contract), and repeated candidate scans cost one set probe.

Clock domains: ctld-side spans use the ctld clock.  Craned-side spans
are re-based onto the ctld clock by the craned itself, using the push's
``now`` field as the anchor (span_t = request.now + local elapsed since
receive); the residual skew is bounded by the one-way network latency,
which is itself bounded by the ping RTT the craned already measures
(``crane_craned_ctld_seconds{op=ping}``) — each shipped span carries
that bound in its ``skew`` field so consumers can assert span sums
against wall clocks honestly.  The simulated node plane stamps on the
ctld clock directly (skew 0).

Memory is bounded: live timelines are evicted oldest-first past
``capacity`` live jobs and closed timelines spill from a ring of the
same capacity — both evictions are counted (``spilled``), never silent.

Derived metrics (per-process REGISTRY):

- ``crane_job_latency_seconds{edge=...}``  histogram of the latency of
  each edge RELATIVE TO the previous span in its timeline (the
  waterfall segment, not cumulative-from-submit).
- ``crane_job_latency_exemplar_job_id{edge=...}``  gauge holding the
  job_id of the worst observation per edge — the "which job do I look
  at" exemplar for a histogram that only keeps counts.
"""

from __future__ import annotations

import threading
import time

from cranesched_tpu_torch.obs.metrics import REGISTRY

#: lifecycle edges in waterfall order (terminal edges last)
SPAN_EDGES = ("submit", "eligible", "placed", "committed_durable",
              "dispatched", "craned_received", "cgroup_ready",
              "step_start", "end", "requeue")

#: federation spans — stamped on the SAME (job_id,
#: incarnation) key so a forwarded submit or an arbiter-placed gang
#: keeps one unbroken waterfall across shard boundaries.  Kept out of
#: SPAN_EDGES on purpose: they are optional interleavings, not part of
#: the single-controller lifecycle schema the SLO engine and the
#: happy-path tests assert on.
FED_EDGES = ("fed_forwarded", "arbiter_reserve", "arbiter_confirm")

_EDGE_ORDER = {e: i for i, e in enumerate(SPAN_EDGES)}
_TERMINAL = ("end", "requeue")

_MET_LAT = REGISTRY.histogram(
    "crane_job_latency_seconds",
    "Per-edge job lifecycle latency (delta from the previous span)")
_MET_EXEMPLAR = REGISTRY.gauge(
    "crane_job_latency_exemplar_job_id",
    "job_id of the worst-latency observation per lifecycle edge")
_MET_STAMPS = REGISTRY.counter(
    "crane_job_trace_stamps_total", "Lifecycle spans recorded")
_MET_SPILLED = REGISTRY.counter(
    "crane_job_trace_spilled_total",
    "Timelines evicted from the bounded store")

# stamp() runs inside the scheduling cycle: pre-bind the per-edge
# metric children so a hot-path observation never rebuilds its sorted
# label-key tuple (metrics._BoundCell — ~5x cheaper per stamp)
_LAT_CELLS = {e: _MET_LAT.labels(edge=e)
              for e in SPAN_EDGES + FED_EDGES}
_EX_CELLS = {e: _MET_EXEMPLAR.labels(edge=e)
             for e in SPAN_EDGES + FED_EDGES}
_STAMPS_CELL = _MET_STAMPS.labels()
_SPILLED_CELL = _MET_SPILLED.labels()


class _Timeline:
    """One incarnation's span list + the stamp-once edge set."""

    __slots__ = ("job_id", "incarnation", "spans", "edges", "next_seq",
                 "fencing_epoch", "closed")

    def __init__(self, job_id: int, incarnation: int):
        self.job_id = job_id
        self.incarnation = incarnation
        self.spans: list[dict] = []
        self.edges: set[str] = set()
        self.next_seq = 0
        self.fencing_epoch = 0
        self.closed = False

    def doc(self) -> dict:
        return {"job_id": self.job_id,
                "incarnation": self.incarnation,
                "fencing_epoch": self.fencing_epoch,
                "closed": self.closed,
                "spans": list(self.spans)}


class JobTraceRecorder:
    """Bounded, thread-safe store of per-job lifecycle timelines.

    The scheduler owns one instance (``scheduler.jobtrace``); the craned
    daemon records its local spans separately and ships them back inside
    StepStatusChange, where they land here through ``stamp`` with their
    original seq numbers (``seq`` parameter) so the merged timeline
    stays monotone."""

    def __init__(self, capacity: int = 4096, slo=None):
        self.capacity = max(int(capacity), 8)
        self.slo = slo
        self._lock = threading.Lock()
        # (job_id, incarnation) -> _Timeline; dicts iterate in insertion
        # order, which doubles as the oldest-first eviction order
        self._active: dict[tuple[int, int], _Timeline] = {}
        self._done: dict[tuple[int, int], _Timeline] = {}
        self.stamps_total = 0
        self.spilled = 0
        # wall seconds spent recording — the direct measurement behind
        # the "tracing costs <=2% of the cycle" guard (differencing
        # whole trace-on/off runs just reads scheduler jitter)
        self.self_time_s = 0.0

    # ------------------------------------------------------------------
    # recording
    # ------------------------------------------------------------------

    def stamp(self, job_id: int, incarnation: int, edge: str, t: float,
              node_id: int = -1, epoch: int = 0, skew: float = 0.0,
              seq: int | None = None, synthetic: bool = False) -> bool:
        """Record one span; returns False when this (incarnation, edge)
        was already stamped (idempotent — the HA re-stamp contract)."""
        t0 = time.perf_counter()
        with self._lock:
            out = self._stamp_locked(job_id, incarnation, edge, t,
                                     node_id, epoch, skew, seq,
                                     synthetic)
        self.self_time_s += time.perf_counter() - t0
        return out

    def stamp_many(self, edge: str, items, t: float) -> int:
        """Batch stamp under ONE lock acquisition: ``items`` yields
        (job_id, incarnation) pairs.  Used by the candidate scan, where
        most stamps are repeats that must cost one set probe.  Metric
        flushes are deferred and batched — one registry-lock round per
        batch instead of three per stamp."""
        n = 0
        lats: list[tuple[float, int]] = []
        t0 = time.perf_counter()
        with self._lock:
            for job_id, incarnation in items:
                if self._stamp_locked(job_id, incarnation, edge, t,
                                      -1, 0, 0.0, None, False,
                                      defer=lats):
                    n += 1
            if n:
                _STAMPS_CELL.inc(n)
            if lats:
                cell = _LAT_CELLS.get(edge)
                if cell is not None:
                    cell.observe_many(lat for lat, _ in lats)
                else:
                    for lat, _ in lats:
                        _MET_LAT.observe(lat, edge=edge)
                worst_lat, worst_job = max(lats)
                self._note_exemplar(edge, worst_lat, worst_job)
        self.self_time_s += time.perf_counter() - t0
        return n

    def _stamp_locked(self, job_id, incarnation, edge, t, node_id,
                      epoch, skew, seq, synthetic,
                      defer=None) -> bool:
        key = (job_id, incarnation)
        tl = self._active.get(key)
        if tl is None:
            tl = self._done.get(key)
            if tl is None:
                tl = _Timeline(job_id, incarnation)
                self._active[key] = tl
                if len(self._active) > self.capacity:
                    self._active.pop(next(iter(self._active)))
                    self.spilled += 1
                    _SPILLED_CELL.inc()
        if edge in tl.edges:
            return False
        if seq is None:
            seq = tl.next_seq
        tl.next_seq = max(tl.next_seq, seq + 1)
        if epoch:
            tl.fencing_epoch = max(tl.fencing_epoch, epoch)
        span = {"edge": edge, "seq": seq, "t": t, "node_id": node_id,
                "skew": skew}
        if synthetic:
            span["synthetic"] = True
        prev_t = tl.spans[-1]["t"] if tl.spans else None
        tl.spans.append(span)
        tl.edges.add(edge)
        self.stamps_total += 1
        if defer is None:
            _STAMPS_CELL.inc()
        if prev_t is not None and not synthetic:
            lat = max(t - prev_t, 0.0)
            if defer is not None:
                defer.append((lat, job_id))
            else:
                cell = _LAT_CELLS.get(edge)
                if cell is not None:
                    cell.observe(lat)
                else:  # off-schema edge from a remote span
                    _MET_LAT.observe(lat, edge=edge)
                self._note_exemplar(edge, lat, job_id)
        if (self.slo is not None and not synthetic
                and edge in self.slo.wanted):
            self.slo.record(edge,
                            {s["edge"]: s["t"] for s in tl.spans}, t)
        if edge in _TERMINAL:
            tl.closed = True
            self._active.pop(key, None)
            self._done[key] = tl
            if len(self._done) > self.capacity:
                self._done.pop(next(iter(self._done)))
                self.spilled += 1
                _SPILLED_CELL.inc()
        return True

    def _note_exemplar(self, edge: str, lat: float, job_id: int) -> None:
        # per-edge worst-latency exemplar (guarded by self._lock)
        worst = getattr(self, "_worst_map", None)
        if worst is None:
            worst = self._worst_map = {}
        if lat >= worst.get(edge, -1.0):
            worst[edge] = lat
            cell = _EX_CELLS.get(edge)
            if cell is not None:
                cell.set(job_id)
            else:
                _MET_EXEMPLAR.set(job_id, edge=edge)

    def next_seq(self, job_id: int, incarnation: int) -> int:
        """Next span seq for the timeline (0 when none exists yet) —
        the base propagated to craned so remote spans sort after the
        local ones."""
        with self._lock:
            tl = self._active.get((job_id, incarnation))
            if tl is None:
                tl = self._done.get((job_id, incarnation))
            return tl.next_seq if tl is not None else 0

    def seed_recovered(self, job, now: float) -> None:
        """Seed a timeline for a job re-adopted from a WAL replay or a
        standby promotion: synthetic spans back-date the edges the job
        has provably passed (submit always; through ``dispatched`` for
        a re-adopted running job).  Stamp-once makes this safe to call
        on state the old leader already stamped — a promoted standby
        neither drops nor double-stamps."""
        inc = getattr(job, "requeue_count", 0)
        submit_t = getattr(job, "submit_time", now) or now
        self.stamp(job.job_id, inc, "submit", submit_t, synthetic=True)
        if getattr(job, "start_time", None) is not None:
            st = job.start_time
            for edge in ("eligible", "placed", "committed_durable",
                         "dispatched"):
                self.stamp(job.job_id, inc, edge, st, synthetic=True)
        status = getattr(job, "status", None)
        if status is not None and getattr(status, "is_terminal", False):
            end_t = getattr(job, "end_time", None)
            self.stamp(job.job_id, inc, "end",
                       end_t if end_t is not None else now,
                       synthetic=True)

    # ------------------------------------------------------------------
    # reading
    # ------------------------------------------------------------------

    def timeline(self, job_id: int) -> dict | None:
        """All recorded incarnations of one job, oldest first."""
        with self._lock:
            incs = [tl.doc()
                    for store in (self._done, self._active)
                    for (jid, _inc), tl in store.items()
                    if jid == job_id]
        if not incs:
            return None
        incs.sort(key=lambda d: d["incarnation"])
        for doc in incs:
            doc["spans"].sort(key=lambda s: s["seq"])
        return {"job_id": job_id, "incarnations": incs}

    def ledger(self, job_ids) -> dict:
        """The lost/doubled audit over a set of submitted jobs: a job
        is LOST when no incarnation recorded a terminal ``end`` span,
        DOUBLED when more than one did (the double-dispatch bug class).
        Requeued incarnations close with ``requeue`` and don't count."""
        job_ids = list(job_ids)
        ends: dict[int, int] = {}
        with self._lock:
            for store in (self._done, self._active):
                for (jid, _inc), tl in store.items():
                    if "end" in tl.edges:
                        ends[jid] = ends.get(jid, 0) + 1
        lost = [j for j in job_ids if ends.get(j, 0) == 0]
        doubled = [j for j in job_ids if ends.get(j, 0) > 1]
        return {"lost": lost, "doubled": doubled,
                "checked": len(job_ids)}

    def stats(self) -> dict:
        with self._lock:
            return {"active": len(self._active),
                    "completed": len(self._done),
                    "spilled": self.spilled,
                    "stamps_total": self.stamps_total,
                    "self_time_s": round(self.self_time_s, 6),
                    "capacity": self.capacity}


def render_waterfall(doc: dict, width: int = 48) -> list[str]:
    """ASCII waterfall of one job's timeline doc (cstats --job).  Each
    incarnation renders as offset bars scaled to its own duration."""
    out: list[str] = []
    for inc in doc.get("incarnations", []):
        spans = inc["spans"]
        if not spans:
            continue
        t0 = spans[0]["t"]
        t1 = max(s["t"] for s in spans)
        dur = max(t1 - t0, 1e-9)
        out.append(f"job {doc['job_id']} incarnation "
                   f"{inc['incarnation']}"
                   + (" (closed)" if inc.get("closed") else "")
                   + f"  [{dur:.3f}s]")
        prev = t0
        for s in spans:
            off = int((s["t"] - t0) / dur * width)
            seg = max(int((s["t"] - prev) / dur * width), 0)
            bar = " " * max(off - seg, 0) + "-" * seg + "|"
            delta = s["t"] - prev
            extra = ""
            if s.get("node_id", -1) >= 0:
                extra += f" node={s['node_id']}"
            if s.get("skew"):
                extra += f" skew<={s['skew']:.4f}s"
            if s.get("synthetic"):
                extra += " (synthetic)"
            out.append(f"  {s['edge']:>18s} {bar:<{width + 2}s} "
                       f"+{delta:.4f}s{extra}")
            prev = s["t"]
    return out
