"""Write-ahead log of job runtime state + restart recovery (the port's
copy of ``cranesched_tpu/ctld/wal.py``: the record format is the same
field for field, so a log written by either package replays into the
other).

The reference keeps every pending/running job's runtime attributes in an
embedded KV store (unqlite/BerkeleyDB behind IEmbeddedDb, reference:
src/CraneCtld/Database/EmbeddedDbClient.h:85-204), written BEFORE dispatch
and updated on every status change, then purged once the job is terminal
and archived to MongoDB.  On restart, JobScheduler::Init
(JobScheduler.cpp:191-1091) replays it: pending jobs re-queue, running
jobs are re-adopted.

Here the WAL is an append-only JSON-lines file — human-debuggable, crash
append-atomic (one line per event), and replayable in one pass.  Events
are durable before they take effect: a lone append fsyncs immediately,
while a ``group()``/``begin_batch()`` batch buffers its encoded lines
and commits them with one write + one fsync (classic group commit — the
durability barrier is amortized over the batch, and no dispatch happens
for any job in the group until that barrier returns).
Terminal jobs are retained as ``finalized`` tombstones; ``compact()``
rewrites the live prefix the way the reference purges finalized rows.

HA additions: every record carries a monotonically increasing ``seq``
(the replication cursor), recent records are kept in an in-memory tail
buffer the leader serves to a polling standby, and ``rotate()`` seals
the active file into a ``.seg.<lastseq>`` segment so a snapshot can
absorb the prefix and recovery replays snapshot + tail instead of the
full history.  Records written before the seq field replay as seq 0.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import glob
import json
import os
from typing import IO

from cranesched_tpu_torch.obs import REGISTRY as _OBS

from cranesched_tpu_torch.ctld.defs import (
    ArraySpec,
    Dependency,
    DepType,
    Job,
    JobSpec,
    JobStatus,
    PendingReason,
    ResourceSpec,
    Step,
    StepSpec,
    StepStatus,
)


def _res_to_dict(res: dict) -> dict:
    gres = res.pop("gres")
    res["gres"] = ([[list(k), v] for k, v in gres.items()]
                   if gres else None)
    return res


def _spec_to_dict(spec: JobSpec) -> dict:
    d = dataclasses.asdict(spec)
    d["res"] = _res_to_dict(d.pop("res"))
    task_res = d.pop("task_res")
    d["task_res"] = _res_to_dict(task_res) if task_res else None
    d["include_nodes"] = list(spec.include_nodes)
    d["exclude_nodes"] = list(spec.exclude_nodes)
    d["dependencies"] = [[dep.job_id, dep.type.name, dep.delay_seconds]
                         for dep in spec.dependencies]
    d["array"] = (dataclasses.asdict(spec.array)
                  if spec.array is not None else None)
    return d


def _res_from_dict(res: dict) -> ResourceSpec:
    res = dict(res)
    gres = res.pop("gres")
    res["gres"] = ({tuple(k): v for k, v in gres} if gres else None)
    return ResourceSpec(**res)


_SPEC_FIELDS = {f.name for f in dataclasses.fields(JobSpec)}


def _spec_from_dict(d: dict) -> JobSpec:
    d = dict(d)
    d["res"] = _res_from_dict(d.pop("res"))
    task_res = d.pop("task_res", None)
    d["task_res"] = _res_from_dict(task_res) if task_res else None
    d["include_nodes"] = tuple(d.get("include_nodes") or ())
    d["exclude_nodes"] = tuple(d.get("exclude_nodes") or ())
    d["dependencies"] = tuple(
        Dependency(job_id=dep[0], type=DepType[dep[1]],
                   delay_seconds=dep[2])
        for dep in (d.get("dependencies") or ()))
    arr = d.get("array")
    d["array"] = ArraySpec(**arr) if arr else None
    # forward compatibility: records written by older versions may carry
    # fields the current JobSpec no longer has — drop, don't crash
    return JobSpec(**{k: v for k, v in d.items() if k in _SPEC_FIELDS})


def _job_to_dict(job: Job) -> dict:
    return {
        "job_id": job.job_id,
        "spec": _spec_to_dict(job.spec),
        "submit_time": job.submit_time,
        "status": job.status.name,
        "qos_name": job.qos_name,
        "qos_priority": job.qos_priority,
        "held": job.held,
        "cancel_requested": job.cancel_requested,
        "pending_reason": job.pending_reason.name,
        "start_time": job.start_time,
        "end_time": job.end_time,
        "exit_code": job.exit_code,
        "node_ids": job.node_ids,
        "task_layout": job.task_layout,
        "node_reports": {str(k): [v[0].name, v[1]]
                         for k, v in job.node_reports.items()},
        "requeue_count": job.requeue_count,
        "dep_state": {str(k): (None if v is None
                               else ("never" if v == float("inf") else v))
                      for k, v in job.dep_state.items()},
        "array_parent_id": job.array_parent_id,
        "array_task_id": job.array_task_id,
        "array_remaining": job.array_remaining,
        "array_children": job.array_children,
        "suspend_time": job.suspend_time,
        "suspended_total": job.suspended_total,
        "next_step_id": job.next_step_id,
        "cpu_seconds": job.cpu_seconds,
        "max_rss_bytes": job.max_rss_bytes,
        "steps": [_step_to_dict(s) for s in job.steps.values()],
    }


def _step_to_dict(step: Step) -> dict:
    sp = dataclasses.asdict(step.spec)
    res = sp.pop("res")
    sp["res"] = _res_to_dict(res) if res else None
    return {
        "step_id": step.step_id,
        "spec": sp,
        "submit_time": step.submit_time,
        "status": step.status.name,
        "start_time": step.start_time,
        "end_time": step.end_time,
        "exit_code": step.exit_code,
        "node_ids": step.node_ids,
        "node_reports": {str(k): [v[0].name, v[1]]
                         for k, v in step.node_reports.items()},
        "cancel_requested": step.cancel_requested,
        "cpu_seconds": step.cpu_seconds,
        "max_rss_bytes": step.max_rss_bytes,
    }


def _step_from_dict(d: dict) -> Step:
    sp = dict(d["spec"])
    res = sp.pop("res", None)
    sp["res"] = _res_from_dict(res) if res else None
    return Step(
        step_id=d["step_id"],
        spec=StepSpec(**sp),
        submit_time=d["submit_time"],
        status=StepStatus[d["status"]],
        start_time=d["start_time"],
        end_time=d["end_time"],
        exit_code=d["exit_code"],
        node_ids=list(d["node_ids"]),
        node_reports={int(k): (StepStatus[v[0]], v[1])
                      for k, v in (d.get("node_reports") or {}).items()},
        cancel_requested=d.get("cancel_requested", False),
        cpu_seconds=d.get("cpu_seconds", 0.0),
        max_rss_bytes=d.get("max_rss_bytes", 0),
    )


def _job_from_dict(d: dict) -> Job:
    return Job(
        job_id=d["job_id"],
        spec=_spec_from_dict(d["spec"]),
        submit_time=d["submit_time"],
        status=JobStatus[d["status"]],
        qos_name=d.get("qos_name", ""),
        # records written before the effective-qos field carried the
        # priority on the spec — fall back there, not to 0
        qos_priority=d.get("qos_priority",
                           d.get("spec", {}).get("qos_priority", 0)),
        held=d["held"],
        cancel_requested=d.get("cancel_requested", False),
        pending_reason=PendingReason[d["pending_reason"]],
        start_time=d["start_time"],
        end_time=d["end_time"],
        exit_code=d["exit_code"],
        node_ids=list(d["node_ids"]),
        task_layout=list(d.get("task_layout") or ()),
        node_reports={int(k): (JobStatus[v[0]], v[1])
                      for k, v in (d.get("node_reports") or {}).items()},
        requeue_count=d["requeue_count"],
        dep_state={int(k): (None if v is None
                            else (float("inf") if v == "never" else v))
                   for k, v in (d.get("dep_state") or {}).items()},
        array_parent_id=d.get("array_parent_id"),
        array_task_id=d.get("array_task_id"),
        array_remaining=list(d.get("array_remaining") or ()),
        array_children=list(d.get("array_children") or ()),
        suspend_time=d.get("suspend_time"),
        suspended_total=d.get("suspended_total", 0.0),
        next_step_id=d.get("next_step_id", 0),
        cpu_seconds=d.get("cpu_seconds", 0.0),
        max_rss_bytes=d.get("max_rss_bytes", 0),
        steps={s["step_id"]: _step_from_dict(s)
               for s in (d.get("steps") or ())},
    )


_MET_WAL_FSYNC = _OBS.counter(
    "crane_wal_fsync_total", "WAL durability barriers (os.fsync calls)")
_MET_WAL_GROUP = _OBS.histogram(
    "crane_wal_group_records", "records committed per WAL group",
    buckets=tuple(float(2 ** k) for k in range(17)))


def _fsync_dir(path: str) -> None:
    """fsync the directory holding ``path`` so a rename/unlink survives
    a host crash (an os.replace alone is only durable once the directory
    entry itself is)."""
    d = os.path.dirname(path) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return  # e.g. O_RDONLY on a dir unsupported — best-effort
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _segment_files(path: str) -> list[str]:
    """Sealed segments of ``path``, oldest first (the suffix is the
    zero-padded last seq in the segment, so lexical order is seq order)."""
    return sorted(glob.glob(glob.escape(path) + ".seg.*"))


class WriteAheadLog:
    """Append-only event log; each event carries the job's full runtime
    record so replay is last-writer-wins per job_id."""

    # records the leader keeps in memory for follower catch-up; a
    # follower further behind than this re-pulls a full snapshot
    TAIL_BUFFER = 4096

    def __init__(self, path: str, fsync: bool = True):
        """``fsync`` defaults to True: the daemon path must not lose
        acknowledged submits/status transitions to a host crash (the
        reference's embedded WAL writes before dispatch).  Tests and
        benchmarks that only need crash-*process* durability may pass
        fsync=False."""
        self.path = path
        self.fsync = fsync
        # resume the seq counter past everything durable (sealed
        # segments may hold the max when the active file is fresh)
        self.seq = 0
        for f in _segment_files(path) + [path]:
            self.seq = max(self.seq, self._scan_max_seq(f))
        # last seq known to be on disk; inside an open group, seq runs
        # ahead of durable_seq until the group's single fsync returns
        self.durable_seq = self.seq
        self._tail: collections.deque = collections.deque(
            maxlen=self.TAIL_BUFFER)
        self._group_depth = 0
        self._group_buf: list[tuple[int, str]] = []
        self.fsync_total = 0    # actual os.fsync calls (fsync=True only)
        self.groups_total = 0   # non-empty group flushes
        # what the appends wrote to the file: records and bytes
        # (compaction's rewrite is not an append)
        self.records_total = 0
        self.bytes_total = 0
        self._fh: IO[str] = open(path, "a", encoding="utf-8")

    @staticmethod
    def _scan_max_seq(path: str) -> int:
        last = 0
        if not os.path.exists(path):
            return last
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    last = max(last, json.loads(line).get("seq", 0))
                except json.JSONDecodeError:
                    continue  # torn tail
        return last

    def close(self) -> None:
        self._flush_group()
        self._fh.close()

    def _append(self, event: str, job: Job) -> None:
        self._append_rec(event, {"job": _job_to_dict(job)})

    def fed_event(self, event: str, payload: dict) -> int:
        """Durable federation record (``fed_reserve`` / ``fed_confirm``
        / ``fed_release``): carries a lease payload instead of a job, so
        :meth:`replay` skips it and :meth:`replay_fed` reconstructs the
        lease table.  Returns the record's seq (the arbiter's durability
        watermark — it must not act on the lease until
        ``durable_seq >= seq``)."""
        self._append_rec(event, {"fed": dict(payload)})
        return self.seq

    def _append_rec(self, event: str, body: dict) -> None:
        self.seq += 1
        rec = {"seq": self.seq, "ev": event, **body}
        line = json.dumps(rec, separators=(",", ":"))
        if self._group_depth > 0:
            # group commit: buffer the encoded line; seq numbers stay
            # contiguous (we are under the server lock), the write and
            # the single fsync happen at commit_batch
            self._group_buf.append((self.seq, line))
            return
        self._fh.write(line + "\n")
        self._fh.flush()
        self.records_total += 1
        self.bytes_total += len(line) + 1
        if self.fsync:
            os.fsync(self._fh.fileno())
            self.fsync_total += 1
            _MET_WAL_FSYNC.inc()
        self.durable_seq = self.seq
        self._tail.append((self.seq, line))

    # -- group commit (one durability barrier per batch) --

    def begin_batch(self) -> None:
        """Open (or nest into) a commit group: subsequent appends buffer
        in memory and become durable together at ``commit_batch``."""
        self._group_depth += 1

    def commit_batch(self) -> None:
        """Close one nesting level; at depth zero, write every buffered
        record with one ``write`` + one ``fsync``.  Tolerates being
        called with no open group (flushes any residue) so safety-net
        callers can invoke it unconditionally."""
        if self._group_depth > 0:
            self._group_depth -= 1
        if self._group_depth == 0:
            self._flush_group()

    @contextlib.contextmanager
    def group(self):
        self.begin_batch()
        try:
            yield self
        finally:
            self.commit_batch()

    def _flush_group(self) -> None:
        if not self._group_buf:
            return
        buf = self._group_buf
        self._group_buf = []
        data = "".join(line + "\n" for _seq, line in buf)
        self._fh.write(data)
        self._fh.flush()
        self.records_total += len(buf)
        self.bytes_total += len(data)
        if self.fsync:
            os.fsync(self._fh.fileno())
            self.fsync_total += 1
            _MET_WAL_FSYNC.inc()
        # the tail buffer feeds HaFetchWal: records enter it only after
        # the barrier, so a follower can never observe a non-durable seq
        self.durable_seq = buf[-1][0]
        self._tail.extend(buf)
        self.groups_total += 1
        _MET_WAL_GROUP.observe(len(buf))

    # -- replication feed (leader side) --

    def tail_since(self, after_seq: int, limit: int = 512
                   ) -> list[tuple[int, str]] | None:
        """Records with seq > ``after_seq`` from the in-memory buffer,
        or None when the cursor fell off the buffer (or points past our
        history — a diverged follower): the caller must resync from a
        snapshot."""
        if after_seq > self.durable_seq:
            return None
        floor = self._tail[0][0] if self._tail else self.durable_seq + 1
        if after_seq + 1 < floor:
            return None
        out = [(s, line) for s, line in self._tail if s > after_seq]
        return out[:limit] if limit else out

    # -- segment rotation --

    def rotate(self) -> int:
        """Seal the active file into a ``.seg.<lastseq>`` segment and
        start a fresh one.  Returns the sealed-through seq.  No-op on an
        empty active file."""
        self._flush_group()
        self._fh.flush()
        if self._fh.tell() == 0:
            return self.seq
        self._fh.close()
        sealed = f"{self.path}.seg.{self.seq:016d}"
        os.replace(self.path, sealed)
        _fsync_dir(self.path)
        self._fh = open(self.path, "a", encoding="utf-8")
        return self.seq

    def prune_segments(self, upto_seq: int) -> int:
        """Delete sealed segments fully covered by a durable snapshot
        (last seq <= ``upto_seq``).  Returns #segments removed."""
        n = 0
        for f in _segment_files(self.path):
            try:
                last = int(f.rsplit(".", 1)[1])
            except ValueError:
                continue
            if last <= upto_seq:
                try:
                    os.unlink(f)
                except FileNotFoundError:
                    continue  # a concurrent compact absorbed it
                n += 1
        if n:
            _fsync_dir(self.path)
        return n

    # -- the lifecycle hooks the scheduler calls --

    def job_submitted(self, job: Job) -> None:
        self._append("submit", job)

    def job_started(self, job: Job) -> None:
        self._append("start", job)

    def job_requeued(self, job: Job) -> None:
        self._append("requeue", job)

    def job_updated(self, job: Job) -> None:
        """Any other durable mutation: cancel intent, hold/release."""
        self._append("update", job)

    def job_finalized(self, job: Job) -> None:
        self._append("finalize", job)

    # -- recovery --

    @staticmethod
    def replay(path: str, after_seq: int = 0
               ) -> dict[int, tuple[str, Job]]:
        """Last-writer-wins replay: job_id -> (last event, job record).

        Reads sealed segments (oldest first) then the active file.
        ``after_seq`` skips records a snapshot already covers (records
        predating the seq field count as seq 0 and are only applied on a
        full replay)."""
        state: dict[int, tuple[str, Job]] = {}
        for rec in WriteAheadLog._iter_records(path):
            if after_seq and rec.get("seq", 0) <= after_seq:
                continue
            if "job" not in rec:
                continue  # federation record — replay_fed's domain
            job = _job_from_dict(rec["job"])
            state[job.job_id] = (rec["ev"], job)
        return state

    @staticmethod
    def replay_fed(path: str, after_seq: int = 0
                   ) -> dict[str, tuple[str, dict]]:
        """Last-writer-wins replay of federation lease records:
        lease_id -> (last event, payload).  A lease whose last record is
        ``fed_reserve`` was never confirmed nor released — recovery must
        drop it (release the nodes) because only a ``fed_confirm``
        record creates a job; this is what makes a shard crash mid-gang
        safe against double placement."""
        state: dict[str, tuple[str, dict]] = {}
        for rec in WriteAheadLog._iter_records(path, fed_only=True):
            if after_seq and rec.get("seq", 0) <= after_seq:
                continue
            fed = rec.get("fed")
            if fed is None or "lease_id" not in fed:
                continue  # migration records replay separately
            state[str(fed.get("lease_id", ""))] = (rec["ev"], fed)
        return state

    @staticmethod
    def replay_migrations(path: str) -> dict[str, dict]:
        """Reconstruct partition-migration state: mid -> merged payload
        with ``ev`` = the LAST recorded phase (``fed_migrate_begin`` /
        ``fed_migrate_import`` / ``fed_migrate_commit`` /
        ``fed_migrate_abort``).  Payload fields accumulate across the
        phases so a ``commit`` entry still carries the ``begin``
        record's job_ids — recovery needs them to drop migrated-away
        jobs the ordinary job replay just resurrected."""
        state: dict[str, dict] = {}
        for rec in WriteAheadLog._iter_records(path, fed_only=True):
            fed = rec.get("fed")
            if fed is None or "mid" not in fed:
                continue
            entry = state.setdefault(str(fed["mid"]), {})
            entry.update(fed)
            entry["ev"] = rec["ev"]
            # first-record seq: imports re-apply in arrival order on
            # recovery so adopted node ids re-number identically
            entry.setdefault("seq", rec.get("seq", 0))
        return state

    @staticmethod
    def _iter_records(path: str, fed_only: bool = False):
        """Every record of the sealed segments and the active file, in
        order.  ``fed_only`` skips, without decoding them, the lines that
        cannot hold a federation record (no ``"fed"`` token): the fed
        replays then read a log of 100,000 job records in a fraction of
        the time a full decode takes, with the same result."""
        for f in _segment_files(path) + [path]:
            if not os.path.exists(f):
                continue
            with open(f, encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line or (fed_only and '"fed"' not in line):
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        continue  # torn tail write from a crash

    def compact(self, live: dict[int, tuple[str, Job]] | None = None
                ) -> None:
        """Rewrite the log keeping only non-terminal jobs (the purge the
        reference does after archiving to MongoDB).

        Crash-safe: the survivors are written to a temp file, fsync'd,
        atomically renamed over the active file, and the directory entry
        itself fsync'd — a kill at any point leaves either the old log
        (plus an ignorable ``.tmp``) or the complete new one.  Sealed
        segments are absorbed into the rewrite and deleted.

        With sealed segments present the rewrite keeps every job's LAST
        record — terminal tombstones included.  Dropping a terminal job
        while its older (non-terminal) records still sit in a segment
        would resurrect it as RUNNING if the process dies between the
        active-file rename and the segment unlink (replay reads segments
        first and nothing in the new active file would supersede them).
        The tombstones fall out on the next segment-free compact."""
        # an open group's records would be silently dropped by the
        # rewrite (they exist only in memory) — make them durable first;
        # the group stays open for appends that follow the compact
        self._flush_group()
        segments = _segment_files(self.path)
        keep: list[tuple[int, str]] = []
        if live is not None and not segments:
            for job_id, (ev, job) in sorted(live.items()):
                if job.status.is_terminal:
                    continue
                keep.append((job_id, json.dumps(
                    {"seq": self.seq, "ev": ev, "job": _job_to_dict(job)},
                    separators=(",", ":"))))
        else:
            # re-read raw records so each survivor keeps its original
            # seq (follower cursors and segment ordering stay valid)
            last: dict[int, tuple[int, dict]] = {}
            for rec in self._iter_records(self.path):
                if "job" not in rec:
                    continue  # federation records survive separately
                last[rec["job"]["job_id"]] = (rec.get("seq", 0), rec)
            for job_id, (seq, rec) in sorted(last.items()):
                if not segments and \
                        JobStatus[rec["job"]["status"]].is_terminal:
                    continue
                keep.append((job_id, json.dumps(
                    rec, separators=(",", ":"))))
        # federation lease records: keep each lease's last record unless
        # it is resolved (confirmed or released) — dropping an
        # unresolved fed_reserve would resurrect its nodes on recovery
        # while the arbiter may still confirm against the lease.
        # Migration records key by mid.  ``fed_migrate_abort`` is the
        # only droppable migration state: a commit must survive forever
        # on the source (it is what filters the migrated-away jobs out
        # of replay) and an import must survive on the destination (the
        # source's crash recovery resolves begin-without-commit by
        # asking whether the import happened).
        fed_last: dict[str, dict] = {}
        for rec in self._iter_records(self.path):
            fed = rec.get("fed")
            if fed is None:
                continue
            key = (str(fed["lease_id"]) if "lease_id" in fed
                   else "mig:" + str(fed.get("mid", "")))
            fed_last[key] = rec
        for key in sorted(fed_last):
            rec = fed_last[key]
            if not segments and rec["ev"] in ("fed_confirm",
                                              "fed_release",
                                              "fed_migrate_abort"):
                continue
            keep.append((key, json.dumps(
                rec, separators=(",", ":"))))
        self._fh.close()
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as out:
            for _job_id, line in keep:
                out.write(line + "\n")
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, self.path)
        _fsync_dir(self.path)
        for f in segments:
            try:
                os.unlink(f)
            except FileNotFoundError:
                pass  # a concurrent prune got it first
        _fsync_dir(self.path)
        self._fh = open(self.path, "a", encoding="utf-8")
