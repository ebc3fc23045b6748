"""Durable job history archive (the port's copy of
``cranesched_tpu/ctld/archive.py``).

The reference archives terminal jobs to MongoDB and only then purges
them from the embedded WAL (PersistAndTransferJobsToMongodb_, reference:
src/CraneCtld/JobScheduler.cpp:6918-6948; the accounting/history DB
surface is DbClient.h:87-724).  Here every finalized job is appended to
a sqlite file BEFORE it can be purged anywhere, so history survives WAL
compaction and restarts.

sqlite over a bespoke file: durable (WAL journal), queryable with
indexes (user/account/partition/time), concurrent-reader safe, stdlib.
"""

from __future__ import annotations

import json
import sqlite3
import threading

from cranesched_tpu_torch.ctld.defs import Job
from cranesched_tpu_torch.ctld.wal import _job_from_dict, _job_to_dict

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id      INTEGER PRIMARY KEY,
    name        TEXT,
    user        TEXT,
    account     TEXT,
    partition   TEXT,
    status      TEXT,
    submit_time REAL,
    start_time  REAL,
    end_time    REAL,
    exit_code   INTEGER,
    record      TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_jobs_user ON jobs (user);
CREATE INDEX IF NOT EXISTS idx_jobs_account ON jobs (account);
CREATE INDEX IF NOT EXISTS idx_jobs_partition ON jobs (partition);
CREATE INDEX IF NOT EXISTS idx_jobs_end ON jobs (end_time);
"""


class JobArchive:
    """Append-on-finalize job history (INSERT OR REPLACE keyed by
    job_id: an array parent finalizing after its children, or a
    recovery re-archive, simply refreshes the row)."""

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        self._db.executescript(_SCHEMA)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._db.close()

    def append(self, job: Job) -> None:
        record = json.dumps(_job_to_dict(job), separators=(",", ":"))
        with self._lock:
            self._db.execute(
                "INSERT OR REPLACE INTO jobs (job_id, name, user, "
                "account, partition, status, submit_time, start_time, "
                "end_time, exit_code, record) "
                "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (job.job_id, job.spec.name, job.spec.user,
                 job.spec.account, job.spec.partition, job.status.name,
                 job.submit_time, job.start_time, job.end_time,
                 job.exit_code, record))
            self._db.commit()

    def query(self, job_ids=(), user: str = "", partition: str = "",
              limit: int = 0, after_job_id: int = 0,
              keyset: bool = False) -> list[Job]:
        """Filterable history read.  Default order is newest first;
        with ``keyset`` (or a nonzero ``after_job_id``) the read
        becomes a keyset page (ascending job id, strictly after the
        cursor — 0 = from the start) so pagination reaches EVERY
        archived row: applying the cursor post-hoc to a newest-first
        capped read would silently hide everything past the cap."""
        keyset = keyset or bool(after_job_id)
        clauses, params = [], []
        if job_ids:
            clauses.append("job_id IN (%s)"
                           % ",".join("?" * len(job_ids)))
            params.extend(int(j) for j in job_ids)
        if user:
            clauses.append("user = ?")
            params.append(user)
        if partition:
            clauses.append("partition = ?")
            params.append(partition)
        if after_job_id:
            clauses.append("job_id > ?")
            params.append(int(after_job_id))
        sql = "SELECT record FROM jobs"
        if clauses:
            sql += " WHERE " + " AND ".join(clauses)
        sql += (" ORDER BY job_id ASC" if keyset
                else " ORDER BY end_time DESC, job_id DESC")
        if limit:
            sql += " LIMIT ?"
            params.append(int(limit))
        with self._lock:
            rows = self._db.execute(sql, params).fetchall()
        return [_job_from_dict(json.loads(r[0])) for r in rows]

    def __contains__(self, job_id: int) -> bool:
        with self._lock:
            row = self._db.execute(
                "SELECT 1 FROM jobs WHERE job_id = ?",
                (job_id,)).fetchone()
        return row is not None

    def count(self) -> int:
        with self._lock:
            return self._db.execute(
                "SELECT COUNT(*) FROM jobs").fetchone()[0]

    def max_job_id(self) -> int:
        """Highest archived job id (0 = empty) — seeds the id counter
        after a restart whose WAL was compacted, so reused ids can never
        INSERT OR REPLACE over history."""
        with self._lock:
            row = self._db.execute(
                "SELECT MAX(job_id) FROM jobs").fetchone()
        return int(row[0] or 0)
