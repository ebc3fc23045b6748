"""Leader lease + fencing epoch.

The lease is an flock on ``<wal>.lock`` — it dies with its holder, so a
SIGKILL'd leader frees it immediately and the standby's next acquisition
attempt succeeds (no TTL to wait out).  The fencing epoch is a counter
persisted beside the WAL (``<wal>.epoch``, atomic-rename updates): every
leadership term bumps it BEFORE the first dispatch, craneds latch the
highest epoch they have seen (register reply or any push), and reject
pushes below it — which is what actually stops a deposed-but-alive
leader whose kill/free RPCs are still in flight.  Epoch 0 means "no HA
configured" and disables the check.
"""

from __future__ import annotations

import os

from cranesched_tpu_torch.utils.filelock import FileLock, FileLockHeld

__all__ = ["FencingEpoch", "LeaderLease", "FileLockHeld"]


class FencingEpoch:
    """Monotonic leadership-term counter persisted next to the WAL."""

    def __init__(self, wal_path: str):
        self.path = wal_path + ".epoch"

    def load(self) -> int:
        try:
            with open(self.path, encoding="utf-8") as fh:
                return int(fh.read().strip() or 0)
        except (OSError, ValueError):
            return 0

    def observe(self, epoch: int) -> None:
        """Raise the persisted counter to at least ``epoch``.  A standby
        records the leader's term from every replication reply, so that
        when the ctlds do NOT share a filesystem (separate WAL dirs, so
        separate epoch files) a promotion still bumps strictly past the
        dead leader's term and the fence holds."""
        if epoch > self.load():
            self._write(epoch)

    def bump(self) -> int:
        """Durably advance to the next term and return it (>= 1)."""
        epoch = self.load() + 1
        self._write(epoch)
        return epoch

    def _write(self, epoch: int) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            fh.write(f"{epoch}\n")
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


class LeaderLease:
    """The WAL-directory lock + epoch pair a ctld must hold to lead."""

    def __init__(self, wal_path: str):
        self.wal_path = wal_path
        self.lock = FileLock(wal_path + ".lock")
        self.epoch_store = FencingEpoch(wal_path)
        self.epoch = 0

    @property
    def held(self) -> bool:
        return self.lock.held

    def acquire(self, timeout: float | None = None) -> int:
        """Take the lease and start a new term.  Raises
        :class:`FileLockHeld` when another ctld holds it."""
        self.lock.acquire(timeout=timeout)
        try:
            self.epoch = self.epoch_store.bump()
        except BaseException:
            self.lock.release()
            raise
        return self.epoch

    def release(self) -> None:
        self.lock.release()
