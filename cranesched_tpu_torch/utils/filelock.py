"""flock(2)-based advisory file lock.

Used as the HA leader lease on the WAL directory and, independently, as
the plain single-ctld startup guard: two cranectlds appending to one WAL
corrupt it silently (interleaved JSON lines, duplicate job ids), so the
second must fail fast instead.

The lock is advisory and per-host (flock does not span NFS reliably on
all kernels, and never spans hosts on local filesystems) — the HA story
documented in ARCHITECTURE.md assumes leader and standby share the WAL
directory's host or a correctly-flock'ing shared filesystem.  Crucially
an flock dies with its holder: a SIGKILL'd leader releases the lease the
instant the kernel reaps it, with no TTL to wait out and no stale lock
file to clean up.
"""

from __future__ import annotations

import errno
import fcntl
import os
import time


class FileLockHeld(RuntimeError):
    """The lock is held by another live process."""


class FileLock:
    """Exclusive advisory lock on ``path`` (created if missing).

    ``acquire(blocking=False)`` raises :class:`FileLockHeld` when the
    lock is held elsewhere; ``acquire(timeout=...)`` polls until the
    deadline.  The holder's pid is written into the file purely as a
    diagnostic — the kernel lock, not the content, is the truth.
    Usable as a context manager.
    """

    def __init__(self, path: str):
        self.path = path
        self._fh = None

    @property
    def held(self) -> bool:
        return self._fh is not None

    def acquire(self, blocking: bool = False,
                timeout: float | None = None,
                poll_interval: float = 0.1) -> "FileLock":
        if self._fh is not None:
            return self
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        fh = open(self.path, "a+")
        try:
            while True:
                try:
                    flags = fcntl.LOCK_EX
                    if not blocking:
                        flags |= fcntl.LOCK_NB
                    fcntl.flock(fh.fileno(), flags)
                    break
                except OSError as e:
                    if e.errno not in (errno.EACCES, errno.EAGAIN):
                        raise
                    if deadline is None or time.monotonic() >= deadline:
                        raise FileLockHeld(
                            f"{self.path} is locked by another process "
                            f"({self._holder_hint(fh)})") from None
                    time.sleep(poll_interval)
        except BaseException:
            fh.close()
            raise
        # diagnostics only; racy by design (the flock is authoritative)
        try:
            fh.seek(0)
            fh.truncate()
            fh.write(f"{os.getpid()}\n")
            fh.flush()
        except OSError:
            pass
        self._fh = fh
        return self

    @staticmethod
    def _holder_hint(fh) -> str:
        try:
            fh.seek(0)
            pid = fh.read().strip()
            return f"pid {pid}" if pid else "pid unknown"
        except OSError:
            return "pid unknown"

    def release(self) -> None:
        if self._fh is None:
            return
        fh, self._fh = self._fh, None
        try:
            fcntl.flock(fh.fileno(), fcntl.LOCK_UN)
        finally:
            fh.close()

    def __enter__(self) -> "FileLock":
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()
