"""Structured per-cycle traces + profiler span helper (the port's copy
of ``cranesched_tpu/obs/trace.py``; the span is ``torch.profiler``'s).

``CycleTraceRing`` keeps the last N cycle traces (plain dicts, schema
below) in a bounded deque — cheap enough to run always-on, queryable
over RPC through QueryStats (``cstats --cycles`` renders it).

Cycle-trace schema (ARCHITECTURE.md "Observability"):

    now              float   scheduler clock the cycle ran at
    solver           str     route ("cuda", "cuda-stream", "native",
                             "backfill", "backfill-split"...)
    prelude_ms       float   lock-held bookkeeping before the solve
    solve_ms         float   lock-RELEASED time in yielded closures
    commit_ms        float   lock-held time after the first solve
    dispatch_ms      float   lock-RELEASED post-commit push fan-out
    total_ms         float   wall time of the whole cycle
    lock_held_ms     float   prelude_ms + commit_ms (never the solve
                             and never the dispatch drain)
    wal_fsyncs       int     durability barriers this cycle (== WAL
                             groups when group commit is active)
    wal_groups       int     WAL groups flushed this cycle (<= 3)
    candidates       int     jobs considered this cycle
    placed           int     jobs started (incl. backfill tail)
    preempted        int     victims killed by this cycle
    backfilled       int     placed with start_bucket > 0 (future start)
    queue_depth      int     pending queue size at cycle start
    dirty_jobs       int     PendingTable rows dirtied since last cycle
    dirty_nodes      int     node rows patched into the cached snapshot
                             (0 on a cache hit; == all nodes on rebuild)
    skip_reason      str     only on solver="skip" rows: why the cycle
                             short-circuited ("fingerprint")
    skips            int     only on solver="skip" rows: consecutive
                             skipped cycles coalesced into this row
                             (idle clusters would otherwise flush the
                             ring with identical no-op entries)
    recompiles       int     run-time builds (nvcc kernels, the native
                             library) this cycle paid (obs/introspect.py)
    device_bytes     int     bytes allocated on the card after the cycle
    device_peak_bytes int    peak allocated bytes (-1 on the CPU)
    device_buffers   int     live allocations (-1 on the CPU)

``solve_span`` wraps a solve closure in
``torch.profiler.record_function`` so a captured profiler trace (the
scheduler's ``ProfilerWindow``, obs/introspect.py) shows one named span
per solve phase, ``crane:solve:<label>``; outside a capture it costs one
check of whether a profiler is running.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from typing import Iterator


class CycleTraceRing:
    """Thread-safe bounded ring of per-cycle trace dicts."""

    def __init__(self, size: int = 64):
        self._ring = collections.deque(maxlen=max(int(size), 1))
        self._lock = threading.Lock()

    def push(self, trace: dict) -> None:
        with self._lock:
            self._ring.append(trace)

    def snapshot(self, last: int | None = None) -> list[dict]:
        """Newest-last copy of the ring (optionally only the last N)."""
        with self._lock:
            out = list(self._ring)
        return out if last is None else out[-last:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


@contextlib.contextmanager
def solve_span(name: str) -> Iterator[None]:
    """``torch.profiler.record_function`` span around a solve closure:
    a trace captured by the profiler window shows one named span per
    cycle phase, so the card's kernels line up with the cycle trace's
    timings."""
    from torch.profiler import record_function

    with record_function(name):
        yield
