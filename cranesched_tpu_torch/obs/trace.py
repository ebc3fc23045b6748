"""Structured per-cycle traces and the cycle's span tree (the port's
copy of ``cranesched_tpu/obs/trace.py``, with the span recorder the JAX
package lacks).

``CycleTraceRing`` keeps the last N cycle traces (plain dicts, schema
below) in a bounded deque — cheap enough to run always-on, queryable
over RPC through QueryStats (``cstats --cycles`` renders it,
``cstats --spans`` the newest row's span tree).

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
    wal_bytes        int     bytes the WAL wrote this cycle
    wal_records      int     records the WAL wrote this cycle
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
    cycle            int     the cycle's sequence number (a skip row's:
                             its newest cycle's)
    t0               float   the cycle's start on ``time.perf_counter``
    spans            list    the span tree, ``[name, parent, start,
                             end]`` each: ``parent`` the index of the
                             parent span in this list (-1 at the top),
                             ``start`` and ``end`` ms relative to ``t0``

``CycleSpans`` records the span tree.  Its root, ``cycle``, runs from
the scheduler's ``cycle_phases`` entry to its end; the root's direct
children follow one another (``drain``, ``candidates``, ``snapshot``,
``priority``, ``batch``, ``timed_state``, ``wal:flush``,
``solve:<label>[:<part>]``, ``commit[:head|:tail]``, ``preempt``,
``stage``, ``record``, ``dispatch``), so the root's time outside them is
the cycle's unnamed rest.  A server's own spans before the root
(``lock_wait``, ``sim_advance``) sit at the top of the same list.  The
recorder is always on and costs a list append and two clock reads a
span; while a ``torch.profiler`` capture runs (the scheduler's
``ProfilerWindow``, obs/introspect.py) each span also enters
``record_function("crane:<name>")``, so the capture shows the tree on
the profiler's own clock.
"""

from __future__ import annotations

import collections
import sys
import threading
import time


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


def _profiling() -> bool:
    """Whether a ``torch.profiler`` capture records this thread (torch
    is never imported here: a process that has not loaded it runs no
    profiler)."""
    torch = sys.modules.get("torch")
    return torch is not None and torch._C._autograd._profiler_enabled()


class CycleSpans:
    """The span tree of the scheduler's cycles, one list per cycle.

    ``begin`` opens the next cycle's root and ``end`` closes whatever
    is still open; between them ``span(name)`` (or ``open``/``close``)
    records a span under the innermost open one.  Outside a cycle every
    call records nothing.  Spans are lists, closed in place: the row
    that holds the list (``fields``) sees spans that close after it was
    pushed to the ring, the root and the dispatch drain among them.

    One cycle at a time, as the scheduler runs them; the phases of a
    cycle may run on different threads, one after another."""

    def __init__(self):
        self.cycle = 0
        self.t0 = 0.0
        self.spans: list[list] = []
        self._open: list[int] = []
        self._early: list[tuple[str, float, float]] = []
        self._profiled: dict[int, object] = {}

    def before(self, name: str, start: float, end: float) -> None:
        """A span of the next cycle's row that ends before its root
        opens (the server's wait for its lock, the simulated plane's
        advance); ``start`` and ``end`` on ``perf_counter``."""
        self._early.append((name, start, end))

    def begin(self) -> None:
        """Open the next cycle's root span, at ``t0``."""
        t0 = time.perf_counter()
        self.cycle += 1
        self.t0 = t0
        self.spans = [[name, -1, (a - t0) * 1e3, (b - t0) * 1e3]
                      for name, a, b in self._early]
        self._early = []
        self._open = []
        self._push("cycle", -1, 0.0)

    def end(self) -> None:
        """Close every open span, the root last."""
        while self._open:
            self.close(self._open[-1])

    def fields(self) -> dict:
        """The row fields of the current cycle."""
        return {"cycle": self.cycle, "t0": self.t0, "spans": self.spans}

    def open(self, name: str) -> int:
        """Open a span under the innermost open one; returns its index
        (-1 outside a cycle)."""
        if not self._open:
            return -1
        return self._push(name, self._open[-1],
                          (time.perf_counter() - self.t0) * 1e3)

    def _push(self, name: str, parent: int, start: float) -> int:
        i = len(self.spans)
        self.spans.append([name, parent, start, None])
        self._open.append(i)
        if _profiling():
            from torch.autograd.profiler import record_function

            rf = record_function("crane:" + name)
            rf.__enter__()
            self._profiled[i] = rf
        return i

    def close(self, i: int) -> None:
        """Close span ``i`` (a no-op for -1 or a span already closed)."""
        if i not in self._open:
            return
        self.spans[i][3] = (time.perf_counter() - self.t0) * 1e3
        self._open.remove(i)
        rf = self._profiled.pop(i, None)
        if rf is not None:
            rf.__exit__(None, None, None)

    def span(self, name: str) -> "_Span":
        """``with spans.span(name):`` records the block as one span."""
        return _Span(self, name)


class _Span:
    __slots__ = ("_rec", "_name", "_i")

    def __init__(self, rec: CycleSpans, name: str):
        self._rec, self._name = rec, name

    def __enter__(self) -> None:
        self._i = self._rec.open(self._name)

    def __exit__(self, *exc) -> None:
        self._rec.close(self._i)


def span_tree(row: dict) -> list[tuple[int, str, float, float, float]]:
    """``(depth, name, start, duration, self time)`` of each span of a
    trace row, in the row's order (ms; a span still open ends at the
    latest end in the row).  Self time is the span's duration less the
    union of its direct children."""
    spans = row.get("spans") or []
    last = max((s[3] for s in spans if s[3] is not None), default=0.0)
    ends = [last if s[3] is None else s[3] for s in spans]
    depth, kids = [], [[] for _ in spans]
    for i, (_name, parent, _start, _end) in enumerate(spans):
        depth.append(depth[parent] + 1 if parent >= 0 else 0)
        if parent >= 0:
            kids[parent].append(i)
    out = []
    for i, (name, _parent, start, _end) in enumerate(spans):
        covered, reach = 0.0, start
        for k in sorted(kids[i], key=lambda k: spans[k][2]):
            a, b = max(spans[k][2], reach), min(ends[k], ends[i])
            if b > a:
                covered += b - a
                reach = b
        dur = ends[i] - start
        out.append((depth[i], name, start, dur, dur - covered))
    return out


def render_span_tree(row: dict) -> list[str]:
    """A trace row's span tree as display lines: each span indented by
    its depth, with its start, duration and self time in ms."""
    lines = [f"cycle {row.get('cycle')} now={row.get('now')} "
             f"solver={row.get('solver')} total_ms={row.get('total_ms')}"]
    tree = span_tree(row)
    width = max([4] + [2 * d + len(n) for d, n, *_ in tree])
    lines.append(f"{'SPAN':<{width}}  {'START_MS':>10}  {'MS':>10}  "
                 f"{'SELF_MS':>10}")
    for d, name, start, dur, self_ms in tree:
        lines.append(f"{'  ' * d + name:<{width}}  {start:>10.3f}  "
                     f"{dur:>10.3f}  {self_ms:>10.3f}")
    return lines
