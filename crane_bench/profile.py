"""The benchmark's own ``torch.profiler`` capture of the measured window and
its reduction: the card's busy time, the device operations that took the
most time, and the longest idle gaps named by what the host was doing.

The host's phases come from the harness's spans (each ``SubmitBatchJobs``
call and each ``Tick``) and, inside a cycle, from spans the harness records
around the scheduler's own phase methods (``instrument``): the profiler sees
only the thread that started it, and the cycle runs on a gRPC handler
thread, so the program's ``crane:solve:<label>`` profiler spans are not in
the capture (the card's kernels are, from every thread).  A gap in which the
interpreter's garbage collector ran is ``gc:gen<n>``.  A gap inside a tick
but in no phase span is ``tick:other`` (the RPC, the simulated plane's
advance, the cycle's own bookkeeping).  Host clock and profiler clock are
tied by a ``crane_bench:anchor`` span taken at a known ``perf_counter``.
"""

from __future__ import annotations

import bisect
import time

ANCHOR = "crane_bench:anchor"
TOP = 10
# scheduler methods whose calls name a phase of the cycle
PHASES = {
    "process_status_changes": "cycle:status_drain",
    "_pending_candidates": "cycle:candidates",
    "_priority_sort": "cycle:priority",
    "_build_batch": "cycle:batch",
    "_commit": "cycle:commit",
    "_drain_dispatch_ring": "cycle:dispatch",
}


def instrument(sched) -> list:
    """Record ``(name, t0, t1)`` on ``perf_counter`` around each call of the
    scheduler's phase methods and each solve closure
    (``crane:solve:<label>[:<part>]``), as instance attributes of this one
    scheduler.  A method the scheduler lacks is left out."""
    spans: list = []

    def timed(fn, name):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spans.append((name, t0, time.perf_counter()))
        return call

    for attr, name in PHASES.items():
        if hasattr(sched, attr):
            setattr(sched, attr, timed(getattr(sched, attr), name))
    solve = getattr(sched, "_traced_solve", None)
    if solve is not None:
        def traced(label, fn, part=None):
            name = f"crane:solve:{label}" + (f":{part}" if part else "")
            return timed(solve(label, fn, part), name)
        sched._traced_solve = traced
    return spans


def _union(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Capture:
    """Profile the card (and the host's annotations) from ``start`` to
    ``stop``."""

    def __init__(self, use_cuda: bool):
        self.use_cuda = use_cuda
        self._prof = None
        self.t0 = self.t1 = 0.0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.use_cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts, record_shapes=False,
                             with_stack=False, profile_memory=False)
        self._prof.__enter__()
        if self.use_cuda:
            torch.cuda.synchronize()
        with record_function(ANCHOR):
            self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if self.use_cuda:
            torch.cuda.synchronize()
        self.t1 = time.perf_counter()
        self._prof.__exit__(None, None, None)

    def _events(self):
        """(device, start_ns, end_ns, name) of every recorded event."""
        from torch.autograd import DeviceType

        for ev in self._prof.profiler.kineto_results.events():
            start = ev.start_ns()
            yield (ev.device_type() == DeviceType.CUDA, start,
                   start + ev.duration_ns(), ev.name())

    def reduce(self, ticks: list, submits: list, phases: list) -> dict:
        """``busy_s``, ``window_s``, time by device operation, the top
        operations and the longest idle gaps.  ``ticks`` and ``submits``:
        (t0, t1), ``phases``: (name, t0, t1), all on ``perf_counter``."""
        dev, anchors, host = [], [], set()
        for on_dev, a, b, name in self._events():
            if on_dev:
                dev.append((a, b, name))
            else:
                host.add(name)
                if name == ANCHOR:
                    anchors.append(a)
        if not anchors:
            raise RuntimeError("profiler capture lacks its anchor span")
        off = anchors[0] - self.t0 * 1e9
        w0, w1 = anchors[0], self.t1 * 1e9 + off
        # a device-side copy of a host annotation is not work on the card
        dev = [(max(a, w0), min(b, w1), n) for a, b, n in dev
               if n not in host and b > w0 and a < w1]
        busy = _union([a, b] for a, b, _n in dev)
        by_name: dict[str, float] = {}
        for a, b, n in dev:
            by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e9
        gaps, cur = [], w0
        for a, b in busy + [[w1, w1]]:
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        def on_clock(spans):
            return sorted((t0 * 1e9 + off, t1 * 1e9 + off, name)
                          for name, t0, t1 in spans)

        outer = on_clock([("tick:other", t0, t1) for t0, t1 in ticks]
                         + [("rpc:SubmitBatchJobs", t0, t1)
                            for t0, t1 in submits])
        inner = on_clock(phases)
        outer_at = [s[0] for s in outer]
        inner_at = [s[0] for s in inner]

        collect = on_clock([p for p in phases if p[0].startswith("gc:")])
        inner = [p for p in inner if not p[2].startswith("gc:")]
        inner_at = [s[0] for s in inner]

        def phase_of(m):
            # a collection runs inside whatever phase the interpreter was
            # in; the phase spans do not overlap one another (a solve runs
            # between the cycle's phases, never inside one)
            for a, b, name in collect:
                if a <= m < b:
                    return name
            j = bisect.bisect_right(inner_at, m) - 1
            if j >= 0 and m < inner[j][1]:
                return inner[j][2]
            k = bisect.bisect_right(outer_at, m) - 1
            if k >= 0 and m < outer[k][1]:
                return outer[k][2]
            return "harness"

        longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
        busy_s = sum(b - a for a, b in busy) / 1e9
        return {
            "busy_s": busy_s,
            "window_s": (w1 - w0) / 1e9,
            "by_name": by_name,
            "device_ops": [[n, s] for n, s in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[phase_of((a + b) / 2), (b - a) / 1e9]
                          for a, b in longest],
        }
