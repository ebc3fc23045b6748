"""Build telemetry, device-memory gauges, and on-demand profiler capture
windows (the port's counterpart of ``cranesched_tpu/obs/introspect.py``).

The JAX package counts the fresh XLA compiles of its jit entry points;
the port has no jit.  What it compiles at run time are its CUDA kernels
(``kernels/build.py``, one nvcc per source) and the native solver
library (``utils/native.py``, g++), each once per hash of its sources
into a cache under ``build/``.  This module makes those builds and the
card's memory observable with the JAX package's names:

* :func:`note_build` is called by the build cache (through
  ``flight.note_kernel_cache``) for every library it builds; it counts
  ``crane_build_total{fn}``, observes the build's wall time in
  ``crane_build_seconds{fn}`` and advances :func:`total_compiles`.
* :func:`sample_device_memory` reads ``torch.cuda.memory_stats()`` of
  the current device into the ``crane_device_bytes_live`` /
  ``crane_device_peak_bytes`` / ``crane_device_buffers_live`` gauges;
  without a card every field is -1.
* :class:`ProfilerWindow` arms an N-cycle ``torch.profiler`` capture;
  the scheduler ticks it at cycle boundaries and the chrome trace lands
  under ``profiles/`` (git-ignored).

The build counter is process-wide (the build cache is), but per-cycle
attribution is delta-based: the scheduler snapshots
:func:`total_compiles` at cycle start and records the delta in the
cycle trace (``recompiles``), emitting a ``recompile_steady`` event
when a warm cycle pays one.  All bookkeeping self-time is accumulated
in :func:`self_time_s` so a bench can show what the plane costs a
cycle.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional

from cranesched_tpu_torch.obs.metrics import REGISTRY as _OBS

log = logging.getLogger("obs.introspect")

_MET_BUILDS = _OBS.counter(
    "crane_build_total",
    "run-time builds (nvcc kernels, the g++ native library), by fn")
_MET_BUILD_SECONDS = _OBS.histogram(
    "crane_build_seconds",
    "wall time of run-time builds, by fn")
_MET_DEV_BYTES = _OBS.gauge(
    "crane_device_bytes_live",
    "bytes allocated on the card (-1 without one)")
_MET_DEV_PEAK = _OBS.gauge(
    "crane_device_peak_bytes",
    "peak bytes allocated on the card (-1 without one)")
_MET_DEV_BUFFERS = _OBS.gauge(
    "crane_device_buffers_live",
    "live allocations of the card's caching allocator (-1 without one)")

#: the chrome trace's file name inside a capture directory
TRACE_FILE = "trace.json"

_lock = threading.Lock()
_total_compiles = 0
_self_time = 0.0  # seconds spent inside introspection bookkeeping


def total_compiles() -> int:
    """Process-wide count of run-time builds (cycle-delta base)."""
    with _lock:
        return _total_compiles


def self_time_s() -> float:
    """Cumulative seconds of introspection overhead (build bookkeeping +
    memory sampling) — the numerator of a bench's overhead share."""
    with _lock:
        return _self_time


def _add_self_time(dt: float) -> None:
    global _self_time
    with _lock:
        _self_time += dt


def note_build(name: str, seconds: float) -> None:
    """Count one run-time build of ``name`` that took ``seconds``."""
    global _total_compiles
    t0 = time.perf_counter()
    _MET_BUILDS.inc(fn=name)
    _MET_BUILD_SECONDS.observe(seconds, fn=name)
    with _lock:
        _total_compiles += 1
    log.debug("build: %s (%.3fs)", name, seconds)
    _add_self_time(time.perf_counter() - t0)


def sample_device_memory(peak_reset: bool = False) -> dict:
    """The current card's allocator stats as a small dict.

    Returns ``{"bytes": int, "peak_bytes": int, "buffers": int}`` from
    ``torch.cuda.memory_stats()`` (``allocated_bytes.all.current``,
    ``allocated_bytes.all.peak``, ``active.all.current``); every field
    is -1 without a card.  ``peak_reset`` starts a new peak after the
    read (``torch.cuda.reset_peak_memory_stats``)."""
    import torch

    t0 = time.perf_counter()
    bytes_live = peak = buffers = -1
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        bytes_live = int(stats.get("allocated_bytes.all.current", -1))
        peak = int(stats.get("allocated_bytes.all.peak", -1))
        buffers = int(stats.get("active.all.current", -1))
        if peak_reset:
            torch.cuda.reset_peak_memory_stats()
    _MET_DEV_BYTES.set(bytes_live)
    _MET_DEV_PEAK.set(peak)
    _MET_DEV_BUFFERS.set(buffers)
    _add_self_time(time.perf_counter() - t0)
    return {"bytes": bytes_live, "peak_bytes": peak, "buffers": buffers}


class ProfilerWindow:
    """``torch.profiler`` capture spanning N scheduling cycles.

    ``request(cycles, out_dir)`` arms the window; the scheduler calls
    :meth:`tick` once per cycle (cheap no-op while disarmed).  The
    first tick after arming starts the profiler (CPU activity, plus
    CUDA when a card is present); after ``cycles`` more ticks it stops,
    the chrome trace is written to ``<dir>/trace.json`` and the capture
    directory is recorded in :attr:`last_capture`.  Never raises into
    the cycle loop."""

    def __init__(self, base_dir: str = "profiles",
                 event_sink: Optional[Callable] = None,
                 namespace: "str | Callable[[], str] | None" = None):
        self.base_dir = base_dir
        self.event_sink = event_sink
        # shard id (str, or callable resolved at request time): shards
        # that share one filesystem must not write traces into the same
        # capture dir when they arm in the same instant
        self.namespace = namespace
        self._lock = threading.Lock()
        self._armed = 0          # cycles requested, 0 = disarmed
        self._remaining = 0      # cycles left in an active capture
        self._active_dir = ""
        self._capture_seq = 0    # per-process uniquifier
        self._prof = None        # the running torch.profiler.profile
        self.last_capture = ""
        self.last_error = ""
        self.captures_done = 0

    def _namespace(self) -> str:
        ns = self.namespace
        if callable(ns):
            try:
                ns = ns()
            except Exception:
                ns = ""
        return str(ns) if ns else ""

    def request(self, cycles: int, out_dir: str = "") -> tuple:
        """Arm a capture.  Returns (ok, dir-or-error)."""
        cycles = int(cycles)
        if cycles <= 0:
            return False, "cycles must be > 0"
        with self._lock:
            if self._armed or self._remaining:
                return False, "capture already in progress"
            self._capture_seq += 1
            ns = self._namespace()
            tag = (f"capture-{ns}-" if ns else "capture-")
            d = out_dir or os.path.join(
                self.base_dir,
                "%s%d-%d-%d" % (tag, int(time.time() * 1000),
                                os.getpid(), self._capture_seq))
            self._armed = cycles
            self._active_dir = d
        return True, d

    @staticmethod
    def _start_profiler():
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
        return prof

    def tick(self) -> None:
        """Cycle-boundary hook: start / count down / stop the capture."""
        with self._lock:
            armed, remaining, d = (self._armed, self._remaining,
                                   self._active_dir)
        if not armed and not remaining:
            return
        if armed:
            try:
                os.makedirs(d, exist_ok=True)
                prof = self._start_profiler()
                with self._lock:
                    self._prof = prof
                    self._remaining = self._armed
                    self._armed = 0
                if self.event_sink is not None:
                    self.event_sink("profile_capture", "info",
                                    detail="started: %s" % d)
            except Exception as e:  # never break the cycle loop
                with self._lock:
                    self._armed = 0
                    self._active_dir = ""
                    self.last_error = str(e)
                log.warning("profiler capture failed to start: %s", e)
            return
        with self._lock:
            self._remaining -= 1
            done = self._remaining <= 0
        if done:
            prof, self._prof = self._prof, None
            try:
                prof.stop()
                prof.export_chrome_trace(os.path.join(d, TRACE_FILE))
            except Exception as e:
                with self._lock:
                    self.last_error = str(e)
                log.warning("profiler capture failed to stop: %s", e)
            with self._lock:
                self.last_capture = self._active_dir
                self._active_dir = ""
                self._remaining = 0
                self.captures_done += 1
            if self.event_sink is not None:
                self.event_sink("profile_capture", "info",
                                detail="written: %s" % self.last_capture)

    def status(self) -> dict:
        with self._lock:
            return {"armed": self._armed, "remaining": self._remaining,
                    "active_dir": self._active_dir,
                    "last_capture": self.last_capture,
                    "last_error": self.last_error,
                    "captures_done": self.captures_done}
