"""Stall forensics: the always-on flight recorder, the probe heartbeat
protocol, and the counters of the port's build cache (the port's copy
of ``cranesched_tpu/obs/flight.py``).

A stall -- probe-side or cycle-side -- has to land with a phase
attribution and an all-thread stack dump, not as a timeout that names
neither the phase that hung nor the stack it hung on:

* :class:`FlightRecorder` -- a bounded ring of recent phase stamps (the
  scheduler stamps cycle_begin/prelude/commit/dispatch/cycle_end per
  cycle; ~6 appends, microseconds; each on the wall clock and on
  ``perf_counter``, the clock of the cycle's spans in its trace row, so
  a stall lines up with them) plus a stall sentry the cycle loop
  arms around every cycle.  If the deadline passes while armed, the
  sentry captures ``sys._current_frames()`` for every thread into
  ``last_stall`` alongside the ring tail -- the "what was the scheduler
  doing when it stopped" answer, without attaching a debugger to a
  wedged daemon.  All bookkeeping self-time is accumulated so a bench
  can show what the recorder costs a cycle.

* The heartbeat protocol -- :class:`Heartbeat` writes one fsync'd JSON
  line per named phase (``PROBE_PHASES``: env preflight -> torch
  import -> CUDA init -> device enum -> kernel build -> first launch ->
  steady state); :func:`read_heartbeat` parses the file tolerantly (a
  probe killed mid-write leaves a torn last line, which is dropped,
  never raised on).  The device acquisition (``parallel/acquire.py``)
  stamps the first four; the warm tail is the bench probe's (ROADMAP.md
  A12).

* :func:`kernel_cache_stats` -- the port compiles at run time only its
  CUDA kernels (``kernels/build.py``, nvcc) and the native solver
  library (``utils/native.py``, g++), each into a cache under
  ``build/`` keyed by a hash of its sources.  Every lookup is counted
  here: a library found built is a hit, one built now a miss (and a
  build, in ``introspect.total_compiles``).

Nothing here imports torch: the recorder and heartbeat halves must work
in processes that are themselves finding out whether the device
initialises.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from collections import deque
from typing import Callable, Optional

from cranesched_tpu_torch.obs.metrics import REGISTRY as _OBS

#: the probe's named phases, in order.  A stamp marks the phase's
#: START -- on a timeout, the last stamp names where it hung.  The
#: first four are the device acquisition handshake (env pre-flight,
#: torch import, CUDA runtime init, device enumeration); the tail is
#: the kernels' build and first launch.
PROBE_PHASES = ("env_preflight", "torch_import", "cuda_init",
                "device_enum", "kernel_build", "first_launch",
                "first_sync", "steady_state")

_MET_STALLS = _OBS.counter(
    "crane_flight_stalls_total",
    "stall-sentry firings (armed deadline passed; stacks captured)")
_MET_CACHE_HITS = _OBS.counter(
    "crane_kernel_cache_hits_total",
    "run-time libraries found built in the build cache, by name")
_MET_CACHE_MISSES = _OBS.counter(
    "crane_kernel_cache_misses_total",
    "run-time libraries built now (nvcc / g++), by name")
_MET_CACHE_ENTRIES = _OBS.gauge(
    "crane_kernel_cache_entries",
    "built libraries in the build cache directories")


def dump_all_stacks() -> dict[str, list[str]]:
    """Formatted stack of every live thread, keyed ``name (tid)``.

    Pure-Python ``sys._current_frames`` — works on a RUNNING process
    (the sentry's case), unlike ``faulthandler`` which wants a file and
    C-level signal safety (the probe child's case)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out: dict[str, list[str]] = {}
    for tid, frame in sys._current_frames().items():
        key = f"{names.get(tid, '?')} ({tid})"
        out[key] = [ln.rstrip("\n")
                    for ln in traceback.format_stack(frame)]
    return out


class FlightRecorder:
    """Bounded ring of phase stamps + an armable stall sentry.

    The scheduler owns one instance and stamps its cycle phases; the
    server's cycle loop arms the sentry before each cycle and disarms
    after.  A deadline that passes while armed fires ONCE: the sentry
    snapshots every thread's stack plus the ring tail into
    :attr:`last_stall`, bumps ``crane_flight_stalls_total``, emits a
    ``flight_stall`` event through ``event_sink``, and disarms (the
    next cycle re-arms).  Nothing here ever raises into the loop."""

    def __init__(self, capacity: int = 256,
                 event_sink: Optional[Callable] = None):
        self.capacity = max(int(capacity), 16)
        self.event_sink = event_sink
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self.self_time_s = 0.0
        self.stalls_total = 0
        self.last_stall: dict | None = None
        # sentry state: deadline on the monotonic clock, None = disarmed
        self._deadline: float | None = None
        self._label = ""
        self._cond = threading.Condition(self._lock)
        self._sentry: threading.Thread | None = None
        self._closed = False

    # -- the hot path --

    def stamp(self, phase: str, detail: str = "",
              t: float | None = None) -> None:
        """Append one phase stamp: wall time, ``perf_counter`` (the clock
        of the cycle's spans, obs/trace.py), phase, detail."""
        t0 = time.perf_counter()
        rec = {"t": time.time() if t is None else t, "perf_counter": t0,
               "phase": phase}
        if detail:
            rec["detail"] = detail
        with self._lock:
            self._ring.append(rec)
        self.self_time_s += time.perf_counter() - t0

    # -- the stall sentry --

    def arm(self, timeout_s: float, label: str = "cycle") -> None:
        """Start (or reset) the deadline; lazily spawns the sentry."""
        if timeout_s <= 0:
            return
        with self._cond:
            self._deadline = time.monotonic() + timeout_s
            self._label = label
            if self._sentry is None:
                self._sentry = threading.Thread(
                    target=self._sentry_loop, daemon=True,
                    name="flight-sentry")
                self._sentry.start()
            self._cond.notify()

    def disarm(self) -> None:
        with self._cond:
            self._deadline = None
            self._cond.notify()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._deadline = None
            self._cond.notify()

    def _sentry_loop(self) -> None:
        while True:
            with self._cond:
                if self._closed:
                    return
                if self._deadline is None:
                    self._cond.wait()
                    continue
                wait = self._deadline - time.monotonic()
                if wait > 0:
                    self._cond.wait(wait)
                    continue
                # expired while still armed: fire once and disarm
                label = self._label
                self._deadline = None
            try:
                self._record_stall(label)
            except Exception:  # never kill the sentry
                pass

    def _record_stall(self, label: str) -> None:
        stacks = dump_all_stacks()
        with self._lock:
            phases = list(self._ring)[-16:]
        stall = {"time": time.time(), "perf_counter": time.perf_counter(),
                 "label": label,
                 "phases": phases, "stacks": stacks}
        with self._lock:
            self.last_stall = stall
            self.stalls_total += 1
        _MET_STALLS.inc()
        if self.event_sink is not None:
            last = phases[-1]["phase"] if phases else "(no stamps)"
            self.event_sink(
                "flight_stall", "error",
                detail=f"{label} stalled; last phase {last}; "
                       f"{len(stacks)} thread stacks captured")

    # -- reading --

    def report(self, tail: int = 64) -> dict:
        """JSON-friendly dump for QueryStats / cflight."""
        with self._lock:
            return {"phases": list(self._ring)[-tail:],
                    "stalls_total": self.stalls_total,
                    "last_stall": self.last_stall,
                    "self_time_s": round(self.self_time_s, 6),
                    "armed": self._deadline is not None}


# ---------------------------------------------------------------------------
# the probe heartbeat protocol (the device probe <-> its parent)
# ---------------------------------------------------------------------------


class Heartbeat:
    """fsync'd phase stamps: one JSON line per stamp, durable before
    the writer proceeds — a probe killed mid-phase leaves its last
    stamp on disk, which is the whole point."""

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, "a", encoding="utf-8")

    def stamp(self, phase: str, detail: str = "") -> None:
        rec = {"t": time.time(), "phase": phase}
        if detail:
            rec["detail"] = detail
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())

    def close(self) -> None:
        try:
            self._fh.close()
        except Exception:
            pass


def read_heartbeat(path: str) -> list[dict]:
    """Parse a heartbeat file; missing file -> [], torn last line
    dropped (the writer died mid-write — exactly the case this exists
    for)."""
    out: list[dict] = []
    try:
        with open(path, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail
                if isinstance(rec, dict) and "phase" in rec:
                    out.append(rec)
    except OSError:
        return []
    return out


# ---------------------------------------------------------------------------
# the build cache (kernels/build.py, utils/native.py)
# ---------------------------------------------------------------------------

_cache_lock = threading.Lock()
_cache_state = {"hits": 0, "misses": 0}


def note_kernel_cache(name: str, hit: bool, seconds: float = 0.0) -> None:
    """Count one build-cache lookup of library ``name``: ``hit`` when it
    was found built, else it was built now, in ``seconds`` (also counted
    as a build in ``introspect.total_compiles``)."""
    with _cache_lock:
        _cache_state["hits" if hit else "misses"] += 1
    if hit:
        _MET_CACHE_HITS.inc(name=name)
        return
    _MET_CACHE_MISSES.inc(name=name)
    from cranesched_tpu_torch.obs import introspect

    introspect.note_build(name, seconds)


def kernel_cache_stats() -> dict:
    """Hit/miss counters + the built libraries on disk (JSON-friendly)."""
    from cranesched_tpu_torch.kernels.build import BUILD_DIR as kernels
    from cranesched_tpu_torch.utils.native import BUILD_DIR as native

    with _cache_lock:
        st = dict(_cache_state)
    entries = sum(1 for d in (kernels, native) if d.is_dir()
                  for f in d.iterdir() if f.suffix == ".so"
                  and not f.name.endswith(".tmp.so"))
    _MET_CACHE_ENTRIES.set(entries)
    total = st["hits"] + st["misses"]
    return {"dirs": [str(kernels), str(native)],
            "hits": st["hits"], "misses": st["misses"],
            "entries": entries,
            "hit_rate": round(st["hits"] / total, 4) if total else 0.0}
