"""SLO engine: sliding-window latency targets over job-trace edges (the
port's copy of ``cranesched_tpu/obs/slo.py``).

Targets are declared in the cluster YAML and evaluated continuously
from the spans the JobTraceRecorder stamps:

    Observability:
      JobTrace: on
      SLO:
        - name: submit-to-dispatch
          from: submit
          to: dispatched
          p: 99
          target_seconds: 5.0
          windows: [60, 300, 3600]

Each observation is the latency ``t(to) - t(from)`` within ONE
timeline (so a requeued job measures its current incarnation, never a
span pair across incarnations).  Per window the engine reports the
observed percentile and the multi-window BURN RATE:

    burn = (fraction of observations over target) / (1 - p/100)

i.e. burn 1.0 exactly consumes the error budget the percentile target
allows; burn 14.4 on the 1 h window is the classic page-now threshold.
``crane_slo_burn_rate{slo=,window=}`` gauges update on every
``evaluate()``; ``crane_slo_breaches_total{slo=}`` counts EDGES (a
window's burn crossing >= 1.0), not samples, so a sustained breach is
one breach until it recovers.

Dependency-free and bounded: per-SLO sample deques are pruned to the
largest window and hard-capped (oldest dropped first, counted).
"""

from __future__ import annotations

import threading
from collections import deque

from cranesched_tpu_torch.obs.metrics import REGISTRY

_MET_BURN = REGISTRY.gauge(
    "crane_slo_burn_rate",
    "Error-budget burn rate per SLO and sliding window")
_MET_BREACH = REGISTRY.counter(
    "crane_slo_breaches_total",
    "Burn-rate >= 1.0 crossings per SLO (edge-triggered)")

DEFAULT_WINDOWS = (60.0, 300.0, 3600.0)
_MAX_SAMPLES = 65536


class SloSpec:
    __slots__ = ("name", "frm", "to", "p", "target", "windows")

    def __init__(self, name: str, frm: str, to: str, p: float,
                 target: float, windows=DEFAULT_WINDOWS):
        self.name = str(name)
        self.frm = str(frm)
        self.to = str(to)
        self.p = float(p)
        self.target = float(target)
        self.windows = tuple(float(w) for w in windows) or \
            DEFAULT_WINDOWS

    def as_tuple(self) -> tuple:
        return (self.name, self.frm, self.to, self.p, self.target,
                self.windows)


class SloEngine:
    """Holds the configured SLO specs and their sample windows."""

    def __init__(self, specs=()):
        self.specs: list[SloSpec] = [
            s if isinstance(s, SloSpec) else SloSpec(*s)
            for s in specs]
        # optional callable(slo_name, window_s, burn, breaching) fired
        # on breach EDGES (start and clear) — the scheduler points this
        # at its event log; called outside the engine lock
        self.event_sink = None
        self._lock = threading.Lock()
        # per spec: deque of (t, latency)
        self._samples: list[deque] = [deque() for _ in self.specs]
        self._burning: dict[tuple[str, float], bool] = {}
        self.dropped = 0
        # to==edge index so record() is O(matching specs), not O(all)
        self._by_to: dict[str, list[int]] = {}
        for i, s in enumerate(self.specs):
            self._by_to.setdefault(s.to, []).append(i)
        #: edges any spec samples on — callers probe this before
        #: building the span-times dict record() wants
        self.wanted = frozenset(self._by_to)

    @classmethod
    def from_config(cls, entries) -> "SloEngine | None":
        """Build from the YAML ``Observability: SLO:`` list (dicts) or
        the SchedulerConfig tuple form; None when nothing configured."""
        specs = []
        for e in entries or ():
            if isinstance(e, dict):
                specs.append(SloSpec(
                    name=e.get("name", f"{e.get('from')}-to-"
                               f"{e.get('to')}"),
                    frm=e["from"], to=e["to"],
                    p=float(e.get("p", 99)),
                    target=float(e["target_seconds"]),
                    windows=tuple(float(w) for w in
                                  e.get("windows",
                                        DEFAULT_WINDOWS))))
            else:
                specs.append(SloSpec(*e))
        return cls(specs) if specs else None

    # ------------------------------------------------------------------

    def record(self, edge: str, span_times: dict, now: float) -> None:
        """Called by the recorder on every stamp: ``span_times`` maps
        edge -> t for the timeline that just gained ``edge``."""
        idxs = self._by_to.get(edge)
        if not idxs:
            return
        with self._lock:
            for i in idxs:
                spec = self.specs[i]
                t_frm = span_times.get(spec.frm)
                if t_frm is None:
                    continue
                dq = self._samples[i]
                dq.append((now, max(now - t_frm, 0.0)))
                if len(dq) > _MAX_SAMPLES:
                    dq.popleft()
                    self.dropped += 1

    def evaluate(self, now: float) -> list[dict]:
        """Prune, compute per-window percentile + burn rate, update the
        gauges/breach counter, and return the live table."""
        table = []
        edges: list[tuple] = []  # (name, window, burn, breaching)
        with self._lock:
            for i, spec in enumerate(self.specs):
                dq = self._samples[i]
                horizon = now - max(spec.windows)
                while dq and dq[0][0] < horizon:
                    dq.popleft()
                allowed = max(1.0 - spec.p / 100.0, 1e-3)
                row = {"name": spec.name, "from": spec.frm,
                       "to": spec.to, "p": spec.p,
                       "target_seconds": spec.target, "windows": {}}
                for w in spec.windows:
                    lats = sorted(lat for t, lat in dq
                                  if t >= now - w)
                    n = len(lats)
                    if n:
                        k = min(int(spec.p / 100.0 * n), n - 1)
                        observed = lats[k]
                        bad = sum(1 for v in lats if v > spec.target)
                        burn = (bad / n) / allowed
                    else:
                        observed, burn = 0.0, 0.0
                    key = (spec.name, w)
                    was = self._burning.get(key, False)
                    breaching = n > 0 and burn >= 1.0
                    if breaching != was:
                        if breaching:
                            _MET_BREACH.inc(slo=spec.name)
                        edges.append((spec.name, w, burn, breaching))
                    self._burning[key] = breaching
                    _MET_BURN.set(burn, slo=spec.name, window=int(w))
                    row["windows"][str(int(w))] = {
                        "count": n,
                        "observed": round(observed, 6),
                        "burn_rate": round(burn, 4),
                        "breaching": breaching}
                table.append(row)
        if self.event_sink is not None:
            for name, w, burn, breaching in edges:
                try:
                    self.event_sink(name, w, burn, breaching)
                except Exception:
                    pass  # observability must never break evaluation
        return table

    def table(self, now: float) -> list[dict]:
        return self.evaluate(now)
