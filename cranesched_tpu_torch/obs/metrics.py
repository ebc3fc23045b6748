"""Process-wide metrics registry with Prometheus text exposition (the
port's copy of ``cranesched_tpu/obs/metrics.py``).

Dependency-free (stdlib only) on purpose: the container must not grow a
prometheus_client dependency, and the hot path must stay cheap — a
counter bump is one dict lookup + one float add under a lock that is
never contended in practice (ctld's cycle thread and the gRPC worker
pool touch disjoint metrics almost always).

Naming scheme (ARCHITECTURE.md "Observability"):

    crane_<plane>_<what>_<unit-suffix>

e.g. ``crane_cycle_phase_seconds`` (histogram, label phase=prelude|
solve|commit), ``crane_rpc_latency_seconds`` (histogram, label method),
``crane_craned_state`` (gauge, 0..3 FSM ordinal),
``crane_topo_fragmentation`` (gauge, label level — per-topology-level
free-capacity fragmentation) and
``crane_topo_cross_block_gangs_total`` (counter — gangs placed by the
cross-block spanning fallback), ``crane_cycle_skips_total`` (counter,
label reason — cycles short-circuited by the no-op fingerprint) and
``crane_pending_jobs``/``crane_running_jobs`` (gauges, updated on the
submit/start/finish EVENTS so they stay honest between the
event-driven loop's idle sleeps).  ``*_total`` are monotonic counters;
``*_seconds`` histograms use the shared log-scale buckets below
(100 µs .. ~100 s), which cover both RPC latencies and multi-second
device solves without per-metric tuning.
"""

from __future__ import annotations

import bisect
import http.server
import json
import math
import threading
from typing import Optional

# log-scale bucket upper bounds (seconds): 1e-4 * (10^0.5)^k — two
# buckets per decade from 100us to 100s, 13 finite buckets + +Inf
DEFAULT_TIME_BUCKETS = tuple(
    round(1e-4 * math.sqrt(10.0) ** k, 10) for k in range(13))


def _fmt(v: float) -> str:
    """Prometheus float formatting: integers bare, else repr."""
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape_label_value(v: str) -> str:
    """Exposition-format label escaping: backslash first, then quote
    and newline (text format 0.0.4 spec)."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    """HELP line escaping: backslash and newline only (quotes are legal
    in HELP text)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _labels_str(labels: tuple[tuple[str, str], ...],
                extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _BoundCell:
    """A counter/gauge child pre-bound to one label set: the sorted
    label-key tuple is built ONCE at bind time, so a hot-path inc/set
    is a dict op under the lock — ~5x cheaper than the kwargs path."""

    __slots__ = ("_values", "_lock", "_key")

    def __init__(self, parent: "Counter", key):
        self._values = parent._values
        self._lock = parent._reg._lock
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._values[self._key] = \
                self._values.get(self._key, 0.0) + amount

    def set(self, value: float) -> None:
        with self._lock:
            self._values[self._key] = float(value)


class _BoundHistogramCell:
    """Histogram child pre-bound to one label set (see _BoundCell);
    the series cell is created lazily on first observe so an unused
    binding never shows up in the exposition."""

    __slots__ = ("_parent", "_key")

    def __init__(self, parent: "Histogram", key):
        self._parent = parent
        self._key = key

    def observe(self, value: float) -> None:
        p = self._parent
        i = bisect.bisect_left(p.buckets, value)
        with p._reg._lock:
            counts, acc = p._series.setdefault(
                self._key, ([0] * len(p.buckets), [0, 0.0]))
            if i < len(counts):
                counts[i] += 1
            acc[0] += 1
            acc[1] += value

    def observe_many(self, values) -> None:
        """Batch observe under ONE registry-lock acquisition (the
        per-cycle stamp_many path)."""
        p = self._parent
        bl = p.buckets
        with p._reg._lock:
            counts, acc = p._series.setdefault(
                self._key, ([0] * len(bl), [0, 0.0]))
            n, s = 0, 0.0
            for v in values:
                i = bisect.bisect_left(bl, v)
                if i < len(counts):
                    counts[i] += 1
                n += 1
                s += v
            acc[0] += n
            acc[1] += s


class Counter:
    """Monotonic counter.  ``labels(**kv)`` returns a child bound to a
    label set; ``inc()`` on the parent uses the empty label set."""

    kind = "counter"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry"):
        self.name = name
        self.help = help
        self._reg = registry
        self._values: dict[tuple[tuple[str, str], ...], float] = {}

    def labels(self, **labels) -> _BoundCell:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        return _BoundCell(self, key)

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._reg._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._reg._lock:
            return self._values.get(key, 0.0)

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} {self.kind}"]
        for key, v in sorted(self._values.items()):
            out.append(f"{self.name}{_labels_str(key)} {_fmt(v)}")
        if not self._values:
            out.append(f"{self.name} 0")
        return out

    def snapshot(self) -> dict:
        with self._reg._lock:
            if not self._values:
                return {"": 0.0}
            return {_labels_str(k) or "": v
                    for k, v in self._values.items()}


class Gauge(Counter):
    """Settable gauge (same storage as Counter, plus set/dec)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._reg._lock:
            self._values[key] = float(value)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram:
    """Fixed-bucket histogram (cumulative, Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, registry: "MetricsRegistry",
                 buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS):
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(buckets))
        self._reg = registry
        # per label-set: ([count per finite bucket], total_count, sum)
        self._series: dict[tuple[tuple[str, str], ...],
                           tuple[list, list]] = {}

    def labels(self, **labels) -> _BoundHistogramCell:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        return _BoundHistogramCell(self, key)

    def observe(self, value: float, **labels) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._reg._lock:
            counts, acc = self._series.setdefault(
                key, ([0] * len(self.buckets), [0, 0.0]))
            for i, ub in enumerate(self.buckets):
                if value <= ub:
                    counts[i] += 1
                    break
            acc[0] += 1
            acc[1] += value

    def expose(self) -> list[str]:
        out = [f"# HELP {self.name} {_escape_help(self.help)}",
               f"# TYPE {self.name} {self.kind}"]
        for key, (counts, (n, s)) in sorted(self._series.items()):
            cum = 0
            for ub, c in zip(self.buckets, counts):
                cum += c
                le = 'le="%s"' % _fmt(ub)
                out.append(
                    f"{self.name}_bucket{_labels_str(key, le)} {cum}")
            inf = 'le="+Inf"'
            out.append(
                f"{self.name}_bucket{_labels_str(key, inf)} {n}")
            out.append(f"{self.name}_sum{_labels_str(key)} {_fmt(s)}")
            out.append(f"{self.name}_count{_labels_str(key)} {n}")
        return out

    def snapshot(self) -> dict:
        with self._reg._lock:
            return {_labels_str(k) or "": {"count": n, "sum": s}
                    for k, (_, (n, s)) in self._series.items()}


class MetricsRegistry:
    """Registry of named metrics; idempotent get-or-create so modules
    can declare their metrics at import time in any order."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, object] = {}

    def _get(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple[float, ...] = DEFAULT_TIME_BUCKETS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def expose(self) -> str:
        """Prometheus text exposition format 0.0.4.  Each family's
        ``# HELP``/``# TYPE`` header is emitted exactly once (guarded
        here so a future aliased registration can't duplicate it —
        promtool treats a second TYPE line for a family as a parse
        error)."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines: list[str] = []
        seen: set[str] = set()
        for name, m in metrics:
            if name in seen:
                continue
            seen.add(name)
            lines.extend(m.expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """JSON-friendly dump (merged into QueryStats)."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        return {name: {"type": m.kind, "values": m.snapshot()}
                for name, m in metrics}

    def reset(self) -> None:
        """Drop all metrics (tests only — never call in a daemon)."""
        with self._lock:
            self._metrics.clear()


#: the process-wide registry: ctld and craned are separate processes,
#: so one module-level registry per process is exactly one per daemon
REGISTRY = MetricsRegistry()


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    registry: MetricsRegistry = REGISTRY

    def do_GET(self):  # noqa: N802 (stdlib API name)
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        body = self.registry.expose().encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):  # silence per-request stderr lines
        pass


def serve_metrics(port: int, host: str = "0.0.0.0",
                  registry: Optional[MetricsRegistry] = None
                  ) -> http.server.ThreadingHTTPServer:
    """Start the /metrics endpoint on a daemon thread; returns the
    server (``server.server_address[1]`` is the bound port — pass
    port=0 for an ephemeral one in tests).  Call ``shutdown()`` to
    stop."""
    handler = type("Handler", (_MetricsHandler,),
                   {"registry": registry or REGISTRY})
    srv = http.server.ThreadingHTTPServer((host, port), handler)
    srv.daemon_threads = True
    threading.Thread(target=srv.serve_forever, daemon=True,
                     name="metrics-http").start()
    return srv


def stats_doc(registry: Optional[MetricsRegistry] = None) -> dict:
    """The dict merged under ``"metrics"`` in QueryStats replies."""
    return (registry or REGISTRY).snapshot()


if __name__ == "__main__":  # tiny smoke: python -m cranesched_tpu_torch.obs.metrics
    c = REGISTRY.counter("crane_demo_total", "demo")
    c.inc(3, kind="x")
    h = REGISTRY.histogram("crane_demo_seconds", "demo latency")
    h.observe(0.004)
    print(REGISTRY.expose())
    print(json.dumps(REGISTRY.snapshot(), indent=1))
