"""Observability of the port (copies of ``cranesched_tpu/obs/``, with
torch counterparts where the JAX package reaches JAX):

- ``metrics.py``    process-wide registry of counters / gauges /
                    histograms with Prometheus text exposition and a
                    stdlib HTTP endpoint.
- ``trace.py``      bounded ring of structured per-cycle traces and the
                    cycle's span tree, written into each row (and into a
                    running ``torch.profiler`` capture).
- ``events.py``     bounded ring of typed, severity-tagged cluster
                    events (node flaps, requeues, preemptions, SLO
                    breaches, steady-state rebuilds).
- ``jobtrace.py``   event-sourced per-job timelines (one span per
                    lifecycle edge) and the derived latency histograms.
- ``slo.py``        sliding-window percentile targets over trace edges
                    with multi-window burn rates and a breach counter.
- ``flight.py``     stall forensics: the flight recorder (phase ring +
                    stall sentry with all-thread stacks), the fsync'd
                    heartbeat protocol, and the build cache's counters.
- ``introspect.py`` run-time build counts, the card's memory gauges,
                    and the N-cycle ``torch.profiler`` capture window.
- ``fedobs.py``     federation-wide merge: scatter-gather metric
                    aggregation and the cluster-level SLO engine over
                    per-shard summaries (exact burn-rate merge).
"""

from cranesched_tpu_torch.obs.fedobs import (  # noqa: F401
    ClusterSlo,
    cluster_doc,
    merge_metric_snapshots,
    merge_slo_tables,
)
from cranesched_tpu_torch.obs.flight import (  # noqa: F401
    FlightRecorder,
    Heartbeat,
    PROBE_PHASES,
    dump_all_stacks,
    kernel_cache_stats,
    read_heartbeat,
)
from cranesched_tpu_torch.obs.jobtrace import (  # noqa: F401
    FED_EDGES,
    SPAN_EDGES,
    JobTraceRecorder,
    render_waterfall,
)
from cranesched_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    serve_metrics,
)
from cranesched_tpu_torch.obs.slo import (  # noqa: F401
    SloEngine,
    SloSpec,
)
from cranesched_tpu_torch.obs.trace import (  # noqa: F401
    CycleSpans,
    CycleTraceRing,
)
