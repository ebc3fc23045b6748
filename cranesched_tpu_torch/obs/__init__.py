"""Observability of the port.  Only the dependency-free metrics registry
is here so far (``metrics.py``, a copy of ``cranesched_tpu/obs/
metrics.py``): the WAL counts its fsyncs and group sizes in it.  The
cycle trace ring, events, job trace, flight recorder, SLOs and explain
are ROADMAP.md A8's next slice."""

from cranesched_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    REGISTRY,
    serve_metrics,
)
