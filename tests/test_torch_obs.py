"""The port's observability objects against the JAX package's: the cycle
trace ring, the event log, the SLO engine and the job-trace recorder.

Each case feeds the same call sequence, drawn from a numpy seed, into
both packages' objects and requires every output equal (the objects are
copies, so equal means equal to the bit: times, seqs, burn rates).
"""

import numpy as np
import pytest

from cranesched_tpu.obs import events as jevents
from cranesched_tpu.obs import jobtrace as jjobtrace
from cranesched_tpu.obs import slo as jslo
from cranesched_tpu.obs import trace as jtrace
from cranesched_tpu_torch.obs import events as tevents
from cranesched_tpu_torch.obs import jobtrace as tjobtrace
from cranesched_tpu_torch.obs import slo as tslo
from cranesched_tpu_torch.obs import trace as ttrace

PAIRS = {"events": (jevents, tevents), "jobtrace": (jjobtrace, tjobtrace),
         "slo": (jslo, tslo), "trace": (jtrace, ttrace)}


def both(module, name, *args, **kwargs):
    j, t = PAIRS[module]
    return (getattr(j, name)(*args, **kwargs),
            getattr(t, name)(*args, **kwargs))


def call(pair, method, *args, **kwargs):
    a, b = (getattr(o, method)(*args, **kwargs) for o in pair)
    assert a == b, (method, args, kwargs, a, b)
    return a


# ---------------- the cycle trace ring ----------------


@pytest.mark.parametrize("size", [0, 1, 4, 64])
def test_cycle_trace_ring_matches_jax(size):
    rng = np.random.default_rng(size)
    rings = both("trace", "CycleTraceRing", size)
    for i in range(100):
        row = {"now": float(i), "placed": int(rng.integers(0, 9))}
        for r in rings:
            r.push(dict(row))
        call(rings, "__len__")
        call(rings, "snapshot")
        call(rings, "snapshot", int(rng.integers(1, 5)))


def test_solve_span_is_a_profiler_span():
    """A span of the port's cycle recorder is torch.profiler's
    record_function while a capture runs: a CPU capture shows a solve
    span by its name, ``crane:solve:<label>``, nested in its cycle."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    spans = ttrace.CycleSpans()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        spans.begin()
        with spans.span("solve:test"):
            torch.ones(4).sum()
        spans.end()
    names = {e.name for e in prof.events()}
    assert {"crane:cycle", "crane:solve:test"} <= names
    assert [s[:2] for s in spans.spans] == [["cycle", -1], ["solve:test", 0]]


# ---------------- the event log ----------------

_TYPES = sorted(jevents.EVENT_TYPES)


@pytest.mark.parametrize("seed", range(4))
def test_event_log_matches_jax(seed):
    """Emission, severities (unknown -> info), filters, the ring bound,
    flap detection and ingest with dedup give the same records."""
    assert tevents.EVENT_TYPES == jevents.EVENT_TYPES
    assert tevents.SEVERITIES == jevents.SEVERITIES
    assert tevents.FLAP_WINDOW == jevents.FLAP_WINDOW
    rng = np.random.default_rng(seed)
    logs = both("events", "EventLog", capacity=int(rng.integers(4, 40)))
    now = 1000.0
    for _ in range(300):
        now += float(rng.exponential(60.0))
        op = rng.integers(0, 4)
        if op == 0:
            sev = ["debug", "info", "warning", "error", "critical",
                   "shouting"][rng.integers(0, 6)]
            call(logs, "emit", _TYPES[rng.integers(len(_TYPES))], sev,
                 node=f"cn{rng.integers(0, 4)}",
                 job_id=int(rng.integers(0, 100)), detail="d", time=now)
        elif op == 1:
            call(logs, "emit_node_transition",
                 ["down", "up", "node_down", "node_up", "drain"][
                     rng.integers(0, 5)], f"cn{rng.integers(0, 4)}",
                 now=now)
        elif op == 2:
            rec = {"seq": int(rng.integers(0, 50)), "time": now,
                   "type": "requeue", "severity": "info", "node": "",
                   "job_id": 1, "detail": ""}
            call(logs, "ingest", rec)
        else:
            call(logs, "since", after_seq=int(rng.integers(0, 200)),
                 severity=["", "info", "warning", "error"][
                     rng.integers(0, 4)],
                 since_time=now - float(rng.uniform(0, 3000)),
                 type=["", "node_flap", "requeue"][rng.integers(0, 3)],
                 limit=int(rng.integers(0, 6)))
        call(logs, "stats")
        assert logs[0].last_seq == logs[1].last_seq


def test_event_log_flap_and_bound():
    """The JAX package's own cases on the port's log."""
    log = tevents.EventLog(capacity=4)
    for i in range(10):
        log.emit("requeue", job_id=i, time=float(i))
    assert [r["job_id"] for r in log.since()] == [6, 7, 8, 9]
    assert log.last_seq == 10
    log = tevents.EventLog()
    log.emit_node_transition("down", "cn00", now=100.0)
    log.emit_node_transition("up", "cn00",
                             now=100.0 + tevents.FLAP_WINDOW / 2)
    assert [r["type"] for r in log.since()] == [
        "node_down", "node_up", "node_flap"]


# ---------------- the SLO engine ----------------


def _specs(mod):
    return [mod.SloSpec("s2d", "submit", "dispatched", p=90.0, target=1.0,
                        windows=(100.0,)),
            mod.SloSpec("e", "a", "b", 50, 1.0, windows=(60.0, 300.0))]


@pytest.mark.parametrize("seed", range(3))
def test_slo_engine_matches_jax(seed):
    """Percentiles, burn rates, the edge-triggered breach sink and the
    window's slide give the same tables and the same edges."""
    rng = np.random.default_rng(seed)
    engines = (jslo.SloEngine(_specs(jslo)), tslo.SloEngine(_specs(tslo)))
    edges = ([], [])
    for eng, out in zip(engines, edges):
        eng.event_sink = lambda *a, out=out: out.append(a)
    now = 0.0
    for _ in range(200):
        now += float(rng.exponential(5.0))
        if rng.random() < 0.7:
            lat = float(rng.exponential(1.0))
            edge, frm = (("dispatched", "submit") if rng.random() < 0.5
                         else ("b", "a"))
            for eng in engines:
                eng.record(edge, {frm: now - lat}, now)
        else:
            call(engines, "evaluate", now)
    call(engines, "table", now + 1.0)
    assert edges[0] == edges[1] and edges[0]


def test_slo_from_config_matches_jax():
    entries = (("s", "submit", "dispatched", 99.0, 5.0, (60.0, 300.0)),
               {"from": "submit", "to": "end", "target_seconds": 9.0})
    assert tslo.SloEngine.from_config(()) is None
    assert jslo.SloEngine.from_config(()) is None
    a = jslo.SloEngine.from_config(entries)
    b = tslo.SloEngine.from_config(entries)
    assert [s.as_tuple() for s in a.specs] == [s.as_tuple()
                                              for s in b.specs]


def test_slo_one_incarnation_and_synthetic_spans():
    """A requeued job measures within its incarnation; back-dated
    (synthetic) spans never enter the burn."""
    for mod, jt in ((jslo, jjobtrace), (tslo, tjobtrace)):
        slo = mod.SloEngine([mod.SloSpec("s2e", "submit", "end", p=50.0,
                                         target=100.0, windows=(1e4,))])
        rec = jt.JobTraceRecorder(slo=slo)
        rec.stamp(1, 0, "submit", 0.0)
        rec.stamp(1, 0, "requeue", 5.0)
        rec.stamp(1, 1, "submit", 6.0)
        rec.stamp(1, 1, "end", 9.0)
        rec.stamp(2, 0, "submit", 0.0, synthetic=True)
        rec.stamp(2, 0, "end", 500.0, synthetic=True)
        w = slo.evaluate(9.0)[0]["windows"]["10000"]
        assert w["count"] == 1 and w["observed"] == 3.0


# ---------------- the job-trace recorder ----------------


@pytest.mark.parametrize("seed,capacity", [(0, 8), (1, 64), (2, 4096)])
def test_job_trace_recorder_matches_jax(seed, capacity):
    """Stamp-once per incarnation, stamp_many, next_seq, the bounded
    live and closed stores with their spill counts, timelines, the
    lost/doubled ledger, stats and the rendered waterfall."""
    assert tjobtrace.SPAN_EDGES == jjobtrace.SPAN_EDGES
    assert tjobtrace.FED_EDGES == jjobtrace.FED_EDGES
    rng = np.random.default_rng(seed)
    recs = both("jobtrace", "JobTraceRecorder", capacity=capacity)
    edges = jjobtrace.SPAN_EDGES
    t = 0.0
    for _ in range(600):
        t += float(rng.exponential(1.0))
        job = int(rng.integers(0, 40))
        inc = int(rng.integers(0, 2))
        op = rng.integers(0, 5)
        if op <= 2:
            call(recs, "stamp", job, inc, edges[rng.integers(len(edges))],
                 t, node_id=int(rng.integers(-1, 4)),
                 epoch=int(rng.integers(0, 2)))
        elif op == 3:
            items = [(int(j), 0) for j in rng.integers(0, 40, size=5)]
            call(recs, "stamp_many", "eligible", items, t)
        else:
            call(recs, "next_seq", job, inc)
        a, b = (dict(r.stats(), self_time_s=0) for r in recs)
        assert a == b
    for job in range(40):
        doc = call(recs, "timeline", job)
        if doc is not None:
            assert both("jobtrace", "render_waterfall", doc)[0] == \
                tjobtrace.render_waterfall(doc)
    call(recs, "ledger", list(range(40)))
    st = recs[1].stats()
    if capacity == 8:
        assert st["spilled"] > 0 and st["active"] <= 8


def test_job_trace_spill_bound():
    """The JAX package's spill case on the port's recorder."""
    rec = tjobtrace.JobTraceRecorder(capacity=8)
    for j in range(50):
        rec.stamp(j, 0, "submit", float(j))
    assert rec.stats()["active"] <= 8 and rec.stats()["spilled"] == 42
    for j in range(100, 150):
        rec.stamp(j, 0, "submit", float(j))
        rec.stamp(j, 0, "end", float(j) + 1.0)
    assert rec.stats()["completed"] <= 8
    assert rec.stamp(7, 0, "submit", 1.0) is True
    assert rec.stamp(7, 0, "submit", 2.0) is False
