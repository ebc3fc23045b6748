"""The port's introspection and stall-forensics plane (obs/introspect.py,
obs/flight.py): the build counter and the cycle trace's ``recompiles``,
the card's memory sample on the CPU, the ``torch.profiler`` window
(held step by step against the JAX package's window), the flight
recorder and the heartbeat protocol.
"""

import json
import os
import time

import pytest

from cranesched_tpu.obs import introspect as jintrospect
from cranesched_tpu_torch.ctld import (
    JobScheduler,
    JobSpec,
    MetaContainer,
    ResourceSpec,
    SchedulerConfig,
)
from cranesched_tpu_torch.kernels import build
from cranesched_tpu_torch.obs import flight, introspect
from cranesched_tpu_torch.obs.flight import (
    PROBE_PHASES,
    FlightRecorder,
    Heartbeat,
    dump_all_stacks,
    read_heartbeat,
)


def _sched(**cfg):
    meta = MetaContainer()
    for i in range(2):
        meta.add_node(f"cn{i:02d}", meta.layout.encode(
            cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True))
        meta.craned_up(i)
    return JobScheduler(meta, SchedulerConfig(backfill=False, **cfg),
                        device="cpu")


def _spec(cpu=1.0):
    return JobSpec(res=ResourceSpec(cpu=cpu, mem_bytes=1 << 30),
                   sim_runtime=1e6)


# ---------------- builds and recompiles ----------------


def test_build_counter_and_cycle_recompiles():
    """A build the cache pays is counted once in total_compiles and lands
    in the cycle that paid it as ``recompiles``; a warm cycle past
    WARMUP_CYCLES that pays one emits ``recompile_steady``; a cache hit
    counts no build."""
    sched = _sched()
    before = introspect.total_compiles()
    flight.note_kernel_cache("greedy_place", hit=True)
    assert introspect.total_compiles() == before
    for t in range(3):
        sched.submit(_spec(), now=float(t))
        sched.schedule_cycle(now=float(t))
    assert sched.cycle_trace.snapshot()[-1]["recompiles"] == 0
    assert sched.events.since(type="recompile_steady") == []

    # a cycle whose solve pays a build (as a first launch would)
    solve = sched._immediate_solve

    def building(*a, **kw):
        flight.note_kernel_cache("greedy_place", hit=False, seconds=0.5)
        return solve(*a, **kw)

    sched._immediate_solve = building
    sched.submit(_spec(), now=3.0)
    sched.schedule_cycle(now=3.0)
    row = sched.cycle_trace.snapshot()[-1]
    assert row["recompiles"] == 1
    assert introspect.total_compiles() == before + 1
    ev = sched.events.since(type="recompile_steady")
    assert [e["detail"] for e in ev] == ["cycle 4 paid 1 recompile(s)"]
    stats = flight.kernel_cache_stats()
    assert stats["hits"] >= 1 and stats["misses"] >= 1
    assert str(build.BUILD_DIR) in stats["dirs"]


def test_kernel_build_cache_counts_hits_and_builds(tmp_path, monkeypatch):
    """kernels/build.py: a library found built is a hit, a fresh nvcc
    build a miss and one build (nvcc stood in by a script that writes
    its -o target)."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\nwhile [ $# -gt 0 ]; do\n"
                    "  if [ \"$1\" = -o ]; then touch \"$2\"; fi\n"
                    "  shift\ndone\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    st0 = flight.kernel_cache_stats()
    c0 = introspect.total_compiles()
    report = build.build_all()
    assert set(report) == set(build.SOURCES)
    assert introspect.total_compiles() == c0 + len(build.SOURCES)
    report = build.build_all()
    assert all(v["log"] == "cached" for v in report.values())
    st = flight.kernel_cache_stats()
    assert st["misses"] - st0["misses"] == len(build.SOURCES)
    assert st["hits"] - st0["hits"] == len(build.SOURCES)
    assert introspect.total_compiles() == c0 + len(build.SOURCES)


# ---------------- device memory ----------------


def test_sample_device_memory_cpu():
    """Without a card every field is -1 (the JAX package reports -1 for
    the bytes it cannot read on the CPU); the gauges follow."""
    out = introspect.sample_device_memory()
    assert out == {"bytes": -1, "peak_bytes": -1, "buffers": -1}
    assert set(out) == set(jintrospect.sample_device_memory())
    assert introspect.sample_device_memory(peak_reset=True) == out
    row = None
    sched = _sched()
    sched.submit(_spec(), now=0.0)
    sched.schedule_cycle(now=0.0)
    row = sched.cycle_trace.snapshot()[-1]
    assert (row["device_bytes"], row["device_peak_bytes"],
            row["device_buffers"]) == (-1, -1, -1)
    assert introspect.self_time_s() > 0.0


# ---------------- the profiler window ----------------


def _jax_window(tmp_path, monkeypatch, sink):
    import jax

    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    return jintrospect.ProfilerWindow(
        base_dir=str(tmp_path / "jax"),
        event_sink=lambda *a, **kw: sink.append((a, kw)))


def _status(pw):
    st = pw.status()
    for key in ("active_dir", "last_capture"):
        st[key] = os.path.basename(st[key])
    return st


def test_profiler_window_lifecycle_matches_jax(tmp_path, monkeypatch):
    """request / tick / status step by step against the JAX window, with
    a real torch.profiler capture on the CPU writing its chrome trace."""
    import torch

    jsink, tsink = [], []
    jw = _jax_window(tmp_path, monkeypatch, jsink)
    tw = introspect.ProfilerWindow(
        base_dir=str(tmp_path / "port"),
        event_sink=lambda *a, **kw: tsink.append((a, kw)))
    d = "cap1"
    steps = [(w.request(2, out_dir=str(tmp_path / n / d)))
             for w, n in ((jw, "jax"), (tw, "port"))]
    assert [ok for ok, _ in steps] == [True, True]
    assert jw.request(1) == tw.request(1) == (
        False, "capture already in progress")
    assert _status(jw) == _status(tw)
    for _ in range(3):
        jw.tick()
        tw.tick()
        with torch.profiler.record_function("crane:solve:immediate"):
            torch.ones(64).cumsum(0)
        assert _status(jw) == _status(tw)
    assert tw.captures_done == 1 and tw.last_error == ""
    trace = tmp_path / "port" / d / introspect.TRACE_FILE
    events = json.loads(trace.read_text())["traceEvents"]
    assert any(e.get("name") == "crane:solve:immediate" for e in events)
    # the same started / written events reached both sinks
    norm = [[(a[0], a[1], os.path.basename(kw.get("detail", "")))
             for a, kw in sink] for sink in (jsink, tsink)]
    assert norm[0] == norm[1] and len(norm[1]) == 2
    assert jw.request(0) == tw.request(0) == (False, "cycles must be > 0")
    assert tw.request(1)[0]


def test_profiler_window_never_raises_into_cycle(tmp_path, monkeypatch):
    def boom():
        raise RuntimeError("no profiler")

    tw = introspect.ProfilerWindow(base_dir=str(tmp_path))
    monkeypatch.setattr(tw, "_start_profiler", boom)
    assert tw.request(3)[0]
    tw.tick()
    st = tw.status()
    assert "no profiler" in st["last_error"]
    assert st["armed"] == 0 and st["remaining"] == 0
    assert tw.request(1)[0]


def test_capture_dirs_never_collide(tmp_path):
    a = introspect.ProfilerWindow(base_dir=str(tmp_path), namespace="s0")
    b = introspect.ProfilerWindow(base_dir=str(tmp_path),
                                  namespace=lambda: "s1")
    c = introspect.ProfilerWindow(base_dir=str(tmp_path))
    dirs = [w.request(1)[1] for w in (a, b, c)]
    assert len(set(dirs)) == 3
    assert os.path.basename(dirs[0]).startswith("capture-s0-")
    assert os.path.basename(dirs[2]).startswith("capture-")


def test_scheduler_window_spans_cycles(tmp_path):
    """The scheduler ticks the window at cycle start: a request of 2
    captures two cycles, whose solves show as crane:solve spans."""
    sched = _sched()
    sched.profiler_window.base_dir = str(tmp_path)
    ok, d = sched.profiler_window.request(2)
    assert ok
    for t in range(3):
        sched.submit(_spec(), now=float(t))
        sched.schedule_cycle(now=float(t))
    st = sched.profiler_window.status()
    assert st["captures_done"] == 1 and st["last_capture"] == d
    names = {e.get("name") for e in json.loads(
        open(os.path.join(d, introspect.TRACE_FILE)).read())["traceEvents"]}
    assert "crane:solve:immediate" in names
    assert [e["type"] for e in sched.events.since(type="profile_capture")] \
        == ["profile_capture"] * 2


# ---------------- the flight recorder ----------------


def test_flight_ring_bounded_and_report_tails():
    fr = FlightRecorder(capacity=16)
    for i in range(50):
        fr.stamp("phase", detail=str(i))
    rep = fr.report(tail=8)
    assert [p["detail"] for p in rep["phases"]] == [str(i)
                                                     for i in range(42, 50)]
    assert rep["stalls_total"] == 0 and rep["last_stall"] is None
    assert rep["armed"] is False and rep["self_time_s"] >= 0.0
    fr.close()


def test_stall_sentry_fires_once_with_stacks_and_event():
    events = []
    fr = FlightRecorder(event_sink=lambda type, sev, detail="":
                        events.append((type, sev, detail)))
    fr.stamp("cycle_begin")
    fr.stamp("prelude")
    fr.arm(0.15, label="cycle")
    assert fr.report()["armed"] is True
    deadline = time.monotonic() + 5.0
    while fr.stalls_total == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    assert fr.stalls_total == 1
    stall = fr.report()["last_stall"]
    assert stall["label"] == "cycle"
    assert [p["phase"] for p in stall["phases"]][-1] == "prelude"
    main = [k for k in stall["stacks"] if k.startswith("MainThread")]
    assert main and any("test_torch_introspect" in ln
                        for ln in stall["stacks"][main[0]])
    assert fr.report()["armed"] is False
    time.sleep(0.3)
    assert fr.stalls_total == 1
    assert events == [("flight_stall", "error",
                       "cycle stalled; last phase prelude; "
                       f"{len(stall['stacks'])} thread stacks captured")]
    fr.close()


def test_disarm_before_deadline_never_fires():
    fr = FlightRecorder()
    fr.arm(0.2, label="cycle")
    fr.disarm()
    time.sleep(0.4)
    assert fr.stalls_total == 0
    fr.arm(30.0)
    assert fr.report()["armed"] is True
    fr.disarm()
    fr.close()


def test_dump_all_stacks_sees_this_thread():
    stacks = dump_all_stacks()
    me = [k for k in stacks if k.startswith("MainThread")]
    assert me and any("test_torch_introspect" in ln
                      for ln in stacks[me[0]])


def test_scheduler_stamps_cycle_phases():
    sched = _sched()
    sched.submit(_spec(), now=0.0)
    sched.schedule_cycle(now=0.0)
    for t in (1.0, 2.0):   # nothing new: the fingerprint skips
        sched.schedule_cycle(now=t)
    phases = [p["phase"] for p in sched.flight.report()["phases"]]
    assert phases[:5] == ["cycle_begin", "prelude", "commit", "dispatch",
                          "cycle_end"]
    assert "skip" in phases


def test_heartbeat_roundtrip_and_torn_tail(tmp_path):
    assert PROBE_PHASES[:2] == ("env_preflight", "torch_import")
    path = str(tmp_path / "hb" / "heartbeat.jsonl")
    hb = Heartbeat(path)
    hb.stamp("torch_import")
    hb.stamp("cuda_init", detail="cpu")
    hb.close()
    beats = read_heartbeat(path)
    assert [b["phase"] for b in beats] == ["torch_import", "cuda_init"]
    assert beats[1]["detail"] == "cpu" and beats[0]["t"] <= beats[1]["t"]
    with open(path, "a", encoding="utf-8") as fh:
        fh.write("\n42\n{\"t\": 17, \"pha")
    assert [b["phase"] for b in read_heartbeat(path)] == [
        "torch_import", "cuda_init"]
    assert read_heartbeat(str(tmp_path / "nope.jsonl")) == []


@pytest.mark.parametrize("capacity", [1, 16, 256])
def test_flight_capacity_floor(capacity):
    assert FlightRecorder(capacity=capacity).capacity == max(capacity, 16)
