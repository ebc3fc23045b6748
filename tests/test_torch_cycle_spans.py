"""The port's cycle span tree (``obs/trace.py::CycleSpans``) in the
scheduler's trace rows, the WAL's byte and record counters, and the
benchmark's readers of both.

On a small CPU cluster, one cycle of each route (immediate, backfill, the
split backfill, packed, topology) and a skipped cycle: the row carries its
``cycle``, ``t0``, ``spans``, ``wal_bytes`` and ``wal_records``; the spans
nest, siblings do not overlap, the root's direct children cover it up to a
small self time, every time sits on ``perf_counter`` inside the call, and
``wal_bytes`` / ``wal_records`` are the WAL file's growth over the cycle.
"""

import os
import time
import types

import pytest

from crane_bench import spec as bench_spec
from cranesched_tpu_torch import ctld
from cranesched_tpu_torch.craned.sim import SimCluster
from cranesched_tpu_torch.ctld.defs import Job
from cranesched_tpu_torch.ctld.wal import WriteAheadLog
from cranesched_tpu_torch.obs.trace import CycleSpans, span_tree
from cranesched_tpu_torch.rpc import CtldClient, serve
from cranesched_tpu_torch.topo import Topology

NODES = 16


def _sched(tmp_path, topology=False, **cfg):
    meta = ctld.MetaContainer()
    for i in range(NODES):
        meta.add_node(f"cn{i:02d}", meta.layout.encode(
            cpu=16, mem_bytes=32 << 30, memsw_bytes=32 << 30,
            is_capacity=True))
        meta.craned_up(i)
    if topology:
        meta.set_topology(Topology.uniform_blocks(NODES, 4))
    sched = ctld.JobScheduler(meta, ctld.SchedulerConfig(**cfg),
                              device="cpu")
    sim = SimCluster(sched)
    sim.wire(sched)
    sched.wal = WriteAheadLog(str(tmp_path / "ctld.wal"), fsync=True)
    return sched, sim


def _spec(cpu=2.0, **kw):
    return ctld.JobSpec(res=ctld.ResourceSpec(
        cpu=cpu, mem_bytes=1 << 30, memsw_bytes=1 << 30),
        sim_runtime=60.0, time_limit=600, **kw)


def _submit(sched, specs):
    with sched.wal.group():
        for s in specs:
            assert sched.submit(s, now=0.0) > 0


# route -> (scheduler config, jobs, spans the row must hold)
ROUTES = {
    "immediate": (dict(backfill=False), lambda: [_spec() for _ in range(40)],
                  {"solve:immediate", "commit", "stage"}),
    "backfill": (dict(backfill_max_jobs=64),
                 lambda: [_spec() for _ in range(40)],
                 {"timed_state", "solve:backfill", "commit", "stage"}),
    "backfill-split": (dict(backfill_max_jobs=8),
                       lambda: [_spec() for _ in range(40)],
                       {"timed_state", "solve:backfill:head", "commit:head",
                        "solve:immediate:tail", "commit:tail"}),
    "packed": (dict(backfill=False),
               lambda: [_spec() for _ in range(20)]
               + [_spec(exclusive=True) for _ in range(4)],
               {"solve:packed", "commit"}),
    "topo": (dict(backfill=False),
             lambda: [_spec(node_num=2) for _ in range(12)],
             {"solve:topo", "commit"}),
}
# every cycle that reaches a solve: the root's direct children before the
# route's own and after them, in this order (``wal:flush`` falls between
# any two, before each solve and after the commit)
FRONT = ["drain", "candidates", "snapshot", "priority", "batch"]
TAIL = ["preempt", "record", "dispatch"]


def _file(path):
    with open(path, "rb") as fh:
        data = fh.read()
    return len(data), data.count(b"\n")


def _timed_cycle(sched, now):
    """One cycle; (row, call start, call end, WAL bytes, WAL lines)."""
    path = sched.wal.path
    b0, n0 = _file(path)
    t_in = time.perf_counter()
    sched.schedule_cycle(now)
    t_out = time.perf_counter()
    b1, n1 = _file(path)
    row = sched.cycle_trace.snapshot(last=1)[0]
    return row, t_in, t_out, b1 - b0, n1 - n0


def _check_tree(row, t_in, t_out):
    spans = row["spans"]
    assert row["t0"] >= t_in
    root = [i for i, s in enumerate(spans) if s[0] == "cycle"]
    assert len(root) == 1 and spans[root[0]][1] == -1
    root = root[0]
    eps = 1e-6
    for i, (name, parent, start, end) in enumerate(spans):
        assert end is not None and end >= start, (name, start, end)
        # on perf_counter, inside the call
        assert row["t0"] + start / 1e3 >= t_in - eps
        assert row["t0"] + end / 1e3 <= t_out + eps
        if parent >= 0:
            assert parent < i
            p = spans[parent]
            assert p[2] - eps <= start and end <= p[3] + eps, (name, p[0])
        elif i != root:
            # a span before the root ends before it opens
            assert end <= eps
    kids = {}
    for i, s in enumerate(spans):
        kids.setdefault(s[1], []).append(s)
    for group in kids.values():
        group = sorted(group, key=lambda s: s[2])
        for a, b in zip(group, group[1:]):
            assert a[3] <= b[2] + eps, (a[0], b[0])
    tree = span_tree(row)
    root_ms, self_ms = tree[root][3], tree[root][4]
    assert self_ms <= max(2.0, 0.1 * root_ms), (self_ms, root_ms)
    return [s[0] for s in spans if s[1] == root]


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_row_carries_a_covering_span_tree(route, tmp_path):
    cfg, jobs, names = ROUTES[route]
    sched, sim = _sched(tmp_path, topology=route == "topo", **cfg)
    _submit(sched, jobs())
    row, t_in, t_out, grew, lines = _timed_cycle(sched, 1.0)
    assert row["solver"] == route or (
        route == "immediate" and row["solver"] in ("cuda", "cuda-stream"))
    assert row["placed"] > 0
    top = _check_tree(row, t_in, t_out)
    assert names <= set(top), (names - set(top), top)
    assert [n for n in top if n in FRONT] == FRONT
    assert [n for n in top if n in TAIL] == TAIL
    route_spans = top[len(FRONT):top.index("preempt")]
    assert names - {"stage"} <= set(route_spans)
    # the drain holds the status drain and the lifecycle checks
    drain = next(i for i, s in enumerate(row["spans"]) if s[0] == "drain")
    assert [s[0] for s in row["spans"] if s[1] == drain] == [
        "status_drain", "lifecycle"]
    assert row["wal_bytes"] == grew > 0
    assert row["wal_records"] == lines == row["placed"]
    assert isinstance(row["cycle"], int) and row["cycle"] >= 1
    # a second cycle after every job ended: its row also counts the
    # end records its status drain writes
    sim.advance_to(400.0)
    _submit(sched, jobs())
    row2, t_in, t_out, grew, lines = _timed_cycle(sched, 400.0)
    _check_tree(row2, t_in, t_out)
    assert row2["cycle"] == row["cycle"] + 1 and row2["placed"] > 0
    assert (row2["wal_bytes"], row2["wal_records"]) == (grew, lines)
    assert row2["wal_records"] == row2["placed"] + row["placed"]


def test_skipped_cycle_row_carries_its_root_and_candidates(tmp_path):
    sched, _sim = _sched(tmp_path, backfill=False)
    # one job more than the nodes hold: the second cycle places nothing
    # and arms the no-op fingerprint, the next ones are skipped and
    # coalesced into one row
    _submit(sched, [_spec(cpu=16.0) for _ in range(NODES + 1)])
    sched.schedule_cycle(1.0)
    sched.schedule_cycle(1.5)
    first = sched.cycle_trace.snapshot(last=1)[0]
    assert first["solver"] != "skip" and first["placed"] == 0
    for now in (2.0, 3.0):
        row, t_in, t_out, grew, lines = _timed_cycle(sched, now)
        assert row["solver"] == "skip" and row["now"] == now
        top = _check_tree(row, t_in, t_out)
        assert top[:2] == ["drain", "candidates"]
        assert set(top) <= {"drain", "candidates", "wal:flush"}
        assert (row["wal_bytes"], row["wal_records"]) == (grew, lines) \
            == (0, 0)
    assert row["skips"] == 2 and row["cycle"] == first["cycle"] + 2


def test_flight_stamps_carry_the_spans_clock(tmp_path):
    sched, _sim = _sched(tmp_path, backfill=False)
    _submit(sched, [_spec() for _ in range(4)])
    row, t_in, t_out, _g, _n = _timed_cycle(sched, 1.0)
    phases = sched.flight.report()["phases"][-5:]
    assert [p["phase"] for p in phases] == [
        "cycle_begin", "prelude", "commit", "dispatch", "cycle_end"]
    stamps = [p["perf_counter"] for p in phases]
    assert stamps == sorted(stamps)
    root = next(s for s in row["spans"] if s[0] == "cycle")
    assert row["t0"] <= stamps[0] and \
        stamps[-1] <= row["t0"] + root[3] / 1e3 <= t_out


def test_tick_mode_row_holds_lock_wait_and_sim_advance(tmp_path):
    sched, sim = _sched(tmp_path, backfill=False)
    _submit(sched, [_spec(cpu=16.0) for _ in range(3 * NODES)])
    server, port = serve(sched, sim=sim, tick_mode=True)
    client = CtldClient(f"127.0.0.1:{port}")
    try:
        for now in (1.0, 90.0):
            t_in = time.perf_counter()
            client.tick(now)
            t_out = time.perf_counter()
            row = sched.cycle_trace.snapshot(last=1)[0]
            assert row["now"] == now
            spans = row["spans"]
            assert [s[:2] for s in spans[:3]] == [
                ["lock_wait", -1], ["sim_advance", -1], ["cycle", -1]]
            # the handler's lock request to the root: back to back
            assert spans[0][3] == spans[1][2] and spans[1][3] <= 0.0
            assert row["t0"] + spans[0][2] / 1e3 >= t_in
            _check_tree(row, t_in, t_out)
    finally:
        client.close()
        server.stop()
        sched.wal.close()


def test_spans_outside_a_cycle_record_nothing():
    spans = CycleSpans()
    with spans.span("wal:flush"):
        pass
    assert spans.spans == [] and spans.cycle == 0
    spans.before("lock_wait", 1.0, 1.5)
    spans.begin()
    i = spans.open("batch")
    spans.end()
    spans.close(i)   # already closed by end: no-op
    assert [s[:2] for s in spans.spans] == [
        ["lock_wait", -1], ["cycle", -1], ["batch", 1]]
    assert spans.spans[0][2] == pytest.approx((1.0 - spans.t0) * 1e3)
    with spans.span("late"):
        pass
    assert len(spans.spans) == 3 and spans.fields()["cycle"] == 1


# ---------------- the benchmark's readers over synthetic rows ----------------

def _row(spans, **fields):
    return dict(spans=spans, **fields)


ROWS = [
    # root 0-100 ms; children cover 0-40 and 50-90 (40-50 and 90-100
    # unnamed), a nested flush inside the drain
    _row([["lock_wait", -1, -3.0, -1.0], ["cycle", -1, 0.0, 100.0],
          ["drain", 1, 0.0, 10.0], ["wal:flush", 2, 2.0, 3.0],
          ["timed_state", 1, 10.0, 40.0], ["wal:flush", 1, 50.0, 55.0],
          ["commit", 1, 55.0, 90.0]], wal_bytes=2400),
    # root 0-50; children 0-20 and 10-30 overlap, 45-60 past the root
    _row([["cycle", -1, 0.0, 50.0], ["drain", 0, 0.0, 20.0],
          ["commit", 0, 10.0, 30.0], ["wal:flush", 0, 45.0, 60.0]],
         wal_bytes=1200),
]
# (unnamed 20 + 15) / 2; timed_state in one row; flush (1 + 5, 15) / 2
WANT = {"cycle_unnamed_ms": 17.5, "timed_state_ms": 30.0,
        "wal_flush_ms": 10.5, "wal_bytes_per_tick": 1800.0}


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_reader_over_synthetic_rows(name):
    read = bench_spec.metric_reader(name)

    def ctx(rows):
        return types.SimpleNamespace(ticks=[{"row": r, "wall_ms": 1.0}
                                            for r in rows])

    assert read(ctx(ROWS)) == pytest.approx(WANT[name])
    # rows of a program without spans or WAL counters: nothing to read
    assert read(ctx([{"total_ms": 5.0}, None])) is None


def test_wal_counts_what_it_appends(tmp_path):
    path = str(tmp_path / "w.wal")
    wal = WriteAheadLog(path, fsync=False)
    job = Job(job_id=1, spec=_spec(), submit_time=0.0)
    wal.job_submitted(job)
    with wal.group():
        wal.job_updated(job)
        wal.job_updated(job)
    wal.close()
    assert wal.records_total == 3
    assert wal.bytes_total == os.path.getsize(path)
