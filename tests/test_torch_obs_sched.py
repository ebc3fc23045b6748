"""The observability planes through the port's scheduler against the JAX
scheduler (``solver="device"``): job timelines, events, the cycle trace
ring, explain_pending and SLO evaluations.

Each scenario runs once per package on the same inputs (numpy seeds for
the random ones) and returns what the planes recorded; the two records
must be equal.  Timelines are compared whole (edges, times, seqs,
epochs, node ids, synthetic flags); events whole but for the wall-clock
``time`` of the events the scheduler stamps with ``time.time()``;
trace-ring rows on the fields both packages compute alike, and by key
and type on the backend facts (``*_ms``, ``device_*``, ``recompiles``,
the solver label, which is each package's own).
"""

import types

import numpy as np
import pytest

import cranesched_tpu.craned.sim as jsim
import cranesched_tpu.ctld as jctld
import cranesched_tpu.ctld.accounting as jacct
import cranesched_tpu.ctld.defs as jdefs
import cranesched_tpu.ctld.wal as jwal
import cranesched_tpu.obs.jobtrace as jjobtrace
import cranesched_tpu_torch.craned.sim as tsim
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.ctld.accounting as tacct
import cranesched_tpu_torch.ctld.defs as tdefs
import cranesched_tpu_torch.ctld.wal as twal
import cranesched_tpu_torch.obs.jobtrace as tjobtrace

JAX = types.SimpleNamespace(ctld=jctld, defs=jdefs, sim=jsim, wal=jwal,
                            acct=jacct, jobtrace=jjobtrace, name="jax")
PORT = types.SimpleNamespace(ctld=tctld, defs=tdefs, sim=tsim, wal=twal,
                             acct=tacct, jobtrace=tjobtrace, name="port")

# trace-ring fields both packages compute alike
DETERMINISTIC = ("now", "candidates", "placed", "preempted", "backfilled",
                 "queue_depth", "dirty_jobs", "dirty_nodes", "wal_fsyncs",
                 "wal_groups", "skips", "skip_reason", "running")
# backend facts: same keys and types, not values
BACKEND = ("prelude_ms", "solve_ms", "commit_ms", "dispatch_ms",
           "total_ms", "lock_held_ms", "drain_ms", "recompiles",
           "device_bytes", "device_peak_bytes", "device_buffers", "solver")


def _cluster(env, cpus=(8, 8), config=None, partitions=None, **kw):
    ctld = env.ctld
    meta = ctld.MetaContainer()
    for i, cpu in enumerate(cpus):
        extra = ({} if partitions is None
                 else dict(partitions=(partitions[i % len(partitions)],)))
        meta.add_node(f"cn{i:02d}", meta.layout.encode(
            cpu=cpu, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True), **extra)
        meta.craned_up(i)
    cfg = dict(config or {})
    if env is JAX:
        cfg["solver"] = "device"
    else:
        kw["device"] = "cpu"
    sched = ctld.JobScheduler(meta, ctld.SchedulerConfig(**cfg), **kw)
    sim = env.sim.SimCluster(sched)
    sim.wire(sched)
    return meta, sched, sim


def _spec(env, cpu=1.0, runtime=50.0, **kw):
    ctld = env.ctld
    return ctld.JobSpec(res=ctld.ResourceSpec(cpu=cpu, mem_bytes=1 << 30,
                                              memsw_bytes=1 << 30),
                        sim_runtime=runtime, **kw)


def _events(sched):
    """The event ring, without the wall-clock times (virtual times are
    below 1e8 s in every scenario here).  ``recompile_steady`` is a
    backend fact (the JAX package's jit compiles a new shape bucket, the
    port builds nothing on the CPU): where one was emitted, the rest are
    compared in order without their seqs."""
    rows = [{k: v for k, v in r.items() if k != "time" or v < 1e8}
            for r in sched.events.since()]
    if any(r["type"] == "recompile_steady" for r in rows):
        rows = [{k: v for k, v in r.items() if k != "seq"} for r in rows
                if r["type"] != "recompile_steady"]
    return rows


def _trace_rows(sched):
    rows = []
    for r in sched.cycle_trace.snapshot():
        rows.append(({k: r[k] for k in DETERMINISTIC if k in r},
                     {k: type(r[k]).__name__ for k in BACKEND if k in r}))
    return rows


def _observe(sched, job_ids=None):
    ids = (sorted(set(sched.pending) | set(sched.running)
                  | set(sched.history)) if job_ids is None else job_ids)
    out = {"events": _events(sched), "trace": _trace_rows(sched),
           "node_events": [dict(e) for e in sched.node_events]}
    if sched.jobtrace is not None:
        out["timelines"] = {j: sched.jobtrace.timeline(j) for j in ids}
        out["ledger"] = sched.jobtrace.ledger(ids)
        st = sched.jobtrace.stats()
        st.pop("self_time_s")
        out["jobtrace_stats"] = st
    return out


def _same(scenario, *args):
    a, b = scenario(JAX, *args), scenario(PORT, *args)
    assert a.keys() == b.keys()
    for key in a:
        assert a[key] == b[key], key
    return b


def _edges(doc, incarnation=0):
    inc = [i for i in doc["incarnations"]
           if i["incarnation"] == incarnation][0]
    return [s["edge"] for s in inc["spans"]]


# ---------------- timelines ----------------


def _happy_path(env):
    _, sched, sim = _cluster(env)
    j = sched.submit(_spec(env, runtime=30.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    sim.advance_to(35.0)
    sched.schedule_cycle(now=35.0)
    return _observe(sched)


def test_happy_path_timeline_in_order():
    out = _same(_happy_path)
    doc = out["timelines"][1]
    assert _edges(doc) == [e for e in tjobtrace.SPAN_EDGES
                           if e != "requeue"]
    seqs = [s["seq"] for s in doc["incarnations"][0]["spans"]]
    assert seqs == sorted(set(seqs))
    assert doc["incarnations"][0]["closed"]


def _held(env):
    _, sched, _ = _cluster(env)
    j = sched.submit(_spec(env), now=0.0)
    sched.hold(j, held=True, now=0.0)
    sched.schedule_cycle(now=1.0)
    first = _edges(sched.jobtrace.timeline(j))
    sched.hold(j, held=False, now=2.0)
    sched.schedule_cycle(now=3.0)
    return dict(_observe(sched), first=first)


def test_held_job_is_not_eligible_until_release():
    out = _same(_held)
    assert out["first"] == ["submit"]
    assert "eligible" in _edges(out["timelines"][1])


def _requeue(env):
    _, sched, sim = _cluster(env)
    j = sched.submit(_spec(env, runtime=500.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    assert sched.requeue(j, now=5.0) == ""
    sched.schedule_cycle(now=6.0)
    # a failed run requeues through the status drain (system failure)
    sched.step_status_change(j, env.ctld.JobStatus.FAILED, 1, 7.0,
                             incarnation=1)
    sched.schedule_cycle(now=8.0)
    sim.advance_to(900.0)
    sched.schedule_cycle(now=900.0)
    return _observe(sched)


def test_requeue_across_incarnations():
    out = _same(_requeue)
    incs = {i["incarnation"] for i in out["timelines"][1]["incarnations"]}
    assert incs >= {0, 1}
    assert _edges(out["timelines"][1], 0)[-1] == "requeue"
    assert out["ledger"]["lost"] == [] and out["ledger"]["doubled"] == []
    assert [e["type"] for e in out["events"]].count("requeue") >= 1


def _accounts(env):
    acct = env.acct
    mgr = acct.AccountManager()
    mgr.users["root"] = acct.User(name="root",
                                  admin_level=acct.AdminLevel.ROOT)
    mgr.add_qos("root", acct.Qos(name="low", priority=0))
    mgr.add_qos("root", acct.Qos(name="high", priority=1000,
                                 preempt={"low"}))
    mgr.add_account("root", acct.Account(name="hpc",
                                         allowed_qos={"low", "high"},
                                         default_qos="low"))
    mgr.add_user("root", acct.User(name="alice", uid=1), "hpc")
    return mgr


def _preempted(env, backfill):
    _, sched, _ = _cluster(env, cpus=(8,), accounts=_accounts(env),
                           config=dict(preempt_mode="requeue",
                                       backfill=backfill))

    def qspec(qos):
        return env.ctld.JobSpec(
            user="alice", account="hpc", qos=qos,
            res=env.ctld.ResourceSpec(cpu=8.0, mem_bytes=1 << 30,
                                      memsw_bytes=1 << 30),
            sim_runtime=1e5, time_limit=1e5)

    sched.submit(qspec("low"), now=0.0)
    sched.schedule_cycle(now=0.0)
    sched.submit(qspec("high"), now=1.0)
    sched.schedule_cycle(now=1.0)
    return _observe(sched)


@pytest.mark.parametrize("backfill", [False, True])
def test_preempted_victim_closes_with_requeue(backfill):
    out = _same(_preempted, backfill)
    assert _edges(out["timelines"][1], 0)[-1] == "requeue"
    assert "placed" in _edges(out["timelines"][2])
    assert [e["type"] for e in out["events"]] == ["preemption"]


def _recovery(env, path):
    wal = env.wal.WriteAheadLog(path)
    _, sched, sim = _cluster(env, wal=wal)
    done = sched.submit(_spec(env, runtime=5.0), now=0.0)
    running = sched.submit(_spec(env, runtime=500.0), now=0.0)
    sched.submit(_spec(env, cpu=8.0, runtime=10.0), now=0.0)
    sched.submit(_spec(env, cpu=8.0, runtime=10.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    sim.advance_to(6.0)
    sched.process_status_changes()
    wal.close()
    _, again, _ = _cluster(env)
    again.recover(env.wal.WriteAheadLog.replay(path), now=7.0)
    before = again.jobtrace.stamps_total
    again.jobtrace.seed_recovered(again.job_info(running), 8.0)
    restamped = again.jobtrace.stamps_total - before
    again.step_status_change(running, env.ctld.JobStatus.COMPLETED, 0,
                             500.0, incarnation=0)
    again.schedule_cycle(now=600.0)
    return dict(_observe(again), restamped=restamped,
                first=_observe(sched)["timelines"], done=done)


def test_recovery_seeds_without_dropping_or_doubling(tmp_path):
    a = _recovery(JAX, str(tmp_path / "jax.wal"))
    b = _recovery(PORT, str(tmp_path / "port.wal"))
    assert a == b
    assert b["restamped"] == 0
    # the two jobs that never ran to their end yet; none lost otherwise
    assert b["ledger"]["lost"] == [3, 4]
    assert b["timelines"][2]["incarnations"][0]["spans"][0]["synthetic"]
    assert b["ledger"]["doubled"] == []


def _remote_spans(env):
    _, sched, _ = _cluster(env)
    sched.dispatch = lambda job, nodes: None   # a real node plane's seam
    j = sched.submit(_spec(env), now=0.0)
    sched.schedule_cycle(now=0.0)
    base = sched.trace_seq(j, 0)
    spans = [{"edge": "craned_received", "t": 0.5, "seq": base,
              "node_id": 1, "skew": 0.01},
             {"edge": "cgroup_ready", "t": 0.6, "seq": base + 1},
             types.SimpleNamespace(edge="step_start", time=0.7,
                                   seq=base + 2, node_id=1, skew=0.0)]
    n = [sched.record_remote_spans(j, 0, spans),
         sched.record_remote_spans(j, 0, spans[:1]),   # a retried report
         sched.trace_seq(j, 0), sched.trace_seq(99, 0)]
    return dict(_observe(sched), n=n)


def test_record_remote_spans_and_trace_seq():
    out = _same(_remote_spans)
    assert out["n"][:2] == [3, 0]


# ---------------- the cycle trace ring ----------------


def _skip_rows(env):
    _, sched, _ = _cluster(env)
    sched.submit(_spec(env, cpu=8.0, runtime=1e6), now=0.0)
    sched.submit(_spec(env, cpu=8.0, runtime=1e6), now=0.0)
    sched.submit(_spec(env, cpu=8.0, runtime=1e6), now=0.0)  # no room
    sched.schedule_cycle(now=0.0)
    for t in range(1, 6):   # places nothing, then 4 skipped cycles
        sched.schedule_cycle(now=float(t))
    sched.submit(_spec(env, cpu=8.0, runtime=1e6), now=6.0)
    for t in range(6, 9):
        sched.schedule_cycle(now=float(t))
    return _observe(sched)


def test_skip_rows_coalesce():
    out = _same(_skip_rows)
    skips = [r for r, _ in out["trace"] if r.get("skip_reason")]
    assert skips and skips[0]["skips"] >= 3


def _mixed(env, seed, backfill):
    rng = np.random.default_rng(seed)
    _, sched, sim = _cluster(env, cpus=tuple(rng.integers(4, 17, 8)),
                             partitions=("a", "b"),
                             config=dict(backfill=backfill,
                                         backfill_max_jobs=6,
                                         cycle_trace_ring=16))
    now = 0.0
    for cycle in range(8):
        for _ in range(int(rng.integers(0, 12))):
            sched.submit(_spec(env, cpu=float(rng.integers(1, 9)),
                               runtime=float(rng.integers(10, 400)),
                               time_limit=float(rng.integers(400, 900)),
                               node_num=int(rng.integers(1, 3)),
                               partition=("a", "b")[rng.integers(0, 2)]),
                         now=now)
        sched.schedule_cycle(now=now)
        now += float(rng.integers(20, 200))
        sim.advance_to(now)
    return _observe(sched)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("backfill", [False, True])
def test_trace_rows_and_timelines_random(seed, backfill):
    out = _same(_mixed, seed, backfill)
    assert len(out["trace"]) > 1
    keys = set(out["trace"][-1][1])
    assert {"recompiles", "device_bytes", "total_ms"} <= keys


# ---------------- events ----------------


def _node_events(env):
    meta, sched, _ = _cluster(env)
    got = []
    sched.node_event_hook = got.append
    sched.submit(_spec(env, runtime=1e6), now=0.0)
    sched.schedule_cycle(now=0.0)
    sched.on_craned_down(0, now=10.0)
    sched.emit_node_event("node_up", "cn00", now=20.0)
    sched.emit_node_event("drain", "cn01", detail="maint", now=30.0)
    sched.emit_node_event("undrain", "cn01", now=40.0)
    sched.emit_node_event("node_down", "cn01", now=50.0)
    sched.emit_node_event("node_up", "cn01", now=50.0 + 1e4)
    import time

    deadline = time.time() + 10.0
    while len(got) < 6 and time.time() < deadline:
        time.sleep(0.01)
    return dict(_observe(sched), hook=[dict(r) for r in got])


def test_node_transitions_and_requeue_events():
    out = _same(_node_events)
    types_ = [e["type"] for e in out["events"]]
    assert types_[:3] == ["node_down", "requeue", "node_up"]
    assert "node_flap" in types_ and types_.count("node_flap") == 1
    assert out["hook"] == out["node_events"]


def _slo(env):
    _, sched, sim = _cluster(env, cpus=(4,), config=dict(
        slo=(("s2d", "submit", "dispatched", 50.0, 5.0, (100.0,)),)))
    for t in range(6):
        sched.submit(_spec(env, cpu=4.0, runtime=30.0), now=float(t))
    now = 0.0
    tables = []
    for _ in range(8):
        sched.schedule_cycle(now=now)
        tables.append(sched.slo_engine.evaluate(now))
        now += 31.0
        sim.advance_to(now)
    tables.append(sched.slo_engine.evaluate(now + 500.0))
    return dict(_observe(sched), tables=tables)


def test_slo_breach_and_clear_events():
    out = _same(_slo)
    types_ = [e["type"] for e in out["events"]]
    assert "slo_breach" in types_ and "slo_clear" in types_


# ---------------- explain_pending ----------------


def _explain_gates(env):
    defs = env.defs
    _, sched, _ = _cluster(env, cpus=(8, 8, 8))
    sched.licenses.configure("lic", 1)
    held = sched.submit(_spec(env, held=True), now=0.0)
    future = sched.submit(_spec(env, begin_time=500.0), now=0.0)
    blocker = sched.submit(_spec(env, cpu=8.0, runtime=1e6), now=0.0)
    dep = sched.submit(_spec(env, dependencies=(defs.Dependency(
        blocker, defs.DepType.AFTER_OK),)), now=0.0)
    lic_a = sched.submit(_spec(env, licenses={"lic": 1}, runtime=1e6),
                         now=0.0)
    lic_b = sched.submit(_spec(env, licenses={"lic": 1}), now=0.0)
    big = sched.submit(_spec(env, cpu=8.0, node_num=3), now=0.0)
    sched.schedule_cycle(now=0.0)
    ids = [held, future, dep, lic_a, lic_b, big, blocker, 9999]
    return dict(_observe(sched), explain=[
        sched.explain_pending(j, 0.0) for j in ids])


def test_explain_gates_match_jax():
    out = _same(_explain_gates)
    gates = [e["gate"] for e in out["explain"]]
    assert gates[:3] == ["held", "begin_time", "dependency"]
    assert "license" in gates and gates[-1] == "exists"


def _explain_resources(env):
    meta, sched, _ = _cluster(env, cpus=(8, 8))
    for _ in range(2):
        sched.submit(_spec(env, cpu=8.0, runtime=1e6), now=0.0)
    queued = sched.submit(_spec(env, cpu=4.0), now=0.0)
    gang = sched.submit(_spec(env, cpu=4.0, node_num=2), now=0.0)
    sched.schedule_cycle(now=0.0)
    out = [sched.explain_pending(queued, 0.0)]
    info = sched.job_info(1)
    sched.meta.free_resource(1, info.node_ids, sched.meta.layout.encode(
        cpu=8.0, mem_bytes=1 << 30, memsw_bytes=1 << 30))
    out.append(sched.explain_pending(queued, 0.0))
    meta.craned_down(1)
    out.append(sched.explain_pending(gang, 1.0))
    return dict(_observe(sched), explain=out)


def test_explain_resource_priority_alive_match_jax():
    out = _same(_explain_resources)
    assert [(e["reason"], e["gate"]) for e in out["explain"]] == [
        ("Resource", "resources"), ("Priority", "priority"),
        ("Constraint", "alive")]


def _explain_qos_resv_topo(env):
    acct = env.acct
    mgr = _accounts(env)
    mgr.add_qos("root", acct.Qos(name="one", max_jobs_per_user=1))
    mgr.accounts["hpc"].allowed_qos.add("one")
    meta, sched, _ = _cluster(env, cpus=(8,) * 8, accounts=mgr)
    meta.set_topology(_topology(env, 8, 2))
    user = dict(user="alice", account="hpc")
    a = sched.submit(_spec(env, qos="one", runtime=1e6, **user), now=0.0)
    b = sched.submit(_spec(env, qos="one", **user), now=0.0)
    meta.create_reservation("r", "default", ["cn00"], 100.0, 200.0)
    resv = sched.submit(_spec(env, reservation="r", **user), now=0.0)
    sched.schedule_cycle(now=0.0)
    # one node of each block of two down: a gang of 2 fits now, in no
    # single block
    for nid in (1, 3, 5, 7):
        meta.craned_down(nid)
    gang = sched.submit(_spec(env, cpu=4.0, node_num=2, **user), now=2.0)
    ids = [a, b, resv, gang]
    return dict(_observe(sched), explain=[
        sched.explain_pending(j, 2.0) for j in ids])


def _topology(env, n, block):
    mod = (__import__("cranesched_tpu.topo", fromlist=["Topology"])
           if env is JAX else
           __import__("cranesched_tpu_torch.topo", fromlist=["Topology"]))
    return mod.Topology.uniform_blocks(n, block)


def test_explain_qos_reservation_topology_match_jax():
    out = _same(_explain_qos_resv_topo)
    assert [e["gate"] for e in out["explain"][1:]] == [
        "qos_limit", "eligibility", "topology"]


def _explain_random(env, seed):
    rng = np.random.default_rng(140814 + seed)
    defs = env.defs
    cpus = tuple(int(c) for c in rng.choice((2, 4, 8, 16), 8))
    meta, sched, _ = _cluster(env, cpus=cpus)
    blockers = [sched.submit(_spec(env, cpu=float(c), runtime=1e6),
                             now=0.0)
                for c in cpus if rng.random() < 0.7]
    sched.schedule_cycle(now=0.0)
    jobs = []
    for _ in range(40):
        kw = {}
        r = rng.random()
        if r < 0.15:
            kw["held"] = True
        elif r < 0.30:
            kw["begin_time"] = float(rng.uniform(100.0, 1000.0))
        elif r < 0.45 and blockers:
            kw["dependencies"] = (defs.Dependency(
                int(rng.choice(blockers)), defs.DepType.AFTER_OK),)
        jid = sched.submit(_spec(env, cpu=float(rng.choice((1, 2, 4, 8,
                                                            16))),
                                 node_num=int(rng.choice((1, 1, 1, 2, 3))),
                                 runtime=1e6, **kw), now=1.0)
        if jid:
            jobs.append(jid)
    sched.schedule_cycle(now=1.0)
    for nid in rng.choice(len(cpus), 2, replace=False):
        meta.craned_down(int(nid))
    explained = [sched.explain_pending(j, 2.0) for j in jobs]
    reasons = [(e["reason"], e.get("pending_reason")) for e in explained]
    return dict(_observe(sched), explain=explained, reasons=reasons)


@pytest.mark.parametrize("seed", range(3))
def test_explain_random_match_jax(seed):
    out = _same(_explain_random, seed)
    assert len({r for r, _ in out["reasons"] if r}) >= 3


# ---------------- job_trace off ----------------


def test_job_trace_off_removes_the_recorder():
    _, sched, sim = _cluster(PORT, config=dict(job_trace=False))
    sched.submit(_spec(PORT, runtime=5.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    sim.advance_to(10.0)
    sched.schedule_cycle(now=10.0)
    assert sched.jobtrace is None
    assert sched.trace_seq(1, 0) == 0
    assert sched.record_remote_spans(1, 0, [{"edge": "end", "t": 1.0,
                                             "seq": 0}]) == 0
    assert len(sched.cycle_trace) == 1
