"""The port's CraneCtld service (``cranesched_tpu_torch/rpc/``) on the CPU.

- *Parity*: a JAX server and a port server, each in tick mode on its own
  socket with auth on, get the same scripted session covering every RPC
  the port serves: submits (with the deny and parse-error paths), job
  control, steps and allocations, the job, step and cluster queries with
  their cursors and the stream's ``truncated`` flag, reservations, node
  control, tokens, the craned-internal surface, ``Tick`` at fixed
  ``now``s, requeue, the job summary with its timeline and explanation,
  events, stats, the accounting surface and the profiler window.
  Replies are compared by ``SerializeToString(deterministic=True)``,
  apart from the fields listed in ``WALL``: wall-clock times, random
  tokens and backend facts, compared by type.
- *Cases ported from the JAX tests*: ``tests/test_rpc_cli.py`` (those
  that do not go through ``cli.py``) and ``tests/test_obs.py``'s
  metrics endpoint, ``QueryStats`` and watchdog fault injection.
- *The WAL of a batch submit*: the JAX server's records byte for byte,
  one group (one fsync) per 32-spec chunk.
- *The federation and HA replication RPCs* (once refused naming ROADMAP.md
  A14 and A13): each answers a shard's reply, and a standby serves
  queries and refuses mutations
  (``tests/test_torch_ha.py`` holds them against the JAX package).  A
  real node plane (``dispatcher=``) is accepted, registered craneds get
  push channels, and ``stop()`` closes it.
"""

import json
import time
import types
import urllib.error
import urllib.request

import grpc
import numpy as np
import pytest

import cranesched_tpu.craned.sim as jsim
import cranesched_tpu.ctld as jctld
import cranesched_tpu.ctld.accounting as jacct
import cranesched_tpu.ctld.auth as jauth
import cranesched_tpu.ctld.wal as jwal
import cranesched_tpu.rpc.client as jclient
import cranesched_tpu.rpc.server as jserver
import cranesched_tpu_torch.craned.sim as tsim
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.ctld.accounting as tacct
import cranesched_tpu_torch.ctld.auth as tauth
import cranesched_tpu_torch.ctld.wal as twal
import cranesched_tpu_torch.rpc.client as tclient
import cranesched_tpu_torch.rpc.server as tserver
from cranesched_tpu_torch.craned import SimCluster
from cranesched_tpu_torch.ctld import (
    JobScheduler,
    JobSpec,
    MetaContainer,
    ResourceSpec,
    SchedulerConfig,
)
from cranesched_tpu_torch.obs import REGISTRY
from cranesched_tpu_torch.obs.metrics import MetricsRegistry, serve_metrics
from cranesched_tpu_torch.rpc import CtldClient, crane_pb2 as pb, serve
from cranesched_tpu_torch.rpc.client import StreamResult

JAX = types.SimpleNamespace(ctld=jctld, sim=jsim, acct=jacct, auth=jauth,
                            wal=jwal, client=jclient, server=jserver,
                            name="jax")
PORT = types.SimpleNamespace(ctld=tctld, sim=tsim, acct=tacct, auth=tauth,
                             wal=twal, client=tclient, server=tserver,
                             name="port")


def _wait(predicate, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(interval)
    return False


# ---------------- parity: one scripted session, two servers ----------------

# reply fields compared by type, not value: wall-clock times, the random
# token plaintext, the capture directory's name, and the backend facts of
# the stats document (timings, build counts, device kinds, the solver
# label, the stream count)
_TRACE_BACKEND = ("prelude_ms", "solve_ms", "commit_ms", "dispatch_ms",
                  "total_ms", "lock_held_ms", "drain_ms", "solver",
                  "recompiles", "device_bytes", "device_peak_bytes",
                  "device_buffers", "num_streams")
WALL = ({"TokenReply.token", "CaptureProfileReply.dir",
         "stats.watchdog.now", "stats.watchdog.last_cycle_walltime",
         "stats.last_cycle_walltime", "stats.jobtrace.self_time_s",
         "event.time"}
        | {f"stats.{row}.{k}" for row in ("last_cycle", "cycle_trace")
           for k in _TRACE_BACKEND})
# compared as "a JSON object" only: each package's process-wide metric
# registry (other tests in the process feed it too) and the flight
# recorder's wall-clock phase ring
OPAQUE = {"stats.metrics", "stats.flight"}
# what the port's trace rows carry beyond the JAX package's: finer
# timings, the scheduler's device and greedy_place's launches, the span
# tree and the WAL's bytes and records
PORT_ONLY = {"stats.cycle_trace": ("batch_ms", "priority_ms",
                                   "solve_head_ms", "solve_tail_ms",
                                   "device", "kernel_launches", "cycle",
                                   "t0", "spans", "wal_bytes",
                                   "wal_records")}


def _typed(x):
    """The type skeleton of a JSON value (dicts by key)."""
    if isinstance(x, dict):
        return {k: _typed(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_typed(v) for v in x]
    return "num" if isinstance(x, (int, float)) and \
        not isinstance(x, bool) else type(x).__name__


def _masked(x, path):
    """``x`` with every field under a WALL path replaced by its type
    skeleton, OPAQUE ones by their type name and PORT_ONLY keys dropped
    (list rows share their list's path)."""
    if path in OPAQUE:
        return type(x).__name__
    if path in WALL:
        return _typed(x)
    if isinstance(x, dict):
        drop = PORT_ONLY.get(path, ())
        return {k: _masked(v, f"{path}.{k}") for k, v in x.items()
                if k not in drop}
    if isinstance(x, list):
        return [_masked(v, path) for v in x]
    return x


def _norm(label, reply):
    """What is compared of one reply."""
    name = type(reply).__name__
    if name == "StatsReply":
        return (name, reply.durable_seq,
                _masked(json.loads(reply.json), "stats"))
    if name == "QueryJobSummaryReply":
        doc = {f: (json.loads(getattr(reply, f)) if getattr(reply, f)
                   else "")
               for f in ("timeline_json", "explain_json")}
        rest = type(reply)()
        rest.CopyFrom(reply)
        rest.timeline_json = rest.explain_json = ""
        return (name, rest.SerializeToString(deterministic=True), doc)
    if name == "QueryEventsReply":
        events = []
        for e in reply.events:
            d = {f.name: v for f, v in e.ListFields()}
            # events stamped with time.time() (virtual times are < 1e8)
            if d.get("time", 0.0) > 1e8:
                d["time"] = "wall"
            events.append(d)
        return (name, reply.durable_seq, events)
    for field in ("token", "dir"):
        if f"{name}.{field}" in WALL and getattr(reply, field):
            rest = type(reply)()
            rest.CopyFrom(reply)
            setattr(rest, field, "")
            return (name, rest.SerializeToString(deterministic=True),
                    type(getattr(reply, field)).__name__)
    return (name, reply.SerializeToString(deterministic=True))


def _pbspec(i, rng, user="alice", **kw):
    part = ("p0", "p1")[i % 2]
    return pb.JobSpec(
        name=f"j{i}", user=user, partition=part,
        res=pb.ResourceSpec(cpu=float(rng.integers(1, 9)),
                            mem_bytes=int(rng.integers(1, 8)) << 30),
        time_limit=int(rng.integers(2, 40) * 60),
        sim_runtime=float(rng.integers(1, 30) * 60), **kw)


def _server(env, tmp_path, accounts=False, nodes=96):
    ctld = env.ctld
    meta = ctld.MetaContainer()
    for p in ("p0", "p1"):
        meta.add_partition(p, priority=10)
    for i in range(nodes):
        meta.add_node(f"cn{i:03d}", meta.layout.encode(
            cpu=16, mem_bytes=64 << 30, memsw_bytes=64 << 30,
            is_capacity=True), partitions=(("p0", "p1")[i % 2],))
        meta.craned_up(i)
    kw = {}
    if accounts:
        mgr = env.acct.AccountManager()
        mgr.users["root"] = env.acct.User(
            name="root", admin_level=env.acct.AdminLevel.ROOT)
        kw["accounts"] = mgr
    if env is JAX:
        sched = ctld.JobScheduler(meta, ctld.SchedulerConfig(
            solver="device", backfill_max_jobs=64), **kw)
    else:
        sched = ctld.JobScheduler(meta, ctld.SchedulerConfig(
            backfill_max_jobs=64), device="cpu", **kw)
    sim = env.sim.SimCluster(sched)
    sim.wire(sched)
    auth = env.auth.AuthManager(str(tmp_path / f"{env.name}-tokens.json"))
    server = env.server.CtldServer(sched, sim=sim, tick_mode=True,
                                   auth=auth)
    port = server.start("127.0.0.1:0")
    return server, sched, auth, f"127.0.0.1:{port}"


def _main_session(env, tmp_path):
    """Every RPC the port serves, in one scripted session; returns the
    (label, reply) list."""
    server, sched, auth, addr = _server(env, tmp_path)
    server.QUERY_CHUNK = 64      # several chunks on the wire
    Client = env.client.CtldClient
    root = Client(addr, token=auth.root_token)
    craned = Client(addr, token=auth.craned_token)
    anon = Client(addr)
    clients = [root, craned, anon]
    out = []

    def rec(label, reply):
        out.append((label, reply))
        return reply

    def user(name):
        c = Client(addr, token=rec(f"issue {name}",
                                   root.issue_token(name)).token)
        clients.append(c)
        return c

    try:
        rng = np.random.default_rng(7)
        alice, mallory = user("alice"), user("mallory")
        rec("issue denied", alice.issue_token("eve"))
        rec("submit", alice.submit(_pbspec(0, rng)))
        rec("submit as other", alice.submit(_pbspec(1, rng, user="bob")))
        rec("submit anon", anon.submit(_pbspec(2, rng)))
        bad = _pbspec(3, rng)
        bad.dependencies.add(job_id=1, type="nonsense")
        rec("submit bad dep", alice.submit(bad))
        alloc = rec("alloc", alice.submit(pb.JobSpec(
            user="alice", partition="p0", alloc_only=True,
            time_limit=3600, res=pb.ResourceSpec(
                cpu=4.0, mem_bytes=1 << 30)))).job_id
        specs = [_pbspec(i, rng) for i in range(4, 400)]
        specs[5].user = "bob"        # identity mismatch inside a batch
        rec("submit many", alice.submit_many(specs))
        rec("hold", alice.hold(300))
        rec("hold denied", mallory.hold(301))
        for now in (0.0, 60.0):
            rec(f"tick {now}", root.tick(now))
        rec("tick denied", alice.tick(120.0))
        rec("jobs", root.query_jobs())
        rec("jobs anon", _abort_code(lambda: anon.query_jobs()))
        cursor = 0
        for k in range(3):
            page = rec(f"page {k}", root.query_jobs(
                limit=150, after_job_id=cursor))
            cursor = page.jobs[-1].job_id
        res = StreamResult()
        rec("stream", [j.SerializeToString(deterministic=True)
                       for j in root.query_jobs_stream(limit=200,
                                                       result=res)])
        rec("stream truncated", res.truncated)
        rec("stream user", [j.job_id for j in root.query_jobs_stream(
            user="alice", partition="p1")])
        rec("cluster", root.query_cluster())
        running = [j.job_id for j in root.query_jobs().jobs
                   if j.status == "Running" and j.job_id != alloc]
        rec("suspend", alice.suspend(running[0]))
        rec("resume", root.resume(running[0]))
        rec("suspend denied", mallory.suspend(running[1]))
        rec("modify lower", alice.modify_job(running[2], time_limit=60.0))
        rec("modify raise", alice.modify_job(running[2],
                                             time_limit=9e4))
        rec("modify prio", alice.modify_job(300, priority=5))
        rec("modify prio root", root.modify_job(300, priority=5))
        rec("modify part", root.modify_job(302, partition="p0"))
        rec("cancel denied", mallory.cancel(running[3]))
        rec("cancel", alice.cancel(running[3]))
        rec("cancel pending", alice.cancel(350))
        rec("cancel missing", root.cancel(99999))
        rec("requeue", root.requeue(running[4]))
        rec("requeue pending", root.requeue(301))
        share = pb.ResourceSpec(cpu=1.0)
        s0 = rec("step", alice.submit_step(alloc, pb.StepSpec(
            name="a", res=share, sim_runtime=30.0))).step_id
        rec("step fail", alice.submit_step(alloc, pb.StepSpec(
            name="b", res=share, sim_runtime=30.0, sim_exit_code=3)))
        rec("step denied", mallory.submit_step(alloc, pb.StepSpec(
            name="x", sim_runtime=5.0)))
        rec("steps", root.query_steps(alloc))
        rec("cancel step", alice.cancel_step(alloc, s0))
        rec("resv", root.create_reservation("maint", "p1", ["cn001"],
                                            5000.0, 9000.0))
        rec("resv clash", root.create_reservation(
            "m2", "p1", ["cn001"], 6000.0, 7000.0))
        rec("resv denied", alice.create_reservation(
            "m3", "p1", ["cn003"], 0.0, 10.0))
        for action in ("drain", "resume", "poweroff", "wake", "explode"):
            rec(f"node {action}", root.modify_node("cn005", action))
        rec("node unknown", root.modify_node("nope", "drain"))
        rec("node denied", alice.modify_node("cn005", "drain"))
        total = pb.ResourceSpec(cpu=8.0, mem_bytes=16 << 30,
                                memsw_bytes=16 << 30)
        reg = rec("register", craned.craned_register("cn900", total,
                                                     partitions=["p0"]))
        rec("re-register", craned.craned_register("cn000", total))
        rec("register denied", alice.craned_register("evil", total))
        rec("ping", craned.craned_ping(reg.node_id))
        rec("ping unknown", craned.craned_ping(12345))
        rec("health bad", craned.craned_health(7, False, "disk"))
        rec("cluster drained", root.query_cluster())
        rec("health ok", craned.craned_health(7, True))
        rec("status change", craned.step_status_change(
            running[5], "Failed", 9, 90.0, node_id=-1))
        rec("status denied", alice.step_status_change(
            running[6], "Failed", 9, 90.0))
        for now in (120.0, 900.0, 1800.0):
            rec(f"tick {now}", root.tick(now))
        rec("free", alice.free_allocation(alloc))
        rec("free again", alice.free_allocation(alloc))
        rec("tick 2400", root.tick(2400.0))
        rec("history", root.query_jobs(include_history=True, limit=500))
        rec("summary", root.query_job_summary())
        rec("summary user", root.query_job_summary(user="alice",
                                                   partition="p0"))
        for jid in (1, 300, running[3]):
            rec(f"summary {jid}", root.query_job_summary(job_id=jid))
        rec("events", root.query_events())
        rec("events filtered", root.query_events(severity="warning",
                                                 after_seq=2, limit=5))
        rec("events type", root.query_events(type="node_up"))
        rec("stats", root.query_stats())
        rec("acct off", root.acct_mgr("root", "show"))
        rec("revoke", root.revoke_token("mallory"))
        rec("revoked", mallory.cancel(1))
        rec("revoke denied", alice.revoke_token("root"))
        rec("profile bad", root.capture_profile(cycles=0))
        rec("profile", root.capture_profile(
            cycles=1, dir=str(tmp_path / f"prof-{env.name}")))
        rec("profile busy", root.capture_profile(cycles=1))
    finally:
        for c in clients:
            c.close()
        server.stop()
    return out


def _acct_session(env, tmp_path):
    """The accounting surface with accounts on (``AcctMgr``)."""
    server, sched, auth, addr = _server(env, tmp_path, accounts=True,
                                        nodes=4)
    root = env.client.CtldClient(addr, token=auth.root_token)
    alice = env.client.CtldClient(
        addr, token=root.issue_token("alice").token)
    out = []
    try:
        calls = [
            (root, "add_qos", {"name": "hi", "priority": 9,
                               "preempt": ["lo"]}),
            (root, "add_qos", {"name": "lo", "priority": 1}),
            (root, "add_account", {"name": "phys",
                                   "allowed_qos": ["hi", "lo"],
                                   "default_qos": "lo"}),
            (root, "add_user", {"name": "alice", "account": "phys"}),
            (root, "add_user", {"name": "bob"}),
            (alice, "add_qos", {"name": "mine", "priority": 1}),
            (root, "block_user", {"name": "alice", "account": "phys"}),
            (root, "block_account", {"name": "phys", "blocked": False}),
            (root, "set_admin_level", {"name": "alice",
                                       "level": "operator"}),
            (root, "show", {}),
            (root, "explode", {}),
        ]
        for cli, action, payload in calls:
            out.append((action, cli.acct_mgr("ignored", action, payload)))
        bad = pb.AcctMgrRequest(actor="root", action="add_qos",
                                payload="{not json")
        out.append(("bad payload", root._call("AcctMgr", bad,
                                              pb.AcctMgrReply)))
    finally:
        root.close()
        alice.close()
        server.stop()
    return out


def _abort_code(call):
    try:
        call()
    except grpc.RpcError as exc:
        return pb.OkReply(ok=False, error=f"{exc.code().name}: "
                                          f"{exc.details()}")
    raise AssertionError("the call was not refused")


@pytest.mark.parametrize("session", [_main_session, _acct_session])
def test_replies_match_jax_server(session, tmp_path):
    """The same scripted session against a JAX and a port server gives
    the same replies, byte for byte, apart from the WALL fields."""
    a = session(JAX, tmp_path)
    b = session(PORT, tmp_path)
    assert [label for label, _ in a] == [label for label, _ in b]
    for (label, ra), (_, rb) in zip(a, b):
        if isinstance(ra, list) or isinstance(ra, bool):
            assert ra == rb, label
            continue
        assert _norm(label, ra) == _norm(label, rb), label


def _wal_session(env, tmp_path):
    """A batch submit against a server whose scheduler logs to a WAL:
    (replies, the WAL's bytes, its fsync count)."""
    server, sched, auth, addr = _server(env, tmp_path, nodes=4)
    path = str(tmp_path / f"{env.name}.wal")
    sched.wal = env.wal.WriteAheadLog(path)
    client = env.client.CtldClient(addr, token=auth.root_token)
    try:
        rng = np.random.default_rng(3)
        specs = [_pbspec(i, rng) for i in range(40)]
        specs[7].dependencies.add(job_id=1, type="nonsense")
        reply = client.submit_many(specs)
        fsyncs = sched.wal.fsync_total
        sched.wal.close()
    finally:
        client.close()
        server.stop()
    with open(path, "rb") as fh:
        return reply, fh.read(), fsyncs


def test_batch_submit_logs_the_same_records_in_one_group_a_chunk(tmp_path):
    """SubmitBatchJobs writes the JAX server's WAL records byte for byte,
    and acknowledges the same jobs, with one fsync per 32-spec chunk
    where the JAX server fsyncs each record."""
    ra, wa, fa = _wal_session(JAX, tmp_path)
    rb, wb, fb = _wal_session(PORT, tmp_path)
    assert ra.SerializeToString(deterministic=True) == \
        rb.SerializeToString(deterministic=True)
    assert sum(1 for r in rb.replies if r.job_id) == 39
    assert wa == wb and wb.count(b"\n") == 39
    assert (fa, fb) == (39, 2)


# ---------------- cases of tests/test_rpc_cli.py ----------------


@pytest.fixture()
def ctld():
    meta = MetaContainer()
    for i in range(4):
        meta.add_node(f"cn{i:02d}",
                      meta.layout.encode(cpu=8, mem_bytes=16 << 30,
                                         memsw_bytes=16 << 30,
                                         is_capacity=True))
        meta.craned_up(i)
    sched = JobScheduler(meta, SchedulerConfig(backfill=False),
                         device="cpu")
    sim = SimCluster(sched)
    sim.wire(sched)
    server, port = serve(sched, sim=sim, tick_mode=True)
    client = CtldClient(f"127.0.0.1:{port}")
    yield client, server, sched, port
    client.close()
    server.stop()


def job_spec(cpu=2.0, runtime=30.0, **kw):
    return pb.JobSpec(res=pb.ResourceSpec(cpu=cpu, mem_bytes=1 << 30,
                                          memsw_bytes=1 << 30),
                      sim_runtime=runtime, **kw)


def test_submit_tick_query_lifecycle(ctld):
    client, server, sched, _ = ctld
    reply = client.submit(job_spec(name="hello"))
    assert reply.job_id == 1

    tick = client.tick(0.0)
    assert list(tick.started) == [1]

    jobs = client.query_jobs().jobs
    assert len(jobs) == 1
    assert jobs[0].status == "Running"
    assert jobs[0].node_names[0].startswith("cn")

    client.tick(31.0)
    jobs = client.query_jobs(include_history=True).jobs
    assert jobs[0].status == "Completed"


def test_submit_many_and_filters(ctld):
    client, _, _, _ = ctld
    specs = [job_spec(name=f"j{i}", user="alice" if i % 2 else "bob")
             for i in range(6)]
    replies = client.submit_many(specs).replies
    assert [r.job_id for r in replies] == [1, 2, 3, 4, 5, 6]
    assert len(client.query_jobs(user="alice").jobs) == 3


def test_cancel_hold_suspend_over_wire(ctld):
    client, _, _, _ = ctld
    a = client.submit(job_spec(runtime=100.0)).job_id
    b = client.submit(job_spec(runtime=100.0)).job_id
    assert client.hold(b).ok
    client.tick(0.0)
    assert client.query_jobs(job_ids=[b]).jobs[0].pending_reason == "Held"
    assert client.suspend(a).ok
    assert client.query_jobs(job_ids=[a]).jobs[0].status == "Suspended"
    assert client.resume(a).ok
    assert client.cancel(a).ok
    client.tick(1.0)
    assert client.query_jobs(job_ids=[a],
                             include_history=True).jobs[0].status == \
        "Cancelled"


def test_cluster_info_states(ctld):
    client, _, _, _ = ctld
    client.submit(job_spec(cpu=8.0))
    client.tick(0.0)
    nodes = client.query_cluster().nodes
    assert len(nodes) == 4
    states = {n.name: n.state for n in nodes}
    assert sorted(states.values()) == ["ALLOC", "IDLE", "IDLE", "IDLE"] \
        or "MIXED" in states.values()


def test_reservation_over_wire(ctld):
    client, _, _, _ = ctld
    assert client.create_reservation("maint", "default", ["cn00"],
                                     0.0, 1000.0).ok
    # overlapping second reservation refused
    assert not client.create_reservation("maint2", "default", ["cn00"],
                                         10.0, 20.0).ok
    assert client.delete_reservation("maint").ok


def test_craned_register_and_status_change(ctld):
    client, _, sched, _ = ctld
    reply = client.craned_register(
        "cn99", pb.ResourceSpec(cpu=4.0, mem_bytes=8 << 30,
                                memsw_bytes=8 << 30))
    assert reply.ok
    assert sched.meta.node_by_name("cn99").alive
    assert client.craned_ping(reply.node_id).ok


def test_gang_and_packed_spec_over_wire(ctld):
    client, _, _, _ = ctld
    spec = job_spec(runtime=10.0)
    spec.node_num = 2
    spec.ntasks = 6
    spec.ntasks_per_node_max = 4
    spec.task_res.CopyFrom(pb.ResourceSpec(cpu=1.0))
    jid = client.submit(spec).job_id
    assert jid > 0
    client.tick(0.0)
    info = client.query_jobs(job_ids=[jid]).jobs[0]
    assert info.status == "Running"
    assert len(info.node_names) == 2
    assert sum(info.task_layout) == 6


def test_steps_over_wire(ctld):
    """calloc-style allocation + crun steps over the RPC surface
    (SubmitStep/QueryStepsInfo/CancelStep/FreeAllocation)."""
    client, _, sched, _ = ctld
    jid = client.submit(pb.JobSpec(
        res=pb.ResourceSpec(cpu=4.0, mem_bytes=1 << 30),
        alloc_only=True, time_limit=3600)).job_id
    client.tick(0.0)
    assert client.query_jobs(job_ids=[jid]).jobs[0].status == "Running"

    share = pb.ResourceSpec(cpu=1.0)
    s0 = client.submit_step(jid, pb.StepSpec(
        name="a", res=share, sim_runtime=5.0)).step_id
    s1 = client.submit_step(jid, pb.StepSpec(
        name="b", res=share, sim_runtime=5.0, sim_exit_code=3)).step_id
    assert (s0, s1) == (0, 1)
    steps = client.query_steps(jid).steps
    assert [s.status for s in steps] == ["Running", "Running"]

    client.tick(10.0)
    steps = {s.step_id: s for s in client.query_steps(jid).steps}
    assert steps[s0].status == "Completed" and steps[s0].exit_code == 0
    assert steps[s1].status == "Failed" and steps[s1].exit_code == 3

    s2 = client.submit_step(jid, pb.StepSpec(
        name="c", res=share, sim_runtime=1e6)).step_id
    assert client.cancel_step(jid, s2).ok
    assert client.free_allocation(jid).ok
    jobs = client.query_jobs(job_ids=[jid], include_history=True).jobs
    assert jobs[0].status == "Completed"
    # rejected: no such allocation anymore
    assert client.submit_step(jid, pb.StepSpec(name="late")).step_id == -1


def test_streaming_and_paginated_queries(ctld):
    """QueryJobsStream chunks + keyset pagination (reference streams
    QueryJobsInfo, Crane.proto:1576-1590)."""
    client, server, sched, _ = ctld
    ids = [client.submit(job_spec(name=f"j{i}")).job_id
           for i in range(25)]
    assert len(set(ids)) == 25
    server.QUERY_CHUNK = 10  # force multiple chunks on the wire

    streamed = [j.job_id for j in client.query_jobs_stream()]
    assert streamed == sorted(ids)

    # keyset pagination, unary: limit + truncated flag + cursor
    page1 = client.query_jobs(limit=10)
    assert len(page1.jobs) == 10 and page1.truncated
    page2 = client.query_jobs(limit=10,
                              after_job_id=page1.jobs[-1].job_id)
    assert len(page2.jobs) == 10 and page2.truncated
    page3 = client.query_jobs(limit=10,
                              after_job_id=page2.jobs[-1].job_id)
    assert len(page3.jobs) == 5 and not page3.truncated
    walked = [j.job_id for p in (page1, page2, page3) for j in p.jobs]
    assert walked == sorted(ids)

    # streamed with limit honors the cap
    capped = [j.job_id for j in client.query_jobs_stream(limit=7)]
    assert capped == sorted(ids)[:7]

    # filters still compose with the stream
    only = [j.job_id for j in client.query_jobs_stream(
        job_ids=[ids[3], ids[7]])]
    assert only == sorted([ids[3], ids[7]])


def test_stream_truncated_flag_and_cursor(ctld):
    client, server, sched, _ = ctld
    ids = [client.submit(job_spec()).job_id for i in range(12)]

    res = StreamResult()
    got = [j.job_id for j in client.query_jobs_stream(limit=5,
                                                      result=res)]
    assert got == sorted(ids)[:5] and res.truncated

    # exactly-full final page: no spurious truncation
    res2 = StreamResult()
    got2 = [j.job_id for j in client.query_jobs_stream(
        limit=12, result=res2)]
    assert got2 == sorted(ids) and not res2.truncated

    # cursor walk drains everything
    seen, cursor = [], 0
    while True:
        r = StreamResult()
        page = [j.job_id for j in client.query_jobs_stream(
            limit=5, after_job_id=cursor, result=r)]
        seen += page
        if not r.truncated:
            break
        cursor = page[-1]
    assert seen == sorted(ids)


def test_requeue_rpc(ctld):
    """Operator requeue over the wire (reference RequeueJob,
    Crane.proto:1407)."""
    client, server, sched, port = ctld
    jid = client.submit(job_spec(runtime=100.0)).job_id
    client.tick(0.0)
    assert client.query_jobs().jobs[0].status == "Running"

    assert client.requeue(jid).ok
    job = client.query_jobs().jobs[0]
    assert job.status == "Pending" and job.requeue_count == 1

    # nothing to requeue while pending
    rep = client.requeue(jid)
    assert not rep.ok and "pending" in rep.error
    # unknown job -> refusal naming it
    rep = client.requeue(999)
    assert not rep.ok


def test_job_summary_rpc(ctld):
    """Per-state counts (reference QueryJobSummary, Crane.proto:1588)."""
    client, server, sched, port = ctld
    client.submit(job_spec(runtime=5.0, user="alice"))
    client.submit(job_spec(runtime=100.0, user="bob"))
    held = client.submit(job_spec(runtime=100.0, user="bob")).job_id
    client.hold(held)
    client.tick(0.0)
    client.tick(6.0)

    rep = client.query_job_summary()
    counts = {s.status: s.count for s in rep.states}
    assert rep.total == 3
    assert counts == {"COMPLETED": 1, "RUNNING": 1, "PENDING": 1}
    # filters compose
    assert client.query_job_summary(user="bob").total == 2
    assert client.query_job_summary(user="nobody").total == 0
    # a job's explanation rides along
    doc = json.loads(client.query_job_summary(job_id=held).explain_json)
    assert doc["job_id"] == held and doc["state"] == "PENDING"


# ---------------- refusals ----------------

_REFUSED = [("query_shard_map", (), "A14"),
            ("lease_nodes", ("l", "default", 1), "A14"),
            ("confirm_gang", ("l", "g", pb.JobSpec()), "A14"),
            ("release_lease", ("l",), "A14"),
            ("fetch_usage", (), "A14"),
            ("migrate_partition", ("default", "s2"), "A14"),
            ("ha_status", (), "A13"),
            ("ha_fetch_snapshot", (), "A13"),
            ("ha_fetch_wal", (0,), "A13")]


@pytest.mark.parametrize("method,args,item", _REFUSED,
                         ids=[m for m, _, _ in _REFUSED])
def test_unported_rpcs_abort_naming_their_item(ctld, method, args, item):
    """The RPCs once refused by item answer now: the federation RPCs (in
    since A14) a shard's replies, here of a one-shard federation with a
    usage book (``tests/test_torch_federation.py`` and
    ``test_torch_rebalance.py`` hold them against the JAX package); the
    HA replication RPCs (in since A13) a leader's."""
    client, server, sched, _port = ctld
    if item == "A14":
        from cranesched_tpu_torch.fed.shard import FedShardPlane
        from cranesched_tpu_torch.fed.shardmap import ShardMap, ShardSpec
        from cranesched_tpu_torch.fed.usage import GlobalLimits, UsageBook
        FedShardPlane(sched, "s1")
        sched.global_usage = UsageBook(
            "s1", GlobalLimits(max_submit_jobs_per_user=10))
        server.shard_name = "s1"
        server.shard_map = ShardMap([ShardSpec("s1", ("default",))])
        assert client.submit(job_spec(user="u")).job_id == 1
        reply = getattr(client, method)(*args)
        if method == "query_shard_map":
            assert (reply.shard, reply.error, reply.map_epoch) == \
                ("s1", "", 0)
            assert [(s.name, list(s.partitions)) for s in reply.shards] \
                == [("s1", ["default"])]
        elif method == "lease_nodes":
            assert reply.ok and len(reply.node_names) == 1
            assert reply.node_names[0] in {"cn00", "cn01", "cn02", "cn03"}
            assert sched.fed.leases["l"].partition == "default"
        elif method == "fetch_usage":
            doc = json.loads(reply.payload)
            assert reply.ok and reply.shard == "s1"
            assert doc["user"] == {"u": {"jobs": 0, "submit_jobs": 1}}
        elif method == "migrate_partition":
            assert not reply.ok
            assert reply.error == "bad destination shard 's2'"
        else:
            # no lease "l" is held: the shard refuses by name
            assert not reply.ok and "no such lease" in reply.error
        return
    if item == "A13":
        reply = getattr(client, method)(*args)
        if method == "ha_status":
            assert reply.role == "leader" and reply.leader_address == ""
            assert reply.fencing_epoch == sched.fencing_epoch
        elif method == "ha_fetch_snapshot":
            doc = json.loads(reply.payload)
            assert reply.ok and doc["seq"] == reply.seq == 0
        else:
            # this leader keeps no WAL: nothing to replicate
            assert not reply.ok and "no WAL" in reply.error


def test_real_node_plane_and_standby_refused():
    """The real node plane is in the port: ``dispatcher=`` is accepted,
    a craned's registration opens its push channel and ``stop()`` closes
    the dispatcher.  A standby is still refused (A13)."""
    from cranesched_tpu_torch.rpc.dispatcher import GrpcDispatcher

    meta = MetaContainer()
    sched = JobScheduler(meta, SchedulerConfig(), device="cpu")
    dispatcher = GrpcDispatcher(sched)
    dispatcher.wire(sched)
    server, port = serve(sched, tick_mode=True, dispatcher=dispatcher)
    client = CtldClient(f"127.0.0.1:{port}")
    reply = client._call("CranedRegister", pb.CranedRegisterRequest(
        name="r0", address="127.0.0.1:1", total=pb.ResourceSpec(
            cpu=4.0, mem_bytes=1 << 30, memsw_bytes=1 << 30)),
        pb.CranedRegisterReply)
    assert reply.ok
    node_id = meta.node_by_name("r0").node_id
    assert dispatcher._stubs[node_id].address == "127.0.0.1:1"
    client.close()
    server.stop()
    assert dispatcher._pool._shutdown
    # a standby (A13) serves the read surface and refuses mutations and
    # craned RPCs with FAILED_PRECONDITION, naming its peer
    standby, sport = serve(sched, tick_mode=True, standby=True,
                           peer_address="127.0.0.1:1")
    client = CtldClient(f"127.0.0.1:{sport}")
    try:
        assert client.ha_status().role == "standby"
        assert client.ha_status().leader_address == "127.0.0.1:1"
        for call in (lambda: client.submit(job_spec()),
                     lambda: client._call(
                         "CranedRegister", pb.CranedRegisterRequest(
                             name="r1"), pb.CranedRegisterReply)):
            with pytest.raises(grpc.RpcError) as info:
                call()
            assert info.value.code() == grpc.StatusCode.FAILED_PRECONDITION
            assert "not leader" in info.value.details()
            assert "127.0.0.1:1" in info.value.details()
    finally:
        client.close()
        standby.stop()
    assert sched.fed is None and sched.global_usage is None


# ---------------- cases of tests/test_obs.py:84-303 ----------------


def test_standalone_metrics_http_endpoint():
    reg = MetricsRegistry()
    reg.counter("crane_http_total", "t").inc(7)
    srv = serve_metrics(0, host="127.0.0.1", registry=reg)
    try:
        port = srv.server_address[1]
        txt = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/metrics", timeout=5
        ).read().decode()
        assert "crane_http_total 7" in txt
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(
                f"http://127.0.0.1:{port}/nope", timeout=5)
    finally:
        srv.shutdown()


def _cluster(num_nodes=4, backfill=False):
    meta = MetaContainer()
    for i in range(num_nodes):
        meta.add_node(
            f"cn{i:02d}",
            meta.layout.encode(cpu=16, mem_bytes=32 << 30,
                               memsw_bytes=32 << 30, is_capacity=True),
            partitions=("default",))
        meta.craned_up(i)
    sched = JobScheduler(meta, SchedulerConfig(backfill=backfill),
                         device="cpu")
    cluster = SimCluster(sched)
    cluster.wire(sched)
    return meta, sched, cluster


def _obs_spec(cpu=1.0, runtime=30.0):
    return pb.JobSpec(
        res=pb.ResourceSpec(cpu=cpu, mem_bytes=1 << 30,
                            memsw_bytes=1 << 30),
        time_limit=3600, partition="default", user="alice",
        sim_runtime=runtime)


def test_ctld_metrics_endpoint_and_query_stats():
    """GET /metrics on a live ctld serves Prometheus text with the
    cycle-phase, lock-held, per-backend solve, and per-RPC latency
    series; QueryStats carries the same registry snapshot plus the
    cycle-trace ring."""
    meta, sched, cluster = _cluster()
    server, port = serve(sched, sim=cluster, address="127.0.0.1:0",
                         cycle_interval=0.05, metrics_port=0)
    client = CtldClient(f"127.0.0.1:{port}")
    try:
        for _ in range(3):
            client.submit(_obs_spec())
        assert _wait(lambda: sched.stats["jobs_started_total"] >= 3)
        assert _wait(lambda: len(sched.cycle_trace) > 0)

        txt = urllib.request.urlopen(
            f"http://127.0.0.1:{server.metrics_port}/metrics",
            timeout=5).read().decode()
        for phase in ("prelude", "solve", "commit"):
            assert (f'crane_cycle_phase_seconds_bucket{{phase="{phase}"'
                    in txt), f"missing phase={phase} in:\n{txt[:2000]}"
        assert "crane_lock_held_seconds_bucket" in txt
        assert 'crane_solve_seconds_bucket{backend="' in txt
        assert ('crane_rpc_latency_seconds_bucket'
                '{method="SubmitBatchJob"') in txt
        assert "crane_rpc_requests_total" in txt
        assert "crane_cycles_total" in txt

        doc = json.loads(client.query_stats().json)
        assert doc["metrics"]["crane_cycles_total"]["values"]
        trace = doc["cycle_trace"][-1]
        for field in ("now", "solver", "prelude_ms", "solve_ms",
                      "commit_ms", "total_ms", "lock_held_ms",
                      "candidates", "placed", "queue_depth",
                      "preempted", "backfilled"):
            assert field in trace, f"trace missing {field}: {trace}"
        assert trace["solver"]
        assert doc["watchdog"]["last_cycle_walltime"] > 0
    finally:
        client.close()
        server.stop()


def test_cycle_trace_row_names_device_and_kernel_launches():
    """Each trace row carries the scheduler's device and greedy_place's
    launches inside that cycle (a delta off the wrapper's count), which
    is how a client of the daemon sees that it schedules on the card."""
    from cranesched_tpu_torch.models import gpu_solver

    meta, sched, cluster = _cluster()
    inner = sched._immediate_solve

    def counted(*a, **kw):
        # on CPU tensors the wrapper runs its plain version, uncounted
        gpu_solver.greedy_place.launches += 1
        return inner(*a, **kw)

    sched._immediate_solve = counted
    gpu_solver.greedy_place.launches += 5      # launches before the cycle
    for now in (1.0, 2.0):
        sched.submit(JobSpec(res=ResourceSpec(cpu=1.0, mem_bytes=1 << 30,
                                              memsw_bytes=1 << 30),
                             sim_runtime=30.0), now=now - 0.5)
        assert len(sched.schedule_cycle(now=now)) == 1
        row = sched.cycle_trace.snapshot()[-1]
        assert row["device"] == "cpu" and row["kernel_launches"] == 1


def test_cycle_trace_solve_time_excluded_from_lock_held():
    """The trace attributes a slow solve to solve_ms, not to the
    lock-held phases: the whole point of the lock break."""
    meta, sched, cluster = _cluster()
    inner = sched._immediate_solve

    def slow(*a, **kw):
        time.sleep(0.2)
        return inner(*a, **kw)

    sched._immediate_solve = slow
    sched.submit(JobSpec(res=ResourceSpec(cpu=1.0, mem_bytes=1 << 30,
                                          memsw_bytes=1 << 30),
                         sim_runtime=30.0), now=0.0)
    started = sched.schedule_cycle(now=1.0)
    assert len(started) == 1
    trace = sched.cycle_trace.snapshot()[-1]
    assert trace["solve_ms"] >= 200.0
    assert trace["lock_held_ms"] < 150.0
    assert trace["placed"] == 1
    assert trace["candidates"] == 1


def test_cycle_crash_watchdog_fault_injection():
    """One cycle raises inside the solve closure ->
    crane_cycle_crashes_total increments, the traceback lands in
    stats["last_crash"], and the very NEXT tick schedules jobs normally
    (the cycle thread survives)."""
    meta, sched, cluster = _cluster()
    inner = sched._immediate_solve
    state = {"armed": False, "crashes": 0}

    def maybe_crash(*a, **kw):
        if state["armed"]:
            state["armed"] = False
            state["crashes"] += 1
            raise RuntimeError("injected solver fault")
        return inner(*a, **kw)

    sched._immediate_solve = maybe_crash
    crashes0 = REGISTRY.counter("crane_cycle_crashes_total").value()
    server, port = serve(sched, sim=cluster, address="127.0.0.1:0",
                         cycle_interval=0.05)
    client = CtldClient(f"127.0.0.1:{port}")
    try:
        client.submit(_obs_spec())
        assert _wait(lambda: sched.stats["jobs_started_total"] >= 1)

        # arm the fault, then submit: the next solving cycle dies
        state["armed"] = True
        client.submit(_obs_spec())
        assert _wait(lambda: state["crashes"] == 1)
        assert _wait(lambda: sched.stats.get("cycle_crashes_total", 0)
                     >= 1)
        # the job from the crashed cycle is scheduled by a LATER tick
        assert _wait(lambda: sched.stats["jobs_started_total"] >= 2), \
            "cycle thread died: next tick never scheduled"

        doc = json.loads(client.query_stats().json)
        assert doc["cycle_crashes_total"] >= 1
        assert "injected solver fault" in \
            doc["last_crash"]["traceback"]
        assert doc["watchdog"]["cycle_crashes_total"] >= 1
        assert REGISTRY.counter(
            "crane_cycle_crashes_total").value() >= crashes0 + 1
        events = [e.type for e in client.query_events().events]
        assert "watchdog_crash" in events

        # and the cluster still takes + runs NEW work after the crash
        client.submit(_obs_spec())
        assert _wait(lambda: sched.stats["jobs_started_total"] >= 3)
    finally:
        client.close()
        server.stop()


def test_crash_in_locked_phase_also_survives():
    """A crash in the prelude (under the lock, before any solve) does
    not kill the loop either: the watchdog closes the half-run generator
    and the next tick runs clean."""
    meta, sched, cluster = _cluster()
    inner = sched.process_status_changes
    state = {"armed": True}

    def crash_once():
        if state["armed"]:
            state["armed"] = False
            raise RuntimeError("prelude fault")
        return inner()

    sched.process_status_changes = crash_once
    server, port = serve(sched, sim=cluster, address="127.0.0.1:0",
                         cycle_interval=0.05)
    client = CtldClient(f"127.0.0.1:{port}")
    try:
        assert _wait(lambda: sched.stats.get("cycle_crashes_total", 0)
                     >= 1)
        client.submit(_obs_spec())
        assert _wait(lambda: sched.stats["jobs_started_total"] >= 1)
    finally:
        client.close()
        server.stop()


def test_idle_loop_sleeps_past_the_base_tick_and_wakes_on_submit():
    """``cycle_idle_sleep`` is live: an idle cluster's loop sleeps up to
    it (no cycles run), and a submit's kick wakes it at once."""
    meta = MetaContainer()
    meta.add_node("cn00", meta.layout.encode(
        cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
        is_capacity=True))
    meta.craned_up(0)
    sched = JobScheduler(meta, SchedulerConfig(backfill=False,
                                               cycle_idle_sleep=60.0),
                         device="cpu")
    cluster = SimCluster(sched)
    cluster.wire(sched)
    server, port = serve(sched, sim=cluster, address="127.0.0.1:0",
                         cycle_interval=0.05)
    client = CtldClient(f"127.0.0.1:{port}")
    try:
        # the first no-op cycle arms the fingerprint, then the loop idles
        assert _wait(lambda: sched.can_idle())
        cycles = sched.stats["cycles"] + sched.stats["skipped_cycles"]
        time.sleep(0.5)
        assert (sched.stats["cycles"] + sched.stats["skipped_cycles"]
                == cycles), "an idle loop kept cycling at the base tick"
        client.submit(_obs_spec())
        assert _wait(lambda: sched.stats["jobs_started_total"] >= 1,
                     timeout=5.0)
    finally:
        client.close()
        server.stop()
