"""The port's push dispatcher (``cranesched_tpu_torch/rpc/dispatcher.py``)
against the JAX package's (``cranesched_tpu/rpc/dispatcher.py``).

- The cases of ``tests/test_commit_dispatch.py:218-294``: per-craned
  coalescing, the whole-job rollback of a failed push, the pool's
  default width and the ``DispatchWorkers`` YAML knob, and the dispatch
  phase billed outside the lock-held phases.  Each runs once per
  package and the outcomes are compared.
- The pushes themselves: the same jobs (single-node, a gang, an
  allocation and a step inside it) through both schedulers into
  recording stubs.  Every ``AllocJob`` / ``ExecuteStep`` request and its
  ``crane-trace`` metadata are byte-identical after
  ``SerializeToString()``, with only the wall-clock ``now`` and the
  random gang token masked (both compared by type).
"""

import types

import cranesched_tpu.ctld as jctld
import cranesched_tpu.rpc.dispatcher as jdisp
import cranesched_tpu.utils.config as jconfig
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.rpc.dispatcher as tdisp
import cranesched_tpu_torch.utils.config as tconfig
from cranesched_tpu_torch.rpc import crane_pb2 as pb

JAX = types.SimpleNamespace(ctld=jctld, disp=jdisp, config=jconfig,
                            kw={}, name="jax")
PORT = types.SimpleNamespace(ctld=tctld, disp=tdisp, config=tconfig,
                             kw={"device": "cpu"}, name="port")
BOTH = (JAX, PORT)


def build(S, num_nodes=4, cpu=8, config=None):
    meta = S.ctld.MetaContainer()
    for i in range(num_nodes):
        meta.add_node(f"cn{i:02d}",
                      meta.layout.encode(cpu=cpu, mem_bytes=64 << 30,
                                         memsw_bytes=64 << 30,
                                         is_capacity=True))
        meta.craned_up(i)
    sched = S.ctld.JobScheduler(
        meta, config or S.ctld.SchedulerConfig(priority_type="basic"),
        **S.kw)
    return meta, sched


def spec(S, cpu=1.0, runtime=50.0, **kw):
    return S.ctld.JobSpec(res=S.ctld.ResourceSpec(
        cpu=cpu, mem_bytes=1 << 30, memsw_bytes=1 << 30),
        sim_runtime=runtime, **kw)


class FakeStub:
    def __init__(self, fail=False):
        self.fail = fail
        self.calls = []

    def call(self, name, request, reply_cls=None):
        self.calls.append((name, request.job_id))
        if self.fail and name in ("ExecuteStep", "AllocJob"):
            return pb.OkReply(ok=False, error="node exploded")
        return pb.OkReply(ok=True)

    def close(self):
        pass


class RecordingStub:
    """Advertises ``trace_metadata`` so the dispatcher passes the
    crane-trace context, and keeps every request it was given."""

    trace_metadata = True

    def __init__(self):
        self.calls = []

    def call(self, name, request, reply_cls=None, metadata=()):
        self.calls.append((name, request, tuple(metadata)))
        return pb.OkReply(ok=True)

    def close(self):
        pass


def _drain_pool(disp):
    disp._pool.shutdown(wait=True)


def _coalescing(S):
    meta, sched = build(S, num_nodes=2)
    disp = S.disp.GrpcDispatcher(sched, max_workers=4)
    stubs = {i: FakeStub() for i in range(2)}
    disp._stubs.update(stubs)
    node_batches = []
    orig = disp._push_node_batch
    disp._push_node_batch = lambda entries: (
        node_batches.append([e[1] for e in entries]), orig(entries))
    disp.wire(sched)
    for _ in range(6):
        sched.submit(spec(S, cpu=2.0), now=0.0)
    started = sched.schedule_cycle(now=0.0)
    assert len(started) == 6
    _drain_pool(disp)
    # one pool task per craned, not per job: every batch is homogeneous
    # in node and the batch count equals the distinct nodes used
    used = {n for jid in started for n in sched.job_info(jid).node_ids}
    assert len(node_batches) == len(used)
    for batch in node_batches:
        assert len(set(batch)) == 1
    # every started job got exactly one push on each of its nodes
    pushed = [jid for stub in stubs.values()
              for name, jid in stub.calls if name == "ExecuteStep"]
    assert sorted(pushed) == sorted(started)
    return (sorted(started), sorted(map(sorted, node_batches)),
            {i: stub.calls for i, stub in stubs.items()})


def test_dispatch_batch_coalesces_per_node():
    assert _coalescing(JAX) == _coalescing(PORT)


def _rollback(S):
    meta, sched = build(S, num_nodes=2, cpu=4)
    disp = S.disp.GrpcDispatcher(sched, max_workers=2)
    good, bad = FakeStub(), FakeStub(fail=True)
    disp._stubs.update({0: good, 1: bad})
    disp.wire(sched)
    jid = sched.submit(S.ctld.JobSpec(
        res=S.ctld.ResourceSpec(cpu=4.0, mem_bytes=1 << 30,
                                memsw_bytes=1 << 30),
        node_num=2, sim_runtime=50.0), now=0.0)
    started = sched.schedule_cycle(now=0.0)
    assert started == [jid]
    _drain_pool(disp)
    # the failing node triggered a whole-job rollback: both nodes see
    # the terminate and the job fails through the status-change path
    for stub in (good, bad):
        assert any(name == "TerminateStep" for name, _ in stub.calls)
    sched.process_status_changes()
    job = sched.job_info(jid)
    assert job.status.name == "FAILED"
    return (sorted(good.calls), sorted(bad.calls), job.exit_code,
            job.status.name)


def test_dispatch_batch_failure_rolls_back_whole_job():
    assert _rollback(JAX) == _rollback(PORT)


def test_default_workers_scales_with_cluster():
    for S in BOTH:
        assert S.disp.GrpcDispatcher.default_workers(10) == 8
        assert S.disp.GrpcDispatcher.default_workers(1024) == 16
        assert S.disp.GrpcDispatcher.default_workers(100_000) == 128
    for n in (1, 63, 64, 640, 8191, 8192, 10_000, 10**6):
        assert (tdisp.GrpcDispatcher.default_workers(n)
                == jdisp.GrpcDispatcher.default_workers(n))


def _yaml_knob(S):
    node = S.config.NodeConfig(names=["n0"], cpu=4.0, mem_bytes=1 << 30,
                               partitions=["default"])
    build_kw = {"device": "cpu"} if S is PORT else {}
    meta, sched = S.config.CraneConfig(
        nodes=[node], scheduler={"DispatchWorkers": 5}).build(**build_kw)
    assert sched.config.dispatch_workers == 5
    disp = S.disp.GrpcDispatcher(sched)
    assert disp.max_workers == 5
    disp.close()
    # unset: derived from cluster size
    meta2, sched2 = S.config.CraneConfig(nodes=[node]).build(**build_kw)
    assert sched2.config.dispatch_workers is None
    disp2 = S.disp.GrpcDispatcher(sched2)
    assert disp2.max_workers == 8
    disp2.close()
    return disp.max_workers, disp2.max_workers


def test_dispatch_workers_yaml_knob_threads_through():
    assert _yaml_knob(JAX) == _yaml_knob(PORT)


def test_phase_accounting_splits_commit_and_dispatch():
    import time

    for S in BOTH:
        meta, sched = build(S, num_nodes=2)
        slow = []

        def slow_dispatch(items, slow=slow):
            time.sleep(0.02)
            slow.extend(items)
        sched.dispatch_batch = slow_dispatch
        sched.submit(spec(S, cpu=8.0), now=0.0)
        sched.schedule_cycle(now=0.0)
        trace = sched.cycle_trace.snapshot()[-1]
        assert trace["dispatch_ms"] >= 20.0
        # the slow push is NOT billed to the lock-held phases
        assert abs(trace["lock_held_ms"]
                   - (trace["prelude_ms"] + trace["commit_ms"])) < 0.01
        assert trace["commit_ms"] < trace["dispatch_ms"]
        assert len(slow) == 1


def test_wire_sets_the_same_seams():
    class Seams:
        def __init__(self):
            self.names = []

        def __setattr__(self, name, value):
            if name != "names":
                self.names.append(name)
            object.__setattr__(self, name, value)

    got = {}
    for S in BOTH:
        meta, sched = build(S, num_nodes=1)
        disp = S.disp.GrpcDispatcher(sched, max_workers=1)
        seams = Seams()
        disp.wire(seams)
        got[S.name] = seams.names
        disp.close()
    assert got["port"] == got["jax"] and len(got["port"]) == 9


def _masked(request):
    """The request's bytes with the wall-clock stamp and the random
    gang token cleared (each checked for its type first)."""
    msg = type(request)()
    msg.CopyFrom(request)
    assert isinstance(msg.now, float) and msg.now > 0
    assert isinstance(msg.rendezvous_token, str) and msg.rendezvous_token
    msg.now = 0.0
    msg.rendezvous_token = ""
    return msg.SerializeToString(deterministic=True)


def _pushes(S):
    meta, sched = build(S, num_nodes=4)
    disp = S.disp.GrpcDispatcher(sched, max_workers=4)
    stubs = {i: RecordingStub() for i in range(4)}
    disp._stubs.update(stubs)
    disp.wire(sched)
    ids = [
        sched.submit(spec(S, cpu=2.0, name="single", time_limit=600,
                          script="echo $CRANE_JOB_ID",
                          output_path="/out/%j.txt"), now=0.0),
        sched.submit(spec(S, cpu=8.0, name="gang", node_num=2,
                          script="hostname"), now=0.0),
        sched.submit(spec(S, cpu=4.0, name="alloc", alloc_only=True,
                          time_limit=300), now=0.0),
    ]
    started = sched.schedule_cycle(now=1.0)
    assert sorted(started) == sorted(ids)
    step_id = sched.submit_step(ids[2], S.ctld.StepSpec(
        name="s", res=S.ctld.ResourceSpec(cpu=1.0),
        script="echo step"), now=2.0)
    assert step_id == 0
    _drain_pool(disp)
    out = {}
    for node, stub in stubs.items():
        out[node] = sorted(
            (name, req.job_id, req.step_id, _masked(req), md)
            for name, req, md in stub.calls)
    verbs = sorted(c[0] for calls in out.values() for c in calls)
    assert verbs == ["AllocJob", "ExecuteStep", "ExecuteStep",
                     "ExecuteStep", "ExecuteStep"]
    gang = [c for calls in out.values() for c in calls
            if c[1] == ids[1]]
    assert len(gang) == 2
    return out, [sched.job_info(j).node_ids for j in ids]


def test_pushes_are_byte_identical_to_the_jax_dispatcher():
    jax_out, jax_nodes = _pushes(JAX)
    port_out, port_nodes = _pushes(PORT)
    assert port_nodes == jax_nodes
    assert port_out == jax_out
