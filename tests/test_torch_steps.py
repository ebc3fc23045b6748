"""Steps inside an allocation in the port's scheduler against the JAX
scheduler: the cases of ``tests/test_steps.py``.  A batch job carries an
implicit step 0; an ``alloc_only`` job holds its allocation while steps
are submitted, packed into its capacity and ended one by one, and its
time limit is enforced by the scheduler.  Each scenario runs once per
package (the JAX side with ``solver="device"``, the port's on the CPU),
makes the original test's assertions on both and returns every job's
record with its steps; the two records must be equal."""

import types

import numpy as np
import pytest

import cranesched_tpu.craned.sim as jsim
import cranesched_tpu.ctld as jctld
import cranesched_tpu.ctld.wal as jwal
import cranesched_tpu_torch.craned.sim as tsim
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.ctld.wal as twal

JAX = types.SimpleNamespace(ctld=jctld, sim=jsim, wal=jwal, name="jax")
PORT = types.SimpleNamespace(ctld=tctld, sim=tsim, wal=twal, name="port")


def _make(env, num_nodes=2, cpu=8.0, wal=None):
    ctld = env.ctld
    meta = ctld.MetaContainer()
    for i in range(num_nodes):
        meta.add_node(f"n{i}", meta.layout.encode(
            cpu=cpu, mem_bytes=32 << 30, memsw_bytes=32 << 30,
            is_capacity=True))
        meta.craned_up(i)
    cfg, kw = dict(backfill=False), {}
    if env is JAX:
        cfg["solver"] = "device"
    else:
        kw["device"] = "cpu"
    sched = ctld.JobScheduler(meta, ctld.SchedulerConfig(**cfg), wal=wal,
                              **kw)
    sim = env.sim.SimCluster(sched)
    sim.wire(sched)
    return meta, sched, sim


def _res(env, **kw):
    return env.ctld.ResourceSpec(**kw)


def _start_alloc(env, sched, now=0.0):
    jid = sched.submit(env.ctld.JobSpec(
        res=_res(env, cpu=4.0, mem_bytes=4 << 30), alloc_only=True,
        time_limit=3600), now=now)
    assert sched.schedule_cycle(now=now + 1.0) == [jid]
    return jid


def _job(job):
    return (job.job_id, job.status.name, tuple(job.node_ids),
            job.exit_code, job.end_time, job.next_step_id,
            tuple((s.step_id, s.spec.name, s.status.name, s.exit_code,
                   tuple(s.node_ids), s.start_time, s.end_time,
                   s.cancel_requested) for s in job.steps.values()))


def _record(sched):
    avail = sched.meta.snapshot()[0]
    return [[_job(j) for j in sched.pending.values()],
            [_job(j) for j in sched.running.values()],
            sorted(_job(j) for j in sched.history.values()),
            np.asarray(avail).tolist()]


def _implicit_step0(env, d):
    _, sched, sim = _make(env)
    SS = env.ctld.StepStatus
    jid = sched.submit(env.ctld.JobSpec(res=_res(env, cpu=2.0),
                                        sim_runtime=30.0,
                                        script="echo hi"), now=0.0)
    sched.schedule_cycle(now=1.0)
    job = sched.running[jid]
    assert list(job.steps) == [0] and job.steps[0].status == SS.RUNNING
    assert job.steps[0].spec.script == "echo hi"
    sim.advance_to(40.0)
    sched.schedule_cycle(now=41.0)
    job = sched.job_info(jid)
    assert job.status == env.ctld.JobStatus.COMPLETED
    assert job.steps[0].status == SS.COMPLETED and job.steps[0].exit_code == 0
    return _record(sched)


def _three_steps(env, d):
    _, sched, sim = _make(env)
    SS, StepSpec = env.ctld.StepStatus, env.ctld.StepSpec
    jid = _start_alloc(env, sched)
    ids = [sched.submit_step(jid, StepSpec(name=n, sim_runtime=5.0,
                                           sim_exit_code=c), now=2.0)
           for n, c in (("a", 0), ("b", 7), ("c", 0))]
    assert ids == [0, 1, 2]
    job = sched.running[jid]
    assert [job.steps[s].status for s in ids] == [
        SS.RUNNING, SS.PENDING, SS.PENDING]
    t = 3.0
    for _ in range(10):
        sim.advance_to(t)
        sched.schedule_cycle(now=t)
        t += 5.0
        if all(job.steps[s].status.is_terminal for s in ids):
            break
    assert [(job.steps[s].status, job.steps[s].exit_code)
            for s in ids] == [(SS.COMPLETED, 0), (SS.FAILED, 7),
                              (SS.COMPLETED, 0)]
    assert jid in sched.running
    assert sched.free_allocation(jid, now=t)
    assert sched.job_info(jid).status == env.ctld.JobStatus.COMPLETED
    return [t, _record(sched)]


def _sized_steps_pack(env, d):
    _, sched, sim = _make(env, num_nodes=1)
    SS, StepSpec = env.ctld.StepStatus, env.ctld.StepSpec
    jid = _start_alloc(env, sched)
    small = _res(env, cpu=2.0, mem_bytes=1 << 30)
    ids = [sched.submit_step(jid, StepSpec(res=small, sim_runtime=50.0),
                             now=2.0) for _ in range(3)]
    job = sched.running[jid]
    assert [job.steps[s].status for s in ids] == [
        SS.RUNNING, SS.RUNNING, SS.PENDING]
    assert sched.submit_step(jid, StepSpec(res=_res(env, cpu=8.0)),
                             now=3.0) == -1
    sim.advance_to(60.0)
    sched.schedule_cycle(now=61.0)
    assert job.steps[ids[2]].status == SS.RUNNING
    return _record(sched)


def _cancel_single_step(env, d):
    _, sched, _ = _make(env)
    SS, StepSpec = env.ctld.StepStatus, env.ctld.StepSpec
    jid = _start_alloc(env, sched)
    small = _res(env, cpu=1.0)
    s0 = sched.submit_step(jid, StepSpec(res=small, sim_runtime=500.0),
                           now=2.0)
    s1 = sched.submit_step(jid, StepSpec(res=small, sim_runtime=500.0),
                           now=2.0)
    s2 = sched.submit_step(jid, StepSpec(sim_runtime=500.0), now=2.0)
    assert sched.cancel_step(jid, s0, now=3.0)
    assert sched.cancel_step(jid, s2, now=3.0)     # still pending
    assert not sched.cancel_step(jid, s2, now=3.5)
    job = sched.running[jid]
    assert job.steps[s0].status == SS.CANCELLED
    assert job.steps[s1].status == SS.RUNNING
    assert job.steps[s2].status == SS.CANCELLED
    return _record(sched)


def _alloc_time_limit(env, d):
    meta, sched, _ = _make(env)
    jid = sched.submit(env.ctld.JobSpec(res=_res(env, cpu=4.0),
                                        alloc_only=True, time_limit=100),
                       now=0.0)
    sched.schedule_cycle(now=1.0)
    assert sched.next_wake_time(2.0) == 101.0
    sched.submit_step(jid, env.ctld.StepSpec(sim_runtime=1e9), now=2.0)
    sched.schedule_cycle(now=50.0)
    assert jid in sched.running
    sched.schedule_cycle(now=102.0)
    job = sched.job_info(jid)
    assert job.status == env.ctld.JobStatus.EXCEED_TIME_LIMIT
    assert all(s.status.is_terminal for s in job.steps.values())
    assert all((n.avail == n.total).all() for n in meta.nodes.values())
    return _record(sched)


def _cancel_alloc_job(env, d):
    meta, sched, _ = _make(env)
    jid = _start_alloc(env, sched)
    sched.submit_step(jid, env.ctld.StepSpec(sim_runtime=1e9), now=2.0)
    assert sched.cancel(jid, now=3.0)
    job = sched.job_info(jid)
    assert job.status == env.ctld.JobStatus.CANCELLED
    assert all(s.status.is_terminal for s in job.steps.values())
    assert all((n.avail == n.total).all() for n in meta.nodes.values())
    return _record(sched)


def _steps_wal_recovered(env, d):
    path = str(d / "wal.jsonl")
    wal = env.wal.WriteAheadLog(path, fsync=False)
    _, sched, sim = _make(env, wal=wal)
    SS, StepSpec = env.ctld.StepStatus, env.ctld.StepSpec
    jid = _start_alloc(env, sched)
    s0 = sched.submit_step(jid, StepSpec(name="done", sim_runtime=2.0,
                                         sim_exit_code=5), now=2.0)
    sim.advance_to(10.0)
    sched.schedule_cycle(now=11.0)
    s1 = sched.submit_step(jid, StepSpec(name="live", sim_runtime=1e9),
                           now=12.0)
    assert sched.running[jid].steps[s0].status == SS.FAILED
    wal.close()
    _, sched2, _ = _make(env)
    sched2.recover(env.wal.WriteAheadLog.replay(path), now=20.0)
    job2 = sched2.running[jid]
    assert job2.spec.alloc_only and job2.next_step_id == 2
    assert job2.steps[s0].status == SS.FAILED
    assert job2.steps[s0].exit_code == 5
    assert job2.steps[s1].status == SS.RUNNING
    assert sched2.submit_step(jid, StepSpec(sim_runtime=1.0),
                              now=21.0) == 2
    return _record(sched2)


def _step_ids_reset_on_requeue(env, d):
    _, sched, _ = _make(env, num_nodes=3)
    kills = []
    sched.dispatch = lambda job, nodes: None
    sched.dispatch_terminate = lambda jid, now, **kw: kills.append(jid)
    jid = sched.submit(env.ctld.JobSpec(res=_res(env, cpu=2.0),
                                        node_num=2, sim_runtime=1e9),
                       now=0.0)
    sched.schedule_cycle(now=1.0)
    assert list(sched.running[jid].steps) == [0]
    sched.on_craned_down(sched.running[jid].node_ids[0], now=5.0)
    job = sched.pending[jid]
    assert job.steps == {} and job.next_step_id == 0
    sched.schedule_cycle(now=6.0)
    assert list(sched.running[jid].steps) == [0]
    return [kills, _record(sched)]


def _per_node_step_reports(env, d):
    """Per-node step reports aggregate like jobs: the first failure
    kills the step's other nodes and wins; usage folds once per node."""
    _, sched, _ = _make(env)
    SS, StepSpec = env.ctld.StepStatus, env.ctld.StepSpec
    killed = []
    sched.dispatch_terminate_step = \
        lambda jid, sid, now: killed.append((jid, sid))
    jid = sched.submit(env.ctld.JobSpec(
        res=_res(env, cpu=4.0, mem_bytes=4 << 30), alloc_only=True,
        node_num=2, time_limit=3600), now=0.0)
    sched.schedule_cycle(now=1.0)
    s0 = sched.submit_step(jid, StepSpec(sim_runtime=1e9), now=2.0)
    nodes = sched.running[jid].steps[s0].node_ids
    sched.step_report(jid, s0, SS.FAILED, 9, 3.0, node_id=nodes[0],
                      cpu_seconds=5.0, max_rss_bytes=100)
    sched.step_report(jid, s0, SS.FAILED, 9, 3.1, node_id=nodes[0],
                      cpu_seconds=5.0, max_rss_bytes=100)
    sched.step_report(jid, s0, SS.CANCELLED, 130, 3.5, node_id=nodes[1],
                      cpu_seconds=1.0, max_rss_bytes=300)
    step = sched.running[jid].steps[s0]
    assert (step.status, step.exit_code) == (SS.FAILED, 9)
    assert killed == [(jid, s0)]
    job = sched.running[jid]
    assert (job.cpu_seconds, job.max_rss_bytes) == (6.0, 300)
    return [killed, job.cpu_seconds, _record(sched)]


def _step_reports_async(env, d):
    """Step reports from transport threads queue up and are applied by
    the next status drain; a report for step 0 of a batch job closes
    the job."""
    _, sched, _ = _make(env)
    sched.dispatch = lambda job, nodes: None
    jid = sched.submit(env.ctld.JobSpec(res=_res(env, cpu=2.0),
                                        sim_runtime=1e9), now=0.0)
    sched.schedule_cycle(now=1.0)
    sched.step_report_async(jid, 0, env.ctld.StepStatus.COMPLETED, 0, 2.0)
    assert not sched.can_idle()
    assert jid in sched.running
    sched.schedule_cycle(now=3.0)
    assert sched.job_info(jid).status == env.ctld.JobStatus.COMPLETED
    return _record(sched)


_CASES = {
    "implicit_step0": _implicit_step0,
    "three_steps_own_exit_status": _three_steps,
    "sized_steps_pack": _sized_steps_pack,
    "cancel_single_step": _cancel_single_step,
    "alloc_time_limit": _alloc_time_limit,
    "cancel_alloc_job": _cancel_alloc_job,
    "steps_wal_recovered": _steps_wal_recovered,
    "step_ids_reset_on_requeue": _step_ids_reset_on_requeue,
    "per_node_step_reports": _per_node_step_reports,
    "step_reports_async": _step_reports_async,
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_steps_match_jax(case, tmp_path):
    fn = _CASES[case]
    out = []
    for env in (JAX, PORT):
        d = tmp_path / env.name
        d.mkdir()
        out.append(fn(env, d))
    assert out[0] == out[1]
