"""The job lifecycle in the port's scheduler against the JAX scheduler:
the scheduler cases of ``tests/test_capabilities.py`` (dependencies,
arrays, reservations, suspend/resume), ``tests/test_ctld_e2e.py`` (hold,
begin time, requeue-then-held, node death, stale completions),
``tests/test_modify_job.py`` (those without a real node plane or RPC),
``tests/test_terminate_guards.py`` and the begin/dependency re-arm cases
of ``tests/test_delta_cycle.py``, plus submit hooks.

Each scenario runs once per package on the same inputs (the JAX side
with ``solver="device"``, the port's on the CPU), makes the original
test's assertions on both, and returns what a user sees: the started
lists and a record of every job (status, reason, nodes, hold, requeue
count, dependency edges, array bookkeeping, steps) with the ledger's
availability.  The two records must be equal."""

import types

import numpy as np
import pytest

import cranesched_tpu.craned.sim as jsim
import cranesched_tpu.ctld as jctld
import cranesched_tpu.ctld.accounting as jacct
import cranesched_tpu.ctld.defs as jdefs
import cranesched_tpu.ctld.wal as jwal
import cranesched_tpu_torch.craned.sim as tsim
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.ctld.accounting as tacct
import cranesched_tpu_torch.ctld.defs as tdefs
import cranesched_tpu_torch.ctld.wal as twal

JAX = types.SimpleNamespace(ctld=jctld, defs=jdefs, sim=jsim, wal=jwal,
                            acct=jacct, name="jax")
PORT = types.SimpleNamespace(ctld=tctld, defs=tdefs, sim=tsim, wal=twal,
                             acct=tacct, name="port")


def _cluster(env, num_nodes=4, cpu=8, config=None, partitions=None,
             **kw):
    ctld = env.ctld
    meta = ctld.MetaContainer()
    for i in range(num_nodes):
        extra = ({} if partitions is None
                 else dict(partitions=(partitions[i % len(partitions)],)))
        meta.add_node(f"cn{i:02d}", meta.layout.encode(
            cpu=cpu, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True), **extra)
        meta.craned_up(i)
    cfg = dict(backfill=False) if config is None else dict(config)
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


def _job(job):
    steps = tuple((s.step_id, s.status.name, s.exit_code,
                   tuple(s.node_ids), s.start_time, s.end_time,
                   s.cancel_requested) for s in job.steps.values())
    return (job.job_id, job.status.name, job.pending_reason.name,
            tuple(job.node_ids), job.held, job.requeue_count,
            job.cancel_requested, job.start_time, job.end_time,
            job.exit_code, tuple(sorted(job.dep_state.items())),
            tuple(job.array_remaining), tuple(job.array_children),
            job.array_parent_id, job.array_task_id, job.suspend_time,
            job.suspended_total, job.qos_priority, job.spec.time_limit,
            job.spec.partition, job.spec.name, job.next_step_id, steps)


def _record(sched):
    """Every job the scheduler knows and the ledger's availability."""
    avail, _total, alive = sched.meta.snapshot()
    return {
        "pending": [_job(j) for j in sched.pending.values()],
        "running": [_job(j) for j in sched.running.values()],
        "history": sorted(_job(j) for j in sched.history.values()),
        "avail": np.asarray(avail).tolist(),
        "alive": np.asarray(alive).tolist(),
    }


def _dep(env, job_id, kind, delay=0.0):
    return env.defs.Dependency(job_id, env.defs.DepType[kind],
                               delay_seconds=delay)


# ---------------- dependencies ----------------

def _afterok_waits(env):
    _, sched, sim = _cluster(env)
    Reason = env.ctld.PendingReason
    a = sched.submit(_spec(env, runtime=10.0), now=0.0)
    b = sched.submit(_spec(env, dependencies=(_dep(env, a, "AFTER_OK"),)),
                     now=0.0)
    out = [sched.schedule_cycle(now=0.0)]
    assert out[-1] == [a]
    assert sched.job_info(b).pending_reason == Reason.DEPENDENCY
    sim.advance_to(11.0)
    out.append(sched.schedule_cycle(now=11.0))
    assert out[-1] == [b]
    return out + [_record(sched)]


def _afterok_never(env):
    _, sched, sim = _cluster(env)
    a = sched.submit(_spec(env, runtime=5.0, sim_exit_code=1), now=0.0)
    b = sched.submit(_spec(env, dependencies=(_dep(env, a, "AFTER_OK"),)),
                     now=0.0)
    sched.schedule_cycle(now=0.0)
    sim.advance_to(6.0)
    sched.schedule_cycle(now=6.0)
    assert sched.job_info(a).status == env.ctld.JobStatus.FAILED
    sched.schedule_cycle(now=7.0)
    assert sched.job_info(b).pending_reason == \
        env.ctld.PendingReason.DEPENDENCY_NEVER_SATISFIED
    return [_record(sched)]


def _afternotok(env):
    _, sched, sim = _cluster(env)
    a = sched.submit(_spec(env, runtime=5.0, sim_exit_code=1), now=0.0)
    cleanup = sched.submit(_spec(
        env, runtime=5.0, dependencies=(_dep(env, a, "AFTER_NOT_OK"),)),
        now=0.0)
    sched.schedule_cycle(now=0.0)
    sim.advance_to(6.0)
    out = [sched.schedule_cycle(now=6.0)]
    assert out[-1] == [cleanup]
    return out + [_record(sched)]


def _after_delay(env):
    _, sched, sim = _cluster(env)
    a = sched.submit(_spec(env, runtime=100.0), now=0.0)
    b = sched.submit(_spec(
        env, dependencies=(_dep(env, a, "AFTER", 30.0),)), now=0.0)
    out = [sched.schedule_cycle(now=0.0), sched.schedule_cycle(now=10.0)]
    assert out == [[a], []]
    assert sched.job_info(b).pending_reason == \
        env.ctld.PendingReason.DEPENDENCY
    out.append(sched.schedule_cycle(now=31.0))
    assert out[-1] == [b]
    return out + [_record(sched)]


def _or_deps(env):
    _, sched, sim = _cluster(env)
    a = sched.submit(_spec(env, runtime=5.0, sim_exit_code=1), now=0.0)
    b = sched.submit(_spec(env, runtime=200.0), now=0.0)
    c = sched.submit(_spec(env, dependencies=(
        _dep(env, a, "AFTER_OK"), _dep(env, b, "AFTER")),
        deps_is_or=True), now=0.0)
    out = [sched.schedule_cycle(now=0.0)]
    assert set(out[-1]) == {a, b}
    out.append(sched.schedule_cycle(now=1.0))
    assert out[-1] == [c]
    return out + [_record(sched)]


def _unknown_dep(env):
    _, sched, _ = _cluster(env)
    b = sched.submit(_spec(
        env, dependencies=(_dep(env, 9999, "AFTER_ANY"),)), now=0.0)
    sched.schedule_cycle(now=1.0)
    assert sched.job_info(b).pending_reason == \
        env.ctld.PendingReason.DEPENDENCY_NEVER_SATISFIED
    return [_record(sched)]


def _finished_dep(env):
    _, sched, sim = _cluster(env)
    a = sched.submit(_spec(env, runtime=1.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    sim.advance_to(2.0)
    sched.schedule_cycle(now=2.0)
    assert sched.job_info(a).status == env.ctld.JobStatus.COMPLETED
    b = sched.submit(_spec(env, dependencies=(_dep(env, a, "AFTER_OK"),)),
                     now=3.0)
    out = [sched.schedule_cycle(now=3.0)]
    assert out[-1] == [b]
    return out + [_record(sched)]


def _dep_chain_drains(env):
    """A chain a -> b -> c of afterany edges with delays drains in order
    (the simulated plane jumps to each dependency delay)."""
    _, sched, sim = _cluster(env)
    a = sched.submit(_spec(env, runtime=5.0), now=0.0)
    b = sched.submit(_spec(env, runtime=5.0, dependencies=(
        _dep(env, a, "AFTER_ANY", 20.0),)), now=0.0)
    c = sched.submit(_spec(env, runtime=5.0, dependencies=(
        _dep(env, b, "AFTER_ANY", 7.0),)), now=0.0)
    end = sim.run_until_drained(start=0.0, max_cycles=200)
    starts = [sched.job_info(j).start_time for j in (a, b, c)]
    assert starts[1] >= starts[0] + 25.0 and starts[2] >= starts[1] + 12.0
    return [end, starts, _record(sched)]


# ---------------- job arrays ----------------

def _cancelled_child_finalizes_parent(env):
    _, sched, sim = _cluster(env, num_nodes=1, cpu=1)
    parent = sched.submit(_spec(env, runtime=5.0, array=env.defs.ArraySpec(
        start=0, end=1)), now=0.0)
    sched.schedule_cycle(now=0.0)
    sim.advance_to(6.0)
    sched.schedule_cycle(now=6.0)
    sched.schedule_cycle(now=7.0)
    children = [j for j in list(sched.pending.values())
                + list(sched.running.values())
                if j.array_parent_id == parent]
    for c in children:
        sched.cancel(c.job_id, now=8.0)
    sched.schedule_cycle(now=9.0)
    assert sched.job_info(parent).status.is_terminal
    return [_record(sched)]


def _array_one_child_per_cycle(env):
    _, sched, _ = _cluster(env, num_nodes=8)
    parent = sched.submit(_spec(env, runtime=100.0,
                                array=env.defs.ArraySpec(start=0, end=3)),
                          now=0.0)
    out = [sched.schedule_cycle(now=0.0)]
    assert len(out[-1]) == 1
    child = sched.job_info(out[-1][0])
    assert child.array_parent_id == parent and child.array_task_id == 0
    assert child.spec.name.endswith("_0")
    for cyc in range(1, 4):
        out.append(sched.schedule_cycle(now=float(cyc)))
        assert len(out[-1]) == 1
    out.append(sched.schedule_cycle(now=5.0))
    assert out[-1] == []
    return out + [_record(sched)]


def _array_run_limit(env):
    _, sched, sim = _cluster(env, num_nodes=8)
    sched.submit(_spec(env, runtime=50.0, array=env.defs.ArraySpec(
        start=0, end=5, max_concurrent=2)), now=0.0)
    for cyc in range(6):
        sched.schedule_cycle(now=float(cyc))
    assert len(sched.running) == 2
    end = sim.run_until_drained(start=6.0, max_cycles=5000)
    children = [j for j in sched.history.values()
                if j.array_task_id is not None]
    assert len(children) == 6
    assert all(j.status == env.ctld.JobStatus.COMPLETED for j in children)
    return [end, _record(sched)]


def _array_parent_completes(env):
    _, sched, sim = _cluster(env, num_nodes=8)
    parent = sched.submit(_spec(env, runtime=10.0, array=env.defs.ArraySpec(
        start=1, end=2)), now=0.0)
    end = sim.run_until_drained(start=0.0, max_cycles=1000)
    p = sched.job_info(parent)
    assert p.status == env.ctld.JobStatus.COMPLETED
    assert len(p.array_children) == 2
    return [end, _record(sched)]


def _array_cancel(env):
    _, sched, _ = _cluster(env, num_nodes=2, cpu=2)
    parent = sched.submit(_spec(env, cpu=2.0, runtime=100.0,
                                array=env.defs.ArraySpec(start=0, end=9)),
                          now=0.0)
    sched.schedule_cycle(now=0.0)
    sched.schedule_cycle(now=1.0)
    running = list(sched.running)
    sched.cancel(parent, now=2.0)
    sched.schedule_cycle(now=3.0)
    assert sched.job_info(parent).status == env.ctld.JobStatus.CANCELLED
    for c in running:
        assert sched.job_info(c).status == env.ctld.JobStatus.CANCELLED
    assert not sched.pending and not sched.running
    return [running, _record(sched)]


# ---------------- reservations ----------------

def _resv_excludes_outside(env):
    meta, sched, _ = _cluster(env)
    assert meta.create_reservation("maint", "default", ["cn00", "cn01"],
                                   start_time=0.0, end_time=1000.0)
    j = sched.submit(_spec(env, cpu=8.0, time_limit=500), now=0.0)
    sched.schedule_cycle(now=0.0)
    assert sched.job_info(j).node_ids[0] >= 2
    r = sched.submit(_spec(env, cpu=8.0, reservation="maint",
                           time_limit=500, runtime=10.0), now=1.0)
    sched.schedule_cycle(now=1.0)
    assert sched.job_info(r).node_ids[0] < 2
    return [_record(sched)]


def _resv_acl(env):
    meta, sched, _ = _cluster(env, num_nodes=2)
    meta.create_reservation("vip", "default", ["cn00"], 0.0, 1000.0,
                            allowed_accounts=["special"])
    out = [sched.submit(_spec(env, reservation="vip"), now=0.0),
           sched.submit(_spec(env, account="special", reservation="vip"),
                        now=0.0)]
    meta.reservations["vip"].denied_accounts.add("special")
    out.append(sched.submit(_spec(env, account="special",
                                  reservation="vip"), now=1.0))
    out.append(sched.submit(_spec(env, reservation="nope"), now=1.0))
    assert out[0] == 0 and out[1] > 0 and out[2] == 0 and out[3] == 0
    return out + [_record(sched)]


def _resv_expiry(env):
    meta, sched, _ = _cluster(env, num_nodes=1)
    meta.create_reservation("soon", "default", ["cn00"], 0.0, 100.0)
    j = sched.submit(_spec(env, cpu=8.0, time_limit=500, runtime=10.0),
                     now=0.0)
    out = [sched.schedule_cycle(now=0.0), sched.schedule_cycle(now=100.0)]
    assert out == [[], [j]]
    assert "soon" not in meta.reservations
    return out + [_record(sched)]


def _resv_future_window(env):
    meta, sched, _ = _cluster(env, num_nodes=1)
    meta.create_reservation("later", "default", ["cn00"], 1000.0, 2000.0)
    short = sched.submit(_spec(env, cpu=8.0, time_limit=500, runtime=10.0),
                         now=0.0)
    lng = sched.submit(_spec(env, cpu=8.0, time_limit=1500, runtime=10.0),
                       now=0.0)
    out = [sched.schedule_cycle(now=0.0)]
    assert short in out[-1] and lng not in out[-1]
    return out + [_record(sched)]


def _resv_job_waits_for_window(env, config=None):
    """A job naming a reservation places nowhere before its window opens
    and only inside the carve-out once it is active; other jobs keep
    off the carve-out meanwhile."""
    meta, sched, sim = _cluster(env, num_nodes=6, config=config)
    meta.create_reservation("w", "default", ["cn01", "cn03"], 50.0, 500.0)
    r = [sched.submit(_spec(env, cpu=4.0, reservation="w",
                            time_limit=100, runtime=30.0), now=0.0)
         for _ in range(5)]
    o = [sched.submit(_spec(env, cpu=8.0, time_limit=1000,
                            runtime=60.0), now=0.0) for _ in range(5)]
    out = [sched.schedule_cycle(now=1.0)]
    assert not set(out[-1]) & set(r)
    sim.advance_to(60.0)
    out.append(sched.schedule_cycle(now=60.0))
    placed = [sched.job_info(j) for j in r
              if sched.job_info(j).node_ids]
    assert placed and all(n in (1, 3) for j in placed for n in j.node_ids)
    assert all(n not in (1, 3) for j in o
               for n in sched.job_info(j).node_ids)
    return out + [_record(sched)]


def _resv_job_waits_backfill(env):
    return _resv_job_waits_for_window(env, config=dict(backfill=True))


# ---------------- suspend / resume ----------------

def _suspend_credits_time(env):
    _, sched, sim = _cluster(env)
    JS = env.ctld.JobStatus
    j = sched.submit(_spec(env, runtime=100.0, time_limit=3600), now=0.0)
    sched.schedule_cycle(now=0.0)
    assert sched.suspend(j, now=10.0)
    sim.advance_to(150.0)
    sched.schedule_cycle(now=150.0)
    assert sched.job_info(j).status == JS.SUSPENDED
    assert sched.resume(j, now=200.0)
    assert sched.job_info(j).suspended_total == 190.0
    sim.advance_to(291.0)
    sched.schedule_cycle(now=291.0)
    assert sched.job_info(j).status == JS.COMPLETED
    assert sched.job_info(j).end_time == 290.0
    return [_record(sched)]


def _suspend_keeps_resources(env):
    _, sched, sim = _cluster(env, num_nodes=1, cpu=4)
    a = sched.submit(_spec(env, cpu=4.0, runtime=100.0), now=0.0)
    b = sched.submit(_spec(env, cpu=4.0, runtime=10.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    sched.suspend(a, now=1.0)
    out = [sched.schedule_cycle(now=2.0)]
    assert out[-1] == []
    sched.resume(a, now=3.0)
    out.append(sim.run_until_drained(start=4.0, max_cycles=1000))
    assert sched.job_info(b).status == env.ctld.JobStatus.COMPLETED
    return out + [_record(sched)]


# ---------------- hold / begin / requeue / node death ----------------

def _hold_release(env):
    _, sched, _ = _cluster(env, config={})
    jid = sched.submit(_spec(env, held=True, runtime=5.0), now=0.0)
    sched.schedule_cycle(now=1.0)
    assert sched.job_info(jid).pending_reason == \
        env.ctld.PendingReason.HELD
    sched.hold(jid, False, now=2.0)
    out = [sched.schedule_cycle(now=3.0)]
    assert out[-1] == [jid]
    return out + [_record(sched)]


def _begin_time_gates(env):
    _, sched, _ = _cluster(env, config={})
    jid = sched.submit(_spec(env, begin_time=100.0, runtime=5.0), now=0.0)
    out = [sched.schedule_cycle(now=1.0)]
    assert sched.job_info(jid).pending_reason == \
        env.ctld.PendingReason.BEGIN_TIME
    out.append(sched.schedule_cycle(now=100.0))
    assert out == [[], [jid]]
    return out + [_record(sched)]


def _cancel_pending_and_running(env):
    meta, sched, _ = _cluster(env, config={})
    JS = env.ctld.JobStatus
    j1 = sched.submit(_spec(env, runtime=100.0), now=0.0)
    j2 = sched.submit(_spec(env, runtime=100.0), now=0.0)
    assert sched.cancel(j1, now=0.5)
    sched.schedule_cycle(now=1.0)
    assert sched.job_info(j2).status == JS.RUNNING
    assert sched.cancel(j2, now=2.0)
    sched.schedule_cycle(now=3.0)
    assert sched.job_info(j2).status == JS.CANCELLED
    assert all((n.avail == n.total).all() for n in meta.nodes.values())
    return [_record(sched)]


def _cancel_beats_node_death(env):
    _, sched, sim = _cluster(env, num_nodes=2, cpu=4, config={})
    jid = sched.submit(_spec(env, cpu=4.0, runtime=100.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    node = sched.job_info(jid).node_ids[0]
    sched.cancel(jid, now=1.0)
    sched.on_craned_down(node, now=2.0)
    sim.advance_to(200.0)
    sched.schedule_cycle(now=200.0)
    job = sched.job_info(jid)
    assert job.status == env.ctld.JobStatus.CANCELLED
    assert job.requeue_count == 0
    return [_record(sched)]


def _requeue_then_held(env):
    _, sched, sim = _cluster(env, config=dict(max_requeue_count=2))
    jid = sched.submit(_spec(env, runtime=5.0, sim_exit_code=1,
                             requeue_if_failed=True), now=0.0)
    now = 0.0
    for _ in range(50):
        sim.advance_to(now)
        sched.schedule_cycle(now)
        if sched.job_info(jid).held:
            break
        now += 1.0
    job = sched.job_info(jid)
    assert job.requeue_count == 3 and job.held
    assert job.status == env.ctld.JobStatus.PENDING
    return [now, _record(sched)]


def _craned_down_requeues(env):
    _, sched, sim = _cluster(env, num_nodes=2, cpu=4, config={})
    JS = env.ctld.JobStatus
    j1 = sched.submit(_spec(env, cpu=3.0, runtime=100.0), now=0.0)
    j2 = sched.submit(_spec(env, cpu=3.0, runtime=100.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    dead = sched.job_info(j1).node_ids[0]
    out = [sched.on_craned_down(dead, now=10.0)]
    assert out[-1] == [j1]
    assert sched.job_info(j1).requeue_count == 1
    out.append(sched.schedule_cycle(now=11.0))
    assert out[-1] == []
    assert sched.job_info(j1).pending_reason == \
        env.ctld.PendingReason.RESOURCE
    sim.advance_to(101.0)
    sched.schedule_cycle(now=101.0)
    assert sched.job_info(j1).status == JS.RUNNING
    assert sched.job_info(j1).node_ids != [dead]
    assert sched.job_info(j2).status == JS.COMPLETED
    return out + [_record(sched)]


def _stale_completion(env):
    _, sched, sim = _cluster(env, num_nodes=2, cpu=4, config={})
    jid = sched.submit(_spec(env, cpu=4.0, runtime=100.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    sched.on_craned_down(sched.job_info(jid).node_ids[0], now=10.0)
    out = [sched.schedule_cycle(now=11.0)]
    assert out[-1] == [jid]
    sim.advance_to(105.0)
    sched.schedule_cycle(now=105.0)
    assert sched.job_info(jid).status == env.ctld.JobStatus.RUNNING
    sim.advance_to(112.0)
    sched.schedule_cycle(now=112.0)
    assert sched.job_info(jid).end_time == 111.0
    return out + [_record(sched)]


def _cancel_timestamp(env):
    _, sched, _ = _cluster(env, config={})
    jid = sched.submit(_spec(env, runtime=100.0), now=0.0)
    sched.schedule_cycle(now=1.0)
    sched.cancel(jid, now=5.0)
    sched.schedule_cycle(now=6.0)
    job = sched.job_info(jid)
    assert job.status == env.ctld.JobStatus.CANCELLED
    assert job.end_time == 5.0 >= job.start_time
    return [_record(sched)]


def _operator_requeue(env):
    """requeue: refused for pending, suspended and cancelling jobs; a
    running job goes back to pending and runs again."""
    _, sched, sim = _cluster(env, num_nodes=2)
    a = sched.submit(_spec(env, runtime=100.0), now=0.0)
    b = sched.submit(_spec(env, runtime=100.0), now=0.0)
    c = sched.submit(_spec(env, held=True), now=0.0)
    sched.schedule_cycle(now=1.0)
    out = [sched.requeue(c, now=2.0), sched.requeue(999, now=2.0)]
    sched.suspend(b, now=2.0)
    out.append(sched.requeue(b, now=3.0))
    out.append(sched.requeue(a, now=3.0))
    assert out[-1] == "" and a in sched.pending
    sched.cancel(b, now=4.0)
    out.append(sched.schedule_cycle(now=5.0))
    assert out[-1] == [a]
    return out + [_record(sched)]


# ---------------- modify_job ----------------

def _modify_pending_fields(env):
    _, sched, _ = _cluster(env, num_nodes=2)
    sched.meta.add_partition("gpu")
    sched.meta.nodes[1].partitions.add("gpu")
    sched.meta.partitions["gpu"].node_ids.add(1)
    jid = sched.submit(_spec(env, time_limit=100.0, held=True,
                             runtime=10.0), now=0.0)
    out = [sched.modify_job(jid, now=1.0, time_limit=500.0, priority=42,
                            partition="gpu")]
    job = sched.pending[jid]
    assert out[-1] == "" and job.spec.time_limit == 500.0
    assert job.qos_priority == 42 and job.spec.partition == "gpu"
    out.append(sched.modify_job(jid, now=1.0, partition="nope"))
    out.append(sched.modify_job(9999, now=1.0, time_limit=10.0))
    out.append(sched.modify_job(jid, now=1.0, time_limit=-1.0))
    assert "not found" in out[1] and "not found" in out[2]
    return out + [_record(sched)]


def _modify_running(env):
    _, sched, _ = _cluster(env, num_nodes=2)
    jid = sched.submit(_spec(env, runtime=1e9), now=0.0)
    out = [sched.schedule_cycle(now=1.0)]
    out.append(sched.modify_job(jid, now=2.0, priority=1))
    out.append(sched.modify_job(jid, now=2.0, partition="x"))
    assert "running" in out[-1] and "running" in out[-2]
    out.append(sched.modify_job(jid, now=2.0, time_limit=999.0))
    assert out[-1] == "" and sched.running[jid].spec.time_limit == 999.0
    return out + [_record(sched)]


def _modify_extends_alloc(env):
    _, sched, _ = _cluster(env, num_nodes=2)
    jid = sched.submit(_spec(env, alloc_only=True, time_limit=10.0),
                       now=0.0)
    out = [sched.schedule_cycle(now=1.0),
           sched.modify_job(jid, now=2.0, time_limit=100.0)]
    sched.schedule_cycle(now=50.0)
    assert sched.running[jid].status == env.ctld.JobStatus.RUNNING
    sched.schedule_cycle(now=200.0)
    assert jid not in sched.running
    return out + [_record(sched)]


def _modify_priority_reorders(env):
    _, sched, _ = _cluster(env, num_nodes=1)
    sched.meta.nodes[0].avail = sched.meta.layout.encode(
        cpu=1, mem_bytes=1 << 30, memsw_bytes=1 << 30, is_capacity=True)
    a = sched.submit(_spec(env, runtime=1e9), now=0.0)
    b = sched.submit(_spec(env, runtime=1e9), now=0.1)
    out = [sched.modify_job(b, now=0.2, priority=10_000_000),
           sched.schedule_cycle(now=1.0)]
    assert out[-1] == [b] and a in sched.pending
    return out + [_record(sched)]


def _modify_partition_validation(env):
    _, sched, _ = _cluster(env, num_nodes=2)
    meta = sched.meta
    meta.add_partition("vip", allowed_accounts={"elite"})
    meta.nodes[1].partitions.add("vip")
    meta.partitions["vip"].node_ids.add(1)
    jid = sched.submit(_spec(env, held=True, runtime=10.0, node_num=2),
                       now=0.0)
    out = [sched.modify_job(jid, now=1.0, partition="vip")]
    meta.partitions["vip"].allowed_accounts = None
    out.append(sched.modify_job(jid, now=1.0, partition="vip"))
    assert "not allowed" in out[0] and "exceeds" in out[1]
    return out + [_record(sched)]


def _modify_ledger_release(env):
    _, sched, _ = _cluster(env, num_nodes=1)
    jid = sched.submit(_spec(env, time_limit=120.0, runtime=1e9), now=0.0)
    out = [sched.schedule_cycle(now=0.0)]
    end0 = int(np.asarray(sched._ledger.timed_rows(10.0, 60.0, 64)[2])[0])
    out.append(sched.modify_job(jid, now=10.0, time_limit=36000.0))
    end1 = int(np.asarray(sched._ledger.timed_rows(10.0, 60.0, 64)[2])[0])
    assert end1 > end0
    return out + [end0, end1, _record(sched)]


# ---------------- incarnation-guarded kills ----------------

def _guarded_node_down_kill(env):
    _, sched, _ = _cluster(env, cpu=16)
    kills = []
    sched.dispatch = lambda job, nodes: None
    sched.dispatch_terminate = \
        lambda jid, now, incarnation=None, skip_node=None: \
        kills.append((jid, incarnation, skip_node))
    jid = sched.submit(_spec(env, cpu=2.0, node_num=3, runtime=1e9),
                       now=0.0)
    out = [sched.schedule_cycle(now=1.0)]
    dead = sched.running[jid].node_ids[0]
    sched.on_craned_down(dead, now=5.0)
    assert kills == [(jid, 0, dead)]
    assert sched.pending[jid].requeue_count == 1
    return out + [kills, _record(sched)]


def _stale_guarded_kill(env):
    _, sched, sim = _cluster(env, cpu=16)
    jid = sched.submit(_spec(env, cpu=2.0, runtime=40.0), now=0.0)
    out = [sched.schedule_cycle(now=1.0)]
    sim.terminate(jid, now=2.0, incarnation=7)
    sched.schedule_cycle(now=3.0)
    assert jid in sched.running
    sim.terminate(jid, now=4.0, incarnation=0)
    sched.schedule_cycle(now=5.0)
    assert sched.job_info(jid).status == env.ctld.JobStatus.CANCELLED
    return out + [_record(sched)]


def _stale_whole_job_report(env):
    _, sched, _ = _cluster(env, cpu=16)
    sched.dispatch = lambda job, nodes: None
    sched.dispatch_terminate = lambda jid, now, **kw: None
    jid = sched.submit(_spec(env, cpu=2.0, runtime=1e9, node_num=2),
                       now=0.0)
    out = [sched.schedule_cycle(now=1.0)]
    sched.on_craned_down(sched.running[jid].node_ids[0], now=2.0)
    out.append(sched.schedule_cycle(now=3.0))
    assert out[-1] == [jid]
    sched.step_status_change(jid, env.ctld.JobStatus.CANCELLED, 130, 4.0,
                             incarnation=0)
    sched.schedule_cycle(now=5.0)
    assert sched.running[jid].status == env.ctld.JobStatus.RUNNING
    return out + [_record(sched)]


def _per_node_reports(env):
    """Per-node status reports: the job ends once every node reported;
    the first failure kills the rest and wins the aggregate."""
    _, sched, _ = _cluster(env, cpu=16)
    kills = []
    sched.dispatch = lambda job, nodes: None
    sched.dispatch_terminate = lambda jid, now, **kw: kills.append(jid)
    JS = env.ctld.JobStatus
    a = sched.submit(_spec(env, cpu=2.0, node_num=2, runtime=1e9), now=0.0)
    b = sched.submit(_spec(env, cpu=2.0, node_num=2, runtime=1e9), now=0.0)
    sched.schedule_cycle(now=1.0)
    na, nb = sched.running[a].node_ids, sched.running[b].node_ids
    sched.step_status_change(a, JS.COMPLETED, 0, 2.0, node_id=na[0])
    sched.step_status_change(b, JS.FAILED, 3, 2.0, node_id=nb[0])
    sched.step_status_change(b, JS.CANCELLED, 130, 2.5, node_id=nb[1])
    sched.step_status_change(a, JS.COMPLETED, 0, 3.0, node_id=na[1])
    sched.schedule_cycle(now=4.0)
    assert sched.job_info(a).status == JS.COMPLETED
    assert sched.job_info(b).status == JS.FAILED
    assert sched.job_info(b).exit_code == 3 and kills == [b]
    return [kills, _record(sched)]


def _cancel_renewal_backoff(env):
    _, sched, _ = _cluster(env, cpu=16)
    kills = []
    sched.dispatch = lambda job, nodes: None
    sched.dispatch_terminate = \
        lambda jid, now, **kw: kills.append((jid, now))
    jid = sched.submit(_spec(env, cpu=2.0, runtime=1e9), now=0.0)
    sched.schedule_cycle(now=1.0)
    sched.cancel(jid, now=2.0)
    assert not sched.can_idle()
    for t in range(3, 9):
        sched.schedule_cycle(now=float(t))
    assert [t for _, t in kills] == [2.0, 7.0]
    sched.step_status_change(jid, env.ctld.JobStatus.CANCELLED, 130, 8.5)
    sched.schedule_cycle(now=20.0)
    assert len(kills) == 2 and jid not in sched._cancel_kill_sent
    return [kills, _record(sched)]


def _craned_timeout(env):
    """A node that expects pings and misses them past craned_timeout is
    declared dead by the cycle prelude; its job requeues."""
    meta, sched, _ = _cluster(env, num_nodes=2,
                              config=dict(backfill=False,
                                          craned_timeout=10.0))
    jid = sched.submit(_spec(env, runtime=1e9), now=0.0)
    sched.schedule_cycle(now=0.0)
    node = meta.nodes[sched.running[jid].node_ids[0]]
    node.expect_pings = True
    node.last_ping = 0.0
    out = [sched.next_wake_time(1.0)]
    sched.schedule_cycle(now=5.0)
    assert jid in sched.running
    out.append(sched.schedule_cycle(now=11.0))
    assert not node.alive and sched.job_info(jid).requeue_count == 1
    return out + [_record(sched)]


def _evicted_with_pending_cancel(env):
    acct = env.acct
    meta = env.ctld.MetaContainer()
    meta.add_node("n0", meta.layout.encode(cpu=4, mem_bytes=8 << 30,
                                           is_capacity=True))
    meta.craned_up(0)
    mgr = acct.AccountManager()
    mgr.users["root"] = acct.User(name="root",
                                  admin_level=acct.AdminLevel.ROOT)
    mgr.add_qos("root", acct.Qos(name="hi", priority=100, preempt={"lo"}))
    mgr.add_qos("root", acct.Qos(name="lo", priority=1))
    mgr.add_account("root", acct.Account(
        name="acc", allowed_qos={"hi", "lo"}, default_qos="lo"))
    mgr.add_user("root", acct.User(name="u", uid=1), "acc")
    cfg = dict(preempt_mode="requeue", backfill=False)
    kw = {}
    if env is JAX:
        cfg["solver"] = "device"
    else:
        kw["device"] = "cpu"
    sched = env.ctld.JobScheduler(meta, env.ctld.SchedulerConfig(**cfg),
                                  accounts=mgr, **kw)
    sched.dispatch = lambda job, nodes: None
    sched.dispatch_terminate = lambda jid, now, **kw: None
    res = env.ctld.ResourceSpec(cpu=4.0, mem_bytes=1 << 30)
    lo = sched.submit(env.ctld.JobSpec(user="u", account="acc", qos="lo",
                                       res=res, sim_runtime=1e9), now=0.0)
    out = [sched.schedule_cycle(now=1.0)]
    sched.cancel(lo, now=2.0)
    hi = sched.submit(env.ctld.JobSpec(user="u", account="acc", qos="hi",
                                       res=res, sim_runtime=10.0), now=3.0)
    out.append(sched.schedule_cycle(now=4.0))
    assert hi in out[-1]
    assert sched.job_info(lo).status == env.ctld.JobStatus.CANCELLED
    return out + [_record(sched)]


# ---------------- no-op fingerprint re-arming ----------------

def _held_flip_rearms(env):
    _, sched, _ = _cluster(env)
    jid = sched.submit(_spec(env, held=True, runtime=1.0), now=0.0)
    out = [sched.schedule_cycle(now=1.0), sched.schedule_cycle(now=2.0)]
    assert sched.stats["skipped_cycles"] == 1
    sched.hold(jid, held=False, now=3.0)
    out.append(sched.schedule_cycle(now=3.0))
    assert out[-1] == [jid] and sched.stats["skipped_cycles"] == 1
    return out + [sched.stats["skipped_cycles"], _record(sched)]


def _begin_edge_defeats_skip(env):
    _, sched, _ = _cluster(env)
    jid = sched.submit(_spec(env, begin_time=10.0, runtime=1.0), now=0.0)
    out = [sched.schedule_cycle(now=1.0), sched.schedule_cycle(now=2.0)]
    assert sched.stats["skipped_cycles"] == 1
    out.append(sched.schedule_cycle(now=11.0))
    assert out[-1] == [jid]
    return out + [_record(sched)]


def _dependency_flip_rearms(env):
    _, sched, sim = _cluster(env)
    a = sched.submit(_spec(env, runtime=2.0), now=0.0)
    b = sched.submit(_spec(env, runtime=1.0, dependencies=(
        _dep(env, a, "AFTER_OK"),)), now=0.0)
    out = [sched.schedule_cycle(now=1.0), sched.schedule_cycle(now=2.0),
           sched.schedule_cycle(now=2.5)]
    assert out == [[a], [], []] and sched.stats["skipped_cycles"] == 1
    sim.advance_to(4.0)
    out.append(sched.schedule_cycle(now=4.0))
    assert out[-1] == [b]
    return out + [_record(sched)]


def _idle_wakeup_bounds(env):
    _, sched, _ = _cluster(env)
    sched.submit(_spec(env, begin_time=50.0), now=0.0)
    sched.schedule_cycle(now=1.0)
    assert sched.can_idle() and sched.next_wake_time(2.0) == 50.0
    jid2 = sched.submit(_spec(env, runtime=1.0), now=2.0)
    assert not sched.can_idle()
    out = [sched.schedule_cycle(now=3.0)]
    assert out[-1] == [jid2]
    return out + [_record(sched)]


# ---------------- submit hooks ----------------

def _submit_hooks(env):
    """A hook rewrites the spec or rejects it; one that raises or
    returns the wrong type rejects the job and is counted."""
    import dataclasses

    seen = []

    def hook(spec):
        seen.append(spec.name)
        if spec.name == "boom":
            raise RuntimeError("hook bug")
        if spec.name == "wrong":
            return "not a spec"
        if spec.name == "deny":
            return None
        return dataclasses.replace(spec, time_limit=123.0,
                                   qos_priority=7)

    _, sched, _ = _cluster(env, submit_hook=hook)
    out = [sched.submit(_spec(env, name=n), now=0.0)
           for n in ("ok", "boom", "wrong", "deny", "ok2")]
    assert out == [1, 0, 0, 0, 2]
    assert sched.stats["submit_hook_failures"] == 2
    assert sched.pending[1].spec.time_limit == 123.0
    out.append(sched.schedule_cycle(now=1.0))
    return out + [seen, _record(sched)]


def _rebuild_matches_incremental(env):
    """The per-job candidate walk (``incremental=False``) and the
    PendingTable pass agree over held, begin-time, dependent and array
    jobs, cycle by cycle."""
    records = []
    for incremental in (True, False):
        _, sched, sim = _cluster(env, num_nodes=3, config=dict(
            backfill=False, incremental=incremental))
        a = sched.submit(_spec(env, runtime=4.0), now=0.0)
        sched.submit(_spec(env, runtime=3.0, dependencies=(
            _dep(env, a, "AFTER_ANY", 2.0),)), now=0.0)
        sched.submit(_spec(env, runtime=2.0, begin_time=6.0), now=0.0)
        h = sched.submit(_spec(env, held=True, runtime=1.0), now=0.0)
        sched.submit(_spec(env, cpu=4.0, runtime=3.0,
                           array=env.defs.ArraySpec(0, 4, 2)), now=0.0)
        run = []
        for t in range(0, 16):
            if t == 9:
                sched.hold(h, False, now=float(t))
            sim.advance_to(float(t))
            run.append(sched.schedule_cycle(now=float(t)))
        records.append([run, _record(sched)])
    assert records[0] == records[1]
    return records[0]


_CASES = {
    "afterok_waits": _afterok_waits,
    "afterok_never": _afterok_never,
    "afternotok": _afternotok,
    "after_delay": _after_delay,
    "or_deps": _or_deps,
    "unknown_dep": _unknown_dep,
    "finished_dep": _finished_dep,
    "dep_chain_drains": _dep_chain_drains,
    "cancelled_child_finalizes_parent": _cancelled_child_finalizes_parent,
    "array_one_child_per_cycle": _array_one_child_per_cycle,
    "array_run_limit": _array_run_limit,
    "array_parent_completes": _array_parent_completes,
    "array_cancel": _array_cancel,
    "resv_excludes_outside": _resv_excludes_outside,
    "resv_acl": _resv_acl,
    "resv_expiry": _resv_expiry,
    "resv_future_window": _resv_future_window,
    "resv_job_waits_for_window": _resv_job_waits_for_window,
    "resv_job_waits_backfill": _resv_job_waits_backfill,
    "suspend_credits_time": _suspend_credits_time,
    "suspend_keeps_resources": _suspend_keeps_resources,
    "hold_release": _hold_release,
    "begin_time_gates": _begin_time_gates,
    "cancel_pending_and_running": _cancel_pending_and_running,
    "cancel_beats_node_death": _cancel_beats_node_death,
    "requeue_then_held": _requeue_then_held,
    "craned_down_requeues": _craned_down_requeues,
    "stale_completion": _stale_completion,
    "cancel_timestamp": _cancel_timestamp,
    "operator_requeue": _operator_requeue,
    "modify_pending_fields": _modify_pending_fields,
    "modify_running": _modify_running,
    "modify_extends_alloc": _modify_extends_alloc,
    "modify_priority_reorders": _modify_priority_reorders,
    "modify_partition_validation": _modify_partition_validation,
    "modify_ledger_release": _modify_ledger_release,
    "guarded_node_down_kill": _guarded_node_down_kill,
    "stale_guarded_kill": _stale_guarded_kill,
    "stale_whole_job_report": _stale_whole_job_report,
    "per_node_reports": _per_node_reports,
    "cancel_renewal_backoff": _cancel_renewal_backoff,
    "craned_timeout": _craned_timeout,
    "evicted_with_pending_cancel": _evicted_with_pending_cancel,
    "held_flip_rearms": _held_flip_rearms,
    "begin_edge_defeats_skip": _begin_edge_defeats_skip,
    "dependency_flip_rearms": _dependency_flip_rearms,
    "idle_wakeup_bounds": _idle_wakeup_bounds,
    "submit_hooks": _submit_hooks,
    "rebuild_matches_incremental": _rebuild_matches_incremental,
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_lifecycle_matches_jax(case):
    fn = _CASES[case]
    assert fn(JAX) == fn(PORT)
