"""The port's WAL, job archive and accounts store against the JAX
package's: the cases of ``tests/test_wal_recovery.py``,
``tests/test_acct_store.py`` and ``tests/test_archive.py`` (those
without RPC), run once per package in its own directory, each making
the original test's assertions and returning what it observed; the two
records must be equal.

Then the cross-package cases: the same mixed scenario (running,
suspended, held, dependency-waiting, array, reservation, alloc-only
with steps, a cancel intent) writes byte-identical WAL files from
either scheduler, a WAL written by one package replays into the other
to the same recovered state, and a recovered scheduler's next cycle is
held against the scheduler that did not crash, in both packages."""

import json
import os
import types

import numpy as np
import pytest

import cranesched_tpu.craned.sim as jsim
import cranesched_tpu.ctld as jctld
import cranesched_tpu.ctld.accounting as jacct
import cranesched_tpu.ctld.acct_store as jstore
import cranesched_tpu.ctld.archive as jarchive
import cranesched_tpu.ctld.defs as jdefs
import cranesched_tpu.ctld.wal as jwal
import cranesched_tpu_torch.craned.sim as tsim
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.ctld.accounting as tacct
import cranesched_tpu_torch.ctld.acct_store as tstore
import cranesched_tpu_torch.ctld.archive as tarchive
import cranesched_tpu_torch.ctld.defs as tdefs
import cranesched_tpu_torch.ctld.wal as twal

JAX = types.SimpleNamespace(ctld=jctld, defs=jdefs, sim=jsim, wal=jwal,
                            acct=jacct, store=jstore, archive=jarchive,
                            name="jax")
PORT = types.SimpleNamespace(ctld=tctld, defs=tdefs, sim=tsim, wal=twal,
                             acct=tacct, store=tstore, archive=tarchive,
                             name="port")


def _build(env, num_nodes=4, wal=None, config=None, **kw):
    ctld = env.ctld
    meta = ctld.MetaContainer()
    for i in range(num_nodes):
        meta.add_node(f"cn{i:02d}", meta.layout.encode(
            cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True))
        meta.craned_up(i)
    cfg = (dict(priority_type="basic") if config is None
           else dict(config))
    if env is JAX:
        cfg["solver"] = "device"
    else:
        kw["device"] = "cpu"
    sched = ctld.JobScheduler(meta, ctld.SchedulerConfig(**cfg), wal=wal,
                              **kw)
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
    return (job.job_id, job.status.name, tuple(job.node_ids), job.held,
            job.requeue_count, job.cancel_requested, job.start_time,
            job.end_time, job.exit_code,
            tuple(sorted(job.dep_state.items())),
            tuple(job.array_remaining), tuple(job.array_children),
            job.array_parent_id, job.suspend_time, job.suspended_total,
            job.spec.time_limit, job.next_step_id, steps)


def _record(sched):
    avail, _total, _alive = sched.meta.snapshot()
    return {"pending": [_job(j) for j in sched.pending.values()],
            "running": [_job(j) for j in sched.running.values()],
            "history": sorted(_job(j) for j in sched.history.values()),
            "avail": np.asarray(avail).tolist()}


def _replayed(path, wal_mod):
    return {jid: (ev, job.status.name)
            for jid, (ev, job) in wal_mod.WriteAheadLog.replay(path).items()}


def _twin(fn, tmp_path):
    """Run ``fn(env, dir)`` once per package, each in its own directory;
    the observations must be equal."""
    out = []
    for env in (JAX, PORT):
        d = tmp_path / env.name
        d.mkdir()
        out.append(fn(env, d))
    assert out[0] == out[1]
    return out[1]


# ---------------- tests/test_wal_recovery.py ----------------

def _mixed_states(env, d):
    path = str(d / "ctld.wal")
    wal = env.wal.WriteAheadLog(path)
    meta, sched, sim = _build(env, num_nodes=3, wal=wal)
    JS = env.ctld.JobStatus
    done = sched.submit(_spec(env, cpu=2.0, runtime=5.0), now=0.0)
    run1 = sched.submit(_spec(env, cpu=8.0, runtime=500.0), now=0.0)
    run2 = sched.submit(_spec(env, cpu=8.0, runtime=500.0), now=0.0)
    pend = sched.submit(_spec(env, cpu=8.0, runtime=10.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    sim.advance_to(6.0)
    sched.process_status_changes()
    nodes = {j: sched.job_info(j).node_ids for j in (run1, run2)}
    wal.close()

    meta2, sched2, sim2 = _build(env)
    sched2.recover(env.wal.WriteAheadLog.replay(path))
    assert sched2.job_info(done).status == JS.COMPLETED
    assert set(sched2.running) == {run1, run2}
    for j, ns in nodes.items():
        assert sched2.job_info(j).node_ids == ns
        for n in ns:
            assert meta2.nodes[n].avail[0] == \
                meta2.nodes[n].total[0] - 8 * 256
    assert pend in sched2.pending
    out = [_record(sched2), sched2.submit(_spec(env), now=7.0)]
    assert out[-1] == pend + 1
    for j in (run1, run2):
        sim2.dispatch(sched2.job_info(j), sched2.job_info(j).node_ids)
    out.append(sim2.run_until_drained(start=7.0, max_cycles=3000))
    assert len(sched2.history) == 5
    assert all(j.status == JS.COMPLETED for j in sched2.history.values())
    return out + [_record(sched2)]


def _dead_node_requeues(env, d):
    path = str(d / "ctld.wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, _ = _build(env, wal=wal)
    jid = sched.submit(_spec(env, cpu=4.0, runtime=100.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    node = sched.job_info(jid).node_ids[0]
    wal.close()
    meta2, sched2, _ = _build(env)
    meta2.nodes[node].alive = False
    sched2.recover(env.wal.WriteAheadLog.replay(path))
    job = sched2.job_info(jid)
    assert job.status == env.ctld.JobStatus.PENDING
    assert job.requeue_count == 1
    return [_record(sched2)]


def _cancel_intent_survives(env, d):
    path = str(d / "ctld.wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, _ = _build(env, wal=wal)
    jid = sched.submit(_spec(env, cpu=4.0, runtime=500.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    sched.cancel(jid, now=1.0)
    wal.close()
    _, sched2, _ = _build(env)
    kills = []
    sched2.dispatch_terminate = \
        lambda job_id, now, **kw: kills.append(job_id)
    sched2.recover(env.wal.WriteAheadLog.replay(path), now=2.0)
    assert sched2.job_info(jid).cancel_requested and kills == [jid]
    sched2.on_craned_down(sched2.job_info(jid).node_ids[0], now=3.0)
    assert sched2.job_info(jid).status == env.ctld.JobStatus.CANCELLED
    return [kills, _record(sched2)]


def _node_death_requeue_survives(env, d):
    path = str(d / "ctld.wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, _ = _build(env, wal=wal)
    jid = sched.submit(_spec(env, cpu=4.0, runtime=500.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    node = sched.job_info(jid).node_ids[0]
    sched.on_craned_down(node, now=1.0)
    wal.close()
    meta2, sched2, _ = _build(env)
    sched2.recover(env.wal.WriteAheadLog.replay(path), now=2.0)
    job = sched2.job_info(jid)
    assert job.status == env.ctld.JobStatus.PENDING
    assert job.requeue_count == 1 and jid not in sched2.running
    assert (meta2.nodes[node].avail == meta2.nodes[node].total).all()
    return [_record(sched2)]


def _torn_tail(env, d):
    path = str(d / "ctld.wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, _ = _build(env, wal=wal)
    sched.submit(_spec(env), now=0.0)
    wal.close()
    with open(path, "a") as fh:
        fh.write('{"ev": "start", "job": {"job_id": 99')
    replayed = env.wal.WriteAheadLog.replay(path)
    assert list(replayed) == [1]
    return list(replayed)


def _compact_drops_finalized(env, d):
    path = str(d / "ctld.wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, sim = _build(env, wal=wal)
    j1 = sched.submit(_spec(env, runtime=1.0), now=0.0)
    j2 = sched.submit(_spec(env, cpu=8.0, runtime=500.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    sim.advance_to(2.0)
    sched.schedule_cycle(now=2.0)
    assert sched.job_info(j1).status == env.ctld.JobStatus.COMPLETED
    before = sum(1 for _ in open(path))
    wal.compact()
    after = [json.loads(line) for line in open(path)]
    assert len(after) < before
    assert {r["job"]["job_id"] for r in after} == {j2}
    sched.submit(_spec(env), now=3.0)
    assert set(env.wal.WriteAheadLog.replay(path)) == {j2, j2 + 1}
    wal.close()
    return [before, after, _replayed(path, env.wal)]


def _seq_rotation(env, d):
    path = str(d / "ctld.wal")
    W = env.wal.WriteAheadLog
    wal = W(path)
    _, sched, _ = _build(env, wal=wal)
    j1 = sched.submit(_spec(env, runtime=500.0), now=0.0)
    j2 = sched.submit(_spec(env, runtime=500.0), now=0.0)
    assert wal.seq == 2 and wal.rotate() == 2
    j3 = sched.submit(_spec(env), now=1.0)
    assert wal.seq == 3
    assert [s for s, _ in wal.tail_since(0)] == [1, 2, 3]
    assert [s for s, _ in wal.tail_since(2)] == [3]
    assert wal.tail_since(3) == [] and wal.tail_since(99) is None
    assert set(W.replay(path)) == {j1, j2, j3}
    assert set(W.replay(path, after_seq=2)) == {j3}
    wal.close()
    wal2 = W(path)
    assert wal2.seq == 3
    assert wal2.tail_since(0) is None and wal2.tail_since(3) == []
    wal2.close()
    return [wal.seq, sorted(os.listdir(d))]


def _prune_segments(env, d):
    path = str(d / "ctld.wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, _ = _build(env, wal=wal)
    sched.submit(_spec(env, runtime=500.0), now=0.0)
    first = wal.rotate()
    sched.submit(_spec(env, runtime=500.0), now=1.0)
    second = wal.rotate()
    segs = env.wal._segment_files
    assert len(segs(path)) == 2
    out = [wal.prune_segments(first), len(segs(path)),
           wal.prune_segments(second), segs(path)]
    assert out == [1, 1, 1, []]
    wal.close()
    return out


def _compact_absorbs_segments(env, d):
    path = str(d / "ctld.wal")
    W = env.wal.WriteAheadLog
    wal = W(path)
    _, sched, sim = _build(env, wal=wal)
    j1 = sched.submit(_spec(env, runtime=1.0), now=0.0)
    j2 = sched.submit(_spec(env, cpu=8.0, runtime=500.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    wal.rotate()
    sim.advance_to(2.0)
    sched.process_status_changes()
    pre = {r["job"]["job_id"]: r.get("seq", 0)
           for r in W._iter_records(path)}
    seq_before = wal.seq
    wal.compact()
    assert env.wal._segment_files(path) == []
    lines = [json.loads(line) for line in open(path)]
    assert {r["job"]["job_id"] for r in lines} == {j1, j2}
    assert {r["job"]["job_id"]: r["seq"] for r in lines} == pre
    wal.compact()
    lines = [json.loads(line) for line in open(path)]
    assert {r["job"]["job_id"] for r in lines} == {j2}
    assert lines[-1]["seq"] == pre[j2] and wal.seq == seq_before
    wal.close()
    return [pre, lines]


def _kill_during_compact(env, d, monkeypatch):
    path = str(d / "ctld.wal")
    W = env.wal.WriteAheadLog
    wal = W(path)
    _, sched, sim = _build(env, wal=wal)
    j1 = sched.submit(_spec(env, runtime=1.0), now=0.0)
    j2 = sched.submit(_spec(env, cpu=8.0, runtime=500.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    wal.rotate()
    sim.advance_to(2.0)
    sched.process_status_changes()
    before = _replayed(path, env.wal)

    def boom(src, dst):
        raise OSError("kill -9 mid-compact")
    monkeypatch.setattr(env.wal.os, "replace", boom)
    with pytest.raises(OSError):
        wal.compact()
    monkeypatch.undo()
    assert _replayed(path, env.wal) == before

    wal2 = W(path)
    monkeypatch.setattr(env.wal.os, "unlink", lambda p: (_ for _ in ())
                        .throw(OSError("kill -9 mid-unlink")))
    with pytest.raises(OSError):
        wal2.compact()
    monkeypatch.undo()
    after2 = W.replay(path)
    assert after2[j1][1].status == env.ctld.JobStatus.COMPLETED
    assert after2[j2][1].status == env.ctld.JobStatus.RUNNING
    wal3 = W(path)
    wal3.compact()
    wal3.compact()
    final = _replayed(path, env.wal)
    assert final == {j2: ("start", "RUNNING")}
    wal3.close()
    return [before, final]


def _group_commit(env, d):
    path = str(d / "ctld.wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, _ = _build(env, wal=wal)
    f0, g0 = wal.fsync_total, wal.groups_total
    with wal.group():
        ids = [sched.submit(_spec(env), now=0.0) for _ in range(3)]
        assert wal.seq == 3 and wal.durable_seq == 0
        assert wal.tail_since(0) == []
    assert wal.fsync_total - f0 == 1 and wal.groups_total - g0 == 1
    assert wal.durable_seq == wal.seq == 3
    assert [s for s, _ in wal.tail_since(0)] == [1, 2, 3]
    wal.close()
    assert set(env.wal.WriteAheadLog.replay(path)) == set(ids)
    return ids


def _cycle_groups(env, d):
    """A cycle with starts and status changes is at most a few WAL
    groups, each one fsync, whatever the number of records."""
    path = str(d / "ctld.wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, sim = _build(env, wal=wal, config={})
    for _ in range(12):
        sched.submit(_spec(env, runtime=5.0), now=0.0)
    f0, g0 = wal.fsync_total, wal.groups_total
    started = sched.schedule_cycle(now=1.0)
    groups = [wal.groups_total - g0, wal.fsync_total - f0]
    sim.advance_to(10.0)
    sched.schedule_cycle(now=10.0)
    groups += [wal.groups_total - g0, wal.fsync_total - f0]
    assert groups[0] == groups[1] <= 3 and groups[2] == groups[3] <= 6
    wal.close()
    return [started, groups, _replayed(path, env.wal)]


def _torn_group_tail(env, d):
    path = str(d / "ctld.wal")
    W = env.wal.WriteAheadLog
    wal = W(path)
    _, sched, _ = _build(env, wal=wal)
    j1 = sched.submit(_spec(env), now=0.0)
    with wal.group():
        j2 = sched.submit(_spec(env), now=0.0)
        sched.submit(_spec(env), now=0.0)
    wal.close()
    lines = open(path).read().splitlines(True)
    with open(path, "w") as fh:
        fh.writelines(lines[:-1])
        fh.write(lines[-1][: len(lines[-1]) // 2])
    assert set(W.replay(path)) == {j1, j2}
    wal2 = W(path)
    assert wal2.seq == 2 == wal2.durable_seq
    assert wal2.tail_since(0) is None
    wal2.close()
    return [j1, j2]


def _failed_fsync_blocks_dispatch(env, d, monkeypatch):
    path = str(d / "ctld.wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, _ = _build(env, wal=wal)
    dispatched = []
    sched.dispatch = lambda job, nodes: dispatched.append(job.job_id)
    sched.submit(_spec(env), now=0.0)
    monkeypatch.setattr(env.wal.os, "fsync", lambda fd: (_ for _ in ())
                        .throw(OSError("disk gone")))
    with pytest.raises(OSError):
        sched.schedule_cycle(now=1.0)
    monkeypatch.undo()
    assert dispatched == []
    if env is PORT:
        assert sched.stats["dispatch_dropped"] == 1
    return dispatched


def _compact_mid_group(env, d, monkeypatch):
    W = env.wal.WriteAheadLog
    path = str(d / "ctld.wal")
    wal = W(path)
    _, sched, _ = _build(env, wal=wal)
    j1 = sched.submit(_spec(env), now=0.0)
    wal.begin_batch()
    j2 = sched.submit(_spec(env), now=0.0)
    wal.compact()
    j3 = sched.submit(_spec(env), now=0.0)
    wal.commit_batch()
    wal.close()
    assert set(W.replay(path)) == {j1, j2, j3}
    path2 = str(d / "crash.wal")
    wal2 = W(path2)
    _, sched2, _ = _build(env, wal=wal2)
    k1 = sched2.submit(_spec(env), now=0.0)
    wal2.begin_batch()
    k2 = sched2.submit(_spec(env), now=0.0)
    monkeypatch.setattr(env.wal.os, "replace", lambda s, t: (_ for _ in ())
                        .throw(OSError("kill -9 mid-compact")))
    with pytest.raises(OSError):
        wal2.compact()
    monkeypatch.undo()
    assert set(W.replay(path2)) == {k1, k2}
    return [j1, j2, j3, k1, k2]


def _follower_tail(env, d):
    path = str(d / "ctld.wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, _ = _build(env, wal=wal)
    sched.submit(_spec(env), now=0.0)
    with wal.group():
        sched.submit(_spec(env), now=0.0)
        sched.submit(_spec(env), now=0.0)
    sched.submit(_spec(env), now=0.0)
    assert [s for s, _ in wal.tail_since(1)] == [2, 3, 4]
    assert [s for s, _ in wal.tail_since(2)] == [3, 4]
    for s, line in wal.tail_since(0):
        assert json.loads(line)["seq"] == s
    assert wal.tail_since(4) == [] and wal.tail_since(99) is None
    wal.close()
    return [s for s, _ in wal.tail_since(0)]


def _dep_survives_crash(env, d):
    path = str(d / "wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, sim = _build(env, wal=wal, config=dict(backfill=False))
    a = sched.submit(_spec(env, runtime=5.0), now=0.0)
    b = sched.submit(_spec(env, dependencies=(env.defs.Dependency(
        a, env.defs.DepType.AFTER_OK),)), now=0.0)
    sched.schedule_cycle(now=0.0)
    sim.advance_to(6.0)
    sched.process_status_changes()
    wal.close()
    _, sched2, _ = _build(env, config=dict(backfill=False))
    sched2.recover(env.wal.WriteAheadLog.replay(path), now=7.0)
    out = [sched2.schedule_cycle(now=7.0)]
    assert out[-1] == [b]
    return out + [_record(sched2)]


def _suspended_recovers(env, d):
    path = str(d / "wal")
    wal = env.wal.WriteAheadLog(path)
    _, sched, _ = _build(env, wal=wal, config=dict(backfill=False))
    j = sched.submit(_spec(env, runtime=100.0), now=0.0)
    sched.schedule_cycle(now=0.0)
    sched.suspend(j, now=5.0)
    wal.close()
    meta2, sched2, _ = _build(env, config=dict(backfill=False))
    sched2.recover(env.wal.WriteAheadLog.replay(path), now=6.0)
    job = sched2.job_info(j)
    assert job.status == env.ctld.JobStatus.SUSPENDED
    node = meta2.nodes[job.node_ids[0]]
    assert j in sched2.running and node.avail[0] < node.total[0]
    return [_record(sched2)]


# ---------------- tests/test_archive.py ----------------

def _archived(env, d, wal_fsync=False):
    wal = env.wal.WriteAheadLog(str(d / "wal.jsonl"), fsync=wal_fsync)
    archive = env.archive.JobArchive(str(d / "history.sqlite"))
    _, sched, sim = _build(env, num_nodes=2, wal=wal,
                           config=dict(backfill=False), archive=archive)
    return sched, sim, wal, archive


def _history_survives_compaction(env, d):
    sched, sim, wal, archive = _archived(env, d)
    jid = sched.submit(env.ctld.JobSpec(
        name="keepme", user="alice", res=env.ctld.ResourceSpec(
            cpu=2.0, mem_bytes=1 << 30), sim_runtime=10.0), now=0.0)
    assert sched.schedule_cycle(now=1.0) == [jid]
    sim.advance_to(20.0)
    sched.schedule_cycle(now=21.0)
    assert jid in archive
    wal.compact()
    assert jid not in env.wal.WriteAheadLog.replay(wal.path)
    wal.close()
    archive.close()
    sched2, _, _, archive2 = _archived(env, d)
    sched2.recover(env.wal.WriteAheadLog.replay(str(d / "wal.jsonl")),
                   now=30.0)
    assert sched2.job_info(jid) is None
    rows = archive2.query(job_ids=[jid])
    assert len(rows) == 1 and rows[0].spec.name == "keepme"
    assert rows[0].steps[0].status.value == "Completed"
    return [_job(rows[0]), archive2.count()]


def _auto_compaction(env, d):
    sched, sim, wal, archive = _archived(env, d)
    sched._finalized_since_compact = 998
    for i in range(2):
        sched.submit(env.ctld.JobSpec(res=env.ctld.ResourceSpec(cpu=1.0),
                                      sim_runtime=1.0), now=float(i))
    sched.schedule_cycle(now=5.0)
    sim.advance_to(10.0)
    sched.schedule_cycle(now=11.0)
    assert not env.wal.WriteAheadLog.replay(wal.path)
    assert archive.count() == 2
    return [archive.count(), sched._finalized_since_compact]


def _recovery_archives_tombstones(env, d):
    sched, sim, wal, archive = _archived(env, d)
    jid = sched.submit(env.ctld.JobSpec(res=env.ctld.ResourceSpec(cpu=1.0),
                                        sim_runtime=1.0), now=0.0)
    sched.schedule_cycle(now=1.0)
    sim.advance_to(5.0)
    sched.schedule_cycle(now=6.0)
    wal.close()
    archive.close()
    (d / "history.sqlite").unlink()
    sched2, _, _, archive2 = _archived(env, d)
    sched2.recover(env.wal.WriteAheadLog.replay(str(d / "wal.jsonl")),
                   now=10.0)
    assert jid in archive2
    return [_job(archive2.query(job_ids=[jid])[0])]


def _ids_never_reused(env, d):
    sched, sim, wal, archive = _archived(env, d)
    spec = env.ctld.JobSpec
    jid = sched.submit(spec(name="first", res=env.ctld.ResourceSpec(
        cpu=1.0), sim_runtime=1.0), now=0.0)
    sched.schedule_cycle(now=1.0)
    sim.advance_to(5.0)
    sched.schedule_cycle(now=6.0)
    wal.compact()
    wal.close()
    archive.close()
    sched2, sim2, _, archive2 = _archived(env, d)
    sched2.recover(env.wal.WriteAheadLog.replay(str(d / "wal.jsonl")),
                   now=10.0)
    jid2 = sched2.submit(spec(name="second", res=env.ctld.ResourceSpec(
        cpu=1.0), sim_runtime=1.0), now=11.0)
    assert jid2 > jid
    sched2.schedule_cycle(now=12.0)
    sim2.advance_to(20.0)
    sched2.schedule_cycle(now=21.0)
    assert {j.spec.name for j in archive2.query()} == {"first", "second"}
    return [jid, jid2]


def _keyset_pagination(env, d):
    archive = env.archive.JobArchive(str(d / "h.sqlite"))
    now = 1_700_000_000.0
    for jid in range(1, 31):
        archive.append(env.defs.Job(
            job_id=jid, spec=env.ctld.JobSpec(user="u"), submit_time=now,
            status=env.ctld.JobStatus.COMPLETED, start_time=now,
            end_time=now + jid, exit_code=0))
    out = [[j.job_id for j in archive.query(limit=5)]]
    assert out[0] == [30, 29, 28, 27, 26]
    seen, cursor = [], 0
    while True:
        page = archive.query(limit=7, after_job_id=cursor, keyset=True)
        if not page:
            break
        seen += [j.job_id for j in page]
        cursor = page[-1].job_id
    assert seen == list(range(1, 31))
    return out + [seen]


# ---------------- tests/test_acct_store.py ----------------

def _seed(env, mgr):
    a = env.acct
    mgr.users["root"] = a.User(name="root", admin_level=a.AdminLevel.ROOT)
    mgr.add_qos("root", a.Qos(name="normal", priority=100,
                              max_jobs_per_user=1,
                              max_tres_per_user=np.asarray(
                                  [16 * 256, 1 << 20, 1 << 20], np.int64)))
    mgr.add_account("root", a.Account(name="hpc", allowed_qos={"normal"},
                                      default_qos="normal"))
    mgr.add_account("root", a.Account(name="hpc-sub", parent="hpc"))
    mgr.add_user("root", a.User(name="alice", uid=1001), "hpc")
    mgr.accounts["hpc"].coordinators.add("alice")
    mgr.block_user("root", "alice", "hpc", blocked=False)


def _fresh_manager(env, path):
    mgr = env.acct.AccountManager()
    env.store.attach_store(mgr, env.store.AccountStore(path))
    return mgr


def _manager_view(mgr):
    return {
        "qos": sorted((q.name, q.priority, q.max_jobs_per_user,
                       np.asarray(q.max_tres_per_user).tolist(),
                       q.reference_count) for q in mgr.qos.values()),
        "accounts": sorted((a.name, a.parent, sorted(a.users),
                            sorted(a.coordinators))
                           for a in mgr.accounts.values()),
        "users": sorted((u.name, u.admin_level.name,
                         sorted((k, v.blocked)
                                for k, v in u.accounts.items()))
                        for u in mgr.users.values()),
        "txn": [(t["action"], t.get("target")) for t in mgr.txn_log],
    }


def _hierarchy_survives(env, d):
    path = str(d / "acct.sqlite")
    m1 = env.acct.AccountManager()
    env.store.attach_store(m1, env.store.AccountStore(path))
    _seed(env, m1)
    m2 = _fresh_manager(env, path)
    assert _manager_view(m2) == _manager_view(m1)
    assert m2.users["root"].admin_level == env.acct.AdminLevel.ROOT
    assert m2.accounts["hpc-sub"].parent == "hpc"
    assert any(t["action"] == "add_qos" for t in m2.txn_log)
    return _manager_view(m2)


def _mutations_keep_persisting(env, d):
    path = str(d / "acct.sqlite")
    m1 = env.acct.AccountManager()
    env.store.attach_store(m1, env.store.AccountStore(path))
    _seed(env, m1)
    m2 = _fresh_manager(env, path)
    m2.add_user("root", env.acct.User(name="bob", uid=1002), "hpc")
    m3 = _fresh_manager(env, path)
    assert "bob" in m3.users and "bob" in m3.accounts["hpc"].users
    return _manager_view(m3)


def _run_limits_after_crash(env, d):
    acct_path, wal_path = str(d / "acct.sqlite"), str(d / "ctld.wal")

    def build(recovered=None):
        mgr = _fresh_manager(env, acct_path)
        if not mgr.accounts:
            _seed(env, mgr)
        _, sched, _ = _build(env, config=dict(backfill=False),
                             accounts=mgr)
        if recovered:
            sched.recover(recovered, now=100.0)
        sched.wal = env.wal.WriteAheadLog(wal_path)
        return sched

    s1 = build()
    spec = env.ctld.JobSpec(user="alice", account="hpc",
                            res=env.ctld.ResourceSpec(
                                cpu=1.0, mem_bytes=1 << 30,
                                memsw_bytes=1 << 30), sim_runtime=1e9)
    j1, j2 = s1.submit(spec, now=0.0), s1.submit(spec, now=0.1)
    out = [s1.schedule_cycle(now=1.0)]
    assert out[-1] == [j1]
    s2 = build(recovered=env.wal.WriteAheadLog.replay(wal_path))
    assert s2.running[j1].status == env.ctld.JobStatus.RUNNING
    out.append(s2.schedule_cycle(now=101.0))
    assert out[-1] == []
    s2.step_status_change(j1, env.ctld.JobStatus.COMPLETED, 0, 102.0)
    s2.process_status_changes()
    out.append(s2.schedule_cycle(now=103.0))
    assert out[-1] == [j2]
    return out + [_record(s2)]


_CASES = {
    "mixed_states": _mixed_states,
    "dead_node_requeues": _dead_node_requeues,
    "cancel_intent_survives": _cancel_intent_survives,
    "node_death_requeue_survives": _node_death_requeue_survives,
    "torn_tail": _torn_tail,
    "compact_drops_finalized": _compact_drops_finalized,
    "seq_rotation": _seq_rotation,
    "prune_segments": _prune_segments,
    "compact_absorbs_segments": _compact_absorbs_segments,
    "group_commit": _group_commit,
    "cycle_groups": _cycle_groups,
    "torn_group_tail": _torn_group_tail,
    "follower_tail": _follower_tail,
    "dep_survives_crash": _dep_survives_crash,
    "suspended_recovers": _suspended_recovers,
    "history_survives_compaction": _history_survives_compaction,
    "auto_compaction": _auto_compaction,
    "recovery_archives_tombstones": _recovery_archives_tombstones,
    "ids_never_reused": _ids_never_reused,
    "keyset_pagination": _keyset_pagination,
    "hierarchy_survives": _hierarchy_survives,
    "mutations_keep_persisting": _mutations_keep_persisting,
    "run_limits_after_crash": _run_limits_after_crash,
}

_PATCHED = {
    "kill_during_compact": _kill_during_compact,
    "failed_fsync_blocks_dispatch": _failed_fsync_blocks_dispatch,
    "compact_mid_group": _compact_mid_group,
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_wal_store_archive_match_jax(case, tmp_path):
    _twin(_CASES[case], tmp_path)


@pytest.mark.parametrize("case", sorted(_PATCHED))
def test_wal_crash_points_match_jax(case, tmp_path, monkeypatch):
    fn = _PATCHED[case]
    _twin(lambda env, d: fn(env, d, monkeypatch), tmp_path)


# ---------------- across packages ----------------

def _mixed_scenario(env, path, fsync=False):
    """Running, suspended, held, dependency-waiting, array, reservation,
    alloc-only with steps and a cancel intent, on 6 nodes with the
    default backfill cycle.  Returns (scheduler, simulated cluster);
    the WAL at ``path`` is closed as in a crash (no compaction)."""
    wal = env.wal.WriteAheadLog(path, fsync=fsync)
    meta, sched, sim = _build(env, num_nodes=6, wal=wal, config={})
    meta.create_reservation("maint", "default", ["cn04", "cn05"],
                            20.0, 400.0, allowed_accounts=["ops"])
    S, D = _spec, env.defs
    ids = {}
    with wal.group():
        ids["a"] = sched.submit(S(env, cpu=4.0, runtime=300.0), now=0.0)
        ids["b"] = sched.submit(S(env, cpu=4.0, runtime=8.0), now=0.0)
        ids["held"] = sched.submit(S(env, held=True), now=0.0)
        ids["dep"] = sched.submit(S(env, dependencies=(
            D.Dependency(ids["a"], D.DepType.AFTER_OK),)), now=0.0)
        ids["dep_b"] = sched.submit(S(env, runtime=20.0, dependencies=(
            D.Dependency(ids["b"], D.DepType.AFTER_ANY, 5.0),)), now=0.0)
        ids["begin"] = sched.submit(S(env, begin_time=50.0), now=0.0)
        ids["arr"] = sched.submit(S(env, cpu=2.0, runtime=30.0,
                                    array=D.ArraySpec(0, 5, 2)), now=0.0)
        ids["resv"] = sched.submit(S(env, cpu=8.0, account="ops",
                                     reservation="maint", time_limit=100,
                                     runtime=60.0), now=0.0)
        ids["alloc"] = sched.submit(S(env, cpu=4.0, alloc_only=True,
                                      time_limit=3600), now=0.0)
        ids["susp"] = sched.submit(S(env, cpu=2.0, runtime=500.0), now=0.0)
        ids["cancel"] = sched.submit(S(env, cpu=1.0, runtime=900.0),
                                     now=0.0)
    for t in (1.0, 2.0, 3.0):
        sched.schedule_cycle(now=t)
    alloc = ids["alloc"]
    step_spec = env.ctld.StepSpec
    sched.submit_step(alloc, step_spec(name="s0", sim_runtime=4.0,
                                       sim_exit_code=3), now=4.0)
    sched.submit_step(alloc, step_spec(name="s1", sim_runtime=1e6), now=4.0)
    sched.submit_step(alloc, step_spec(name="s2", sim_runtime=1e6), now=4.0)
    sched.suspend(ids["susp"], now=5.0)
    for t in (10.0, 21.0, 30.0):
        sim.advance_to(t)
        sched.schedule_cycle(now=t)
    # the cancel intent: the kill is issued, its confirmation is queued
    # and never drained before the crash
    sched.dispatch_terminate = lambda job_id, now, **kw: None
    sched.cancel(ids["cancel"], now=31.0)
    wal.close()
    return sched, sim, ids


def _recover(env, path, now, confirm_kills=True):
    meta, sched, sim = _build(env, num_nodes=6, config={})
    meta.create_reservation("maint", "default", ["cn04", "cn05"],
                            20.0, 400.0, allowed_accounts=["ops"])
    if not confirm_kills:
        sched.dispatch_terminate = lambda job_id, now, **kw: None
    sched.recover(env.wal.WriteAheadLog.replay(path), now=now)
    sched.rebuild_device_state()
    return sched, sim


def _lines(path):
    with open(path) as fh:
        return fh.read().splitlines()


def test_mixed_scenario_writes_identical_wal(tmp_path):
    """Field for field: the same scenario writes the same WAL bytes from
    either scheduler."""
    paths = [str(tmp_path / f"{e.name}.wal") for e in (JAX, PORT)]
    recs = [_record(_mixed_scenario(e, p)[0])
            for e, p in zip((JAX, PORT), paths)]
    assert recs[0] == recs[1]
    j, t = _lines(paths[0]), _lines(paths[1])
    assert len(j) > 25 and j == t
    kinds = {json.loads(line)["job"]["status"] for line in t}
    assert {"PENDING", "RUNNING", "SUSPENDED", "COMPLETED"} <= kinds


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax_to_port", "port_to_jax"])
def test_wal_replays_across_packages(tmp_path, writer, reader):
    """A WAL written by one package replays into the other: the
    recovered state equals the writer package's own recovery, and the
    first cycle after it places the same jobs."""
    path = str(tmp_path / "w.wal")
    _mixed_scenario(writer, path)
    out = []
    for env in (writer, reader):
        sched, _ = _recover(env, path, now=40.0)
        rec = _record(sched)
        started = sched.schedule_cycle(now=40.0)
        out.append([rec, started, _record(sched)])
    assert out[0] == out[1]
    rec = out[1][0]
    statuses = {j[1] for part in ("pending", "running") for j in rec[part]}
    assert {"RUNNING", "SUSPENDED", "PENDING"} <= statuses


def _twin_question(env, tmp_path):
    """Crash after a cycle, recover, then run the next cycle on the
    recovered scheduler and on the one that did not crash."""
    path = str(tmp_path / f"{env.name}.wal")
    twin, _sim, ids = _mixed_scenario(env, path)
    twin.wal = None      # its log is closed: the twin runs on alone
    # the recovered side's node plane loses its kills like the twin's
    rec, _ = _recover(env, path, now=31.0, confirm_kills=False)

    def state(sched):
        # id, status, nodes, held, requeue count, cancel intent,
        # dependency edges, array bookkeeping; steps apart
        return {part: sorted((j[0], j[1], j[2], j[3], j[4], j[5], j[9],
                              j[10], j[11]) for j in r)
                for part, r in _record(sched).items() if part != "avail"}

    def steps(sched):
        return {jid: [(s.step_id, s.status.name, s.exit_code)
                      for s in j.steps.values()]
                for jid, j in sorted(sched.running.items())}

    before = [state(twin), state(rec), steps(twin), steps(rec),
              twin.meta.snapshot()[0].tolist(),
              rec.meta.snapshot()[0].tolist()]
    # no simulated time passes: the begin-time job becomes eligible
    a, b = twin.schedule_cycle(now=60.0), rec.schedule_cycle(now=60.0)
    reasons = [{jid: j.pending_reason.name for jid, j in s.pending.items()}
               for s in (twin, rec)]
    nodes = [{jid: j.node_ids for jid, j in s.running.items()}
             for s in (twin, rec)]
    return before, [a, b], reasons, nodes, ids


def test_recover_then_cycle_matches_twin(tmp_path):
    """The recovered scheduler equals the one that did not crash (jobs,
    nodes, holds, requeue counts, cancel intents, dependency edges,
    array bookkeeping, step statuses, the ledger), and the next cycle
    starts the same jobs on the same nodes with the same pending reasons
    — in both packages, with equal results.

    One divergence is the JAX package's own: a step that an allocation
    starts because an earlier step ended is not logged (``step_report``
    writes the job before ``_try_start_steps``), so it recovers PENDING
    while it runs on the twin."""
    res = [_twin_question(env, tmp_path) for env in (JAX, PORT)]
    assert res[0] == res[1]
    before, started, reasons, nodes, ids = res[1]
    assert before[0] == before[1] and before[4] == before[5]
    twin_steps, rec_steps = before[2], before[3]
    alloc = ids["alloc"]
    assert twin_steps[alloc][1] == (1, "RUNNING", None)
    assert rec_steps[alloc][1] == (1, "PENDING", None)
    rec_steps[alloc][1] = twin_steps[alloc][1]
    assert twin_steps == rec_steps
    assert started[0] == started[1] and started[0]
    assert reasons[0] == reasons[1] and nodes[0] == nodes[1]


def _compacted_dependee(env, d):
    """A dependee that finished and was compacted out of the WAL (its
    record is in the archive) is gone from a recovered scheduler's
    memory: the JAX package's ``recover`` re-derives the waiting edge
    from ``job_info``, finds nothing and marks it never satisfied, while
    the scheduler that did not crash runs the dependent."""
    sched, sim, wal, archive = _archived(env, d)
    D = env.defs
    a = sched.submit(_spec(env, runtime=5.0), now=0.0)
    b = sched.submit(_spec(env, dependencies=(
        D.Dependency(a, D.DepType.AFTER_OK),)), now=0.0)
    sched.schedule_cycle(now=1.0)
    sched._finalized_since_compact = 999   # a's end compacts the WAL
    sim.advance_to(10.0)
    sched.process_status_changes()
    wal.close()
    sched.wal = None
    assert a in archive and a not in env.wal.WriteAheadLog.replay(wal.path)
    rec, _, _, _ = _archived(env, d)
    rec.recover(env.wal.WriteAheadLog.replay(wal.path), now=10.0)
    assert rec.job_info(a) is None
    out = [dict(sched.pending[b].dep_state), dict(rec.pending[b].dep_state),
           sched.schedule_cycle(now=11.0), rec.schedule_cycle(now=11.0),
           rec.pending[b].pending_reason.name]
    assert out[0] == {a: 6.0} and out[1] == {a: float("inf")}
    assert out[2] == [b] and out[3] == []
    assert out[4] == "DEPENDENCY_NEVER_SATISFIED"
    return out


def _requeued_ties(env, d):
    """A requeued job goes back to the end of the twin's queue; a
    recovery rebuilds the queue in id order.  Ties in priority break by
    queue position, so the next cycle starts a different one of two
    equal jobs — unless the twin's queues are put in id order too."""
    results = []
    for reorder in (False, True):
        path = str(d / f"w{int(reorder)}.wal")
        wal = env.wal.WriteAheadLog(path, fsync=False)
        _, sched, _ = _build(env, num_nodes=2, wal=wal,
                             config=dict(backfill=False))
        ids = [sched.submit(_spec(env, cpu=8.0, runtime=1e6), now=0.0)
               for _ in range(3)]
        sched.schedule_cycle(now=1.0)       # ids[0], ids[1] run
        assert sched.requeue(ids[0], now=2.0) == ""
        wal.close()
        sched.wal = None
        _, rec, _ = _build(env, num_nodes=2, config=dict(backfill=False))
        rec.recover(env.wal.WriteAheadLog.replay(path), now=2.0)
        if reorder:
            for col in (sched.pending, sched.running):
                items = sorted(col.items())
                col.clear()
                for jid, job in items:
                    col[jid] = job
        results.append([list(sched.pending), list(rec.pending),
                        sched.schedule_cycle(now=3.0),
                        rec.schedule_cycle(now=3.0)])
    (tq, rq, ts, rs), (tq2, rq2, ts2, rs2) = results
    assert tq == [3, 1] and rq == [1, 3] and ts == [3] and rs == [1]
    assert tq2 == rq2 == [1, 3] and ts2 == rs2 == [1]
    return results


@pytest.mark.parametrize("case", ["compacted_dependee", "requeued_ties"])
def test_recovery_divergences_match_jax(case, tmp_path):
    """What a recovered scheduler does not reproduce, in both packages
    alike: the divergences ``chip_smoke.py``'s restart phase accounts
    for before it holds the recovered scheduler against its twin."""
    _twin({"compacted_dependee": _compacted_dependee,
           "requeued_ties": _requeued_ties}[case], tmp_path)
