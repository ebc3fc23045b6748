"""Exit test of slices 1 and 2: the port's scheduling cycle against the
JAX package's, through the public JobScheduler + SimCluster path.

The same cluster is built twice from one spec list (512 nodes in four
disjoint partitions with one node down; a variant adds a partition
overlapping all of them) and the same ~3,000 jobs (gangs of up to 4
nodes) are submitted to the JAX ``JobScheduler(solver="device")`` and to
the port's ``JobScheduler`` on the CPU.  Three cycles run with
completions and cancels between them; after each, the started lists,
every running job's nodes, every node's avail and every pending job's
reason must be identical (some jobs fail, some of those requeue).  The
port must take the streamed plan on the disjoint cluster and the serial
plan on the overlapping one, and its resident state must reach "patch"
or "ledger".

The backfill cycle (the default configuration) runs the same way on a
smaller cluster (128 nodes, 800 jobs): once with every candidate in the
time-axis solve (label ``backfill``) and once split at 128 candidates
with a geometric grid reaching 7 days (label ``backfill-split``: the
head through the time-axis solve, the tail through the greedy kernel
against the head's min-over-horizon availability).  Future starts must
report the same ``Priority`` / ``Resource`` reasons as the JAX package.
"""

import numpy as np
import pytest

from cranesched_tpu import ctld as jctld
from cranesched_tpu.craned.sim import SimCluster as JSimCluster
from cranesched_tpu_torch import ctld as tctld
from cranesched_tpu_torch.craned.sim import SimCluster as TSimCluster

NUM_NODES = 512
NUM_JOBS = 3000


def _node_specs(overlap, num_nodes=NUM_NODES):
    rng = np.random.default_rng(0)
    specs = []
    for i in range(num_nodes):
        parts = (f"p{i % 4}",) + (("all",) if overlap else ())
        specs.append((f"cn{i}", int(rng.integers(8, 65)),
                      int(rng.integers(16, 129)) << 30, parts))
    return specs


def _job_specs(pkg, overlap, num_jobs=NUM_JOBS):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(num_jobs):
        part = f"p{int(rng.integers(0, 4))}"
        if overlap and rng.random() < 0.1:
            part = "all"
        out.append(pkg.JobSpec(
            res=pkg.ResourceSpec(cpu=float(rng.integers(4, 33)),
                                 mem_bytes=int(rng.integers(8, 65)) << 30,
                                 memsw_bytes=64 << 30),
            partition=part, node_num=int(rng.integers(1, 5)),
            time_limit=int(rng.integers(120, 86400)),
            qos_priority=int(rng.integers(0, 3)) * 10,
            account=f"acct{int(rng.integers(0, 5))}",
            sim_runtime=float(rng.integers(30, 400)),
            # some jobs fail; half of those ask to be requeued
            sim_exit_code=int(rng.random() < 0.05),
            requeue_if_failed=bool(rng.random() < 0.5)))
    return out


def _build(pkg, sim_cls, overlap, incremental, num_nodes=NUM_NODES,
           num_jobs=NUM_JOBS, cfg=None, **sched_kw):
    meta = pkg.MetaContainer()
    for name, cpu, mem, parts in _node_specs(overlap, num_nodes):
        node = meta.add_node(name, meta.layout.encode(
            cpu=cpu, mem_bytes=mem, memsw_bytes=256 << 30,
            is_capacity=True), partitions=parts)
        meta.craned_up(node.node_id)
    meta.craned_down(3)  # a dead node exercises the alive mask
    cfg = dict(cfg or dict(backfill=False), incremental=incremental)
    if pkg is jctld:
        cfg["solver"] = "device"
    sched = pkg.JobScheduler(meta, pkg.SchedulerConfig(**cfg), **sched_kw)
    sim = sim_cls(sched)
    sim.wire(sched)
    for i, spec in enumerate(_job_specs(pkg, overlap, num_jobs)):
        assert sched.submit(spec, now=i * 1e-3) > 0
    return sched, sim


def _outcome(sched):
    return (
        {jid: sorted(job.node_ids) for jid, job in sched.running.items()},
        np.stack([n.avail for _, n in sorted(sched.meta.nodes.items())]),
        {jid: str(job.pending_reason.value)
         for jid, job in sched.pending.items()},
        sorted(sched.history),
    )


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["disjoint", "overlapping"])
@pytest.mark.parametrize("incremental", [True, False],
                         ids=["incremental", "rebuild"])
def test_cycle_matches_jax_scheduler(overlap, incremental):
    jax_side = _build(jctld, JSimCluster, overlap, incremental)
    port_side = _build(tctld, TSimCluster, overlap, incremental,
                       device="cpu")
    labels, modes = [], []
    now = 10.0
    for cycle in range(3):
        if cycle:
            now += 300.0
            # the same cancels on both sides: the lowest running and
            # the highest pending job of the JAX side
            jsched = jax_side[0]
            victims = [min(jsched.running), max(jsched.pending)]
            for sched, sim in (jax_side, port_side):
                sim.advance_to(now)
                for jid in victims:
                    assert sched.cancel(jid, now=now)
        started = [sched.schedule_cycle(now=now)
                   for sched, _ in (jax_side, port_side)]
        assert started[0] == started[1], f"cycle {cycle}: started differ"
        assert started[0], f"cycle {cycle} placed nothing"
        j, t = _outcome(jax_side[0]), _outcome(port_side[0])
        assert j[0] == t[0], f"cycle {cycle}: node assignments differ"
        np.testing.assert_array_equal(j[1], t[1])
        assert j[2] == t[2], f"cycle {cycle}: pending reasons differ"
        assert j[3] == t[3], f"cycle {cycle}: finished sets differ"
        last = port_side[0].stats["last_cycle"]
        labels.append(last["solver"])
        modes.append(last["resident"])
        for key in ("prelude_ms", "priority_ms", "batch_ms", "solve_ms",
                    "commit_ms", "dispatch_ms"):
            assert last[key] >= 0.0
    want = "cuda" if overlap else "cuda-stream"
    assert labels == [want] * 3, labels
    if incremental:
        assert modes[0] == "rebuild"
        assert set(modes[1:]) <= {"patch", "ledger"}, modes
    else:
        assert modes == [None] * 3


# (id, backfill_max_jobs, time_horizon, solver label): the full timed
# path keeps the default lookahead of 1024 above the 800 candidates
_BACKFILL = [("full", 1024, None, "backfill"),
             ("split", 128, 7 * 24 * 3600.0, "backfill-split")]


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["disjoint", "overlapping"])
@pytest.mark.parametrize("mode", _BACKFILL, ids=[m[0] for m in _BACKFILL])
def test_backfill_cycle_matches_jax_scheduler(overlap, mode):
    _, bf_max, horizon, want = mode
    cfg = dict(backfill_max_jobs=bf_max, time_horizon=horizon)
    size = dict(num_nodes=128, num_jobs=800, cfg=cfg)
    jax_side = _build(jctld, JSimCluster, overlap, True, **size)
    port_side = _build(tctld, TSimCluster, overlap, True, device="cpu",
                       **size)
    assert port_side[0].config.backfill
    now = 10.0
    reasons = set()
    for cycle in range(3):
        if cycle:
            now += 300.0
            jsched = jax_side[0]
            victims = [min(jsched.running), max(jsched.pending)]
            for sched, sim in (jax_side, port_side):
                sim.advance_to(now)
                for jid in victims:
                    assert sched.cancel(jid, now=now)
        started = [sched.schedule_cycle(now=now)
                   for sched, _ in (jax_side, port_side)]
        assert started[0] == started[1], f"cycle {cycle}: started differ"
        assert started[0], f"cycle {cycle} placed nothing"
        j, t = _outcome(jax_side[0]), _outcome(port_side[0])
        assert j[0] == t[0], f"cycle {cycle}: node assignments differ"
        np.testing.assert_array_equal(j[1], t[1])
        assert j[2] == t[2], f"cycle {cycle}: pending reasons differ"
        assert j[3] == t[3], f"cycle {cycle}: finished sets differ"
        reasons |= set(t[2].values())
        last = port_side[0].stats["last_cycle"]
        assert last["solver"] == want, last["solver"]
        assert last["backfilled"] > 0
        if want == "backfill-split":
            assert last["solve_ms"] >= last["solve_tail_ms"] > 0.0
    assert str(tctld.PendingReason.RESOURCE.value) in reasons


def _reservation_scenario(pkg, sim_cls, **sched_kw):
    """Two 8-cpu nodes; a blocker holds 4 cpus of cn0 for 60 s.  The
    head (2 jobs, FIFO) is a 2-node gang that must wait for cn0 and a
    600 s job that fits cn1 now but would collide with the gang's
    reservation there; the tail is a small job that would too."""
    meta = pkg.MetaContainer()
    for i in range(2):
        meta.add_node(f"cn{i}", meta.layout.encode(
            cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True))
        meta.craned_up(i)
    cfg = dict(backfill_max_jobs=2, time_buckets=16,
               priority_type="basic")
    if pkg is jctld:
        cfg["solver"] = "device"
    sched = pkg.JobScheduler(meta, pkg.SchedulerConfig(**cfg), **sched_kw)
    sim = sim_cls(sched)
    sim.wire(sched)

    def spec(cpu, runtime, node_num=1):
        return pkg.JobSpec(res=pkg.ResourceSpec(
            cpu=cpu, mem_bytes=1 << 30, memsw_bytes=1 << 30),
            time_limit=runtime, sim_runtime=runtime, node_num=node_num)

    ids = [sched.submit(spec(4.0, 60.0), now=0.0)]
    started = [sched.schedule_cycle(now=0.5)]
    ids += [sched.submit(spec(8.0, 300.0, node_num=2), now=1.0),
            sched.submit(spec(8.0, 600.0), now=1.1),
            sched.submit(spec(4.0, 600.0), now=1.2)]
    started.append(sched.schedule_cycle(now=2.0))
    reasons = [str(sched.pending[j].pending_reason.value) for j in ids[1:]]
    sim.advance_to(65.0)
    started.append(sched.schedule_cycle(now=65.0))
    return ids, started, reasons, sched.stats["last_cycle"]["solver"]


def test_split_backfill_reservation_reasons_match_jax():
    """The split cycle's reasons for future starts: the gang lacks room
    on cn0 now (Resource); the 600 s job has room on cn1 now but waits
    for the gang's reservation (Priority); the tail job may not steal
    the reserved window.  Once the blocker ends the gang starts."""
    j = _reservation_scenario(jctld, JSimCluster)
    t = _reservation_scenario(tctld, TSimCluster, device="cpu")
    assert j == t
    ids, started, reasons, solver = t
    assert started[:2] == [[ids[0]], []]
    assert reasons == ["Resource", "Priority", "Resource"]
    assert ids[1] in started[2] and solver == "backfill-split"
