"""Exit test of slice 1: the port's scheduling cycle against the JAX
package's, through the public JobScheduler + SimCluster path.

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
"""

import numpy as np
import pytest

from cranesched_tpu import ctld as jctld
from cranesched_tpu.craned.sim import SimCluster as JSimCluster
from cranesched_tpu_torch import ctld as tctld
from cranesched_tpu_torch.craned.sim import SimCluster as TSimCluster

NUM_NODES = 512
NUM_JOBS = 3000


def _node_specs(overlap):
    rng = np.random.default_rng(0)
    specs = []
    for i in range(NUM_NODES):
        parts = (f"p{i % 4}",) + (("all",) if overlap else ())
        specs.append((f"cn{i}", int(rng.integers(8, 65)),
                      int(rng.integers(16, 129)) << 30, parts))
    return specs


def _job_specs(pkg, overlap):
    rng = np.random.default_rng(1)
    out = []
    for _ in range(NUM_JOBS):
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


def _build(pkg, sim_cls, overlap, incremental, **sched_kw):
    meta = pkg.MetaContainer()
    for name, cpu, mem, parts in _node_specs(overlap):
        node = meta.add_node(name, meta.layout.encode(
            cpu=cpu, mem_bytes=mem, memsw_bytes=256 << 30,
            is_capacity=True), partitions=parts)
        meta.craned_up(node.node_id)
    meta.craned_down(3)  # a dead node exercises the alive mask
    cfg = dict(backfill=False, incremental=incremental)
    if pkg is jctld:
        cfg["solver"] = "device"
    sched = pkg.JobScheduler(meta, pkg.SchedulerConfig(**cfg), **sched_kw)
    sim = sim_cls(sched)
    sim.wire(sched)
    for i, spec in enumerate(_job_specs(pkg, overlap)):
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
