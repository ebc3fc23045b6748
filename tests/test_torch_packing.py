"""The port's packed solve (``cranesched_tpu_torch/models/packing.py``)
against the JAX package's ``solve_packed``, bit for bit on the CPU:
placed, nodes, tasks, reason and the final avail/cost, on the cases of
``tests/test_packing_parity.py`` and on random batches.  A batch with no
packed job equals ``solve_greedy``.  The scheduler's packed route
(packed, exclusive and plain jobs in one cycle) gives the JAX
scheduler's started set, nodes, task layouts, reasons and ledger."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cranesched_tpu import ctld as jctld
from cranesched_tpu.craned.sim import SimCluster as JSimCluster
from cranesched_tpu.models import packing as jpacking
from cranesched_tpu.models.solver import make_cluster_state as j_state
from cranesched_tpu.ops.resources import ResourceLayout
from cranesched_tpu_torch import ctld as tctld
from cranesched_tpu_torch.craned.sim import SimCluster as TSimCluster
from cranesched_tpu_torch.models import packing as tpacking
from cranesched_tpu_torch.models.solver import (
    JobBatch,
    make_cluster_state,
    solve_greedy,
)

LAY = ResourceLayout()
_FIELDS = ("node_req", "task_req", "ntasks", "ntasks_min", "ntasks_max",
           "node_num", "time_limit", "part_mask", "exclusive", "valid")
_DTYPES = (np.int32, np.int32, np.int32, np.int32, np.int32, np.int32,
           np.int32, bool, bool, bool)


def job(node_req=None, task_req=None, ntasks=1, ntasks_min=1,
        ntasks_max=1, node_num=1, time_limit=3600, part_mask=None,
        exclusive=False, valid=True, num_nodes=1):
    return dict(
        node_req=node_req if node_req is not None else LAY.encode(),
        task_req=task_req if task_req is not None else LAY.encode(),
        ntasks=ntasks, ntasks_min=ntasks_min, ntasks_max=ntasks_max,
        node_num=node_num, time_limit=time_limit,
        part_mask=(part_mask if part_mask is not None
                   else np.ones(num_nodes, bool)),
        exclusive=exclusive, valid=valid)


def _cols(jobs):
    return [np.asarray([j[f] for j in jobs], dt)
            for f, dt in zip(_FIELDS, _DTYPES)]


def run_both(state_np, jobs, max_nodes):
    """Both solves on the same inputs; asserts bitwise equality and
    returns the port's placements as numpy."""
    avail, total, alive, cost = state_np
    cols = _cols(jobs)
    jp, js = jpacking.solve_packed(
        j_state(avail, total, alive, cost),
        jpacking.PackedJobBatch(*(jnp.asarray(c) for c in cols)),
        max_nodes=max_nodes)
    tp, ts = tpacking.solve_packed(
        make_cluster_state(avail, total, alive, cost, device="cpu"),
        tpacking.PackedJobBatch(*(torch.from_numpy(c) for c in cols)),
        max_nodes=max_nodes)
    for what, a, b in (("placed", jp.placed, tp.placed),
                       ("nodes", jp.nodes, tp.nodes),
                       ("tasks", jp.tasks, tp.tasks),
                       ("reason", jp.reason, tp.reason),
                       ("avail", js.avail, ts.avail),
                       ("cost", js.cost, ts.cost)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    return {k: getattr(tp, k).numpy() for k in ("placed", "nodes", "tasks",
                                                "reason")}


def fresh(num_nodes, cpu=16, mem_gb=32):
    total = np.tile(LAY.encode(cpu=cpu, mem_bytes=mem_gb << 30,
                               is_capacity=True), (num_nodes, 1))
    return (total.copy(), total, np.ones(num_nodes, bool),
            np.zeros(num_nodes, np.int32))


def test_tasks_pack_onto_fewest_needed_nodes():
    p = run_both(fresh(2), [job(task_req=LAY.encode(cpu=2.0), ntasks=6,
                                ntasks_max=8, node_num=2, num_nodes=2)], 2)
    assert p["placed"][0] and sorted(p["tasks"][0].tolist()) == [1, 5]


def test_ntasks_max_caps_per_node():
    p = run_both(fresh(3), [job(task_req=LAY.encode(cpu=1.0), ntasks=9,
                                ntasks_max=3, node_num=3, num_nodes=3)], 3)
    assert p["placed"][0] and p["tasks"][0].tolist() == [3, 3, 3]


def test_insufficient_combined_capacity_fails():
    p = run_both(fresh(2, cpu=4), [job(task_req=LAY.encode(cpu=2.0),
                                       ntasks=8, ntasks_max=8, node_num=2,
                                       num_nodes=2)], 2)
    assert not p["placed"][0] and p["reason"][0] == 1


def test_exclusive_requires_idle_node_and_takes_all():
    avail, total, alive, cost = fresh(2, cpu=8)
    avail[0] = avail[0] - LAY.encode(cpu=1.0)
    p = run_both((avail, total, alive, cost),
                 [job(node_req=LAY.encode(cpu=1.0), exclusive=True,
                      num_nodes=2),
                  job(node_req=LAY.encode(cpu=1.0), num_nodes=2)], 1)
    assert p["placed"][0] and p["nodes"][0, 0] == 1
    assert p["nodes"][1, 0] == 0


def test_min_tasks_per_node_enforced():
    p = run_both(fresh(2, cpu=4), [job(task_req=LAY.encode(cpu=2.0),
                                       ntasks=8, ntasks_min=4, ntasks_max=8,
                                       node_num=2, num_nodes=2)], 2)
    assert not p["placed"][0]


def test_node_req_plus_task_req_combined():
    p = run_both(fresh(1, cpu=8), [job(node_req=LAY.encode(cpu=1.0),
                                       task_req=LAY.encode(cpu=2.0),
                                       ntasks=3, ntasks_max=4,
                                       num_nodes=1)], 1)
    assert p["placed"][0] and p["tasks"][0, 0] == 3


def _random_case(seed, N=12, J=40):
    rng = np.random.default_rng(seed)
    total = np.stack([
        LAY.encode(cpu=int(rng.integers(8, 33)),
                   mem_bytes=int(rng.integers(16, 65)) << 30,
                   is_capacity=True) for _ in range(N)])
    avail = total.copy()
    avail[rng.random(N) < 0.3] //= 2       # some nodes partly used
    alive = rng.random(N) > 0.1
    cost = rng.integers(0, 50, N).astype(np.int32)
    jobs = []
    for _ in range(J):
        nn = int(rng.integers(1, 4))
        nt_min = int(rng.integers(1, 3))
        nt_max = nt_min + int(rng.integers(0, 4))
        jobs.append(job(
            node_req=LAY.encode(cpu=float(rng.integers(0, 3)),
                                mem_bytes=int(rng.integers(0, 3)) << 30),
            task_req=LAY.encode(cpu=float(rng.integers(1, 5)),
                                mem_bytes=int(rng.integers(0, 5)) << 30),
            ntasks=int(rng.integers(nn, nn * nt_max + 1)),
            ntasks_min=nt_min, ntasks_max=nt_max, node_num=nn,
            time_limit=int(rng.integers(60, 86400)),
            part_mask=rng.random(N) > 0.15,
            exclusive=bool(rng.random() < 0.15),
            valid=bool(rng.random() > 0.05), num_nodes=N))
    return (avail, total, alive, cost), jobs


@pytest.mark.parametrize("seed", range(8))
def test_random_packed_parity(seed):
    state, jobs = _random_case(seed)
    p = run_both(state, jobs, max_nodes=4)
    assert p["placed"].any()


def test_no_packed_job_equals_solve_greedy():
    """ntasks == node_num, no task_req, nothing exclusive: exactly
    solve_greedy's placements and final state."""
    rng = np.random.default_rng(7)
    (avail, total, alive, cost), _ = _random_case(7, N=16)
    J = 60
    req = np.stack([LAY.encode(cpu=float(rng.integers(1, 9)),
                               mem_bytes=int(rng.integers(1, 9)) << 30)
                    for _ in range(J)])
    nn = rng.integers(1, 4, J).astype(np.int32)
    tl = rng.integers(60, 86400, J).astype(np.int32)
    pm = rng.random((J, 16)) > 0.2
    valid = np.ones(J, bool)
    jobs = [job(node_req=req[i], ntasks=int(nn[i]), node_num=int(nn[i]),
                time_limit=int(tl[i]), part_mask=pm[i]) for i in range(J)]
    p = run_both((avail, total, alive, cost), jobs, max_nodes=3)
    gp, gs = solve_greedy(
        make_cluster_state(avail, total, alive, cost, device="cpu"),
        JobBatch(*(torch.from_numpy(x) for x in (req, nn, tl, pm, valid))),
        max_nodes=3)
    np.testing.assert_array_equal(p["placed"], gp.placed.numpy())
    np.testing.assert_array_equal(p["nodes"], gp.nodes.numpy())
    np.testing.assert_array_equal(p["reason"], gp.reason.numpy())
    np.testing.assert_array_equal(p["tasks"], np.where(
        gp.nodes.numpy() >= 0, 1, 0))
    ts = make_cluster_state(avail, total, alive, cost, device="cpu")
    tpacking.solve_packed(ts, tpacking.PackedJobBatch(
        *(torch.from_numpy(c) for c in _cols(jobs))), max_nodes=3)
    np.testing.assert_array_equal(ts.avail.numpy(), gs.avail.numpy())
    np.testing.assert_array_equal(ts.cost.numpy(), gs.cost.numpy())


def test_empty_batch():
    avail, total, alive, cost = fresh(4)
    cols = [np.zeros((0,) + ((3,) if f.endswith("req") else (4,)
                             if f == "part_mask" else ()), dt)
            for f, dt in zip(_FIELDS, _DTYPES)]
    p, s = tpacking.solve_packed(
        make_cluster_state(avail, total, alive, cost, device="cpu"),
        tpacking.PackedJobBatch(*(torch.from_numpy(c) for c in cols)),
        max_nodes=2)
    assert p.nodes.shape == (0, 2) and p.tasks.shape == (0, 2)
    np.testing.assert_array_equal(s.avail.numpy(), avail)


# ------------------------------------------------------ the scheduler


def _packed_cluster(pkg, sim_cls, backfill, **kw):
    rng = np.random.default_rng(0)
    meta = pkg.MetaContainer()
    for i in range(48):
        node = meta.add_node(f"cn{i}", meta.layout.encode(
            cpu=int(rng.integers(8, 33)), mem_bytes=64 << 30,
            memsw_bytes=64 << 30, is_capacity=True),
            partitions=(f"p{i % 2}",))
        meta.craned_up(node.node_id)
    meta.craned_down(7)
    cfg = dict(backfill=backfill)
    if pkg is jctld:
        cfg["solver"] = "device"
    sched = pkg.JobScheduler(meta, pkg.SchedulerConfig(**cfg), **kw)
    sim = sim_cls(sched)
    sim.wire(sched)
    rng = np.random.default_rng(1)
    for i in range(260):
        kind = rng.random()
        nn = int(rng.integers(1, 4))
        shape = {}
        if kind < 0.25:       # packed: tasks over the gang
            nt_max = int(rng.integers(2, 6))
            shape = dict(task_res=pkg.ResourceSpec(
                cpu=float(rng.integers(1, 3)), mem_bytes=1 << 30),
                ntasks=int(rng.integers(nn, nn * nt_max + 1)),
                ntasks_per_node_max=nt_max)
        elif kind < 0.32:
            shape = dict(exclusive=True)
        assert sched.submit(pkg.JobSpec(
            res=pkg.ResourceSpec(cpu=float(rng.integers(1, 5)),
                                 mem_bytes=int(rng.integers(1, 9)) << 30),
            partition=f"p{int(rng.integers(0, 2))}", node_num=nn,
            time_limit=int(rng.integers(120, 7200)),
            qos_priority=int(rng.integers(0, 3)),
            sim_runtime=float(rng.integers(30, 900)), **shape),
            now=i * 1e-3) > 0
    return sched, sim


@pytest.mark.parametrize("backfill", [False, True],
                         ids=["immediate", "backfill"])
def test_packed_cycle_matches_jax_scheduler(backfill):
    """A cycle holding packed and exclusive jobs takes the packed route:
    the same started set, nodes, task layouts, pending reasons and
    ledger as the JAX scheduler, over three cycles with completions."""
    sides = [_packed_cluster(jctld, JSimCluster, backfill),
             _packed_cluster(tctld, TSimCluster, backfill, device="cpu")]
    now = 10.0
    for cycle in range(3):
        if cycle:
            now += 300.0
            for sched, sim in sides:
                sim.advance_to(now)
        started = [s.schedule_cycle(now=now) for s, _ in sides]
        assert started[0] == started[1] and started[0], cycle
        out = []
        for sched, _ in sides:
            out.append((
                {jid: (sorted(j.node_ids), list(j.task_layout))
                 for jid, j in sched.running.items()},
                {jid: str(j.pending_reason.value)
                 for jid, j in sched.pending.items()},
                np.stack([n.avail for _, n in
                          sorted(sched.meta.nodes.items())]).tolist(),
                sorted(sched.history)))
        assert out[0] == out[1], f"cycle {cycle} differs"
        port = sides[1][0]
        assert port.stats["last_cycle"]["solver"] == "packed"
        for job in port.running.values():
            spec = job.spec
            if spec.task_res is not None:
                assert sum(job.task_layout) == spec.ntasks
                assert all(1 <= t <= spec.ntasks_per_node_max
                           for t in job.task_layout)
            if spec.exclusive:
                for n in job.node_ids:
                    assert (port.meta.nodes[n].avail == 0).all()
