"""The port's node-axis-sharded solves against the JAX package's, bit for
bit (the cases of ``tests/test_sharded_parity.py`` and more).

The JAX side runs on the 8-device CPU mesh of ``tests/conftest.py``; the
port's mesh is eight CPU shards, ``(torch.device("cpu"),) * 8``.  Placed,
nodes, reason, avail and the int32 cost ledger must be identical to the
JAX sharded solve and to the port's single-device ``solve_greedy``.  The
scheduler cases run ``SchedulerConfig(solver="sharded")`` cycles on a
cluster whose node count does not divide the mesh (the dead-node pad)
against the JAX scheduler's sharded cycles and the port's ``device``
twin.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cranesched_tpu import ctld as jctld
from cranesched_tpu.craned.sim import SimCluster as JSimCluster
from cranesched_tpu.models import solver as jsolver
from cranesched_tpu.ops.resources import ResourceLayout
from cranesched_tpu.parallel import sharded as jsharded
from cranesched_tpu_torch import convert
from cranesched_tpu_torch import ctld as tctld
from cranesched_tpu_torch.craned.sim import SimCluster as TSimCluster
from cranesched_tpu_torch.models import solver as tsolver
from cranesched_tpu_torch.parallel import sharded as tsharded
from test_multihost import _problem
from test_sharded_parity import _random_problem

CPU8 = (torch.device("cpu"),) * 8


def _port_state(jstate):
    return convert.cluster_state(
        np.asarray(jstate.avail), np.asarray(jstate.total),
        np.asarray(jstate.alive), np.asarray(jstate.cost), device="cpu")


def _port_jobs(jjobs):
    return convert.job_batch(
        np.asarray(jjobs.req), np.asarray(jjobs.node_num),
        np.asarray(jjobs.time_limit), np.asarray(jjobs.part_mask),
        np.asarray(jjobs.valid), device="cpu")


def _assert_same(jp, js, tp, ts):
    np.testing.assert_array_equal(np.asarray(jp.placed), tp.placed.numpy())
    np.testing.assert_array_equal(np.asarray(jp.nodes), tp.nodes.numpy())
    np.testing.assert_array_equal(np.asarray(jp.reason), tp.reason.numpy())
    np.testing.assert_array_equal(np.asarray(js.avail), ts.avail.numpy())
    np.testing.assert_array_equal(np.asarray(js.cost), ts.cost.numpy())
    assert tp.nodes.dtype == torch.int32 and ts.cost.dtype == torch.int32


def _three_ways(jstate, jjobs, max_nodes):
    """The JAX sharded solve, the port's sharded solve and the port's
    solve_greedy on the same inputs: all three must agree."""
    mesh = jsharded.make_node_mesh()
    jp, js = jsharded.solve_greedy_sharded(
        jsharded.shard_cluster_state(jstate, mesh), jjobs, mesh,
        max_nodes=max_nodes)
    tp, ts = tsharded.solve_greedy_sharded(
        _port_state(jstate), _port_jobs(jjobs), CPU8, max_nodes=max_nodes)
    gp, gs = tsolver.solve_greedy(_port_state(jstate), _port_jobs(jjobs),
                                  max_nodes=max_nodes)
    _assert_same(jp, js, tp, ts)
    _assert_same(jp, js, gp, gs)
    return tp, ts


def test_mesh_is_an_ordered_tuple_of_devices():
    mesh = tsharded.make_node_mesh(["cpu"] * 8)
    assert mesh == CPU8 and len(mesh) == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsharded.make_node_mesh()
    state = tsolver.make_cluster_state(np.ones((12, 3), np.int32),
                                       np.ones((12, 3), np.int32),
                                       np.ones(12, bool), device="cpu")
    with pytest.raises(ValueError, match="pad with dead nodes"):
        tsharded.shard_cluster_state(state, CPU8)
    # slabs on the state's own device are views: the solve writes through
    sh = tsharded.shard_cluster_state(state, CPU8[:4])
    assert sh.base is state and sh.local_n == 3
    sh.shards[1].cost += 7
    assert state.cost.tolist() == [0] * 3 + [7] * 3 + [0] * 6


@pytest.mark.parametrize("seed", range(4))
def test_sharded_matches_jax_and_single_device(seed):
    rng = np.random.default_rng(seed)
    jstate, jjobs = _random_problem(rng, num_jobs=64, num_nodes=64,
                                    max_nodes=4)
    _three_ways(jstate, jjobs, 4)


def test_sharded_gang_spanning_shards():
    """A gang of 8 on 16 nodes in 8 shards of 2: every shard offers fewer
    candidates than the gang needs, and the winners span shards."""
    lay = ResourceLayout()
    total = np.tile(lay.encode(cpu=16, mem_bytes=32 << 30,
                               is_capacity=True), (16, 1))
    jstate = jsolver.make_cluster_state(
        total.copy(), total, np.ones(16, bool),
        np.arange(16, dtype=np.float32)[::-1].copy())
    jjobs = jsolver.JobBatch(
        req=jnp.asarray(np.tile(lay.encode(cpu=16, mem_bytes=32 << 30),
                                (1, 1))),
        node_num=jnp.asarray([8], jnp.int32),
        time_limit=jnp.asarray([3600], jnp.int32),
        part_mask=jnp.ones((1, 16), bool), valid=jnp.ones(1, bool))
    tp, _ = _three_ways(jstate, jjobs, 8)
    assert sorted(tp.nodes[0].tolist()) == list(range(8, 16))


def test_sharded_cost_tie_breaks_to_lowest_global_index():
    lay = ResourceLayout()
    total = np.tile(lay.encode(cpu=8, is_capacity=True), (16, 1))
    jstate = jsolver.make_cluster_state(total.copy(), total,
                                        np.ones(16, bool),
                                        np.zeros(16, np.float32))
    jjobs = jsolver.JobBatch(
        req=jnp.asarray(np.tile(lay.encode(cpu=1), (3, 1))),
        node_num=jnp.asarray([3, 1, 2], jnp.int32),
        time_limit=jnp.asarray([60, 60, 60], jnp.int32),
        part_mask=jnp.ones((3, 16), bool), valid=jnp.ones(3, bool))
    tp, _ = _three_ways(jstate, jjobs, 3)
    assert tp.nodes[0].tolist() == [0, 1, 2]


def test_sharded_second_cycle_reuses_sharded_state():
    rng = np.random.default_rng(99)
    jstate, jjobs = _random_problem(rng, num_jobs=32, num_nodes=32,
                                    max_nodes=2)
    mesh = jsharded.make_node_mesh()
    _, js = jsharded.solve_greedy_sharded(
        jsharded.shard_cluster_state(jstate, mesh), jjobs, mesh,
        max_nodes=2)
    _, ts = tsharded.solve_greedy_sharded(_port_state(jstate),
                                          _port_jobs(jjobs), CPU8,
                                          max_nodes=2)
    _, jjobs2 = _random_problem(rng, num_jobs=32, num_nodes=32,
                                max_nodes=2)
    jp2, js2 = jsharded.solve_greedy_sharded(js, jjobs2, mesh, max_nodes=2)
    tp2, ts2 = tsharded.solve_greedy_sharded(ts, _port_jobs(jjobs2), CPU8,
                                             max_nodes=2)
    assert isinstance(ts2, tsharded.ShardedClusterState)
    _assert_same(jp2, js2, tp2, ts2)


def _classes_args(pb):
    return (torch.from_numpy(pb["req"]), torch.from_numpy(pb["node_num"]),
            torch.from_numpy(pb["time_limit"]),
            torch.from_numpy(pb["valid"]),
            torch.from_numpy(pb["job_class"]))


@pytest.mark.parametrize("disjoint", [False, True],
                         ids=["overlapping", "disjoint"])
@pytest.mark.parametrize("seed", [0, 1])
def test_sharded_classes_matches_jax(seed, disjoint):
    """The streamed class-table solve (S streams a step on a disjoint
    table, S = 1 on an overlapping one) against the JAX one."""
    max_nodes = 3
    pb = _problem(seed, num_jobs=96, num_nodes=48, num_classes=4,
                  max_nodes=max_nodes, disjoint=disjoint)
    jstate = jsolver.make_cluster_state(pb["avail"], pb["total"],
                                        pb["alive"], pb["cost"])
    mesh = jsharded.make_node_mesh()
    jp, js = jsharded.solve_greedy_sharded_classes(
        jsharded.shard_cluster_state(jstate, mesh),
        *(jnp.asarray(pb[k]) for k in ("req", "node_num", "time_limit",
                                       "valid", "job_class",
                                       "class_masks")),
        mesh, max_nodes=max_nodes)
    tp, ts = tsharded.solve_greedy_sharded_classes(
        _port_state(jstate), *_classes_args(pb),
        torch.from_numpy(pb["class_masks"]), CPU8, max_nodes=max_nodes)
    _assert_same(jp, js, tp, ts)
    from cranesched_tpu_torch.models.gpu_solver import plan_streams
    plan = plan_streams(pb["job_class"], pb["class_masks"], block_jobs=1)
    assert (plan is not None) == disjoint


def test_sharded_classes_pad_path_matches_jax_single_device():
    """46 nodes on an 8-shard mesh: padded with 2 dead nodes and False
    mask columns, the first 46 rows equal the JAX package's unsharded
    solve."""
    max_nodes = 2
    pb = _problem(5, num_jobs=80, num_nodes=46, num_classes=3,
                  max_nodes=max_nodes, disjoint=False)
    jstate = jsolver.make_cluster_state(pb["avail"], pb["total"],
                                        pb["alive"], pb["cost"])
    dense = pb["class_masks"][pb["job_class"]]
    jp, js = jsolver.solve_greedy(jstate, jsolver.JobBatch(
        req=jnp.asarray(pb["req"]), node_num=jnp.asarray(pb["node_num"]),
        time_limit=jnp.asarray(pb["time_limit"]),
        part_mask=jnp.asarray(dense), valid=jnp.asarray(pb["valid"])),
        max_nodes=max_nodes)

    def pad(x):
        return np.concatenate([x, np.zeros((2,) + x.shape[1:], x.dtype)])

    state = convert.cluster_state(pad(pb["avail"]), pad(pb["total"]),
                                  pad(pb["alive"]),
                                  pad(np.asarray(jstate.cost)),
                                  device="cpu")
    masks = np.concatenate([pb["class_masks"], np.zeros((3, 2), bool)], 1)
    tp, ts = tsharded.solve_greedy_sharded_classes(
        state, *_classes_args(pb), torch.from_numpy(masks), CPU8,
        max_nodes=max_nodes)
    np.testing.assert_array_equal(np.asarray(jp.placed), tp.placed.numpy())
    np.testing.assert_array_equal(np.asarray(jp.nodes), tp.nodes.numpy())
    np.testing.assert_array_equal(np.asarray(jp.reason), tp.reason.numpy())
    np.testing.assert_array_equal(np.asarray(js.avail),
                                  ts.avail.numpy()[:46])
    np.testing.assert_array_equal(np.asarray(js.cost), ts.cost.numpy()[:46])
    assert (ts.avail.numpy()[46:] == 0).all()


# ---- the scheduler's sharded cycle ----

NUM_NODES = 60     # 60 % 8 = 4: the scheduler pads 4 dead nodes
NUM_JOBS = 500


def _build(pkg, sim_cls, solver, overlap, **sched_kw):
    rng = np.random.default_rng(0)
    meta = pkg.MetaContainer()
    for i in range(NUM_NODES):
        parts = (f"p{i % 3}",) + (("all",) if overlap else ())
        node = meta.add_node(f"cn{i}", meta.layout.encode(
            cpu=int(rng.integers(8, 65)),
            mem_bytes=int(rng.integers(16, 129)) << 30,
            memsw_bytes=256 << 30, is_capacity=True), partitions=parts)
        meta.craned_up(node.node_id)
    meta.craned_down(5)
    sched = pkg.JobScheduler(meta, pkg.SchedulerConfig(
        backfill=False, solver=solver), **sched_kw)
    sim = sim_cls(sched)
    sim.wire(sched)
    rng = np.random.default_rng(1)
    for i in range(NUM_JOBS):
        part = f"p{int(rng.integers(0, 3))}"
        if overlap and rng.random() < 0.1:
            part = "all"
        assert sched.submit(pkg.JobSpec(
            res=pkg.ResourceSpec(cpu=float(rng.integers(4, 33)),
                                 mem_bytes=int(rng.integers(8, 65)) << 30,
                                 memsw_bytes=64 << 30),
            partition=part, node_num=int(rng.integers(1, 4)),
            time_limit=int(rng.integers(120, 86400)),
            sim_runtime=float(rng.integers(30, 400))), now=i * 1e-3) > 0
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
def test_sharded_cycle_matches_jax_and_device_twin(overlap):
    sides = [_build(jctld, JSimCluster, "sharded", overlap),
             _build(tctld, TSimCluster, "sharded", overlap, device="cpu"),
             _build(tctld, TSimCluster, "device", overlap, device="cpu")]
    sides[1][0]._mesh = CPU8
    now = 10.0
    modes = []
    for cycle in range(3):
        if cycle:
            now += 300.0
            victims = [min(sides[0][0].running), max(sides[0][0].pending)]
            for sched, sim in sides:
                sim.advance_to(now)
                for jid in victims:
                    assert sched.cancel(jid, now=now)
        started = [sched.schedule_cycle(now=now) for sched, _ in sides]
        assert started[0] == started[1] == started[2], cycle
        assert started[0], f"cycle {cycle} placed nothing"
        outs = [_outcome(sched) for sched, _ in sides]
        for out in outs[1:]:
            assert out[0] == outs[0][0], f"cycle {cycle}: nodes differ"
            np.testing.assert_array_equal(out[1], outs[0][1])
            assert out[2] == outs[0][2], f"cycle {cycle}: reasons differ"
            assert out[3] == outs[0][3]
        port = sides[1][0]
        assert port.stats["last_cycle"]["solver"] == "sharded"
        assert port.cycle_trace.snapshot()[-1]["mesh"] == "1x8"
        assert (sides[0][0].cycle_trace.snapshot()[-1]["mesh"]
                == "1x8")
        modes.append(port.stats["last_cycle"]["resident"])
    # the padded state is resident across cycles
    assert modes[0] == "rebuild" and set(modes[1:]) <= {"patch", "ledger"}
    # another mesh drops the resident state instead of patching it
    port._mesh = CPU8[:4]
    for sched, sim in sides[1:]:
        sim.advance_to(now + 300.0)
        sched.schedule_cycle(now=now + 300.0)
    assert port.stats["last_cycle"]["resident"] == "rebuild"
    assert port.cycle_trace.snapshot()[-1]["mesh"] == "1x4"
    np.testing.assert_array_equal(_outcome(port)[1],
                                  _outcome(sides[2][0])[1])


def test_yaml_solver_sharded_builds_the_sharded_scheduler(tmp_path):
    """``Scheduler: Solver: sharded`` goes where the JAX config sends it:
    both packages build a scheduler with ``solver="sharded"``, on the
    card or off it."""
    from cranesched_tpu.utils import config as jconfig
    from cranesched_tpu_torch.utils import config as tconfig

    path = tmp_path / "c.yaml"
    path.write_text("ClusterName: t\nNodes:\n  - name: \"cn[0-9]\"\n"
                    "    cpu: 8\n    memory: 16G\n    partitions: [p]\n"
                    "Partitions:\n  - name: p\nScheduler:\n"
                    "  Solver: sharded\n")
    _, jsched = jconfig.load_config(str(path)).build()
    _, tsched = tconfig.load_config(str(path)).build(device="cpu")
    assert jsched.config.solver == tsched.config.solver == "sharded"
    assert tconfig.solver_for("sharded", None) == "sharded"
