"""The JAX package's solver names in the port: the native C++ solver
(``utils/native.py``, built from the shared ``native/crane_native.cpp``
into ``build/native/``) against the JAX package's bridge and the port's
plain ``solve_greedy``, and a scheduler cycle under each of ``"auto"``,
``"native"``, ``"device"`` and ``"pallas"`` against the JAX scheduler
with the same name.
"""

import numpy as np
import pytest
import torch

import cranesched_tpu.craned.sim as jsim
import cranesched_tpu.ctld as jctld
from cranesched_tpu.utils import native as jnative
import cranesched_tpu_torch.craned.sim as tsim
import cranesched_tpu_torch.ctld as tctld
from cranesched_tpu_torch import convert
from cranesched_tpu_torch.models.solver import solve_greedy
from cranesched_tpu_torch.ops.resources import ResourceLayout
from cranesched_tpu_torch.utils import native


def _problem(rng, num_jobs, num_nodes, max_nodes, num_parts=0):
    lay = ResourceLayout()
    total = np.stack([lay.encode(cpu=int(rng.integers(8, 65)),
                                 mem_bytes=int(rng.integers(16, 257)) << 30,
                                 is_capacity=True)
                      for _ in range(num_nodes)])
    used = np.stack([lay.encode(cpu=float(rng.integers(0, 8)),
                                mem_bytes=int(rng.integers(0, 8)) << 30)
                     for _ in range(num_nodes)])
    avail = (total - np.minimum(used, total)).astype(np.int32)
    alive = rng.random(num_nodes) >= 0.1
    cost = rng.integers(0, 1 << 20, num_nodes).astype(np.int32)
    req = np.stack([lay.encode(cpu=float(rng.integers(1, 17)),
                               mem_bytes=int(rng.integers(1, 33)) << 30)
                    for _ in range(num_jobs)]).astype(np.int32)
    node_num = rng.integers(1, max_nodes + 2, num_jobs).astype(np.int32)
    time_limit = rng.integers(60, 86400, num_jobs).astype(np.int32)
    valid = rng.random(num_jobs) > 0.05
    if num_parts:
        node_part = rng.integers(0, num_parts, num_nodes).astype(np.int32)
        job_part = rng.integers(0, num_parts + 1, num_jobs).astype(np.int32)
        mask = job_part[:, None] == node_part[None, :]
    else:
        node_part = job_part = None
        mask = rng.random((num_jobs, num_nodes)) > 0.2
    return (avail, total, alive, cost, req, node_num, time_limit, valid,
            mask, job_part, node_part)


@pytest.mark.parametrize("mode", ["mask", "partition"])
@pytest.mark.parametrize("seed", range(3))
def test_native_matches_jax_bridge_and_plain(seed, mode):
    rng = np.random.default_rng(seed)
    K = 4
    (avail, total, alive, cost, req, nn, tl, valid, mask, jp,
     npart) = _problem(rng, 150, 60, K, num_parts=4 if mode != "mask"
                       else 0)
    kw = (dict(mask=mask) if mode == "mask"
          else dict(job_part=jp, node_part=npart))
    args = (avail, total, alive.astype(np.uint8), cost, req, nn, tl,
            valid.astype(np.uint8))
    got = native.solve_greedy_native(*args, max_nodes=K, **kw)
    want = jnative.solve_greedy_native(*args, max_nodes=K, **kw)
    assert got is not None and want is not None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # and the port's plain solve on the same inputs
    state = convert.cluster_state(avail, total, alive, cost, device="cpu")
    jobs = convert.job_batch(req, nn, tl, mask, valid, device="cpu")
    p, s = solve_greedy(state, jobs, max_nodes=K)
    np.testing.assert_array_equal(got[0], p.placed.numpy())
    np.testing.assert_array_equal(got[1], p.nodes.numpy())
    np.testing.assert_array_equal(got[2], p.reason.numpy())
    np.testing.assert_array_equal(got[3], s.avail.numpy())
    np.testing.assert_array_equal(got[4], s.cost.numpy())


def test_native_refuses_what_it_cannot_take():
    """Beyond 16 dimensions or with negative partition ids the bridge
    returns None before any build (the caller falls back)."""
    z = np.zeros((2, 17), np.int32)
    assert native.solve_greedy_native(
        z, z, np.ones(2, np.uint8), np.zeros(2, np.int32), z[:1],
        np.ones(1, np.int32), np.ones(1, np.int32), np.ones(1, np.uint8),
        max_nodes=1, mask=np.ones((1, 2), bool)) is None
    y = np.zeros((2, 3), np.int32)
    assert native.solve_greedy_native(
        y, y, np.ones(2, np.uint8), np.zeros(2, np.int32), y[:1],
        np.ones(1, np.int32), np.ones(1, np.int32), np.ones(1, np.uint8),
        max_nodes=1, job_part=np.array([-1], np.int32),
        node_part=np.zeros(2, np.int32)) is None


def test_library_lands_in_the_port_build_cache():
    assert native.available()
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "native")
    assert native.parse_hostlist("cn[01-03]") == ["cn01", "cn02", "cn03"]
    assert native.compress_hostlist(["cn01", "cn02", "cn03"]) == "cn[01-03]"


def _cycle(pkg, sim_mod, solver, num_nodes, backfill=False, topo=False,
           max_gang=3):
    meta = pkg.MetaContainer()
    rng = np.random.default_rng(num_nodes)
    for i in range(num_nodes):
        meta.add_node(f"cn{i}", meta.layout.encode(
            cpu=int(rng.integers(8, 33)),
            mem_bytes=int(rng.integers(16, 65)) << 30,
            memsw_bytes=64 << 30, is_capacity=True),
            partitions=("gpu" if i % 3 == 0 else "default",))
        meta.craned_up(i)
    meta.craned_down(1)
    if topo:
        mod = (__import__("cranesched_tpu.topo", fromlist=["x"])
               if pkg is jctld else
               __import__("cranesched_tpu_torch.topo", fromlist=["x"]))
        meta.set_topology(mod.Topology.uniform_blocks(num_nodes, 8))
    kw = {} if pkg is jctld else dict(device="cpu")
    sched = pkg.JobScheduler(meta, pkg.SchedulerConfig(
        backfill=backfill, backfill_max_jobs=8, solver=solver), **kw)
    sim = sim_mod.SimCluster(sched)
    sim.wire(sched)
    jrng = np.random.default_rng(1000 + num_nodes)
    for i in range(48):
        sched.submit(pkg.JobSpec(
            res=pkg.ResourceSpec(cpu=float(jrng.integers(1, 9)),
                                 mem_bytes=int(jrng.integers(1, 9)) << 30,
                                 memsw_bytes=8 << 30),
            partition="gpu" if jrng.random() < 0.3 else "default",
            node_num=int(jrng.integers(1, max_gang + 1)),
            time_limit=float(jrng.integers(120, 86400)),
            sim_runtime=1e9), now=float(i) * 0.001)
    started = sched.schedule_cycle(now=10.0)
    return (started, {j: sorted(sched.running[j].node_ids)
                      for j in started},
            {j: job.pending_reason.value
             for j, job in sorted(sched.pending.items())},
            {n: node.avail.tolist()
             for n, node in sorted(sched.meta.nodes.items())},
            sched.stats["last_cycle"]["solver"])


@pytest.mark.parametrize("solver,label", [
    ("auto", "native"), ("native", "native"), ("device", "device"),
    ("pallas", "cuda")])
@pytest.mark.parametrize("num_nodes", [64, 67])
def test_scheduler_solver_names_match_jax(solver, label, num_nodes):
    """A cycle under each JAX solver name starts the same jobs on the
    same nodes with the same reasons and ledger as the JAX scheduler
    with that name; the trace's label is the port's own."""
    want = _cycle(jctld, jsim, solver, num_nodes)
    got = _cycle(tctld, tsim, solver, num_nodes)
    assert got[:4] == want[:4]
    assert got[4].startswith(label)


@pytest.mark.parametrize("solver", ["native", "auto"])
@pytest.mark.parametrize("topo", [False, True])
def test_native_split_backfill_tail_matches_cuda(solver, topo):
    """The split backfill's tail and a topology's block-major axis go
    through the configured solver too, equal to the kernel's route."""
    want = _cycle(tctld, tsim, "cuda", 64, backfill=True, topo=topo,
                  max_gang=1)
    got = _cycle(tctld, tsim, solver, 64, backfill=True, topo=topo,
                 max_gang=1)
    assert got[:4] == want[:4]
    assert got[4] == want[4] == "backfill-split"


def test_native_raises_when_the_library_cannot_take_the_shape(
        monkeypatch):
    """``"native"`` raises where the library is unavailable; ``"auto"``
    then runs the kernel's route and says so in its label."""
    monkeypatch.setattr(native, "solve_greedy_native",
                        lambda *a, **kw: None)
    with pytest.raises(RuntimeError, match="native solver unavailable"):
        _cycle(tctld, tsim, "native", 64)
    out = _cycle(tctld, tsim, "auto", 64)
    assert out[4].startswith("cuda")
    assert out[:4] == _cycle(tctld, tsim, "cuda", 64)[:4]


def test_dense_mask_and_node_class_of_a_batch():
    from cranesched_tpu_torch.models.solver import FactoredJobBatch

    rows = np.array([[0, 0, 0, 0], [1, 1, 0, 0], [0, 0, 1, 0]], bool)
    jc = np.array([1, 2, 1, 0], np.int32)
    t = torch.from_numpy
    b = FactoredJobBatch(t(np.zeros((4, 3), np.int32)),
                         t(np.ones(4, np.int32)), t(np.ones(4, np.int32)),
                         t(np.ones(4, bool)), t(jc), t(rows), jc, rows,
                         np.array([1, 1, 2, 3], np.int32))
    np.testing.assert_array_equal(b.dense_mask_np(), rows[jc])
    assert b.with_valid(b.valid).node_class_np is b.node_class_np
