"""The port's topology subsystem (``cranesched_tpu_torch/topo/``) against
the JAX package's ``cranesched_tpu/topo/``, bit for bit on the CPU:

* ``Topology`` arrays (perm, inv_perm, levels, sizes, block paths,
  fragmentation, the doc) for the torus, uniform and ``from_config``
  builds, and the torch twins of the arrays;
* ``solve_greedy_topo`` on random torus problems and on the cross-block
  spanning case, and ``solve_greedy_topo_permuted``;
* the scheduler cycle under a topology against the JAX scheduler: gang
  cycles (route ``topo``) with backfill on and off, and single-node
  cycles, whose greedy solve sees the block-major node axis (the
  immediate cycle and the split-backfill tail, through greedy_place's
  plain version).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cranesched_tpu import ctld as jctld
from cranesched_tpu.craned.sim import SimCluster as JSimCluster
from cranesched_tpu.models.solver import JobBatch as JJobBatch
from cranesched_tpu.models.solver import make_cluster_state as j_state
from cranesched_tpu.topo import Topology as JTopology
from cranesched_tpu.topo import solve_greedy_topo as j_solve
from cranesched_tpu.topo import topology_doc as j_doc
from cranesched_tpu.topo.place import solve_greedy_topo_permuted as j_perm
from cranesched_tpu_torch import ctld as tctld
from cranesched_tpu_torch.craned.sim import SimCluster as TSimCluster
from cranesched_tpu_torch.models.solver import JobBatch, make_cluster_state
from cranesched_tpu_torch.topo import Topology as TTopology
from cranesched_tpu_torch.topo import (
    solve_greedy_topo,
    solve_greedy_topo_permuted,
    topology_doc,
)

_TREE = {
    "Blocks": [{"name": f"b{i}", "nodes": f"n[{8 * i:02d}-{8 * i + 7:02d}]"}
               for i in range(7)],          # n56-n63 stay ungrouped
    "Switches": [{"name": "sw0", "blocks": ["b0", "b1", "b2", "b3"]},
                 {"name": "sw1", "blocks": ["b4", "b5"]}],   # b6 alone
}
_NAMES = {f"n{i:02d}": i for i in range(64)}


def _builds(pkg_topology):
    return {
        "torus": pkg_topology.from_torus([4, 4, 4], [2, 2, 2]),
        "uniform": pkg_topology.uniform_blocks(48, 6),
        "tree": pkg_topology.from_config(_TREE, name_to_id=_NAMES,
                                         num_nodes=64),
        "torus-config": pkg_topology.from_config(
            {"Torus": [4, 4, 2], "Slice": [2, 4, 1]}),
    }


@pytest.mark.parametrize("which", ["torus", "uniform", "tree",
                                   "torus-config"])
def test_topology_arrays_match_jax(which):
    j, t = _builds(JTopology)[which], _builds(TTopology)[which]
    for attr in ("num_nodes", "num_blocks", "block_names", "leaf_name"):
        assert getattr(j, attr) == getattr(t, attr), attr
    for attr in ("block_of_node", "block_sizes", "perm", "inv_perm"):
        a, b = getattr(j, attr), getattr(t, attr)
        assert a.dtype == b.dtype, attr
        np.testing.assert_array_equal(a, b, err_msg=attr)
    assert (j.coords is None) == (t.coords is None)
    if j.coords is not None:
        np.testing.assert_array_equal(j.coords, t.coords)
    assert len(j.levels_np) == len(t.levels_np)
    for (jn, jg, js, jnames), (tn, tg, ts, tnames) in zip(j.levels_np,
                                                          t.levels_np):
        assert (jn, jnames) == (tn, tnames)
        np.testing.assert_array_equal(jg, tg)
        np.testing.assert_array_equal(js, ts)
    # the torch twins equal the host arrays, and JAX's twins
    for (jg, js), (tg, ts) in zip(j.jnp_levels, t.levels("cpu")):
        np.testing.assert_array_equal(np.asarray(jg), tg.numpy())
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        assert tg.dtype == torch.int32 and ts.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j.jnp_perm),
                                  t.perm_tensor("cpu").numpy())
    np.testing.assert_array_equal(np.asarray(j.jnp_inv_perm),
                                  t.inv_perm_tensor("cpu").numpy())
    assert t.levels("cpu") is t.levels(torch.device("cpu"))   # cached
    for nid in range(j.num_nodes):
        assert j.block_path(nid) == t.block_path(nid)
    np.testing.assert_array_equal(j.block_masks(), t.block_masks())
    rng = np.random.default_rng(5)
    for free in (np.zeros(j.num_nodes, bool), rng.random(j.num_nodes) < 0.3,
                 np.ones(j.num_nodes, bool)):
        assert j.fragmentation(free) == t.fragmentation(free)
        assert j_doc(j, free_mask=free) == topology_doc(t, free_mask=free)
    assert j_doc(j) == topology_doc(t)


def test_topology_validation_matches_jax():
    for build in (lambda T: T.from_torus([4, 4, 4], [3, 2, 2]),
                  lambda T: T.from_torus([4, 4], [2, 2, 2]),
                  lambda T: T.uniform_blocks(10, 3),
                  lambda T: T.from_config({"Blocks": [
                      {"name": "x", "nodes": "zz9"}]}, name_to_id=_NAMES,
                      num_nodes=64),
                  lambda T: T.from_config({"Blocks": [
                      {"name": "a", "nodes": "n00"},
                      {"name": "b", "nodes": "n00"}]}, name_to_id=_NAMES,
                      num_nodes=64)):
        msgs = []
        for T in (JTopology, TTopology):
            with pytest.raises(ValueError) as err:
                build(T)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ----------------------------------------------------------- the solve


def _problem(rng, n_jobs, n_nodes, n_parts=1, max_nodes=8, drain=0.1):
    total = np.zeros((n_nodes, 3), np.int32)
    total[:, 0] = rng.choice([16, 32, 64], n_nodes) * 256
    total[:, 1] = rng.choice([64, 128], n_nodes) * 1024
    total[:, 2] = total[:, 1]
    used = rng.uniform(0, 0.5, n_nodes)
    avail = (total * (1 - used[:, None])).astype(np.int32)
    alive = rng.random(n_nodes) > drain
    cost = rng.integers(0, 1600, n_nodes).astype(np.int32)
    req = np.zeros((n_jobs, 3), np.int32)
    req[:, 0] = rng.choice([1, 2, 4], n_jobs) * 256
    req[:, 1] = rng.choice([1, 4], n_jobs) * 1024
    req[:, 2] = req[:, 1]
    node_num = rng.integers(1, max_nodes + 1, n_jobs).astype(np.int32)
    time_limit = rng.choice([60, 3600], n_jobs).astype(np.int32)
    node_part = rng.integers(0, n_parts, n_nodes)
    job_part = rng.integers(0, n_parts, n_jobs)
    part_mask = node_part[None, :] == job_part[:, None]
    valid = np.ones(n_jobs, bool)
    return ((avail, total, alive, cost),
            (req, node_num, time_limit, part_mask, valid))


def _solve_both(state_np, jobs_np, jt, tt, max_nodes, permuted=False):
    jstate = j_state(*state_np)
    jjobs = JJobBatch(*(jnp.asarray(x) for x in jobs_np))
    tstate = make_cluster_state(*state_np, device="cpu")
    tjobs = JobBatch(*(torch.from_numpy(x) for x in jobs_np))
    if permuted:
        jp, js, ji = j_perm(jstate, jjobs, jt, max_nodes=max_nodes)
        tp, ts, ti = solve_greedy_topo_permuted(tstate, tjobs, tt,
                                                max_nodes=max_nodes)
    else:
        jp, js, ji = j_solve(jstate, jjobs, jt.jnp_levels,
                             max_nodes=max_nodes)
        tp, ts, ti = solve_greedy_topo(tstate, tjobs, tt.levels("cpu"),
                                       max_nodes=max_nodes)
    for what, a, b in (("placed", jp.placed, tp.placed),
                       ("nodes", jp.nodes, tp.nodes),
                       ("reason", jp.reason, tp.reason),
                       ("avail", js.avail, ts.avail),
                       ("cost", js.cost, ts.cost),
                       ("in_block", ji.in_block, ti.in_block),
                       ("cross", ji.cross, ti.cross),
                       ("block", ji.block, ti.block)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=what)
    return tp, ti


@pytest.mark.parametrize("seed", range(3))
def test_solve_torus_matches_jax(seed):
    rng = np.random.default_rng(100 + seed)
    jt, tt = (T.from_torus([4, 4, 4], [2, 2, 2])
              for T in (JTopology, TTopology))
    state, jobs = _problem(rng, 48, 64, n_parts=2)
    _, info = _solve_both(state, jobs, jt, tt, 8)
    assert info.in_block.any()


@pytest.mark.parametrize("seed", range(2))
def test_solve_tree_cross_block_matches_jax(seed):
    """Blocks of 8 under switches: gangs of 10-12 fit no block and span
    inside the lowest fitting switch; ungrouped nodes join as one
    pseudo-block."""
    rng = np.random.default_rng(7 + seed)
    jt, tt = (T.from_config(_TREE, name_to_id=_NAMES, num_nodes=64)
              for T in (JTopology, TTopology))
    state, jobs = _problem(rng, 24, 64, max_nodes=8, drain=0.05)
    jobs[1][:] = rng.integers(3, 13, 24)
    placements, info = _solve_both(state, jobs, jt, tt, 16)
    placed = placements.placed.numpy()
    assert info.cross.numpy()[placed].any()
    assert info.in_block.numpy()[placed].any()


def test_permuted_solve_matches_jax_and_direct():
    """Interleaved blocks (perm is not the identity), tie-free costs:
    the permuted solve equals the JAX permuted solve bit for bit and the
    direct solve up to the order of each gang's picks."""
    rng = np.random.default_rng(3)
    n = 24
    bon = (np.arange(n) % 3).astype(np.int32)
    jt, tt = (T(n, bon, ["b0", "b1", "b2"]) for T in (JTopology, TTopology))
    assert not (tt.perm == np.arange(n)).all()
    state, jobs = _problem(rng, 20, n, max_nodes=4, drain=0.05)
    state = state[:3] + ((rng.permutation(n) * 16).astype(np.int32),)
    tp, ti = _solve_both(state, jobs, jt, tt, 4, permuted=True)
    direct = make_cluster_state(*state, device="cpu")
    dp, ds, di = solve_greedy_topo(
        direct, JobBatch(*(torch.from_numpy(x) for x in jobs)),
        tt.levels("cpu"), max_nodes=4)
    pstate = make_cluster_state(*state, device="cpu")
    solve_greedy_topo_permuted(pstate, JobBatch(*(torch.from_numpy(x)
                                                  for x in jobs)), tt, 4)
    np.testing.assert_array_equal(dp.placed.numpy(), tp.placed.numpy())
    np.testing.assert_array_equal(np.sort(dp.nodes.numpy(), axis=1),
                                  np.sort(tp.nodes.numpy(), axis=1))
    np.testing.assert_array_equal(ds.avail.numpy(), pstate.avail.numpy())
    np.testing.assert_array_equal(ds.cost.numpy(), pstate.cost.numpy())
    np.testing.assert_array_equal(di.block.numpy(), ti.block.numpy())


# ------------------------------------------------------- the scheduler


def _node_specs(n):
    rng = np.random.default_rng(0)
    return [(f"n{i:02d}", int(rng.integers(8, 33)),
             int(rng.integers(16, 65)) << 30) for i in range(n)]


def _build(pkg, sim_cls, topo_of, cfg, jobs, n=64, **kw):
    meta = pkg.MetaContainer()
    for name, cpu, mem in _node_specs(n):
        node = meta.add_node(name, meta.layout.encode(
            cpu=cpu, mem_bytes=mem, memsw_bytes=64 << 30,
            is_capacity=True), partitions=("default",))
        meta.craned_up(node.node_id)
    meta.craned_down(5)
    meta.set_topology(topo_of(JTopology if pkg is jctld else TTopology))
    cfg = dict(cfg)
    if pkg is jctld:
        cfg["solver"] = "device"
    sched = pkg.JobScheduler(meta, pkg.SchedulerConfig(**cfg), **kw)
    sim = sim_cls(sched)
    sim.wire(sched)
    for i, spec in enumerate(jobs(pkg)):
        assert sched.submit(spec, now=i * 1e-3) > 0
    return sched, sim


def _jobs(max_gang, count=160):
    def make(pkg):
        rng = np.random.default_rng(1)
        return [pkg.JobSpec(
            res=pkg.ResourceSpec(cpu=float(rng.integers(2, 9)),
                                 mem_bytes=int(rng.integers(1, 9)) << 30),
            node_num=int(rng.integers(1, max_gang + 1)),
            time_limit=int(rng.integers(120, 7200)),
            qos_priority=int(rng.integers(0, 3)) * 10,
            account=f"acct{int(rng.integers(0, 3))}",
            sim_runtime=float(rng.integers(30, 900)))
            for _ in range(count)]
    return make


def _outcome(sched):
    return (
        {jid: (sorted(job.node_ids), job.topo_block, job.cross_block)
         for jid, job in sched.running.items()},
        np.stack([n.avail for _, n in sorted(sched.meta.nodes.items())]),
        {jid: str(job.pending_reason.value)
         for jid, job in sched.pending.items()},
        sorted(sched.history))


def _run_both(topo_of, cfg, jobs, cycles=3):
    sides = [_build(jctld, JSimCluster, topo_of, cfg, jobs),
             _build(tctld, TSimCluster, topo_of, cfg, jobs, device="cpu")]
    labels = []
    now = 10.0
    for cycle in range(cycles):
        if cycle:
            now += 400.0
            for sched, sim in sides:
                sim.advance_to(now)
        started = [sched.schedule_cycle(now=now) for sched, _ in sides]
        assert started[0] == started[1], f"cycle {cycle}: started differ"
        assert started[0], f"cycle {cycle} placed nothing"
        j, t = (_outcome(s) for s, _ in sides)
        assert j[0] == t[0], f"cycle {cycle}: nodes / blocks differ"
        np.testing.assert_array_equal(j[1], t[1])
        assert j[2] == t[2], f"cycle {cycle}: pending reasons differ"
        assert j[3] == t[3], f"cycle {cycle}: finished sets differ"
        labels.append(sides[1][0].stats["last_cycle"]["solver"])
    return sides[1][0], labels


def _tree(topology):
    return topology.from_config(_TREE, name_to_id=_NAMES, num_nodes=64)


def _interleaved(topology):
    return topology(64, (np.arange(64) % 4).astype(np.int32),
                    [f"b{i}" for i in range(4)])


@pytest.mark.parametrize("backfill", [False, True],
                         ids=["immediate", "backfill"])
def test_gang_cycle_matches_jax_scheduler(backfill):
    sched, labels = _run_both(
        _tree, dict(backfill=backfill, max_nodes_per_job=16), _jobs(12))
    assert labels == ["topo"] * 3, labels
    assert sched.stats["topo_in_block_total"] > 0
    assert sched.stats["topo_cross_block_total"] > 0
    last = sched.stats["last_cycle"]
    assert 0.0 <= last["topo_frag"] <= 1.0


@pytest.mark.parametrize("mode", [
    ("immediate", dict(backfill=False), "cuda"),
    ("split", dict(backfill_max_jobs=16), "backfill-split"),
], ids=["immediate", "split-tail"])
def test_single_node_permutation_seam_matches_jax_scheduler(mode):
    """Single-node jobs under interleaved blocks: the greedy solve (its
    plain version on the CPU) sees the block-major node axis and the
    commit sees real node ids, as in the JAX package."""
    _, cfg, want = mode
    sched, labels = _run_both(_interleaved, cfg, _jobs(1, count=600))
    assert labels == [want] * 3, labels
    for job in sched.running.values():
        assert len(job.node_ids) == 1 and not job.cross_block
