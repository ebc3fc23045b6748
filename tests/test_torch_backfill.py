"""The port's time-axis solve against the JAX package's.

The same numpy inputs go through JAX ``TimeGrid``, ``end_buckets_for``,
``make_timed_state`` and ``solve_backfill`` and through the port's (on
the CPU).  Grid edges, release buckets, end buckets, the time map, and
the solve's placements, start buckets, chosen nodes, reasons, post-solve
time map and cost ledger must be bit-identical.  The random problems use
``tests/test_backfill_parity.py``'s shapes (12 nodes, 24 jobs, 10
running jobs, 16 buckets) on the unit grid, and again in seconds on a
geometric grid that reaches 7 days.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cranesched_tpu.models import solver_time as jst
from cranesched_tpu.ops.resources import ResourceLayout
from cranesched_tpu_torch import convert
from cranesched_tpu_torch.models import solver_time as tst

LAY = ResourceLayout()
WEEK = 7 * 24 * 3600

_GRIDS = [("uniform", 64, 60.0, None), ("geometric", 64, 60.0, WEEK),
          ("geometric-16", 16, 60.0, WEEK), ("coarse", 16, 600.0, WEEK),
          ("short-horizon", 16, 60.0, 600.0)]


@pytest.mark.parametrize("grid", _GRIDS, ids=[g[0] for g in _GRIDS])
def test_time_grid_and_end_buckets_match_jax(grid):
    _, T, res, horizon = grid
    jg = jst.TimeGrid(T, res, horizon=horizon)
    tg = tst.TimeGrid(T, res, horizon=horizon)
    np.testing.assert_array_equal(jg.edges, tg.edges)
    assert tg.edges.dtype == np.int64 and tg.num_buckets == T
    rng = np.random.default_rng(T)
    rem = np.concatenate([rng.uniform(-100, 2 * WEEK, 500),
                          tg.edges.astype(np.float64), [0.0, 0.5]])
    np.testing.assert_array_equal(jg.release_bucket(rem),
                                  tg.release_bucket(rem))
    starts = np.arange(T, dtype=np.int32)
    edges = tg.edges_tensor("cpu")
    for dur in [0, -5, 1, 59, 60, 61, 3600, 86400, WEEK, 2 * WEEK,
                *rng.integers(1, WEEK, 20).tolist()]:
        want = jst.end_buckets_for(jg.jnp_edges, jnp.asarray(starts),
                                   jnp.int32(dur))
        got = tst.end_buckets_for(edges, torch.from_numpy(starts),
                                  torch.tensor(dur, dtype=torch.int32))
        np.testing.assert_array_equal(np.asarray(want), got.numpy())
    carried = convert.time_grid(jg.edges, jg.resolution)
    np.testing.assert_array_equal(carried.edges, jg.edges)
    assert carried.num_buckets == T


def _running(rng, N, M, T, pad=False):
    run_nodes = rng.integers(0, N, size=(M, 2)).astype(np.int32)
    if pad:
        run_nodes[rng.random((M, 2)) < 0.3] = -1
    run_req = np.stack([
        LAY.encode(cpu=int(rng.integers(1, 5)),
                   mem_bytes=int(rng.integers(1, 9)) << 30)
        for _ in range(M)]).astype(np.int32)
    run_end = rng.integers(0, T + 3, size=M).astype(np.int32)
    return run_nodes, run_req, run_end


def _problem(seed, N=12, J=24, M=10, T=16, seconds=False):
    rng = np.random.default_rng(seed)
    total = np.stack([
        LAY.encode(cpu=int(rng.integers(4, 17)),
                   mem_bytes=int(rng.integers(8, 65)) << 30,
                   is_capacity=True) for _ in range(N)])
    run_nodes, run_req, run_end = _running(rng, N, M, T)
    run_nodes = run_nodes[:, :1]
    avail = total.copy()
    for i in range(M):
        avail[run_nodes[i, 0]] -= run_req[i]
    avail = np.maximum(avail, 0)
    alive = rng.random(N) > 0.1
    cost = (rng.random(N) * 5).astype(np.float32)
    req = np.stack([LAY.encode(cpu=int(rng.integers(1, 9)),
                               mem_bytes=int(rng.integers(1, 33)) << 30)
                    for _ in range(J)]).astype(np.int32)
    nn = rng.integers(1, 4, J).astype(np.int32)
    tl = rng.integers(1, T + 2, J).astype(np.int32)
    if seconds:
        tl = rng.integers(30, 2 * 86400, J).astype(np.int32)
    pm = rng.random((J, N)) > 0.15
    valid = rng.random(J) > 0.05
    return ((avail, total, alive, run_nodes, run_req, run_end, T, cost),
            (req, nn, tl, pm, valid))


def _states(args):
    avail, total, alive, run_nodes, run_req, run_end, T, cost = args
    js = jst.make_timed_state(avail, total, alive, run_nodes, run_req,
                              run_end, T, cost)
    ts = tst.make_timed_state(avail, total, alive, run_nodes, run_req,
                              run_end, T, cost, device="cpu")
    return js, ts


def _same_state(js, ts):
    np.testing.assert_array_equal(np.asarray(js.time_avail),
                                  ts.time_avail.numpy())
    np.testing.assert_array_equal(np.asarray(js.cost), ts.cost.numpy())
    np.testing.assert_array_equal(np.asarray(js.total), ts.total.numpy())
    np.testing.assert_array_equal(np.asarray(js.alive), ts.alive.numpy())


@pytest.mark.parametrize("seed", range(3))
def test_make_timed_state_matches_jax(seed):
    """Padding slots, ends past the window and repeated (node, bucket)
    pairs, with an integer and a float cost seed."""
    rng = np.random.default_rng(100 + seed)
    N, T = 20, 16
    total = np.stack([LAY.encode(cpu=32, mem_bytes=64 << 30,
                                 is_capacity=True)] * N)
    run = _running(rng, N, 40, T, pad=True)
    run[2][:5] = run[2][5:10]          # repeated end buckets
    run[0][:5] = run[0][5:10]          # on repeated nodes
    avail = total - rng.integers(0, 5, size=total.shape).astype(np.int32)
    alive = rng.random(N) > 0.2
    for cost in (rng.integers(0, 1000, N).astype(np.int32),
                 (rng.random(N) * 100).astype(np.float32), None):
        js, ts = _states((avail, total, alive, *run, T, cost))
        _same_state(js, ts)
        # the JAX state carried into the port is the same state
        _same_state(js, convert.timed_cluster_state(
            np.asarray(js.time_avail), np.asarray(js.total),
            np.asarray(js.alive), np.asarray(js.cost), device="cpu"))
    empty = (np.zeros((0, 1), np.int32), np.zeros((0, total.shape[1]),
                                                  np.int32),
             np.zeros(0, np.int32))
    _same_state(*_states((avail, total, alive, *empty, T, None)))


def _solve_both(args, cols, max_nodes, grid=None):
    js, ts = _states(args)
    req, nn, tl, pm, valid = cols
    jedges = None if grid is None else grid.jnp_edges
    tedges = None if grid is None else convert.time_grid(
        grid.edges, grid.resolution).edges_tensor("cpu")
    jp, js2 = jst.solve_backfill(
        js, jst.TimedJobBatch(req=jnp.asarray(req), node_num=jnp.asarray(nn),
                              time_limit=jnp.asarray(tl),
                              part_mask=jnp.asarray(pm),
                              valid=jnp.asarray(valid)),
        edges=jedges, max_nodes=max_nodes)
    tp, ts2 = tst.solve_backfill(
        ts, convert.timed_job_batch(req, nn, tl, pm, valid, device="cpu"),
        edges=tedges, max_nodes=max_nodes)
    for what in ("placed", "start_bucket", "nodes", "reason"):
        want = np.asarray(getattr(jp, what))
        got = getattr(tp, what).numpy()
        assert want.dtype == got.dtype, what
        np.testing.assert_array_equal(want, got, err_msg=what)
    _same_state(js2, ts2)
    return tp


@pytest.mark.parametrize("seed", range(4))
def test_solve_backfill_matches_jax(seed):
    args, cols = _problem(seed)
    p = _solve_both(args, cols, max_nodes=4)
    assert bool(p.placed.any())


@pytest.mark.parametrize("seed", range(2))
def test_solve_backfill_geometric_grid_matches_jax(seed):
    """Durations in seconds on a 16-bucket grid reaching 7 days: start
    buckets in the geometric tail and reservations across it."""
    args, cols = _problem(10 + seed, N=16, J=40, seconds=True)
    grid = jst.TimeGrid(16, 60.0, horizon=WEEK)
    p = _solve_both(args, cols, max_nodes=4, grid=grid)
    start = p.start_bucket[p.placed]
    assert bool((start > 0).any()) and bool((start == 0).any())


def test_solve_backfill_contended_gangs_match_jax():
    """Many jobs over few nodes: most hold future reservations, gangs up
    to 3 with max_nodes 3, some rows invalid, a dead node."""
    args, cols = _problem(7, N=6, J=60, M=12, T=16)
    args[2][:] = True
    args[2][4] = False
    p = _solve_both(args, cols, max_nodes=3)
    assert bool((p.start_bucket[p.placed] > 0).any())
    assert bool((~p.placed).any())


def test_dense_rows_and_with_valid():
    """FactoredJobBatch.dense(stop) gathers only the first rows' masks,
    equal to the dense gather's head; with_valid shares the tables."""
    rng = np.random.default_rng(3)
    masks = rng.random((5, 30)) > 0.5
    jc = rng.integers(0, 5, 40).astype(np.int32)
    b = convert.factored_job_batch(
        rng.integers(0, 9, (40, 3)), rng.integers(1, 3, 40),
        rng.integers(60, 600, 40), np.ones(40, bool), jc, masks,
        device="cpu")
    head = b.dense(16)
    assert head.part_mask.shape == (16, 30)
    np.testing.assert_array_equal(head.part_mask.numpy(), masks[jc[:16]])
    np.testing.assert_array_equal(head.req.numpy(), b.req.numpy()[:16])
    np.testing.assert_array_equal(b.dense().part_mask.numpy(), masks[jc])
    tail = b.with_valid(torch.arange(40) >= 16)
    assert tail.class_masks is b.class_masks and tail.req is b.req
    assert int(tail.valid.sum()) == 24 and bool(b.valid.all())
