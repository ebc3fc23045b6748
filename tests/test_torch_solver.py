"""The port's ``solve_greedy`` against the JAX package's, bit for bit.

Same shapes as ``tests/test_solver_parity.py``: the same numpy inputs go
through ``cranesched_tpu.models.solver.solve_greedy`` and
``cranesched_tpu_torch.models.solver.solve_greedy`` (on the CPU);
placed, nodes, reason, avail and cost must be identical.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cranesched_tpu.models import solver as jsolver
from cranesched_tpu_torch import convert
from cranesched_tpu_torch.models import solver as tsolver
from test_solver_parity import random_problem


def _run_both(state_d, jobs_d, max_nodes):
    jstate = jsolver.make_cluster_state(state_d["avail"], state_d["total"],
                                        state_d["alive"], state_d["cost"])
    jjobs = jsolver.JobBatch(**{k: jnp.asarray(v)
                                for k, v in jobs_d.items()})
    jp, js = jsolver.solve_greedy(jstate, jjobs, max_nodes=max_nodes)
    tstate = convert.cluster_state(state_d["avail"], state_d["total"],
                                   state_d["alive"], state_d["cost"],
                                   device="cpu")
    tjobs = convert.job_batch(device="cpu", **jobs_d)
    tp, ts = tsolver.solve_greedy(tstate, tjobs, max_nodes=max_nodes)
    return (jp, js), (tp, ts)


def _assert_same(j, t):
    (jp, js), (tp, ts) = j, t
    np.testing.assert_array_equal(np.asarray(jp.placed), tp.placed.numpy())
    np.testing.assert_array_equal(np.asarray(jp.nodes), tp.nodes.numpy())
    np.testing.assert_array_equal(np.asarray(jp.reason), tp.reason.numpy())
    np.testing.assert_array_equal(np.asarray(js.avail), ts.avail.numpy())
    np.testing.assert_array_equal(np.asarray(js.cost), ts.cost.numpy())
    assert tp.nodes.dtype == torch.int32 and ts.cost.dtype == torch.int32


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize(
    "n_jobs,n_nodes,n_parts,max_nodes,gres",
    [
        (50, 20, 1, 1, False),
        (200, 50, 3, 1, False),
        (100, 30, 1, 4, False),
        (150, 40, 2, 2, True),
    ],
)
def test_solve_greedy_bitwise(seed, n_jobs, n_nodes, n_parts, max_nodes,
                              gres):
    rng = np.random.default_rng(seed * 1000 + n_jobs)
    _, state_d, jobs_d, k = random_problem(
        rng, n_jobs, n_nodes, n_parts, max_nodes, gres)
    _assert_same(*_run_both(state_d, jobs_d, k))


def test_oversubscribed_and_dead_cluster_bitwise():
    rng = np.random.default_rng(7)
    _, state_d, jobs_d, k = random_problem(rng, 500, 10, 1, 1)
    j, t = _run_both(state_d, jobs_d, k)
    _assert_same(j, t)
    assert (t[1].avail >= 0).all()
    rng = np.random.default_rng(3)
    _, state_d, jobs_d, k = random_problem(rng, 20, 5, 1, 1)
    state_d["alive"][:] = False
    j, t = _run_both(state_d, jobs_d, k)
    _assert_same(j, t)
    assert not t[0].placed.any()


def test_integer_cost_seed_skips_float32():
    """An integer seed above 2^24 must survive exactly (a float32 round
    trip would move it)."""
    seed = np.array([2**24 + 1, 2**30 + 3], np.int64)
    state = convert.cluster_state(np.ones((2, 3), np.int32),
                                  np.ones((2, 3), np.int32),
                                  np.ones(2, bool), seed, device="cpu")
    assert state.cost.tolist() == [2**24 + 1, 2**30 + 3]
    fseed = np.array([2.5, 3.5], np.float32)   # half to even
    state = convert.cluster_state(np.ones((2, 3), np.int32),
                                  np.ones((2, 3), np.int32),
                                  np.ones(2, bool), fseed, device="cpu")
    assert state.cost.tolist() == [2, 4]


def test_patch_and_refresh_in_place():
    """patch_cluster_state drops pad rows (>= N) and writes in place;
    refresh_cost_ledger replaces only the cost ledger."""
    n, r = 6, 3
    total = np.full((n, r), 8, np.int32)
    state = convert.cluster_state(total, total, np.ones(n, bool),
                                  device="cpu")
    avail_ptr = state.avail.data_ptr()
    idx = np.array([4, 1, n, n], np.int32)
    rows = np.arange(4 * r, dtype=np.int32).reshape(4, r)
    alive = np.array([False, True, True, True])
    out = tsolver.patch_cluster_state(state, idx, rows, rows, alive,
                                      np.arange(n, dtype=np.int32))
    assert out is state and state.avail.data_ptr() == avail_ptr
    assert state.avail[4].tolist() == rows[0].tolist()
    assert state.avail[1].tolist() == rows[1].tolist()
    assert state.avail[0].tolist() == [8, 8, 8]
    assert not bool(state.alive[4]) and bool(state.alive[1])
    assert state.cost.tolist() == list(range(n))
    tsolver.refresh_cost_ledger(state, np.full(n, 9, np.int32))
    assert state.cost.tolist() == [9] * n
    assert state.avail[4].tolist() == rows[0].tolist()


def test_fits_and_fit_count_match_jax():
    from cranesched_tpu.ops import resources as jres
    from cranesched_tpu_torch.ops import resources as tres

    rng = np.random.default_rng(5)
    avail = rng.integers(0, 64, (40, 4)).astype(np.int32)
    req = rng.integers(0, 9, (40, 4)).astype(np.int32)
    req[::7] = 0      # requests with unconstrained dimensions
    np.testing.assert_array_equal(
        np.asarray(jres.fits(jnp.asarray(req), jnp.asarray(avail))),
        tres.fits(torch.from_numpy(req), torch.from_numpy(avail)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jres.fit_count(avail, req)),
        tres.fit_count(torch.from_numpy(avail),
                       torch.from_numpy(req)).numpy())
    lay = tres.ResourceLayout.from_gres_names([("gpu", "a100")])
    jlay = jres.ResourceLayout.from_gres_names([("gpu", "a100")])
    for kw in (dict(cpu=1.3, mem_bytes=(1 << 30) + 1,
                    gres={("gpu", "a100"): 2}),
               dict(cpu=7.0, mem_bytes=5 << 30, memsw_bytes=3 << 20,
                    is_capacity=True)):
        np.testing.assert_array_equal(lay.encode(**kw), jlay.encode(**kw))
