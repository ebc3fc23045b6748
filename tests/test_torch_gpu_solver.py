"""The port's kernel entry points against the JAX package's Pallas ones.

The same numpy problems (``tests/test_pallas_parity.py``'s generator)
go through JAX ``solve_greedy_pallas_auto`` / ``_from_batch`` in
interpret mode, JAX ``solve_greedy``, and the port's
``solve_greedy_gpu_auto`` / ``_from_batch`` on the CPU, where the kernel
wrapper runs its plain version.  Placements, reasons, chosen nodes and
the post-solve avail/cost must be bit-identical, and the port's stream
planner must return the JAX planner's plan.  The CUDA kernel itself is
held against the same plain version on the card by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cranesched_tpu.models import pallas_solver as jpallas
from cranesched_tpu.models.solver import solve_greedy as jax_solve_greedy
from cranesched_tpu_torch import convert
from cranesched_tpu_torch.models import gpu_solver
from test_pallas_parity import _random_problem


def _torch_state(jstate):
    return convert.cluster_state(np.asarray(jstate.avail),
                                 np.asarray(jstate.total),
                                 np.asarray(jstate.alive),
                                 np.asarray(jstate.cost), device="cpu")


def _torch_jobs(jjobs):
    return convert.job_batch(np.asarray(jjobs.req),
                             np.asarray(jjobs.node_num),
                             np.asarray(jjobs.time_limit),
                             np.asarray(jjobs.part_mask),
                             np.asarray(jjobs.valid), device="cpu")


def _same(j, t):
    jp, js = j
    tp, ts = t
    np.testing.assert_array_equal(np.asarray(jp.placed), tp.placed.numpy())
    np.testing.assert_array_equal(np.asarray(jp.nodes), tp.nodes.numpy())
    np.testing.assert_array_equal(np.asarray(jp.reason), tp.reason.numpy())
    np.testing.assert_array_equal(np.asarray(js.avail), ts.avail.numpy())
    np.testing.assert_array_equal(np.asarray(js.cost), ts.cost.numpy())


def _check_from_batch(state, jobs, max_nodes):
    ref = jax_solve_greedy(state, jobs, max_nodes=max_nodes)
    pal = jpallas.solve_greedy_pallas_from_batch(
        state, jobs, max_nodes=max_nodes, interpret=True)
    got = gpu_solver.solve_greedy_gpu_from_batch(
        _torch_state(state), _torch_jobs(jobs), max_nodes=max_nodes)
    _same(ref, got)
    _same(pal, got)


def _check_auto(state, jobs, max_nodes, expect_streams):
    job_class, masks = jpallas.classes_from_part_mask(
        np.asarray(jobs.part_mask))
    jplan = jpallas.plan_streams(job_class, masks)
    tplan = gpu_solver.plan_streams(job_class, masks)
    assert (jplan is None) == (tplan is None) == (not expect_streams)
    if jplan is not None:
        np.testing.assert_array_equal(np.asarray(jplan[0]), tplan[0])
        assert tuple(jplan[1:]) == tuple(tplan[1:])
    ref = jax_solve_greedy(state, jobs, max_nodes=max_nodes)
    pal = jpallas.solve_greedy_pallas_auto(
        state, jobs.req, jobs.node_num, jobs.time_limit, jobs.valid,
        jnp.asarray(job_class), jnp.asarray(masks), max_nodes=max_nodes,
        interpret=True)
    t = _torch_jobs(jobs)
    *got, used = gpu_solver.solve_greedy_gpu_auto(
        _torch_state(state), t.req, t.node_num, t.time_limit, t.valid,
        torch.as_tensor(job_class), torch.as_tensor(masks),
        max_nodes=max_nodes, return_plan=True)
    assert (used is not None) == expect_streams
    _same(ref, got)
    _same(pal, got)


def _skewed(rng):
    state, jobs = _random_problem(rng, num_jobs=80, num_nodes=40,
                                  num_classes=3)
    job_class = np.zeros(80, np.int32)
    job_class[:5] = 1
    node_part = np.asarray(rng.integers(0, 2, 40))
    pm = job_class[:, None] == node_part[None, :]
    return state, jobs.replace(part_mask=jnp.asarray(pm))


def _overlapping(rng):
    state, jobs = _random_problem(rng, num_jobs=50, num_nodes=30)
    pm = np.asarray(rng.random((50, 30)) > 0.35)
    return state, jobs.replace(part_mask=jnp.asarray(pm))


# (id, seed, problem, max_nodes, route): route "batch" runs the dense
# adapters, "stream"/"serial" the auto dispatch with the expected plan
_CASES = [
    ("random-0", 0, lambda r: _random_problem(r, 70, 50), 3, "batch"),
    ("random-1", 1, lambda r: _random_problem(r, 70, 50), 3, "batch"),
    ("random-2", 2, lambda r: _random_problem(r, 70, 50), 3, "batch"),
    ("tie-pileup", 7, lambda r: _random_problem(
        r, 60, 40, tie_costs=True, num_classes=1, dead_frac=0.0), 2,
     "batch"),
    ("oversubscribed", 11, lambda r: _random_problem(
        r, 200, 10, big_frac=0.3), 3, "batch"),
    ("non-multiple-padding", 13, lambda r: _random_problem(r, 33, 17), 2,
     "batch"),
    ("streamed-disjoint-0", 0, lambda r: _random_problem(
        r, 90, 60, num_classes=4), 2, "stream"),
    ("streamed-disjoint-1", 1, lambda r: _random_problem(
        r, 90, 60, num_classes=4), 2, "stream"),
    ("streamed-disjoint-2", 2, lambda r: _random_problem(
        r, 90, 60, num_classes=4), 2, "stream"),
    ("streamed-ties", 5, lambda r: _random_problem(
        r, 64, 48, tie_costs=True, num_classes=4, dead_frac=0.0), 2,
     "stream"),
    ("skewed-falls-back", 9, _skewed, 2, "serial"),
    ("overlapping-falls-back", 21, _overlapping, 3, "serial"),
    ("gangs-dead-nodes", 17, lambda r: _random_problem(
        r, 70, 80, num_classes=4, dead_frac=0.2, max_nodes=3), 3,
     "stream"),
]


@pytest.mark.parametrize("case", _CASES, ids=[c[0] for c in _CASES])
def test_kernel_entry_points_bitwise(case):
    _, seed, build, max_nodes, route = case
    state, jobs = build(np.random.default_rng(seed))
    if route == "batch":
        _check_from_batch(state, jobs, max_nodes)
    else:
        _check_auto(state, jobs, max_nodes, expect_streams=route == "stream")


def test_classes_from_part_mask_roundtrip():
    rng = np.random.default_rng(3)
    pm = rng.random((20, 9)) > 0.4
    job_class, masks = gpu_solver.classes_from_part_mask(pm)
    np.testing.assert_array_equal(masks[job_class], pm)
    jc, jm = jpallas.classes_from_part_mask(pm)
    np.testing.assert_array_equal(jc, job_class)
    np.testing.assert_array_equal(jm, masks)


def test_plan_streams_matches_jax_planner():
    rng = np.random.default_rng(4)
    for num_classes, jobs_n, block in ((4, 3000, 256), (6, 900, 64),
                                       (2, 10, 256), (1, 50, 256)):
        node_part = rng.integers(0, num_classes, 64)
        masks = np.stack([node_part == c for c in range(num_classes)])
        jc = rng.integers(0, num_classes, jobs_n).astype(np.int32)
        for known in (False, True):
            jplan = jpallas.plan_streams(jc, masks, block_jobs=block,
                                         known_disjoint=known)
            tplan = gpu_solver.plan_streams(jc, masks, block_jobs=block,
                                            known_disjoint=known)
            assert (jplan is None) == (tplan is None)
            if jplan is not None:
                np.testing.assert_array_equal(np.asarray(jplan[0]),
                                              tplan[0])
                assert tuple(jplan[1:]) == tuple(tplan[1:])


def test_return_plan_reports_the_plan_run():
    """plan=None lets the internal planner decide; return_plan must
    report what actually ran (a plan for disjoint classes, None for the
    serial kernel), and a passed plan is used as given."""
    rng = np.random.default_rng(2)
    state, jobs = _random_problem(rng, 90, 60, num_classes=4)
    t = _torch_jobs(jobs)
    jc, masks = gpu_solver.classes_from_part_mask(t.part_mask)
    args = (t.req, t.node_num, t.time_limit, t.valid,
            torch.as_tensor(jc), torch.as_tensor(masks))
    *_, used = gpu_solver.solve_greedy_gpu_auto(
        _torch_state(state), *args, max_nodes=2, return_plan=True)
    assert used is not None and used[1] >= 2
    out = gpu_solver.solve_greedy_gpu_auto(_torch_state(state), *args,
                                           max_nodes=2, plan=used)
    assert len(out) == 2
    *_, used = gpu_solver.solve_greedy_gpu_auto(
        _torch_state(state), *args, max_nodes=2, max_streams=1,
        return_plan=True)
    assert used is None


def test_kernel_wrapper_routes_cpu_tensors_to_plain():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing."""
    before = gpu_solver.greedy_place.launches
    rng = np.random.default_rng(0)
    state, jobs = _random_problem(rng, 20, 10)
    gpu_solver.solve_greedy_gpu_from_batch(_torch_state(state),
                                           _torch_jobs(jobs), max_nodes=2)
    assert gpu_solver.greedy_place.launches == before


def test_factored_batch_from_jax_values():
    """A FactoredJobBatch carried in from numpy (as the JAX scheduler
    builds it) solves to the JAX result through the auto dispatch."""
    rng = np.random.default_rng(6)
    state, jobs = _random_problem(rng, 90, 60, num_classes=4)
    jc, masks = jpallas.classes_from_part_mask(np.asarray(jobs.part_mask))
    batch = convert.factored_job_batch(
        np.asarray(jobs.req), np.asarray(jobs.node_num),
        np.asarray(jobs.time_limit), np.asarray(jobs.valid), jc, masks,
        device="cpu")
    assert batch.num_jobs == 90 and batch.job_class_np is not None
    np.testing.assert_array_equal(batch.class_masks.numpy(), masks)
    plan = gpu_solver.plan_streams(batch.job_class_np, batch.class_rows_np,
                                   known_disjoint=True)
    got = gpu_solver.solve_greedy_gpu_auto(
        _torch_state(state), batch.req, batch.node_num, batch.time_limit,
        batch.valid, batch.job_class, batch.class_masks, max_nodes=2,
        plan=plan)
    _same(jax_solve_greedy(state, jobs, max_nodes=2), got)
