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
        max_nodes=max_nodes, return_plan=True, class_rows=masks)
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
        _torch_state(state), *args, max_nodes=2, return_plan=True,
        class_rows=masks)
    assert used is not None and used[1] >= 2
    out = gpu_solver.solve_greedy_gpu_auto(_torch_state(state), *args,
                                           max_nodes=2, plan=used,
                                           class_rows=masks)
    assert len(out) == 2
    *_, used = gpu_solver.solve_greedy_gpu_auto(
        _torch_state(state), *args, max_nodes=2, max_streams=1,
        return_plan=True, class_rows=masks)
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
        plan=plan, class_rows=batch.class_rows_np)
    _same(jax_solve_greedy(state, jobs, max_nodes=2), got)


# ---- the kernel's owned-slot layout and launch plan ----


def _layout_case(name):
    """(class masks [C, N], alive [N], job_class [J]) for one layout."""
    rng = np.random.default_rng(len(name))
    n = 64
    part = np.arange(n) % 4
    disjoint = np.stack([part == c for c in range(4)])
    alive = rng.random(n) > 0.1
    jc = rng.integers(0, 4, 400).astype(np.int32)
    if name == "disjoint":
        return disjoint, alive, jc
    if name == "overlapping":
        jc[::7] = 4
        return np.concatenate([disjoint, np.ones((1, n), bool)]), alive, jc
    if name == "dead-class":
        return disjoint, alive & (part != 2), jc
    if name == "nodes-in-no-class":
        return disjoint & (np.arange(n) < 48), alive, jc
    # unbalanced: classes of 40, 12, 8 and 4 nodes
    cut = np.searchsorted([40, 52, 60], np.arange(n), side="right")
    return np.stack([cut == c for c in range(4)]), alive, jc


@pytest.mark.parametrize("name", ["disjoint", "overlapping", "dead-class",
                                  "nodes-in-no-class", "unbalanced"])
def test_owned_slots_from_kernel_inputs(name):
    """Each stream owns the union of its classes' rows, ascending, padded
    with -1; streams own disjoint nodes; the serial stream owns every
    class row; every node a job may take (``kernel_inputs``' elig) is
    owned by its stream.  ``kernel_inputs`` builds the slots with
    ``owned_slots`` from the host rows and its plan on the card only: on
    the CPU, where the plain version runs, it builds none."""
    masks, alive, jc = _layout_case(name)
    C, n = masks.shape
    rng = np.random.default_rng(1)
    total = np.tile([64, 1 << 10, 1 << 10], (n, 1)).astype(np.int32)
    state = convert.cluster_state(total, total, alive, None, device="cpu")
    J = len(jc)
    args = (torch.ones((J, 3), dtype=torch.int32),
            torch.as_tensor(rng.integers(1, 3, J), dtype=torch.int32),
            torch.full((J,), 60, dtype=torch.int32),
            torch.ones(J, dtype=torch.bool), torch.as_tensor(jc),
            torch.as_tensor(masks))
    plan = gpu_solver.plan_streams(jc, masks)
    assert (plan is None) == (name == "overlapping")
    out = gpu_solver.kernel_inputs(state, *args, max_nodes=2, plan=plan,
                                   class_rows=masks)
    jobs, nelig, elig, _, _, slot, owned, n_owned = out
    assert owned is None and n_owned is None
    S = 1 if plan is None else plan[1]
    soc = np.zeros(C, int) if plan is None else plan[0]
    owned, n_owned = gpu_solver.owned_slots(
        masks, None if plan is None else plan[0], S)
    assert owned.dtype == np.int32 and owned.shape[0] == S
    assert owned.shape[1] == n_owned.max() and n_owned.shape == (S,)
    seen = np.zeros(n, int)
    for s in range(S):
        mine = owned[s, :n_owned[s]]
        np.testing.assert_array_equal(
            mine, np.flatnonzero(masks[soc == s].any(axis=0)))
        assert (np.diff(mine) > 0).all()
        assert (owned[s, n_owned[s]:] == -1).all()
        seen[mine] += 1
    assert seen.max(initial=0) <= 1                  # disjoint
    np.testing.assert_array_equal(seen > 0, masks.any(axis=0))
    # every node a job's class may take lies in its stream's slots
    el = elig.numpy()
    stream_of_job = soc[jc]
    for c in range(C):
        for s in set(stream_of_job[jc == c].tolist()):
            assert set(np.flatnonzero(el[c])) <= set(
                owned[s, :n_owned[s]].tolist())


# (M, R, C, K) -> (state, bits): the smoke shapes (streamed and serial
# at N = 10,000, R = 3, C = 5) fit in shared memory; larger ones do not
_PLANS = [
    ((10_000, 3, 5, 2), ("shared", "shared")),
    ((2_500, 3, 4, 2), ("shared", "shared")),
    ((20_000, 3, 5, 2), ("global", "shared")),
    ((4_096, 3, 600, 3), ("shared", "global")),
    ((16_384, 3, 1_000, 3), ("global", "global")),
    ((10_240, 3, 0, 0), ("shared", "none")),
]


@pytest.mark.parametrize("shape,path", _PLANS,
                         ids=[f"M{p[0][0]}-C{p[0][2]}" for p in _PLANS])
def test_launch_plan_picks_the_path_by_size(shape, path):
    M, R, C, K = shape
    plan = gpu_solver.launch_plan(M, R, C, K)
    assert (plan.state, plan.bits) == path
    assert plan.smem_bytes <= gpu_solver.SMEM_LIMIT
    assert plan.smem_bytes == gpu_solver.smem_bytes(
        M, R, C, K, plan.state == "shared", plan.bits == "shared")
    if plan.state == "global":
        assert gpu_solver.smem_bytes(M, R, C, K, True, False) \
            > gpu_solver.SMEM_LIMIT


def test_smem_layout_mirrors_the_header():
    """The bytes of place::layout at the serial smoke shape, 512
    threads: 2 x 8 x 16 reduction keys, 17 block-minimum keys, the
    2,048-word job chunk, K winners, 10,000 16-byte slot records and 5 x
    313 bit words, each part rounded up to 16 bytes."""
    assert gpu_solver.THREADS == 512
    assert gpu_solver.smem_bytes(10_000, 3, 5, 2, True, True) == (
        2048 + 144 + 8192 + 16 + 160_000 + 6272)
    # a record holds R dims and the cost in whole int4s
    assert gpu_solver.smem_bytes(100, 4, 0, 0, True, False) \
        - gpu_solver.smem_bytes(100, 4, 0, 0, False, False) == 100 * 32
