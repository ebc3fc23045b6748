"""The port's speculative and blocked solvers against the JAX package's and
against ``solve_greedy``, bit for bit (the cases of
``tests/test_speculative_parity.py``).

Placed, nodes, reason, avail and the int32 cost ledger must be identical
whatever the candidate list, group or block size; the tie pile-ups force
a full-width fallback or a one-job block at every step.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from cranesched_tpu.models import solver as jsolver
from cranesched_tpu.models import speculative as jspec
from cranesched_tpu.ops.resources import ResourceLayout
from cranesched_tpu_torch.models import solver as tsolver
from cranesched_tpu_torch.models import speculative as tspec
from test_sharded_parity import _random_problem
from test_torch_sharded import _assert_same, _port_jobs, _port_state


def _check(jstate, jjobs, max_nodes, jfn, tfn, **kw):
    """The JAX function, the port's and the port's solve_greedy on the
    same inputs; returns the port's placements and its stats."""
    jp, js = jfn(jstate, jjobs, max_nodes=max_nodes, **kw)
    stats = {}
    tp, ts = tfn(_port_state(jstate), _port_jobs(jjobs),
                 max_nodes=max_nodes, stats=stats, **kw)
    gp, gs = tsolver.solve_greedy(_port_state(jstate), _port_jobs(jjobs),
                                  max_nodes=max_nodes)
    _assert_same(jp, js, tp, ts)
    _assert_same(jp, js, gp, gs)
    return tp, stats


def _pileup(max_j=20, nodes=4):
    """All costs zero, time limits zero (dcost 0): every job wants node
    0 and the tie persists."""
    lay = ResourceLayout()
    total = np.tile(lay.encode(cpu=64, is_capacity=True), (nodes, 1))
    state = jsolver.make_cluster_state(total.copy(), total,
                                       np.ones(nodes, bool),
                                       np.zeros(nodes, np.float32))
    jobs = jsolver.JobBatch(
        req=jnp.asarray(np.tile(lay.encode(cpu=1), (max_j, 1))),
        node_num=jnp.ones(max_j, jnp.int32),
        time_limit=jnp.zeros(max_j, jnp.int32),
        part_mask=jnp.ones((max_j, nodes), bool),
        valid=jnp.ones(max_j, bool))
    return state, jobs


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("r_cand,group", [(4, 4), (32, 8)])
def test_speculative_matches_jax_random(seed, r_cand, group):
    rng = np.random.default_rng(seed)
    state, jobs = _random_problem(rng, num_jobs=100, num_nodes=40,
                                  max_nodes=4)
    _, stats = _check(state, jobs, 4, jspec.solve_speculative,
                      tspec.solve_speculative, r_cand=r_cand, group=group)
    assert 0 <= int(stats["fallbacks"]) <= 100


def test_speculative_tie_pileup_all_same_node():
    state, jobs = _pileup()
    tp, stats = _check(state, jobs, 1, jspec.solve_speculative,
                       tspec.solve_speculative, r_cand=2, group=4)
    assert set(tp.nodes.reshape(-1).tolist()) == {0}
    # node 0 stays cheapest: every job with another node at its cost as
    # its threshold pair is conclusive; the list holds 2 of 4 nodes
    assert int(stats["fallbacks"]) == 0


def test_speculative_gangs_and_saturation():
    lay = ResourceLayout()
    total = np.tile(lay.encode(cpu=8, is_capacity=True), (6, 1))
    state = jsolver.make_cluster_state(total.copy(), total,
                                       np.ones(6, bool),
                                       np.arange(6, dtype=np.float32))
    J = 12
    jobs = jsolver.JobBatch(
        req=jnp.asarray(np.tile(lay.encode(cpu=8), (J, 1))),
        node_num=jnp.asarray([2, 1, 3, 1, 2, 1] * 2, jnp.int32),
        time_limit=jnp.full(J, 3600, jnp.int32),
        part_mask=jnp.ones((J, 6), bool), valid=jnp.ones(J, bool))
    tp, stats = _check(state, jobs, 4, jspec.solve_speculative,
                       tspec.solve_speculative, r_cand=3, group=5)
    assert int(tp.placed.sum()) == 3
    # saturated candidate lists send later jobs to the full width
    assert int(stats["fallbacks"]) > 0


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("block_size", [4, 32])
def test_blocked_matches_jax_random(seed, block_size):
    rng = np.random.default_rng(seed)
    state, jobs = _random_problem(rng, num_jobs=100, num_nodes=40,
                                  max_nodes=4)
    _, stats = _check(state, jobs, 4, jspec.solve_blocked,
                      tspec.solve_blocked, block_size=block_size)
    assert 100 / block_size <= stats["blocks"] <= 100


def test_blocked_tie_pileup_worst_case():
    state, jobs = _pileup()
    tp, stats = _check(state, jobs, 1, jspec.solve_blocked,
                       tspec.solve_blocked, block_size=8)
    assert set(tp.nodes.reshape(-1).tolist()) == {0}
    # every rank-shifted proposal is wrong: one job a block
    assert stats["blocks"] == 20


def test_blocked_spread_regime_and_partitions():
    lay = ResourceLayout()
    rng = np.random.default_rng(3)
    N, J = 32, 64
    total = np.tile(lay.encode(cpu=64, is_capacity=True), (N, 1))
    state = jsolver.make_cluster_state(total.copy(), total,
                                       np.ones(N, bool),
                                       rng.random(N).astype(np.float32))
    part = np.arange(N) % 2
    jpart = rng.integers(0, 2, J)
    jobs = jsolver.JobBatch(
        req=jnp.asarray(np.tile(lay.encode(cpu=4), (J, 1))),
        node_num=jnp.asarray(rng.integers(1, 3, J), jnp.int32),
        time_limit=jnp.full(J, 36000, jnp.int32),
        part_mask=jnp.asarray(jpart[:, None] == part[None, :]),
        valid=jnp.ones(J, bool))
    _, stats = _check(state, jobs, 2, jspec.solve_blocked,
                      tspec.solve_blocked, block_size=16)
    # the same-row offsets make most proposals hold
    assert stats["blocks"] < J // 2


def test_speculative_group_bigger_than_batch():
    rng = np.random.default_rng(7)
    state, jobs = _random_problem(rng, num_jobs=10, num_nodes=16,
                                  max_nodes=2)
    _check(state, jobs, 2, jspec.solve_speculative,
           tspec.solve_speculative, r_cand=64, group=64)


def test_phase_one_chunks_give_the_same_candidates(monkeypatch):
    """Phase 1 in chunks of 7 jobs equals the one-chunk pass."""
    rng = np.random.default_rng(11)
    state, jobs = _random_problem(rng, num_jobs=60, num_nodes=24,
                                  max_nodes=3)
    monkeypatch.setattr(tspec, "_PHASE1_ELEMS", 7 * 24)
    _check(state, jobs, 3, jspec.solve_speculative,
           tspec.solve_speculative, r_cand=5, group=8)


def test_empty_batch():
    rng = np.random.default_rng(1)
    state, jobs = _random_problem(rng, num_jobs=4, num_nodes=8,
                                  max_nodes=2)
    for fn in (tspec.solve_speculative, tspec.solve_blocked):
        tjobs = _port_jobs(jobs)
        empty = tsolver.JobBatch(req=tjobs.req[:0],
                                 node_num=tjobs.node_num[:0],
                                 time_limit=tjobs.time_limit[:0],
                                 part_mask=tjobs.part_mask[:0],
                                 valid=tjobs.valid[:0])
        p, s = fn(_port_state(state), empty, max_nodes=2)
        assert p.nodes.shape == (0, 2) and p.placed.dtype == torch.bool
        np.testing.assert_array_equal(s.avail.numpy(),
                                      np.asarray(state.avail))
