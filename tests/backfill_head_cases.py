"""Backfill head problems for the card: ``head_problem`` draws one and
``head_vs_plain`` holds the kernel (``solver_time.backfill_head``) against
its plain loop (``solve_backfill_plain``) on it.

Shared by ``tests/test_torch_backfill_card.py`` and ``chip_smoke.py``
(which puts this directory on ``sys.path``); imports neither JAX nor the
JAX package, so it runs on a machine that has only the port.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cranesched_tpu_torch.models import solver_time as st
from cranesched_tpu_torch.ops.resources import ResourceLayout


def head_problem(seed, n, T, J, K, horizon=None, contended=False,
                 device="cuda"):
    """A backfill head at ``n`` nodes on a ``T``-bucket 60 s grid (a week's
    geometric grid with ``horizon``): nodes of 32-128 CPUs and 64-512 GiB,
    jobs of 1-16 CPUs and 1-32 GiB in gangs of 1-``K``, on four disjoint
    partitions, over a saturated cluster (each node 0-4% free now) whose
    ``8 n`` running jobs free over the window.  ``contended``: every job
    2-4x larger, 10% of the rows invalid, one partition of a single node,
    time limits down to -5 s.  Returns ``(state, jobs, edges)`` on
    ``device``."""
    rng = np.random.default_rng(seed)
    lay = ResourceLayout()
    total = np.stack([lay.encode(cpu=float(rng.integers(32, 129)),
                                 mem_bytes=int(rng.integers(64, 513)) << 30,
                                 is_capacity=True) for _ in range(n)])
    unit = np.stack([lay.encode(cpu=1.0, mem_bytes=0),
                     lay.encode(cpu=0.0, mem_bytes=1 << 30)])

    def draw(k):
        # (cpu, GiB) per row, encoded
        return (np.stack([rng.integers(1, 17, k), rng.integers(1, 33, k)],
                         axis=1) @ unit).astype(np.int32)

    M = 8 * n
    run_req = draw(M)
    run_nodes = rng.integers(0, n, (M, 1)).astype(np.int32)
    avail = (total * rng.uniform(0.0, 0.04, (n, 1))).astype(np.int32)
    run_end = rng.integers(1, T + 4, M).astype(np.int32)
    alive = rng.random(n) > 0.005
    cost = rng.integers(0, 50_000, n).astype(np.int32)
    state = st.make_timed_state(avail, total, alive, run_nodes, run_req,
                                run_end, T, cost, device=device)
    req = draw(J)
    nn = rng.integers(1, max(K, 1) + 1, J).astype(np.int32)
    tl = rng.integers(60, 86400, J).astype(np.int32)
    valid = np.ones(J, bool)
    part = np.arange(n) % 4
    if contended:
        req = req * rng.integers(2, 5, (J, 1)).astype(np.int32)
        valid = rng.random(J) > 0.1
        tl = rng.integers(-5, 86400, J).astype(np.int32)
        part[part == 3] = 2
        part[-1] = 3
    pm = part[None, :] == rng.integers(0, 4, J)[:, None]
    jobs = st.TimedJobBatch(*(torch.from_numpy(np.ascontiguousarray(x)).to(
        device) for x in (req, nn, tl, pm, valid)))
    grid = st.TimeGrid(T, 60.0, horizon=horizon)
    return state, jobs, grid.edges_tensor(device)


def head_vs_plain(label, seed, n, T, J, K, horizon=None, contended=False,
                  timed=False):
    """The backfill head kernel against ``solve_backfill_plain`` on the
    card, on the same inputs, bitwise: placed, start bucket, nodes,
    reason, and the post-solve time map and cost ledger; one launch for
    the kernel's side and none for the plain side.  ``timed``: each
    side's ms (CUDA events over one call after a warm-up call).  Raises
    AssertionError on a difference; returns the solve's row (its launch
    plan, the placed, future and no-start counts, and the times)."""
    state, jobs, edges = head_problem(seed, n, T, J, K, horizon, contended)
    plan = st.head_launch_plan(n, T, state.time_avail.shape[2], K,
                               torch.cuda.get_device_properties(
                                   0).multi_processor_count)

    def fresh():
        return dataclasses.replace(state, time_avail=state.time_avail.clone(),
                                   cost=state.cost.clone())

    def event_ms(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    outs, ms = {}, {}
    for side, solve in (("kernel", st.solve_backfill),
                        ("plain", st.solve_backfill_plain)):
        if timed:
            solve(fresh(), jobs, edges=edges, max_nodes=K)
        before = st.backfill_head.launches
        s2 = fresh()
        (p, _), ms[side] = event_ms(lambda: solve(s2, jobs, edges=edges,
                                                  max_nodes=K))
        launched = st.backfill_head.launches - before
        assert launched == (side == "kernel" and J > 0), \
            f"{label}: {side} launched the kernel {launched} times"
        outs[side] = [t.cpu().numpy() for t in (
            p.placed, p.start_bucket, p.nodes, p.reason, s2.time_avail,
            s2.cost)]
    for what, a, b in zip(("placed", "start_bucket", "nodes", "reason",
                           "time_avail", "cost"), outs["kernel"],
                          outs["plain"]):
        assert a.shape == b.shape and np.array_equal(a, b), \
            f"{label}: the kernel's {what} differs from the plain loop"
    placed, start = outs["plain"][0], outs["plain"][1]
    row = {"label": label, "N": n, "T": T, "J": J, "K": K,
           "blocks": plan.blocks, "slice": plan.slice, "words": plan.words,
           "state": plan.state, "smem_bytes": plan.smem_bytes,
           "placed": int(placed.sum()),
           "future": int((placed & (start > 0)).sum()),
           "no_start": int((start == st.NO_START).sum())}
    if timed:
        row.update(kernel_ms=ms["kernel"], plain_ms=ms["plain"])
    return row
