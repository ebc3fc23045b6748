"""Tiny runs of every cell on the CPU through the harness's own path (the
chip's look skipped), the reference's pruned loops against plain loops, the
control that the check must refuse, and the faults it must catch."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from crane_bench import check, harness, spec
from crane_bench.reference import cycle as ref

ROOT = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _tiny(cell):
    """200 nodes and 2,000 pending, the batch cut at the backlog as at full
    size."""
    b = spec.load_benchmark()
    cfg = spec.load_config(b, spec.workload(b, cell)["config"])
    sched = dict(cfg["scheduler"], schedule_batch_size=2000)
    return {"nodes": 200, "pending": 2000, "scheduler": sched}


def _run(cell, seed=2**33 + 7, steps=3, trace=False, control=False):
    """A run whose window takes ``steps`` untraced steps."""
    seconds = steps * spec.load_cell(cell)["step_wall_s"]
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            overrides=_tiny(cell), control=control)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_run_agrees_with_the_reference(cell):
    result, numbers = _run(cell)
    assert result["correct"], result["checks"]
    b = spec.load_benchmark()
    want = {m["name"] for m in spec.metrics_for(b, cell, False)}
    assert set(result["metrics"]) == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert list(result)[-1] == "checks"
    assert numbers["start_mismatch"] == 0 and numbers["infeasible"] == 0
    # the cold and settle ticks, the warm steps, then the window's 3 steps
    warm = spec.load_traffic(spec.workload(b, cell)["traffic"])["warm_steps"]
    assert numbers["_ticks_checked"][-1] == 2 + warm + 3 - 1
    json.dumps(result)


def test_tiny_traced_run_reads_per_layer_metrics():
    result, _ = _run("northstar-backfill.steady", trace=True)
    assert result["correct"]
    assert {"prelude_ms", "priority_ms", "solve_head_ms",
            "tick_overhead_ms", "cycle_p95_ms"} <= set(result["metrics"])
    # no device on the CPU: nothing to read, so no share is reported
    assert "idle_pct" not in result["metrics"]
    assert "greedy_place_roofline" not in result["metrics"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert result["device"]["window_s"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_refused(cell):
    result, numbers = _run(cell, control=True)
    assert result["correct"]
    control_correct, checks = check.verdict(numbers["control"])
    assert not control_correct, checks
    # what the control does not replace is not compared, not read as 0
    assert "running_mismatch" not in checks and "wal_gap" not in checks


def _fault_unchanged(monkeypatch):
    from cranesched_tpu_torch.ctld.scheduler import JobScheduler

    monkeypatch.setattr(JobScheduler, "schedule_cycle",
                        lambda self, now: [])


def _fault_half_batch(monkeypatch):
    from cranesched_tpu_torch.ctld.scheduler import JobScheduler

    orig = JobScheduler._pending_candidates

    def half(self, now):
        cands = orig(self, now)
        return cands[:len(cands) // 2]

    monkeypatch.setattr(JobScheduler, "_pending_candidates", half)


def _fault_altered_answer(monkeypatch):
    from cranesched_tpu_torch.ctld.scheduler import JobScheduler

    orig = JobScheduler._commit

    def altered(self, ordered, placements, now, *args, **kw):
        nodes = placements.nodes.clone()
        placed = torch.nonzero(placements.placed).flatten()
        if len(placed):
            i = int(placed[0])
            # another node of the same partition (node i is in p<i mod 4>)
            n = len(self.meta.nodes)
            nodes[i, 0] = (int(nodes[i, 0]) + 4) % n
        placements = type(placements)(**{**placements.__dict__,
                                         "nodes": nodes})
        return orig(self, ordered, placements, now, *args, **kw)

    monkeypatch.setattr(JobScheduler, "_commit", altered)


FAULTS = {"unchanged": _fault_unchanged, "half_batch": _fault_half_batch,
          "altered_answer": _fault_altered_answer}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_incorrect(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result, _ = _run(cell)
    assert not result["correct"], result["checks"]


def _timeline(starts):
    """Two partitions of two nodes (8 cores, 16 GiB each) and three jobs of
    4 cores and 8 GiB on one node, in p0 but the last (p1), submitted before
    tick 0; ticks at 0, 1 and 2 s; runtimes long enough to outlast them."""
    from crane_bench import draws
    from crane_bench.reference import state

    cfg = {"nodes": 4, "partitions": 2, "node_cpu": [8, 8],
           "node_mem_gib": [16, 16]}
    cluster = draws.Cluster(cfg, 1)
    jobs = {"job_id": np.array([1, 2, 3]), "cpu": np.array([4, 4, 4]),
            "mem_gib": np.array([8, 8, 8]), "nodes": np.array([1, 1, 1]),
            "part": np.array([0, 0, 1]), "time_limit": np.array([600] * 3),
            "runtime": np.array([300] * 3), "submit_now": np.zeros(3),
            "submit_tick": np.array([0, 0, 1])}
    return state.Timeline(cluster, jobs, starts, [0.0, 1.0, 2.0])


@pytest.mark.parametrize("starts,bad", [
    ({1: (0.0, (0,)), 2: (1.0, (2,)), 3: (1.0, (1,))}, 0),
    # two jobs of 4 cores on node 0 fit its 8; the third on it does not
    ({1: (0.0, (0,)), 2: (2.0, (0,))}, 0),
    ({1: (0.0, (0,)), 2: (2.0, (0,)), 3: (2.0, (0,))}, 1 + 1),
    ({2: (1.0, (1,))}, 1),                # node 1 is in p1, the job in p0
    ({3: (0.0, (1,))}, 1),                # before the tick after its submit
    ({1: (0.0, (0, 2))}, 1),              # two nodes for a one-node job
    ({1: (0.5, (0,))}, 1),                # at no tick
    ({1: (0.0, (7,))}, 1),                # a node that does not exist
])
def test_feasibility_pass_over_every_tick(starts, bad):
    assert _timeline(starts).infeasible() == bad


def _loop_greedy(avail, cost, cpu_total, jobs, ar):
    starts = {}
    for jid, req, k, tl in zip(jobs["job_id"], jobs["req"],
                               jobs["node_num"], jobs["time_limit"]):
        fit = np.flatnonzero((avail >= req).all(axis=1))
        if fit.size < k:
            continue
        sel = fit[np.argsort(cost[fit], kind="stable")[:k]]
        avail[sel] -= req
        cost[sel] += ar.dcost(tl, req[0], cpu_total[sel])
        starts[int(jid)] = tuple(sorted(int(n) for n in sel))
    return starts


def _loop_head(ta, cost, cpu_total, edges, jobs, ar):
    n, T, _ = ta.shape
    starts, reserved = {}, 0
    for jid, req, k, tl in zip(jobs["job_id"], jobs["req"],
                               jobs["node_num"], jobs["time_limit"]):
        ok = np.zeros((n, T), bool)
        for s in range(T):
            e = min(int(np.searchsorted(edges, edges[s] + max(int(tl), 1))),
                    T)
            ok[:, s] = (ta[:, s:e] >= req).all(axis=(1, 2))
        can = np.flatnonzero(ok.sum(axis=0) >= k)
        if not can.size:
            continue
        s = int(can[0])
        e = min(int(np.searchsorted(edges, edges[s] + max(int(tl), 1))), T)
        fit = np.flatnonzero(ok[:, s])
        sel = fit[np.argsort(cost[fit], kind="stable")[:k]]
        ta[sel, s:e] -= req
        cost[sel] += ar.dcost(tl, req[0], cpu_total[sel])
        if s == 0:
            starts[int(jid)] = tuple(sorted(int(x) for x in sel))
        else:
            reserved += 1
    return starts, reserved


def _random_jobs(rng, m):
    return {"job_id": np.arange(1, m + 1),
            "req": np.stack([rng.integers(1, 17, m) * 256,
                             rng.integers(1, 33, m) * 1024,
                             np.zeros(m, np.int64)], axis=1),
            "node_num": rng.integers(1, 3, m),
            "time_limit": rng.integers(60, 8000, m)}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_pruned_greedy_equals_plain_loop(seed):
    rng = np.random.default_rng(seed)
    n = 40
    nodes = np.arange(n)
    avail = np.stack([rng.integers(32, 129, n) * 256,
                      rng.integers(64, 513, n) * 1024,
                      np.zeros(n, np.int64)], axis=1)
    cost = rng.integers(0, 50, n)
    cpu_total = avail[:, 0].astype(np.float32)
    jobs = _random_jobs(rng, 300)
    ar = ref.Arith()
    part = ref.Partition(nodes, avail, cost, cpu_total)
    got = {}
    ref.greedy(ar, part, part.avail, jobs, 8, got)
    want = _loop_greedy(avail.copy(), cost.copy(), cpu_total, jobs, ar)
    assert got == want
    assert len(got) > 20


@pytest.mark.parametrize("seed", [1, 2])
def test_pruned_head_equals_plain_loop(seed):
    rng = np.random.default_rng(seed)
    n, T = 24, 16
    edges = np.arange(T + 1) * 60
    avail = np.stack([rng.integers(32, 65, n) * 256,
                      rng.integers(64, 129, n) * 1024,
                      np.zeros(n, np.int64)], axis=1)
    ta = avail[:, None, :] + np.cumsum(
        rng.integers(0, 2, (n, T, 1)) * np.array([256, 1024, 0]), axis=1)
    ta[:, 0] = avail
    cost = rng.integers(0, 50, n)
    cpu_total = avail[:, 0].astype(np.float32)
    jobs = _random_jobs(rng, 150)
    ar = ref.Arith()
    part = ref.Partition(np.arange(n), avail, cost, cpu_total)
    got = {}
    reserved = ref.backfill_head(
        ar, part, np.ascontiguousarray(ta.transpose(2, 0, 1)).astype(np.int32),
        edges, jobs, 8, got)
    want, want_reserved = _loop_head(ta.copy(), cost.copy(), cpu_total,
                                     edges, jobs, ar)
    assert (got, reserved) == (want, want_reserved)
    assert reserved > 0 and got


def test_bf16_rounding():
    x = np.array([1.0, 1.00390625, 3.14159265, -2.5e-3], np.float32)
    y = ref.to_bf16(x)
    assert y[0] == 1.0 and y[1] == 1.0
    assert np.all(y.view(np.uint32) & 0xFFFF == 0)
    assert np.allclose(y, x, rtol=2 ** -8)


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "crane_bench.run", "--workload",
         CELLS[0], "--seed", str(2**33), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=600, env=env)


def test_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _cli(ROOT)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_cli_fails_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "crane_bench", tmp_path / "crane_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _cli(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.card
def test_cli_runs_a_cell_on_the_card(card):
    out = _cli(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
