#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cranesched_tpu_torch``) on one NVIDIA
GPU and hold its kernel against its plain PyTorch version.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, from the checkout's sources;
3. kernel vs plain at full width (N = 10,000 nodes, R = 3, 100,000
   jobs): the greedy-placement kernel through ``solve_greedy_gpu_auto``
   on the card against the plain version on the same inputs, bitwise,
   for 4 disjoint classes (streamed, S = 4), overlapping classes
   (serial), and small edge cases; kernel and plain times;
4. the main path: ``JobScheduler(meta, SchedulerConfig(backfill=False))``
   + ``SimCluster`` at 100,000 pending jobs x 10,000 nodes, two cycles
   with completions and a top-up submission between them, once on four
   disjoint partitions and once with an overlapping partition; the
   kernel's launch count, the first cycle's placements against the plain
   version, and the ledger invariants are checked after every cycle;
5. one JSON line describing every kernel, then the card line, then the
   result line ``{"ok": true, "device": {...}}``.

It imports nothing of the JAX package.  The kernel build goes to
``build/kernels/`` (see ``cranesched_tpu_torch/kernels/build.py``).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_NODES = 10_000
N_JOBS = 100_000
TOPUP_JOBS = 5_000
# H100 SXM int32 rate: NVIDIA's data sheet gives 67 TFLOP/s float32,
# counting an FMA as two operations on 128 float32 lanes per SM; an SM
# has 64 int32 lanes (Hopper architecture white paper), so int32 runs at
# a quarter of that
INT32_OPS_PER_S = 67e12 / 4
HBM_BYTES_PER_S = 3.35e12
DEVICE = "cuda"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cluster_arrays(rng, n):
    """Node totals as bench.py builds them: cpu 32-128, mem 64-512 GiB."""
    from cranesched_tpu_torch.ops.resources import ResourceLayout

    lay = ResourceLayout()
    total = np.stack([lay.encode(cpu=float(rng.integers(32, 129)),
                                 mem_bytes=int(rng.integers(64, 513)) << 30,
                                 is_capacity=True) for _ in range(n)])
    return lay, total


def job_arrays(rng, lay, j, max_gang=2):
    req = np.stack([lay.encode(cpu=float(c), mem_bytes=int(m) << 30)
                    for c, m in zip(rng.integers(1, 17, j),
                                    rng.integers(1, 33, j))])
    return (req, rng.integers(1, max_gang + 1, j).astype(np.int32),
            rng.integers(60, 86400, j).astype(np.int32), np.ones(j, bool))


def host(*ts):
    return [t.cpu().numpy() for t in ts]


def kernel_vs_plain(name, total, alive, cost, jobs, job_class, masks,
                    max_nodes, expect_streams, timed=False):
    """One solve through the entry point on the card and through the
    plain version on the CPU, from the same inputs; bitwise equal.
    Returns the kernel-level measurements."""
    import torch

    from cranesched_tpu_torch.models import gpu_solver as g
    from cranesched_tpu_torch.models.solver import make_cluster_state

    req, node_num, time_limit, valid = jobs
    cuda = [torch.as_tensor(x, device=DEVICE)
            for x in (req, node_num, time_limit, valid, job_class, masks)]
    plan = g.plan_streams(job_class, masks)
    streams = plan[1] if plan is not None else 1
    check(streams == expect_streams,
          f"{name}: planned {streams} streams, expected {expect_streams}")

    # the entry point on the card (the kernel)
    state = make_cluster_state(total, total, alive, cost, device=DEVICE)
    p, s = g.solve_greedy_gpu_auto(state, *cuda, max_nodes=max_nodes,
                                   plan=plan)
    torch.cuda.synchronize()
    k_out = host(p.placed, p.nodes, p.reason, s.avail, s.cost)

    # the plain version on the same kernel inputs, on the CPU
    fresh = make_cluster_state(total, total, alive, cost, device=DEVICE)
    jobs_t, nelig, elig, cpu_total, K, slot = g.kernel_inputs(
        fresh, *cuda, max_nodes=max_nodes, plan=plan)
    avail_c, cost_c = fresh.avail.cpu(), fresh.cost.cpu()
    t0 = time.perf_counter()
    placed, reason, chosen = g.greedy_place_plain(
        jobs_t.cpu(), nelig.cpu(), elig.cpu(), cpu_total.cpu(), avail_c,
        cost_c, K)
    plain_s = time.perf_counter() - t0
    sl = slot.cpu()
    p_out = [x.numpy() for x in (
        placed.reshape(-1)[sl] != 0, chosen.reshape(-1, K)[sl],
        reason.reshape(-1)[sl], avail_c, cost_c)]
    err = 0
    for what, a, b in zip(("placed", "nodes", "reason", "avail", "cost"),
                          k_out, p_out):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{name}: {what} shape/dtype {a.shape}/{a.dtype} vs "
              f"{b.shape}/{b.dtype}")
        check(np.array_equal(a, b), f"{name}: {what} differs from plain")
        if a.size:
            err = max(err, int(np.abs(a.astype(np.int64)
                                      - b.astype(np.int64)).max()))
    print(f"[kernel-vs-plain] {name}: J={len(req)} N={len(total)} "
          f"K={K} streams={streams} placed={int(k_out[0].sum())} "
          f"bitwise=True plain_cpu_s={plain_s:.3f}", flush=True)
    out = {"max_abs_err": err, "plain_s": plain_s, "streams": streams,
           "K": K, "J": len(req), "C": int(masks.shape[0])}
    if not timed:
        return out

    # kernel time: CUDA events around the kernel alone, fresh state
    # copies per run (the entry call above was the warm-up)
    times = []
    for _ in range(5):
        a, c = fresh.avail.clone(), fresh.cost.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.greedy_place(jobs_t, nelig, elig, cpu_total, a, c, K)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    # the least work: per admissible job, over its class's eligible
    # nodes, the R compares + eligibility test, and a compare + min per
    # pass (node_num passes)
    jn = jobs_t.reshape(-1, jobs_t.shape[-1]).cpu().numpy().astype(np.int64)
    R = jn.shape[1] - 4
    nn, live, cls = jn[:, R], jn[:, R + 2] != 0, jn[:, R + 3]
    run = live & (nn >= 1) & (nn <= K)
    ops = float((nelig.cpu().numpy()[cls[run]] * (R + 1 + 2 * nn[run])).sum())
    J, N = int(live.sum()), len(total)
    nbytes = (J * (R + 4) * 4 + int(nelig.numel()) * 4 + int(elig.numel())
              + N * 4 + 2 * N * R * 4 + 2 * N * 4 + J * (2 + K) * 4)
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out.update(ms=float(np.median(times)), ms_runs=times, ops=ops,
               bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    print(f"[kernel-time] {name}: kernel_ms={out['ms']:.3f} "
          f"runs={[round(t, 3) for t in times]} bound_ms="
          f"{out['bound_ms']:.4f} ({out['bound_by']}) plain_cpu_ms="
          f"{plain_s * 1e3:.1f}", flush=True)
    return out


def phase_kernels():
    rng = np.random.default_rng(0)
    lay, total = cluster_arrays(rng, N_NODES)
    alive = rng.random(N_NODES) > 0.005
    cost = rng.integers(0, 50_000, N_NODES).astype(np.int32)
    node_part = np.arange(N_NODES) % 4
    disjoint = np.stack([node_part == c for c in range(4)])
    jobs = job_arrays(rng, lay, N_JOBS)
    res = {}
    # (a) four disjoint partitions: the streamed kernel, S = 4
    res["stream"] = kernel_vs_plain(
        "disjoint-4", total, alive, cost, jobs,
        rng.integers(0, 4, N_JOBS).astype(np.int32), disjoint, 2, 4,
        timed=True)
    # (b) plus one class over every node: the serial kernel
    overlap = np.concatenate([disjoint, np.ones((1, N_NODES), bool)])
    jc = rng.integers(0, 4, N_JOBS).astype(np.int32)
    jc[rng.random(N_JOBS) < 0.1] = 4
    res["serial"] = kernel_vs_plain(
        "overlapping", total, alive, cost, jobs, jc, overlap, 2, 1,
        timed=True)
    # (c) edge cases at small size
    n = 256
    lay, small = cluster_arrays(rng, n)
    part = np.arange(n) % 4
    masks4 = np.stack([part == c for c in range(4)])
    empty = (np.zeros((0, 3), np.int32), np.zeros(0, np.int32),
             np.zeros(0, np.int32), np.zeros(0, bool))
    kernel_vs_plain("no-jobs", small, np.ones(n, bool), None, empty,
                    np.zeros(0, np.int32), masks4, 2, 1)
    few = job_arrays(rng, lay, 400)
    kernel_vs_plain("all-dead", small, np.zeros(n, bool), None, few,
                    rng.integers(0, 4, 400).astype(np.int32), masks4, 2, 4)
    kernel_vs_plain("cost-ties", small, np.ones(n, bool),
                    np.zeros(n, np.int32), few, np.zeros(400, np.int32),
                    np.ones((1, n), bool), 2, 1)
    gangs = job_arrays(rng, lay, 600, max_gang=9)   # some exceed K = 8
    jc = rng.integers(0, 4, 600).astype(np.int32)
    kernel_vs_plain("gangs-k8-stream", small, rng.random(n) > 0.1,
                    rng.integers(0, 100, n).astype(np.int32), gangs, jc,
                    masks4, 8, 4)
    kernel_vs_plain("gangs-k8-serial", small, rng.random(n) > 0.1,
                    rng.integers(0, 100, n).astype(np.int32), gangs, jc,
                    np.concatenate([masks4, np.ones((1, n), bool)]), 8, 1)
    return res


def check_ledger(sched, label):
    """avail >= 0; avail + running allocations == total; running jobs
    inside their partition; the device-resident state equals the host
    ledger."""
    meta = sched.meta
    ids = sorted(meta.nodes)
    avail = np.stack([meta.nodes[i].avail for i in ids]).astype(np.int64)
    total = np.stack([meta.nodes[i].total for i in ids]).astype(np.int64)
    check((avail >= 0).all(), f"{label}: negative avail")
    used = np.zeros_like(total)
    for job in sched.running.values():
        for n, a in zip(job.node_ids, sched._job_alloc(job)):
            used[n] += a
        check(set(job.node_ids)
              <= meta.partitions[job.spec.partition].node_ids,
              f"{label}: job {job.job_id} outside its partition")
    check((avail + used == total).all(),
          f"{label}: avail + allocations != total")
    state = sched._resident._state
    check(state is not None, f"{label}: no resident state")
    check(np.array_equal(state.avail.cpu().numpy(), avail),
          f"{label}: device-resident avail differs from the host ledger")


def phase_cycle(overlap: bool):
    """The main path at the north-star size; returns per-cycle stats."""
    import torch

    from cranesched_tpu_torch import convert
    from cranesched_tpu_torch.craned.sim import SimCluster
    from cranesched_tpu_torch.ctld import (
        JobScheduler,
        JobSpec,
        MetaContainer,
        ResourceSpec,
        SchedulerConfig,
    )
    from cranesched_tpu_torch.models import gpu_solver as g

    label = "overlapping" if overlap else "disjoint"
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    meta = MetaContainer()
    for i in range(N_NODES):
        parts = (f"p{i % 4}",) + (("all",) if overlap else ())
        meta.add_node(f"b{i:05d}", meta.layout.encode(
            cpu=float(rng.integers(32, 129)),
            mem_bytes=int(rng.integers(64, 513)) << 30, is_capacity=True),
            partitions=parts)
        meta.craned_up(i)
    sched = JobScheduler(meta, SchedulerConfig(backfill=False),
                         device=DEVICE)
    sim = SimCluster(sched)
    sim.wire(sched)

    def submit(k, now):
        for _ in range(k):
            part = f"p{rng.integers(0, 4)}"
            if overlap and rng.random() < 0.1:
                part = "all"
            tl = int(rng.integers(60, 86400))
            check(sched.submit(JobSpec(
                res=ResourceSpec(cpu=float(rng.integers(1, 17)),
                                 mem_bytes=int(rng.integers(1, 33)) << 30),
                node_num=int(rng.integers(1, 3)), time_limit=tl,
                partition=part,
                sim_runtime=float(rng.integers(30, 1800))), now=now) > 0,
                "submit rejected")

    submit(N_JOBS, 0.0)
    print(f"[cycle:{label}] setup {time.perf_counter() - t0:.1f}s "
          f"({N_NODES} nodes, {len(sched.pending)} pending)", flush=True)

    # record the first solve's inputs and outputs for the plain check
    record = {}
    solve = sched._solve_gpu

    def spy(avail, total, alive, cost0, batch, max_nodes, resident_ok=False):
        out = solve(avail, total, alive, cost0, batch, max_nodes,
                    resident_ok=resident_ok)
        if "in" not in record:
            record["in"] = (avail.copy(), total.copy(), alive.copy(),
                            cost0.copy(), host(batch.req, batch.node_num,
                                               batch.time_limit,
                                               batch.valid),
                            batch.job_class_np.copy(),
                            batch.class_rows_np.copy(), max_nodes)
            record["out"] = host(out[0].placed, out[0].nodes,
                                 out[0].reason)
        return out

    sched._solve_gpu = spy
    want = "cuda" if overlap else "cuda-stream"
    rows = []
    now = 100.0
    # the main path's launch count: zeroed just before, read just after
    g.greedy_place.launches = 0
    for cycle in range(2):
        if cycle:
            now += 900.0
            done = sim.advance_to(now)
            submit(TOPUP_JOBS, now)
            print(f"[cycle:{label}] advance_to({now}): {done} completions,"
                  f" +{TOPUP_JOBS} submitted", flush=True)
        before = g.greedy_place.launches
        t1 = time.perf_counter()
        started = sched.schedule_cycle(now=now)
        wall = time.perf_counter() - t1
        last = dict(sched.stats["last_cycle"])
        check(g.greedy_place.launches == before + 1,
              f"{label} cycle {cycle}: kernel launched "
              f"{g.greedy_place.launches - before} times")
        check(last["solver"] == want,
              f"{label} cycle {cycle}: solver {last['solver']} != {want}")
        check(len(started) > 0, f"{label} cycle {cycle}: placed nothing")
        if cycle:
            check(last["resident"] in ("patch", "ledger"),
                  f"{label}: second cycle resident mode {last['resident']}")
        check_ledger(sched, f"{label} cycle {cycle}")
        last.update(cycle=cycle, placed=len(started), wall_s=wall)
        rows.append(last)
        print(f"[cycle:{label}] cycle {cycle}: placed {len(started)} "
              f"wall {wall:.3f}s stats {json.dumps(last)}", flush=True)

    launches = g.greedy_place.launches
    check(launches == len(rows),
          f"{label}: {launches} launches for {len(rows)} solved cycles")

    # the first cycle against the plain version on the same snapshot
    # and batch, through the same entry point on the CPU
    (avail, total, alive, cost0, (req, nn, tl, valid), jc, rows_np,
     max_nodes) = record["in"]
    state = convert.cluster_state(avail, total, alive, cost0, device="cpu")
    t2 = time.perf_counter()
    plan = g.plan_streams(jc, rows_np)
    p, _ = g.solve_greedy_gpu_auto(
        state, torch.from_numpy(req), torch.from_numpy(nn),
        torch.from_numpy(tl), torch.from_numpy(valid),
        torch.from_numpy(jc), torch.from_numpy(rows_np),
        max_nodes=max_nodes, plan=plan)
    for what, a, b in zip(("placed", "nodes", "reason"), record["out"],
                          host(p.placed, p.nodes, p.reason)):
        check(np.array_equal(a, b),
              f"{label}: first cycle {what} differs from plain")
    print(f"[cycle:{label}] first cycle == plain version (bitwise, "
          f"{len(req)} jobs, plain {time.perf_counter() - t2:.1f}s)",
          flush=True)
    return rows, launches


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from cranesched_tpu_torch.kernels import build
    from cranesched_tpu_torch.models import gpu_solver as g

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[device] {kind} | nvidia-smi: {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    report = build.build_all()
    print(f"[build] {time.perf_counter() - t0:.2f}s "
          + ", ".join(f"{k}: {v['seconds']:.2f}s" for k, v in
                      report.items()), flush=True)
    for name, v in report.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # 3. kernel vs plain
    t0 = time.perf_counter()
    kres = phase_kernels()
    print(f"[kernel-vs-plain] {time.perf_counter() - t0:.1f}s", flush=True)

    # 4. the main path, on disjoint and on overlapping partitions
    cycles_d, launches_d = phase_cycle(overlap=False)
    cycles_o, launches_o = phase_cycle(overlap=True)
    cycles = cycles_d + cycles_o
    launches = launches_d + launches_o

    st, se = kres["stream"], kres["serial"]
    kernels = [{
        "name": "greedy_place",
        "route": "cuda",
        "source": "cranesched_tpu_torch/csrc/greedy_place.cu",
        "replaces": "cranesched_tpu/models/pallas_solver.py:89",
        "jax_function": "cranesched_tpu.models.pallas_solver."
                        "solve_greedy_pallas_auto",
        "launches": launches,
        "match": "bitwise",
        "max_abs_err": max(st["max_abs_err"], se["max_abs_err"]),
        "ms": st["ms"],
        "kernel_ms": st["ms"],
        "serial_ms": se["ms"],
        "plain_ms": st["plain_s"] * 1e3,
        "plain_serial_ms": se["plain_s"] * 1e3,
        "plain_device": "cpu",
        "bound_ms": st["bound_ms"],
        "bound_by": st["bound_by"],
        "serial_bound_ms": se["bound_ms"],
        "library_ms": None,
        "shapes": {"N": N_NODES, "R": 3, "J": st["J"], "K": st["K"],
                   "S": st["streams"], "C": st["C"],
                   "serial_C": se["C"]},
    }]
    print(json.dumps({"cycles": cycles}), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
