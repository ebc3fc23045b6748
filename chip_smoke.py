#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``cranesched_tpu_torch``) on one NVIDIA
GPU and hold its kernels against their plain PyTorch versions.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of the port, from the checkout's sources,
   one ``nvcc`` per source, all started together;
3. kernel vs plain at full width (N = 10,000 nodes, R = 3, 100,000
   jobs): the greedy-placement kernel through ``solve_greedy_gpu_auto``
   on the card against the plain version on the same inputs, bitwise,
   for 4 disjoint classes (streamed, S = 4), overlapping classes
   (serial), the owned state and the class bits in device memory
   (forced by size: 20,000 nodes; 600 and 1,000 classes), gangs above
   the kernel's 8 keys per thread (K = 32), unbalanced streams, streams
   that own no alive node or no node, and small edge cases; kernel and
   plain times, threads per block, shared-memory bytes and the path
   taken;
4. the attribution kernels (``tools/kattr.py``'s variants) at J =
   100,000, N = 10,000, R = 3, BJ = 256: each variant against its plain
   version on the card, bitwise, and with no feasible node and with
   exactly one at small size; then the attribution tool's path
   (``kattr.attribute``) with the
   launch counts zeroed before and read after (one warm-up and
   ``kattr.REPS`` timed launches per variant): each variant's median
   CUDA-event time, its time per job and its bound, beside the real
   kernel on the same data;
5. the immediate-fit path: ``JobScheduler(meta,
   SchedulerConfig(backfill=False))`` + ``SimCluster`` at 100,000
   pending jobs x 10,000 nodes, two cycles with completions and a top-up
   submission between them, once on four disjoint partitions and once
   with an overlapping partition; the kernel's launch count and the
   ledger invariants are checked after every cycle, and each layout's
   first cycle against the plain version on the batch the scheduler
   fed the kernel;
6. the default path: ``JobScheduler(meta, SchedulerConfig())`` at the
   same size on four disjoint partitions, two split backfill cycles, the
   second contended: its top-up adds high-QoS gangs of 8 x 32 CPUs on
   one partition, more than it holds now, so the head reserves future
   starts.  The greedy kernel launches once per cycle (the tail); each
   cycle's head (1,024 jobs on the [10,000, 64, 3] time map) equals the
   port's time-axis solve on the CPU from the recorded inputs; the
   second cycle backfills and its future starts pend ``Priority`` or
   ``Resource``; the first cycle's tail equals the kernel's plain
   version on the recorded inputs; the ledger invariants hold after
   every cycle;
7. one JSON line describing every kernel, then the card line, then the
   result line ``{"ok": true, "device": {...}}``.

It imports nothing of the JAX package.  The kernel build goes to
``build/kernels/`` (see ``cranesched_tpu_torch/kernels/build.py``).
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

N_NODES = 10_000
N_JOBS = 100_000
TOPUP_JOBS = 5_000
# the contended backfill cycle's high-QoS gangs (8 nodes x 32 CPUs, 10
# min) on partition p0: 750 at 10,000 nodes, ~80% of p0's CPUs
BIG_GANGS = N_NODES * 3 // 40
# H100 SXM int32 rate: NVIDIA's data sheet gives 67 TFLOP/s float32,
# counting an FMA as two operations on 128 float32 lanes per SM; an SM
# has 64 int32 lanes (Hopper architecture white paper), so int32 runs at
# a quarter of that
INT32_OPS_PER_S = 67e12 / 4
HBM_BYTES_PER_S = 3.35e12
DEVICE = "cuda"
# the kernels' design (place_common.cuh)
DESIGN = "owned-smem-1barrier"


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


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
                    max_nodes, expect_streams, timed=False, expect_path=None):
    """One solve through the entry point on the card and through the
    plain version on the CPU, from the same inputs; bitwise equal.
    ``expect_path`` ``(state, bits)`` checks where the launch plan put
    the owned state and the class bits.  Returns the kernel-level
    measurements; ``timed`` adds the kernel's time."""
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
                                   plan=plan, class_rows=masks)
    torch.cuda.synchronize()
    k_out = host(p.placed, p.nodes, p.reason, s.avail, s.cost)

    # the plain version on the same kernel inputs, on the CPU
    fresh = make_cluster_state(total, total, alive, cost, device=DEVICE)
    (jobs_t, nelig, elig, cpu_total, K, slot, owned,
     n_owned) = g.kernel_inputs(fresh, *cuda, max_nodes=max_nodes,
                                plan=plan, class_rows=masks)
    M = g.owned_slots(masks, plan and plan[0], streams)[0].shape[1]
    lp = g.launch_plan(M, total.shape[1], masks.shape[0], K)
    if expect_path is not None:
        check((lp.state, lp.bits) == expect_path,
              f"{name}: plan {lp}, expected state/bits {expect_path}")
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
          f"C={masks.shape[0]} K={K} streams={streams} owned={M} "
          f"threads={g.THREADS} smem_bytes={lp.smem_bytes} "
          f"state={lp.state} bits={lp.bits} "
          f"placed={int(k_out[0].sum())} bitwise=True "
          f"plain_cpu_s={plain_s:.3f}", flush=True)
    out = {"max_abs_err": err, "plain_s": plain_s, "streams": streams,
           "K": K, "J": len(req), "C": int(masks.shape[0]), "owned": M,
           "threads": g.THREADS, "smem_bytes": lp.smem_bytes,
           "state": lp.state, "bits": lp.bits}
    if not timed:
        return out

    # kernel time: CUDA events around the wrapper's launch alone, fresh
    # state copies per run (the entry call above was the warm-up)
    def run():
        a, c = fresh.avail.clone(), fresh.cost.clone()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.greedy_place(jobs_t, nelig, elig, cpu_total, a, c, K, owned,
                       n_owned)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)

    times = [run() for _ in range(5)]
    # the least work: per admissible job, over its class's eligible
    # nodes, the R compares + eligibility test, and a compare + min per
    # pass (node_num passes)
    jn = jobs_t.reshape(-1, jobs_t.shape[-1]).cpu().numpy().astype(np.int64)
    R = jn.shape[1] - 4
    nn, live, cls = jn[:, R], jn[:, R + 2] != 0, jn[:, R + 3]
    run_ = live & (nn >= 1) & (nn <= K)
    ops = float((nelig.cpu().numpy()[cls[run_]] * (R + 1 + 2 * nn[run_])).sum())
    J, N = int(live.sum()), len(total)
    nbytes = (J * (R + 4) * 4 + int(nelig.numel()) * 4 + int(elig.numel())
              + N * 4 + 2 * N * R * 4 + 2 * N * 4 + J * (2 + K) * 4)
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out.update(ms=float(np.median(times)), ms_runs=times, ops=ops,
               bytes=nbytes, bound_ms=max(ops_ms, bytes_ms),
               bound_by="operations" if ops_ms >= bytes_ms else "bytes")
    print(f"[kernel-time] {name}: kernel_ms={out['ms']:.3f} "
          f"runs={[round(t, 3) for t in times]} threads={g.THREADS} "
          f"smem_bytes={lp.smem_bytes} state={lp.state} bits={lp.bits} "
          f"bound_ms={out['bound_ms']:.4f} ({out['bound_by']}) "
          f"plain_cpu_ms={plain_s * 1e3:.1f}", flush=True)
    return out


def random_classes(rng, n_classes, n, share=0.05):
    """``n_classes`` overlapping random class masks over n nodes, each
    node in a class with probability ``share``, every node in some."""
    masks = rng.random((n_classes, n)) < share
    masks[rng.integers(0, n_classes, n), np.arange(n)] = True
    return masks


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
        timed=True, expect_path=("shared", "shared"))
    # (b) plus one class over every node: the serial kernel
    overlap = np.concatenate([disjoint, np.ones((1, N_NODES), bool)])
    jc = rng.integers(0, 4, N_JOBS).astype(np.int32)
    jc[rng.random(N_JOBS) < 0.1] = 4
    res["serial"] = kernel_vs_plain(
        "overlapping", total, alive, cost, jobs, jc, overlap, 2, 1,
        timed=True, expect_path=("shared", "shared"))
    # (c) the owned state in device memory, forced by size: serial over
    # 20,000 nodes (320 KB of state); then the class bits in device
    # memory (600 classes over 4,096 nodes), then both (1,000 classes
    # over 16,384 nodes)
    n2 = 2 * N_NODES
    lay2, total2 = cluster_arrays(rng, n2)
    part2 = np.arange(n2) % 4
    masks2 = np.concatenate([np.stack([part2 == c for c in range(4)]),
                             np.ones((1, n2), bool)])
    jc2 = rng.integers(0, 5, n2).astype(np.int32)
    res["global"] = kernel_vs_plain(
        "global-state", total2, rng.random(n2) > 0.005,
        rng.integers(0, 50_000, n2).astype(np.int32),
        job_arrays(rng, lay2, n2), jc2, masks2, 2, 1,
        expect_path=("global", "shared"))
    for name, n, C, J, path in (("global-bits", 4096, 600, 4000,
                                 ("shared", "global")),
                                ("global-both", 16_384, 1000, 3000,
                                 ("global", "global"))):
        lay3, total3 = cluster_arrays(rng, n)
        kernel_vs_plain(name, total3, rng.random(n) > 0.01, None,
                        job_arrays(rng, lay3, J, max_gang=3),
                        rng.integers(0, C, J).astype(np.int32),
                        random_classes(rng, C, n), 3, 1,
                        expect_path=path)
    # (d) edge cases at small size
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
    # gangs above the kernel's 8 keys per thread: the pass path
    big = job_arrays(rng, lay, 600, max_gang=32)
    kernel_vs_plain("gangs-k32-stream", small, rng.random(n) > 0.1,
                    rng.integers(0, 100, n).astype(np.int32), big, jc,
                    masks4, 32, 4)
    kernel_vs_plain("gangs-k32-serial", small, rng.random(n) > 0.1,
                    rng.integers(0, 100, n).astype(np.int32), big, jc,
                    np.concatenate([masks4, np.ones((1, n), bool)]), 32, 1)
    # many slots a thread and few distinct costs: ties inside each
    # thread's list, gangs up to 8
    n5 = 4096
    lay5, total5 = cluster_arrays(rng, n5)
    part5 = np.arange(n5) % 4
    m5 = np.stack([part5 == c for c in range(4)])
    ties = job_arrays(rng, lay5, 2000, max_gang=8)
    jc5 = rng.integers(0, 4, 2000).astype(np.int32)
    for name, m, S in (("ties-k8-stream", m5, 4),
                       ("ties-k8-serial", np.concatenate(
                           [m5, np.ones((1, n5), bool)]), 1)):
        kernel_vs_plain(name, total5, rng.random(n5) > 0.02,
                        rng.integers(0, 4, n5).astype(np.int32), ties, jc5,
                        m, 8, S)
    # unbalanced streams: classes of 55% / 25% / 12% / 8% of the nodes
    n4 = 1024
    lay4, total4 = cluster_arrays(rng, n4)
    cut = np.searchsorted(np.cumsum([0.55, 0.25, 0.12]) * n4,
                          np.arange(n4), side="right")
    kernel_vs_plain("unbalanced-streams", total4, rng.random(n4) > 0.05,
                    rng.integers(0, 1000, n4).astype(np.int32),
                    job_arrays(rng, lay4, 3000, max_gang=4),
                    rng.integers(0, 4, 3000).astype(np.int32),
                    np.stack([cut == c for c in range(4)]), 4, 4)
    # a stream whose class owns no alive node
    dead3 = part != 3
    kernel_vs_plain("dead-class-stream", small, dead3, None, few,
                    rng.integers(0, 4, 400).astype(np.int32), masks4, 2, 4)
    # a stream that owns no node at all (its class is empty)
    empty3 = masks4.copy()
    empty3[3] = False
    kernel_vs_plain("empty-class-stream", small, np.ones(n, bool), None,
                    few, rng.integers(0, 4, 400).astype(np.int32), empty3,
                    2, 4)
    return res


def phase_attribution():
    """The kattr variants on the card against their plain versions, then
    the attribution tool's path with the launch counts zeroed just
    before and read just after."""
    import torch

    from cranesched_tpu_torch.tools import kattr

    J, N, R, BJ = N_JOBS, N_NODES, 3, 256
    ins = kattr.kernel_inputs(*kattr.make_data(J, N, R, BJ), device=DEVICE)
    res = {}
    vp = {"threads": kattr.THREADS,
          **kattr.variant_plan(ins[1].shape[0], R)._asdict()}
    print(f"[kattr] launch plan: {vp}", flush=True)
    for kind, err in kattr.check_variants(*ins, BJ).items():
        plain = kattr.event_ms(
            lambda: kattr.attr_variant_plain(kind, *ins, BJ))
        res[kind] = {"max_abs_err": err, "plain_ms": float(np.median(plain)),
                     "launch": vp}
        print(f"[kattr-vs-plain] {kind}: J={ins[0].shape[1]} "
              f"N={ins[1].shape[0]} bitwise=True plain_card_ms="
              f"{res[kind]['plain_ms']:.3f}", flush=True)
    # no feasible node anywhere: select's second pass re-picks node 0
    job, avail, cost = kattr.make_data(512, 1024, R, BJ)
    avail[:] = 0
    kattr.check_variants(*kattr.kernel_inputs(job, avail, cost,
                                              device=DEVICE), BJ)
    print("[kattr-vs-plain] all-infeasible J=512 N=1024: bitwise=True",
          flush=True)
    # exactly one feasible node: select's second key is (INT32_MAX, that
    # node), the first winner itself
    avail[:, 0, 5] = 10_000
    kattr.check_variants(*kattr.kernel_inputs(job, avail, cost,
                                              device=DEVICE), BJ)
    print("[kattr-vs-plain] one-feasible J=512 N=1024: bitwise=True",
          flush=True)

    # the attribution tool's path
    for kind in kattr.VARIANTS:
        kattr.attr_variant.launches[kind] = 0
    rows = kattr.attribute(*ins, BJ)
    launches = dict(kattr.attr_variant.launches)
    print("[kattr] attribution (J=%d, N=%d, R=%d, BJ=%d)\n%s" % (
        ins[0].shape[1], ins[1].shape[0], R, BJ, kattr.format_rows(rows)),
        flush=True)
    for row in rows:
        kind = row["variant"]
        print(f"[kattr] {kind}: runs={[round(t, 3) for t in row['runs']]}",
              flush=True)
        if kind in res:
            check(launches[kind] == kattr.REPS + 1,
                  f"kattr {kind}: {launches[kind]} launches, want "
                  f"{kattr.REPS + 1}")
            res[kind].update(row, launches=launches[kind])
        else:
            res[kind] = row
    return res


def check_ledger(sched, label, resident=True):
    """avail >= 0; avail + running allocations == total; running jobs
    inside their partition; with ``resident``, the device-resident state
    equals the host ledger."""
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
    if not resident:
        return
    state = sched._resident._state
    check(state is not None, f"{label}: no resident state")
    check(np.array_equal(state.avail.cpu().numpy(), avail),
          f"{label}: device-resident avail differs from the host ledger")


def build_cell(rng, overlap: bool, config):
    """``N_NODES`` nodes (cpu 32-128, mem 64-512 GiB) in partitions
    ``p0..p3`` (plus ``all`` over every node with ``overlap``), a
    ``JobScheduler`` with ``config`` on the card and a ``SimCluster``;
    returns ``(sched, sim, submit)`` with ``submit(k, now)`` adding k
    jobs as bench.py draws them."""
    from cranesched_tpu_torch.craned.sim import SimCluster
    from cranesched_tpu_torch.ctld import (
        JobScheduler,
        JobSpec,
        MetaContainer,
        ResourceSpec,
    )

    meta = MetaContainer()
    for i in range(N_NODES):
        parts = (f"p{i % 4}",) + (("all",) if overlap else ())
        meta.add_node(f"b{i:05d}", meta.layout.encode(
            cpu=float(rng.integers(32, 129)),
            mem_bytes=int(rng.integers(64, 513)) << 30, is_capacity=True),
            partitions=parts)
        meta.craned_up(i)
    sched = JobScheduler(meta, config, device=DEVICE)
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

    return sched, sim, submit


def phase_cycle(overlap: bool):
    """The immediate-fit path at the north-star size; returns per-cycle
    stats.  The first cycle is held against the plain version (~1 min of
    CPU)."""
    import torch

    from cranesched_tpu_torch import convert
    from cranesched_tpu_torch.ctld import SchedulerConfig
    from cranesched_tpu_torch.models import gpu_solver as g

    label = "overlapping" if overlap else "disjoint"
    rng = np.random.default_rng(1)
    t0 = time.perf_counter()
    sched, sim, submit = build_cell(rng, overlap,
                                    SchedulerConfig(backfill=False))
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
        max_nodes=max_nodes, plan=plan, class_rows=rows_np)
    for what, a, b in zip(("placed", "nodes", "reason"), record["out"],
                          host(p.placed, p.nodes, p.reason)):
        check(np.array_equal(a, b),
              f"{label}: first cycle {what} differs from plain")
    print(f"[cycle:{label}] first cycle == plain version (bitwise, "
          f"{len(req)} jobs, plain {time.perf_counter() - t2:.1f}s)",
          flush=True)
    return rows, launches


def phase_backfill():
    """The default configuration at the north-star size: two split
    backfill cycles on four disjoint partitions, the second contended by
    ``BIG_GANGS`` high-QoS gangs on p0; returns per-cycle stats and the
    kernel's launch count."""
    import torch

    from cranesched_tpu_torch.ctld import (
        JobSpec,
        PendingReason,
        ResourceSpec,
        SchedulerConfig,
    )
    from cranesched_tpu_torch.models import gpu_solver as g
    from cranesched_tpu_torch.models import solver_time as st
    from cranesched_tpu_torch.models.solver import make_cluster_state

    label = "backfill"
    rng = np.random.default_rng(2)
    t0 = time.perf_counter()
    sched, sim, submit = build_cell(rng, False, SchedulerConfig())
    check(sched.config.backfill, "the default config is not backfill")
    submit(N_JOBS, 0.0)
    print(f"[cycle:{label}] setup {time.perf_counter() - t0:.1f}s "
          f"({N_NODES} nodes, {len(sched.pending)} pending)", flush=True)

    # record each cycle's head inputs (built before the solve, so the
    # recording stays outside its timed span), its head placements (read
    # by the commit) and its future starts, and the first tail solve's
    # inputs and outputs
    record = {}
    cur = {"cycle": 0}
    timed_state, timed_batch = sched._timed_state, sched._timed_batch
    commit, solve = sched._commit, sched._solve_gpu

    def spy_state(*args):
        state = timed_state(*args)
        record[("state", cur["cycle"])] = st.TimedClusterState(*(
            x.cpu().clone() for x in (state.time_avail, state.total,
                                      state.alive, state.cost)))
        return state

    def spy_batch(batch):
        tb = timed_batch(batch)
        record[("batch", cur["cycle"])] = st.TimedJobBatch(*(
            x.cpu() for x in (tb.req, tb.node_num, tb.time_limit,
                              tb.part_mask, tb.valid)))
        return tb

    def spy_commit(ordered, placements, now, start_buckets=None):
        if start_buckets is not None:
            head = host(placements.placed, start_buckets, placements.nodes,
                        placements.reason)
            record[("head", cur["cycle"])] = head
            record[("future", cur["cycle"])] = [
                job.job_id for job, fut in zip(ordered, head[0]
                                               & (head[1] > 0)) if fut]
        return commit(ordered, placements, now, start_buckets)

    def spy_solve(avail, total, alive, cost, batch, max_nodes,
                  resident_ok=False):
        check(not resident_ok, "the tail solve asked for the resident state")
        first = "tail_in" not in record
        if first:
            record["tail_in"] = (
                avail.cpu().clone(), total.copy(), alive.copy(),
                cost.cpu().clone(), host(batch.req, batch.node_num,
                                         batch.time_limit, batch.valid),
                batch.job_class_np.copy(), batch.class_rows_np.copy(),
                max_nodes)
        out = solve(avail, total, alive, cost, batch, max_nodes,
                    resident_ok=resident_ok)
        if first:
            record["tail_out"] = host(out[0].placed, out[0].nodes,
                                      out[0].reason)
        return out

    sched._timed_state, sched._timed_batch = spy_state, spy_batch
    sched._commit, sched._solve_gpu = spy_commit, spy_solve
    big = JobSpec(res=ResourceSpec(cpu=32.0, mem_bytes=1 << 30),
                  node_num=8, time_limit=600, partition="p0",
                  qos_priority=1, sim_runtime=300.0)
    rows = []
    now = 100.0
    # the main path's launch count: zeroed just before, read just after
    g.greedy_place.launches = 0
    for cycle in range(2):
        cur["cycle"] = cycle
        if cycle:
            now += 900.0
            done = sim.advance_to(now)
            submit(TOPUP_JOBS, now)
            for _ in range(BIG_GANGS):
                check(sched.submit(big, now=now) > 0, "submit rejected")
            print(f"[cycle:{label}] advance_to({now}): {done} completions,"
                  f" +{TOPUP_JOBS} submitted, +{BIG_GANGS} high-QoS gangs "
                  "of 8 x 32 CPUs on p0", flush=True)
        before = g.greedy_place.launches
        t1 = time.perf_counter()
        started = sched.schedule_cycle(now=now)
        wall = time.perf_counter() - t1
        last = dict(sched.stats["last_cycle"])
        check(g.greedy_place.launches == before + 1,
              f"{label} cycle {cycle}: kernel launched "
              f"{g.greedy_place.launches - before} times (want once, for "
              "the tail)")
        check(last["solver"] == "backfill-split",
              f"{label} cycle {cycle}: solver {last['solver']}")
        check(len(started) > 0, f"{label} cycle {cycle}: placed nothing")
        check_ledger(sched, f"{label} cycle {cycle}", resident=False)
        future = record[("future", cycle)]
        check(last["backfilled"] == len(future),
              f"{label} cycle {cycle}: backfilled {last['backfilled']} "
              f"!= {len(future)} future starts in the head")
        reasons = {}
        for jid in future:
            r = sched.pending[jid].pending_reason
            reasons[r.value] = reasons.get(r.value, 0) + 1
        check(set(reasons) <= {PendingReason.PRIORITY.value,
                               PendingReason.RESOURCE.value},
              f"{label} cycle {cycle}: future-start reasons {reasons}")
        if cycle:
            check(len(future) > 0,
                  f"{label}: the contended cycle reserved no future start")
        last.update(cycle=cycle, placed=len(started), wall_s=wall,
                    future_reasons=reasons)
        rows.append(last)
        print(f"[cycle:{label}] cycle {cycle}: placed {len(started)} "
              f"wall {wall:.3f}s head {last['solve_head_ms']:.1f}ms tail "
              f"{last['solve_tail_ms']:.1f}ms backfilled "
              f"{last['backfilled']} future-start reasons {reasons} "
              f"stats {json.dumps(last)}", flush=True)
    launches = g.greedy_place.launches
    check(launches == len(rows),
          f"{label}: {launches} launches for {len(rows)} cycles")

    # each cycle's head against the time-axis solve on the CPU
    for cycle in range(2):
        state = record[("state", cycle)]
        batch = record[("batch", cycle)]
        check(tuple(state.time_avail.shape) == (N_NODES, 64, 3),
              f"{label}: time map {tuple(state.time_avail.shape)}")
        want = record[("head", cycle)]
        t2 = time.perf_counter()
        p, _ = st.solve_backfill(state, batch,
                                 edges=sched._grid.edges_tensor("cpu"),
                                 max_nodes=want[2].shape[1])
        for what, a, b in zip(("placed", "start bucket", "nodes", "reason"),
                              want, host(p.placed, p.start_bucket, p.nodes,
                                         p.reason)):
            check(a.shape == b.shape and np.array_equal(a.astype(b.dtype), b),
                  f"{label}: cycle {cycle} head {what} differs from the CPU "
                  "solve")
        print(f"[cycle:{label}] cycle {cycle} head == CPU time-axis solve "
              f"(bitwise, {len(want[0])} jobs, K={want[2].shape[1]}, "
              f"{int(want[0].sum())} placed, "
              f"{int((want[0] & (want[1] > 0)).sum())} future starts, "
              f"latest bucket {int(want[1][want[0]].max(initial=0))}, cpu "
              f"{time.perf_counter() - t2:.1f}s)", flush=True)

    # the first cycle's tail against the kernel's plain version
    (avail, total, alive, cost, (req, nn, tl, valid), jc, rows_np,
     max_nodes) = record["tail_in"]
    tstate = make_cluster_state(avail, total, alive, cost, device="cpu")
    t3 = time.perf_counter()
    plan = g.plan_streams(jc, rows_np, known_disjoint=True)
    p, _ = g.solve_greedy_gpu_auto(
        tstate, torch.from_numpy(req), torch.from_numpy(nn),
        torch.from_numpy(tl), torch.from_numpy(valid),
        torch.from_numpy(jc), torch.from_numpy(rows_np),
        max_nodes=max_nodes, plan=plan, class_rows=rows_np)
    for what, a, b in zip(("placed", "nodes", "reason"), record["tail_out"],
                          host(p.placed, p.nodes, p.reason)):
        check(np.array_equal(a, b),
              f"{label}: first tail {what} differs from plain")
    print(f"[cycle:{label}] first tail == plain version (bitwise, "
          f"{int(valid.sum())} jobs, plain {time.perf_counter() - t3:.1f}s)",
          flush=True)
    return rows, launches


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    from cranesched_tpu_torch.kernels import build
    from cranesched_tpu_torch.tools import kattr

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = kattr.card_line()
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

    # 4. the attribution kernels and the attribution tool's path
    t0 = time.perf_counter()
    ares = phase_attribution()
    print(f"[kattr] {time.perf_counter() - t0:.1f}s", flush=True)

    # 5. the immediate-fit path, on disjoint and on overlapping partitions
    t0 = time.perf_counter()
    cycles_d, launches_d = phase_cycle(overlap=False)
    cycles_o, launches_o = phase_cycle(overlap=True)
    print(f"[cycle] immediate {time.perf_counter() - t0:.1f}s", flush=True)

    # 6. the default path: split backfill cycles
    t0 = time.perf_counter()
    cycles_b, launches_b = phase_backfill()
    print(f"[cycle] backfill {time.perf_counter() - t0:.1f}s", flush=True)
    cycles = cycles_d + cycles_o + cycles_b
    launches = launches_d + launches_o + launches_b

    st, se = kres["stream"], kres["serial"]
    kernels = [{
        "name": "greedy_place",
        "route": "cuda",
        "source": "cranesched_tpu_torch/csrc/greedy_place.cu",
        "replaces": "cranesched_tpu/models/pallas_solver.py:89",
        "jax_function": "cranesched_tpu.models.pallas_solver."
                        "solve_greedy_pallas_auto",
        "launches": launches,
        "launches_by_path": {"immediate": launches_d + launches_o,
                             "backfill_tail": launches_b},
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
        "attribution_full_ms": ares["full"]["ms"],
        "attribution_full_us_per_job": ares["full"]["us_per_job"],
        "design": DESIGN,
        "launch": {k: {f: r[f] for f in ("owned", "threads", "smem_bytes",
                                         "state", "bits")}
                   for k, r in (("stream", st), ("serial", se))},
        "global_state_case": {f: kres["global"][f] for f in (
            "J", "owned", "threads", "smem_bytes", "state", "bits")},
    }]
    for variant in ("floor", "bcast", "onemin", "select"):
        a = ares[variant]
        kernels.append({
            "name": f"kattr_{variant}",
            "route": "cuda",
            "source": "cranesched_tpu_torch/csrc/kattr_variants.cu",
            "replaces": "tools/kattr.py:35",
            "path": "attribution tool (cranesched_tpu_torch/tools/kattr.py)",
            "launches": a["launches"],
            "match": "bitwise",
            "max_abs_err": a["max_abs_err"],
            "ms": a["ms"],
            "us_per_job": a["us_per_job"],
            "plain_ms": a["plain_ms"],
            "plain_device": "cuda",
            "bound_ms": a["bound_ms"],
            "bound_by": a["bound_by"],
            "library_ms": None,
            "shapes": {"J": N_JOBS, "N": N_NODES,
                       "N_pad": -(-N_NODES // 1024) * 1024, "R": 3,
                       "BJ": 256},
            "design": DESIGN,
            "launch": a["launch"],
        })
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
