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
   taken; then the backfill head kernel (``csrc/backfill_head.cu``) at
   the benchmark's shapes (N = 10,000, T = 64, R = 3, K = 2, J = 1,024)
   against ``solve_backfill_plain`` on the card, bitwise on the
   placements and the post-solve time map and costs, with both sides'
   times, and again on a week's geometric grid and contended;
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
   first cycle against the plain version on the whole batch the
   scheduler fed the kernel;
6. the default path: ``JobScheduler(meta, SchedulerConfig())`` at the
   same size on four disjoint partitions, two split backfill cycles, the
   second contended: its top-up adds high-QoS gangs of 8 x 32 CPUs on
   one partition, more than it holds now, so the head reserves future
   starts.  The greedy kernel launches once per cycle (the tail); each
   cycle's head (1,024 jobs on the [10,000, 64, 3] time map) equals the
   port's time-axis solve on the CPU from the recorded inputs; the
   second cycle backfills and its future starts pend ``Priority`` or
   ``Resource``; the first cycle's tail equals the kernel's plain
   version on the recorded inputs (every tail job); the ledger
   invariants hold after every cycle;
7. topology: a Slurm ``topology.conf`` tree over the same cluster (250
   leaf switches of 40 nodes under 10 upper switches of 25 leaves; the
   craneds register in another order than their names).  (a) 100,000
   single-node candidates under ``SchedulerConfig()``: one split
   backfill cycle whose tail goes through the greedy kernel on the
   block-major node axis, launched once, held bitwise against the plain
   version on the same permuted inputs (every tail job) with the picks
   mapped back; (b) 10,000 gangs of 2-8 nodes (4-32 CPUs
   each) through the best-fit-block solve: every in-block gang's nodes
   share one leaf, spanning gangs are flagged and some exist; in-block/
   cross counts and the solve's ms and us per job are printed;
8. packed: 5,000 candidates, 10% packed (4-32 tasks over 1-4 nodes
   with a per-task request), 2% exclusive, the rest plain, one cycle
   through the packed solve: every started packed job's task layout
   sums to ntasks within the per-node bounds, every exclusive job holds
   whole nodes; solve ms and us per job;
9. preemption: accounts with QoS ``low``, ``mid`` and ``high`` (may
   preempt ``low`` only), ``preempt_mode="requeue"``: a cold cycle of
   100,000 jobs, low everywhere and half of them mid on p3 (mid jobs
   end within the time axis), then 1,000 high jobs of 24-32 CPUs that
   do not fit: single-node ones on p0-p2, and gangs of 4-8 on p3, where
   eviction alone cannot free enough now; once with backfill
   (``solve_preempt_timed``) and once without (``solve_preempt``).
   Every eviction happens inside a preemption commit that started its
   preemptor or as a due deferred claim, every victim pends
   ``Preempted`` with its requeue count raised at once; with backfill
   some gangs start in a later bucket, their claims fall due at bucket
   edges, and a third cycle at the first due time drains them; J, V, M,
   the what-if's ms and ms per preemptor and
   ``torch.cuda.max_memory_allocated`` are printed.
   The routes of 7-9 that have no kernel (the gang solve, the packed
   solve, both what-ifs) record their inputs on the card and are held
   bitwise against the same function on the CPU: every job of the gang
   and packed solves and of the immediate what-if, and the first
   ``CPU_CHECK_PREEMPTORS`` preemptors of the timed one (at least up to
   its first future start; a preemptor's decision depends only on
   those before it).  The ledger invariants hold after every cycle of
   7-9;
10. the lifecycle and a restart: ``SchedulerConfig()`` on the same
   cluster with accounts in a sqlite ``AccountStore``, a ``JobArchive``
   and a ``WriteAheadLog(fsync=True)`` in a temporary directory;
   ``LIFE_JOBS`` (75,000, a depth cut) submissions in one WAL group
   (plain jobs, some holding a license; at 100,000 they would be 10,000
   dependents, OR-deps of two and edges on ids never submitted among
   them; 5,000 begin times; 4,000 jobs in the reservation ``maint`` on
   400 nodes of p1 for [600, 4,200] s, its ACL one account;
   800 held; 200 array templates of 50 tasks, half at most 5 at once;
   10 allocations); cycle 1; the operator's events up to t = 900 as jobs
   complete (hold and release, time limits and priorities modified,
   requeues, suspends and resumes, cancels of pending and running jobs
   and of templates, 20 nodes down, 3 steps in each allocation); cycle 2
   with ``maint`` active (its jobs only on its nodes, its class row in
   the kernel's tail batch); a crash after its dispatch; recovery into a
   fresh scheduler (store, WAL replay, ``recover``,
   ``rebuild_device_state``) held against the one that did not crash,
   job by job, with the ledger, license seats and QoS usage; then the
   same cancels on both and cycle 3 on both, equal in started jobs,
   nodes, reasons and the kernel's outputs, the recovered side's tail
   held against the plain version.  Two divergences are the JAX
   package's own and are accounted for first (``tests/test_torch_wal.py``):
   dependents of compacted dependees recover never-satisfied (they are
   held on both sides), and a recovery rebuilds the queues in id order
   (the twin's are put in id order). WAL records, bytes, fsyncs and
   groups per step, the recovery's seconds and each cycle's commit_ms
   (beside phase 6's cold commit without a WAL) are printed;
11. the observability planes and the JAX package's solver names (the
   job trace is on in every phase, ``SchedulerConfig``'s default): (a)
   the disjoint cell of 5: a cold cycle, then two warm cycles under the
   scheduler's ``torch.profiler`` window (``profiler_window.request``;
   its chrome trace goes to ``profiles/capture-*/``, git-ignored), and
   a third outside it for the times; the default cell's warm split
   cycle under the window too.  Per cycle, from the trace: the share of
   the cycle's wall time the card was busy (the union of its kernel,
   memcpy and memset intervals), the 5 device operations that took the
   most time and the 5 longest idle gaps with the ``crane:*`` span or
   host phase each falls in; the trace-ring row (no builds on a warm
   cycle, the card's memory); the first profiled cycle's kernel output
   against the plain version; (b) the default cell's cold cycle with
   ``job_trace`` on and off: ``commit_ms``, ``total_ms``, the recorder's
   stats, the introspection plane's self time, the same decisions; (c)
   ``explain_pending`` on ``EXPLAIN_JOBS`` pending jobs of the warm
   cycle, each giving the job's pending reason, and a stall drill of
   the flight recorder (fires once, with stacks and one event); (d) the
   disjoint cold cycle with ``solver="native"`` and ``"auto"`` (the C++
   solver, built with g++ into ``build/native/``) equal to the
   ``"cuda"`` cold cycle of (a) from the same seed;
12. the controller daemon over gRPC (``rpc/server.py``,
   ``ctld_main.py``) on phase 6's cluster and jobs.  (a) ``serve`` in
   tick mode on the card with ``SimCluster``: 100,000 specs through
   ``CtldClient`` in ``SubmitBatchJobs`` calls of 1,000; p50/p99 of a
   page of ``QueryJobsInfo`` and of ``QueryClusterInfo`` at rest at
   100,000 pending; a cold ``Tick``, then 10,000 more specs and a warm
   ``Tick`` 900 s later with a second client querying all through it;
   ``QueryJobsInfo`` pages by its cursor, ``QueryJobsStream``,
   ``QueryClusterInfo``, ``QueryJobSummary`` (with ``explain_json``),
   ``QueryEvents`` and ``QueryStats``; 1,000 pending and 100 running
   jobs cancelled over the wire.  All of it is held against a twin
   ``JobScheduler`` on the card fed the same specs at the same ``now``s
   in process, and the twin's own handlers: started sets, nodes,
   pending reasons, ledgers and every job record equal.  greedy_place
   launches once in each tick (the split cycle's tail), and the cold
   tick's tail equals the plain version.  Each tick's RPC wall time is
   printed beside the cycle's ``total_ms`` and its lock-held share.
   (b) ``python3 -m cranesched_tpu_torch.ctld_main -c <yaml> --sim``
   with no ``--device`` (the card), a WAL and an archive in a temporary
   directory: the banner, ``DAEMON_JOBS`` (75,000) specs over the wire
   (made to run and wait without end), a second daemon on the same WAL
   refused (the lease is held), at least two cycles with starts and one
   that places nothing, SIGTERM and exit 0, a restart that shows every
   acknowledged job as the last query before the stop did; boot-to-banner
   seconds,
   the first cycle's time, and each cycle's ``total_ms``/``solve_ms``.
   Leg (b) runs beside phase 16, in a process of its own.  Leg (a) ends
   with 17 (c);
13. the CPU checks: every plain version and CPU replay above runs in
   one of ``CPU_WORKERS`` worker processes beside the card's phases;
   the script waits for all of them and fails on any failure;
14. the real node plane, once the workers are gone:
   ``python3 -m cranesched_tpu_torch.ctld_main -c <yaml>`` on the card
   with no ``--sim`` (phase 12's cluster, ``CranedTimeoutSec: 10``, and
   two nodes under host names that resolve here in a partition of their
   own), ``NP_JOBS`` (15,000) of phase 12's draws as real scripts (echo
   the job id, node and shell PID, sleep 1-8 s, 2% ``exit 3``) and ten
   sleepers on the gang nodes, then ``NP_CRANEDS`` real ``craned_main``
   processes (a quarter a partition, each a configured node with its
   CPUs and memory) and the two gang nodes register.  Real-time cycles for
   ``NP_RUN_S`` from the last registration, sampled: no alive node runs
   more CPUs or memory than it has; every finished job's output names
   the nodes the ctld recorded, the ``exit 3`` jobs report 3.  Then the
   ten sleepers cancelled (their shells gone), the second gang node's
   craned SIGKILLed while two long keepers run there (its node down,
   both requeued, none left running there) and restarted (alive again),
   a 2-node ``coord fence`` gang on the resolvable pair (both ranks'
   data on both), the node-side spans of the window's latest finished
   jobs (each must have them), SIGTERM to every process (each exits 0).
   Every cycle is on the card with greedy_place launched as the cycle's
   shape says.  Printed: registration seconds, each cycle's times, steps
   finished per second, the span percentiles (the cycle's start to the
   push's send, the end of its state phases to the send, receipt to
   step start), the supervisors' spawn times, the time from SIGKILL to
   node down, the heads' stretch over phase 12's in-process head, the
   dispatcher's pool size, the host's cgroup flavour (read, not built),
   the rendezvous bind failures and when each step ended;
15. scale-out and failover (seed 2 where it draws): (a) the disjoint
   cold cycle of 11 (phase 11's seed) with ``solver="sharded"`` on the
   default mesh (every card) against phase 11's ``"cuda"`` twin,
   started jobs, nodes, reasons and ledger equal, the greedy kernel not
   launched, the trace row's ``mesh``; (b) ``SO_JOBS`` x ``N_NODES``
   through ``solve_greedy_sharded_classes`` on a mesh of ``SO_SHARDS``
   shards all on the card, and the first ``SO_DENSE_JOBS`` through the
   dense ``solve_greedy_sharded``, each bitwise against greedy_place on
   the same batch, and the card's operations a job under
   ``torch.profiler``; (c) ``SO_RANKS`` processes, one node slab each on
   the card, fencing once a step through a ``RendezvousServer`` here
   (``solve_greedy_sharded_classes_mp``) on those first jobs, bitwise
   against greedy_place, with the p50/p99 of their fences; (d)
   ``solve_speculative`` and ``solve_blocked`` on the whole batch,
   bitwise against greedy_place, with their fallbacks and blocks; (e) a
   failover drill: a leader ``ctld_main --sim`` on the card (phase 12's
   cluster) and a standby ``--ha-standby --ha-peer`` on the card,
   ``FO_JOBS`` submits to the leader, the standby caught up, refusing a
   submit and running no cycle, the leader SIGKILLed, the standby
   promoted with every acknowledged job (the dead leader's running jobs
   recovered running, counted apart), ``FO_TOPUP`` new submits
   acknowledged and scheduled on the card through greedy_place; (e) runs
   beside phase 16, in a process of its own;
16. federation (``cranesched_tpu_torch/fed/``): (a) a
   ``FederatedCluster`` on the card, ``SchedulerConfig()``, shards east
   (p0, p1) and west (p2, p3) of ``N_NODES // 4`` nodes a partition (64
   CPUs, 256 GiB each, as ``SimShard`` builds them), a WAL each and a
   usage book: first the solo-vs-federated parity at the JAX test's size
   and a lease taken while a cycle solves (its commit places nothing on
   the leased nodes); then phase 12's 100,000 draws routed by partition
   and two cycles per shard, each equal to a plain ``JobScheduler`` over
   that shard's partitions alone (started set, nodes, pending reasons,
   ledger), the usage pumped after each; then a gang window in which
   p1 and p2 keep ``FED_KEEP`` nodes each (held back until then) and the
   shards' cycles wait: ``FED_GANGS`` gangs of ``FED_GANG_NODES`` nodes
   over p1 and p2 through the arbiter, west SIGKILLed right after its
   first lease and recovered from its WAL (the bare reserve released,
   the gang placed once), every gang whole on leased nodes of both
   shards, no lease left; then p1 migrates east -> west with jobs
   running and pending on it: west's node axis grows to 7,500 and its
   next cycle launches greedy_place on it and places onto p1's nodes,
   east's p1 rows stay, dead, and every job is there once by name.
   Cycle ms by phase, placements, leases, gang commits, seal-to-flip
   seconds and device memory are printed.  (b) two ``ctld_main --sim``
   shards on the card from one ``Federation:`` YAML (phase 12's cluster,
   ``MaxJobsPerUser`` / ``MaxSubmitJobsPerUser`` that bind): a lease,
   confirm and release round trip; ``FED_DAEMON_JOBS`` of phase 12's
   draws all to east, west's share forwarded with its redirect hint, the
   submit gate refusing some; the ``FetchUsage`` counts converging and
   the limits never exceeded; a ``FederatedClient`` fan-out with
   ``max_staleness``; ``MigratePartition`` of p1 over the wire; west
   SIGKILLed and restarted with the imported partition and every job
   once by name; greedy_place in both shards' cycles (trace rows).  (b),
   12 (b) and 15 (e) run beside (a), each in a process of its own;
17. the replays (``cranesched_tpu_torch/replay.py``) and the ``crane``
   commands (``cli.py``): (a) ``replay fifo --scale 1.0 --rpc --wal``
   on the card, BASELINE config #1 at its full shape (10,000 jobs x
   1,000 nodes) through ``SubmitBatchJobs``, the WAL and ``Tick``: every
   job submitted, finished and completed, greedy_place launched (the
   trace rows' ``kernel_launches``, equal to the wrapper's count), and
   the result equal to the same replay on the CPU (from the same seed,
   in the same mode, in a CPU-check worker started before phase 3) on
   every field but the wall-clock ones and on a digest of every finished
   job's id, status, start, end and nodes; (b) ``minload``,
   ``backfill``, ``gres``, ``qos`` and ``topo`` direct at the cut scales
   of ``REPLAY_SCALES``, ``--slo`` on backfill at 0.05 and the
   ``--federation`` and ``--rebalance`` drills at 0.25, on the card:
   each ``ok`` where it has one, no job lost or doubled (the job trace's
   ledger), at least 95% completed, and greedy_place launched where the
   configuration's cycles reach it; each leg's wall time.  (a) and (b)
   run beside phase 16, in a process of their own.  (c) at the end of
   12 (a), against its server and twin: ``cqueue``, ``cinfo``,
   ``cstats``, ``csummary``, ``cexplain`` of a pending job and
   ``cevents`` through ``cli.main`` in this process, each against the
   twin's handlers (jobs and nodes by state, the counters, the pending
   reason, the event seqs); then ``cqueue`` as a process of its own,
   as ``python -m cranesched_tpu_torch.cli`` and through a ``python -c``
   wrapper that reports that ``torch`` was not loaded, each timed;
18. one JSON line each for the cycles, the lifecycle, the obs phase, the
   native solver, the controller, the node plane, the scale-out phase,
   the federation and the replays, one describing every kernel, then
   the card line, then the result line ``{"ok": true, "device":
   {...}}``.

It imports nothing of the JAX package.  The kernel build goes to
``build/kernels/`` (see ``cranesched_tpu_torch/kernels/build.py``).
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np

N_NODES = 10_000
N_JOBS = 100_000
TOPUP_JOBS = 5_000
# the lifecycle cell's submissions, cut from N_JOBS for the run's time
# limit (PERF.md §4): still above the ~57,000 jobs the cluster runs at
# once, so cycle 1 leaves a backlog for the operator's events and cycle 2
LIFE_JOBS = 75_000
# the contended backfill cycle's high-QoS gangs (8 nodes x 32 CPUs, 10
# min) on partition p0: 750 at 10,000 nodes, ~80% of p0's CPUs
BIG_GANGS = N_NODES * 3 // 40
# the topology phases: leaf switches of 40 nodes under upper switches of
# 25 leaves (250 leaves, 10 upper switches at 10,000 nodes), and the
# gang cycle's gangs
LEAF = 40
SPINE_LEAVES = 25
TOPO_GANGS = N_NODES
# the packed cycle's candidates (halved twice for the script's time
# limit: its per-job loop takes ~2 ms a job), and the preemption burst's
# high-QoS jobs
PACKED_JOBS = N_NODES // 2
PREEMPT_BURST = N_NODES // 10
# the timed what-if on the CPU takes ~0.1-0.4 s a preemptor at this size
# (its [M, T, R] steps): it is held against the card on this many
# preemptors, or up to the first future start if that comes later
CPU_CHECK_PREEMPTORS = 200
# the CPU checks (the plain versions of the kernel, the routes' CPU
# replays: ~10 min of CPU at this size) run in worker processes beside
# the card's phases, each with 1 thread: with 2 each they took 8 of the
# card machine's 8 cores from the phases' own thread, whose phases then
# ran up to 1.8x slower on some hosts than on others (PERF.md §6)
CPU_WORKERS = 4
# the share of p3's cold jobs in QoS mid, which high may not preempt
MID_SHARE = 0.5
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


# every process this run starts inherits this variable (the craned and
# the supervisor pass their environment on to the steps), so the ones
# that outlive their parent (a craned's supervisors and scripts after a
# SIGKILL, or after a failed check) are still found and stopped
RUN_MARK = "CRANE_SMOKE_RUN"


def mark_processes() -> None:
    """Tag this run's processes, and adopt its orphans (Linux
    ``PR_SET_CHILD_SUBREAPER``), so that ``stop_marked`` can reap them."""
    import ctypes
    import os

    os.environ[RUN_MARK] = f"{os.getpid()}-{time.time_ns()}"
    ctypes.CDLL(None, use_errno=True).prctl(36, 1, 0, 0, 0)


def _marked_pids(trackers: bool) -> list[int]:
    import os

    mark = f"{RUN_MARK}={os.environ.get(RUN_MARK, '')}".encode()
    pids = []
    for d in os.listdir("/proc"):
        if not d.isdigit() or int(d) == os.getpid():
            continue
        try:
            with open(f"/proc/{d}/environ", "rb") as fh:
                env = fh.read().split(b"\0")
            with open(f"/proc/{d}/stat") as fh:
                state = fh.read().rpartition(")")[2].split()[0]
        except OSError:
            continue
        if (mark in env and state != "Z"
                and (trackers or b"resource_tracker" not in _cmdline(d))):
            pids.append(int(d))
    return pids


def stop_marked(trackers: bool = False) -> list[str]:
    """SIGKILL every live process of this run but this one, then reap
    this process's exited children; returns the command lines of those
    that were live.  multiprocessing's resource tracker, which the pools
    of worker processes share, is spared unless ``trackers``."""
    import os
    import signal

    if RUN_MARK not in os.environ:
        return []
    seen = []
    for _ in range(10):
        pids = _marked_pids(trackers)
        if not pids:
            break
        seen += [(p, _cmdline(p)) for p in pids
                 if p not in {q for q, _ in seen}]
        for pid in pids:
            try:
                os.kill(pid, signal.SIGKILL)
            except OSError:
                pass
        time.sleep(0.2)
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            break
        if pid == 0:
            break
    return [f"{pid} " + cmd.replace(b"\0", b" ").decode(errors="replace")[:120]
            for pid, cmd in seen]


_pool = None
_checks = {}


def _worker_init():
    import torch

    torch.set_num_threads(1)


def cpu_check(label, fn, *args):
    """Run ``fn(label, *args)`` in a worker process (the pool is started at
    first use, by 'spawn': the card stays with this process) and keep its
    future under ``label``; ``main`` waits for every one of them, and
    fails on any failure, before it prints a result."""
    global _pool
    if _pool is None:
        import concurrent.futures
        import multiprocessing

        _pool = concurrent.futures.ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=_worker_init)
    check(label not in _checks, f"two CPU checks named {label}")
    _checks[label] = _pool.submit(fn, label, *args)


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


def plain_check(label, want, avail, total, alive, cost, batch, jc,
                rows_np, max_nodes, perm=None):
    """(A worker's job.)  A recorded greedy solve (inputs as the scheduler
    handed them to ``_immediate_solve``, outputs ``want`` = host (placed,
    nodes, reason)) against the kernel's plain version on every job: the
    same entry point and stream plan on CPU tensors, where it runs
    ``greedy_place_plain``.  ``perm`` presents the node axis block-major,
    as the scheduler does under a topology, and maps the picks back.
    Returns the largest absolute difference (0)."""
    import torch

    from cranesched_tpu_torch.models import gpu_solver as g
    from cranesched_tpu_torch.models.solver import make_cluster_state

    avail, cost = (x.numpy() if isinstance(x, torch.Tensor) else x
                   for x in (avail, cost))
    if perm is not None:
        avail, total, alive, cost = (x[perm] for x in (avail, total, alive,
                                                       cost))
        rows_np = rows_np[:, perm]
    t0 = time.perf_counter()
    state = make_cluster_state(avail, total, alive, cost, device="cpu")
    plan = g.plan_streams(jc, rows_np)
    p, _ = g.solve_greedy_gpu_auto(
        state, *(torch.from_numpy(x) for x in (*batch, jc, rows_np)),
        max_nodes=max_nodes, plan=plan, class_rows=rows_np)
    placed, nodes, reason = host(p.placed, p.nodes, p.reason)
    if perm is not None:
        nodes = np.where(nodes >= 0, perm[np.maximum(nodes, 0)],
                         -1).astype(np.int32)
    err = 0
    for what, a, b in zip(("placed", "nodes", "reason"), want,
                          (placed, nodes, reason)):
        check(a.shape == b.shape and np.array_equal(a, b),
              f"{label}: {what} differs from the plain version")
        if a.size:
            err = max(err, int(np.abs(a.astype(np.int64)
                                      - b.astype(np.int64)).max()))
    print(f"[cycle:{label}] == plain version (bitwise, every one of "
          f"{int(batch[3].sum())} jobs, streams {plan[1] if plan else 1}, "
          f"plain cpu {time.perf_counter() - t0:.1f}s)", flush=True)
    return err


def to_cpu(x):
    """A copy on the CPU of a solve's arguments or outputs: tensors,
    dataclasses of them, tuples, lists and dicts."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().clone()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: to_cpu(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: to_cpu(v) for k, v in x.items()}
    return x


def tensors_of(x, path="out"):
    """``(path, array)`` for every tensor in ``x``, in a fixed order."""
    import dataclasses

    import torch

    if isinstance(x, torch.Tensor):
        yield path, x.numpy()
    elif dataclasses.is_dataclass(x):
        for f in dataclasses.fields(x):
            yield from tensors_of(getattr(x, f.name), f"{path}.{f.name}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from tensors_of(v, f"{path}[{i}]")


class Recording:
    """Within a ``with`` block, every call of the scheduler module's
    ``name`` (a solve route that has no kernel) records its arguments,
    copied to the CPU before the call (the solves update their state in
    place), its outputs and its arguments after it, and the copies'
    ms."""

    def __init__(self, name):
        from cranesched_tpu_torch.ctld import scheduler

        self.module, self.name = scheduler, name
        self.fn = getattr(scheduler, name)
        self.calls = []

    def __enter__(self):
        def spy(*args, **kwargs):
            t0 = time.perf_counter()
            inputs = to_cpu((args, kwargs))
            t1 = time.perf_counter()
            out = self.fn(*args, **kwargs)
            t2 = time.perf_counter()
            self.calls.append({"in": inputs, "out": to_cpu(out),
                               "after": to_cpu(args), "copy_ms": (
                                   t1 - t0 + time.perf_counter() - t2) * 1e3})
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def route_vs_cpu(label, fn, call, jobs_arg, per_job, cut=None):
    """(A worker's job.)  A recorded call of a route on the card against
    ``fn`` on the CPU from the same inputs, bitwise.  ``cut`` keeps the
    first ``cut`` jobs of the batch at positional argument ``jobs_arg`` (a
    job's result depends only on those before it); then only the per-job
    outputs (the elements ``per_job`` of the output tuple) are compared,
    on those jobs, and without a cut every output and every argument
    after the call (the state the solve updates in place).  Returns
    ``(jobs compared, CPU seconds)``."""
    import dataclasses

    args, kwargs = to_cpu(call["in"])     # the recording stays as it was
    args = list(args)
    batch = args[jobs_arg]
    J = getattr(batch, dataclasses.fields(batch)[0].name).shape[0]
    if cut is not None and cut >= J:
        cut = None
    if cut is not None:
        args[jobs_arg] = dataclasses.replace(batch, **{
            f.name: getattr(batch, f.name)[:cut]
            for f in dataclasses.fields(batch)})
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    cpu_s = time.perf_counter() - t0
    want, got = call["out"], out
    if cut is None:
        want, got = (*want, call["after"]), (*got, tuple(args))
    n = 0
    for i in (range(len(want)) if cut is None else per_job):
        for (path, a), (_, b) in zip(tensors_of(want[i], f"out[{i}]"),
                                     tensors_of(got[i], f"out[{i}]")):
            a = a if cut is None else a[:cut]
            check(a.shape == b.shape and a.dtype == b.dtype
                  and np.array_equal(a, b),
                  f"{label}: {path} on the card differs from the CPU")
            n += 1
    jobs = J if cut is None else cut
    print(f"[cycle:{label}] {fn.__name__} on the card == on the CPU "
          f"(bitwise, {n} outputs, {jobs} of {J} jobs"
          f"{'' if cut is None else ', per-job outputs'}, cpu "
          f"{cpu_s:.1f}s, recording {call['copy_ms']:.0f} ms)", flush=True)
    return jobs, cpu_s


def kernel_plain_check(label, k_out, jobs_t, nelig, elig, cpu_total, avail,
                       cost, K, slot):
    """(A worker's job.)  The kernel's outputs ``k_out`` (placed, nodes,
    reason, avail, cost) against its plain version on the CPU, from the
    same kernel inputs; bitwise.  Returns ``(max_abs_err, plain
    seconds)``."""
    from cranesched_tpu_torch.models import gpu_solver as g

    t0 = time.perf_counter()
    placed, reason, chosen = g.greedy_place_plain(
        jobs_t, nelig, elig, cpu_total, avail, cost, K)
    plain_s = time.perf_counter() - t0
    p_out = [x.numpy() for x in (
        placed.reshape(-1)[slot] != 0, chosen.reshape(-1, K)[slot],
        reason.reshape(-1)[slot], avail, cost)]
    err = 0
    for what, a, b in zip(("placed", "nodes", "reason", "avail", "cost"),
                          k_out, p_out):
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{label}: {what} shape/dtype {a.shape}/{a.dtype} vs "
              f"{b.shape}/{b.dtype}")
        check(np.array_equal(a, b), f"{label}: {what} differs from plain")
        if a.size:
            err = max(err, int(np.abs(a.astype(np.int64)
                                      - b.astype(np.int64)).max()))
    print(f"[kernel-vs-plain] {label}: bitwise=True plain_cpu_s="
          f"{plain_s:.3f}", flush=True)
    return err, plain_s


def kernel_vs_plain(name, total, alive, cost, jobs, job_class, masks,
                    max_nodes, expect_streams, timed=False, expect_path=None):
    """One solve through the entry point on the card; its outputs go with
    the kernel's inputs to a worker that holds them bitwise against the
    plain version on the CPU (``kernel_plain_check``, under the label
    ``kernel <name>``).  ``expect_path`` ``(state, bits)`` checks where
    the launch plan put the owned state and the class bits.  Returns the
    kernel-level measurements; ``timed`` adds the kernel's time."""
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
    cpu_check(f"kernel {name}", kernel_plain_check, k_out,
              *to_cpu((jobs_t, nelig, elig, cpu_total, fresh.avail,
                       fresh.cost)), K, slot.cpu())
    print(f"[kernel-vs-plain] {name}: J={len(req)} N={len(total)} "
          f"C={masks.shape[0]} K={K} streams={streams} owned={M} "
          f"threads={g.THREADS} smem_bytes={lp.smem_bytes} "
          f"state={lp.state} bits={lp.bits} "
          f"placed={int(k_out[0].sum())}", flush=True)
    out = {"check": f"kernel {name}", "streams": streams,
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
          f"bound_ms={out['bound_ms']:.4f} ({out['bound_by']})", flush=True)
    return out


def head_vs_plain(label, *args, **kwargs):
    """``tests/backfill_head_cases.py``'s kernel-vs-plain check of the
    backfill head on the card, printed; returns its row."""
    import os

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    try:
        import backfill_head_cases
    finally:
        sys.path.pop(0)
    try:
        row = backfill_head_cases.head_vs_plain(label, *args, **kwargs)
    except AssertionError as e:
        raise RuntimeError(f"chip_smoke check failed: {e}") from None
    print(f"[head:{label}] kernel == plain (bitwise) {json.dumps(row)}",
          flush=True)
    return row


def phase_backfill_head():
    """The backfill head kernel at the benchmark's shapes (N = 10,000, T =
    64, R = 3, K = 2, J = 1,024), held bitwise against its plain loop and
    timed beside it, then on a week's geometric grid and contended; its
    bound: the time map read and written once and the J part_mask rows,
    over HBM_BYTES_PER_S."""
    res = head_vs_plain("cell", 11, N_NODES, 64, 1024, 2, timed=True)
    res["bound_ms"] = (2 * N_NODES * 64 * 3 * 4 + 1024 * N_NODES) \
        / HBM_BYTES_PER_S * 1e3
    head_vs_plain("geometric", 12, N_NODES, 64, 1024, 2,
                  horizon=7 * 86400)
    head_vs_plain("contended", 13, N_NODES, 64, 1024, 2, contended=True)
    return res


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


def topology_spec(n):
    """A Slurm ``topology.conf`` tree as the ``Topology:`` section: leaf
    switches of ``LEAF`` nodes (``b[00000-00039]``, ...) under upper
    switches of ``SPINE_LEAVES`` leaves (250 leaves under 10 switches at
    10,000 nodes)."""
    leaves = -(-n // LEAF)
    return {
        "Blocks": [{"name": f"leaf{b:03d}", "nodes": "b[%05d-%05d]" % (
            LEAF * b, min(LEAF * b + LEAF, n) - 1)} for b in range(leaves)],
        "Switches": [{"name": f"spine{s}", "blocks": [
            f"leaf{b:03d}" for b in range(SPINE_LEAVES * s,
                                          min(SPINE_LEAVES * (s + 1),
                                              leaves))]}
            for s in range(-(-leaves // SPINE_LEAVES))],
    }


def qos_accounts(mgr=None):
    """Accounts for the preemption and lifecycle phases: QoS ``low``
    (priority 0), ``mid`` (priority 500) and ``high`` (priority 1,000, may
    preempt ``low`` only), user alice in hpc; into ``mgr`` when given
    (one with a store attached persists them)."""
    from cranesched_tpu_torch.ctld.accounting import (
        Account,
        AccountManager,
        AdminLevel,
        Qos,
        User,
    )

    mgr = AccountManager() if mgr is None else mgr
    mgr.users["root"] = User(name="root", admin_level=AdminLevel.ROOT)
    mgr.add_qos("root", Qos(name="low", priority=0))
    mgr.add_qos("root", Qos(name="mid", priority=500))
    mgr.add_qos("root", Qos(name="high", priority=1000, preempt={"low"}))
    mgr.add_account("root", Account(name="hpc",
                                    allowed_qos={"low", "mid", "high"},
                                    default_qos="low"))
    mgr.add_user("root", User(name="alice", uid=1), "hpc")
    return mgr


def build_cell(rng, overlap: bool, config, topology=False, accounts=None):
    """``N_NODES`` nodes (cpu 32-128, mem 64-512 GiB) in partitions
    ``p0..p3`` (plus ``all`` over every node with ``overlap``), a
    ``JobScheduler`` with ``config`` on the card and a ``SimCluster``;
    returns ``(sched, sim, submit)`` with ``submit(k, now)`` adding k
    jobs as bench.py draws them.  ``topology`` attaches
    ``topology_spec``'s tree; ``accounts`` goes to the scheduler and
    ``submit`` then takes the QoS (``qos=``)."""
    from cranesched_tpu_torch.craned.sim import SimCluster
    from cranesched_tpu_torch.ctld import (
        JobScheduler,
        JobSpec,
        MetaContainer,
        ResourceSpec,
    )

    meta = MetaContainer()
    # under a topology the craneds register in another order than their
    # names (and so than the leaf switches' hostlists): the block-major
    # permutation is not the identity
    names = (np.random.default_rng(7).permutation(N_NODES) if topology
             else np.arange(N_NODES))
    for i in range(N_NODES):
        parts = (f"p{i % 4}",) + (("all",) if overlap else ())
        meta.add_node(f"b{names[i]:05d}", meta.layout.encode(
            cpu=float(rng.integers(32, 129)),
            mem_bytes=int(rng.integers(64, 513)) << 30, is_capacity=True),
            partitions=parts)
        meta.craned_up(i)
    if topology:
        from cranesched_tpu_torch.topo import Topology

        meta.set_topology(Topology.from_config(
            topology_spec(N_NODES), num_nodes=N_NODES,
            name_to_id={f"b{names[i]:05d}": i for i in range(N_NODES)}))
    sched = JobScheduler(meta, config, device=DEVICE, accounts=accounts)
    sim = SimCluster(sched)
    sim.wire(sched)

    def submit(k, now, max_gang=2, qos=""):
        user = dict(user="alice", account="hpc", qos=qos) if qos else {}
        for _ in range(k):
            part = f"p{rng.integers(0, 4)}"
            if overlap and rng.random() < 0.1:
                part = "all"
            tl = int(rng.integers(60, 86400))
            check(sched.submit(JobSpec(
                res=ResourceSpec(cpu=float(rng.integers(1, 17)),
                                 mem_bytes=int(rng.integers(1, 33)) << 30),
                node_num=int(rng.integers(1, max_gang + 1)), time_limit=tl,
                partition=part,
                sim_runtime=float(rng.integers(30, 1800)), **user),
                now=now) > 0, "submit rejected")

    return sched, sim, submit


def phase_cycle(overlap: bool):
    """The immediate-fit path at the north-star size; returns per-cycle
    stats.  The first cycle is held against the plain version on the
    card."""
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
    solve = sched._immediate_solve

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

    sched._immediate_solve = spy
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

    # the first cycle against the plain version on the same snapshot and
    # batch
    cpu_check(f"{label} first cycle", plain_check, record["out"],
              *record["in"])
    return rows, launches


def phase_backfill():
    """The default configuration at the north-star size: two split
    backfill cycles on four disjoint partitions, the second contended by
    ``BIG_GANGS`` high-QoS gangs on p0; returns per-cycle stats and the
    kernel's launch count."""
    from cranesched_tpu_torch.ctld import (
        JobSpec,
        PendingReason,
        ResourceSpec,
        SchedulerConfig,
    )
    from cranesched_tpu_torch.models import gpu_solver as g
    from cranesched_tpu_torch.models import solver_time as st

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
    commit, solve = sched._commit, sched._immediate_solve

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
    sched._commit, sched._immediate_solve = spy_commit, spy_solve
    big = JobSpec(res=ResourceSpec(cpu=32.0, mem_bytes=1 << 30),
                  node_num=8, time_limit=600, partition="p0",
                  qos_priority=1, sim_runtime=300.0)
    rows = []
    now = 100.0
    # the main path's launch counts: zeroed just before, read just after
    g.greedy_place.launches = 0
    st.backfill_head.launches = 0
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
        head_before = st.backfill_head.launches
        t1 = time.perf_counter()
        started = sched.schedule_cycle(now=now)
        wall = time.perf_counter() - t1
        last = dict(sched.stats["last_cycle"])
        check(g.greedy_place.launches == before + 1,
              f"{label} cycle {cycle}: kernel launched "
              f"{g.greedy_place.launches - before} times (want once, for "
              "the tail)")
        head_launched = st.backfill_head.launches - head_before
        check(head_launched == 1,
              f"{label} cycle {cycle}: the head kernel launched "
              f"{head_launched} times (want once)")
        row_launches = sched.cycle_trace.snapshot()[-1][
            "head_kernel_launches"]
        check(row_launches == 1,
              f"{label} cycle {cycle}: trace row head_kernel_launches "
              f"{row_launches}")
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
    launches, head_launches = g.greedy_place.launches, \
        st.backfill_head.launches
    check(launches == len(rows) and head_launches == len(rows),
          f"{label}: {launches} greedy and {head_launches} head launches "
          f"for {len(rows)} cycles")

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
    cpu_check(f"{label} first tail", plain_check, record["tail_out"],
              *record["tail_in"])
    return rows, launches, head_launches


def cycle_once(sched, now, label):
    """One cycle, timed on the host; returns ``(started, last_cycle)``
    with the wall time, and prints the stats line."""
    t1 = time.perf_counter()
    started = sched.schedule_cycle(now=now)
    wall = time.perf_counter() - t1
    last = dict(sched.stats["last_cycle"], placed=len(started), wall_s=wall)
    print(f"[cycle:{label}] placed {len(started)} wall {wall:.3f}s stats "
          f"{json.dumps(last)}", flush=True)
    return started, last


def phase_topo_single():
    """The default configuration under a topology: 100,000 single-node
    candidates, one split backfill cycle whose tail goes through the
    greedy kernel on the block-major node axis; the launch is held
    bitwise against the plain version on the same permuted inputs, the
    picks mapped back to real node ids."""
    from cranesched_tpu_torch.ctld import SchedulerConfig
    from cranesched_tpu_torch.models import gpu_solver as g

    label = "topo-single"
    rng = np.random.default_rng(3)
    t0 = time.perf_counter()
    sched, sim, submit = build_cell(rng, False, SchedulerConfig(),
                                    topology=True)
    topo = sched.meta.topology
    check(not (topo.perm == np.arange(N_NODES)).all(),
          "the block-major permutation is the identity")
    submit(N_JOBS, 0.0, max_gang=1)
    print(f"[cycle:{label}] setup {time.perf_counter() - t0:.1f}s "
          f"({N_NODES} nodes, {topo.num_blocks} leaves, "
          f"{len(topo.upper_levels[0][1])} upper switches, "
          f"{len(sched.pending)} pending)", flush=True)
    record = {}
    solve = sched._immediate_solve

    def spy(avail, total, alive, cost, batch, max_nodes, resident_ok=False):
        record["in"] = (avail.cpu().clone(), total.copy(), alive.copy(),
                        cost.cpu().clone(), host(batch.req, batch.node_num,
                                                 batch.time_limit,
                                                 batch.valid),
                        batch.job_class_np.copy(),
                        batch.class_rows_np.copy(), max_nodes)
        out = solve(avail, total, alive, cost, batch, max_nodes,
                    resident_ok=resident_ok)
        record["out"] = host(out[0].placed, out[0].nodes, out[0].reason)
        return out

    sched._immediate_solve = spy
    # the main path's launch count: zeroed just before, read just after
    g.greedy_place.launches = 0
    started, last = cycle_once(sched, 100.0, label)
    launches = g.greedy_place.launches
    check(launches == 1, f"{label}: kernel launched {launches} times")
    check(last["solver"] == "backfill-split",
          f"{label}: solver {last['solver']}")
    check(len(started) > 0, f"{label}: placed nothing")
    check_ledger(sched, label, resident=False)

    # the permuted launch against the plain version on the same inputs
    cpu_check(f"{label} permuted tail", plain_check, record["out"],
              *record["in"], topo.perm)
    last.update(cycle=0)
    return [last], launches


def phase_topo_gangs():
    """Gangs of 2-8 nodes under the topology: one cycle through the
    best-fit-block solve (``solve_greedy_topo``, route ``topo``)."""
    from cranesched_tpu_torch.ctld import JobSpec, ResourceSpec
    from cranesched_tpu_torch.ctld import SchedulerConfig
    from cranesched_tpu_torch.models import gpu_solver as g
    from cranesched_tpu_torch.topo.place import solve_greedy_topo

    label = "topo-gangs"
    rng = np.random.default_rng(4)
    t0 = time.perf_counter()
    sched, sim, _ = build_cell(rng, False, SchedulerConfig(), topology=True)
    topo = sched.meta.topology
    for _ in range(TOPO_GANGS):
        check(sched.submit(JobSpec(
            res=ResourceSpec(cpu=float(rng.integers(4, 33)),
                             mem_bytes=int(rng.integers(1, 33)) << 30),
            node_num=int(rng.integers(2, 9)),
            time_limit=int(rng.integers(60, 86400)),
            partition=f"p{rng.integers(0, 4)}",
            sim_runtime=float(rng.integers(30, 1800))), now=0.0) > 0,
            "submit rejected")
    print(f"[cycle:{label}] setup {time.perf_counter() - t0:.1f}s "
          f"({len(sched.pending)} gangs)", flush=True)
    before = g.greedy_place.launches
    with Recording("solve_greedy_topo") as rec:
        started, last = cycle_once(sched, 100.0, label)
    check(g.greedy_place.launches == before,
          f"{label}: the gang cycle launched the greedy kernel")
    check(len(rec.calls) == 1, f"{label}: {len(rec.calls)} gang solves")
    check(last["solver"] == "topo", f"{label}: solver {last['solver']}")
    check(len(started) > 0, f"{label}: placed nothing")
    check_ledger(sched, label, resident=False)
    leaf = topo.block_of_node
    n_in = n_cross = 0
    for jid in started:
        job = sched.running[jid]
        leaves = {int(leaf[n]) for n in job.node_ids}
        if job.cross_block:
            n_cross += 1
            check(job.topo_block == "spanning",
                  f"{label}: cross gang {jid} block {job.topo_block!r}")
        else:
            n_in += 1
            check(len(leaves) == 1 and leaves != {-1}
                  and job.topo_block == topo.block_names[leaves.pop()],
                  f"{label}: in-block gang {jid} spans leaves")
    check((n_in, n_cross) == (last["topo_in_block"], last["topo_cross"]),
          f"{label}: in-block/cross counts differ from the trace")
    check(n_cross > 0, f"{label}: no gang took the spanning fallback")
    # the solve's time without the recording's copies
    ms = last["solve_ms"] - rec.calls[0]["copy_ms"]
    us = ms * 1e3 / max(last["pending"], 1)
    print(f"[cycle:{label}] {last['pending']} gangs: in-block {n_in}, "
          f"cross {n_cross}, unplaced {last['pending'] - len(started)}; "
          f"solve {ms:.1f} ms = {us:.1f} us/job; leaf "
          f"fragmentation {last['topo_frag']}", flush=True)
    cpu_check(label, route_vs_cpu, solve_greedy_topo, rec.calls[0], 1,
              (0, 2))
    last.update(cycle=0, us_per_job=us, route_ms=ms)
    return [last]


def phase_packed():
    """~``PACKED_JOBS`` candidates on ``N_NODES`` nodes, 10% packed
    (ntasks 4-32 over 1-4 nodes with a per-task request), 2% exclusive,
    the rest plain: one cycle through the packed solve."""
    from cranesched_tpu_torch.ctld import JobSpec, ResourceSpec
    from cranesched_tpu_torch.ctld import SchedulerConfig
    from cranesched_tpu_torch.models.packing import solve_packed

    label = "packed"
    rng = np.random.default_rng(5)
    t0 = time.perf_counter()
    sched, sim, _ = build_cell(rng, False, SchedulerConfig())
    kinds = {"packed": 0, "exclusive": 0, "plain": 0}
    for _ in range(PACKED_JOBS):
        u = rng.random()
        nn = int(rng.integers(1, 5)) if u < 0.12 else int(rng.integers(1, 3))
        shape = {}
        if u < 0.10:
            ntasks = int(rng.integers(max(4, nn), 33))
            shape = dict(task_res=ResourceSpec(
                cpu=float(rng.integers(1, 5)) / 2, mem_bytes=1 << 30),
                ntasks=ntasks,
                ntasks_per_node_max=-(-ntasks // nn) + int(rng.integers(0, 4)))
            kinds["packed"] += 1
        elif u < 0.12:
            shape = dict(exclusive=True)
            kinds["exclusive"] += 1
        else:
            kinds["plain"] += 1
        check(sched.submit(JobSpec(
            res=ResourceSpec(cpu=float(rng.integers(1, 9)),
                             mem_bytes=int(rng.integers(1, 17)) << 30),
            node_num=nn, time_limit=int(rng.integers(60, 86400)),
            partition=f"p{rng.integers(0, 4)}",
            sim_runtime=float(rng.integers(30, 1800)), **shape),
            now=0.0) > 0, "submit rejected")
    print(f"[cycle:{label}] setup {time.perf_counter() - t0:.1f}s "
          f"({len(sched.pending)} pending: {kinds})", flush=True)
    with Recording("solve_packed") as rec:
        started, last = cycle_once(sched, 100.0, label)
    check(last["solver"] == "packed", f"{label}: solver {last['solver']}")
    check(len(rec.calls) == 1, f"{label}: {len(rec.calls)} packed solves")
    check(len(started) > 0, f"{label}: placed nothing")
    check_ledger(sched, label, resident=False)
    meta = sched.meta
    got = {"packed": 0, "exclusive": 0}
    for jid in started:
        job = sched.running[jid]
        spec = job.spec
        if spec.task_res is not None:
            got["packed"] += 1
            check(len(job.task_layout) == spec.node_num
                  and sum(job.task_layout) == spec.ntasks
                  and all(spec.ntasks_per_node_min <= t
                          <= spec.ntasks_per_node_max
                          for t in job.task_layout),
                  f"{label}: job {jid} task layout {job.task_layout}")
        if spec.exclusive:
            got["exclusive"] += 1
            for n, a in zip(job.node_ids, sched._job_alloc(job)):
                check((a == meta.nodes[n].total).all()
                      and (meta.nodes[n].avail == 0).all(),
                      f"{label}: exclusive job {jid} does not hold node {n}")
    check(got["packed"] > 0 and got["exclusive"] > 0,
          f"{label}: started {got}")
    # the solve's time without the recording's copies
    ms = last["solve_ms"] - rec.calls[0]["copy_ms"]
    us = ms * 1e3 / max(last["pending"], 1)
    print(f"[cycle:{label}] started {len(started)} of {last['pending']} "
          f"({got}); solve {ms:.1f} ms = {us:.1f} us/job", flush=True)
    cpu_check(label, route_vs_cpu, solve_packed, rec.calls[0], 1, (0,))
    last.update(cycle=0, us_per_job=us, route_ms=ms, started_kinds=got)
    return [last]


def phase_preempt(backfill: bool):
    """QoS preemption in ``preempt_mode="requeue"``: a cold cycle of
    ``N_JOBS`` jobs (QoS low, and on p3 a ``MID_SHARE`` of QoS mid that
    ends within the time axis), then a burst of ``PREEMPT_BURST``
    high-QoS jobs that do not fit: single-node ones on p0-p2, gangs of
    4-8 on p3, where evicting the low jobs alone cannot free enough now.
    With backfill the what-if is ``solve_preempt_timed``: some gangs
    start at a later bucket with their evictions deferred to its edge,
    and a third cycle at the first due time drains those claims; without
    backfill it is ``solve_preempt``."""
    import torch

    from cranesched_tpu_torch.ctld import (
        JobSpec,
        JobStatus,
        PendingReason,
        ResourceSpec,
        SchedulerConfig,
    )
    from cranesched_tpu_torch.models import gpu_solver as g
    from cranesched_tpu_torch.models import solver_time as st
    from cranesched_tpu_torch.models.preempt import solve_preempt
    from cranesched_tpu_torch.models.preempt_time import solve_preempt_timed

    label = "preempt-" + ("timed" if backfill else "now")
    rng = np.random.default_rng(6)
    t0 = time.perf_counter()
    sched, sim, _ = build_cell(
        rng, False, SchedulerConfig(backfill=backfill,
                                    preempt_mode="requeue"),
        accounts=qos_accounts())

    def submit(qos, part, cpu, node_num, time_limit, runtime, now):
        jid = sched.submit(JobSpec(
            user="alice", account="hpc", qos=qos,
            res=ResourceSpec(cpu=float(cpu),
                             mem_bytes=int(rng.integers(1, 33)) << 30),
            node_num=node_num, time_limit=time_limit, partition=f"p{part}",
            sim_runtime=float(runtime)), now=now)
        check(jid > 0, "submit rejected")
        return jid

    # low jobs run 3,900 s or more, past every claim's due time (the time
    # axis is 64 buckets of 60 s); mid jobs end within 2,400 s
    kinds = {"low": 0, "mid": 0}
    for _ in range(N_JOBS):
        part = int(rng.integers(0, 4))
        cpu, nn = rng.integers(1, 17), int(rng.integers(1, 3))
        if part == 3 and rng.random() < MID_SHARE:
            tl = int(rng.integers(600, 2401))
            submit("mid", part, cpu, nn, tl, tl, 0.0)
            kinds["mid"] += 1
        else:
            tl = int(rng.integers(4000, 86401))
            submit("low", part, cpu, nn, tl,
                   min(tl, int(rng.integers(3900, 7201))), 0.0)
            kinds["low"] += 1
    print(f"[cycle:{label}] setup {time.perf_counter() - t0:.1f}s "
          f"({len(sched.pending)} pending: {kinds})", flush=True)
    g.greedy_place.launches = 0
    st.backfill_head.launches = 0
    started0, last0 = cycle_once(sched, 100.0, label)
    check(len(started0) > 0, f"{label}: cold cycle placed nothing")
    check(last0["preempted"] == 0, f"{label}: cold cycle preempted")
    check_ledger(sched, f"{label} cold", resident=False)

    high = [submit("high", 3 if gang else int(rng.integers(0, 3)),
                   rng.integers(24, 33),
                   int(rng.integers(4, 9)) if gang else 1,
                   int(rng.integers(300, 3600)), int(rng.integers(60, 1800)),
                   110.0)
            for gang in (i % 5 == 0 for i in range(PREEMPT_BURST))]
    running0 = set(sched.running)
    # every eviction happens inside a preemption commit that started its
    # preemptor, or in the prelude's drain as a claim that fell due; the
    # victim pends Preempted with its requeue count raised at once
    events = {"evicted": [], "drained": [], "bad": [], "owner": None,
              "claims": {}}
    evict, commit = sched._evict, sched._commit_preemption
    drain = sched._drain_deferred_evictions

    def spy_evict(victim_id, now):
        owner, job = events["owner"], sched.running.get(victim_id)
        count = job.requeue_count if job is not None else -1
        if owner is None:
            events["bad"].append(victim_id)
        elif owner == "drain":
            if events["claims"].get(victim_id, (np.inf,))[0] > now:
                events["bad"].append(victim_id)
            events["drained"].append(victim_id)
        evict(victim_id, now)
        job = sched.pending.get(victim_id)
        if (job is None or job.status != JobStatus.PENDING
                or job.pending_reason != PendingReason.PREEMPTED
                or job.requeue_count != count + 1):
            events["bad"].append(victim_id)
        events["evicted"].append(victim_id)

    def spy_commit(job, chosen, evict_ids, layout, now):
        events["owner"] = job.job_id
        try:
            ok = commit(job, chosen, evict_ids, layout, now)
        finally:
            events["owner"] = None
        if not ok and evict_ids and set(evict_ids) & set(events["evicted"]):
            events["bad"].append(job.job_id)
        return ok

    def spy_drain(now):
        events["owner"] = "drain"
        events["claims"] = dict(sched._deferred_evictions)
        try:
            drain(now)
        finally:
            events["owner"] = None

    sched._evict, sched._commit_preemption = spy_evict, spy_commit
    sched._drain_deferred_evictions = spy_drain
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    solve = solve_preempt_timed if backfill else solve_preempt
    with Recording(solve.__name__) as rec:
        started1, last1 = cycle_once(sched, 120.0, label)
    peak = torch.cuda.max_memory_allocated() if DEVICE == "cuda" else 0
    check(len(rec.calls) == 1, f"{label}: {len(rec.calls)} what-ifs")
    check(not events["bad"],
          f"{label}: evictions outside a started preemption, or victims "
          f"not requeued Preempted: {events['bad']}")
    evicted = list(events["evicted"])
    check(len(evicted) == last1["preempted"] > 0,
          f"{label}: {len(evicted)} evictions, trace {last1['preempted']}")
    check(set(evicted) <= running0, f"{label}: evicted a job not running")
    started_high = [j for j in started1 if j in set(high)]
    check(started_high, f"{label}: no high-QoS job started")
    claims = dict(sched._deferred_evictions)
    edges = set(sched._grid.edges.tolist())
    for vid, (due, pre) in claims.items():
        check(vid in sched.running and pre in sched.pending
              and (due - 120.0) in edges,
              f"{label}: claim {vid} -> {pre} due {due} off a bucket edge")
    check_ledger(sched, f"{label} burst", resident=False)
    J, V, M = last1["preempt_shape"]
    # the what-if's time without the recording's copies
    ms = last1["preempt_solve_ms"] - rec.calls[0]["copy_ms"]
    decisions = rec.calls[0]["out"][0]
    n_future, cut = 0, None
    if backfill:
        future = np.flatnonzero(decisions.placed.numpy()
                                & (decisions.start_bucket.numpy() > 0))
        n_future = len(future)
        check(n_future > 0 and claims,
              f"{label}: no future start deferred an eviction "
              f"({n_future} future starts, {len(claims)} claims)")
        cut = max(CPU_CHECK_PREEMPTORS, int(future[0]) + 1)
    print(f"[cycle:{label}] burst: J={J} V={V} M={M} solve {ms:.1f} ms = "
          f"{ms / max(J, 1):.3f} ms/preemptor (inputs "
          f"{last1['preempt_inputs_ms']:.1f} ms); evicted {len(evicted)}, "
          f"high started {len(started_high)} of {len(high)}, future starts "
          f"{n_future}, deferred claims {len(claims)} (victims) for "
          f"{len({p for _, p in claims.values()})} preemptors; "
          f"max_memory_allocated {peak / 2**20:.1f} MiB", flush=True)
    # the what-if against the same function on the CPU: all of it, or
    # the timed one's first preemptors, up to its first future start
    cpu_check(label, route_vs_cpu, solve, rec.calls[0], 5, (0,), cut)
    last1.update(cycle=1, evicted=len(evicted), claims=len(claims),
                 future_starts=n_future, high_started=len(started_high),
                 max_memory_bytes=peak, route_ms=ms,
                 ms_per_preemptor=ms / max(J, 1))
    last0.update(cycle=0)
    rows = [last0, last1]

    if backfill:
        # the first claims fall due: the next cycle's prelude evicts their
        # victims before the solve
        due = min(d for d, _ in claims.values())
        done = sim.advance_to(due)
        started2, last2 = cycle_once(sched, due, label)
        drained = events["drained"]
        check(not events["bad"], f"{label}: bad evictions {events['bad']}")
        check(drained and set(drained) <= {
            v for v, (d, _) in claims.items() if d <= due},
            f"{label}: drained {drained} at {due}")
        check(all(d > due for d, _ in sched._deferred_evictions.values()),
              f"{label}: a claim due by {due} survived the drain")
        check_ledger(sched, f"{label} drain", resident=False)
        owners = {claims[v][1] for v in drained}
        print(f"[cycle:{label}] drain at t={due} ({done} completions): "
              f"{len(drained)} claimed victims evicted for {len(owners)} "
              f"preemptors, of which {len(owners & set(sched.running))} "
              f"now run; {len(sched._deferred_evictions)} claims left",
              flush=True)
        last2.update(cycle=2, drained=len(drained))
        rows.append(last2)
    # one launch a cycle that runs the greedy kernel (immediate, or a
    # split backfill cycle's tail)
    want = sum(last["solver"] in ("cuda", "cuda-stream", "backfill-split")
               for last in rows)
    check(g.greedy_place.launches == want,
          f"{label}: {g.greedy_place.launches} kernel launches, want {want}")
    # and one launch of the head kernel a backfill cycle
    want = sum(last["solver"] in ("backfill", "backfill-split")
               for last in rows)
    check(st.backfill_head.launches == want,
          f"{label}: {st.backfill_head.launches} head kernel launches, "
          f"want {want}")
    return rows, g.greedy_place.launches, st.backfill_head.launches


def lifecycle_counts():
    """The lifecycle cell's submissions and events at ``LIFE_JOBS`` jobs
    and ``N_NODES`` nodes (their full-size values at 100,000 x 10,000)."""
    s = LIFE_JOBS / 100_000

    def k(n):
        return max(1, round(n * s))

    return {
        "plain": LIFE_JOBS - sum(k(n) for n in (10_000, 5_000, 4_000, 800,
                                              200)),
        "dependents": k(10_000), "or_deps": k(1_000), "missing_deps": k(500),
        "begin": k(5_000), "maint": k(4_000), "held": k(800),
        "arrays": k(200), "array_tasks": 50, "alloc": 10,
        "maint_nodes": N_NODES // 25, "licensed": k(4_000),
        "hold": k(500), "release": k(400), "modify_limit": k(200),
        "modify_prio": k(200), "requeue": k(100), "suspend": k(100),
        "resume": k(50), "cancel_pending": k(300),
        "cancel_running": k(300), "cancel_arrays": k(20),
        "nodes_down": max(1, N_NODES // 500), "steps": 3,
    }


def id_order(sched):
    """Re-insert the pending and running jobs in job-id order, the order
    a recovery builds its queues in; returns how many sat elsewhere
    (requeued jobs go back to the end of the queue)."""
    moved = 0
    for col in (sched.pending, sched.running):
        items = sorted(col.items())
        top = 0
        for jid in col:
            moved += jid < top
            top = max(top, jid)
        col.clear()
        for jid, job in items:
            col[jid] = job
    return moved


def life_state(sched, archive_ids):
    """What a restart must keep: the job ids pending, running and
    finished; per live job its status, nodes, allocation, hold, requeue
    count, dependency edges, array bookkeeping, step statuses and cancel
    intent; the ledger, license seats and QoS usage."""
    jobs = {}
    for col in (sched.pending, sched.running):
        for jid, j in col.items():
            alloc = ([a.tolist() for a in sched._job_alloc(j)]
                     if jid in sched.running else [])
            jobs[jid] = (j.status.name, tuple(j.node_ids), alloc, j.held,
                         j.requeue_count, tuple(sorted(j.dep_state.items())),
                         tuple(j.array_remaining), tuple(j.array_children),
                         tuple((s.step_id, s.status.name)
                               for s in j.steps.values()),
                         j.cancel_requested, j.suspended_total)
    am = sched.account_meta

    def usage(d):
        return {k: (u.jobs, u.submit_jobs, [] if u.tres is None
                    or not u.tres.any() else u.tres.tolist())
                for k, u in d.items() if u.jobs or u.submit_jobs}

    avail, _, alive = sched.meta.snapshot()
    return {
        "pending": sorted(sched.pending), "running": sorted(sched.running),
        "finished": sorted(set(sched.history) | archive_ids),
        "jobs": jobs, "avail": avail.tobytes(), "alive": alive.tobytes(),
        "licenses": {n: (v.in_use, v.total)
                     for n, v in sched.licenses.licenses.items()},
        "qos_usage": [usage(am._qos), usage(am._user), usage(am._acct)],
    }


def record_tail(sched, record, key):
    """Record every tail solve's inputs and outputs under ``key()`` (the
    greedy kernel's launches of a split backfill cycle)."""
    solve = sched._immediate_solve

    def spy(avail, total, alive, cost, batch, max_nodes, resident_ok=False):
        ins = (avail.cpu().clone(), total.copy(), alive.copy(),
               cost.cpu().clone(), host(batch.req, batch.node_num,
                                        batch.time_limit, batch.valid),
               batch.job_class_np.copy(), batch.class_rows_np.copy(),
               max_nodes)
        out = solve(avail, total, alive, cost, batch, max_nodes,
                    resident_ok=resident_ok)
        record[key()] = (host(out[0].placed, out[0].nodes, out[0].reason),
                         ins)
        return out

    sched._immediate_solve = spy


def phase_lifecycle(ref_commit_ms):
    """The job lifecycle and a restart at the north-star width, on the
    default configuration with accounts kept in a sqlite store, a job
    archive and an fsync'd WAL: ``LIFE_JOBS`` submissions in one WAL group
    (plain jobs, dependents, begin times, jobs in the reservation
    ``maint``, held jobs, array templates, allocations); cycle 1; the
    operator's events up to t = 900 as jobs complete; cycle 2, with
    ``maint`` active; a crash after its dispatch; recovery into a fresh
    scheduler from the store and the WAL; cycle 3 on the recovered
    scheduler and on the one that did not crash, held equal.
    ``ref_commit_ms`` is the default cell's cold commit without a WAL."""
    import os
    import shutil
    import tempfile

    from cranesched_tpu_torch.craned.sim import SimCluster
    from cranesched_tpu_torch.ctld import (
        JobScheduler,
        JobSpec,
        JobStatus,
        MetaContainer,
        ResourceSpec,
        SchedulerConfig,
        StepSpec,
        WriteAheadLog,
    )
    from cranesched_tpu_torch.ctld.accounting import (
        Account,
        AccountManager,
        User,
    )
    from cranesched_tpu_torch.ctld.acct_store import AccountStore, attach_store
    from cranesched_tpu_torch.ctld.archive import JobArchive
    from cranesched_tpu_torch.ctld.defs import ArraySpec, Dependency, DepType
    from cranesched_tpu_torch.models import gpu_solver as g

    label = "lifecycle"
    n = lifecycle_counts()
    rng = np.random.default_rng(9)
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="crane-lifecycle-")
    try:
        paths = {k: os.path.join(tmp, f) for k, f in (
            ("wal", "ctld.wal"), ("acct", "acct.sqlite"),
            ("archive", "history.sqlite"))}
        mgr = AccountManager()
        attach_store(mgr, AccountStore(paths["acct"]))
        qos_accounts(mgr)
        mgr.add_account("root", Account(name="ops",
                                        allowed_qos={"low", "high"},
                                        default_qos="low"))
        mgr.add_user("root", User(name="alice", uid=1), "ops")
        sched, sim, _ = build_cell(rng, False, SchedulerConfig(),
                                   accounts=mgr)
        meta = sched.meta
        wal = WriteAheadLog(paths["wal"], fsync=True)
        sched.wal = wal
        # the automatic compactions (one per 1,000 finalized jobs with an
        # archive attached), counted and timed
        compactions = {"n": 0, "s": 0.0}
        compact = wal.compact

        def counted_compact(*args, **kwargs):
            t1 = time.perf_counter()
            compact(*args, **kwargs)
            compactions["n"] += 1
            compactions["s"] += time.perf_counter() - t1

        wal.compact = counted_compact
        sched.attach_archive(JobArchive(paths["archive"]))
        sched.licenses.configure("matlab", n["licensed"] // 2)
        maint = [i for i in range(N_NODES) if i % 4 == 1][:n["maint_nodes"]]
        check(meta.create_reservation(
            "maint", "p1", [meta.nodes[i].name for i in maint], 600.0,
            4200.0, allowed_accounts=["ops"]) is not None,
            "reservation refused")
        maint_set = set(maint)

        def spec(part=None, account="hpc", tl=None, runtime=None, **kw):
            return JobSpec(
                user="alice", account=account,
                res=ResourceSpec(cpu=float(rng.integers(1, 17)),
                                 mem_bytes=int(rng.integers(1, 33)) << 30),
                node_num=int(rng.integers(1, 3)),
                time_limit=int(tl if tl is not None
                               else rng.integers(60, 86400)),
                partition=part or f"p{rng.integers(0, 4)}",
                sim_runtime=float(runtime if runtime is not None
                                  else rng.integers(600, 7201)), **kw)

        def submit(s, now):
            jid = sched.submit(s, now=now)
            check(jid > 0, f"{label}: submit rejected")
            return jid

        # 1. LIFE_JOBS submissions at t = 0 in one WAL group
        kinds = {}
        t0 = time.perf_counter()
        bytes0 = os.path.getsize(paths["wal"])
        f0, g0 = wal.fsync_total, wal.groups_total
        with wal.group():
            kinds["alloc"] = [submit(JobSpec(
                user="alice", account="hpc", qos="high",
                res=ResourceSpec(cpu=4.0, mem_bytes=4 << 30),
                alloc_only=True, time_limit=3600, partition="p2"), 0.0)
                for _ in range(n["alloc"])]
            lic = set(rng.choice(n["plain"] - n["alloc"], n["licensed"],
                                 replace=False).tolist())
            kinds["plain"] = [submit(spec(
                licenses={"matlab": 1} if i in lic else None), 0.0)
                for i in range(n["plain"] - n["alloc"])]
            plain = kinds["plain"]
            plain_ids = np.asarray(plain)   # one conversion, not one a draw
            deps = []
            for i in range(n["dependents"]):
                kind = DepType.AFTER_OK if i % 2 else DepType.AFTER_ANY
                if i < n["missing_deps"]:
                    d = (Dependency(10**9 + i, kind),)
                elif i < n["missing_deps"] + n["or_deps"]:
                    a, b = rng.choice(plain_ids, 2, replace=False).tolist()
                    d = (Dependency(a, kind), Dependency(b, kind))
                else:
                    d = (Dependency(int(rng.choice(plain_ids)), kind),)
                deps.append(submit(spec(dependencies=d,
                                        deps_is_or=len(d) == 2), 0.0))
            kinds["dependents"] = deps
            kinds["begin"] = [submit(spec(begin_time=float(
                rng.uniform(0.0, 1800.0))), 0.0) for _ in range(n["begin"])]
            kinds["maint"] = [submit(spec(
                part="p1", account="ops", reservation="maint",
                tl=rng.integers(300, 3601)), 0.0) for _ in range(n["maint"])]
            kinds["held"] = [submit(spec(held=True), 0.0)
                             for _ in range(n["held"])]
            kinds["arrays"] = [submit(spec(
                tl=rng.integers(600, 3601), runtime=rng.integers(60, 601),
                array=ArraySpec(start=0, end=n["array_tasks"] - 1,
                                max_concurrent=5 if i % 2 else 0)), 0.0)
                for i in range(n["arrays"])]
        records = wal.seq
        check(records == LIFE_JOBS and wal.durable_seq == records,
              f"{label}: {records} WAL records, {wal.durable_seq} durable")
        check(wal.fsync_total - f0 == 1 and wal.groups_total - g0 == 1,
              f"{label}: the submissions took {wal.fsync_total - f0} "
              f"fsyncs in {wal.groups_total - g0} groups")
        wal_rows = [{"step": "submit", "records": records,
                     "bytes": os.path.getsize(paths["wal"]) - bytes0,
                     "fsyncs": 1, "groups": 1,
                     "s": time.perf_counter() - t0}]
        print(f"[cycle:{label}] setup + {LIFE_JOBS} submissions in one WAL "
              f"group: {wal_rows[0]['s']:.1f}s, {records} records, "
              f"{wal_rows[0]['bytes'] / 2**20:.1f} MiB, 1 fsync "
              f"({ {k: len(v) for k, v in kinds.items()} })", flush=True)

        record, cur = {}, {"key": None}
        record_tail(sched, record, lambda: cur["key"])
        rows = []

        def wal_delta(step, fn, wal=wal):
            b, s, f, gr = (os.path.getsize(paths["wal"]), wal.seq,
                           wal.fsync_total, wal.groups_total)
            t1 = time.perf_counter()
            out = fn()
            row = {"step": step, "records": wal.seq - s,
                   "bytes": os.path.getsize(paths["wal"]) - b,
                   "fsyncs": wal.fsync_total - f,
                   "groups": wal.groups_total - gr,
                   "s": time.perf_counter() - t1}
            wal_rows.append(row)
            print(f"[cycle:{label}] WAL {step}: {row}", flush=True)
            return out

        def cycle(sched, now, tag):
            cur["key"] = tag
            before = g.greedy_place.launches
            started, last = cycle_once(sched, now, f"{label} {tag}")
            check(g.greedy_place.launches == before + 1,
                  f"{label} {tag}: kernel launched "
                  f"{g.greedy_place.launches - before} times")
            check(last["solver"] == "backfill-split",
                  f"{label} {tag}: solver {last['solver']}")
            check(sched.stats.get("dispatch_dropped", 0) == 0,
                  f"{label} {tag}: dispatches dropped")
            check_ledger(sched, f"{label} {tag}", resident=False)
            last.update(cycle=tag)
            rows.append(last)
            return started

        def on_maint(jid, s):
            return bool(set(s.job_info(jid).node_ids) & maint_set)

        # 2. cycle 1 (maint not active: its jobs place nowhere, others
        # whose window reaches t = 600 stay off its nodes)
        g.greedy_place.launches = 0
        started1 = wal_delta("cycle 1", lambda: cycle(sched, 1.0, "c1"))
        s1 = set(started1)
        check(set(kinds["alloc"]) <= s1, f"{label}: an allocation waits")
        for kind in ("maint", "dependents", "held", "arrays"):
            check(not s1 & set(kinds[kind]), f"{label}: a {kind} job ran")
        check(all(sched.job_info(j).spec.begin_time <= 1.0
                  for j in s1 & set(kinds["begin"])),
              f"{label}: a job started before its begin time")
        check(not any(on_maint(j, sched) for j in started1
                      if sched.job_info(j).spec.time_limit > 599),
              f"{label}: a job whose window meets maint's placed on it")
        check(rows[-1]["wal_fsyncs"] == rows[-1]["wal_groups"] <= 3,
              f"{label}: cycle 1 WAL {rows[-1]['wal_fsyncs']} fsyncs")

        # 3. the operator's events as jobs complete (lone appends: each
        # is durable, one fsync, before it returns)
        def pick(pool, k, where):
            pool = [j for j in pool if where(j)]
            return [pool[i] for i in sorted(rng.choice(
                len(pool), min(k, len(pool)), replace=False).tolist())]

        def running_plain(j):
            job = sched.running.get(j)
            return job is not None and job.status == JobStatus.RUNNING

        def events_100():
            done = sim.advance_to(100.0)
            held = pick(plain, n["hold"], lambda j: j in sched.pending
                        and not sched.pending[j].held)
            check(all(sched.hold(j, True, 100.0) for j in held), "hold")
            for j in pick(plain, n["modify_limit"], running_plain):
                check(sched.modify_job(j, 100.0, time_limit=float(
                    sched.running[j].spec.time_limit + 3600)) == "",
                    "modify time limit")
            for j in pick(plain, n["modify_prio"],
                          lambda j: j in sched.pending):
                check(sched.modify_job(j, 100.0, priority=500) == "",
                      "modify priority")
            susp = pick(plain, n["suspend"], running_plain)
            check(all(sched.suspend(j, 100.0) for j in susp), "suspend")
            for a in kinds["alloc"]:
                for k, rt in enumerate((60.0, 120.0, 1e6)):
                    check(sched.submit_step(a, StepSpec(
                        name=f"s{k}", res=ResourceSpec(cpu=1.0),
                        sim_runtime=rt), 100.0) == k, "submit_step")
            return done, held, susp

        done100, held, susp = wal_delta("events t=100", events_100)

        def events_300():
            done = sim.advance_to(300.0)
            for j in held[:n["release"]]:
                check(sched.hold(j, False, 300.0), "release")
            for j in susp[:n["resume"]]:
                check(sched.resume(j, 300.0), "resume")
            for j in pick(plain, n["requeue"], running_plain):
                check(sched.requeue(j, 300.0) == "", "requeue")
            for j in pick(plain, n["cancel_pending"], lambda j:
                          j in sched.pending and not sched.pending[j].held):
                check(sched.cancel(j, 300.0), "cancel pending")
            for j in pick(plain, n["cancel_running"], running_plain):
                check(sched.cancel(j, 300.0), "cancel running")
            for j in kinds["arrays"][:n["cancel_arrays"]]:
                check(sched.cancel(j, 300.0), "cancel template")
            busy = sorted({nd for j in sched.running.values()
                           for nd in j.node_ids} - maint_set)
            down = [busy[i] for i in sorted(rng.choice(
                len(busy), n["nodes_down"], replace=False).tolist())]
            victims = sum(len(sched.on_craned_down(d, 300.0)) for d in down)
            return done, down, victims

        done300, down, victims = wal_delta("events t=300", events_300)
        print(f"[cycle:{label}] events: {done100} + {done300} completions "
              f"by t=300, {len(down)} nodes down ({victims} jobs)",
              flush=True)

        # 4. cycle 2: maint is active, its class row reaches the kernel
        done900 = sim.advance_to(900.0)
        started2 = wal_delta("cycle 2", lambda: cycle(sched, 900.0, "c2"))
        s2 = set(started2)
        m2 = s2 & set(kinds["maint"])
        check(m2 and all(set(sched.job_info(j).node_ids) <= maint_set
                         for j in m2),
              f"{label}: {len(m2)} maint jobs, or one outside its nodes")
        check(not any(on_maint(j, sched) for j in s2 - m2),
              f"{label}: a job outside maint placed on its nodes")
        (placed, _nodes, _r), ins = record["c2"]
        rows_np, jc, valid = ins[6], ins[5], ins[4][3]
        mrow = np.zeros(N_NODES, bool)
        mrow[maint] = True
        cls = [c for c in range(rows_np.shape[0])
               if np.array_equal(rows_np[c], mrow)]
        tail_maint = int((np.isin(jc, cls) & valid).sum()) if cls else 0
        check(tail_maint > 0, f"{label}: no maint class row in the tail")
        print(f"[cycle:{label}] cycle 2: {done900} completions by t=900; "
              f"started {len(s2)}: maint {len(m2)} (tail rows in maint's "
              f"class: {tail_maint}), dependents "
              f"{len(s2 & set(kinds['dependents']))}, begin "
              f"{len(s2 & set(kinds['begin']))}, array children "
              f"{sum(sched.job_info(j).array_parent_id is not None for j in s2)}"
              f"; WAL compactions {compactions['n']} in "
              f"{compactions['s']:.1f}s, the WAL now "
              f"{os.path.getsize(paths['wal']) / 2**20:.1f} MiB", flush=True)

        # 5. crash right after cycle 2's dispatch: no compaction
        wal.close()
        twin, twin_archive = sched, sched.archive
        twin.wal = None

        # 6. recovery in fresh process state
        t_r = time.perf_counter()
        meta2 = MetaContainer()
        for i in sorted(meta.nodes):
            node = meta.nodes[i]
            meta2.add_node(node.name, node.total.copy(),
                           partitions=sorted(node.partitions))
            if node.alive:
                meta2.craned_up(i)
        check(meta2.create_reservation(
            "maint", "p1", [meta.nodes[i].name for i in maint], 600.0,
            4200.0, allowed_accounts=["ops"]) is not None, "reservation")
        mgr2 = AccountManager()
        attach_store(mgr2, AccountStore(paths["acct"]))
        rec = JobScheduler(meta2, SchedulerConfig(), device=DEVICE,
                           accounts=mgr2,
                           archive=JobArchive(paths["archive"]))
        rec.licenses.configure("matlab", n["licensed"] // 2)
        sim2 = SimCluster(rec)
        sim2.wire(rec)
        record_tail(rec, record, lambda: cur["key"])
        times = {"setup_s": time.perf_counter() - t_r}
        t1 = time.perf_counter()
        replayed = WriteAheadLog.replay(paths["wal"])
        times["replay_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        rec.recover(replayed, now=900.0)
        times["recover_s"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        rec.rebuild_device_state()
        times["rebuild_device_state_s"] = time.perf_counter() - t1
        check(rec._resident._state is None,
              f"{label}: the resident state survived the rebuild")
        t1 = time.perf_counter()
        rec.wal = WriteAheadLog(paths["wal"], fsync=True)
        times["wal_reopen_s"] = time.perf_counter() - t1
        times["replayed_jobs"] = len(replayed)
        print(f"[cycle:{label}] recovery: {json.dumps(times)}", flush=True)
        for jid, job in twin.running.items():
            ev, wjob = replayed.get(jid, (None, None))
            check(wjob is not None and wjob.status == job.status
                  and wjob.node_ids == job.node_ids,
                  f"{label}: running job {jid} has no start record")

        # 7. the recovered scheduler against the twin.  One divergence is
        # the JAX package's own (tests/test_torch_wal.py): an edge still
        # waiting in a dependent's last record, whose dependee finished
        # and was compacted out of the WAL into the archive, recovers
        # never-satisfied (``recover`` asks ``job_info``, which does not
        # read the archive) while the twin has it satisfied.  Exactly
        # those edges may differ; the dependents are held on both sides
        # before cycle 3
        archived = {r[0] for r in twin_archive._db.execute(
            "SELECT job_id FROM jobs")}
        a, b = life_state(twin, archived), life_state(rec, archived)
        lost = {}
        for jid, job in rec.pending.items():
            for dep, v in job.dep_state.items():
                tv = twin.pending[jid].dep_state.get(dep) \
                    if jid in twin.pending else None
                if v != tv:
                    check(v == float("inf") and tv not in (None, v)
                          and rec.job_info(dep) is None
                          and dep in archived
                          and twin.job_info(dep).status.is_terminal,
                          f"{label}: job {jid}'s edge on {dep} recovered "
                          f"{v}, the twin has {tv}")
                    lost.setdefault(jid, []).append(dep)
        for jid in lost:
            ta, tb = list(a["jobs"][jid]), list(b["jobs"][jid])
            check(ta[:5] + ta[6:] == tb[:5] + tb[6:],
                  f"{label}: job {jid} differs beyond its edges")
            b["jobs"][jid] = a["jobs"][jid]
        bad = [k for k in a if a[k] != b[k]]
        if "jobs" in bad:
            diff = [j for j in a["jobs"] if a["jobs"][j] != b["jobs"].get(j)]
            print(f"[cycle:{label}] differing jobs {diff[:5]}: "
                  f"{[(a['jobs'][j], b['jobs'].get(j)) for j in diff[:2]]}",
                  flush=True)
        check(not bad, f"{label}: recovered state differs from the twin in "
              f"{bad}")
        print(f"[cycle:{label}] recovered == twin: {len(a['pending'])} "
              f"pending, {len(a['running'])} running, {len(a['finished'])} "
              f"finished; ledger, license seats and QoS usage equal; "
              f"{len(lost)} dependents with {sum(map(len, lost.values()))} "
              f"edges on compacted dependees recovered never-satisfied",
              flush=True)

        # 8. cycle 3 on both, no simulated time in between: the same
        # operator cancels on both free room; the twin's queues in id
        # order, as a recovery builds them (requeued jobs go back to the
        # end of the twin's queue, and ties in priority break by queue
        # position)
        moved = id_order(twin)
        for jid in sorted(lost):
            check(twin.hold(jid, True, 950.0) and rec.hold(jid, True, 950.0),
                  f"{label}: hold {jid}")
        running = sorted(j for j in twin.running
                         if j not in set(kinds["alloc"]))
        freed = sorted(rng.choice(running, n["cancel_running"],
                                  replace=False).tolist())
        check(all(twin.cancel(j, 950.0) for j in freed), "cancel on twin")
        wal_delta("cancels t=950 (recovered)", lambda: check(
            all(rec.cancel(j, 950.0) for j in freed), "cancel recovered"),
            wal=rec.wal)
        started3 = cycle(twin, 960.0, "c3-twin")
        started3r = wal_delta("cycle 3 (recovered)",
                              lambda: cycle(rec, 960.0, "c3-recovered"),
                              wal=rec.wal)
        check(started3 == started3r and started3,
              f"{label}: cycle 3 started {len(started3)} on the twin, "
              f"{len(started3r)} recovered, "
              f"{len(set(started3) ^ set(started3r))} differ")
        check(all(twin.job_info(j).node_ids == rec.job_info(j).node_ids
                  for j in started3), f"{label}: cycle 3 nodes differ")
        reasons = [{j: job.pending_reason for j, job in s.pending.items()}
                   for s in (twin, rec)]
        check(reasons[0] == reasons[1], f"{label}: pending reasons differ")
        check(record["c3-twin"][0][0].shape == record["c3-recovered"][0][0]
              .shape and all(np.array_equal(x, y) for x, y in zip(
                  record["c3-twin"][0], record["c3-recovered"][0])),
              f"{label}: the tail kernel's outputs differ")
        launches = g.greedy_place.launches
        check(launches == 4, f"{label}: {launches} kernel launches")
        out3, ins3 = record["c3-recovered"]
        cpu_check(f"{label} recovered tail", plain_check, out3, *ins3)
        wall = time.perf_counter() - t_phase
        commits = {r["cycle"]: r["commit_ms"] for r in rows}
        print(f"[cycle:{label}] cycle 3: {len(freed)} cancelled on both, "
              f"{len(started3)} started, equal on the twin and the "
              f"recovered scheduler (nodes, reasons, tail kernel outputs); "
              f"{moved} twin jobs sat out of id order", flush=True)
        print(f"[cycle:{label}] commit_ms with the WAL: {commits}; the "
              f"default cell's cold commit without one: {ref_commit_ms}; "
              f"wall {wall:.1f}s", flush=True)
        twin.archive.close()
        rec.archive.close()
        rec.wal.close()
        return rows, launches, {"wal": wal_rows, "recovery": times,
                                "compactions": compactions,
                                "lost_edges": sum(map(len, lost.values())),
                                "commit_ms": commits,
                                "ref_commit_ms": ref_commit_ms,
                                "moved": moved, "wall_s": wall}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# 11. the observability planes and the JAX package's solver names
# ---------------------------------------------------------------------------

# chrome-trace categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# explain_pending is held against the pending reason of this many jobs
EXPLAIN_JOBS = 200


def _union(intervals):
    """Sorted, merged ``[start, end)`` intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def window_report(events, label, wall0, stamps):
    """One cycle of a profiler capture (``events``: the chrome trace's
    ``traceEvents``): the cycle is the ``crane:cycle:<label>`` span; the
    card's work inside it is the union of its kernel, memcpy and memset
    intervals.  Returns the busy share, the 5 device operations that took
    the most time and the 5 longest idle gaps with the ``crane:*`` span
    or host phase (from the flight recorder's stamps ``stamps``, mapped
    onto the trace's clock through the cycle span's start ``wall0``)
    each falls in."""
    span = [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"
            and e.get("name") == f"crane:cycle:{label}"]
    check(len(span) == 1, f"obs {label}: {len(span)} cycle spans in the "
          "capture")
    w0 = float(span[0]["ts"])
    w1 = w0 + float(span[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS
           and float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0]
    check(dev, f"obs {label}: the capture shows no work on the card")
    busy = _union([max(float(e["ts"]), w0),
                   min(float(e["ts"]) + float(e["dur"]), w1)] for e in dev)
    busy_us = sum(b - a for a, b in busy)
    by_name = {}
    for e in dev:
        n = e["name"][:72]
        ms, k = by_name.get(n, (0.0, 0))
        by_name[n] = (ms + float(e["dur"]) / 1e3, k + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    solves = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"]) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and str(e.get("name", "")).startswith("crane:solve:")
                    and w0 <= float(e["ts"]) < w1)
    offset = w0 - wall0 * 1e6
    at = {}
    for st in stamps:
        at.setdefault(st["phase"], st["t"] * 1e6 + offset)
    first_solve = solves[0][0] if solves else w1

    def phase_of(m):
        for a, b, name in solves:
            if a <= m < b:
                return name
        if m < at.get("prelude", w0):
            return "drain"
        if m < first_solve:
            return "prelude"
        if m < at.get("dispatch", w1):
            return "commit"
        return "dispatch"

    gaps, cur = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:5]
    return {
        "cycle_ms": (w1 - w0) / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / (w1 - w0),
        "device_idle_share": 1.0 - busy_us / (w1 - w0),
        "device_ops": len(dev),
        "top_ops": [{"name": n, "ms": ms, "count": k}
                    for n, (ms, k) in top],
        "top_gaps": [{"ms": (b - a) / 1e3, "in": phase_of((a + b) / 2)}
                     for a, b in gaps],
        "solve_spans": [{"name": n, "ms": (b - a) / 1e3}
                        for a, b, n in solves],
    }


def profiled_cycles(sched, sim, submit, now, labels, step=900.0):
    """Run one cycle per label under ``sched.profiler_window``, each
    inside a ``crane:cycle:<label>`` span; returns the per-cycle reports,
    the time reached and the capture's directory and size.  The window
    is armed for one tick more than there are cycles and ticked once by
    hand before the first (the capture must be running when the first
    cycle's span opens) and once after the last (the boundary that stops
    it); each cycle ticks it once at its start."""
    from torch.profiler import record_function

    from cranesched_tpu_torch.obs import introspect

    ok, d = sched.profiler_window.request(len(labels) + 1)
    check(ok, f"profiler window refused: {d}")
    sched.profiler_window.tick()   # starts the capture
    marks = []
    for label in labels:
        now += step
        sim.advance_to(now)
        submit(TOPUP_JOBS, now)
        with record_function(f"crane:cycle:{label}"):
            wall0 = time.time()
            started = sched.schedule_cycle(now=now)
        check(started, f"obs {label}: placed nothing")
        stamps = [st for st in sched.flight.report(tail=64)["phases"]
                  if st["t"] >= wall0]
        marks.append((label, wall0, stamps,
                      dict(sched.cycle_trace.snapshot()[-1]),
                      dict(sched.stats["last_cycle"])))
    sched.profiler_window.tick()   # the boundary after the last: stop
    st = sched.profiler_window.status()
    check(st["captures_done"] >= 1 and not st["last_error"]
          and st["last_capture"] == d,
          f"profiler window: {st}")
    path = f"{d}/{introspect.TRACE_FILE}"
    import os

    size = os.path.getsize(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    out = []
    for label, wall0, stamps, row, last in marks:
        rep = window_report(events, label, wall0, stamps)
        rep.update(trace_row={k: row[k] for k in (
            "solver", "total_ms", "solve_ms", "commit_ms", "recompiles",
            "device_bytes", "device_peak_bytes", "device_buffers",
            "candidates", "placed") if k in row},
            label=label, placed=last["started"])
        check(row["recompiles"] == 0, f"obs {label}: a warm cycle paid "
              f"{row['recompiles']} builds")
        check(row["device_bytes"] > 0 and row["device_peak_bytes"]
              >= row["device_bytes"], f"obs {label}: device memory {row}")
        print(f"[obs:{label}] device busy {rep['device_busy_share']:.4f} "
              f"of {rep['cycle_ms']:.1f} ms under the window "
              f"({rep['device_ops']} device ops); top ops "
              f"{json.dumps(rep['top_ops'])}; longest idle gaps "
              f"{json.dumps(rep['top_gaps'])}; trace row "
              f"{json.dumps(rep['trace_row'])}", flush=True)
        out.append(rep)
    del events
    return out, now, {"capture": d, "bytes": size}


def cycle_outcome(sched, started):
    """What a twin comparison holds equal: the started jobs in order,
    their nodes, every pending job's reason and the ledger."""
    meta = sched.meta
    return (list(started),
            {j: list(sched.running[j].node_ids) for j in started},
            {j: job.pending_reason.value
             for j, job in sched.pending.items()},
            np.stack([meta.nodes[i].avail for i in sorted(meta.nodes)]))


def same_outcome(label, a, b):
    check(a[0] == b[0], f"{label}: started jobs differ")
    check(a[1] == b[1], f"{label}: node assignments differ")
    check(a[2] == b[2], f"{label}: pending reasons differ")
    check(np.array_equal(a[3], b[3]), f"{label}: post-cycle ledger differs")


def stall_drill(sched):
    """The flight recorder's stall sentry around a deliberately slow
    closure: it fires once, with every thread's stack and one
    ``flight_stall`` event."""
    fr = sched.flight
    before = fr.stalls_total
    n_events = len(sched.events.since(type="flight_stall"))
    fr.stamp("drill")
    fr.arm(0.2, label="drill")

    def slow():
        deadline = time.monotonic() + 5.0
        while fr.stalls_total == before and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.3)   # past the deadline: the sentry must not refire

    slow()
    fr.disarm()
    stall = fr.report()["last_stall"]
    fired = fr.stalls_total - before
    ev = sched.events.since(type="flight_stall")[n_events:]
    check(fired == 1, f"stall drill: the sentry fired {fired} times")
    check(stall is not None and stall["label"] == "drill"
          and stall["stacks"], "stall drill: no stacks captured")
    check(len(ev) == 1 and "drill stalled; last phase drill" in
          ev[0]["detail"], f"stall drill: events {ev}")
    return {"fired": fired, "threads": len(stall["stacks"]),
            "event": ev[0]["detail"]}


def phase_obs():
    """The observability planes on the main paths: (a) the immediate
    cycle on the disjoint cell under the profiler window (two warm
    cycles, after an unprofiled cold one), and the default cell's warm
    split cycle under it; (b) the default cell's cold cycle with the job
    trace on and off; (c) explain_pending on pending jobs of the warm
    cycle and a stall drill.  Returns the phase's report, the greedy
    kernel's launches on its paths, and the disjoint cell's cold-cycle
    outcome (the twin of phase_native)."""
    from cranesched_tpu_torch.ctld import SchedulerConfig
    from cranesched_tpu_torch.models import gpu_solver as g
    from cranesched_tpu_torch.obs import introspect

    rep = {}
    # (a) the immediate cycle under the window
    label = "obs-disjoint"
    rng = np.random.default_rng(1)
    gc.collect()
    t0 = time.perf_counter()
    sched, sim, submit = build_cell(rng, False,
                                    SchedulerConfig(backfill=False))
    submit(N_JOBS, 0.0)
    print(f"[cycle:{label}] setup {time.perf_counter() - t0:.1f}s",
          flush=True)
    record = {}
    solve = sched._immediate_solve

    def spy(avail, total, alive, cost0, batch, max_nodes, resident_ok=False):
        out = solve(avail, total, alive, cost0, batch, max_nodes,
                    resident_ok=resident_ok)
        if "in" not in record and record.get("armed"):
            record["in"] = (avail.copy(), total.copy(), alive.copy(),
                            cost0.copy(), host(batch.req, batch.node_num,
                                               batch.time_limit,
                                               batch.valid),
                            batch.job_class_np.copy(),
                            batch.class_rows_np.copy(), max_nodes)
            record["out"] = host(out[0].placed, out[0].nodes,
                                 out[0].reason)
        return out

    sched._immediate_solve = spy
    launches = {}
    g.greedy_place.launches = 0
    started, cold = cycle_once(sched, 100.0, label + " cold")
    twin = cycle_outcome(sched, started)
    record["armed"] = True
    # warm cycles 300 s apart: some completions each, and a backlog left
    # pending for explain_pending
    windows, now, cap = profiled_cycles(sched, sim, submit, 100.0,
                                        ["warm1", "warm2"], step=300.0)
    # the cycle times outside the window (the profiler slows the host)
    now += 300.0
    sim.advance_to(now)
    submit(TOPUP_JOBS, now)
    _, unprofiled = cycle_once(sched, now, label + " warm3")
    launches["obs_immediate"] = g.greedy_place.launches
    check(launches["obs_immediate"] == 4,
          f"{label}: {launches['obs_immediate']} launches for 4 cycles")
    cpu_check(f"{label} cycle under the window", plain_check,
              record["out"], *record["in"])
    # (c) explain_pending against the warm cycle's pending reasons
    ids = sorted(sched.pending)
    check(len(ids) >= EXPLAIN_JOBS, f"explain: {len(ids)} pending jobs")
    pick = [ids[i] for i in np.linspace(0, len(ids) - 1, EXPLAIN_JOBS,
                                         dtype=int)]
    gates = {}
    t1 = time.perf_counter()
    for jid in pick:
        ex = sched.explain_pending(jid, now)
        job = sched.pending[jid]
        check(ex["gate"], f"explain {jid}: no gate")
        check(ex["reason"] == job.pending_reason.value,
              f"explain {jid}: {ex['reason']} (gate {ex['gate']}, "
              f"{ex['detail']}) != pending reason "
              f"{job.pending_reason.value}")
        gates[ex["gate"]] = gates.get(ex["gate"], 0) + 1
    explain_ms = (time.perf_counter() - t1) * 1e3 / len(pick)
    drill = stall_drill(sched)
    print(f"[obs:explain] {len(pick)} pending jobs: gates {gates}, "
          f"{explain_ms:.2f} ms each; stall drill {json.dumps(drill)}",
          flush=True)
    rep["immediate"] = {"cold": cold, "window": windows, "capture": cap,
                        "unprofiled_warm": unprofiled}
    rep["explain"] = {"jobs": len(pick), "gates": gates,
                      "ms_per_job": explain_ms, "stall_drill": drill}
    del sched, sim, submit

    # (b) the default cell's cold cycle, job trace on and off; the
    # earlier cells' garbage (reference cycles through the spies) is
    # collected first, so that no cycle pays for another's
    cost = {}
    for job_trace in (True, False):
        label = f"obs-default trace={job_trace}"
        rng = np.random.default_rng(2)
        gc.collect()
        sched, sim, submit = build_cell(
            rng, False, SchedulerConfig(job_trace=job_trace))
        submit(N_JOBS, 0.0)
        gc.collect()
        self0 = introspect.self_time_s()
        rec0 = sched.jobtrace.self_time_s if job_trace else 0.0
        g.greedy_place.launches = 0
        started, last = cycle_once(sched, 100.0, label)
        n = g.greedy_place.launches
        check(n == 1, f"{label}: {n} launches")
        launches[f"obs_default_trace_{job_trace}"] = n
        cost[job_trace] = {
            "prelude_ms": last["prelude_ms"], "commit_ms": last["commit_ms"],
            "dispatch_ms": last["dispatch_ms"],
            "total_ms": last["total_ms"],
            "placed": len(started),
            "introspect_self_ms": (introspect.self_time_s() - self0) * 1e3,
            # the recorder's own time inside the cycle: its direct cost
            "jobtrace_cycle_ms": ((sched.jobtrace.self_time_s - rec0) * 1e3
                                  if job_trace else 0.0),
            "jobtrace": (sched.jobtrace.stats() if job_trace else None)}
        cost[job_trace]["introspect_share"] = (
            cost[job_trace]["introspect_self_ms"] / last["total_ms"])
        if job_trace:
            outcome = cycle_outcome(sched, started)
            # the split warm cycle under the window
            g.greedy_place.launches = 0
            split, _, split_cap = profiled_cycles(sched, sim, submit,
                                                  100.0, ["split-warm"])
            n = g.greedy_place.launches
            check(n == 1, f"obs split warm: {n} launches")
            launches["obs_split"] = n
            rep["split"] = {"window": split, "capture": split_cap}
        else:
            same_outcome("job trace on vs off", outcome,
                         cycle_outcome(sched, started))
        del sched, sim, submit
    on, off = cost[True], cost[False]
    print(f"[obs:job-trace] default cold cycle, on vs off: prelude "
          f"{on['prelude_ms']:.1f} vs {off['prelude_ms']:.1f} ms, commit "
          f"{on['commit_ms']:.1f} vs {off['commit_ms']:.1f}, dispatch "
          f"{on['dispatch_ms']:.1f} vs {off['dispatch_ms']:.1f}, total "
          f"{on['total_ms']:.1f} vs {off['total_ms']:.1f}; the recorder's "
          f"own time in the cycle {on['jobtrace_cycle_ms']:.1f} ms; recorder "
          f"{json.dumps(on['jobtrace'])}; introspection self time "
          f"{on['introspect_self_ms']:.3f} ms "
          f"({on['introspect_share']:.2e} of the cycle)", flush=True)
    rep["job_trace_cost"] = {"on": on, "off": off}
    return rep, launches, twin


def phase_native(twin):
    """The JAX package's solver names on the disjoint cell's cold cycle:
    ``solver="native"`` and ``"auto"`` (which takes the native solver
    here) against the ``"cuda"`` twin of phase_obs, from the same seed:
    started jobs, nodes, reasons and ledger equal."""
    from cranesched_tpu_torch.ctld import SchedulerConfig
    from cranesched_tpu_torch.models import gpu_solver as g
    from cranesched_tpu_torch.utils import native

    # built in phase 2 (no cycle pays the g++ build)
    check(native.available(), "the native library did not build")
    out = {}
    for solver in ("native", "auto"):
        label = f"native solver={solver}"
        rng = np.random.default_rng(1)
        gc.collect()
        sched, sim, submit = build_cell(
            rng, False, SchedulerConfig(backfill=False, solver=solver))
        submit(N_JOBS, 0.0)
        gc.collect()
        g.greedy_place.launches = 0
        started, last = cycle_once(sched, 100.0, label)
        check(g.greedy_place.launches == 0,
              f"{label}: the kernel launched {g.greedy_place.launches} "
              "times")
        check(last["solver"] == "native", f"{label}: {last['solver']}")
        check(sched.cycle_trace.snapshot()[-1]["recompiles"] == 0,
              f"{label}: the cycle paid a build")
        same_outcome(f"{label} vs cuda", cycle_outcome(sched, started),
                     twin)
        out[solver] = {"solve_ms": last["solve_ms"],
                       "total_ms": last["total_ms"], "placed": len(started)}
        del sched, sim, submit
    print(f"[native] native / auto / cuda equal on {len(twin[0])} starts; "
          f"solve_ms {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# 12. the controller daemon over gRPC
# ---------------------------------------------------------------------------

WIRE_CHUNK = 1_000          # specs per SubmitBatchJobs
DAEMON_TOPUP = 10_000       # the warm tick's top-up
# leg (b)'s backlog, cut from 100,000 for the run's time limit (PERF.md
# §4): above the ~60,000 jobs the cluster holds, so its cycles still
# saturate it and then place nothing
DAEMON_JOBS = 75_000
CANCEL_PENDING, CANCEL_RUNNING = 1_000, 100
QUERY_REPS = 30             # queries per kind at rest
PAGES_WALKED = 3            # QueryJobsInfo pages walked from the start
QUERY_PAUSE_S = 0.05        # the warm tick's client: pause between pairs
# the daemon's client polls as ``watch cqueue`` does, every 2 s.  Its
# queries' Python shares the daemon's GIL with the cycle thread, whose
# backfill head hands the GIL over at each of its ~100 launches a job:
# at QUERY_PAUSE_S the head took 5-32x its time in process on an H100,
# which ``phase_daemon(poll_s=QUERY_PAUSE_S)`` measures (PERF.md)
POLL_S = 2.0
DAEMON_WAIT_S = 300.0       # the longest any one wait of leg (b) may take


def draw_specs(rng, k):
    """``k`` wire job specs drawn as ``build_cell``'s ``submit`` draws
    them on four disjoint partitions (the same draws in the same order,
    so after ``build_cell`` with phase 6's seed they are phase 6's
    jobs)."""
    from cranesched_tpu_torch.rpc import crane_pb2 as pb

    out = []
    for _ in range(k):
        part = f"p{rng.integers(0, 4)}"
        tl = int(rng.integers(60, 86400))
        cpu = float(rng.integers(1, 17))
        mem = int(rng.integers(1, 33)) << 30
        out.append(pb.JobSpec(
            res=pb.ResourceSpec(cpu=cpu, mem_bytes=mem),
            node_num=int(rng.integers(1, 3)), time_limit=tl, partition=part,
            sim_runtime=float(rng.integers(30, 1800))))
    return out


def wire_submit(client, specs):
    """Submit over the wire in chunks of ``WIRE_CHUNK``; returns (job
    ids, seconds)."""
    t0 = time.perf_counter()
    ids = []
    for lo in range(0, len(specs), WIRE_CHUNK):
        reply = client.submit_many(specs[lo:lo + WIRE_CHUNK])
        ids += [r.job_id for r in reply.replies]
    dt = time.perf_counter() - t0
    check(all(ids) and len(set(ids)) == len(ids),
          f"wire submit: {sum(1 for i in ids if not i)} rejected")
    return ids, dt


def percentiles(xs):
    a = np.sort(np.asarray(xs) * 1e3)
    return {"n": len(a), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99)), "max_ms": float(a[-1])}


def start_querier(addr, lat, stop, pause):
    """A started thread that sends a 1,000-job ``QueryJobsInfo`` page and
    a ``QueryClusterInfo`` to ``addr``, ``pause`` seconds apart, until
    ``stop`` is set, appending each call's seconds to ``lat``."""
    import threading

    from cranesched_tpu_torch.rpc import CtldClient

    def loop():
        qc = CtldClient(addr, timeout=600.0)
        try:
            while not stop.is_set():
                t1 = time.perf_counter()
                qc.query_jobs(limit=1000)
                lat["jobs"].append(time.perf_counter() - t1)
                t1 = time.perf_counter()
                qc.query_cluster()
                lat["cluster"].append(time.perf_counter() - t1)
                stop.wait(pause)
        finally:
            qc.close()

    thread = threading.Thread(target=loop)
    thread.start()
    return thread


def job_records(reply_jobs):
    return [j.SerializeToString(deterministic=True) for j in reply_jobs]


def same_service_state(label, sched, twin, client=None, twin_srv=None):
    """The server's scheduler against its in-process twin: nodes of every
    running job, the reason of every pending one, the ledger, and with
    ``client`` every job record the wire streams against the twin's
    handler's reply; returns the number of records compared."""
    from cranesched_tpu_torch.rpc import crane_pb2 as pb

    check(sorted(sched.running) == sorted(twin.running),
          f"{label}: running sets differ")
    check(all(sched.running[j].node_ids == twin.running[j].node_ids
              for j in twin.running), f"{label}: nodes differ")
    check(sorted(sched.pending) == sorted(twin.pending),
          f"{label}: pending sets differ")
    check(all(sched.pending[j].pending_reason
              == twin.pending[j].pending_reason for j in twin.pending),
          f"{label}: pending reasons differ")
    ids = sorted(sched.meta.nodes)
    check(np.array_equal(np.stack([sched.meta.nodes[i].avail for i in ids]),
                         np.stack([twin.meta.nodes[i].avail for i in ids])),
          f"{label}: ledgers differ")
    check_ledger(sched, label, resident=False)
    check_ledger(twin, label + " twin", resident=False)
    if client is None:
        return 0
    # the stream over the wire against the twin's handler, every job
    req = pb.QueryJobsRequest(include_history=True)
    wire = [r for reply in client._stub.call_stream(
        "QueryJobsStream", req, pb.QueryJobsReply) for r in reply.jobs]
    mine = [r for reply in twin_srv.QueryJobsStream(req, None)
            for r in reply.jobs]
    check(len(wire) == len(mine) and job_records(wire) == job_records(mine),
          f"{label}: the streamed job records differ from the twin's")
    return len(wire)


def phase_service():
    """Leg (a): ``serve`` in tick mode on the card against an in-process
    twin fed the same specs at the same ``now``s."""
    import threading

    from cranesched_tpu_torch.ctld import SchedulerConfig
    from cranesched_tpu_torch.models import gpu_solver as g
    from cranesched_tpu_torch.rpc import CtldClient, crane_pb2 as pb, serve
    from cranesched_tpu_torch.rpc.convert import spec_from_pb
    from cranesched_tpu_torch.rpc.server import CtldServer

    label = "service"
    gc.collect()
    rng = np.random.default_rng(2)
    t0 = time.perf_counter()
    sched, sim, _ = build_cell(rng, False, SchedulerConfig())
    specs = draw_specs(rng, N_JOBS)
    topup = draw_specs(rng, DAEMON_TOPUP)
    twin, tsim, _ = build_cell(np.random.default_rng(2), False,
                               SchedulerConfig())
    twin_srv = CtldServer(twin, sim=tsim, tick_mode=True)  # not started
    server, port = serve(sched, sim=sim, tick_mode=True)
    addr = f"127.0.0.1:{port}"
    client = CtldClient(addr, timeout=600.0)
    out = {"setup_s": time.perf_counter() - t0}
    try:
        # 100,000 submits over the wire; the twin takes the same specs
        ids, dt = wire_submit(client, specs)
        out["submit"] = {"jobs": len(ids), "seconds": dt,
                         "jobs_per_s": len(ids) / dt,
                         "chunk": WIRE_CHUNK}
        twin_ids = [twin.submit(spec_from_pb(s), now=tsim.now)
                    for s in specs]
        check(ids == twin_ids, f"{label}: job ids differ from the twin's")
        print(f"[{label}] {len(ids)} submits over the wire in {dt:.2f}s "
              f"({len(ids) / dt:.0f} jobs/s, {WIRE_CHUNK} a call); "
              f"{time.perf_counter() - t0:.1f}s into the leg (setup "
              f"{out['setup_s']:.1f}s)", flush=True)

        # the query plane at 100,000 pending, at rest
        rest = {"jobs": [], "cluster": []}
        for _ in range(QUERY_REPS):
            t1 = time.perf_counter()
            page = client.query_jobs(limit=1000)
            rest["jobs"].append(time.perf_counter() - t1)
            t1 = time.perf_counter()
            nodes = client.query_cluster().nodes
            rest["cluster"].append(time.perf_counter() - t1)
        check(len(page.jobs) == 1000 and page.truncated,
              f"{label}: a page of QueryJobsInfo")
        check(len(nodes) == N_NODES, f"{label}: QueryClusterInfo")
        out["query_at_rest"] = {k: percentiles(v) for k, v in rest.items()}

        # record the cold tick's tail solve for the plain check
        record = {}
        solve = sched._immediate_solve

        def spy(avail, total, alive, cost, batch, max_nodes,
                resident_ok=False):
            # the inputs before the solve (it updates the state in place)
            first = "tail_in" not in record
            if first:
                record["tail_in"] = (
                    avail.cpu().clone(), total.copy(), alive.copy(),
                    cost.cpu().clone(), host(batch.req, batch.node_num,
                                             batch.time_limit, batch.valid),
                    batch.job_class_np.copy(), batch.class_rows_np.copy(),
                    max_nodes)
            res = solve(avail, total, alive, cost, batch, max_nodes,
                        resident_ok=resident_ok)
            if first:
                record["tail_out"] = host(res[0].placed, res[0].nodes,
                                          res[0].reason)
            return res

        sched._immediate_solve = spy
        ticks = []
        launches = 0
        lat = {"jobs": [], "cluster": []}
        for k, now in enumerate((100.0, 1000.0)):
            if k:
                # 900 s of completions come with the tick; the top-up
                # goes in first, at the server's clock
                more, _ = wire_submit(client, topup)
                check(more == [twin.submit(spec_from_pb(s), now=tsim.now)
                               for s in topup],
                      f"{label}: top-up ids differ")
            stop = threading.Event()
            querier = None
            if k:
                querier = start_querier(addr, lat, stop, QUERY_PAUSE_S)
            # the main path's launch count: zeroed just before the tick,
            # read just after (the twin's own cycle is not counted)
            g.greedy_place.launches = 0
            t1 = time.perf_counter()
            reply = client.tick(now)
            wall = time.perf_counter() - t1
            n = g.greedy_place.launches
            stop.set()
            if querier is not None:
                querier.join(timeout=DAEMON_WAIT_S)
                check(not querier.is_alive(), f"{label}: querier hung")
            launches += n
            trace = sched.cycle_trace.snapshot()[-1]
            check(n == 1, f"{label} tick {k}: greedy_place launched {n} "
                          "times (want once, the split cycle's tail)")
            check(trace["solver"] == "backfill-split",
                  f"{label} tick {k}: solver {trace['solver']}")
            tsim.advance_to(now)
            started = twin.schedule_cycle(now=now)
            check(list(reply.started) == started,
                  f"{label} tick {k}: started set differs from the twin's")
            check(len(started) > 0, f"{label} tick {k}: placed nothing")
            # the decisions by sets, nodes, reasons and ledger; every job
            # record is compared after the cancels
            same_service_state(f"{label} tick {k}", sched, twin)
            row = {"tick": k, "now": now, "placed": len(started),
                   "launches": n, "rpc_wall_ms": wall * 1e3,
                   "total_ms": trace["total_ms"],
                   "dispatch_ms": trace["dispatch_ms"],
                   "solve_ms": trace["solve_ms"],
                   "solve_head_ms": trace["solve_head_ms"],
                   "lock_held_ms": trace["lock_held_ms"],
                   "lock_held_share": trace["lock_held_ms"]
                   / trace["total_ms"],
                   # the RPC, and in the warm tick sim.advance_to's
                   # completions, beyond the cycle and its dispatch
                   "rpc_overhead_ms": wall * 1e3 - trace["total_ms"]
                   - trace["dispatch_ms"],
                   "pending_after": len(sched.pending)}
            ticks.append(row)
            print(f"[{label}] tick {k} at now={now}: placed {len(started)}"
                  f", rpc {wall * 1e3:.1f}ms vs cycle total "
                  f"{trace['total_ms']:.1f}ms + dispatch "
                  f"{trace['dispatch_ms']:.1f}ms (solve "
                  f"{trace['solve_ms']:.1f}"
                  f"ms, lock held {trace['lock_held_ms']:.1f}ms), launches "
                  f"{n}; == twin (started, nodes, reasons, ledger); "
                  f"{time.perf_counter() - t0:.1f}s into the leg",
                  flush=True)
            if not k:
                sched._immediate_solve = solve
                cpu_check(f"{label} cold tick tail", plain_check,
                          record["tail_out"], *record["tail_in"])
        out["ticks"] = ticks
        out["query_during_warm_tick"] = {k: percentiles(v)
                                         for k, v in lat.items()}

        # the query surface against the twin's handlers
        # QueryJobsInfo paged by its cursor: the first pages, then the
        # last two (truncated, then not), each reply against the twin's
        # (the stream below compares every record)
        live = sorted(set(twin.pending) | set(twin.running))
        cursors = [0]
        for k in range(PAGES_WALKED):
            page = client.query_jobs(limit=1000, after_job_id=cursors[-1])
            cursors.append(page.jobs[-1].job_id)
        cursors = cursors[:-1] + [live[-1500], live[-500]]
        truncated = []
        for cursor in cursors:
            req = pb.QueryJobsRequest(limit=1000, after_job_id=cursor)
            reply = client._call("QueryJobsInfo", req, pb.QueryJobsReply)
            check(reply.SerializeToString(deterministic=True)
                  == twin_srv.QueryJobsInfo(req, None)
                  .SerializeToString(deterministic=True),
                  f"{label}: QueryJobsInfo after job {cursor} differs "
                  "from the twin's")
            truncated.append(reply.truncated)
        check(truncated[-2:] == [True, False],
              f"{label}: the last pages' truncated flags {truncated[-2:]}")
        jid = live[-1]
        check(client.query_cluster().SerializeToString(deterministic=True)
              == twin_srv.QueryClusterInfo(pb.QueryClusterRequest(), None)
              .SerializeToString(deterministic=True),
              f"{label}: QueryClusterInfo differs from the twin's")
        summary = client.query_job_summary()
        check(summary.SerializeToString(deterministic=True)
              == twin_srv.QueryJobSummary(pb.QueryJobSummaryRequest(),
                                          None)
              .SerializeToString(deterministic=True),
              f"{label}: QueryJobSummary differs from the twin's")
        explain = json.loads(client.query_job_summary(job_id=jid)
                             .explain_json)
        check(explain["job_id"] == jid, f"{label}: explain_json")
        ev = [(e.seq, e.type, e.severity, e.node, e.job_id, e.detail)
              for e in client.query_events().events]
        ev_twin = [(e["seq"], e["type"], e["severity"], e["node"],
                    e["job_id"], e["detail"]) for e in twin.events.since()]
        check(ev == ev_twin, f"{label}: QueryEvents differs from the twin")
        stats = json.loads(client.query_stats().json)
        for key in ("cycles", "jobs_started_total", "jobs_submitted_total",
                    "jobs_finished_total"):
            check(stats[key] == twin.stats[key], f"{label}: stats {key}")
        out["pages_compared"] = len(cursors)

        # cancels over the wire: 1,000 pending and 100 running jobs
        pend = sorted(twin.pending)[::max(1, len(twin.pending)
                                          // CANCEL_PENDING)]
        run = sorted(twin.running)[::max(1, len(twin.running)
                                         // CANCEL_RUNNING)]
        victims = pend[:CANCEL_PENDING] + run[:CANCEL_RUNNING]
        t1 = time.perf_counter()
        oks = [client.cancel(j).ok for j in victims]
        dt = time.perf_counter() - t1
        check(all(oks), f"{label}: a cancel was refused")
        check([twin.cancel(j, now=tsim.now) for j in victims] == oks,
              f"{label}: cancel replies differ from the twin's")
        rows = same_service_state(f"{label} cancels", sched, twin,
                                  client, twin_srv)
        out["cancel"] = {"jobs": len(victims), "seconds": dt,
                         "per_call_ms": dt * 1e3 / len(victims)}
        out["launches"] = launches
        # 17 (c): the crane commands against this server
        out["cli"] = cli_vs_twin("cli", addr, twin, twin_srv)
        print(f"[{label}] {len(cursors)} QueryJobsInfo pages, stream, "
              f"cluster, summary, events and stats == twin; {len(victims)} "
              f"cancels over the wire in {dt:.2f}s; == twin on {rows} job "
              f"records; {time.perf_counter() - t0:.1f}s in the leg; queries "
              f"at rest "
              f"{json.dumps(out['query_at_rest'])}, during the warm tick "
              f"{json.dumps(out['query_during_warm_tick'])}", flush=True)
    finally:
        client.close()
        server.stop()
    del sched, sim, twin, tsim, twin_srv, server
    gc.collect()
    import torch

    torch.cuda.empty_cache()
    return out, launches


def daemon_config(path, tmp, extra_nodes=(), extra_yaml=()):
    """The north-star cluster as a YAML config: phase 6's nodes (the same
    seed), four disjoint partitions, a WAL and an archive under ``tmp``,
    and no ``Scheduler:`` block: the defaults a site's config starts
    from (``Solver: auto``, which on the card is the greedy kernel).
    ``extra_nodes``: (name, cpu, memory bytes, partition) appended after
    them, their partitions too; ``extra_yaml``: lines appended as they
    are.
    Returns the generator and the configured nodes as such tuples."""
    rng = np.random.default_rng(2)
    # build_cell's node draws (disjoint partitions), without its scheduler
    rows = []
    for i in range(N_NODES):
        cpu = int(rng.integers(32, 129))
        mem = int(rng.integers(64, 513)) << 30
        rows.append((f"b{i:05d}", cpu, mem, f"p{i % 4}"))
    lines = ["ClusterName: smoke", "Listen: 127.0.0.1:0",
             f"Wal: {tmp}/wal/ctld.wal", f"Archive: {tmp}/archive.db",
             "Nodes:"]
    for name, cpu, mem, part in rows + list(extra_nodes):
        lines.append(f"  - {{name: {name}, cpu: {cpu}, memory: {mem}, "
                     f"partitions: [{part}]}}")
    parts = [f"p{i}" for i in range(4)]
    parts += sorted({part for *_, part in extra_nodes} - set(parts))
    lines += ["Partitions:"] + [f"  - name: {p}" for p in parts]
    lines += list(extra_yaml)
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    # rng is positioned after the node draws, as in phase 6
    return rng, rows


class DaemonProc:
    """``python3 -m cranesched_tpu_torch.ctld_main`` with its output in
    files; killed by PID if still alive at the end."""

    def __init__(self, tmp, tag, cfg, args=("--sim",),
                 listen="127.0.0.1:0"):
        import os
        import subprocess

        self.out = os.path.join(tmp, f"{tag}.out")
        self.err = os.path.join(tmp, f"{tag}.err")
        self.t0 = time.perf_counter()
        # no --device on the card: the daemon's default is the card
        device = () if DEVICE == "cuda" else ("--device", DEVICE)
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "cranesched_tpu_torch.ctld_main",
                 "-c", cfg, *args, "--listen", listen, *device],
                stdout=out, stderr=err)

    def text(self, which="out"):
        with open(self.out if which == "out" else self.err) as fh:
            return fh.read()

    def banner(self):
        """(port, seconds from start to the banner); the banner must name
        the card as the scheduler's device."""
        import re

        deadline = time.time() + DAEMON_WAIT_S
        while time.time() < deadline:
            lines = self.text().splitlines()
            if lines:
                m = re.search(r"listening on port (\d+)", lines[0])
                check(m is not None and f"device {DEVICE}" in lines[0],
                      f"first stdout line: {lines[0]!r}")
                return int(m.group(1)), time.perf_counter() - self.t0
            check(self.proc.poll() is None,
                  f"daemon exited {self.proc.returncode}: "
                  f"{self.text('err')[-2000:]}")
            time.sleep(0.05)
        raise RuntimeError("chip_smoke check failed: no daemon banner")

    def stop(self):
        """SIGTERM; checks the exit code is 0 and returns the seconds
        the daemon took to exit."""
        import signal

        t0 = time.perf_counter()
        self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=DAEMON_WAIT_S)
        check(rc == 0, f"daemon exited {rc} on SIGTERM: "
                       f"{self.text('err')[-2000:]}")
        return time.perf_counter() - t0

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def stream_states(client):
    from cranesched_tpu_torch.rpc import crane_pb2 as pb

    req = pb.QueryJobsRequest(include_history=True)
    return {j.job_id: (j.status, tuple(j.node_names))
            for reply in client._stub.call_stream("QueryJobsStream", req,
                                                  pb.QueryJobsReply)
            for j in reply.jobs}


def phase_daemon(poll_s=POLL_S):
    """Leg (b): the daemon on the card (no ``--device``), ``DAEMON_JOBS``
    specs over the wire with a second client querying every ``poll_s``
    seconds, SIGTERM, a restart from the WAL, and the held lease."""
    import tempfile
    import threading

    from cranesched_tpu_torch.rpc import CtldClient

    label = "daemon"
    tmp = tempfile.mkdtemp(prefix="crane-daemon-")
    cfg = f"{tmp}/ctld.yaml"
    rng, _ = daemon_config(cfg, tmp)
    gc.collect()
    out = {"poll_s": poll_s}
    procs = []
    try:
        first = DaemonProc(tmp, "first", cfg)
        procs.append(first)
        # phase 6's jobs (drawn while the daemon boots), made to stay as
        # they are once placed (no job ends or times out while the phase
        # runs), so the state before the stop is the state a restart
        # must show
        specs = draw_specs(rng, DAEMON_JOBS)
        for s in specs:
            s.time_limit, s.sim_runtime = 86400, 1e6
        port, out["boot_to_banner_s"] = first.banner()
        t_banner = time.time()
        # a second leader on the same WAL, started now, must be refused
        # while the first runs (it boots beside the submits)
        second = DaemonProc(tmp, "second", cfg)
        procs.append(second)
        # a second client polls from the banner until the cycles settle:
        # the real-time loop releases the lock for each solve, so these
        # wait for the submits' chunks and the cycles' state phases only
        lat = {"jobs": [], "cluster": []}
        stop = threading.Event()
        querier = start_querier(f"127.0.0.1:{port}", lat, stop, poll_s)
        client = CtldClient(f"127.0.0.1:{port}", timeout=600.0)
        try:
            ids, dt = wire_submit(client, specs)
            out["submit"] = {"jobs": len(ids), "seconds": dt,
                             "jobs_per_s": len(ids) / dt}
            print(f"[{label}] boot to banner {out['boot_to_banner_s']:.1f}s"
                  f"; {len(ids)} submits in {dt:.1f}s", flush=True)

            # two cycles with starts, then one that places nothing
            deadline = time.time() + DAEMON_WAIT_S

            def rows():
                return json.loads(client.query_stats().json)["cycle_trace"]

            while True:
                trace = [r for r in rows() if r.get("solver") != "skip"]
                placing = [r for r in trace if r.get("placed", 0) > 0]
                if len(placing) >= 2 and trace[-1].get("placed", 0) == 0:
                    break
                check(time.time() < deadline,
                      f"{label}: no settled state in {DAEMON_WAIT_S:.0f}s "
                      f"({len(placing)} placing cycles)")
                time.sleep(1.0)
        finally:
            stop.set()
            querier.join(timeout=DAEMON_WAIT_S)
        check(not querier.is_alive(), f"{label}: querier hung")
        rc = second.proc.wait(timeout=DAEMON_WAIT_S)
        check(rc != 0 and "holds the lease" in second.text("err"),
              f"{label}: a second daemon on the held WAL exited {rc}")
        out["query_during_cycles"] = {k: percentiles(v)
                                      for k, v in lat.items()}
        print(f"[{label}] settled {time.time() - t_banner:.1f}s after the "
              f"banner; queries during the cycles "
              f"{json.dumps(out['query_during_cycles'])}", flush=True)
        stats = json.loads(client.query_stats().json)
        trace = [r for r in stats["cycle_trace"] if r.get("solver") != "skip"]
        out["first_cycle_s"] = (placing[0]["now"] - t_banner
                                + placing[0]["total_ms"] / 1e3)
        out["cycles"] = [{k: r.get(k) for k in (
            "now", "solver", "device", "kernel_launches", "candidates",
            "placed", "total_ms", "solve_ms", "solve_head_ms",
            "solve_tail_ms", "lock_held_ms", "wal_fsyncs")} for r in trace]
        # on the card, through greedy_place: the daemon's count started
        # at 0 with its process, and each row holds its cycle's launches.
        # A split cycle places its tail with one launch, an immediate
        # cycle its batch; a cycle under the lookahead bound has no tail
        check(all(r["device"] == "cuda" for r in trace),
              f"{label}: cycle devices {[r['device'] for r in trace]}")
        want = {"backfill-split": 1, "cuda-stream": 1, "cuda": 1,
                "backfill": 0}
        check(all(r["solver"] in want and r["kernel_launches"]
                  == want[r["solver"]] for r in trace),
              f"{label}: cycle solvers and launches "
              f"{[(r['solver'], r['kernel_launches']) for r in trace]}")
        out["launches"] = sum(r["kernel_launches"] for r in trace)
        check(any(r["kernel_launches"] and r["placed"] for r in trace),
              f"{label}: greedy_place placed nothing in the daemon")
        before = stream_states(client)
        check(set(ids) <= set(before), f"{label}: acked jobs missing")
        running = sum(1 for s, _ in before.values() if s == "Running")
        client.close()
        out["stop_s"] = first.stop()
        print(f"[{label}] cycles {json.dumps(out['cycles'])}; SIGTERM -> 0 "
              f"in {out['stop_s']:.1f}s", flush=True)

        third = DaemonProc(tmp, "restart", cfg)
        procs.append(third)
        port, out["restart_to_banner_s"] = third.banner()
        client = CtldClient(f"127.0.0.1:{port}", timeout=600.0)
        after = stream_states(client)
        client.close()
        lost = [j for j in ids if after.get(j) != before[j]]
        check(not lost, f"{label}: {len(lost)} acked jobs changed over the "
                        f"restart, e.g. {lost[:5]}")
        err = third.text("err")
        check(f"recovered {len(before)} jobs" in err,
              f"{label}: recovery line: {err[-500:]}")
        out["restart_stop_s"] = third.stop()
        out.update(jobs=len(ids), running=running,
                   pending=len(ids) - running,
                   recovery_line=[ln for ln in err.splitlines()
                                  if ln.startswith("recovered")][0])
        print(f"[{label}] boot to banner {out['boot_to_banner_s']:.1f}s, "
              f"{len(ids)} submits at {out['submit']['jobs_per_s']:.0f} "
              f"jobs/s, first cycle done {out['first_cycle_s']:.1f}s after"
              f" the banner; held lease refused; restart to banner "
              f"{out['restart_to_banner_s']:.1f}s with every one of "
              f"{len(ids)} acked jobs as before ({running} running); "
              f"SIGTERM -> 0 in {out['restart_stop_s']:.1f}s", flush=True)
    finally:
        for p in procs:
            p.kill()
    return out


def head_stretch(daemon, base):
    """The daemon's split solves' heads (1,024 jobs each) over the same
    head in process, ``base`` ms (a tick holds the lock, so its querier
    waits instead of sharing the GIL with the solve)."""
    daemon["head_stretch"] = [
        r["solve_head_ms"] / base for r in daemon["cycles"]
        if r["solver"] == "backfill-split"]
    print(f"[daemon] polled every {daemon['poll_s']}s: split solves' heads "
          f"over the warm tick's ({base:.1f} ms in process): "
          f"{[round(x, 2) for x in daemon['head_stretch']]}", flush=True)


# ---------------- 14. the real node plane ----------------

# real craned_main processes, a quarter per partition.  The card's
# host (8 cores) does not carry 32 beside a 10,002-node ctld: each wave
# of ~200 steps spawns ~200 Python supervisors (1.8 s each on average)
# while the ctld's backfill head, which hands the GIL over ~100 times a
# job, stretched to 53 s on an H100 host (PERF.md §6)
NP_CRANEDS = 16
# the backlog of real scripts, cut from N_JOBS for the run's time limit
# (PERF.md §4): still far more than the 18 alive nodes run in the window,
# so every cycle is a split one with the kernel's tail
NP_JOBS = N_JOBS * 3 // 20
NP_RUN_S = 30.0            # real-time cycles once the craneds registered
NP_CANCEL = 10             # running jobs cancelled
NP_PING_S = 2.0            # the craneds' ping interval
NP_CRANED_TIMEOUT_S = 10   # the ctld's CranedTimeoutSec
NP_FAIL_SHARE = 0.02       # jobs whose script ends with ``exit 3``
NP_SAMPLES = 2             # oversubscription samples in the run
NP_TRACE_JOBS = 50         # completed jobs whose node-side spans are read
NP_TRACE_THREADS = 8       # their QueryJobSummary calls in flight at once
NP_WAIT_S = 180.0          # the longest any one wait of the phase may take
# a poll of the node states (QueryClusterInfo: 10,002 nodes) costs the
# ctld ~0.1 s of Python under its lock: polled faster it starves the
# cycle it waits for
NP_POLL_S = 1.0


def host_cgroup(root="/sys/fs/cgroup"):
    """The host's cgroup flavour as ``craned.cgroup.make_cgroups`` would
    find it, read without building a backend (which would create
    ``crane`` directories on a writable host): v2 when ``cgroup.controllers``
    is at the top, else v1 when the cpu or memory hierarchy is writable;
    a host with neither gets the disabled v2 backend.  The craneds here
    run with cgroups off (``CranedProc``)."""
    import os

    def writable(path):
        return os.path.isdir(path) and os.access(path, os.W_OK)

    if os.path.isfile(os.path.join(root, "cgroup.controllers")):
        return {"version": 2, "enabled": writable(root),
                "class": "CgroupV2"}
    v1 = [c for c in ("cpu", "memory", "freezer", "cpuset", "devices")
          if writable(os.path.join(root, c))]
    if "cpu" in v1 or "memory" in v1:
        return {"version": 1, "enabled": True, "class": "CgroupV1",
                "writable_controllers": v1}
    return {"version": 2, "enabled": False, "class": "CgroupV2"}


def resolvable_names():
    """Two distinct host names that resolve to an IPv4 address of this
    host: a gang's rendezvous address is '<rank-0 node name>:<port>',
    served by the rank-0 supervisor on 0.0.0.0."""
    import socket

    names = []
    for name in ("localhost", socket.gethostname(), "runsc", "vm"):
        try:
            socket.gethostbyname(name)
        except OSError:
            continue
        if name and name not in names:
            names.append(name)
    check(len(names) >= 2, f"two resolvable host names: {names}")
    return names[:2]


class CranedProc:
    """``python3 -m cranesched_tpu_torch.craned_main`` for one configured
    node, its output in files; ``start`` again restarts it."""

    def __init__(self, tmp, name, port, cpu, mem, part):
        import os

        workdir = os.path.join(tmp, "w", name)
        os.makedirs(workdir, exist_ok=True)
        self.tmp, self.name, self.runs = tmp, name, 0
        # the craneds of one host would share the host's cgroup tree,
        # and one job's cgroup (crane/job_<id>) with it: the first member
        # of a gang to end would tear the other's down.  Each runs with
        # a cgroup root that does not exist, so cgroups are off
        self.argv = [sys.executable, "-m", "cranesched_tpu_torch.craned_main",
                     "--name", name, "--ctld", f"127.0.0.1:{port}",
                     "--cpu", str(cpu), "--memory", str(mem),
                     "--partitions", part, "--workdir", workdir,
                     "--ping-interval", str(NP_PING_S),
                     "--cgroup-root", os.path.join(workdir, "no-cgroup"),
                     "--metrics-port", "0"]
        self.start()

    def start(self):
        import subprocess

        self.runs += 1
        tag = f"{self.tmp}/craned-{self.name}-{self.runs}"
        self.out, self.err = tag + ".out", tag + ".err"
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(self.argv, stdout=out, stderr=err)

    def text(self, which="out"):
        with open(self.out if which == "out" else self.err) as fh:
            return fh.read()

    def metrics(self) -> str:
        import re
        import urllib.request

        m = re.search(r"metrics: http://[^:]+:(\d+)/metrics", self.text())
        check(m is not None, f"craned {self.name}: no metrics line")
        return urllib.request.urlopen(
            f"http://127.0.0.1:{m.group(1)}/metrics",
            timeout=30).read().decode()

    def term(self):
        import signal

        self.proc.send_signal(signal.SIGTERM)

    def wait(self) -> int:
        return self.proc.wait(timeout=NP_WAIT_S)

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def spawn_histogram(texts):
    """``crane_supervisor_spawn_seconds`` summed over the craneds'
    /metrics: count, mean, and the bucket bounds holding p50 and p99."""
    import math

    buckets, total, count = {}, 0.0, 0
    for text in texts:
        for line in text.splitlines():
            name, _, value = line.rpartition(" ")
            if name.startswith("crane_supervisor_spawn_seconds_bucket"):
                le = name.split('le="')[1].split('"')[0]
                buckets[le] = buckets.get(le, 0) + float(value)
            elif name.startswith("crane_supervisor_spawn_seconds_sum"):
                total += float(value)
            elif name.startswith("crane_supervisor_spawn_seconds_count"):
                count += int(float(value))
    check(count > 0, "no supervisor spawn was measured")
    bounds = sorted((math.inf if k == "+Inf" else float(k), v)
                    for k, v in buckets.items())

    def quantile(q):
        return next(b for b, c in bounds if c >= q * count)

    return {"count": count, "mean_s": total / count,
            "p50_le_s": quantile(0.5), "p99_le_s": quantile(0.99)}


def stream_jobs(client):
    """Every job (history too) as ``JobInfo`` by id."""
    from cranesched_tpu_torch.rpc import crane_pb2 as pb

    req = pb.QueryJobsRequest(include_history=True)
    return {j.job_id: j
            for reply in client._stub.call_stream("QueryJobsStream", req,
                                                  pb.QueryJobsReply)
            for j in reply.jobs}


def wait_until(pred, what, timeout=NP_WAIT_S, pause=0.2):
    """Wait for ``pred``; ``what`` (a string, or a function giving one
    at the deadline) names it in the failure."""
    deadline = time.time() + timeout
    while not pred():
        if time.time() >= deadline:
            check(False, f"node-plane: {what() if callable(what) else what}"
                         f" within {timeout:.0f}s")
        time.sleep(pause)


def node_plane_specs(rng, tmp):
    """Phase 12's draws as real scripts: each echoes its job id, node
    and shell PID to its output file and sleeps 1-8 s; ``NP_FAIL_SHARE``
    of them then ``exit 3``."""
    specs = draw_specs(rng, NP_JOBS)
    sleeps = rng.integers(1, 9, NP_JOBS)
    fails = rng.random(NP_JOBS) < NP_FAIL_SHARE
    for i, s in enumerate(specs):
        s.script = (f"echo $CRANE_JOB_ID $CRANE_NODE_NAME $$\n"
                    f"sleep {sleeps[i]}\n" + ("exit 3\n" if fails[i] else ""))
        s.output_path = f"{tmp}/out/%j.out"
    return specs, fails


def _cmdline(pid) -> bytes:
    """``pid``'s command line, or b'' once it has exited."""
    try:
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            return fh.read()
    except OSError:
        return b""


def _proc_tagged(pid, tag) -> bool:
    """Is ``pid`` a live process whose command line holds ``tag``?"""
    return tag.encode() in _cmdline(pid)


def _output_lines(tmp, jid):
    import os

    path = f"{tmp}/out/{jid}.out"
    if not os.path.exists(path):
        return []
    with open(path) as fh:
        return [ln.split() for ln in fh.read().splitlines() if ln.strip()]


def phase_node_plane(base_head_ms):
    """Phase 14: ``ctld_main`` on the card with no ``--sim``, 10,002
    configured nodes, ``NP_CRANEDS`` real ``craned_main`` processes (and
    two more for a gang under names that resolve here), 100,000 real
    scripts; cancels, a craned's SIGKILL and restart, a ``coord fence``
    gang, SIGTERM.  Returns the report and greedy_place's launches in
    the ctld's cycles (its own process, read from its trace rows)."""
    import os
    import tempfile

    from cranesched_tpu_torch.rpc import CtldClient
    from cranesched_tpu_torch.rpc.dispatcher import GrpcDispatcher

    label = "node-plane"
    t_phase, marks = time.time(), {}

    def mark(step):
        """When ``step`` ended, in seconds from the phase's start."""
        marks[step] = time.time() - t_phase

    tmp = tempfile.mkdtemp(prefix="crane-nodes-")
    os.makedirs(f"{tmp}/out")
    gang_names = resolvable_names()
    cfg = f"{tmp}/ctld.yaml"
    gang_nodes = [(n, 8, 16 << 30, "gang") for n in gang_names]
    # the job trace keeps every job's timeline (the default keeps 4,096
    # live ones, and the running jobs' node-side spans are read below)
    rng, rows = daemon_config(
        cfg, tmp, extra_nodes=gang_nodes,
        extra_yaml=["Scheduler:",
                    f"  CranedTimeoutSec: {NP_CRANED_TIMEOUT_S}",
                    "Observability:",
                    f"  JobTraceCapacity: {2 * N_JOBS}"])
    chosen = []
    for p in range(4):
        chosen += [r for r in rows if r[3] == f"p{p}"][:NP_CRANEDS // 4]
    out = {"craneds": len(chosen), "gang_nodes": gang_names,
           "configured_nodes": len(rows) + len(gang_nodes),
           "host_cgroup": host_cgroup(),
           "dispatch_workers": GrpcDispatcher.default_workers(
               len(rows) + len(gang_nodes))}
    ctld, craneds, trace_rows = None, {}, {}
    try:
        ctld = DaemonProc(tmp, "ctld", cfg, args=())
        specs, fails = node_plane_specs(rng, tmp)   # while it boots
        port, out["boot_to_banner_s"] = ctld.banner()
        mark("banner")
        banner = ctld.text().splitlines()[0]
        check("(real node plane," in banner, f"{label}: banner {banner!r}")
        client = CtldClient(f"127.0.0.1:{port}", timeout=600.0)

        def alive():
            return {n.name for n in client.query_cluster().nodes
                    if n.state != "DOWN"}

        def rows_now():
            for r in json.loads(client.query_stats().json)["cycle_trace"]:
                trace_rows[(r["now"], r.get("total_ms"))] = r

        # 1. the backlog first (its submits then share the ctld with its
        # idle cycles only), with the ten jobs to cancel: long sleepers
        # on the gang nodes, where no backlog job may end by itself
        # before the kill lands
        from cranesched_tpu_torch.rpc import crane_pb2 as pb

        ids, dt = wire_submit(client, specs)
        tags = {}
        for k in range(NP_CANCEL):
            jid = client.submit(pb.JobSpec(
                partition="gang", time_limit=3600,
                res=pb.ResourceSpec(cpu=1.0, mem_bytes=1 << 30),
                # the trailing echo keeps bash from exec'ing the sleep,
                # so $$ stays the tagged shell
                script=f"echo $CRANE_JOB_ID $CRANE_NODE_NAME $$ # npc{k}\n"
                       "sleep 600\necho done\n",
                output_path=f"{tmp}/out/%j.out")).job_id
            tags[jid] = f"# npc{k}"
        # and two keepers on the second gang node, whose craned is the
        # one SIGKILLed: the ctld's view of a backlog node lags its
        # craned by up to a cycle, so its "running" jobs may have ended
        keepers = []
        for k in range(2):
            jid = client.submit(pb.JobSpec(
                partition="gang", time_limit=3600,
                include_nodes=[gang_names[1]],
                res=pb.ResourceSpec(cpu=1.0, mem_bytes=1 << 30),
                script=f"echo $CRANE_JOB_ID $CRANE_NODE_NAME $$ # npk{k}\n"
                       "sleep 600\necho done\n",
                output_path=f"{tmp}/out/%j.out")).job_id
            keepers.append(jid)
            tags[jid] = f"# npk{k}"
        victims = sorted(set(tags) - set(keepers))
        mark("submitted")

        # 2. the craneds register; then real-time cycles for NP_RUN_S,
        # sampled NP_SAMPLES times
        t0 = time.perf_counter()
        for name, cpu, mem, part in chosen + gang_nodes:
            craneds[name] = CranedProc(tmp, name, port, cpu, mem, part)
        wait_until(lambda: set(craneds) <= alive(), "every craned registers",
                   pause=0.5)
        out["register_s"] = time.perf_counter() - t0
        t_cycles = time.time()
        mark("registered")
        check(alive() == set(craneds),
              f"{label}: alive nodes other than the craneds")
        print(f"[{label}] {len(ids)} submits in {dt:.1f}s; {len(craneds)} "
              f"craneds registered in {out['register_s']:.1f}s (banner "
              f"{out['boot_to_banner_s']:.1f}s); host cgroup "
              f"{json.dumps(out['host_cgroup'])}; gang nodes {gang_names}",
              flush=True)
        totals = {n.name: (n.cpu_total, n.mem_total)
                  for n in client.query_cluster().nodes}
        res_of = {jid: specs[i].res for i, jid in enumerate(ids)}
        res_of.update((jid, pb.ResourceSpec(cpu=1.0, mem_bytes=1 << 30))
                      for jid in tags)
        spec_of = {jid: i for i, jid in enumerate(ids)}
        out["submit"] = {"jobs": len(ids), "seconds": dt,
                         "jobs_per_s": len(ids) / dt}
        samples = []

        def finished(jobs):
            return [j for j in jobs.values() if j.job_id in spec_of
                    and j.status in ("Completed", "Failed")]

        def sample():
            jobs = stream_jobs(client)
            live = alive()
            use = {}
            for j in jobs.values():
                if j.status != "Running":
                    continue
                res = res_of[j.job_id]
                for n in j.node_names:
                    c, m = use.get(n, (0.0, 0))
                    use[n] = (c + res.cpu, m + res.mem_bytes)
            over = [n for n, (c, m) in use.items() if n in live and (
                c > totals[n][0] + 1e-6 or m > totals[n][1])]
            check(not over, f"{label}: oversubscribed {over[:5]}")
            samples.append({"t": time.time() - t_cycles,
                            "running": sum(1 for j in jobs.values()
                                           if j.status == "Running"),
                            "finished": len(finished(jobs)),
                            "busiest_cpu_share": max(
                                (c / totals[n][0] for n, (c, _) in
                                 use.items()), default=0.0)})
            rows_now()
            return jobs

        for k in range(1, NP_SAMPLES + 1):
            time.sleep(max(0.0, t_cycles + k * NP_RUN_S / NP_SAMPLES
                           - time.time()))
            jobs = sample()
        t_run = time.time()
        mark("window")
        done = finished(jobs)
        check(done, f"{label}: no job finished in {NP_RUN_S:.0f}s")
        out["samples"] = samples
        out["finished"] = len(done)
        # every craned registered at t_cycles: the steps that ended in the
        # window, and the rate between the first sample and the last
        # (past the first cold cycles)
        out["window_s"] = t_run - t_cycles
        out["steps_per_s"] = sum(1 for j in done if j.end_time >= t_cycles
                                 ) / out["window_s"]
        first, last = samples[0], samples[-1]
        out["steps_per_s_after_first_sample"] = (
            (last["finished"] - first["finished"]) / (last["t"] - first["t"]))
        bad_out, bad_exit = [], []
        for j in done:
            want = ("Failed", 3) if fails[spec_of[j.job_id]] else (
                "Completed", 0)
            if (j.status, j.exit_code) != want:
                bad_exit.append((j.job_id, j.status, j.exit_code))
            if j.status == "Completed":
                # one line per node and run: a requeued job's earlier
                # runs come first, the recorded nodes' lines last
                lines = _output_lines(tmp, j.job_id)
                last = lines[len(lines) - len(j.node_names):]
                if (sorted(ln[1] for ln in last) != sorted(j.node_names)
                        or any(ln[0] != str(j.job_id) for ln in lines)
                        or (j.requeue_count == 0
                            and len(lines) != len(j.node_names))):
                    bad_out.append((j.job_id, j.requeue_count,
                                    list(j.node_names), lines))
        check(not bad_exit, f"{label}: exit codes {bad_exit[:5]}")
        check(not bad_out, f"{label}: outputs {bad_out[:3]}")
        out["exit3_jobs"] = sum(1 for j in done if j.status == "Failed")
        out["finished_requeued"] = sum(1 for j in done if j.requeue_count)
        print(f"[{label}] {len(done)} jobs finished, "
              f"{out['steps_per_s']:.2f}/s over the {out['window_s']:.1f}s "
              f"window ({out['steps_per_s_after_first_sample']:.2f}/s after "
              f"its first sample), {out['exit3_jobs']} with exit 3; "
              f"samples {json.dumps(samples)}", flush=True)


        def job_report(jids):
            jobs = {j.job_id: j for j in client.query_jobs(
                job_ids=list(jids), include_history=True).jobs}
            rep = []
            for jid in jids:
                lines = _output_lines(tmp, jid)
                j = jobs.get(jid)
                rep.append((jid, j and j.status, j and j.requeue_count,
                            j and list(j.node_names), lines,
                            _cmdline(int(lines[-1][2])) if lines else b""))
            return rep

        def running_shells(jids, what):
            """Each job's shell PID once every one runs: its output's
            last line (a requeued job appends one per run) names a live
            shell with the job's tag."""
            got = {}

            def ready():
                got.clear()
                for jid in jids:
                    lines = _output_lines(tmp, jid)
                    pid = int(lines[-1][2]) if lines else 0
                    if not _proc_tagged(pid, tags[jid]):
                        return False
                    got[jid] = pid
                return True

            wait_until(ready, lambda: f"{what}: {job_report(jids)}")
            return dict(got)

        # node-downs before the SIGKILL below (a craned whose pings the
        # ctld missed for CranedTimeoutSec; its jobs were requeued)
        def node_downs():
            return [(e.node, round(e.time - t_cycles, 3)) for e in
                    client.query_events(type="node_down").events]

        # 3. cancel the ten sleepers
        victims = running_shells(victims, "the jobs to cancel run")
        for jid in victims:
            check(client.cancel(jid).ok, f"{label}: cancel {jid}")

        def statuses():
            return {j.job_id: j.status for j in client.query_jobs(
                job_ids=list(victims), include_history=True).jobs}

        wait_until(lambda: set(statuses().values()) == {"Cancelled"},
                   lambda: f"the cancels ({statuses()})")
        wait_until(lambda: not any(
            _proc_tagged(pid, tags[jid]) for jid, pid in victims.items()),
            "the cancelled shells exit")
        out["cancelled"] = sorted(victims)
        mark("cancelled")

        # 4. SIGKILL the keepers' craned while they run there
        name = gang_names[1]
        running_shells(keepers, "the keepers run")
        held = {j.job_id: j.requeue_count for j in client.query_jobs(
            job_ids=keepers).jobs}
        out["node_downs_before_kill"] = node_downs()
        t_kill = time.time()
        craneds[name].proc.kill()
        craneds[name].proc.wait(timeout=60)

        def down():
            return any(n.name == name and n.state == "DOWN"
                       for n in client.query_cluster().nodes)

        wait_until(down, f"node {name} down", pause=NP_POLL_S)
        out["kill_to_down_s"] = time.time() - t_kill
        mark("killed_node_down")
        jobs = {j.job_id: j for j in client.query_jobs(
            job_ids=keepers, include_history=True).jobs}
        stuck = [jid for jid, inc in held.items()
                 if jobs[jid].status == "Running"
                 and name in jobs[jid].node_names
                 and jobs[jid].requeue_count == inc]
        requeued = [jid for jid, inc in held.items()
                    if jobs[jid].requeue_count > inc]
        check(not stuck and sorted(requeued) == sorted(keepers),
              f"{label}: the jobs running on {name} after its SIGKILL: "
              f"{[(j, jobs[j].status, jobs[j].requeue_count) for j in held]}")
        t_restart = time.time()
        craneds[name].start()
        wait_until(lambda: name in alive(), f"{name} alive again",
                   pause=NP_POLL_S)
        mark("alive_again")
        out["killed"] = {"node": name, "running": len(held),
                         "requeued": len(requeued),
                         "restart_to_alive_s": time.time() - t_restart}
        print(f"[{label}] node-downs before the SIGKILL "
              f"{out['node_downs_before_kill']}; {out['finished_requeued']} "
              f"finished jobs were requeued once or more", flush=True)
        print(f"[{label}] cancelled {NP_CANCEL} (shells gone); SIGKILL "
              f"{name}: down in {out['kill_to_down_s']:.1f}s, "
              f"{len(requeued)} of {len(held)} requeued, alive again in "
              f"{out['killed']['restart_to_alive_s']:.1f}s", flush=True)

        # 5. a 2-node gang fencing through coord on the resolvable pair
        script = (f"exec > {tmp}/gang_$CRANE_NODE_RANK.log 2>&1\n"
                  f"{sys.executable} -m cranesched_tpu_torch.coord fence "
                  "ready --data r$CRANE_NODE_RANK --timeout 60 || exit 9\n"
                  "echo fenced-$CRANE_NODE_RANK\n")
        gid = client.submit(pb.JobSpec(
            partition="gang", node_num=2, time_limit=600, script=script,
            res=pb.ResourceSpec(cpu=1.0, mem_bytes=1 << 30))).job_id
        t_gang = time.time()

        def gang_state():
            return client.query_jobs(job_ids=[gid],
                                     include_history=True).jobs[0]

        wait_until(lambda: gang_state().status in (
            "Completed", "Failed", "Cancelled"), "the gang ends")
        logs = {}
        for r in (0, 1):
            path = f"{tmp}/gang_{r}.log"
            logs[r] = open(path).read() if os.path.exists(path) else ""
        g = gang_state()
        check(g.status == "Completed" and all(
            f"fenced-{r}" in logs[r] and "0:r0" in logs[r]
            and "1:r1" in logs[r] for r in (0, 1)),
            f"{label}: gang {g.status} {g.exit_code} {logs}")
        out["gang"] = {"job": gid, "nodes": list(g.node_names),
                       "seconds": time.time() - t_gang}
        mark("gang")

        # node-side spans of the window's latest finished jobs, read once
        # the gang is done (the reads stretch the cycle they overlap; the
        # job trace keeps every job's timeline: each must hold them).
        # ``dispatched`` is the cycle's ``now``, its start;
        # ``craned_received`` is the push's ``now``, stamped as the
        # dispatcher sends it (the craned re-bases its spans onto it); the
        # cycle's trace row gives its state phases' end (``now`` +
        # ``total_ms``), where the dispatch phase hands the pushes to the
        # dispatcher's pool
        import concurrent.futures

        rows_now()
        by_now = {r["now"]: r for r in trace_rows.values()}
        latest = sorted(done, key=lambda j: -j.end_time)[:NP_TRACE_JOBS]
        with concurrent.futures.ThreadPoolExecutor(NP_TRACE_THREADS) as ex:
            docs = list(ex.map(lambda j: client.query_job_summary(
                job_id=j.job_id).timeline_json, latest))
        cycle_push, drain_push, start, missing = [], [], [], []
        for j, doc in zip(latest, docs):
            t = ({sp["edge"]: sp["t"] for sp in
                  json.loads(doc)["incarnations"][-1]["spans"]}
                 if doc else {})
            if not {"dispatched", "craned_received", "step_start"} <= set(t):
                missing.append((j.job_id, sorted(t)))
                continue
            cycle_push.append(t["craned_received"] - t["dispatched"])
            start.append(t["step_start"] - t["craned_received"])
            row = by_now.get(t["dispatched"])
            if row is not None:
                drain_push.append(t["craned_received"] - t["dispatched"]
                                  - row["total_ms"] / 1e3)
        check(not missing, f"{label}: {len(missing)} of {len(latest)} "
                           f"jobs lack node-side spans: {missing[:5]}")
        out["cycle_start_to_push_sent"] = percentiles(cycle_push)
        out["drain_to_push_sent"] = (percentiles(drain_push)
                                     if drain_push else None)
        out["craned_received_to_step_start"] = percentiles(start)
        mark("spans")

        # the ctld's cycles: on the card, through greedy_place
        rows_now()
        trace = [trace_rows[k] for k in sorted(trace_rows)
                 if trace_rows[k].get("solver") != "skip"]
        out["skipped_cycles"] = len(trace_rows) - len(trace)
        out["cycles"] = [{k: r.get(k) for k in (
            "now", "solver", "device", "kernel_launches", "candidates",
            "placed", "total_ms", "solve_ms", "solve_head_ms",
            "solve_tail_ms", "commit_ms", "dispatch_ms")} for r in trace]
        check(trace and all(r["device"] == DEVICE for r in trace),
              f"{label}: cycle devices {[r['device'] for r in trace]}")
        want = {"backfill-split": 1, "cuda-stream": 1, "cuda": 1,
                "backfill": 0}
        check(DEVICE != "cuda" or all(
            r["solver"] in want and r["kernel_launches"]
            == want[r["solver"]] for r in trace),
            f"{label}: cycle solvers and launches "
            f"{[(r['solver'], r['kernel_launches']) for r in trace]}")
        out["launches"] = sum(r["kernel_launches"] for r in trace)
        check(DEVICE != "cuda" or any(
            r["kernel_launches"] and r["placed"] for r in trace),
            f"{label}: greedy_place placed nothing in the ctld")
        out["head_stretch"] = [r["solve_head_ms"] / base_head_ms
                               for r in trace
                               if r["solver"] == "backfill-split"]
        out["supervisor_spawn"] = spawn_histogram(
            [c.metrics() for c in craneds.values()])
        client.close()

        mark("read")

        # 6. SIGTERM every craned (all at once), then the ctld
        for c in craneds.values():
            c.term()
        rcs = {n: c.wait() for n, c in craneds.items()}
        check(all(rc == 0 for rc in rcs.values()),
              f"{label}: craned exits {rcs}")
        mark("craneds_stopped")
        out["stop_s"] = ctld.stop()
        mark("ctld_stopped")
        out["timeline_s"] = marks
        errs = "".join(c.text("err") for c in craneds.values())
        for c in craneds.values():
            for run in range(1, c.runs):
                with open(f"{tmp}/craned-{c.name}-{run}.err") as fh:
                    errs += fh.read()
        out["rendezvous_bind_failed"] = errs.count("rendezvous bind failed")
        print(f"[{label}] cycles {json.dumps(out['cycles'])}", flush=True)
        print(f"[{label}] gang on {out['gang']['nodes']} fenced in "
              f"{out['gang']['seconds']:.1f}s; heads over the in-process "
              f"head ({base_head_ms:.1f} ms): "
              f"{[round(x, 2) for x in out['head_stretch']]}; spawn "
              f"{json.dumps(out['supervisor_spawn'])}; every process "
              f"exited 0", flush=True)
    finally:
        if "launches" not in out and trace_rows:
            print(f"[{label}] cycles so far: " + json.dumps([
                [r["now"], r["solver"], r.get("total_ms"),
                 r.get("solve_head_ms"), r.get("placed"),
                 r.get("candidates")]
                for _, r in sorted(trace_rows.items())]), flush=True)
        for c in craneds.values():
            c.kill()
        if ctld is not None:
            ctld.kill()
        # what the craneds leave when they die (supervisors, scripts)
        out["processes_stopped_after"] = stop_marked()
    return out, out["launches"]


# ---------------------------------------------------------------------------
# 15. scale-out and failover
# ---------------------------------------------------------------------------

SO_JOBS = 10_000            # (b), (d): the class-table batch
SO_DENSE_JOBS = 2_000       # (b) dense and (c): its first jobs
SO_SHARDS = 4               # (b): shards of one mesh, all on the card
SO_RANKS = 2                # (c): processes, one node slab each
SO_PROFILE_JOBS = 1_000     # the profiled solves that count launches a job
FO_JOBS = 20_000            # (e): submits into the leader (cut: PERF.md §4)
# (e): submits into the promoted controller, in SubmitBatchJobs calls of
# WIRE_CHUNK: while one cycle's 1,024-job head runs, later calls pile up,
# so a later cycle splits and places its tail through greedy_place
FO_TOPUP = 6_000
FO_WAIT_S = 240.0           # the longest any one wait of (e) may take


def device_ops(fn):
    """Run ``fn`` under ``torch.profiler``; returns its result and the
    number of the card's kernel, memcpy and memset events it caused."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if DEVICE == "cuda" else [])
    with profile(activities=acts) as prof:
        out = fn()
        sync()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    return out, sum(1 for e in events if e.get("cat") in DEVICE_CATS)


def sync():
    import torch

    if DEVICE == "cuda":
        torch.cuda.synchronize()


def timed_ms(fn):
    """``fn()`` and its wall time in ms, the card settled on both ends."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def same_solve(label, want, p, s):
    """A solve's placed, nodes, reason, avail and cost against greedy_place
    on the same batch, bitwise."""
    got = host(p.placed, p.nodes, p.reason, s.avail, s.cost)
    for what, a, b in zip(("placed", "nodes", "reason", "avail", "cost"),
                          want, got):
        check(a.shape == b.shape and np.array_equal(a, b),
              f"{label}: {what} differs from greedy_place")


_MP_CHILD = r"""
import json, sys, time
import numpy as np, torch
from cranesched_tpu_torch.models.solver import make_cluster_state
from cranesched_tpu_torch.parallel import distributed as d

tmp, rank, nprocs, device = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
pb = np.load(tmp + "/problem.npz")
slab = pb["total"].shape[0] // nprocs
lo, hi = rank * slab, (rank + 1) * slab
state = make_cluster_state(pb["total"][lo:hi], pb["total"][lo:hi],
                           pb["alive"][lo:hi], pb["cost"][lo:hi],
                           device=device)
pmesh = d.bootstrap_process_mesh(rank, nprocs, slab, devices=[device])
fences = []
fence = pmesh.fence


def timed(*a, **k):
    t0 = time.monotonic()
    try:
        return fence(*a, **k)
    finally:
        fences.append(time.monotonic() - t0)


pmesh.fence = timed
args = [torch.as_tensor(pb[k], device=device)
        for k in ("req", "node_num", "time_limit", "valid", "job_class")]
masks = torch.as_tensor(pb["masks"][:, lo:hi], device=device)
t0 = time.perf_counter()
p, s = d.solve_greedy_sharded_classes_mp(pmesh, state, *args, masks,
                                         max_nodes=2)
solve_s = time.perf_counter() - t0
pmesh.close()
np.savez(f"{tmp}/rank{rank}.npz", placed=p.placed.cpu().numpy(),
         nodes=p.nodes.cpu().numpy(), reason=p.reason.cpu().numpy(),
         avail=s.avail.cpu().numpy(), cost=s.cost.cpu().numpy(),
         fence_s=np.asarray(fences))
counts, (n, total) = d._MET_FENCE._series[(("kind", "solve"),)]
print(json.dumps({"rank": rank, "mesh": pmesh.describe(),
                  "solve_s": solve_s, "fences": len(fences),
                  "metric_count": n, "metric_sum_s": total}))
"""


def two_processes(data, want):
    """(c): ``SO_RANKS`` processes, one node slab each on the card, fence
    through a rendezvous server in this process; each rank's placements
    and the slabs' ledger against ``want`` (greedy_place on the whole
    cluster).  Returns the report."""
    import os
    import shutil
    import subprocess
    import tempfile

    from cranesched_tpu_torch.rpc.rendezvous import RendezvousServer

    tmp = tempfile.mkdtemp(prefix="crane-mp-")
    np.savez(f"{tmp}/problem.npz", **data)
    server = RendezvousServer(token="smoke", nranks=SO_RANKS, epoch=1)
    port = server.start("127.0.0.1:0")
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CRANE_RENDEZVOUS=f"127.0.0.1:{port}",
               CRANE_RENDEZVOUS_TOKEN="smoke")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _MP_CHILD, tmp, str(r), str(SO_RANKS),
         DEVICE], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=root) for r in range(SO_RANKS)]
    try:
        outs = []
        for p in procs:
            o, e = p.communicate(timeout=FO_WAIT_S)
            check(p.returncode == 0,
                  f"two processes: a rank exited {p.returncode}: {e[-2000:]}")
            outs.append(json.loads(o.strip().splitlines()[-1]))
        wall = time.perf_counter() - t0
        parts = [np.load(f"{tmp}/rank{r}.npz") for r in range(SO_RANKS)]
        for r, part in enumerate(parts):
            for i, what in enumerate(("placed", "nodes", "reason")):
                check(np.array_equal(part[what], want[i]),
                      f"two processes: rank {r}'s {what} differ from "
                      "greedy_place")
        for i, what in ((3, "avail"), (4, "cost")):
            check(np.array_equal(np.concatenate([p[what] for p in parts]),
                                 want[i]),
                  f"two processes: the slabs' {what} differ")
        fences = np.concatenate([p["fence_s"] for p in parts])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    check(all(o["fences"] == o["metric_count"] for o in outs),
          "two processes: crane_mesh_fence_seconds missed fences")
    rep = {"ranks": SO_RANKS, "jobs": len(want[0]),
           "slab_nodes": N_NODES // SO_RANKS, "mesh": outs[0]["mesh"],
           "wall_s": wall, "solve_s": [o["solve_s"] for o in outs],
           "fences_per_rank": outs[0]["fences"],
           "fence": percentiles(fences),
           "fence_metric_mean_ms": [o["metric_sum_s"] / o["metric_count"]
                                    * 1e3 for o in outs]}
    print(f"[scaleout:two-processes] {SO_RANKS} ranks x "
          f"{rep['slab_nodes']} nodes, {rep['jobs']} jobs == greedy_place "
          f"(bitwise, every rank and both slabs); solve "
          f"{[round(s, 2) for s in rep['solve_s']]}s, wall {wall:.1f}s; "
          f"crane_mesh_fence_seconds over {len(fences)} fences "
          f"{json.dumps(rep['fence'])}", flush=True)
    return rep


def phase_scaleout_solves():
    """(b)-(d) on seed 2's cluster: the sharded solves on a mesh of
    ``SO_SHARDS`` shards all on the card, two processes fencing through
    the rendezvous service, and the speculative and blocked solvers, each
    bitwise against greedy_place on the same batch."""
    import torch

    from cranesched_tpu_torch.models import gpu_solver as g
    from cranesched_tpu_torch.models.solver import (
        JobBatch,
        make_cluster_state,
    )
    from cranesched_tpu_torch.models.speculative import (
        solve_blocked,
        solve_speculative,
    )
    from cranesched_tpu_torch.parallel.sharded import (
        make_node_mesh,
        solve_greedy_sharded,
        solve_greedy_sharded_classes,
    )

    rng = np.random.default_rng(2)
    lay, total = cluster_arrays(rng, N_NODES)
    alive = rng.random(N_NODES) > 0.005
    cost = rng.integers(0, 50_000, N_NODES).astype(np.int32)
    masks = np.stack([np.arange(N_NODES) % 4 == c for c in range(4)])
    jobs = job_arrays(rng, lay, SO_JOBS)
    jc = rng.integers(0, 4, SO_JOBS).astype(np.int32)
    dev = torch.device(DEVICE)
    cm = torch.as_tensor(masks, device=dev)

    def fresh():
        return make_cluster_state(total, total, alive, cost, device=DEVICE)

    def batch(j):
        return [torch.as_tensor(x[:j], device=dev) for x in (*jobs, jc)]

    def dense(j):
        req, nn, tl, valid, cls = batch(j)
        return JobBatch(req=req, node_num=nn, time_limit=tl,
                        part_mask=cm[cls.long()], valid=valid)

    rep, ref = {}, {}
    # the yardstick: greedy_place on the batch and on its first jobs
    for j in (SO_JOBS, SO_DENSE_JOBS):
        st = fresh()
        plan = g.plan_streams(jc[:j], masks)
        (p, s), ms = timed_ms(lambda: g.solve_greedy_gpu_auto(
            st, *batch(j), cm, max_nodes=2, plan=plan, class_rows=masks))
        ref[j] = host(p.placed, p.nodes, p.reason, s.avail, s.cost)
        rep[f"greedy_place_{j}"] = {"ms": ms, "streams": plan[1],
                                    "placed": int(ref[j][0].sum())}

    # (b) the merge on the card: SO_SHARDS shards of cuda:0
    mesh = make_node_mesh([dev] * SO_SHARDS)
    st = fresh()
    (p, s), ms = timed_ms(lambda: solve_greedy_sharded_classes(
        st, *batch(SO_JOBS), cm, mesh, max_nodes=2, class_rows=masks))
    same_solve(f"sharded classes, {SO_SHARDS} shards", ref[SO_JOBS], p, s)
    rep["sharded_classes"] = {"shards": SO_SHARDS, "jobs": SO_JOBS,
                              "ms": ms, "us_per_job": ms * 1e3 / SO_JOBS}
    st = fresh()
    (p, s), ms = timed_ms(lambda: solve_greedy_sharded(
        st, dense(SO_DENSE_JOBS), mesh, max_nodes=2))
    same_solve(f"sharded dense, {SO_SHARDS} shards", ref[SO_DENSE_JOBS],
               p, s)
    rep["sharded_dense"] = {"shards": SO_SHARDS, "jobs": SO_DENSE_JOBS,
                            "ms": ms, "us_per_job": ms * 1e3 / SO_DENSE_JOBS}
    # the card's operations a job: the class-table solve of the first
    # SO_PROFILE_JOBS jobs (4 streams) on the default mesh and on this one
    default = make_node_mesh() if DEVICE == "cuda" else make_node_mesh([dev])
    for name, m in (("default_mesh", default), ("mesh4", mesh)):
        st = fresh()
        _, ops = device_ops(lambda: solve_greedy_sharded_classes(
            st, *batch(SO_PROFILE_JOBS), cm, m, max_nodes=2,
            class_rows=masks))
        rep[f"device_ops_per_job_{name}"] = ops / SO_PROFILE_JOBS
    print(f"[scaleout:merge] {SO_SHARDS} shards on {dev}: classes "
          f"{SO_JOBS} jobs and dense {SO_DENSE_JOBS} jobs == greedy_place "
          f"(bitwise); {json.dumps(rep)}", flush=True)

    # (c) two processes, one slab each, on the first SO_DENSE_JOBS jobs
    j = SO_DENSE_JOBS
    rep["two_processes"] = two_processes(
        dict(total=total, alive=alive, cost=cost, masks=masks,
             req=jobs[0][:j], node_num=jobs[1][:j], time_limit=jobs[2][:j],
             valid=jobs[3][:j], job_class=jc[:j]), ref[j])

    # (d) the speculative and the blocked solvers on the dense batch
    jb = dense(SO_JOBS)
    for name, fn, kw in (
            ("speculative", solve_speculative, dict(r_cand=32, group=8)),
            ("blocked", solve_blocked, dict(block_size=128))):
        st, stats = fresh(), {}
        (p, s), ms = timed_ms(lambda: fn(st, jb, max_nodes=2, stats=stats,
                                         **kw))
        same_solve(name, ref[SO_JOBS], p, s)
        rep[name] = dict(kw, ms=ms, us_per_job=ms * 1e3 / SO_JOBS,
                         **{k: int(v) for k, v in stats.items()})
    del jb
    print(f"[scaleout:A11] {SO_JOBS} x {N_NODES}: speculative "
          f"{json.dumps(rep['speculative'])}, blocked "
          f"{json.dumps(rep['blocked'])} == greedy_place "
          f"({rep[f'greedy_place_{SO_JOBS}']['ms']:.1f} ms) bitwise",
          flush=True)
    return rep


def sharded_cycle(twin):
    """(a): the disjoint cell's cold immediate cycle (phase 11's seed)
    with ``solver="sharded"`` on the default mesh, against phase 11's
    ``"cuda"`` twin: started jobs, nodes, reasons and ledger equal; the
    greedy kernel does not launch."""
    from cranesched_tpu_torch.ctld import SchedulerConfig
    from cranesched_tpu_torch.models import gpu_solver as g

    label = "sharded"
    rng = np.random.default_rng(1)
    gc.collect()
    sched, sim, submit = build_cell(
        rng, False, SchedulerConfig(backfill=False, solver="sharded"))
    submit(N_JOBS, 0.0)
    gc.collect()
    g.greedy_place.launches = 0
    started, last = cycle_once(sched, 100.0, label)
    check(g.greedy_place.launches == 0,
          f"{label}: the kernel launched {g.greedy_place.launches} times")
    row = sched.cycle_trace.snapshot()[-1]
    want_mesh = f"1x{len(sched._mesh)}"
    check(last["solver"] == "sharded" and row["mesh"] == want_mesh
          and row["device"] == DEVICE,
          f"{label}: solver {last['solver']}, mesh {row.get('mesh')}")
    check_ledger(sched, label)
    same_outcome(f"{label} vs cuda", cycle_outcome(sched, started), twin)
    rep = {"solve_ms": last["solve_ms"], "total_ms": last["total_ms"],
           "candidates": row["candidates"], "placed": len(started),
           "us_per_job": last["solve_ms"] * 1e3 / row["candidates"],
           "mesh": row["mesh"]}
    print(f"[scaleout:sharded-cycle] == cuda twin on {len(started)} starts;"
          f" {json.dumps(rep)}", flush=True)
    del sched, sim, submit
    return rep


def failover_drill():
    """(e): a leader ``ctld_main --sim`` on the card and a standby that
    follows it (``--ha-standby --ha-peer``), phase 12's cluster and
    draws; ``FO_JOBS`` submits; the standby catches up, refuses a
    mutation and runs no cycle; SIGKILL the leader; the standby promotes
    with every acknowledged job, places jobs on the card, acknowledges
    ``FO_TOPUP`` new submits (so that a cycle has more candidates than
    the backfill head and its tail goes through greedy_place) and
    schedules them on the card.
    Returns the report and the promoted controller's greedy_place
    launches (its trace rows)."""
    import signal
    import tempfile

    import grpc

    from cranesched_tpu_torch.rpc import CtldClient

    label = "failover"
    tmp_l = tempfile.mkdtemp(prefix="crane-leader-")
    tmp_s = tempfile.mkdtemp(prefix="crane-standby-")
    rng, _ = daemon_config(f"{tmp_l}/ctld.yaml", tmp_l)
    daemon_config(f"{tmp_s}/ctld.yaml", tmp_s)
    out = {"jobs": FO_JOBS}
    procs, clients = [], []
    t_phase = time.perf_counter()
    try:
        leader = DaemonProc(tmp_l, "leader", f"{tmp_l}/ctld.yaml")
        procs.append(leader)
        specs = draw_specs(rng, FO_JOBS)
        lport, out["leader_boot_s"] = leader.banner()
        standby = DaemonProc(
            tmp_s, "standby", f"{tmp_s}/ctld.yaml",
            args=("--sim", "--ha-standby", "--ha-peer",
                  f"127.0.0.1:{lport}"))
        procs.append(standby)
        lc = CtldClient(f"127.0.0.1:{lport}", timeout=600.0)
        clients.append(lc)
        ids, dt = wire_submit(lc, specs)
        out["submit"] = {"seconds": dt, "jobs_per_s": len(ids) / dt}
        sport, out["standby_boot_s"] = standby.banner()
        check(f"STANDBY of 127.0.0.1:{lport}" in standby.text(),
              f"{label}: standby banner {standby.text()[:300]!r}")
        sc = CtldClient(f"127.0.0.1:{sport}", timeout=600.0)
        clients.append(sc)

        def rows(client):
            return [r for r in json.loads(client.query_stats().json)
                    ["cycle_trace"] if r.get("solver") != "skip"]

        def wait(pred, what, client=None):
            """Wait for ``pred``; on a timeout, fail with ``client``'s
            cycles and the standby's log tail."""
            deadline = time.time() + FO_WAIT_S
            while not pred():
                if time.time() >= deadline:
                    seen = [(r["solver"], r["device"], r["candidates"],
                             r["placed"], r["kernel_launches"])
                            for r in rows(client)] if client else []
                    check(False, f"{label}: {what} not within "
                                 f"{FO_WAIT_S:.0f}s; cycles {seen[-12:]}; "
                                 f"standby log {standby.text('err')[-1500:]}")
                time.sleep(0.2)

        def note(what):
            print(f"[scaleout:failover] {time.perf_counter() - t_phase:.1f}s "
                  f"{what}", flush=True)

        # the leader places part of the backlog; the standby catches up
        # with everything acknowledged and started so far
        note(f"leader up in {out['leader_boot_s']:.1f}s, {len(ids)} "
             f"submits in {dt:.1f}s, standby up in "
             f"{out['standby_boot_s']:.1f}s")
        wait(lambda: any(r["placed"] > 0 for r in rows(lc)),
             "a placing cycle on the leader", lc)
        t0 = time.perf_counter()
        mark = lc.ha_status().wal_seq
        wait(lambda: sc.ha_status().wal_seq >= mark, "the standby's catch-up")
        out["catch_up_s"] = time.perf_counter() - t0
        note(f"standby caught up with seq {mark} in {out['catch_up_s']:.1f}s")
        st = sc.ha_status()
        check(st.role == "standby" and st.leader_address
              == f"127.0.0.1:{lport}", f"{label}: standby status {st}")
        try:
            sc.submit(specs[0])
            check(False, f"{label}: the standby took a submit")
        except grpc.RpcError as e:
            check(e.code() == grpc.StatusCode.FAILED_PRECONDITION
                  and "not leader" in e.details(),
                  f"{label}: standby refusal {e.code()} {e.details()}")
        check(rows(sc) == [], f"{label}: the standby ran a cycle")
        epoch = lc.ha_status().fencing_epoch
        before = stream_states(lc)
        out["leader_running_at_kill"] = sum(
            1 for s, _ in before.values() if s == "Running")

        # SIGKILL the leader
        t_kill, wall_kill = time.perf_counter(), time.time()
        leader.proc.send_signal(signal.SIGKILL)
        leader.proc.wait(timeout=60)
        wait(lambda: sc.ha_status().role == "leader", "the promotion")
        out["kill_to_leader_s"] = time.perf_counter() - t_kill
        note(f"leader SIGKILLed; the standby leads after "
             f"{out['kill_to_leader_s']:.1f}s")
        st = sc.ha_status()
        check(st.fencing_epoch > epoch,
              f"{label}: epoch {st.fencing_epoch} after {epoch}")
        check("PROMOTED to leader" in standby.text("err"),
              f"{label}: no promotion line")
        after = stream_states(sc)
        lost = [j for j in ids if j not in after]
        check(not lost, f"{label}: {len(lost)} acknowledged jobs missing "
                        f"after the promotion, e.g. {lost[:5]}")
        # the dead leader's running jobs are recovered RUNNING; the
        # promoted controller's own simulated plane never ran them, so
        # nothing ends them: counted apart
        out["recovered_running"] = sum(
            1 for s, _ in after.values() if s == "Running")
        new_ids, _ = wire_submit(sc, draw_specs(rng, FO_TOPUP))
        check(min(new_ids) > max(ids), f"{label}: new job ids {new_ids[:3]}")

        def placing():
            return [r for r in rows(sc) if r["placed"] > 0
                    and r["device"] == DEVICE]

        wait(lambda: placing(), "a placing cycle on the card", sc)
        first = placing()[0]
        out["kill_to_first_placement_s"] = (
            first["now"] + first["total_ms"] / 1e3 - wall_kill)
        wait(lambda: any(r["kernel_launches"] >= 1 for r in placing()),
             "a placing cycle through greedy_place", sc)
        wait(lambda: any(j.status == "Running" for j in
                         sc.query_jobs(job_ids=new_ids).jobs),
             "a new job running", sc)
        promoted = rows(sc)
        check(all(r["device"] == DEVICE for r in promoted),
              f"{label}: cycle devices {[r['device'] for r in promoted]}")
        out["launches"] = sum(r["kernel_launches"] for r in promoted)
        out["promoted_cycles"] = [{k: r.get(k) for k in (
            "solver", "kernel_launches", "candidates", "placed",
            "total_ms", "solve_ms")} for r in promoted]
        out["epoch"] = [epoch, st.fencing_epoch]
        for c in clients:
            c.close()
        clients.clear()
        out["stop_s"] = standby.stop()
        print(f"[scaleout:failover] {FO_JOBS} submits at "
              f"{out['submit']['jobs_per_s']:.0f}/s; standby caught up "
              f"{out['catch_up_s']:.1f}s after the leader's first placing "
              f"cycle; SIGKILL -> leader {out['kill_to_leader_s']:.1f}s, "
              f"-> first placement on the card "
              f"{out['kill_to_first_placement_s']:.1f}s; every one of "
              f"{len(ids)} acknowledged jobs there "
              f"({out['recovered_running']} recovered running); "
              f"{json.dumps(out)}", flush=True)
    finally:
        for c in clients:
            c.close()
        for p in procs:
            p.kill()
    return out


# ---------------------------------------------------------------------------
# 16. federation: partition-sharded controllers on the card
# ---------------------------------------------------------------------------

FED_LAYOUT = {"east": ("p0", "p1"), "west": ("p2", "p3")}
FED_CPU, FED_MEM_GB = 64.0, 256   # every node of (a), as SimShard builds
FED_GANGS = 200                   # cross-partition gangs over p1 and p2
FED_GANG_NODES = 8                # SchedulerConfig().max_nodes_per_job
FED_KEEP = 7                      # p1 / p2 nodes left undrained for them
FED_GANG_RUNTIME = 60.0           # seconds a gang runs
FED_ROUND_S = 60.0                # the gang window's clock step
FED_ROUNDS = 60                   # the longest the gang window may take
FED_DAEMON_JOBS = 10_000          # (b): a depth cut (PERF.md §4)
FED_MAX_SUBMIT = 8_000            # (b): MaxSubmitJobsPerUser
FED_MAX_JOBS = 3_000              # (b): MaxJobsPerUser
FED_SLACK = 1_000                 # (b): PublishSlack
FED_WAIT_S = 240.0                # (b): the longest any one wait may take


def fed_nodes(name, parts, layout):
    """(name, partition) of every node of one shard, in ``SimShard``'s
    order (partitions sorted, ``<shard>-<part>-n<i>``)."""
    return [(f"{name}-{part}-n{i:04d}", part) for part in sorted(parts)
            for i in range(layout[part])]


def fed_twin(name, parts, layout):
    """One plain port ``JobScheduler`` on the card over one shard's
    partitions alone (the same nodes, names and ids as its ``SimShard``,
    the same config), with a ``SimCluster``; no federation plane."""
    from cranesched_tpu_torch.craned.sim import SimCluster
    from cranesched_tpu_torch.ctld import (
        JobScheduler,
        MetaContainer,
        SchedulerConfig,
    )

    meta = MetaContainer()
    for nid, (node, part) in enumerate(fed_nodes(name, parts, layout)):
        meta.add_node(node, meta.layout.encode(
            cpu=FED_CPU, mem_bytes=FED_MEM_GB << 30,
            memsw_bytes=FED_MEM_GB << 30, is_capacity=True),
            partitions=(part,))
        meta.craned_up(nid)
    sched = JobScheduler(meta, SchedulerConfig(
        job_trace=True, job_trace_capacity=65536), device=DEVICE)
    sim = SimCluster(sched)
    sim.wire(sched)
    return sched, sim


def fed_specs(rng, k, prefix):
    """``k`` of phase 12's draws (``draw_specs``'s, in its order) as the
    scheduler's ``JobSpec``s, as ``rpc.convert.spec_from_pb`` makes them
    of the wire specs (its defaults for the fields the draws leave
    unset), each named ``<prefix><i>`` for the by-name audits: ids are
    shard-local and change on a migration."""
    from cranesched_tpu_torch.ctld import JobSpec, ResourceSpec

    out = []
    for i in range(k):
        part = f"p{rng.integers(0, 4)}"
        tl = int(rng.integers(60, 86400))
        cpu = float(rng.integers(1, 17))
        mem = int(rng.integers(1, 33)) << 30
        out.append(JobSpec(
            name=f"{prefix}{i:06d}", user="user", account="default",
            partition=part, res=ResourceSpec(cpu=cpu, mem_bytes=mem),
            node_num=int(rng.integers(1, 3)), time_limit=tl,
            sim_runtime=float(rng.integers(30, 1800))))
    return out


def fed_outcome(sched, started):
    """Started ids, their nodes, every pending reason, and the ledger."""
    meta = sched.meta
    return (sorted(started),
            {j: tuple(sched.running[j].node_ids) for j in started
             if j in sched.running},
            {j: job.pending_reason for j, job in sched.pending.items()},
            np.stack([meta.nodes[i].avail for i in sorted(meta.nodes)]))


def fed_row(sched):
    """The scheduler's last non-skip trace row."""
    rows = [r for r in sched.cycle_trace.snapshot()
            if r.get("solver") != "skip"]
    return rows[-1]


def fed_parity_small():
    """The bitwise solo-vs-federated check at the JAX test's size
    (``tests/test_federation.py``'s parity case) on the card: one
    controller over {batch: 3, gpu: 2} and a two-shard federation place
    every job at the same time on the same nodes.  Then a lease taken
    while a cycle solves: the commit refuses every placement onto the
    leased nodes (revalidation on the lease's ``ResReduceEvent``)."""
    from cranesched_tpu_torch.ctld import JobSpec, ResourceSpec
    from cranesched_tpu_torch.fed.sim import FederatedCluster, SimShard

    specs = []
    for i in range(24):
        part = "gpu" if i % 3 == 0 else "batch"
        specs.append(JobSpec(
            name=f"j{i:03d}", user="u", partition=part,
            res=ResourceSpec(cpu=2.0 + (i % 3) * 2.0, mem_bytes=1 << 30,
                             memsw_bytes=1 << 30),
            sim_runtime=3.0 + (i % 5)))

    def placements(sched):
        return {j.spec.name: (j.start_time, tuple(sorted(
            sched.meta.nodes[n].name.split("-", 1)[1]
            for n in j.node_ids)))
            for j in list(sched.history.values())
            + list(sched.running.values())}

    solo = SimShard("solo", {"batch": 3, "gpu": 2}, device=DEVICE)
    for s in specs:
        solo.submit(s, 0.0)
    now = 0.0
    while now < 1000.0 and not solo.drained():
        now += 1.0
        solo.tick(now)
    fc = FederatedCluster({"east": {"batch": 3}, "west": {"gpu": 2}},
                          device=DEVICE)
    for s in specs:
        fc.submit(s, 0.0)
    fc.run_until_drained(max_cycles=1000)
    fed = {}
    for shard in fc.shards.values():
        fed.update(placements(shard.scheduler))
    check(solo.drained() and len(fed) == len(specs)
          and fed == placements(solo.scheduler),
          "federation parity: the two shards placed otherwise than one "
          "controller")

    # a lease mid-solve: the solve sees every node free, the commit
    # must not place onto the nodes leased in between
    shard = SimShard("lease", {"batch": 4}, device=DEVICE)
    for i in range(8):
        shard.submit(JobSpec(name=f"l{i}", res=ResourceSpec(
            cpu=4.0, mem_bytes=1 << 30, memsw_bytes=1 << 30),
            partition="batch", sim_runtime=50.0), 0.0)
    gen = shard.scheduler.cycle_phases(1.0)
    fn = next(gen)
    leased = []
    try:
        while True:
            result = fn()
            if not leased:
                req = ResourceSpec(cpu=1.0).encode(shard.meta.layout)
                names, _e, _s = shard.fed.lease_nodes(
                    "mid-solve", "batch", 2, req, 0.0, 1.0)
                leased = {shard.meta.node_by_name(n).node_id for n in names}
            fn = gen.send(result)
    except StopIteration:
        pass
    on_leased = [j.job_id for j in shard.scheduler.running.values()
                 if set(j.node_ids) & leased]
    check(shard.scheduler.running and not on_leased,
          f"lease mid-solve: jobs {on_leased} committed onto leased nodes")
    check_ledger(shard.scheduler, "lease mid-solve", resident=False)
    return {"jobs": len(fed), "equal": True,
            "mid_solve_lease_nodes": len(leased),
            "started_beside_lease": len(shard.scheduler.running)}


def fed_spy_leases(shard, leases):
    """Record every lease ``shard`` grants (lease id -> node names)."""
    real = shard.fed.lease_nodes

    def spy(lease_id, partition, node_num, req, ttl, now):
        out = real(lease_id, partition, node_num, req, ttl, now)
        leases[lease_id] = list(out[0])
        return out

    shard.fed.lease_nodes = spy


def phase_federation():
    """(a): two shards in one process on the card, four partitions of
    ``N_NODES // 4`` nodes; returns the report and greedy_place's
    launches in the shards' cycles (their trace rows)."""
    import tempfile

    from cranesched_tpu_torch.ctld import JobSpec, ResourceSpec
    from cranesched_tpu_torch.fed.arbiter import GangRequest
    from cranesched_tpu_torch.fed.sim import FederatedCluster
    from cranesched_tpu_torch.fed.usage import GlobalLimits
    from cranesched_tpu_torch.models import gpu_solver as g
    from cranesched_tpu_torch.obs.introspect import sample_device_memory

    label = "federation"
    per = N_NODES // 4
    layout = {p: per for parts in FED_LAYOUT.values() for p in parts}
    gang_parts = {"p1": "east", "p2": "west"}
    tmp = tempfile.mkdtemp(prefix="crane-fed-")
    rep = {"nodes_per_partition": per, "jobs": N_JOBS, "gangs": FED_GANGS}
    t_phase = time.perf_counter()

    def note(what):
        print(f"[federation] {time.perf_counter() - t_phase:.1f}s {what}",
              flush=True)

    rep["parity_small"] = fed_parity_small()
    note(f"solo-vs-federated parity at the JAX test's size, and a lease "
         f"mid-solve: {rep['parity_small']}")
    sample_device_memory(peak_reset=True)

    # the main path: counts zeroed just before it
    g.greedy_place.launches = 0
    fc = FederatedCluster(
        {name: {p: per for p in parts} for name, parts in FED_LAYOUT.items()},
        cpu=FED_CPU, mem_gb=FED_MEM_GB, wal_dir=tmp, device=DEVICE,
        global_limits=GlobalLimits(), publish_slack=0)
    twins = {name: fed_twin(name, parts, layout)
             for name, parts in FED_LAYOUT.items()}
    # FED_KEEP nodes of p1 and of p2 held back (drained) for the gang
    # window, in the shard and in its twin alike
    kept = {}
    for part, name in gang_parts.items():
        ids = sorted(fc.shards[name].meta.partitions[part].node_ids)
        kept[part] = ids[:FED_KEEP]
        for sched in (fc.shards[name].scheduler, twins[name][0]):
            for nid in kept[part]:
                sched.meta.drain(nid)
    rng, _ = daemon_config(f"{tmp}/draws.yaml", tmp)
    specs = fed_specs(rng, N_JOBS, "f")
    names = [s.name for s in specs]
    t0 = time.perf_counter()
    wals = [s.scheduler.wal for s in fc.shards.values()]
    for w in wals:
        w.begin_batch()
    for spec in specs:
        shard, jid = fc.submit(spec, 0.0)
        check(jid > 0 and twins[shard][0].submit(spec, 0.0) == jid,
              f"{label}: submit of {spec.name} to {shard}")
    for w in wals:
        w.commit_batch()
    rep["submit_s"] = time.perf_counter() - t0
    note(f"{N_JOBS} submits routed by partition (and to the twins) in "
         f"{rep['submit_s']:.1f}s: "
         + ", ".join(f"{n} {len(s.scheduler.pending)}"
                     for n, s in fc.shards.items()))

    # two cycles per shard, each against its twin, the usage pumped
    rep["cycles"] = {n: [] for n in fc.shards}
    twin_launches = 0

    def cycle_row(name, sched, c, started, wall):
        row = fed_row(sched)
        last = dict(sched.stats["last_cycle"])
        last.update(cycle=c, placed=len(started), wall_s=wall,
                    kernel_launches=row["kernel_launches"],
                    device=row["device"], nodes=len(sched.meta.nodes))
        rep["cycles"][name].append(last)
        check(row["device"] == DEVICE and row["kernel_launches"] >= 1,
              f"{label} {name} cycle {c}: {row['solver']} on "
              f"{row['device']}, {row['kernel_launches']} launches")
        return last

    for c, now in enumerate((100.0, 1000.0)):
        fc.now = now
        for name, shard in fc.shards.items():
            t1 = time.perf_counter()
            started = shard.tick(now)
            wall = time.perf_counter() - t1
            sched = shard.scheduler
            check_ledger(sched, f"{label} {name} cycle {c}",
                         resident=False)
            twin, tsim = twins[name]
            tsim.advance_to(now)
            before = g.greedy_place.launches
            tstarted = twin.schedule_cycle(now)
            twin_launches += g.greedy_place.launches - before
            check_ledger(twin, f"{label} {name} twin cycle {c}",
                         resident=False)
            a, b = fed_outcome(sched, started), fed_outcome(twin, tstarted)
            check(a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
                  and np.array_equal(a[3], b[3]),
                  f"{label} {name} cycle {c}: the shard's cycle differs "
                  f"from its solo twin's ({len(a[0])} vs {len(b[0])} "
                  "started)")
            last = cycle_row(name, sched, c, started, wall)
            note(f"{name} cycle {c}: placed {len(started)}, equal to its "
                 f"twin; {json.dumps(last)}")
        fc.arbiter.pump(now)
        fc.pump_usage(now)
    del twins
    gc.collect()

    # the gang window: the held-back nodes come back and the rest of p1
    # and p2 drains (no gang of FED_GANG_NODES fits one partition
    # whole, so each splits over both shards); the shards' cycles wait
    # while the arbiter and the usage gossip pump each step
    def drain_all_but_kept(part, on):
        meta = fc.shards[gang_parts[part]].meta
        for nid in sorted(meta.partitions[part].node_ids):
            meta.drain(nid, on and nid not in kept[part])

    for part in gang_parts:
        drain_all_but_kept(part, True)
    gang_spec = JobSpec(user="gang", res=ResourceSpec(
        cpu=4.0, mem_bytes=8 << 30, memsw_bytes=8 << 30),
        time_limit=3600, sim_runtime=FED_GANG_RUNTIME)
    # the first gang names p2 first: with both kept sets equally free its
    # west lease comes first, and west dies right after it (the reserve
    # durable, no confirm)
    for i in range(FED_GANGS):
        fc.submit_gang(GangRequest(
            name=f"gang{i:03d}", node_num=FED_GANG_NODES,
            partitions=("p2", "p1") if i == 0 else ("p1", "p2"),
            spec=gang_spec))
    leases = {}
    for shard in fc.shards.values():
        fed_spy_leases(shard, leases)
    fc.shards["west"].crash_after_lease = True
    rounds = 0
    crash = {}
    t_gangs = time.perf_counter()
    while fc.arbiter.queue and rounds < FED_ROUNDS:
        now += FED_ROUND_S
        rounds += 1
        fc.now = now
        for shard in fc.shards.values():
            if shard.alive:
                with shard.lock:
                    shard.sim.advance_to(now)
                    shard.scheduler.process_status_changes()
                    shard.fed.expire(now)
        fc.arbiter.pump(now)
        if not fc.shards["west"].alive:
            crash = {"arbiter": dict(fc.arbiter.stats),
                     "bare_lease": sorted(leases)}
            check(fc.arbiter.stats["commits"] == 0
                  and fc.arbiter.stats["aborts"] >= 1,
                  f"{label}: the crash drill {fc.arbiter.stats}")
            t1 = time.perf_counter()
            fc.recover("west", now)
            crash["recover_s"] = time.perf_counter() - t1
            west = fc.shards["west"]
            released = [lid for lid, (ev, _p) in
                        west.scheduler.wal.replay_fed(west.wal_path).items()
                        if ev == "fed_release"]
            check(not west.fed.leases and released,
                  f"{label}: west recovered with leases "
                  f"{west.fed.leases}, released {released}")
            crash["released_by_recovery"] = released
            crash["recovered_live_jobs"] = (len(west.scheduler.pending)
                                            + len(west.scheduler.running))
            # a drain is the operator's, not in the WAL: re-applied
            drain_all_but_kept("p2", True)
            fed_spy_leases(west, leases)
            note(f"west SIGKILLed after its lease for gang000; recovered "
                 f"from its WAL on {DEVICE} in {crash['recover_s']:.1f}s "
                 f"({crash['recovered_live_jobs']} live jobs), the bare "
                 f"reserve {released} released")
        fc.pump_usage(now)
    rep["gang_window"] = {"rounds": rounds, "virtual_s": rounds * FED_ROUND_S,
                          "seconds": time.perf_counter() - t_gangs,
                          "leases_granted": len(leases),
                          "arbiter": dict(fc.arbiter.stats)}
    check(crash and not fc.arbiter.queue
          and fc.arbiter.stats["commits"] == FED_GANGS,
          f"{label}: {len(fc.arbiter.queue)} gangs left after {rounds} "
          f"steps, {fc.arbiter.stats}, crash drill {crash}")
    # every gang placed once, whole, on both shards, each member on the
    # nodes its lease named; no node double-placed; no lease left
    members = {}
    for sname, shard in fc.shards.items():
        sched = shard.scheduler
        for col in (sched.pending, sched.running, sched.history):
            for job in col.values():
                if job.spec.name.startswith("gang"):
                    members.setdefault(job.spec.name, []).append(
                        (sname, [shard.meta.nodes[n].name
                                 for n in job.node_ids]))
    by_gang = {}
    for mname, where in members.items():
        gname, part = mname.split("@")
        check(len(where) == 1,
              f"{label}: member {mname} placed {len(where)} times")
        by_gang.setdefault(gname, {})[part] = where[0]
    check(len(by_gang) == FED_GANGS,
          f"{label}: {len(by_gang)} gangs placed of {FED_GANGS}")
    leased = [set(v) for v in leases.values()]
    for gname, parts in by_gang.items():
        check(set(parts) == set(gang_parts)
              and {sh for sh, _n in parts.values()} == {"east", "west"},
              f"{label}: {gname} is not on both shards: {parts}")
        for part, (_sh, nodes) in parts.items():
            check(any(set(nodes) <= s for s in leased),
                  f"{label}: {gname}@{part} on {nodes}, not a lease's")
    for shard in fc.shards.values():
        check(not shard.fed.leases,
              f"{label}: leases left on {shard.name}: {shard.fed.leases}")
        check_ledger(shard.scheduler, f"{label} {shard.name} gangs",
                     resident=False)
    rep["crash_drill"] = crash
    note(f"{FED_GANGS} gangs committed in {rounds} arbiter steps "
         f"({rep['gang_window']['seconds']:.1f}s), each once, whole, on "
         f"leased nodes of both shards; {len(leases)} leases granted; "
         f"arbiter {fc.arbiter.stats}")
    for part in gang_parts:
        drain_all_but_kept(part, False)

    # the storm goes on: p1 moves east -> west with jobs running and
    # pending on it
    now += FED_ROUND_S
    fc.now = now
    east, west = fc.shards["east"], fc.shards["west"]
    for shard in (east, west):
        with shard.lock:
            shard.sim.advance_to(now)
            shard.scheduler.process_status_changes()
    marks = {}
    seal = fc.handles["east"].seal
    flip = fc.coordinator.flip_map

    def timed_seal(*a):
        marks["seal"] = time.perf_counter()
        return seal(*a)

    def timed_flip(new_map):
        marks["flip"] = time.perf_counter()
        return flip(new_map)

    fc.handles["east"].seal = timed_seal
    fc.coordinator.flip_map = timed_flip
    p1 = [j for col in (east.scheduler.pending, east.scheduler.running)
          for j in col.values() if j.spec.partition == "p1"]
    running = sum(1 for j in p1 if j.job_id in east.scheduler.running)
    t1 = time.perf_counter()
    mig = fc.migrate("p1", "west")
    mig_s = time.perf_counter() - t1
    check(mig["committed"] and mig["jobs_imported"] == len(p1)
          and running > 0 and len(p1) > running,
          f"{label}: migration {mig} of {len(p1)} ({running} running)")
    rep["migration"] = dict(mig, seconds=mig_s, running=running,
                            seal_to_flip_s=marks["flip"] - marks["seal"])
    check(len(west.meta.nodes) == 3 * per
          and len(east.meta.nodes) == 2 * per,
          f"{label}: node axes east {len(east.meta.nodes)}, west "
          f"{len(west.meta.nodes)}")
    check(all(not east.meta.nodes[n].alive
              for n in east.meta.partitions["p1"].node_ids),
          f"{label}: east's p1 rows are not dead")
    note(f"p1 moved east -> west: {len(p1)} jobs ({running} running) in "
         f"{mig_s:.1f}s, seal to flip "
         f"{rep['migration']['seal_to_flip_s']:.2f}s; west's node axis "
         f"{2 * per} -> {len(west.meta.nodes)}, east keeps "
         f"{len(east.meta.nodes)} rows (p1's dead)")

    # the next cycle on each side: west launches greedy_place on the
    # grown axis (the node rows and the class rows the kernel gets) and
    # places onto the imported nodes; east on its 5,000 rows never picks
    # the dead ones
    now += FED_ROUND_S
    fc.now = now
    for name, shard in fc.shards.items():
        sched = shard.scheduler
        axes = []
        solve = sched._immediate_solve

        def spy(avail, total, alive, cost0, batch, max_nodes,
                resident_ok=False, _solve=solve, _axes=axes):
            _axes.append((int(avail.shape[0]),
                          int(batch.class_rows_np.shape[1])))
            return _solve(avail, total, alive, cost0, batch, max_nodes,
                          resident_ok=resident_ok)

        sched._immediate_solve = spy
        t1 = time.perf_counter()
        started = shard.tick(now)
        wall = time.perf_counter() - t1
        del sched._immediate_solve
        check_ledger(sched, f"{label} {name} after the migration",
                     resident=False)
        axis = 3 * per if name == "west" else 2 * per
        on = sum(sched.meta.nodes[n].name.startswith("east-p1-")
                 for j in started for n in sched.running[j].node_ids)
        check(axes and all(a == (axis, axis) for a in axes)
              and (on > 0 if name == "west" else on == 0),
              f"{label}: {name} after the migration: kernel axes {axes} "
              f"(want {axis}), {on} placements on p1's nodes")
        last = cycle_row(name, sched, 2, started, wall)
        last.update(node_axis=axis, on_imported=on)
        note(f"{name} after the migration: placed {len(started)} on a "
             f"{axis}-row axis ({on} on p1's nodes)")
    fc.pump_usage(now)
    audit = fc.ledger_by_name(names + [f"{n}@{p}" for n in by_gang
                                       for p in gang_parts])
    check(audit["lost"] == [] and audit["doubled"] == [],
          f"{label}: lost {audit['lost'][:5]}, doubled "
          f"{audit['doubled'][:5]}")
    rep["audit"] = {k: (v if isinstance(v, int) else len(v))
                    for k, v in audit.items()}
    launches = sum(r["kernel_launches"] for rows in rep["cycles"].values()
                   for r in rows)
    check(g.greedy_place.launches == launches + twin_launches,
          f"{label}: {g.greedy_place.launches} launches; the shards' rows "
          f"{launches} + the twins' {twin_launches}")
    rep["launches_by_shard"] = {n: sum(r["kernel_launches"] for r in rows)
                                for n, rows in rep["cycles"].items()}
    rep["remote_usage"] = {n: s.scheduler.global_usage.stats()["remotes"]
                           for n, s in fc.shards.items()}
    rep["device_memory"] = sample_device_memory()
    rep["wall_s"] = time.perf_counter() - t_phase
    for name in fc.shards:
        for r in rep["cycles"][name]:
            print(f"[federation] {name} cycle {r['cycle']}: placed "
                  f"{r['placed']}, total {r['total_ms']:.0f} ms (prelude "
                  f"{r['prelude_ms']:.0f}, priority {r['priority_ms']:.0f}, "
                  f"batch {r['batch_ms']:.0f}, solve {r['solve_ms']:.0f}, "
                  f"commit {r['commit_ms']:.0f}, dispatch "
                  f"{r['dispatch_ms']:.0f}), {r['nodes']} nodes, "
                  f"greedy_place {r['kernel_launches']}", flush=True)
    note(f"done: launches by shard {rep['launches_by_shard']}, device "
         f"memory {rep['device_memory']}, every job once by name")
    return rep, launches


def fed_reserve_port():
    """A socket bound to a free port of 127.0.0.1 with ``SO_REUSEPORT``,
    which gRPC's server sets too: a shard daemon binds the port while
    the socket holds it, and no bind to port 0 elsewhere (a daemon of
    another phase, another run) is given it meanwhile.  The socket never
    listens, so it takes no connection."""
    import socket

    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
    s.bind(("127.0.0.1", 0))
    return s


class FedDaemons:
    """(b)'s two shard daemons: one ``Federation:`` YAML each (phase 12's
    cluster; only ``ShardName`` and ``Wal:`` differ), started at once;
    ``boot_s`` is each one's start to its banner, read by a watcher
    thread.  Their ports stay reserved until ``kill`` (a restarted shard
    binds its port again)."""

    def __init__(self):
        import tempfile
        import threading

        self.held = {n: fed_reserve_port() for n in FED_LAYOUT}
        self.ports = {n: s.getsockname()[1] for n, s in self.held.items()}
        self.addr = {n: f"127.0.0.1:{p}" for n, p in self.ports.items()}
        self.tmps = {n: tempfile.mkdtemp(prefix=f"crane-fed-{n}-")
                     for n in self.ports}
        fed_yaml = ["Federation:", "  ShardName: {name}", "  Limits:",
                    f"    MaxJobsPerUser: {FED_MAX_JOBS}",
                    f"    MaxSubmitJobsPerUser: {FED_MAX_SUBMIT}",
                    f"    PublishSlack: {FED_SLACK}", "  Shards:"]
        for name, parts in FED_LAYOUT.items():
            fed_yaml += [f"    - name: {name}",
                         f"      partitions: [{', '.join(parts)}]",
                         f"      address: {self.addr[name]}"]
        for name in self.ports:
            self.rng, _ = daemon_config(
                f"{self.tmps[name]}/ctld.yaml", self.tmps[name],
                extra_yaml=[line.format(name=name) for line in fed_yaml])
        self.procs = {}
        self.boot_s = {}
        self._watchers = []
        for name in self.ports:
            self.start(name, name)
            w = threading.Thread(target=self._watch, args=(name,))
            w.start()
            self._watchers.append(w)

    def _watch(self, tag):
        try:
            self.boot_s[tag] = self.procs[tag].banner()[1]
        except RuntimeError as exc:
            self.boot_s[tag] = exc

    def start(self, name, tag):
        p = DaemonProc(self.tmps[name], tag,
                       f"{self.tmps[name]}/ctld.yaml", listen=self.addr[name])
        self.procs[tag] = p
        return p

    def booted(self):
        """Both banners seen; returns each one's seconds to it."""
        for w in self._watchers:
            w.join()
        for tag, s in self.boot_s.items():
            if isinstance(s, BaseException):
                raise s
        return dict(self.boot_s)

    def kill(self):
        for p in self.procs.values():
            p.kill()
        for s in self.held.values():
            s.close()


def phase_federation_daemons():
    """(b): two ``ctld_main --sim`` shards (a ``FedDaemons``) on the card;
    returns the report and greedy_place's launches in both daemons'
    cycles (their trace rows).  Kills every daemon it ran."""
    import signal

    from cranesched_tpu_torch.fed.query import FederatedClient
    from cranesched_tpu_torch.obs.fedobs import cluster_doc
    from cranesched_tpu_torch.rpc import CtldClient, crane_pb2 as pb

    label = "federation-daemons"
    d = FedDaemons()
    addr, procs, rng = d.addr, d.procs, d.rng
    out = {"jobs": FED_DAEMON_JOBS, "limits": {
        "MaxJobsPerUser": FED_MAX_JOBS, "MaxSubmitJobsPerUser":
        FED_MAX_SUBMIT, "PublishSlack": FED_SLACK}}
    clients = []
    t_phase = time.perf_counter()

    def note(what):
        print(f"[federation:daemons] {time.perf_counter() - t_phase:.1f}s "
              f"{what}", flush=True)

    def rows(client):
        return [r for r in json.loads(client.query_stats().json)
                ["cycle_trace"] if r.get("solver") != "skip"]

    def wait(pred, what):
        deadline = time.time() + FED_WAIT_S
        while not pred():
            check(time.time() < deadline,
                  f"{label}: {what} not within {FED_WAIT_S:.0f}s; logs "
                  + " | ".join(f"{t}: {p.text('err')[-600:]}"
                               for t, p in procs.items()))
            time.sleep(0.2)

    def usage(client):
        # draw_specs name no user: the wire's default, "user"
        doc = json.loads(client.fetch_usage().payload)
        return doc["user"].get("user", {"jobs": 0, "submit_jobs": 0})

    try:
        east, west = procs["east"], procs["west"]
        specs = draw_specs(rng, FED_DAEMON_JOBS)
        for i, s in enumerate(specs):
            s.name = f"d{i:05d}"
            s.time_limit, s.sim_runtime = 86400, 1e6
        out["boot_s"] = d.booted()
        for p, n in ((east, "east"), (west, "west")):
            err = p.text("err")
            check(f"federation shard '{n}': 2 shards, map epoch 0, global "
                  "limits on" in err, f"{label}: {n} boot log {err[-800:]}")
        ce = CtldClient(addr["east"], timeout=600.0)
        cw = CtldClient(addr["west"], timeout=600.0)
        clients += [ce, cw]
        note(f"both shards up: {out['boot_s']}")

        # the lease plane over the wire, on west, before the storm
        res = pb.ResourceSpec(cpu=4.0, mem_bytes=8 << 30)
        lease = cw.lease_nodes("smoke-l1", "p2", 2, res=res, ttl=600.0)
        check(lease.ok and len(lease.node_names) == 2,
              f"{label}: LeaseNodes {lease}")
        conf = cw.confirm_gang(
            "smoke-l1", "smoke-g", pb.JobSpec(
                name="smoke-g@p2", user="gang", partition="p2",
                node_num=2, res=res, time_limit=86400, sim_runtime=1e6),
            node_names=list(lease.node_names),
            fencing_epoch=lease.fencing_epoch)
        check(conf.ok and conf.job_id > 0, f"{label}: ConfirmGang {conf}")
        lease2 = cw.lease_nodes("smoke-l2", "p3", 1, res=res, ttl=600.0)
        rel = cw.release_lease("smoke-l2")
        again = cw.release_lease("smoke-l2")
        check(lease2.ok and rel.ok and not again.ok,
              f"{label}: the release round trip {lease2} {rel} {again}")
        gang = cw.query_jobs(job_ids=[conf.job_id]).jobs[0]
        check(gang.status == "Running"
              and sorted(gang.node_names) == sorted(lease.node_names),
              f"{label}: the confirmed member {gang}")
        out["lease_round_trip"] = {"nodes": list(lease.node_names),
                                   "job_id": conf.job_id,
                                   "epoch": lease.fencing_epoch}

        # the storm: every spec to east, west's share forwarded one hop
        admitted, refused, forwarded, samples = {}, 0, 0, []
        t0 = time.perf_counter()
        for lo in range(0, len(specs), WIRE_CHUNK):
            chunk = specs[lo:lo + WIRE_CHUNK]
            reply = ce.submit_many(chunk)
            for s, r in zip(chunk, reply.replies):
                owner = "east" if s.partition in FED_LAYOUT["east"] \
                    else "west"
                check(r.shard == owner, f"{label}: {s.name} ({s.partition})"
                                        f" answered by {r.shard!r}: "
                                        f"{r.error!r}")
                if owner == "west":
                    forwarded += 1
                    check(r.redirect_address == addr["west"],
                          f"{label}: redirect hint {r.redirect_address!r}")
                if r.job_id:
                    admitted[s.name] = (owner, r.job_id)
                else:
                    refused += 1
            ue, uw = usage(ce), usage(cw)
            samples.append((ue["submit_jobs"] + uw["submit_jobs"],
                            ue["jobs"] + uw["jobs"]))
        dt = time.perf_counter() - t0
        out["submit"] = {"seconds": dt, "admitted": len(admitted),
                         "refused": refused, "forwarded": forwarded,
                         "per_s": len(specs) / dt}
        check(refused > 0 and 0 < len(admitted) <= FED_MAX_SUBMIT,
              f"{label}: the submit gate {out['submit']}")
        note(f"{len(specs)} specs to east in {dt:.1f}s: {len(admitted)} "
             f"admitted, {refused} refused by the global gate, {forwarded}"
             " forwarded to west with its redirect hint")

        # the usage gossip converges; the limits hold at every sample
        want = {n: sum(1 for o, _j in admitted.values() if o == n)
                for n in addr}
        wait(lambda: (usage(ce)["submit_jobs"], usage(cw)["submit_jobs"])
             == (want["east"], want["west"]), "the usage counts")
        wait(lambda: any(r["kernel_launches"] >= 1 for r in rows(ce))
             and any(r["kernel_launches"] >= 1 for r in rows(cw)),
             "greedy_place in a cycle of each shard")
        for _ in range(5):
            ue, uw = usage(ce), usage(cw)
            samples.append((ue["submit_jobs"] + uw["submit_jobs"],
                            ue["jobs"] + uw["jobs"]))
            time.sleep(1.0)
        check(all(s <= FED_MAX_SUBMIT and r <= FED_MAX_JOBS
                  for s, r in samples),
              f"{label}: a global limit exceeded: {samples}")
        check(max(r for _s, r in samples) > 0,
              f"{label}: nothing ran: {samples}")
        stats = {n: json.loads(c.query_stats().json)["fed"]
                 for n, c in (("east", ce), ("west", cw))}
        check(stats["east"]["usage"]["remotes"] == ["west"]
              and stats["west"]["usage"]["remotes"] == ["east"],
              f"{label}: the usage remotes {stats}")
        out["usage"] = {"samples": samples[-6:], "max_running": max(
            r for _s, r in samples), "denied": {
            n: s["usage"]["denied"] for n, s in stats.items()}}

        # the fan-out with a staleness bound
        fanc = FederatedClient.connect(addr["east"], timeout=600.0)
        check(fanc is not None, f"{label}: no federation learned")
        try:
            slices = {n: len(r.jobs) for n, r in
                      fanc.jobs(max_staleness=5.0)}
            epochs = fanc.map_epochs()
            doc = cluster_doc(fanc.stats(max_staleness=5.0),
                              max_staleness=5.0)
        finally:
            fanc.close()
        check(slices == {"east": want["east"], "west": want["west"] + 1}
              and epochs == {"east": 0, "west": 0}
              and sorted(doc["shards"]) == ["east", "west"]
              and not doc["errors"],
              f"{label}: fan-out {slices} {epochs} {doc['errors']}")
        out["fanout"] = {"jobs": slices, "map_epochs": epochs,
                         "staleness_s": {n: d["staleness_s"] for n, d in
                                         doc["shards"].items()}}

        # MigratePartition of p1 east -> west over the wire
        in_p1 = {s.name for s in specs if s.partition == "p1"}
        p1 = [n for n in admitted if n in in_p1]
        t0 = time.perf_counter()
        mig = ce.migrate_partition("p1", "west")
        out["migration"] = {"seconds": time.perf_counter() - t0,
                            "jobs": mig.jobs_moved, "mid": mig.mid,
                            "map_epoch": mig.map_epoch}
        check(mig.ok and mig.jobs_moved == len(p1) and mig.map_epoch == 1
              and cw.query_shard_map().map_epoch == 1,
              f"{label}: MigratePartition {mig} of {len(p1)}")
        late = ce.submit(pb.JobSpec(name="late", partition="p1",
                                    res=res, sim_runtime=1e6,
                                    time_limit=86400))
        check(late.shard == "west" and late.map_epoch == 1,
              f"{label}: a p1 submit to east after the flip {late}")
        note(f"p1 migrated east -> west over MigratePartition: "
             f"{mig.jobs_moved} jobs in {out['migration']['seconds']:.1f}s, "
             f"map epoch 1 on both")
        launches = {"east": sum(r["kernel_launches"] for r in rows(ce))}

        # SIGKILL west and restart it from its WAL (and snapshot)
        names_before = {j.name for c in (ce, cw)
                        for j in c.query_jobs(include_history=True).jobs}
        launches["west_before_kill"] = sum(r["kernel_launches"]
                                           for r in rows(cw))
        cw.close()
        clients.remove(cw)
        west.proc.send_signal(signal.SIGKILL)
        west.proc.wait(timeout=60)
        west2 = d.start("west", "west2")
        out["restart_to_banner_s"] = west2.banner()[1]
        cw = CtldClient(addr["west"], timeout=600.0)
        clients.append(cw)
        q = cw.migrate_partition("", "", phase="query", mid=mig.mid)
        check(q.ok and q.adopted and q.jobs_moved == mig.jobs_moved,
              f"{label}: the restarted dest's import {q}")
        jobs = [j for c in (ce, cw)
                for j in c.query_jobs(include_history=True).jobs]
        by_name = {}
        for j in jobs:
            by_name[j.name] = by_name.get(j.name, 0) + 1
        twice = [n for n, k in by_name.items() if k > 1]
        missing = sorted(set(admitted) - set(by_name))
        check(not twice and not missing and set(by_name) == names_before,
              f"{label}: after the restart {len(twice)} twice "
              f"({twice[:5]}), {len(missing)} missing ({missing[:5]})")
        west_p1 = sum(1 for j in cw.query_jobs(partition="p1").jobs)
        check(west_p1 == len(p1) + (1 if late.job_id else 0),
              f"{label}: west holds {west_p1} p1 jobs after the restart")
        wait(lambda: any(r["kernel_launches"] >= 1 for r in rows(cw)),
             "greedy_place in the restarted west's cycles")
        launches["west"] = launches.pop("west_before_kill") + sum(
            r["kernel_launches"] for r in rows(cw))
        devices = {r["device"] for c in (ce, cw) for r in rows(c)}
        check(devices == {DEVICE}, f"{label}: cycle devices {devices}")
        out["launches_by_shard"] = launches
        note(f"west SIGKILLed and restarted in "
             f"{out['restart_to_banner_s']:.1f}s: the imported partition "
             f"back ({west_p1} p1 jobs), every one of {len(by_name)} jobs "
             f"once by name; greedy_place {launches}")
        for c in clients:
            c.close()
        clients.clear()
        out["stop_s"] = {"east": east.stop(), "west": west2.stop()}
    finally:
        for c in clients:
            c.close()
        d.kill()
    out["wall_s"] = time.perf_counter() - t_phase
    return out, launches["east"] + launches["west"]


# ---------------------------------------------------------------------------
# 17. the BASELINE replays (replay.py) on the card, and the crane commands
# (cli.py) against phase 12 (a)'s server
# ---------------------------------------------------------------------------

REPLAY_SEED = 0
REPLAY_FIFO_SCALE = 1.0       # (a): BASELINE config #1 at its full shape
# (b): the other configurations at a cut scale (a depth cut for the run's
# time limit, PERF.md §4: backfill's head and topo's gang solve are
# per-job loops, ~94 and ~103 s alone at 0.1 and 1.0), the closed loops
# at REPLAY_r06-r08's scales
REPLAY_SCALES = {"minload": 0.03, "backfill": 0.02, "gres": 0.1,
                 "qos": 0.05, "topo": 0.05}
REPLAY_SLO = ("backfill", 0.05)
REPLAY_FED_SCALE = 0.25
# the fields of a replay's result measured on the host's clock
REPLAY_WALL = frozenset({"wall_s", "jobs_per_wall_s", "submit_wall_s",
                         "submit_jobs_per_s", "cycle_ms_mean",
                         "cycle_ms_p99", "cycle_ms_max"})


def replay_recorded(sched, sim, specs, run, **kw):
    """``run(sched, sim, specs, **kw)`` (a mode of ``replay``) with every
    trace row's greedy_place launches summed as the rows are pushed (the
    ring keeps only the newest), every timeline kept, and the result
    given ``_trace`` (rows, launches, devices), ``_ledger`` (the job
    trace's lost and doubled jobs) and ``_digest`` (a SHA-256 over every
    finished job's id, status, start, end and node ids, in id order)."""
    import hashlib

    rows = {"rows": 0, "launches": 0, "devices": set()}
    push = sched.cycle_trace.push

    def counted(trace):
        rows["rows"] += 1
        if trace.get("solver") != "skip":   # a skipped cycle ran nothing
            rows["launches"] += trace["kernel_launches"]
            rows["devices"].add(trace["device"])
        push(trace)

    sched.cycle_trace.push = counted
    sched.jobtrace.capacity = max(sched.jobtrace.capacity, 4 * len(specs))
    out = run(sched, sim, specs, **kw)
    ledger = sched.jobtrace.ledger(sorted(sched.history))
    digest = hashlib.sha256()
    for jid in sorted(sched.history):
        j = sched.history[jid]
        digest.update(repr((jid, j.status.value, j.start_time, j.end_time,
                            list(j.node_ids))).encode())
    rows["devices"] = sorted(map(str, rows["devices"]))
    out["_trace"] = rows
    out["_ledger"] = {"lost": len(ledger["lost"]),
                      "doubled": len(ledger["doubled"]),
                      "checked": ledger["checked"], "specs": len(specs)}
    out["_digest"] = digest.hexdigest()
    return out


def replay_fifo_rpc(device, tmp):
    """(a): ``replay fifo --scale 1.0 --rpc --wal <tmp>/fifo.wal`` from
    ``REPLAY_SEED`` on ``device``, recorded (``replay_recorded``)."""
    import functools
    import os

    from cranesched_tpu_torch import replay

    run = functools.partial(replay_recorded, run=replay._run_rpc,
                            wal_path=os.path.join(tmp, "fifo.wal"))
    return replay.replay_fifo(REPLAY_FIFO_SCALE,
                              np.random.default_rng(REPLAY_SEED), run=run,
                              device=device)


def replay_fifo_cpu(label):
    """(a)'s CPU run, in a worker process: the same replay from the same
    seed in the same mode on ``device="cpu"``."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="crane-replay-cpu-")
    try:
        t0 = time.perf_counter()
        out = replay_fifo_rpc("cpu", tmp)
        out["_seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def phase_replay():
    """(a) and (b) on the card, in a process of its own; returns the report
    (each leg's result, wall time and launches) and greedy_place's
    launches over all legs (the wrapper's count, which this process
    zeroes before each leg; where the leg has one scheduler, its trace
    rows must say the same)."""
    import functools
    import os
    import shutil
    import tempfile

    from cranesched_tpu_torch import replay
    from cranesched_tpu_torch.models import gpu_solver as g

    label = "replay"
    tmp = tempfile.mkdtemp(prefix="crane-replay-")
    out = {"legs": {}}
    t_phase = time.perf_counter()

    def leg(name, call, kernel=True):
        """Run ``call()``; ``kernel``: whether greedy_place must launch
        (True), must not (False) or may (None)."""
        g.greedy_place.launches = 0
        t0 = time.perf_counter()
        r = call()
        wall = time.perf_counter() - t0
        n = g.greedy_place.launches
        check(kernel in (None, n >= 1),
              f"{label} {name}: greedy_place launched {n} times (want "
              f"{ {True: 'some', False: 'none', None: 'any'}[kernel]})")
        check(r["completed"] >= 0.95 * r["jobs_finished"] > 0,
              f"{label} {name}: {r['completed']} of {r['jobs_finished']} "
              "completed")
        if "_trace" in r:       # one scheduler, recorded
            trace, ledger = r["_trace"], r["_ledger"]
            check(trace["launches"] == n and trace["devices"] == [DEVICE],
                  f"{label} {name}: greedy_place {n}, trace rows {trace}")
            check(ledger["lost"] == ledger["doubled"] == 0
                  and ledger["checked"] == ledger["specs"]
                  == r["jobs_finished"],
                  f"{label} {name}: ledger {ledger}, {r['jobs_finished']} "
                  "finished")
        res = {k: v for k, v in r.items() if not k.startswith("_")}
        res.update(wall_s_leg=wall, launches=n,
                   ledger_audit=r.get("_ledger"))
        out["legs"][name] = res
        print(f"[{label}] {name}: {wall:.1f}s, {r['jobs_finished']} "
              f"finished, {r['completed']} completed, {r['cycles']} "
              f"cycles, greedy_place {n}; "
              f"{time.perf_counter() - t_phase:.1f}s into the phase",
              flush=True)
        return r

    def config(name, scale, run, **kw):
        return lambda: replay.CONFIGS[name](
            scale, np.random.default_rng(REPLAY_SEED),
            run=functools.partial(replay_recorded, run=run, **kw),
            device=DEVICE)

    def splits(name, scale):
        """Whether the configuration's cycles launch greedy_place: the
        immediate ones do; backfill's do not while its candidates fit the
        head (at most ``backfill_max_jobs``, 1,024; replay_backfill draws
        5,000 x scale jobs), which places them all through the time-axis
        solve; topo's only in a cycle with no gang among its candidates
        (a gang sends the cycle through the best-fit-block solve), so
        either way (None)."""
        if name == "topo":
            return None
        return name != "backfill" or int(5000 * scale) > 1024

    try:
        # (a) BASELINE config #1 at 10,000 jobs x 1,000 nodes through
        # gRPC, the WAL and Tick
        r = leg("fifo", lambda: replay_fifo_rpc(DEVICE, tmp))
        n_jobs = max(int(10_000 * REPLAY_FIFO_SCALE), 20)
        check(r["mode"] == "rpc+wal"
              and r["jobs_submitted"] == r["jobs_finished"]
              == r["completed"] == n_jobs,
              f"{label} fifo: {r['jobs_submitted']} submitted, "
              f"{r['jobs_finished']} finished, {r['completed']} completed")
        out["fifo_digest"] = r["_digest"]
        out["fifo_unwalled"] = {k: v for k, v in r.items()
                                if k not in REPLAY_WALL
                                and not k.startswith("_")}
        out["fifo_rows"] = r["_trace"]["rows"]

        # (b) the other configurations, direct, at their cut scales
        for name, scale in REPLAY_SCALES.items():
            r = leg(name, config(name, scale, replay._run_direct),
                    kernel=splits(name, scale))
            if name == "topo":
                check(r["topo_in_block_gangs"] > 0,
                      f"{label} topo: no gang placed in one block")

        # the closed loop on backfill at REPLAY_r06's scale
        name, scale = REPLAY_SLO
        r = leg(f"{name}-slo",
                config(name, scale, replay._run_closed_loop,
                       wal_path=os.path.join(tmp, "slo.wal")),
                kernel=splits(name, scale))
        check(r["slo_assert"]["ok"], f"{label} slo: {r['slo_assert']}")

        # the federation drills at REPLAY_r07/r08's scale; their shards
        # run SchedulerConfig(), whose cycles at this depth fit the
        # backfill head, so greedy_place may not launch
        for name, drill in (("federation", replay.replay_federation),
                            ("rebalance", replay.replay_rebalance)):
            r = leg(name, functools.partial(
                drill, REPLAY_FED_SCALE, np.random.default_rng(REPLAY_SEED),
                device=DEVICE), kernel=None)
            audit = r["ledger"] if name == "federation" else r["audit"]
            check(r["ok"] and audit["lost"] == audit["doubled"] == 0,
                  f"{label} {name}: ok {r['ok']}, {audit}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["wall_s"] = time.perf_counter() - t_phase
    out["launches"] = sum(v["launches"] for v in out["legs"].values())
    return out, out["launches"]


def same_replay(label, card, cpu):
    """(a) on the card equals its CPU run on every non-wall field and on
    the job digest."""
    want = {k: v for k, v in cpu.items()
            if k not in REPLAY_WALL and not k.startswith("_")}
    check(card["fifo_unwalled"] == want,
          f"{label}: fifo on the card {card['fifo_unwalled']} != on the "
          f"CPU {want}")
    check(card["fifo_digest"] == cpu["_digest"],
          f"{label}: the finished jobs' digest differs from the CPU run's")
    check(card["fifo_rows"] == cpu["_trace"]["rows"],
          f"{label}: {card['fifo_rows']} trace rows, the CPU run "
          f"{cpu['_trace']['rows']}")
    print(f"[{label}] fifo at its full shape over rpc+wal == its CPU run "
          f"({cpu['_seconds']:.1f}s in a worker): every non-wall field, "
          f"{cpu['jobs_finished']} jobs' (id, status, start, end, nodes) "
          f"digest {cpu['_digest'][:16]}", flush=True)


def _table(text):
    """A ``_fmt_table`` printout as dicts by header (each column starts
    where its header word does)."""
    import re

    lines = text.splitlines()
    head = lines[0]
    starts = [m.start() for m in re.finditer(r"\S+", head)]
    names = head.split()
    bounds = list(zip(starts, starts[1:] + [None]))
    return [{n: row[a:b].strip() for n, (a, b) in zip(names, bounds)}
            for row in lines[1:] if not row.startswith("#")]


def cli_vs_twin(label, addr, twin, twin_srv):
    """The crane commands in this process against phase 12 (a)'s server
    after its ticks and cancels, each against the twin; then ``cqueue``
    as a process of its own, which must load no torch."""
    import collections
    import contextlib
    import io
    import os
    import subprocess

    from cranesched_tpu_torch import cli
    from cranesched_tpu_torch.rpc import crane_pb2 as pb

    out = {}

    def crane(*argv, want=0):
        buf, err = io.StringIO(), io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            rc = cli.main(["--server", addr, *argv])
        out[argv[0]] = time.perf_counter() - t0
        check(rc == want, f"{label}: crane {' '.join(argv)} exited {rc}: "
                          f"{err.getvalue()[-300:]}")
        return buf.getvalue() if rc == 0 else err.getvalue()

    jobs = twin_srv.QueryJobsInfo(pb.QueryJobsRequest(), None).jobs
    rows = _table(crane("cqueue"))
    check(collections.Counter(r["STATE"] for r in rows)
          == collections.Counter(j.status for j in jobs)
          and [int(r["JOBID"]) for r in rows] == [j.job_id for j in jobs],
          f"{label}: cqueue's jobs by state differ from the twin's")
    nodes = twin_srv.QueryClusterInfo(pb.QueryClusterRequest(), None).nodes
    rows = _table(crane("cinfo"))
    check(collections.Counter(r["STATE"] for r in rows)
          == collections.Counter(n.state for n in nodes)
          and len(rows) == len(nodes) == N_NODES,
          f"{label}: cinfo's nodes by state differ from the twin's")
    doc = json.loads(crane("cstats"))
    for key in ("cycles", "jobs_started_total", "jobs_submitted_total",
                "jobs_finished_total"):
        check(doc[key] == twin.stats[key], f"{label}: cstats {key}")
    summary = twin_srv.QueryJobSummary(pb.QueryJobSummaryRequest(), None)
    text = crane("csummary")
    check({r["STATE"]: int(r["COUNT"]) for r in _table(text)}
          == {s.status: s.count for s in summary.states}
          and f"# total {summary.total}" in text,
          f"{label}: csummary differs from the twin's summary")
    pending = [j for j in jobs if j.status == "Pending"]
    jid = pending[len(pending) // 2].job_id
    head = crane("cexplain", str(jid)).splitlines()[0]
    reason = twin_srv.QueryJobsInfo(pb.QueryJobsRequest(job_ids=[jid]),
                                    None).jobs[0].pending_reason
    check(head.endswith(f"pending_reason={reason}"),
          f"{label}: cexplain {jid} says {head!r}, the twin {reason}")
    events = [e["seq"] for e in twin.events.since()]
    text = crane("cevents", want=0 if events else 1)
    seqs = ([int(r["SEQ"]) for r in _table(text)] if events
            else [] if text == "no matching events\n" else None)
    check(seqs == events, f"{label}: cevents' seqs differ from the twin's")

    # cqueue as a process of its own: its wall time, and no torch loaded
    root = os.path.dirname(os.path.abspath(__file__))
    wrapper = ("import sys\n"
               "from cranesched_tpu_torch import cli\n"
               "rc = cli.main(sys.argv[1:])\n"
               "print('torch loaded:', 'torch' in sys.modules, "
               "file=sys.stderr)\n"
               "sys.exit(rc)\n")
    procs = {}
    for kind, cmd in (("python -m", ["-m", "cranesched_tpu_torch.cli"]),
                      ("python -c", ["-c", wrapper])):
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, *cmd, "--server", addr,
                            "cqueue"], cwd=root, capture_output=True,
                           text=True, timeout=DAEMON_WAIT_S)
        procs[kind] = time.perf_counter() - t0
        check(p.returncode == 0, f"{label}: {kind} cqueue exited "
                                 f"{p.returncode}: {p.stderr[-300:]}")
        check(len(p.stdout.splitlines()) == len(jobs) + 1,
              f"{label}: {kind} cqueue printed "
              f"{len(p.stdout.splitlines())} lines")
    check(p.stderr.splitlines()[-1] == "torch loaded: False",
          f"{label}: the crane command loaded torch: {p.stderr[-200:]}")
    out = {"in_process_s": out, "subprocess_s": procs,
           "jobs": len(jobs), "nodes": len(nodes), "explained": jid,
           "reason": reason, "events": len(events)}
    print(f"[{label}] crane cqueue/cinfo/cstats/csummary/cexplain/cevents "
          f"in process == twin ({len(jobs)} jobs, {len(nodes)} nodes, "
          f"job {jid} pends {reason}, {len(events)} events): "
          f"{json.dumps(out['in_process_s'])}; cqueue as a process "
          f"{json.dumps(procs)}, no torch loaded", flush=True)
    return out


def main() -> int:
    try:
        return run()
    finally:
        import gc
        from multiprocessing import resource_tracker, util

        if _pool is not None:
            _pool.shutdown(wait=True, cancel_futures=True)
        # multiprocessing's exit handler runs now, while the pools'
        # resource tracker lives: it unlinks and unregisters every
        # semaphore the pools made, so that none is left to relaunch a
        # tracker at interpreter exit.  Then the tracker is stopped and
        # reaped here: one that ended after this process would have no
        # parent left to reap it.
        gc.collect()
        util._exit_function()
        resource_tracker._resource_tracker._stop()
        left = stop_marked(trackers=True)
        if left:
            print(f"[exit] stopped {len(left)} processes this run left: "
                  f"{left[:20]}", file=sys.stderr, flush=True)


def run() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    mark_processes()
    from cranesched_tpu_torch.kernels import build
    from cranesched_tpu_torch.tools import kattr

    # 1. device
    kind = torch.cuda.get_device_name(0)
    card = kattr.card_line()
    print(f"[device] {kind} | nvidia-smi: {card} | torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)

    # 2. build: the kernels (one nvcc each) and, beside them, the native
    # solver library of phase 11 (g++)
    import threading

    from cranesched_tpu_torch.utils import native

    t0 = time.perf_counter()
    nat = {}
    gxx = threading.Thread(target=lambda: nat.update(
        ok=native.available(), seconds=time.perf_counter() - t0))
    gxx.start()
    report = build.build_all()
    gxx.join()
    check(nat["ok"], "the native library did not build")
    print(f"[build] {time.perf_counter() - t0:.2f}s "
          + ", ".join(f"{k}: {v['seconds']:.2f}s" for k, v in
                      report.items())
          + f", crane_native (g++): {nat['seconds']:.2f}s", flush=True)
    for name, v in report.items():
        for line in v["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}", flush=True)

    # 17 (a)'s CPU run: the longest check, so the first in the workers
    cpu_check("replay fifo cpu", replay_fifo_cpu)

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"[phase] {name} {time.perf_counter() - t0:.1f}s", flush=True)
        return out

    # 3. kernel vs plain
    kres = timed("kernel-vs-plain", phase_kernels)
    head = timed("backfill-head kernel-vs-plain", phase_backfill_head)

    # 4. the attribution kernels and the attribution tool's path
    ares = timed("kattr", phase_attribution)

    # 5. the immediate-fit path, on disjoint and on overlapping partitions
    cycles, paths = [], {"immediate": 0}
    for overlap in (False, True):
        rows, n = timed(f"immediate overlap={overlap}", phase_cycle, overlap)
        cycles += rows
        paths["immediate"] += n

    # 6. the default path: split backfill cycles
    head_paths = {}
    rows, paths["backfill_tail"], head_paths["backfill"] = timed(
        "backfill", phase_backfill)
    cycles += rows
    ref_commit_ms = rows[0]["commit_ms"]

    # 7. topology: the block-major tail, then the gang cycle
    rows, paths["topo_tail"] = timed("topo single-node", phase_topo_single)
    cycles += rows + timed("topo gangs", phase_topo_gangs)

    # 8. packed and exclusive jobs
    cycles += timed("packed", phase_packed)

    # 9. preemption, with backfill (timed what-if) and without
    for backfill in (True, False):
        rows, n, n_head = timed(f"preempt backfill={backfill}",
                                phase_preempt, backfill)
        cycles += rows
        paths["preempt_" + ("backfill_tail" if backfill
                            else "immediate")] = n
        if backfill:
            head_paths["preempt_backfill"] = n_head

    # 10. the job lifecycle and a restart from the WAL
    rows, paths["lifecycle"], life = timed("lifecycle", phase_lifecycle,
                                           ref_commit_ms)
    cycles += rows
    print(json.dumps({"lifecycle": life}), flush=True)

    # 11. the observability planes, and the JAX package's solver names
    obs, obs_paths, twin = timed("obs", phase_obs)
    paths.update(obs_paths)
    native_rep = timed("native", phase_native, twin)
    native_rep["cuda_solve_ms"] = obs["immediate"]["cold"]["solve_ms"]

    # 12. the controller daemon over gRPC: (a) the service in tick mode
    # against an in-process twin here; (b) the daemon with a restart
    # runs beside phase 16 (below)
    service, paths["rpc_ticks"] = timed("controller", phase_service)

    # 13. the CPU checks the phases left to the worker processes
    t0 = time.perf_counter()
    results = {label: f.result() for label, f in _checks.items()}
    print(f"[cpu-checks] all {len(results)} passed in {CPU_WORKERS} worker "
          f"processes: {sorted(results)}; waited "
          f"{time.perf_counter() - t0:.1f}s after the last phase", flush=True)
    if _pool is not None:
        _pool.shutdown(wait=True)

    # 14. the real node plane, once the workers are gone: its craneds,
    # supervisors and jobs are real processes on this host
    node_plane, paths["node_plane_cycles"] = timed(
        "node-plane", phase_node_plane,
        service["ticks"][-1]["solve_head_ms"])

    # 15. scale-out: the sharded, multi-process, speculative and blocked
    # solves, and the sharded cycle against phase 11's twin; (e), a hot
    # standby's promotion on the card, runs beside phase 16 (below)
    scaleout = timed("scaleout", lambda: {
        "solves": phase_scaleout_solves(),
        "sharded_cycle": sharded_cycle(twin)})

    # 16. federation: (a) two shards in one process on the card (the
    # arbiter, the usage gossip, a crash drill and a live migration);
    # beside it, each in a process of its own (their daemons are
    # processes too, and their clients then share no interpreter lock
    # with (a)): (b) two shard daemons over gRPC, phase 12's daemon leg
    # and phase 15's failover drill
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    side = ProcessPoolExecutor(
        max_workers=4, mp_context=multiprocessing.get_context("spawn"))
    try:
        fed_b_f = side.submit(phase_federation_daemons)
        daemon_f = side.submit(phase_daemon)
        failover_f = side.submit(failover_drill)
        # 17 (a) and (b): the replays on the card
        replay_f = side.submit(phase_replay)
        fed_a, paths["federation"] = timed("federation", phase_federation)
        t0 = time.perf_counter()
        (fed_b, paths["federation_daemons"]), daemon, failover = (
            fed_b_f.result(), daemon_f.result(), failover_f.result())
        replays, paths["replay"] = replay_f.result()
        print(f"[phase] beside the federation: its shard daemons, the "
              f"daemon leg, the failover drill and the replays, waited "
              f"{time.perf_counter() - t0:.1f}s after it (the replays "
              f"took {replays['wall_s']:.1f}s)", flush=True)
    finally:
        side.shutdown(wait=True, cancel_futures=True)
    same_replay("replay", replays, results["replay fifo cpu"])
    fed = {"in_process": fed_a, "daemons": fed_b}
    head_stretch(daemon, service["ticks"][-1]["solve_head_ms"])
    controller = {"service": service, "daemon": daemon,
                  "transport": "grpc over 127.0.0.1"}
    paths["daemon_cycles"] = daemon["launches"]
    scaleout["failover"] = failover
    paths["failover_cycles"] = failover["launches"]
    launches = sum(paths.values())
    for r in (kres["stream"], kres["serial"]):
        r["max_abs_err"], r["plain_s"] = results[r["check"]]
    topo_err = results["topo-single permuted tail"]

    st, se = kres["stream"], kres["serial"]
    kernels = [{
        "name": "greedy_place",
        "route": "cuda",
        "source": "cranesched_tpu_torch/csrc/greedy_place.cu",
        "replaces": "cranesched_tpu/models/pallas_solver.py:89",
        "jax_function": "cranesched_tpu.models.pallas_solver."
                        "solve_greedy_pallas_auto",
        "launches": launches,
        "launches_by_path": paths,
        "match": "bitwise",
        "max_abs_err": max(st["max_abs_err"], se["max_abs_err"], topo_err),
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
    kernels.append({
        "name": "backfill_head",
        "route": "cuda",
        "source": "cranesched_tpu_torch/csrc/backfill_head.cu",
        "replaces": None,
        "jax_function": "cranesched_tpu.models.solver_time.solve_backfill",
        "launches": sum(head_paths.values()),
        "launches_by_path": head_paths,
        "match": "bitwise",
        "max_abs_err": 0,
        "ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "plain_device": "cuda",
        "bound_ms": head["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": {f: head[f] for f in ("N", "T", "J", "K")},
        "launch": {f: head[f] for f in ("blocks", "slice", "words", "state",
                                        "smem_bytes")},
    })
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
    print(json.dumps({"obs": obs}), flush=True)
    print(json.dumps({"native": native_rep}), flush=True)
    print(json.dumps({"controller": controller}), flush=True)
    print(json.dumps({"node_plane": node_plane}), flush=True)
    print(json.dumps({"scaleout": scaleout}), flush=True)
    print(json.dumps({"federation": fed}), flush=True)
    print(json.dumps({"replay": {
        "fifo_cpu_s": results["replay fifo cpu"]["_seconds"],
        "cli": service["cli"], **replays}}), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f}s", flush=True)
    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
