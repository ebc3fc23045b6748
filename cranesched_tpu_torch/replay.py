"""Replay harness: the five BASELINE.json benchmark configurations as
runnable end-to-end workloads (SURVEY.md §7 artifact 3 — "trace
generators for the five BASELINE.json configs, differential tests").

Each config builds a cluster + job trace, drives it through the full
control plane on the simulated node plane (virtual clock — drain time is
measured in cycles, not wall seconds), and reports scheduling metrics:

    python -m cranesched_tpu_torch.replay fifo --scale 0.1
    python -m cranesched_tpu_torch.replay all --scale 0.02 --json

Configs (full-scale shapes from BASELINE.md):
  fifo        FIFO, 10k jobs x 1k nodes, cpu+mem
  minload     MinCpuTimeRatioFirst order, 50k jobs x 5k nodes,
              multi-partition
  backfill    priority + backfill around long blockers
  gres        GRES gang jobs (gpu slots + multi-node gangs)
  qos         QoS/fair-share mix with run limits (scaled from the 1M
              trace shape)
  topo        gang-heavy mix on a generated torus (topology-aware
              best-fit-block placement; not part of BASELINE.json)

The port's copy of ``cranesched_tpu/replay.py``, with the port's
imports.  Every scheduler it builds runs on ``device`` (None, the
default, is the CUDA card, and raises without one; ``--device cpu`` on
the command line), so each replay cycle's greedy solve launches
greedy_place on the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _build(num_nodes, cpu, mem_gb, layout_gres=(), partitions=("default",),
           accounts=None, config_kw=None, device=None):
    from cranesched_tpu_torch.craned.sim import SimCluster
    from cranesched_tpu_torch.ctld.meta import MetaContainer
    from cranesched_tpu_torch.ctld.scheduler import (
        JobScheduler, SchedulerConfig)
    from cranesched_tpu_torch.ops.resources import ResourceLayout

    meta = MetaContainer(ResourceLayout.from_gres_names(list(layout_gres)))
    for i in range(num_nodes):
        part = partitions[i % len(partitions)]
        gres = ({("gpu", "a100"): 4} if layout_gres and i % 2 == 0
                else None)
        meta.add_node(
            f"n{i:05d}",
            meta.layout.encode(cpu=cpu, mem_bytes=mem_gb << 30,
                               memsw_bytes=mem_gb << 30, gres=gres,
                               is_capacity=True),
            partitions=(part,))
        meta.craned_up(i)
    sched = JobScheduler(meta, SchedulerConfig(**(config_kw or {})),
                         accounts=accounts, device=device)
    sim = SimCluster(sched)
    sim.wire(sched)
    return meta, sched, sim


def _drain(sched, sim, max_cycles=100_000):
    t0 = time.perf_counter()
    end = sim.run_until_drained(start=0.0, max_cycles=max_cycles)
    wall = time.perf_counter() - t0
    total = len(sched.history)
    return dict(
        jobs_finished=total,
        completed=sum(1 for j in sched.history.values()
                      if j.status.value == "Completed"),
        virtual_drain_s=end,
        wall_s=round(wall, 3),
        cycles=sched.stats["cycles"],
        skipped_cycles=sched.stats.get("skipped_cycles", 0),
        jobs_per_wall_s=round(total / wall, 1) if wall else 0.0,
    )


def _run_direct(sched, sim, specs, max_cycles=100_000):
    """Library-call path: submit synchronously, drain on the virtual
    clock (the round-1..3 replay shape)."""
    for spec in specs:
        sched.submit(spec, now=0.0)
    return _drain(sched, sim, max_cycles=max_cycles)


def _run_rpc(sched, sim, specs, wal_path: str | None = None,
             max_cycles=100_000):
    """The FULL control-plane path (VERDICT r3 #10): every job enters
    through SubmitBatchJobs over gRPC, lands in the WAL, is placed by
    the cycle, and dispatches to the sim plane; cycles advance through
    the Tick RPC."""
    from cranesched_tpu_torch.ctld.wal import WriteAheadLog
    from cranesched_tpu_torch.rpc import CtldClient, serve
    from cranesched_tpu_torch.rpc.convert import spec_to_pb

    specs = [spec_to_pb(s) for s in specs]
    if wal_path:
        # fresh WAL per run: the log opens append-mode, and replay
        # configs restart job ids at 1 — mixing runs in one file would
        # merge unrelated benchmarks under last-writer-wins
        open(wal_path, "w").close()
        sched.wal = WriteAheadLog(wal_path)
    server, port = serve(sched, sim=sim, tick_mode=True)
    client = CtldClient(f"127.0.0.1:{port}", timeout=300.0)
    t0 = time.perf_counter()
    submitted = 0
    for lo in range(0, len(specs), 1000):
        replies = client.submit_many(specs[lo:lo + 1000]).replies
        submitted += sum(1 for r in replies if r.job_id)
    t_submit = time.perf_counter() - t0
    cycle_ms = []
    now = 0.0
    try:
        for _ in range(max_cycles):
            c0 = time.perf_counter()
            client.tick(now)
            cycle_ms.append((time.perf_counter() - c0) * 1e3)
            if not sched.running and not sched.pending:
                break
            now += 1.0
    finally:
        client.close()
        server.stop()
        if sched.wal is not None:
            sched.wal.close()
            sched.wal = None
    wall = time.perf_counter() - t0
    total = len(sched.history)
    arr = np.asarray(cycle_ms) if cycle_ms else np.zeros(1)
    return dict(
        mode="rpc+wal" if wal_path else "rpc",
        jobs_submitted=submitted,
        submit_wall_s=round(t_submit, 3),
        submit_jobs_per_s=round(submitted / t_submit, 1)
        if t_submit else 0.0,
        jobs_finished=total,
        completed=sum(1 for j in sched.history.values()
                      if j.status.value == "Completed"),
        virtual_drain_s=now,
        wall_s=round(wall, 3),
        cycles=len(cycle_ms),
        cycle_ms_mean=round(float(arr.mean()), 2),
        cycle_ms_p99=round(float(np.percentile(arr, 99)), 2),
        cycle_ms_max=round(float(arr.max()), 2),
        jobs_per_wall_s=round(total / wall, 1) if wall else 0.0,
    )


# SLO targets for the closed-loop mode (virtual-clock seconds).  The
# windows are sized to the replay drains (hundreds to thousands of
# virtual seconds) so the final evaluate() still sees every sample;
# the queue-wait target is deliberately loose — the assertion is about
# the plumbing (gauges exported, burn math running), not queue policy.
REPLAY_SLOS = (
    ("submit-to-start", "submit", "step_start", 99.0, 86400.0,
     (3600.0, 86400.0)),
    ("commit-to-node", "committed_durable", "craned_received", 99.0,
     5.0, (3600.0, 86400.0)),
)


def _run_closed_loop(sched, sim, specs, wal_path: str | None = None,
                     max_cycles=100_000):
    """SLO-asserted closed loop (REPLAY_r06): the full RPC path, after
    which the run audits itself from its own telemetry — the timeline
    ledger proves no job was lost or double-finalized, every finished
    job's span sum matches the wall clock within its recorded skew
    bound, and the burn-rate gauges are live on /metrics."""
    from cranesched_tpu_torch.obs.metrics import REGISTRY
    from cranesched_tpu_torch.obs.slo import SloEngine

    if sched.jobtrace is None:
        raise RuntimeError("closed-loop replay needs JobTrace on")
    eng = SloEngine.from_config(REPLAY_SLOS)
    sched.slo_engine = eng
    sched.jobtrace.slo = eng
    # the audit reads every timeline back, so the rings must outlive
    # the whole trace (the default capacity is sized for a live ctld)
    sched.jobtrace.capacity = max(sched.jobtrace.capacity,
                                  4 * len(specs))
    out = _run_rpc(sched, sim, specs, wal_path=wal_path,
                   max_cycles=max_cycles)

    ids = sorted(sched.history)
    ledger = sched.jobtrace.ledger(ids)
    checked = matched = 0
    worst = 0.0
    for jid, job in sched.history.items():
        doc = sched.jobtrace.timeline(jid)
        if (doc is None or job.end_time is None
                or job.submit_time is None):
            continue
        first = doc["incarnations"][0]["spans"]
        last = doc["incarnations"][-1]["spans"]
        t_submit = next((s["t"] for s in first
                         if s["edge"] == "submit"), None)
        t_end = next((s["t"] for s in last if s["edge"] == "end"),
                     None)
        if t_submit is None or t_end is None:
            continue
        skew = max((s.get("skew", 0.0)
                    for inc in doc["incarnations"]
                    for s in inc["spans"]), default=0.0)
        err = abs((t_end - t_submit)
                  - (job.end_time - job.submit_time))
        checked += 1
        worst = max(worst, err)
        if err <= skew + 1e-6:
            matched += 1
    table = eng.evaluate(sim.now)
    text = REGISTRY.expose()
    out["slo_assert"] = {
        "ledger": ledger,
        "span_sum_checked": checked,
        "span_sum_matched": matched,
        "span_sum_worst_err_s": round(worst, 6),
        "slo": table,
        "burn_gauge_exported": "crane_slo_burn_rate" in text,
        "latency_hist_exported": "crane_job_latency_seconds" in text,
        "ok": bool(
            not ledger["lost"] and not ledger["doubled"]
            and checked == len(ids) and matched == checked
            and "crane_slo_burn_rate" in text
            and "crane_job_latency_seconds" in text),
    }
    return out


def replay_fifo(scale: float, rng, run=_run_direct, device=None):
    """BASELINE config #1: FIFO 10k jobs x 1k nodes (cpu+mem)."""
    from cranesched_tpu_torch.ctld.defs import JobSpec, ResourceSpec
    n_nodes = max(int(1000 * scale), 4)
    n_jobs = max(int(10_000 * scale), 20)
    meta, sched, sim = _build(
        n_nodes, cpu=16, mem_gb=64,
        config_kw=dict(priority_type="basic", backfill=False),
        device=device)
    specs = [JobSpec(
        res=ResourceSpec(cpu=float(rng.integers(1, 9)),
                         mem_bytes=int(rng.integers(1, 17)) << 30,
                         memsw_bytes=int(rng.integers(1, 17)) << 30),
        time_limit=3600,
        sim_runtime=float(rng.integers(10, 300)))
        for _ in range(n_jobs)]
    return run(sched, sim, specs)


def replay_minload(scale: float, rng, run=_run_direct, device=None):
    """BASELINE config #2: MinCpuTimeRatioFirst, 50k x 5k,
    multi-partition."""
    from cranesched_tpu_torch.ctld.defs import JobSpec, ResourceSpec
    n_nodes = max(int(5000 * scale), 8)
    n_jobs = max(int(50_000 * scale), 40)
    parts = ("alpha", "beta", "gamma")
    meta, sched, sim = _build(
        n_nodes, cpu=32, mem_gb=128, partitions=parts,
        config_kw=dict(priority_type="multifactor", backfill=False),
        device=device)
    specs = [JobSpec(
        partition=parts[int(rng.integers(0, len(parts)))],
        res=ResourceSpec(cpu=float(rng.integers(1, 17)),
                         mem_bytes=int(rng.integers(1, 33)) << 30,
                         memsw_bytes=int(rng.integers(1, 33)) << 30),
        qos_priority=int(rng.integers(0, 4)) * 100,
        time_limit=7200,
        sim_runtime=float(rng.integers(30, 600)))
        for _ in range(n_jobs)]
    return run(sched, sim, specs)


def replay_backfill(scale: float, rng, run=_run_direct, device=None):
    """BASELINE config #3: priority + backfill — short jobs around
    long high-priority blockers."""
    from cranesched_tpu_torch.ctld.defs import JobSpec, ResourceSpec
    n_nodes = max(int(500 * scale), 4)
    n_jobs = max(int(5000 * scale), 30)
    meta, sched, sim = _build(
        n_nodes, cpu=16, mem_gb=64,
        config_kw=dict(priority_type="multifactor", backfill=True,
                       time_resolution=60.0, time_buckets=32),
        device=device)
    specs = []
    for i in range(n_jobs):
        big = i % 10 == 0
        specs.append(JobSpec(
            res=ResourceSpec(cpu=16.0 if big else
                             float(rng.integers(1, 5)),
                             mem_bytes=(32 if big else 2) << 30,
                             memsw_bytes=(32 if big else 2) << 30),
            qos_priority=1000 if big else 0,
            time_limit=1800 if big else 300,
            sim_runtime=float(rng.integers(600, 1800)) if big
            else float(rng.integers(10, 120))))
    return run(sched, sim, specs)


def replay_gres(scale: float, rng, run=_run_direct, device=None):
    """BASELINE config #4: GRES gang jobs (gpu slots, multi-node)."""
    from cranesched_tpu_torch.ctld.defs import JobSpec, ResourceSpec
    n_nodes = max(int(1000 * scale), 8)
    n_jobs = max(int(5000 * scale), 30)
    meta, sched, sim = _build(
        n_nodes, cpu=32, mem_gb=128, layout_gres=[("gpu", "a100")],
        config_kw=dict(priority_type="multifactor", backfill=False,
                       max_nodes_per_job=4),
        device=device)
    specs = []
    for _ in range(n_jobs):
        wants_gpu = rng.random() < 0.4
        specs.append(JobSpec(
            res=ResourceSpec(
                cpu=float(rng.integers(1, 9)),
                mem_bytes=int(rng.integers(1, 17)) << 30,
                memsw_bytes=int(rng.integers(1, 17)) << 30,
                gres=({("gpu", "a100"): int(rng.integers(1, 5))}
                      if wants_gpu else None)),
            node_num=int(rng.integers(1, 4)) if rng.random() < 0.2
            else 1,
            time_limit=3600,
            sim_runtime=float(rng.integers(30, 300))))
    return run(sched, sim, specs)


def replay_qos(scale: float, rng, run=_run_direct, device=None):
    """BASELINE config #5 (scaled from the 1M x 100k trace shape):
    QoS/fair-share mix with run limits across accounts."""
    from cranesched_tpu_torch.ctld.accounting import (
        Account, AccountManager, AdminLevel, Qos, User)
    from cranesched_tpu_torch.ctld.defs import JobSpec, ResourceSpec
    mgr = AccountManager()
    mgr.users["root"] = User(name="root", admin_level=AdminLevel.ROOT)
    mgr.add_qos("root", Qos(name="high", priority=1000,
                            max_jobs_per_user=64))
    mgr.add_qos("root", Qos(name="low", priority=0,
                            max_jobs_per_user=32))
    for acc in ("physics", "biology", "ml"):
        mgr.add_account("root", Account(
            name=acc, allowed_qos={"high", "low"}, default_qos="low"))
        for u in range(3):
            mgr.add_user("root", User(name=f"{acc}-u{u}",
                                      uid=1000 + u), acc)
    n_nodes = max(int(1000 * scale), 8)
    n_jobs = max(int(20_000 * scale), 60)
    meta, sched, sim = _build(
        n_nodes, cpu=16, mem_gb=64, accounts=mgr,
        config_kw=dict(priority_type="multifactor", backfill=False),
        device=device)
    accounts = ("physics", "biology", "ml")
    specs = []
    for _ in range(n_jobs):
        acc = accounts[int(rng.integers(0, 3))]
        specs.append(JobSpec(
            user=f"{acc}-u{int(rng.integers(0, 3))}", account=acc,
            qos="high" if rng.random() < 0.2 else "low",
            res=ResourceSpec(cpu=float(rng.integers(1, 5)),
                             mem_bytes=int(rng.integers(1, 9)) << 30,
                             memsw_bytes=int(rng.integers(1, 9)) << 30),
            time_limit=1800,
            sim_runtime=float(rng.integers(10, 120))))
    return run(sched, sim, specs, max_cycles=200_000)


def replay_topo(scale: float, rng, run=_run_direct, device=None):
    """Locality config (topo/): gang-heavy mix on a generated torus
    carved into aligned sub-tori (TPU v4-style slices), exercising the
    best-fit-block solve + cross-block fallback end to end."""
    from cranesched_tpu_torch.ctld.defs import JobSpec, ResourceSpec
    from cranesched_tpu_torch.topo.model import Topology
    # torus shapes must stay slice-aligned, so scale picks a shape
    # instead of multiplying node counts
    if scale >= 0.5:
        shape, slice_shape = (8, 8, 8), (4, 4, 4)    # 512 nodes, 8 blocks
    else:
        shape, slice_shape = (4, 4, 4), (2, 2, 2)    # 64 nodes, 8 blocks
    n_nodes = int(np.prod(shape))
    n_jobs = max(int(2000 * scale), 30)
    meta, sched, sim = _build(
        n_nodes, cpu=32, mem_gb=128,
        config_kw=dict(priority_type="multifactor", backfill=False,
                       max_nodes_per_job=8),
        device=device)
    meta.set_topology(Topology.from_torus(shape, slice_shape))
    specs = []
    for _ in range(n_jobs):
        gang = rng.random() < 0.6
        specs.append(JobSpec(
            res=ResourceSpec(cpu=float(rng.integers(1, 9)),
                             mem_bytes=int(rng.integers(1, 17)) << 30,
                             memsw_bytes=int(rng.integers(1, 17)) << 30),
            node_num=int(rng.integers(2, 9)) if gang else 1,
            time_limit=3600,
            sim_runtime=float(rng.integers(30, 300))))
    out = run(sched, sim, specs)
    out["topo_in_block_gangs"] = int(
        sched.stats.get("topo_in_block_total", 0))
    out["topo_cross_block_gangs"] = int(
        sched.stats.get("topo_cross_block_total", 0))
    return out


def replay_federation(scale: float, rng, wal_dir: str | None = None,
                      kill_shard: str = "east", device=None):
    """Closed-loop federation drill (REPLAY_r07): two WAL-backed shards
    + the placement arbiter on one virtual clock, a submit storm that is
    40% cross-partition gangs, and one shard SIGKILL'd mid-storm at the
    worst possible moment — immediately after a durable gang reserve,
    before any confirm.  The run audits itself: the cross-shard jobtrace
    ledger must show zero lost and zero double-dispatched jobs, and
    every committed gang member must appear exactly once."""
    import collections
    import shutil
    import tempfile

    from cranesched_tpu_torch.ctld.defs import JobSpec, ResourceSpec
    from cranesched_tpu_torch.fed.arbiter import GangRequest
    from cranesched_tpu_torch.fed.sim import FederatedCluster

    n_per_part = max(int(100 * scale), 4)
    n_jobs = max(int(2000 * scale), 60)
    tmp = wal_dir or tempfile.mkdtemp(prefix="crane-fed-replay-")
    fc = FederatedCluster(
        {"east": {"batch": n_per_part,
                  "debug": max(n_per_part // 2, 2)},
         "west": {"gpu": n_per_part}},
        cpu=16.0, mem_gb=64, wal_dir=tmp, device=device)
    parts = ("batch", "debug", "gpu")
    events = []
    for i in range(n_jobs):
        res = ResourceSpec(cpu=float(rng.integers(1, 5)),
                           mem_bytes=int(rng.integers(1, 9)) << 30,
                           memsw_bytes=int(rng.integers(1, 9)) << 30)
        runtime = float(rng.integers(5, 60))
        if rng.random() < 0.4:
            events.append(GangRequest(
                name=f"g{i:05d}",
                node_num=int(rng.integers(2, 5)),
                partitions=("batch", "gpu"),
                spec=JobSpec(user="u", res=res, sim_runtime=runtime)))
        else:
            events.append(JobSpec(
                name=f"j{i:05d}", user="u",
                partition=parts[int(rng.integers(0, 3))],
                res=res, sim_runtime=runtime))

    wave = max(n_jobs // 40, 1)
    kill_at = n_jobs // 2
    backlog = collections.deque(events)
    t0 = time.perf_counter()
    submitted = gangs = 0
    killed_t = recovered_t = None
    while backlog:
        # one wave per tick; a refused submit (shard down) stays queued
        # exactly as a retrying client would hold it
        for _ in range(min(wave, len(backlog))):
            ev = backlog[0]
            if isinstance(ev, GangRequest):
                fc.submit_gang(ev)
                gangs += 1
            else:
                try:
                    fc.submit(ev)
                except RuntimeError:
                    break  # owning shard is down — retry next tick
            backlog.popleft()
            submitted += 1
        if killed_t is None and submitted >= kill_at:
            # arm the worst-case SIGKILL: it lands right after the next
            # durable fed_reserve on this shard, before any confirm
            fc.shards[kill_shard].crash_after_lease = True
            killed_t = fc.now
        if (recovered_t is None and killed_t is not None
                and not fc.shards[kill_shard].alive
                and fc.now >= killed_t + 10.0):
            fc.recover(kill_shard)
            recovered_t = fc.now
        fc.tick()
    if not fc.shards[kill_shard].alive:
        fc.recover(kill_shard)
        recovered_t = fc.now
    fc.run_until_drained()
    wall = time.perf_counter() - t0

    ledger = fc.ledger()
    # every committed gang member exists exactly once across the
    # federation, and no gang was silently dropped
    member_counts = collections.Counter(
        j.spec.name
        for s in fc.shards.values()
        for j in list(s.scheduler.history.values())
        + list(s.scheduler.running.values())
        if j.spec.name.startswith("g"))
    stats = fc.arbiter.stats
    finished = sum(len(s.scheduler.history)
                   for s in fc.shards.values())
    completed = sum(
        1 for s in fc.shards.values()
        for j in s.scheduler.history.values()
        if j.status.value == "Completed")
    ok = bool(
        ledger["lost"] == 0 and ledger["doubled"] == 0
        and stats["failed"] == 0 and not fc.arbiter.queue
        and stats["commits"] == gangs
        and all(c == 1 for c in member_counts.values()))
    if wal_dir is None:
        shutil.rmtree(tmp, ignore_errors=True)
    return dict(
        mode="federation",
        shards={name: dict(s.partitions)
                for name, s in fc.shards.items()},
        jobs_submitted=n_jobs,
        gangs=gangs,
        gang_share=round(gangs / n_jobs, 3),
        gang_commits=stats["commits"],
        gang_aborts=stats["aborts"],
        killed_shard=kill_shard,
        killed_at=killed_t,
        recovered_at=recovered_t,
        jobs_finished=finished,
        completed=completed,
        cycles=int(fc.now),
        virtual_drain_s=fc.now,
        wall_s=round(wall, 3),
        jobs_per_wall_s=round(finished / wall, 1) if wall else 0.0,
        ledger=ledger,
        ok=ok,
    )


def replay_rebalance(scale: float, rng, wal_dir: str | None = None,
                     device=None):
    """Elastic-federation drill (REPLAY_r08): a two-shard submit storm
    with global per-user limits gossiping under bounded staleness, then
    a LIVE migration of the loaded partition mid-storm — with the
    source shard SIGKILL'd at the worst moment of the handoff (begin
    durable, payload exported, commit never acknowledged).  The source
    recovers from its WAL, the coordinator resolves the bare begin
    against the destination's adopted import, the storm finishes, and
    the run audits itself BY NAME across shards (ids renumber on
    import): every submitted job must reach exactly one terminal state
    federation-wide — zero lost, zero doubled."""
    import collections
    import shutil
    import tempfile

    from cranesched_tpu_torch.ctld.defs import JobSpec, ResourceSpec
    from cranesched_tpu_torch.fed.sim import FederatedCluster
    from cranesched_tpu_torch.fed.usage import GlobalLimits

    n_per_part = max(int(100 * scale), 4)
    n_jobs = max(int(2000 * scale), 80)
    limit = max(n_jobs // 2, 20)
    tmp = wal_dir or tempfile.mkdtemp(prefix="crane-rebalance-replay-")
    fc = FederatedCluster(
        {"east": {"batch": n_per_part,
                  "debug": max(n_per_part // 2, 2)},
         "west": {"gpu": n_per_part}},
        cpu=16.0, mem_gb=64, wal_dir=tmp,
        global_limits=GlobalLimits(max_submit_jobs_per_user=limit),
        publish_slack=4, device=device)
    parts = ("batch", "batch", "debug", "gpu")  # batch-heavy: the
    events = []                                 # shard we will unload
    for i in range(n_jobs):
        events.append(JobSpec(
            name=f"r{i:05d}", user="u",
            partition=parts[int(rng.integers(0, 4))],
            res=ResourceSpec(cpu=float(rng.integers(1, 5)),
                             mem_bytes=int(rng.integers(1, 9)) << 30,
                             memsw_bytes=int(rng.integers(1, 9)) << 30),
            sim_runtime=float(rng.integers(5, 60))))

    wave = max(n_jobs // 40, 1)
    migrate_at = n_jobs // 2
    backlog = collections.deque(events)
    t0 = time.perf_counter()
    submitted = admitted = denied = 0
    names: list[str] = []
    migration = None
    resolved = None
    while backlog:
        for _ in range(min(wave, len(backlog))):
            ev = backlog[0]
            try:
                _, jid = fc.submit(ev)
            except RuntimeError:
                break  # owning shard down mid-handoff — client retries
            backlog.popleft()
            submitted += 1
            if jid:
                admitted += 1
                names.append(ev.name)
            else:
                denied += 1  # sealed partition or global limit gate
        if migration is None and submitted >= migrate_at:
            # the storm's hot shard hands off its loaded partition —
            # and dies right after the export leaves (the WAL has the
            # begin; the dest adopts; the commit can never be served)
            migration = fc.migrate(
                "batch", "west",
                on_exported=lambda payload: fc.kill("east"))
            assert migration["committed"] is False
            fc.recover("east")
            resolved = fc.resolve_migrations("east")
        fc.tick()
        fc.pump_usage(fc.now)
    fc.run_until_drained()
    wall = time.perf_counter() - t0

    audit = fc.ledger_by_name(names)
    in_book = sum(
        c.submit_jobs
        for s in fc.shards.values()
        for c in [s.scheduler.global_usage._user.get("u")] if c)
    ok = bool(
        migration is not None
        and [r["resolution"] for r in resolved] == ["commit"]
        and audit["lost"] == [] and audit["doubled"] == []
        and audit["still_live"] == []
        and admitted <= n_jobs
        and in_book == 0  # every slot released on terminal
        and fc.shard_map.shard_for_partition("batch") == "west")
    if wal_dir is None:
        shutil.rmtree(tmp, ignore_errors=True)
    finished = sum(len(s.scheduler.history)
                   for s in fc.shards.values())
    completed = sum(
        1 for s in fc.shards.values()
        for j in s.scheduler.history.values()
        if j.status.value == "Completed")
    return dict(
        mode="rebalance",
        shards={name: dict(s.partitions)
                for name, s in fc.shards.items()},
        jobs_submitted=submitted,
        admitted=admitted,
        denied_at_gate=denied,
        global_submit_limit=limit,
        migration=migration,
        resolved=[r["resolution"] for r in (resolved or [])],
        map_epoch=fc.shard_map.epoch,
        jobs_finished=finished,
        completed=completed,
        cycles=int(fc.now),
        virtual_drain_s=fc.now,
        wall_s=round(wall, 3),
        jobs_per_wall_s=round(finished / wall, 1) if wall else 0.0,
        audit={k: (len(v) if isinstance(v, list) else v)
               for k, v in audit.items()},
        ok=ok,
    )


CONFIGS = {
    "fifo": replay_fifo,
    "minload": replay_minload,
    "backfill": replay_backfill,
    "gres": replay_gres,
    "qos": replay_qos,
    "topo": replay_topo,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="crane-replay")
    ap.add_argument("config", nargs="?", choices=[*CONFIGS, "all"])
    ap.add_argument("--scale", type=float, default=0.1,
                    help="fraction of the full BASELINE shape")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--rpc", action="store_true",
                    help="drive the FULL path: SubmitBatchJobs over "
                         "gRPC -> WAL -> cycle -> dispatch")
    ap.add_argument("--wal", default="",
                    help="WAL path for --rpc (empty = no WAL)")
    ap.add_argument("--slo", action="store_true",
                    help="closed-loop mode: drive --rpc, then assert "
                         "the SLO/ledger contract from the run's own "
                         "exported telemetry")
    ap.add_argument("--federation", action="store_true",
                    help="closed-loop federation drill: 2 WAL-backed "
                         "shards + the arbiter, 40%% cross-partition "
                         "gangs, one shard SIGKILL'd mid-storm; "
                         "asserts zero lost/doubled via the jobtrace "
                         "ledger")
    ap.add_argument("--rebalance", action="store_true",
                    help="elastic-federation drill: live-migrate the "
                         "loaded partition mid-storm with the source "
                         "SIGKILL'd during the handoff, recover, "
                         "resolve; asserts exactly-once by job name "
                         "and the global submit limit")
    ap.add_argument("--device", default="cuda",
                    help="torch device the schedulers run on (cpu "
                         "runs the plain versions of the kernels)")
    args = ap.parse_args(argv)
    if args.config is None and not (args.federation or args.rebalance):
        ap.error("a config is required unless --federation or "
                 "--rebalance is given")
    from cranesched_tpu_torch.device import resolve_device
    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"crane-replay: device {args.device!r}: {exc}",
              file=sys.stderr)
        return 2

    run = _run_direct
    if args.slo:
        import functools
        run = functools.partial(_run_closed_loop,
                                wal_path=args.wal or None)
    elif args.rpc:
        import functools
        run = functools.partial(_run_rpc, wal_path=args.wal or None)

    names = ([] if args.config is None else
             list(CONFIGS) if args.config == "all" else [args.config])
    results = {}
    for name in names:
        rng = np.random.default_rng(args.seed)
        results[name] = CONFIGS[name](args.scale, rng, run=run,
                                      device=device)
    if args.federation:
        rng = np.random.default_rng(args.seed)
        results["federation"] = replay_federation(args.scale, rng,
                                                  device=device)
    if args.rebalance:
        rng = np.random.default_rng(args.seed)
        results["rebalance"] = replay_rebalance(args.scale, rng,
                                                device=device)
    if args.json:
        print(json.dumps(results))
    else:
        for name, r in results.items():
            print(f"{name:9s} finished={r['jobs_finished']} "
                  f"completed={r['completed']} "
                  f"cycles={r['cycles']} "
                  f"virtual_drain={r['virtual_drain_s']:.0f}s "
                  f"wall={r['wall_s']}s "
                  f"({r['jobs_per_wall_s']} jobs/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
