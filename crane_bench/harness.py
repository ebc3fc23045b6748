"""One run of one cell: set-up, the measured window, the check.

The served path: a ``JobScheduler`` with a ``SimCluster`` and an fsync'd
``WriteAheadLog`` behind ``cranesched_tpu_torch.rpc.serve(..., tick_mode=True)``
on 127.0.0.1, driven by one ``CtldClient`` in virtual time.

Set-up, in order: the nodes and the backlog, submitted in process one WAL
group per ``wal.setup_group_jobs`` jobs (the state a controller holds after a
restart); the cold cycle (``Tick(0)``), which fills the cluster; the backlog
topped up in process; the settle tick (``Tick(settle_s)``), so that ends
flow; the backlog topped up again; then ``warm_steps`` steps of the mix.

A step submits over gRPC, in chunks of ``submit_chunk``, as many new jobs as
the previous tick started, which holds the backlog, then calls
``Tick(now + step_s)``.  The window is a fixed count of steps, ``seconds``
over the cell's step wall time (``cells/<cell>.json``), so that every run of
a seed does the same ticks, the same starts and the same collections,
whatever the host's speed.
"""

from __future__ import annotations

import gc
import os
import shutil
import sys
import tempfile
import time
import types

import numpy as np

from crane_bench import check, draws, spec
from crane_bench.profile import Capture, instrument


def log(msg: str) -> None:
    print(f"[crane_bench] {msg}", file=sys.stderr, flush=True)


def build_program(cfg: dict, cluster, device: str, wal_path: str):
    """The scheduler with its simulated node plane and its WAL."""
    from cranesched_tpu_torch.craned.sim import SimCluster
    from cranesched_tpu_torch.ctld import (
        JobScheduler,
        MetaContainer,
        SchedulerConfig,
    )
    from cranesched_tpu_torch.ctld.wal import WriteAheadLog
    from cranesched_tpu_torch.models.priority import PriorityWeights

    meta = MetaContainer()
    for i, name in enumerate(cluster.names()):
        meta.add_node(name, meta.layout.encode(
            cpu=float(cluster.cpu[i]),
            mem_bytes=int(cluster.mem_gib[i]) << 30, is_capacity=True),
            partitions=(f"p{int(cluster.part[i])}",))
        meta.craned_up(i)
    config = SchedulerConfig(
        priority_weights=PriorityWeights(**cfg["priority_weights"]),
        **cfg["scheduler"])
    sched = JobScheduler(meta, config, device=device)
    sim = SimCluster(sched)
    sim.wire(sched)
    sched.wal = WriteAheadLog(wal_path, fsync=bool(cfg["wal"]["fsync"]))
    return sched, sim


class Driver:
    """The client side of a run: draws jobs, submits them, ticks, and keeps
    the record of both."""

    USER, ACCOUNT = "user", "default"

    def __init__(self, cfg: dict, traffic: dict, seed: int, sched, client):
        from cranesched_tpu_torch.rpc import crane_pb2

        self.pb = crane_pb2
        self.cfg, self.traffic = cfg, traffic
        self.sched, self.client = sched, client
        self.jobs = draws.JobLog(cfg, seed)
        self.ticks: list[dict] = []
        self.now = 0.0
        self.refused = 0
        # jobs to submit to hold the backlog: what the last tick started
        self.owed = 0

    def submit_local(self, k: int) -> None:
        """``k`` jobs into the scheduler in process, one WAL group per
        ``setup_group_jobs``; they settle what is owed."""
        from cranesched_tpu_torch.ctld import JobSpec, ResourceSpec

        self.owed = 0
        batch = self.jobs.draw(k)
        group = int(self.cfg["wal"]["setup_group_jobs"])
        ids = []
        for lo in range(0, k, group):
            with self.sched.wal.group():
                for i in range(lo, min(k, lo + group)):
                    ids.append(self.sched.submit(JobSpec(
                        user=self.USER, account=self.ACCOUNT,
                        partition=f"p{int(batch['part'][i])}",
                        res=ResourceSpec(
                            cpu=float(batch["cpu"][i]),
                            mem_bytes=int(batch["mem_gib"][i]) << 30),
                        node_num=int(batch["nodes"][i]),
                        time_limit=int(batch["time_limit"][i]),
                        sim_runtime=float(batch["runtime"][i])),
                        now=self.now))
        self.refused += sum(1 for j in ids if not j)
        self.jobs.record(batch, self.now, len(self.ticks), ids)

    def submit_wire(self, k: int) -> tuple[float, float, int]:
        """``k`` jobs over ``SubmitBatchJobs`` in chunks; returns the
        calls' (start, end) on ``perf_counter`` and the jobs acknowledged."""
        pb = self.pb
        batch = self.jobs.draw(k)
        specs = [pb.JobSpec(
            user=self.USER, account=self.ACCOUNT,
            partition=f"p{int(batch['part'][i])}",
            res=pb.ResourceSpec(cpu=float(batch["cpu"][i]),
                                mem_bytes=int(batch["mem_gib"][i]) << 30),
            node_num=int(batch["nodes"][i]),
            time_limit=int(batch["time_limit"][i]),
            sim_runtime=float(batch["runtime"][i])) for i in range(k)]
        chunk = int(self.traffic["submit_chunk"])
        ids = []
        t0 = time.perf_counter()
        for lo in range(0, k, chunk):
            reply = self.client.submit_many(specs[lo:lo + chunk])
            ids.extend(r.job_id for r in reply.replies)
        t1 = time.perf_counter()
        acked = sum(1 for j in ids if j)
        self.refused += len(ids) - acked
        self.jobs.record(batch, self.now, len(self.ticks), ids)
        return t0, t1, acked

    def tick(self, now: float, phase: str) -> dict:
        t0 = time.perf_counter()
        reply = self.client.tick(now)
        t1 = time.perf_counter()
        if reply.error:
            raise RuntimeError(f"Tick({now}) refused: {reply.error}")
        self.now = now
        rows = self.sched.cycle_trace.snapshot(last=1)
        row = dict(rows[0]) if rows and rows[0].get("now") == now else None
        rec = {"now": now, "phase": phase, "started": list(reply.started),
               "t0": t0, "t1": t1, "wall_ms": (t1 - t0) * 1e3, "row": row}
        self.ticks.append(rec)
        self.owed = len(rec["started"])
        return rec

    def step(self, phase: str) -> dict:
        k = self.owed
        s0, s1, acked = self.submit_wire(k)
        rec = self.tick(self.now + float(self.traffic["step_s"]), phase)
        rec.update(submit_t0=s0, submit_t1=s1, submitted=k, acked=acked)
        return rec


class GcClock:
    """While entered, the interpreter's garbage collections: their count
    and seconds by generation, and their spans on ``perf_counter``."""

    def __init__(self):
        self.spans: list = []
        self._t0 = 0.0

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.spans.append((f"gc:gen{info['generation']}", self._t0,
                               time.perf_counter()))

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def summary(self) -> str:
        by_gen: dict = {}
        for name, t0, t1 in self.spans:
            n, s = by_gen.get(name, (0, 0.0))
            by_gen[name] = (n + 1, s + t1 - t0)
        return ", ".join(f"{name} {n}x {s:.3f} s"
                         for name, (n, s) in sorted(by_gen.items())) or "0x"


def program_view(sched) -> dict:
    """What the program shows after the last tick: running jobs and their
    nodes, each node's free resources, each pending job's priority."""
    nodes = sched.meta.nodes
    return {
        "running": {int(j): [int(n) for n in job.node_ids]
                    for j, job in sched.running.items()},
        "free": np.stack([np.asarray(nodes[i].avail, np.int64)
                          for i in range(len(nodes))]),
        "priority": {int(j): float(job.priority)
                     for j, job in sched.pending.items()},
    }


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float | None = None,
             overrides: dict | None = None, bench: dict | None = None,
             control: bool = False) -> tuple[dict, dict]:
    """Run one cell once.  Returns (the result line, the compared numbers).
    ``overrides`` replace configuration keys (the CPU tests' small sizes);
    ``control`` also reads the control's numbers (``numbers["control"]``):
    the reference in bfloat16 put in the program's place."""
    import torch

    from cranesched_tpu_torch.obs.flight import kernel_cache_stats
    from cranesched_tpu_torch.rpc import CtldClient, serve

    t_start = time.perf_counter() if t_start is None else t_start
    bench = spec.load_benchmark() if bench is None else bench
    cell = spec.workload(bench, cell_name)
    cfg = spec.load_config(bench, cell["config"])
    cfg.update(overrides or {})
    traffic = spec.load_traffic(cell["traffic"])
    steps = spec.window_steps(spec.load_cell(cell_name), seconds, trace)
    on_card = device.startswith("cuda")

    cluster = draws.Cluster(cfg, seed)
    wal_dir = tempfile.mkdtemp(prefix="crane_bench_wal_")
    wal_path = os.path.join(wal_dir, "ctld.wal")
    server = client = None
    try:
        sched, sim = build_program(cfg, cluster, device, wal_path)
        server, port = serve(sched, sim=sim, tick_mode=True)
        client = CtldClient(f"127.0.0.1:{port}", timeout=900.0)
        drv = Driver(cfg, traffic, seed, sched, client)
        backlog = int(cfg["pending"])
        drv.submit_local(backlog)
        log(f"{cell_name}: {cluster.num_nodes} nodes, {backlog} pending "
            f"({time.perf_counter() - t_start:.1f} s)")
        cold = drv.tick(0.0, "cold")
        drv.submit_local(drv.owed)
        settle = drv.tick(float(traffic["settle_s"]), "settle")
        drv.submit_local(drv.owed)
        cache = kernel_cache_stats()
        log(f"cold tick {cold['wall_ms']:.0f} ms, {len(cold['started'])} "
            f"started; settle tick {settle['wall_ms']:.0f} ms, "
            f"{len(settle['started'])} started; kernel builds: "
            f"{cache['misses']} built, {cache['hits']} found built")
        for _ in range(int(traffic["warm_steps"])):
            drv.step("warm")
        if drv.refused:
            raise RuntimeError(f"{drv.refused} submits refused in set-up")
        if on_card:
            torch.cuda.synchronize()
        # every run enters the window with the interpreter's collector in the
        # same state: no full collection left half-due from set-up
        gc.collect()

        cap = phases = None
        if trace:
            cap, phases = Capture(on_card), instrument(sched)
            cap.start()
        collections = GcClock()
        w0 = time.perf_counter()
        setup_s = w0 - t_start
        with collections:
            for _ in range(steps):
                drv.step("window")
        if cap is not None:
            t_stop = time.perf_counter()
            cap.stop()
            phases.extend(collections.spans)
            log(f"profiler stopped in {time.perf_counter() - t_stop:.1f} s")
        window_s = drv.ticks[-1]["t1"] - w0
        window = [t for t in drv.ticks if t["phase"] == "window"]
        log(f"window {window_s:.2f} s, {len(window)} ticks (fixed), setup "
            f"{setup_s:.1f} s; the interpreter's collector ran "
            f"{collections.summary()}")
        for t in window:
            r = t["row"] or {}
            log("tick now={now:.0f} wall={wall:.1f} total={total} "
                "prelude={prelude} priority={priority:.1f} solve={solve} "
                "commit={commit} dispatch={dispatch} started={n}".format(
                    now=t["now"], wall=t["wall_ms"], n=len(t["started"]),
                    total=r.get("total_ms"), prelude=r.get("prelude_ms"),
                    priority=r.get("priority_ms", 0.0),
                    solve=r.get("solve_ms"), commit=r.get("commit_ms"),
                    dispatch=r.get("dispatch_ms")))
        mem_peak = torch.cuda.max_memory_allocated() if on_card else 0
        final = program_view(sched)
        reduced = None
        if cap is not None:
            t_reduce = time.perf_counter()
            reduced = cap.reduce(
                [(t["t0"], t["t1"]) for t in window],
                [(t["submit_t0"], t["submit_t1"]) for t in window], phases)
            cap = None
            log(f"trace read in {time.perf_counter() - t_reduce:.1f} s")
        client.close()
        client = None
        server.stop()
        server = None
        sched.wal.close()
        ticks, jobs = drv.ticks, drv.jobs.arrays()
        refused = drv.refused
        del drv, sched, sim
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()

        t_check = time.perf_counter()
        numbers = check.compare(cfg, cluster, jobs, ticks, final, wal_path,
                                seed)
        if control:
            numbers["control"] = check.compare(cfg, cluster, jobs, ticks,
                                               final, wal_path, seed,
                                               low=True)
        correct, checks = check.verdict(numbers)
        log(f"check {time.perf_counter() - t_check:.1f} s "
            f"({numbers['_seconds']['wal_read']:.1f} s reading the WAL) over "
            f"ticks {numbers['_ticks_checked']} "
            f"({numbers['_seconds']['ticks']} s); WAL records "
            f"{numbers['_wal_records']}")

        ctx = types.SimpleNamespace(
            ticks=window, window_s=window_s, setup_s=setup_s, trace=reduced,
            config=cfg, traffic=traffic, cell=cell)
        metrics = {}
        for m in spec.metrics_for(bench, cell_name, trace):
            value = spec.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_doc = {
            "platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": int(mem_peak),
        }
        if reduced is not None:
            device_doc.update(busy_s=reduced["busy_s"],
                              window_s=reduced["window_s"])
        result = {
            "correct": bool(correct),
            "attempted": sum(t["submitted"] for t in window) + len(window),
            "failed": int(refused),
            "metrics": metrics,
            "device": device_doc,
        }
        if reduced is not None:
            result["breakdown"] = {"device_ops": reduced["device_ops"],
                                   "idle_gaps": reduced["idle_gaps"]}
        result["checks"] = checks
        return result, numbers
    finally:
        if client is not None:
            client.close()
        if server is not None:
            server.stop()
        shutil.rmtree(wal_dir, ignore_errors=True)
