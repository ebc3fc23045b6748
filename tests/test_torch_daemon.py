"""The port's controller daemon (``python -m cranesched_tpu_torch.ctld_main``)
as a subprocess on the CPU (``--device cpu``): the banner, submits over
the wire, SIGTERM with exit 0, a restart from the WAL (and its snapshot)
that keeps every acknowledged job in the state the last query showed,
the held lease's refusal, the refusals naming ROADMAP.md A13 and A14,
the real node plane (no ``--sim``: a ``craned_main`` subprocess registers
and runs jobs as real processes), and the boot path's bounded acquisition of the card, which never
carries on on the CPU when it fails (tested with a stubbed probe).  In
process: the snapshot document against the JAX package's, and the
lease's exclusion and epoch.

Every wait is bounded and every daemon is killed by PID in a
``finally``.
"""

import json
import os
import re
import signal
import subprocess
import sys
import time

import pytest

from cranesched_tpu_torch.parallel import acquire
from cranesched_tpu_torch.rpc import CtldClient, crane_pb2 as pb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNER = re.compile(r"listening on port (\d+)")

CONFIG = """
ClusterName: t
Listen: 127.0.0.1:0
Wal: {tmp}/wal/ctld.wal
Archive: {tmp}/archive.db
Nodes:
  - name: "cn[0-3]"
    cpu: 8
    memory: 16G
    partitions: [batch]
Partitions:
  - name: batch
Scheduler:
  Solver: cuda
"""


def _config(tmp_path, extra=""):
    path = tmp_path / "ctld.yaml"
    path.write_text(CONFIG.format(tmp=tmp_path) + extra)
    return str(path)


class Daemon:
    """One ctld_main subprocess, its output in files under ``tmp``."""

    def __init__(self, tmp_path, tag, *args, env=None):
        self.out = tmp_path / f"{tag}.out"
        self.err = tmp_path / f"{tag}.err"
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "cranesched_tpu_torch.ctld_main",
                 *args], cwd=REPO, stdout=out, stderr=err,
                env=dict(os.environ, **(env or {})))

    def stdout(self) -> str:
        return self.out.read_text()

    def stderr(self) -> str:
        return self.err.read_text()

    def port(self, timeout=60.0) -> int:
        """The port from the banner, which must be the first stdout
        line."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            lines = self.stdout().splitlines()
            if lines:
                m = BANNER.search(lines[0])
                assert m, f"first stdout line is not the banner: {lines}"
                return int(m.group(1))
            if self.proc.poll() is not None:
                raise AssertionError(
                    f"daemon exited {self.proc.returncode}:\n"
                    f"{self.stderr()}")
            time.sleep(0.05)
        raise AssertionError(f"no banner in {timeout}s:\n{self.stderr()}")

    def wait(self, timeout=60.0) -> int:
        return self.proc.wait(timeout=timeout)

    def kill(self) -> None:
        if self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=30)


def _until(pred, timeout=60.0, interval=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


def _spec():
    return pb.JobSpec(user="alice", partition="batch", time_limit=86400,
                      res=pb.ResourceSpec(cpu=8.0, mem_bytes=1 << 30),
                      sim_runtime=1e6)


def _states(client):
    return {j.job_id: (j.status, tuple(j.node_names))
            for j in client.query_jobs(include_history=True).jobs}


def test_submit_sigterm_restart_keeps_every_acked_job(tmp_path):
    """Four nodes, twelve whole-node jobs that never finish: four run,
    eight wait.  SIGTERM exits 0; a second daemon on the same WAL is
    refused while the first holds the lease; the restart (from the
    snapshot plus the WAL tail) shows every acknowledged job in the
    state the last query before the stop showed."""
    cfg = _config(tmp_path)
    args = ("-c", cfg, "--sim", "--device", "cpu", "--cycle-interval",
            "0.1", "--snapshot-interval", "0.3")
    first = Daemon(tmp_path, "first", *args)
    second = third = None
    try:
        client = CtldClient(f"127.0.0.1:{first.port()}", timeout=10.0)
        acked = [r.job_id for r in
                 client.submit_many([_spec() for _ in range(12)]).replies]
        assert all(acked) and len(set(acked)) == 12
        assert _until(lambda: json.loads(client.query_stats().json)
                      ["jobs_started_total"] >= 4)
        # every cycle ran where --device put it
        rows = [r for r in json.loads(client.query_stats().json)
                ["cycle_trace"] if r["solver"] != "skip"]
        assert rows and all(r["device"] == "cpu" for r in rows)
        # the lease is held: a second leader on the same WAL is refused
        second = Daemon(tmp_path, "second", *args)
        assert second.wait() != 0
        assert "holds the lease" in second.stderr()
        assert _until(lambda: os.path.exists(
            str(tmp_path / "wal" / "ctld.wal.snap")))
        before = _states(client)
        assert sorted(before) == sorted(acked)
        assert sorted(s for s, _ in before.values()) == \
            ["Pending"] * 8 + ["Running"] * 4
        client.close()
        os.kill(first.proc.pid, signal.SIGTERM)
        assert first.wait() == 0

        third = Daemon(tmp_path, "third", *args)
        client = CtldClient(f"127.0.0.1:{third.port()}", timeout=10.0)
        assert _states(client) == before
        assert "recovered 12 jobs" in third.stderr()
        # the id counter continues past every acknowledged job
        assert client.submit(_spec()).job_id == max(acked) + 1
        client.close()
    finally:
        for d in (first, second, third):
            if d is not None:
                d.kill()


@pytest.mark.parametrize("args,extra,item", [
    (("--device", "cpu"), "", None),
    (("--device", "cpu"), "  DispatchWorkers: 16\n", None),
    (("--sim", "--ha-standby", "--device", "cpu"), "", "A13"),
    (("--sim", "--device", "cpu"),
     "Federation:\n  ShardName: s0\n", "A14"),
], ids=["real-node-plane", "dispatch-workers", "standby", "federation"])
def test_unported_features_refused_by_item(tmp_path, args, extra, item):
    """What the port does not carry is refused naming its ROADMAP item;
    what came since (item None: the real node plane and its dispatch
    pool) starts with its banner and stops with 0 on SIGTERM."""
    d = Daemon(tmp_path, "d", "-c", _config(tmp_path, extra), *args)
    try:
        if item is None:
            d.port()
            assert "(real node plane, 4 nodes configured" in d.stdout()
            os.kill(d.proc.pid, signal.SIGTERM)
            assert d.wait() == 0
            return
        assert d.wait() != 0
        assert f"ROADMAP.md {item}" in d.stderr()
        assert not BANNER.search(d.stdout())
    finally:
        d.kill()


class Craned:
    """One craned_main subprocess, its output in files under ``tmp``."""

    def __init__(self, tmp_path, name, ctld_port, *args):
        self.out = tmp_path / f"{name}.out"
        self.err = tmp_path / f"{name}.err"
        with open(self.out, "w") as out, open(self.err, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "cranesched_tpu_torch.craned_main",
                 "--name", name, "--ctld", f"127.0.0.1:{ctld_port}",
                 "--workdir", str(tmp_path),
                 "--cgroup-root", str(tmp_path / "nocgroup"), *args],
                cwd=REPO, stdout=out, stderr=err)

    def kill(self) -> None:
        if self.proc.poll() is None:
            os.kill(self.proc.pid, signal.SIGKILL)
            self.proc.wait(timeout=30)


def test_real_node_plane_runs_a_job_to_completed(tmp_path):
    """``ctld_main`` without ``--sim`` on the CPU and one ``craned_main``
    subprocess: the craned registers, a job runs on it as a real
    process to COMPLETED with its output file, a failing one reports its
    exit code, and both daemons stop with 0 on SIGTERM."""
    d = Daemon(tmp_path, "ctld", "-c", _config(tmp_path), "--device",
               "cpu", "--cycle-interval", "0.1")
    craned = None
    try:
        port = d.port()
        assert "(real node plane, 4 nodes configured" in d.stdout()
        client = CtldClient(f"127.0.0.1:{port}", timeout=10.0)
        craned = Craned(tmp_path, "cn1", port, "--cpu", "8", "--memory",
                        "16G", "--partitions", "batch",
                        "--ping-interval", "0.5")

        def alive():
            nodes = client.query_cluster().nodes
            return [n.name for n in nodes if n.state != "DOWN"]

        assert _until(lambda: alive() == ["cn1"], timeout=60.0)
        out = tmp_path / "job_%j.out"
        ok = client.submit(pb.JobSpec(
            user="alice", partition="batch", time_limit=600,
            res=pb.ResourceSpec(cpu=2.0, mem_bytes=1 << 30),
            script="echo ran-$CRANE_JOB_ID-on-$CRANE_NODE_NAME",
            output_path=str(out))).job_id
        bad = client.submit(pb.JobSpec(
            user="alice", partition="batch", time_limit=600,
            res=pb.ResourceSpec(cpu=2.0, mem_bytes=1 << 30),
            script="exit 3")).job_id

        def final(jid):
            jobs = client.query_jobs(include_history=True).jobs
            return {j.job_id: j for j in jobs}.get(jid)

        assert _until(lambda: final(ok).status == "Completed"
                      and final(bad).status == "Failed", timeout=60.0)
        assert list(final(ok).node_names) == ["cn1"]
        assert final(bad).exit_code == 3
        assert (tmp_path / f"job_{ok}.out").read_text() == \
            f"ran-{ok}-on-cn1\n"
        client.close()
        os.kill(craned.proc.pid, signal.SIGTERM)
        assert craned.proc.wait(timeout=30) == 0
        os.kill(d.proc.pid, signal.SIGTERM)
        assert d.wait() == 0
    finally:
        if craned is not None:
            craned.kill()
        d.kill()


def test_failed_acquisition_exits_without_falling_back(tmp_path):
    """The default device is the card.  With the probe wedged in its
    first phase (a stub, not a real card) the daemon emits the event,
    exits non-zero with the diagnosis and never serves on the CPU."""
    d = Daemon(tmp_path, "d", "-c", _config(tmp_path), "--sim",
               env={"BENCH_ACQUIRE_INJECT_HANG": "env_preflight",
                    "CRANE_ACQUIRE_TIMEOUT": "3"})
    try:
        assert d.wait() == 1
        err = d.stderr()
        assert '"type": "backend_degraded"' in err
        assert "hung in phase 'env_preflight'" in err
        assert err.index("backend_degraded") < err.index("FATAL")
        assert not BANNER.search(d.stdout())
    finally:
        d.kill()


def test_acquire_reports_each_phase_and_never_degrades(monkeypatch):
    """The probe in process: a failing child is diagnosed with the phase
    it reached and the event goes to the sink; the CPU, when asked for,
    needs no probe."""
    events = []
    monkeypatch.setattr(
        acquire, "_ACQUIRE_PROBE_SRC",
        acquire._ACQUIRE_PROBE_SRC.replace(
            'stamp("cuda_init")', 'stamp("cuda_init")\nsys.exit(3)'))
    out = acquire.acquire_device(
        30.0, event_sink=lambda *e: events.append(e))
    assert not out["acquired"]
    assert out["phases"] == list(acquire.ACQUIRE_PHASES[:3])
    assert "rc=3" in out["diagnosis"] and "cuda_init" in out["diagnosis"]
    assert [e[0] for e in events] == ["backend_degraded"]
    cpu = acquire.ensure_device("cpu")
    assert cpu["acquired"] and cpu["platform"] == "cpu"


def _snap_cluster(ctld, sim_mod, cfg, **kw):
    meta = ctld.MetaContainer()
    for i in range(4):
        meta.add_node(f"cn{i}", meta.layout.encode(
            cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True))
        meta.craned_up(i)
    sched = ctld.JobScheduler(meta, ctld.SchedulerConfig(**cfg), **kw)
    sim = sim_mod.SimCluster(sched)
    sim.wire(sched)
    for k in range(10):
        sched.submit(ctld.JobSpec(
            res=ctld.ResourceSpec(cpu=4.0, mem_bytes=1 << 30),
            sim_runtime=30.0 + 10 * k), now=0.0)
    sched.schedule_cycle(now=1.0)
    sim.advance_to(45.0)
    sched.schedule_cycle(now=45.0)
    meta.drain(2, True)
    return sched


def test_snapshot_document_and_restore_match_jax(tmp_path):
    """``capture_snapshot`` writes the JAX package's document for the
    same state, and a store round-trips it into the same replay."""
    import cranesched_tpu.craned.sim as jsim
    import cranesched_tpu.ctld as jctld
    import cranesched_tpu.ha.snapshot as jsnap
    import cranesched_tpu_torch.craned.sim as tsim
    import cranesched_tpu_torch.ctld as tctld
    from cranesched_tpu_torch.ha import snapshot as tsnap

    a = _snap_cluster(jctld, jsim, dict(backfill=False, solver="device"))
    b = _snap_cluster(tctld, tsim, dict(backfill=False), device="cpu")
    da, db = jsnap.capture_snapshot(a), tsnap.capture_snapshot(b)
    assert json.dumps(da, sort_keys=True) == json.dumps(db, sort_keys=True)
    store = tsnap.SnapshotStore(str(tmp_path / "w.wal"))
    store.save(db)
    fresh = tctld.JobScheduler(tctld.MetaContainer(), device="cpu")
    for i in range(4):
        fresh.meta.add_node(f"cn{i}", fresh.meta.layout.encode(
            cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True))
    replay = tsnap.restore_snapshot(fresh, store.load())
    assert sorted(replay) == sorted(j["job_id"] for j in db["jobs"])
    assert fresh.meta.nodes[2].drained and fresh._next_job_id == 11


def test_lease_is_exclusive_and_the_epoch_only_grows(tmp_path):
    from cranesched_tpu_torch.ha import LeaderLease
    from cranesched_tpu_torch.utils.filelock import FileLockHeld

    wal = str(tmp_path / "ctld.wal")
    first = LeaderLease(wal)
    assert first.acquire() == 1
    with pytest.raises(FileLockHeld):
        LeaderLease(wal).acquire(timeout=0)
    first.release()
    again = LeaderLease(wal)
    assert again.acquire() == 2
    again.epoch_store.observe(7)
    assert again.epoch_store.load() == 7
    again.release()
