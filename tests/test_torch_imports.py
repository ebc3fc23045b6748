"""The port stands alone: it imports neither JAX nor the JAX package.

A subprocess installs a ``sys.meta_path`` finder that refuses ``jax``,
``jaxlib``, ``flax`` and the top-level ``cranesched_tpu`` (not
``cranesched_tpu_torch``), imports every module of the port (the
topology, hostlist, accounting, license, packing, preemption, WAL,
archive, accounts-store, metrics and observability modules among them),
runs a 16-node scheduling cycle on the CPU with a topology, a license, a
packed job, a dependency, an array, a WAL and the job trace, recovers a
second scheduler from that WAL, runs a cycle with the native solver
under a profiler capture, and serves ``etc/config.yaml``'s cluster over
gRPC (the daemon's modules: config, lease, snapshot, server and client),
solves on a mesh of CPU shards and with the speculative and blocked
solvers, builds a hot standby's server and follower, and runs a two-shard
federation (``fed/``: a cross-partition gang through the arbiter, the
usage gossip, a live partition migration) whose shards' stats merge
through ``obs/fedobs.py``.
The node plane (the craned, its supervisor, ``craned_main``, ``coord``,
the rendezvous service) also imports with ``torch`` blocked, so a craned
and every step's supervisor start without loading it, and so do the
``crane`` commands (``cli`` and every module a command reaches).
``chip_smoke.py`` and every source of the port are checked by an AST
scan of their imports, and the port's ``crane_pb2`` is the JAX
package's byte for byte.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "cranesched_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "cranesched_tpu")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


_CHILD = textwrap.dedent("""
    import importlib, sys

    BLOCKED = {blocked!r}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    for mod in {mods!r}:
        importlib.import_module(mod)

    from cranesched_tpu_torch.craned.sim import SimCluster
    from cranesched_tpu_torch.ctld import (JobScheduler, JobSpec,
        MetaContainer, ResourceSpec, SchedulerConfig)

    meta = MetaContainer()
    for i in range(16):
        meta.add_node("n%d" % i, meta.layout.encode(
            cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True), partitions=("p%d" % (i % 2),))
        meta.craned_up(i)
    sched = JobScheduler(meta, SchedulerConfig(backfill=False),
                         device="cpu")
    import os, tempfile
    from cranesched_tpu_torch.ctld.archive import JobArchive
    from cranesched_tpu_torch.ctld.defs import ArraySpec, Dependency
    from cranesched_tpu_torch.ctld.wal import WriteAheadLog
    tmp = tempfile.mkdtemp()
    wal_path = os.path.join(tmp, "w.wal")
    sched.wal = WriteAheadLog(wal_path, fsync=False)
    sched.attach_archive(JobArchive(os.path.join(tmp, "h.sqlite")))
    sim = SimCluster(sched)
    sim.wire(sched)
    for j in range(40):
        assert sched.submit(JobSpec(
            res=ResourceSpec(cpu=2.0, mem_bytes=1 << 30),
            partition="p%d" % (j % 2), node_num=1 + j % 2,
            sim_runtime=30.0), now=0.0) > 0
    assert sched.submit(JobSpec(
        res=ResourceSpec(cpu=1.0, mem_bytes=1 << 30), partition="p1",
        array=ArraySpec(0, 2), dependencies=(Dependency(1),),
        sim_runtime=5.0), now=0.0) > 0
    # a topology, licenses and a packed job take the new routes
    from cranesched_tpu_torch.topo import Topology
    meta.set_topology(Topology.uniform_blocks(16, 4))
    sched.licenses.configure("lic", 2)
    assert sched.submit(JobSpec(
        res=ResourceSpec(cpu=1.0, mem_bytes=1 << 30), licenses=dict(lic=1),
        task_res=ResourceSpec(cpu=1.0), ntasks=3, ntasks_per_node_max=2,
        node_num=2, partition="p0", sim_runtime=30.0), now=0.0) > 0
    started = sched.schedule_cycle(now=1.0)
    assert started, "nothing placed"
    end = sim.run_until_drained(start=2.0)
    assert not sched.pending and not sched.running
    assert all((n.avail == n.total).all() for n in meta.nodes.values())
    sched.wal.close()
    again = JobScheduler(MetaContainer(), SchedulerConfig(backfill=False),
                         device="cpu")
    again.recover(WriteAheadLog.replay(wal_path), now=end)
    again.rebuild_device_state()
    assert len(again.history) == len(sched.history) == 45
    # the planes: job timelines, the trace ring, explain, the native
    # solver under "auto" and a profiler capture
    assert sched.jobtrace.ledger(sorted(sched.history))["lost"] == []
    assert len(sched.cycle_trace) > 0
    auto = JobScheduler(meta, SchedulerConfig(backfill=False,
                                              solver="auto"),
                        device="cpu")
    auto.profiler_window.base_dir = tmp
    jid = auto.submit(JobSpec(res=ResourceSpec(cpu=1.0), partition="p0",
                              held=True), now=end)
    assert auto.submit(JobSpec(res=ResourceSpec(cpu=1.0), partition="p0"),
                       now=end) > 0
    assert auto.profiler_window.request(1)[0]
    assert auto.schedule_cycle(now=end)
    assert auto.stats["last_cycle"]["solver"] == "native"
    auto.schedule_cycle(now=end + 1)
    assert auto.explain_pending(jid, end)["gate"] == "held"
    assert auto.profiler_window.status()["captures_done"] == 1
    # the daemon's modules: config -> build -> lease -> serve -> client
    from cranesched_tpu_torch.craned.sim import SimCluster as Sim
    from cranesched_tpu_torch.ha import LeaderLease, capture_snapshot
    from cranesched_tpu_torch.rpc import CtldClient, crane_pb2 as pb, serve
    from cranesched_tpu_torch.utils.config import load_config
    cfg = load_config("etc/config.yaml")
    meta2, sched2 = cfg.build(device="cpu")
    lease = LeaderLease(os.path.join(tmp, "d.wal"))
    assert lease.acquire() == 1
    for node in meta2.nodes.values():
        node.alive = True
    sim2 = Sim(sched2)
    sim2.wire(sched2)
    server, port = serve(sched2, sim=sim2, tick_mode=True)
    client = CtldClient("127.0.0.1:%d" % port)
    assert client.submit(pb.JobSpec(partition="cpu", res=pb.ResourceSpec(
        cpu=1.0, mem_bytes=1 << 30), sim_runtime=5.0)).job_id == 1
    assert list(client.tick(1.0).started) == [1]
    assert capture_snapshot(sched2)["jobs"][0]["job_id"] == 1
    client.close()
    server.stop()
    lease.release()
    # the mesh and speculative solvers, and the hot standby's surface
    import numpy as np, torch
    from cranesched_tpu_torch.ha import HaFollower
    from cranesched_tpu_torch.models.solver import JobBatch, make_cluster_state
    from cranesched_tpu_torch.models.speculative import (
        solve_blocked, solve_speculative)
    from cranesched_tpu_torch.parallel import (
        make_node_mesh, solve_greedy_sharded)
    tot = np.tile(np.array([8, 8, 8], np.int32), (8, 1))
    jobs = JobBatch(req=torch.ones((6, 3), dtype=torch.int32),
                    node_num=torch.ones(6, dtype=torch.int32),
                    time_limit=torch.full((6,), 60, dtype=torch.int32),
                    part_mask=torch.ones((6, 8), dtype=torch.bool),
                    valid=torch.ones(6, dtype=torch.bool))
    mesh = make_node_mesh(["cpu"] * 4)
    outs = [fn(make_cluster_state(tot, tot, np.ones(8, bool),
                                  device="cpu"), jobs)[0].nodes.tolist()
            for fn in (lambda s, j: solve_greedy_sharded(s, j, mesh),
                       solve_speculative, solve_blocked)]
    assert outs[0] == outs[1] == outs[2], outs
    standby, sport = serve(sched2, tick_mode=True, standby=True)
    follower = HaFollower(standby, "127.0.0.1:1",
                          os.path.join(tmp, "s.wal"))
    assert follower.staleness() == float("inf")
    standby.stop()
    # federation: two shards, a gang through the arbiter, the usage
    # gossip, a live migration, and the cluster-wide metric merge
    from cranesched_tpu_torch.fed.arbiter import GangRequest
    from cranesched_tpu_torch.fed.sim import FederatedCluster
    from cranesched_tpu_torch.fed.usage import GlobalLimits
    from cranesched_tpu_torch.obs import REGISTRY, merge_metric_snapshots
    fc = FederatedCluster(dict(east=dict(a=2), west=dict(b=2)),
                          wal_dir=tmp, device="cpu",
                          global_limits=GlobalLimits(
                              max_submit_jobs_per_user=50),
                          publish_slack=0)
    for j in range(6):
        fc.submit(JobSpec(name="f%d" % j, res=ResourceSpec(cpu=2.0),
                          partition="ab"[j % 2], sim_runtime=5.0), 0.0)
        fc.pump_usage(0.0)
    fc.submit_gang(GangRequest(name="g", node_num=3, partitions=("a", "b"),
                               spec=JobSpec(res=ResourceSpec(cpu=1.0),
                                            sim_runtime=5.0)))
    fc.tick()
    assert fc.migrate("a", "west")["committed"]
    fc.run_until_drained(max_cycles=200)
    assert fc.arbiter.stats["commits"] == 1
    assert fc.ledger_by_name(["f%d" % j for j in range(6)])["lost"] == []
    merged = merge_metric_snapshots(dict(east=REGISTRY.snapshot(),
                                         west=REGISTRY.snapshot()))
    assert sum(merged["crane_fed_migrations_total"]["values"].values()) \\
        == 2.0
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("OK", len(started), end)
""")


def test_port_imports_without_jax_and_runs_a_cycle():
    mods = _port_modules()
    assert "cranesched_tpu_torch.ctld.scheduler" in mods
    assert "cranesched_tpu_torch.models.gpu_solver" in mods
    assert "cranesched_tpu_torch.models.solver_time" in mods
    assert "cranesched_tpu_torch.tools.kattr" in mods
    for mod in ("topo", "topo.model", "topo.place", "utils.hostlist",
                "ctld.accounting", "ctld.licenses", "models.packing",
                "models.preempt", "models.preempt_time", "ctld.wal",
                "ctld.archive", "ctld.acct_store", "obs", "obs.metrics",
                "obs.trace", "obs.events", "obs.slo", "obs.jobtrace",
                "obs.flight", "obs.introspect", "ctld.explain",
                "utils.native", "rpc", "rpc.consts", "rpc.crane_pb2",
                "rpc.stub", "rpc.convert", "rpc.interceptors",
                "rpc.client", "rpc.server", "utils.logging",
                "utils.filelock", "utils.pki", "utils.config",
                "ctld.auth", "ha", "ha.lease", "ha.snapshot",
                "parallel", "parallel.acquire", "ctld_main",
                "rpc.dispatcher", "rpc.rendezvous", "rpc.cfored",
                "craned.daemon", "craned.supervisor", "craned.cgroup",
                "craned_main", "coord", "utils.gres",
                "parallel.sharded", "parallel.distributed",
                "models.speculative", "ha.follower", "fed",
                "fed.shardmap", "fed.usage", "fed.shard", "fed.arbiter",
                "fed.rebalance", "fed.sim", "fed.query", "obs.fedobs",
                "replay", "cli"):
        assert f"cranesched_tpu_torch.{mod}" in mods, mod
    code = _CHILD.format(blocked=BLOCKED, mods=mods)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK")


NODE_PLANE = ("craned.daemon", "craned.supervisor", "craned.cgroup",
              "craned_main", "coord", "rpc.rendezvous", "rpc.cfored",
              "utils.gres")

_NODE_CHILD = textwrap.dedent("""
    import importlib, sys

    BLOCKED = {blocked!r}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())
    for mod in {mods!r}:
        importlib.import_module("cranesched_tpu_torch." + mod)
    from cranesched_tpu_torch.craned.daemon import CranedDaemon
    from cranesched_tpu_torch.craned_main import _parse_gres
    assert _parse_gres("gpu:a100:2,fpga::1") == dict(
        [("gpu:a100", 2), ("fpga:", 1)])
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("OK")
""")


def test_node_plane_imports_without_torch():
    """A craned and each step's supervisor must not load torch (~1.5 s
    and a few hundred MB a process, on hosts that run many of them):
    the node plane's modules import with torch and the JAX package
    blocked."""
    code = _NODE_CHILD.format(blocked=BLOCKED + ("torch",),
                              mods=NODE_PLANE)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK")
    from cranesched_tpu_torch.ops import resources
    from cranesched_tpu_torch.utils import gres
    assert resources.gres_key_pair is gres.gres_key_pair
    assert resources.gres_key_str is gres.gres_key_str


CLI_PLANE = ("cli", "rpc.client", "rpc.cfored", "rpc.crane_pb2",
             "obs.jobtrace", "obs.fedobs", "obs.trace", "fed.query",
             "utils.pki", "utils.gres")

_CLI_CHILD = textwrap.dedent("""
    import contextlib, importlib, io, json, sys, tempfile, os

    BLOCKED = {blocked!r}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())
    for mod in {mods!r}:
        importlib.import_module("cranesched_tpu_torch." + mod)
    from cranesched_tpu_torch import cli
    args = cli.build_parser().parse_args(
        ["cbatch", "--gres", "gpu:a100:2", "--array", "0-3%2",
         "--dependency", "afterok:1", "--mem", "2G"])
    spec = cli._build_spec(args)
    assert spec.res.gres["gpu:a100"] == 2 and spec.res.mem_bytes == 2 << 30
    assert cli._parse_array(args.array).max_concurrent == 2
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert cli.main(["--server", "127.0.0.1:1", "cqueue"]) == 3
    assert "cannot reach ctld" in err.getvalue()
    path = os.path.join(tempfile.mkdtemp(), "probe.json")
    with open(path, "w") as fh:
        json.dump(dict(device_acquisition=dict(acquired=True)), fh)
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["cflight", "--file", path]) == 0
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("OK")
""")


def test_cli_imports_without_torch():
    """A ``crane`` command must not load torch (~1.5 s and a few hundred
    MB a call): ``cli`` and the modules its commands import lazily load
    with torch and the JAX package blocked, and a command runs."""
    code = _CLI_CHILD.format(blocked=BLOCKED + ("torch",), mods=CLI_PLANE)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_nothing_of_jax():
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert "cranesched_tpu_torch" in roots
    assert not roots & set(BLOCKED), roots & set(BLOCKED)


def test_follower_imports_no_torch_of_its_own():
    """The hot standby's replication loop works on job records and the
    WAL: it imports no torch beyond what the scheduler does."""
    roots = _imported_roots(PORT / "ha" / "follower.py")
    assert "torch" not in roots and "cranesched_tpu_torch" in roots


def test_port_sources_import_nothing_of_jax():
    for path in PORT.rglob("*.py"):
        bad = _imported_roots(path) & set(BLOCKED)
        assert not bad, f"{path}: {bad}"


def test_crane_pb2_is_the_jax_packages_byte_for_byte():
    """Both packages register ``crane.proto`` in protobuf's default
    descriptor pool: a copy that differed by one byte of the descriptor
    would conflict there.  Identical, they share the message classes."""
    jax_pb2 = ROOT / "cranesched_tpu" / "rpc" / "crane_pb2.py"
    port_pb2 = PORT / "rpc" / "crane_pb2.py"
    assert port_pb2.read_bytes() == jax_pb2.read_bytes()
    from cranesched_tpu.rpc import crane_pb2 as a
    from cranesched_tpu_torch.rpc import crane_pb2 as b
    assert a.SubmitJobRequest is b.SubmitJobRequest
    assert a.DESCRIPTOR.serialized_pb == b.DESCRIPTOR.serialized_pb
