"""The port's hot standby and its promotion against the JAX package's (the
cases of ``tests/test_ha_failover.py`` the port lacked, and more).

Every scenario runs in process over real sockets on the CPU:

- a standby refuses mutations with FAILED_PRECONDITION, serves queries,
  and a failover-aware client rotates off it (both packages' pairs);
- a follower seeds from the leader's snapshot and tails its WAL through
  ``HaFetchSnapshot`` / ``HaFetchWal``: a JAX follower and a port
  follower of one port leader write byte-identical local WALs and the
  same shadow state;
- staleness-bounded reads: refused before the first sync and once the
  leader stops answering, served while caught up;
- a failover flip between two port controllers: the leader dies, the
  standby promotes past its epoch, every acknowledged job is there, a
  new submit is placed by a cycle, and a craned that learned the new
  epoch refuses the deposed leader's pushes;
- the two cross-package followings: a JAX standby follows a port leader
  and a port standby a JAX leader, each promoting with every job;
- a snapshot past gRPC's 4 MiB default reply, which only the port's
  follower pulls (ROADMAP.md C6);
- ``ctld_main --ha-standby`` needs ``--ha-peer``.
"""

import json
import os
import socket
import subprocess
import sys
import time

import grpc
import pytest

import cranesched_tpu.craned.sim as jsim
import cranesched_tpu.ctld as jctld
import cranesched_tpu.ctld.wal as jwal
import cranesched_tpu.ha.follower as jfollower
import cranesched_tpu.ha.lease as jlease
import cranesched_tpu.rpc as jrpc
import cranesched_tpu.rpc.client as jclient
import cranesched_tpu_torch.craned.sim as tsim
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.ctld.wal as twal
import cranesched_tpu_torch.ha.follower as tfollower
import cranesched_tpu_torch.ha.lease as tlease
import cranesched_tpu_torch.rpc as trpc
import cranesched_tpu_torch.rpc.client as tclient
from cranesched_tpu_torch.craned.daemon import CranedDaemon
from cranesched_tpu_torch.ha.snapshot import Snapshotter
from cranesched_tpu_torch.rpc import crane_pb2 as pb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

JAX = dict(ctld=jctld, sim=jsim, wal=jwal, follower=jfollower,
           lease=jlease, rpc=jrpc, client=jclient)
PORT = dict(ctld=tctld, sim=tsim, wal=twal, follower=tfollower,
            lease=tlease, rpc=trpc, client=tclient)
CYCLE = 0.2


def _wait(pred, timeout=20.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


class Ctld:
    """One controller of a pair, in process: a sim node plane of four
    nodes (the same names in the same order on both sides), its own WAL,
    a leader (lease taken, recovered) or a standby with its follower."""

    def __init__(self, pkg, tmp_path, name, peer=None, tick_mode=True,
                 poll=0.15):
        self.pkg = pkg
        self.wal_path = str(tmp_path / f"{name}.wal")
        ctld = pkg["ctld"]
        meta = ctld.MetaContainer()
        for i in range(4):
            meta.add_node(f"cn{i:02d}", meta.layout.encode(
                cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
                is_capacity=True))
            meta.craned_up(i)
        kw = {"device": "cpu"} if pkg is PORT else {}
        self.sched = ctld.JobScheduler(meta, ctld.SchedulerConfig(
            backfill=False, priority_type="basic"), **kw)
        self.sim = pkg["sim"].SimCluster(self.sched)
        self.sim.wire(self.sched)
        self.lease = self.follower = None
        if peer is None:
            self.lease = pkg["lease"].LeaderLease(self.wal_path)
            self.sched.fencing_epoch = self.lease.acquire()
            self.sched.wal = pkg["wal"].WriteAheadLog(self.wal_path)
        self.server, self.port = pkg["rpc"].serve(
            self.sched, sim=self.sim, tick_mode=tick_mode,
            cycle_interval=CYCLE, standby=peer is not None,
            peer_address=peer or "")
        self.address = f"127.0.0.1:{self.port}"
        if peer is not None:
            self.follower = pkg["follower"].HaFollower(
                self.server, peer, self.wal_path, poll_interval=poll,
                miss_threshold=3)
            self.server.ha_follower = self.follower

    def client(self):
        return self.pkg["client"].CtldClient(self.address, timeout=10.0)

    def jobs(self):
        s = self.sched
        return {jid: job.status.name for col in (s.pending, s.running,
                                                 s.history)
                for jid, job in col.items()}

    def kill(self):
        """SIGKILL's effect: stop answering, drop the flock (an OS lock
        dies with its holder), leave the WAL and snapshot files."""
        if self.follower is not None:
            self.follower.stop()
        self.server.stop()
        lease = self.lease or (self.follower.lease
                               if self.follower is not None else None)
        if lease is not None and lease.held:
            lease.release()
        if self.sched.wal is not None:
            self.sched.wal.close()


def _spec(runtime=1000.0, cpu=2.0):
    return pb.JobSpec(res=pb.ResourceSpec(cpu=cpu, mem_bytes=1 << 30,
                                          memsw_bytes=1 << 30),
                      sim_runtime=runtime)


def _submit_and_tick(leader, n=12, now=5.0):
    """``n`` acknowledged submits and one placing tick on a leader."""
    client = leader.client()
    try:
        acked = [client.submit(_spec(cpu=float(1 + i % 4))).job_id
                 for i in range(n)]
        assert all(acked)
        client.tick(now)
        return acked
    finally:
        client.close()


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "port"])
def test_standby_refuses_mutations_serves_queries(tmp_path, pkg):
    leader = Ctld(pkg, tmp_path, "leader")
    standby = Ctld(pkg, tmp_path, "standby", peer=leader.address)
    direct = ha = ha2 = None
    try:
        direct = standby.client()
        with pytest.raises(grpc.RpcError) as ei:
            direct.submit(_spec())
        assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert "not leader" in (ei.value.details() or "")
        assert leader.address in ei.value.details()
        assert list(direct.query_jobs().jobs) == []
        st = direct.ha_status()
        assert st.role == "standby" and st.leader_address == leader.address
        ha = pkg["client"].HaCtldClient([standby.address, leader.address])
        jid = ha.submit(_spec()).job_id
        assert jid == 1 and leader.sched.job_info(jid) is not None
        assert ha.ha_status().role == "leader"
        dead = f"127.0.0.1:{_free_port()}"
        ha2 = pkg["client"].HaCtldClient([dead, leader.address])
        assert [j.job_id for j in ha2.query_jobs_stream()] == [jid]
    finally:
        for c in (direct, ha, ha2):
            if c is not None:
                c.close()
        standby.kill()
        leader.kill()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_snapshot_plus_tail_through_the_replication_rpcs(tmp_path):
    """One port leader (with a snapshot of its own, which rotated its
    WAL); a JAX follower and a port follower each pull a snapshot
    (``HaFetchSnapshot``), then the tail past it (``HaFetchWal``).  Their
    snapshots are equal, their local WALs byte-identical, and their
    shadow states the leader's jobs."""
    leader = Ctld(PORT, tmp_path, "leader")
    followers = []
    try:
        acked = _submit_and_tick(leader, n=10)
        snap = Snapshotter(leader.sched, leader.sched.wal,
                           leader.server._lock, leader.wal_path,
                           interval=3600.0)
        assert snap.snap_once() > 0
        for pkg, name in ((JAX, "jf"), (PORT, "tf")):
            f = Ctld(pkg, tmp_path, name, peer=leader.address)
            followers.append(f)
            assert f.follower.poll_once()
        snap_seq = leader.sched.wal.durable_seq
        client = leader.client()
        acked += [client.submit(_spec()).job_id for _ in range(5)]
        assert client.cancel(acked[0]).ok
        client.close()
        want = leader.jobs()
        for f in followers:
            assert f.follower.poll_once()
            assert f.follower.applied_seq == leader.sched.wal.durable_seq
            assert f.follower.leader_seq == leader.sched.wal.durable_seq
            assert f.jobs() == want
            assert f.follower.store.load()["seq"] == snap_seq
            assert f.pkg["wal"].WriteAheadLog._scan_max_seq(f.wal_path) \
                == leader.sched.wal.durable_seq
        # the leader's event ring rides along (test_flight.py:609-635's
        # promotion half): ingested once, in the leader's order
        leader.sched.emit_node_event("node_down", "cn03", now=9.0)
        want_events = [r["type"] for r in leader.sched.events.since()]
        for f in followers:
            assert f.follower.poll_once() and f.follower.poll_once()
            assert f.sched.events.remote_seq == \
                leader.sched.events.last_seq
            assert [r["type"] for r in f.sched.events.since()] == \
                want_events
        jf, tf = followers
        with open(jf.wal_path, "rb") as a, open(tf.wal_path, "rb") as b:
            tail = a.read()
            assert tail and tail == b.read()
        assert jf.follower.store.load() == tf.follower.store.load()
        # a restarted port standby resumes from its local snapshot + tail
        tf.kill()
        again = Ctld(PORT, tmp_path, "tf", peer=leader.address)
        followers.append(again)
        assert again.follower.applied_seq == leader.sched.wal.durable_seq
        assert again.jobs() == want
    finally:
        for f in followers:
            f.kill()
        leader.kill()


def test_snapshot_past_grpc_default_reply_limit(tmp_path):
    """ROADMAP.md C6, a deliberate difference: a leader's snapshot is one
    reply, ~1.2 KB a job.  Past gRPC's 4 MiB default (here 4,000 jobs)
    the JAX package's follower cannot pull it (RESOURCE_EXHAUSTED, a
    missed poll, over and over); the port's takes any size."""
    leader = Ctld(PORT, tmp_path, "leader")
    followers = []
    try:
        client = leader.client()
        for _ in range(4):
            assert all(r.job_id for r in client.submit_many(
                [_spec() for _ in range(1000)]).replies)
        client.close()
        big = tclient.CtldClient(leader.address, max_receive_bytes=-1)
        assert len(big.ha_fetch_snapshot().payload) > 4 << 20
        big.close()
        jf = Ctld(JAX, tmp_path, "jf", peer=leader.address)
        tf = Ctld(PORT, tmp_path, "tf", peer=leader.address)
        followers += [jf, tf]
        assert not jf.follower.poll_once()
        assert jf.follower._misses == 1 and jf.jobs() == {}
        assert tf.follower.poll_once()
        assert tf.jobs() == leader.jobs() and len(tf.jobs()) == 4000
    finally:
        for f in followers:
            f.kill()
        leader.kill()


def test_staleness_bounded_reads(tmp_path):
    leader = Ctld(PORT, tmp_path, "leader")
    standby = Ctld(PORT, tmp_path, "standby", peer=leader.address)
    client = standby.client()
    try:
        _submit_and_tick(leader, n=4)
        # never caught up: a bounded read is refused, an unbounded served
        with pytest.raises(grpc.RpcError) as ei:
            client.query_jobs(max_staleness=5.0)
        assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert "exceeds max_staleness" in ei.value.details()
        assert list(client.query_jobs().jobs) == []
        assert standby.follower.poll_once()
        reply = client.query_jobs(max_staleness=5.0)
        assert len(reply.jobs) == 4
        assert reply.durable_seq == leader.sched.wal.durable_seq
        for call in (lambda: client.query_cluster(max_staleness=5.0),
                     lambda: client.query_stats(max_staleness=5.0)):
            assert call().durable_seq == reply.durable_seq
        # the leader stops answering: the view ages past the bound
        leader.server.stop()
        assert not standby.follower.poll_once()
        time.sleep(0.3)
        with pytest.raises(grpc.RpcError) as ei:
            client.query_jobs(max_staleness=0.2)
        assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
        assert leader.address in ei.value.details()
        assert len(client.query_jobs().jobs) == 4
        ha = json.loads(client.query_stats().json)["ha"]
        assert ha["role"] == "standby" and ha["replication_lag"] == 0
        assert ha["wal_seq"] == reply.durable_seq
    finally:
        client.close()
        standby.kill()
        leader.kill()


def _flip(leader_pkg, standby_pkg, tmp_path):
    """A real-time leader of one package, a standby of the other that
    follows it; kill the leader and wait for the promotion.  Returns
    (leader, standby, acknowledged ids, the leader's jobs at the kill,
    its running ids)."""
    leader = Ctld(leader_pkg, tmp_path, "leader", tick_mode=False)
    standby = Ctld(standby_pkg, tmp_path, "standby", peer=leader.address,
                   tick_mode=False)
    standby.follower.start()
    client = leader.client()
    try:
        acked = [client.submit(_spec(cpu=float(2 + i % 3))).job_id
                 for i in range(16)]
        assert _wait(lambda: len(leader.sched.running) > 0)
    finally:
        client.close()
    assert _wait(lambda: standby.follower.applied_seq
                 == leader.sched.wal.durable_seq
                 and standby.jobs() == leader.jobs())
    with pytest.raises(grpc.RpcError) as ei:
        sc = standby.client()
        try:
            sc.submit(_spec())
        finally:
            sc.close()
    assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
    old_epoch = leader.sched.fencing_epoch
    at_kill = leader.jobs()
    running = set(leader.sched.running)
    leader.kill()
    assert _wait(lambda: standby.follower.promoted.is_set())
    assert standby.server.ha_role == "leader"
    assert standby.sched.fencing_epoch > old_epoch
    return leader, standby, acked, at_kill, running


def test_failover_flip_between_port_controllers(tmp_path):
    leader, standby, acked, at_kill, running = _flip(PORT, PORT, tmp_path)
    client = standby.client()
    try:
        # every acknowledged job, in its replicated state; the running
        # ones stay RUNNING (this standby's own sim never ran them)
        assert set(acked) <= set(standby.jobs())
        assert standby.jobs() == at_kill
        assert set(standby.sched.running) == running
        assert client.ha_status().role == "leader"
        assert standby.server.failovers == 1
        # a new submit is acknowledged and placed by a cycle
        jid = client.submit(_spec(runtime=30.0, cpu=1.0)).job_id
        assert jid == max(acked) + 1
        assert _wait(lambda: jid in standby.sched.running)
        rows = standby.sched.cycle_trace.snapshot()
        assert rows and rows[-1]["device"] == "cpu"
        # a craned learns the new term at registration and then refuses
        # the deposed leader's pushes
        d = CranedDaemon("cn00", standby.address, cpu=8.0,
                         mem_bytes=16 << 30, workdir=str(tmp_path / "cd"),
                         cgroup_root=str(tmp_path / "nocgroup"))
        assert d._register()
        assert d._fencing_epoch == standby.sched.fencing_epoch
        rep = d.TerminateStep(pb.JobIdRequest(
            job_id=jid, fencing_epoch=standby.sched.fencing_epoch - 1),
            None)
        assert not rep.ok and "fenced" in rep.error
        assert d.TerminateStep(pb.JobIdRequest(
            job_id=999, fencing_epoch=standby.sched.fencing_epoch),
            None).ok
    finally:
        client.close()
        standby.kill()


@pytest.mark.parametrize("leader_pkg,standby_pkg", [(PORT, JAX),
                                                    (JAX, PORT)],
                         ids=["jax-follows-port", "port-follows-jax"])
def test_cross_package_following(tmp_path, leader_pkg, standby_pkg):
    leader, standby, acked, at_kill, running = _flip(
        leader_pkg, standby_pkg, tmp_path)
    client = standby.client()
    try:
        assert standby.jobs() == at_kill
        assert set(standby.sched.running) == running
        jid = client.submit(_spec(runtime=30.0, cpu=1.0)).job_id
        assert jid == max(acked) + 1
        assert _wait(lambda: jid in standby.sched.running)
    finally:
        client.close()
        standby.kill()


def test_ctld_main_standby_needs_a_peer(tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text("ClusterName: t\nListen: 127.0.0.1:0\n"
                   f"Wal: {tmp_path}/w/ctld.wal\n"
                   "Nodes:\n  - name: cn0\n    cpu: 4\n    memory: 4G\n"
                   "    partitions: [p]\nPartitions:\n  - name: p\n")
    proc = subprocess.run(
        [sys.executable, "-m", "cranesched_tpu_torch.ctld_main", "-c",
         str(cfg), "--sim", "--device", "cpu", "--ha-standby"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 2
    assert "--ha-standby requires --ha-peer" in proc.stderr
