"""The port's federation (``cranesched_tpu_torch/fed/``) against the JAX
package's, on the CPU (the cases of ``tests/test_federation.py``, and more).

Every scenario runs once on the JAX package and once on the port
(``device="cpu"``) from the same inputs, and the two records are compared
exactly (tolerance 0): placements by job name with their start times and
nodes, the arbiter's stats, ``fc.ledger()``, the RPC replies, the events and
the WAL files byte for byte.  The JAX test's own assertions run on both.

- the shard map: routing, the wire form, disjointness;
- the RPC layer: a misrouted submit forwarded one hop with a redirect hint
  and the route learned, no forwarding loop, ``QueryShardMap`` and the
  ``fed`` document of ``QueryStats``, the lease plane's three verbs, and
  follower reads past ``max_staleness``;
- the arbiter's two-phase gang commit when a shard dies after its reserve;
- a lease's TTL with no arbiter;
- one controller against a two-shard federation over the same partitions;
- a seeded storm (three shards, gangs, a migration, global limits);
- a JAX shard and a port shard in one federation over gRPC: a forward each
  way, a lease round trip each way, and a migration;
- a federation WAL written by either package recovers in the other.
"""

import json
import os
import shutil
import socket

import grpc
import numpy as np
import pytest

import cranesched_tpu.ctld as jctld
import cranesched_tpu.fed.arbiter as jarbiter
import cranesched_tpu.fed.shard as jshard
import cranesched_tpu.fed.shardmap as jshardmap
import cranesched_tpu.fed.sim as jfsim
import cranesched_tpu.fed.usage as jusage
import cranesched_tpu.obs as jobs
import cranesched_tpu.rpc as jrpc
import cranesched_tpu.rpc.client as jclient
import cranesched_tpu.rpc.crane_pb2 as jpb
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.fed.arbiter as tarbiter
import cranesched_tpu_torch.fed.shard as tshard
import cranesched_tpu_torch.fed.shardmap as tshardmap
import cranesched_tpu_torch.fed.sim as tfsim
import cranesched_tpu_torch.fed.usage as tusage
import cranesched_tpu_torch.obs as tobs
import cranesched_tpu_torch.rpc as trpc
import cranesched_tpu_torch.rpc.client as tclient
import cranesched_tpu_torch.rpc.crane_pb2 as tpb

JAX = dict(name="jax", ctld=jctld, arbiter=jarbiter, shard=jshard,
           shardmap=jshardmap, fsim=jfsim, usage=jusage, obs=jobs,
           rpc=jrpc, client=jclient, pb=jpb, dev={})
PORT = dict(name="port", ctld=tctld, arbiter=tarbiter, shard=tshard,
            shardmap=tshardmap, fsim=tfsim, usage=tusage, obs=tobs,
            rpc=trpc, client=tclient, pb=tpb, dev={"device": "cpu"})
BOTH = (JAX, PORT)


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on each package; the records must be
    equal.  Returns the port's."""
    jrec = scenario(JAX, *args)
    trec = scenario(PORT, *args)
    assert trec == jrec
    return trec


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _pb_spec(P, cpu=1.0, runtime=30.0, **kw):
    pb = P["pb"]
    return pb.JobSpec(res=pb.ResourceSpec(cpu=cpu, mem_bytes=1 << 30,
                                          memsw_bytes=1 << 30),
                      sim_runtime=runtime, **kw)


def _shard_sched(P, name, partitions, nodes_per=2):
    c = P["ctld"]
    meta = c.MetaContainer()
    nid = 0
    for part in partitions:
        for i in range(nodes_per):
            meta.add_node(f"{name}-{part}-n{i}",
                          meta.layout.encode(cpu=8.0,
                                             mem_bytes=16 << 30,
                                             memsw_bytes=16 << 30,
                                             is_capacity=True),
                          partitions=(part,))
            meta.craned_up(nid)
            nid += 1
    return c.JobScheduler(meta, c.SchedulerConfig(backfill=False),
                          **P["dev"])


def _fed_pair(east_pkg, west_pkg, planes=False):
    """Two live shard servers wired through one shard map: east owns
    batch+debug, west owns gpu; each server of its own package."""
    pkgs = {"east": east_pkg, "west": west_pkg}
    ports = {"east": _free_port(), "west": _free_port()}
    servers = {}
    for name in ("east", "west"):
        P = pkgs[name]
        sm = P["shardmap"]
        shard_map = sm.ShardMap([
            sm.ShardSpec("east", ("batch", "debug"),
                         address=f"127.0.0.1:{ports['east']}"),
            sm.ShardSpec("west", ("gpu",),
                         address=f"127.0.0.1:{ports['west']}"),
        ])
        sched = _shard_sched(P, name, shard_map.partitions_of(name))
        if planes:
            P["shard"].FedShardPlane(sched, name)
        server, bound = P["rpc"].serve(
            sched, tick_mode=True, address=f"127.0.0.1:{ports[name]}",
            shard_name=name, shard_map=shard_map)
        assert bound == ports[name]
        servers[name] = server
    return ports, servers


def _stop(clients, servers):
    for c in clients:
        if c is not None:
            c.close()
    for s in servers.values():
        s.stop()


def _gang_spec(P, cpu=1.0, runtime=5.0):
    c = P["ctld"]
    return c.JobSpec(user="u", res=c.ResourceSpec(cpu=cpu,
                                                  mem_bytes=1 << 30,
                                                  memsw_bytes=1 << 30),
                     sim_runtime=runtime)


def _wal_bytes(wal_dir):
    return {n: open(os.path.join(wal_dir, n), "rb").read()
            for n in sorted(os.listdir(wal_dir)) if n.endswith(".wal")}


def _outcome(fc):
    """Per-shard job outcomes by name (ids are shard-local): status,
    start and end times and node names."""
    out = {}
    for name, shard in sorted(fc.shards.items()):
        s = shard.scheduler
        for col in (s.pending, s.running, s.history):
            for job in col.values():
                out[(name, job.spec.name, job.job_id)] = (
                    job.status.name, job.start_time, job.end_time,
                    tuple(shard.meta.nodes[n].name for n in job.node_ids))
    return out


# ---------------------------------------------------------------------------
# shard map
# ---------------------------------------------------------------------------

def test_shard_map_routing_and_disjointness():
    def scenario(P):
        sm = P["shardmap"]
        m = sm.ShardMap.from_config({"Shards": [
            {"name": "east", "partitions": ["batch", "debug"],
             "address": "h1:1", "followers": ["h1:2"]},
            {"name": "west", "partitions": ["gpu"], "address": "h2:1"},
        ]})
        assert m.shard_for_partition("gpu") == "west"
        assert m.shard_for_partition("debug") == "east"
        assert m.shard_for_partition("nope") == ""
        assert m.spec("east").addresses == ("h1:1", "h1:2")
        assert sm.ShardMap.from_doc(m.doc()).doc() == m.doc()
        with pytest.raises(ValueError, match="disjoint") as info:
            sm.ShardMap([sm.ShardSpec("a", ("p",)),
                         sm.ShardSpec("b", ("p",))])
        return m.doc(), m.names(), str(info.value)
    both(scenario)


# ---------------------------------------------------------------------------
# RPC layer: routing + forwarding
# ---------------------------------------------------------------------------

def _misrouted(P):
    ports, servers = _fed_pair(P, P)
    east = west = ha = None
    reg = P["obs"].REGISTRY
    try:
        east = P["client"].CtldClient(f"127.0.0.1:{ports['east']}")
        fwd0 = reg.counter("crane_fed_forwards_total").value()
        reply = east.submit(_pb_spec(P, partition="gpu"))
        assert reply.job_id == 1 and not reply.error
        assert reply.shard == "west"
        assert reply.redirect_address == f"127.0.0.1:{ports['west']}"
        assert servers["west"].scheduler.job_info(1) is not None
        assert servers["east"].scheduler.job_info(1) is None
        assert reg.counter("crane_fed_forwards_total").value() == fwd0 + 1
        events = [(e["type"], e["job_id"], e["detail"])
                  for e in servers["east"].scheduler.events.since()]
        assert ("fed_forward", 1, "partition=gpu -> shard=west") in events
        local = east.submit(_pb_spec(P, partition="batch"))
        assert local.shard == "east" and local.job_id == 1
        ha = P["client"].HaCtldClient([f"127.0.0.1:{ports['east']}"])
        assert ha.submit(_pb_spec(P, partition="gpu")).job_id == 2
        fwd1 = reg.counter("crane_fed_forwards_total").value()
        assert ha.submit(_pb_spec(P, partition="gpu")).job_id == 3
        assert reg.counter("crane_fed_forwards_total").value() == fwd1
        west = P["client"].CtldClient(f"127.0.0.1:{ports['west']}")
        many = east.submit_many([_pb_spec(P, partition="batch"),
                                 _pb_spec(P, partition="gpu")])
        assert [r.shard for r in many.replies] == ["east", "west"]
        return ([(r.job_id, r.shard, r.error, r.map_epoch)
                 for r in many.replies], events,
                {n: sorted(s.scheduler.pending) for n, s in
                 servers.items()})
    finally:
        _stop((east, west, ha), servers)


def test_misrouted_submit_forwarded_and_route_learned():
    both(_misrouted)


def test_already_forwarded_submit_redirects_instead_of_looping():
    def scenario(P):
        ports, servers = _fed_pair(P, P)
        east = None
        try:
            east = P["client"].CtldClient(f"127.0.0.1:{ports['east']}")
            reply = east.submit(_pb_spec(P, partition="gpu"),
                                forwarded=True)
            assert reply.job_id == 0
            assert "belongs to shard 'west'" in reply.error
            assert reply.redirect_address == \
                f"127.0.0.1:{ports['west']}"
            assert servers["west"].scheduler.job_info(1) is None
            return reply.job_id, reply.error, reply.shard
        finally:
            _stop((east,), servers)
    both(scenario)


def test_forward_after_a_peer_outage_dials_anew():
    """ROADMAP C9 (the port only): a failed call to a peer shard (the usage
    gossip's, while the peer is down) drops its cached client, so the first
    forward once the peer is up dials anew instead of failing fast on a
    channel in gRPC's reconnect backoff (1 s and more after one refusal)."""
    P = PORT
    ports = {"east": _free_port(), "west": _free_port()}
    sm = P["shardmap"]
    shard_map = sm.ShardMap([
        sm.ShardSpec("east", ("batch", "debug"),
                     address=f"127.0.0.1:{ports['east']}"),
        sm.ShardSpec("west", ("gpu",),
                     address=f"127.0.0.1:{ports['west']}"),
    ])
    west_addr = f"127.0.0.1:{ports['west']}"

    def start(name):
        server, bound = P["rpc"].serve(
            _shard_sched(P, name, shard_map.partitions_of(name)),
            tick_mode=True, address=f"127.0.0.1:{ports[name]}",
            shard_name=name, shard_map=shard_map)
        assert bound == ports[name]
        servers[name] = server

    servers, cli = {}, None
    try:
        start("east")
        # west is down: east's call to it is refused, and east forgets
        # the client whose channel now backs off
        with pytest.raises(grpc.RpcError) as exc:
            servers["east"]._fed_call(
                west_addr, lambda c: c.fetch_usage(shard="east"))
        assert exc.value.code() == grpc.StatusCode.UNAVAILABLE
        assert west_addr not in servers["east"]._fwd_clients
        start("west")
        cli = P["client"].CtldClient(f"127.0.0.1:{ports['east']}")
        reply = cli.submit(_pb_spec(P, partition="gpu"))
        assert (reply.job_id, reply.shard, reply.error) == (1, "west", "")
        assert servers["west"].scheduler.job_info(1) is not None
    finally:
        _stop((cli,), servers)


def test_query_shard_map_and_fed_stats():
    def scenario(P):
        ports, servers = _fed_pair(P, P)
        cli = None
        try:
            cli = P["client"].CtldClient(f"127.0.0.1:{ports['east']}")
            reply = cli.query_shard_map()
            assert reply.shard == "east" and not reply.error
            assert [s.name for s in reply.shards] == ["east", "west"]
            assert list(reply.shards[0].partitions) == ["batch", "debug"]
            doc = json.loads(cli.query_stats().json)
            assert doc["fed"]["shard"] == "east"
            fed = dict(doc["fed"])
            for s in fed["shards"]:
                s["address"] = s["address"].rsplit(":", 1)[0]
            return reply.map_epoch, fed
        finally:
            _stop((cli,), servers)
    both(scenario)


def _lease_roundtrip(east_pkg, west_pkg, client_pkg):
    """The arbiter's three verbs over the wire against east."""
    ports, servers = _fed_pair(east_pkg, west_pkg)
    sched = servers["east"].scheduler
    east_pkg["shard"].FedShardPlane(sched, "east")
    P = client_pkg
    pb = P["pb"]
    cli = None
    try:
        cli = P["client"].CtldClient(f"127.0.0.1:{ports['east']}")
        res = pb.ResourceSpec(cpu=1.0, mem_bytes=1 << 30,
                              memsw_bytes=1 << 30)
        lease = cli.lease_nodes("L1", "batch", 2, res=res, ttl=60.0)
        assert lease.ok and len(lease.node_names) == 2
        assert all(not sched.meta.node_by_name(n).schedulable
                   for n in lease.node_names)
        refuse = cli.lease_nodes("L2", "batch", 1, res=res, ttl=60.0)
        assert not refuse.ok and "0/1 nodes free" in refuse.error
        conf = cli.confirm_gang(
            "L1", "g1", _pb_spec(P, partition="batch", name="g1@batch",
                                 node_num=2),
            node_names=list(lease.node_names),
            fencing_epoch=lease.fencing_epoch)
        assert conf.ok and conf.job_id == 1
        assert sched.running[1].spec.name == "g1@batch"
        stale = cli.confirm_gang("L1", "g1", _pb_spec(P),
                                 fencing_epoch=99)
        assert not stale.ok and "no such lease" in stale.error
        assert not cli.release_lease("L1").ok
        return (list(lease.node_names), lease.fencing_epoch,
                refuse.error, conf.job_id, stale.error,
                sorted(sched.running[1].node_ids))
    finally:
        _stop((cli,), servers)


def test_lease_confirm_release_rpc_roundtrip():
    both(lambda P: _lease_roundtrip(P, P, P))


class _StubFollower:
    """Just the surface the staleness guard and ``_durable_seq`` read."""

    def __init__(self, stale, applied_seq=7):
        self._stale = stale
        self.applied_seq = applied_seq

    def staleness(self):
        return self._stale


def test_follower_refuses_read_past_max_staleness():
    def scenario(P):
        leader, lport = P["rpc"].serve(_shard_sched(P, "s", ("batch",)),
                                       tick_mode=True)
        standby, sport = P["rpc"].serve(
            _shard_sched(P, "s", ("batch",)), tick_mode=True,
            standby=True, peer_address=f"127.0.0.1:{lport}")
        standby.ha_follower = _StubFollower(10.0, applied_seq=7)
        reg = P["obs"].REGISTRY
        direct = ha = None
        try:
            direct = P["client"].CtldClient(f"127.0.0.1:{sport}")
            reply = direct.query_jobs(max_staleness=0.0)
            assert list(reply.jobs) == [] and reply.durable_seq == 7
            stale0 = reg.counter(
                "crane_fed_stale_reads_refused_total").value()
            with pytest.raises(grpc.RpcError) as ei:
                direct.query_jobs(max_staleness=0.5)
            assert ei.value.code() == grpc.StatusCode.FAILED_PRECONDITION
            assert "exceeds max_staleness" in (ei.value.details() or "")
            assert reg.counter(
                "crane_fed_stale_reads_refused_total").value() == \
                stale0 + 1
            for call in (direct.query_cluster, direct.query_stats,
                         direct.query_events):
                with pytest.raises(grpc.RpcError) as ei:
                    call(max_staleness=0.5)
                assert ei.value.code() == \
                    grpc.StatusCode.FAILED_PRECONDITION
            standby.ha_follower = _StubFollower(0.1, applied_seq=42)
            seq = direct.query_jobs(max_staleness=5.0).durable_seq
            assert seq == 42
            standby.ha_follower = _StubFollower(10.0)
            ha = P["client"].HaCtldClient([f"127.0.0.1:{sport}",
                                           f"127.0.0.1:{lport}"])
            assert list(ha.query_jobs(max_staleness=0.5).jobs) == []
            return seq
        finally:
            for c in (direct, ha):
                if c is not None:
                    c.close()
            standby.stop()
            leader.stop()
    both(scenario)


# ---------------------------------------------------------------------------
# two-phase gang commit under shard failure
# ---------------------------------------------------------------------------

def test_shard_crash_mid_reserve_releases_and_never_double_places(
        tmp_path):
    def scenario(P):
        wal_dir = tmp_path / P["name"]
        wal_dir.mkdir()
        fc = P["fsim"].FederatedCluster(
            {"east": {"batch": 2}, "west": {"gpu": 2}},
            wal_dir=str(wal_dir), **P["dev"])
        fc.shards["east"].crash_after_lease = True
        fc.submit_gang(P["arbiter"].GangRequest(
            name="g1", node_num=4, partitions=("batch", "gpu"),
            spec=_gang_spec(P)))
        for _ in range(3):
            fc.tick()
        assert not fc.shards["east"].alive
        assert fc.arbiter.stats["aborts"] >= 1
        assert fc.arbiter.stats["commits"] == 0
        fc.recover("east")
        assert not fc.shards["east"].fed.leases
        fc.run_until_drained()
        assert fc.arbiter.stats["commits"] == 1
        led = fc.ledger()
        assert led["lost"] == 0 and led["doubled"] == 0
        members = sorted(
            j.spec.name for s in fc.shards.values()
            for j in s.scheduler.history.values()
            if j.spec.name.startswith("g1@"))
        assert members == ["g1@batch", "g1@gpu"]
        return (dict(fc.arbiter.stats), led, _outcome(fc),
                _wal_bytes(wal_dir), fc.now)
    both(scenario)


def test_lease_ttl_expires_without_arbiter(tmp_path):
    def scenario(P):
        shard = P["fsim"].SimShard(
            "east", {"batch": 2},
            wal_path=str(tmp_path / f"{P['name']}-east.wal"), **P["dev"])
        req = _gang_spec(P).res.encode(shard.meta.layout)
        names, epoch, seq = shard.fed.lease_nodes(
            "L1", "batch", 2, req, ttl=10.0, now=0.0)
        assert all(not shard.meta.node_by_name(n).schedulable
                   for n in names)
        shard.tick(5.0)
        assert "L1" in shard.fed.leases
        shard.tick(11.0)
        assert "L1" not in shard.fed.leases
        assert all(shard.meta.node_by_name(n).schedulable for n in names)
        events = [(e["type"], e["detail"])
                  for e in shard.scheduler.events.since()]
        return names, epoch, seq, events, open(shard.wal_path, "rb").read()
    both(scenario)


# ---------------------------------------------------------------------------
# single-controller vs. federated parity
# ---------------------------------------------------------------------------

def _suffix(meta, nid):
    return meta.nodes[nid].name.split("-", 1)[1]


def _placements(sched):
    out = {}
    for job in list(sched.history.values()) + list(
            sched.running.values()):
        out[job.spec.name] = (
            job.start_time,
            tuple(sorted(_suffix(sched.meta, n) for n in job.node_ids)))
    return out


def test_single_vs_federated_parity():
    """Disjoint partitions: a two-shard federation and one controller
    over the union place every job at the same time on the same nodes,
    in each package, and the port's placements are the JAX package's."""
    def scenario(P):
        c = P["ctld"]
        layout = {"batch": 3, "gpu": 2}
        specs = []
        for i in range(24):
            part = "gpu" if i % 3 == 0 else "batch"
            specs.append(c.JobSpec(
                name=f"j{i:03d}", user="u", partition=part,
                res=c.ResourceSpec(cpu=2.0 + (i % 3) * 2.0,
                                   mem_bytes=1 << 30, memsw_bytes=1 << 30),
                sim_runtime=3.0 + (i % 5)))
        solo = P["fsim"].SimShard("solo", layout, **P["dev"])
        for spec in specs:
            solo.submit(spec, 0.0)
        now = 0.0
        while now < 1000.0 and not solo.drained():
            now += 1.0
            solo.tick(now)
        assert solo.drained()
        fc = P["fsim"].FederatedCluster(
            {"east": {"batch": 3}, "west": {"gpu": 2}}, **P["dev"])
        for spec in specs:
            fc.submit(spec, 0.0)
        fc.run_until_drained(max_cycles=1000)
        fed = {}
        for shard in fc.shards.values():
            fed.update(_placements(shard.scheduler))
        assert fed == _placements(solo.scheduler)
        assert len(fed) == len(specs)
        return fed
    both(scenario)


# ---------------------------------------------------------------------------
# a seeded storm: three shards, gangs, a migration, global limits
# ---------------------------------------------------------------------------

def _storm_inputs(seed):
    rng = np.random.default_rng(seed)
    n = 90
    return dict(
        part=rng.integers(0, 5, n), cpu=rng.integers(1, 9, n),
        mem=rng.integers(1, 9, n), runtime=rng.integers(2, 12, n),
        node_num=rng.integers(1, 3, n), user=rng.integers(0, 3, n),
        acct=rng.integers(0, 2, n), at=np.sort(rng.integers(0, 8, n)),
        gangs=rng.integers(2, 5, 4),
        # a slack of 1 throttles a gang member's run check right after
        # its own submit slot (both packages abort every such gang)
        slack=int(rng.choice([0, 2, 4])))


def _storm(P, inputs, wal_dir):
    c = P["ctld"]
    parts = ["p0", "p1", "p2", "p3", "p4"]
    fc = P["fsim"].FederatedCluster(
        {"a": {"p0": 3, "p1": 2}, "b": {"p2": 3, "p3": 2},
         "c": {"p4": 3}},
        wal_dir=str(wal_dir), cpu=16.0, mem_gb=64,
        global_limits=P["usage"].GlobalLimits(
            max_jobs_per_user=40, max_submit_jobs_per_user=70),
        publish_slack=inputs["slack"], **P["dev"])
    names, admitted = [], []
    gangs = inputs["gangs"]
    for g, size in enumerate(gangs):
        fc.submit_gang(P["arbiter"].GangRequest(
            name=f"gang{g}", node_num=int(size),
            partitions=("p1", "p2") if g % 2 else ("p0", "p4"),
            spec=_gang_spec(P, cpu=2.0, runtime=4.0)))
    i = 0
    for t in range(12):
        if t == 5:
            res = fc.migrate("p1", "c")
            assert res["committed"]
        while i < len(inputs["at"]) and inputs["at"][i] <= t:
            spec = c.JobSpec(
                name=f"s{i:03d}", user=f"u{inputs['user'][i]}",
                account=f"acct{inputs['acct'][i]}",
                partition=parts[inputs["part"][i]],
                node_num=int(inputs["node_num"][i]),
                res=c.ResourceSpec(
                    cpu=float(inputs["cpu"][i]),
                    mem_bytes=int(inputs["mem"][i]) << 30,
                    memsw_bytes=int(inputs["mem"][i]) << 30),
                sim_runtime=float(inputs["runtime"][i]))
            shard, jid = fc.submit(spec, float(t))
            names.append(spec.name)
            admitted.append((spec.name, shard, jid))
            i += 1
        fc.tick(float(t) + 0.5)
        fc.pump_usage()
    fc.run_until_drained(max_cycles=400)
    books = {n: s.scheduler.global_usage.stats()
             for n, s in sorted(fc.shards.items())}
    audit = fc.ledger_by_name([n for n, _s, jid in admitted if jid])
    assert audit["lost"] == [] and audit["doubled"] == []
    return dict(admitted=admitted, outcome=_outcome(fc),
                arbiter=dict(fc.arbiter.stats), ledger=fc.ledger(),
                audit=audit, books=books, wal=_wal_bytes(wal_dir),
                epoch=fc.shard_map.epoch,
                fed={n: s.fed.stats() for n, s in fc.shards.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_storm_matches_jax(tmp_path, seed):
    """The same seeded numpy draws through both federations: admissions
    under the global limits, every job's outcome, the gang commits, the
    usage books, the ledgers and both shards' WAL files are equal."""
    inputs = _storm_inputs(seed)

    def scenario(P):
        wal_dir = tmp_path / P["name"]
        wal_dir.mkdir()
        return _storm(P, inputs, wal_dir)
    rec = both(scenario)
    assert rec["arbiter"]["commits"] >= 1
    assert rec["epoch"] == 1


# ---------------------------------------------------------------------------
# cross-package: a JAX shard and a port shard in one federation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("east,west", [(JAX, PORT), (PORT, JAX)],
                         ids=["jax-east-port-west", "port-east-jax-west"])
def test_cross_package_federation_over_grpc(east, west):
    """A forward each way, the lease plane of each shard driven by the
    other package's client, the usage gossip pulled across, and a
    migration from one package's shard into the other's."""
    ports, servers = _fed_pair(east, west, planes=True)
    clients = []
    try:
        ce = east["client"].CtldClient(f"127.0.0.1:{ports['east']}")
        cw = west["client"].CtldClient(f"127.0.0.1:{ports['west']}")
        clients += [ce, cw]
        # east -> west and west -> east forwards, with redirect hints
        r1 = ce.submit(_pb_spec(east, partition="gpu", name="to-west"))
        assert (r1.job_id, r1.shard, r1.error) == (1, "west", "")
        assert r1.redirect_address == f"127.0.0.1:{ports['west']}"
        r2 = cw.submit(_pb_spec(west, partition="batch", name="to-east"))
        assert (r2.job_id, r2.shard, r2.error) == (1, "east", "")
        assert servers["west"].scheduler.pending[1].spec.name == "to-west"
        assert servers["east"].scheduler.pending[1].spec.name == "to-east"
        # the west-side forwarded job carries the fed_forwarded span
        tl = servers["west"].scheduler.jobtrace.timeline(1)
        edges = {s["edge"] for s in tl["incarnations"][0]["spans"]}
        assert "fed_forwarded" in edges
        # each shard's lease plane driven by the OTHER package's client
        for shard, P in (("east", west), ("west", east)):
            cli = P["client"].CtldClient(f"127.0.0.1:{ports[shard]}")
            clients.append(cli)
            pb = P["pb"]
            part = "batch" if shard == "east" else "gpu"
            res = pb.ResourceSpec(cpu=1.0, mem_bytes=1 << 30,
                                  memsw_bytes=1 << 30)
            lease = cli.lease_nodes("X1", part, 1, res=res, ttl=60.0)
            assert lease.ok and len(lease.node_names) == 1
            conf = cli.confirm_gang(
                "X1", "gx", _pb_spec(P, partition=part, name=f"gx@{part}"),
                node_names=list(lease.node_names),
                fencing_epoch=lease.fencing_epoch)
            assert conf.ok, conf.error
            job = servers[shard].scheduler.running[conf.job_id]
            assert job.spec.name == f"gx@{part}"
            lease2 = cli.lease_nodes("X2", part, 1, res=res, ttl=60.0)
            assert lease2.ok
            assert cli.release_lease("X2").ok
            assert servers[shard].scheduler.fed.leases == {}
        # a migration of batch from east into west, across packages
        mig = ce.migrate_partition("batch", "west")
        assert mig.ok, mig.error
        assert mig.jobs_moved == 2 and mig.map_epoch == 1
        assert cw.query_shard_map().map_epoch == 1
        moved = sorted(j.spec.name for col in (
            servers["west"].scheduler.pending,
            servers["west"].scheduler.running) for j in col.values())
        assert moved == ["gx@batch", "gx@gpu", "to-east", "to-west"]
        east_s = servers["east"].scheduler
        assert not east_s.pending and not east_s.running
        # the old owner now redirect-forwards batch to west
        r3 = ce.submit(_pb_spec(east, partition="batch", name="late"))
        assert r3.shard == "west" and r3.map_epoch == 1 and r3.job_id
        # the dest's cycle places the adopted pending job on the
        # imported nodes
        cw.tick(5.0)
        west_s = servers["west"].scheduler
        placed = {j.spec.name: west_s.meta.nodes[j.node_ids[0]].name
                  for j in west_s.running.values()}
        assert placed["to-east"].startswith("east-batch-")
    finally:
        _stop(clients, servers)


# ---------------------------------------------------------------------------
# a federation WAL recovers in the other package
# ---------------------------------------------------------------------------

def _recovered(P, wal_path, name, partitions, now):
    """A SimShard of package ``P`` restarted from ``wal_path`` alone."""
    shard = P["fsim"].SimShard(name, partitions, **P["dev"])
    shard.wal_path = wal_path
    shard._fresh_wal = False
    shard.recover(now)
    s = shard.scheduler
    return dict(
        jobs={(col, j.spec.name, j.job_id): (j.status.name, j.start_time,
                                             tuple(shard.meta.nodes[n].name
                                                   for n in j.node_ids))
              for col, d in (("pending", s.pending),
                             ("running", s.running),
                             ("history", s.history))
              for j in d.values()},
        nodes=[(n.name, n.alive, sorted(n.partitions))
               for n in shard.meta.nodes.values()],
        fed=shard.fed.stats(), imports=dict(shard.fed.imports),
        unresolved=[r["mid"] for r in shard.fed.unresolved_migrations],
        sealed=sorted(s.sealed_partitions),
        next_id=s._next_job_id)


@pytest.mark.parametrize("writer", [JAX, PORT], ids=["jax-wal", "port-wal"])
def test_fed_wal_recovers_in_the_other_package(tmp_path, writer):
    """One package runs a storm with a gang, a lease left bare by a
    crash and a migration whose source dies mid-handoff; each shard's
    WAL then recovers in both packages to the same state."""
    P = writer
    wal_dir = tmp_path / "w"
    wal_dir.mkdir()
    fc = P["fsim"].FederatedCluster(
        {"east": {"batch": 3}, "west": {"gpu": 3}}, wal_dir=str(wal_dir),
        **P["dev"])
    c = P["ctld"]
    for i in range(18):
        fc.submit(c.JobSpec(
            name=f"w{i:02d}", user="u",
            partition="gpu" if i % 3 == 0 else "batch",
            res=c.ResourceSpec(cpu=2.0, mem_bytes=1 << 30,
                               memsw_bytes=1 << 30),
            sim_runtime=6.0 + i % 4), 0.0)
    fc.submit_gang(P["arbiter"].GangRequest(
        name="g1", node_num=2, partitions=("batch", "gpu"),
        spec=_gang_spec(P, runtime=50.0)))
    for _ in range(2):
        fc.tick()
    # a bare reserve on west: leased, never confirmed
    req = _gang_spec(P).res.encode(fc.shards["west"].meta.layout)
    fc.shards["west"].fed.lease_nodes("bare", "gpu", 1, req, 0.0, fc.now)
    res = fc.migrate("batch", "west",
                     on_exported=lambda payload: fc.kill("east"))
    assert res["committed"] is False
    now = fc.now
    recs = {}
    for shard, parts in (("east", {"batch": 3}), ("west", {"gpu": 3})):
        for R in BOTH:
            path = str(tmp_path / f"{R['name']}-{shard}.wal")
            shutil.copy(wal_dir / f"{shard}.wal", path)
            recs[(shard, R["name"])] = _recovered(R, path, shard, parts,
                                                  now)
        assert recs[(shard, "port")] == recs[(shard, "jax")]
    assert recs[("east", "port")]["unresolved"] == [res["mid"]]
    assert recs[("east", "port")]["sealed"] == ["batch"]
    assert res["mid"] in recs[("west", "port")]["imports"]
    assert "east-batch-n0000" in [
        n for n, _a, _p in recs[("west", "port")]["nodes"]]
    # the bare reserve was tombstoned by recovery on both
    assert recs[("west", "port")]["fed"]["leases"] == 0


# ---------------------------------------------------------------------------
# the client side: route re-learning and the federated query plane
# ---------------------------------------------------------------------------

def test_client_relearns_the_map_on_a_newer_epoch():
    """A shard-aware client that learned the map at epoch 0 submits to
    the old owner after a migration: the reply carries epoch 1, so the
    client re-pulls the map and its next submit goes straight to the
    new owner (no forward)."""
    def scenario(P):
        ports, servers = _fed_pair(P, P, planes=True)
        ha = east = None
        reg = P["obs"].REGISTRY
        try:
            ha = P["client"].HaCtldClient([f"127.0.0.1:{ports['east']}"])
            assert ha.learn_shard_map() == 3
            assert ha._map_epoch == 0
            east = P["client"].CtldClient(f"127.0.0.1:{ports['east']}")
            assert east.submit(_pb_spec(P, partition="batch")).job_id == 1
            mig = east.migrate_partition("batch", "west")
            assert mig.ok and mig.map_epoch == 1
            first = ha.submit(_pb_spec(P, partition="batch"))
            assert first.shard == "west" and first.map_epoch == 1
            assert ha._map_epoch == 1
            assert ha._shard_routes["batch"] == \
                f"127.0.0.1:{ports['west']}"
            fwd = reg.counter("crane_fed_forwards_total").value()
            second = ha.submit(_pb_spec(P, partition="batch"))
            assert second.shard == "west"
            assert reg.counter("crane_fed_forwards_total").value() == fwd
            return (mig.jobs_moved, first.job_id, second.job_id,
                    sorted(servers["west"].scheduler.pending))
        finally:
            _stop((ha, east), servers)
    both(scenario)


def test_federated_client_fanout_and_degraded_shard():
    """``FederatedClient`` learns the map from one shard, fans every
    read out, labels each slice with its shard, carries the map epochs
    and usage of each, and reports a dead shard in ``errors`` while the
    merge goes on with the live one; ``cluster_doc`` digests the stats
    round."""
    def scenario(P):
        import importlib
        query = importlib.import_module(
            P["client"].__name__.replace("rpc.client", "fed.query"))
        fedobs = importlib.import_module(
            P["obs"].__name__ + ".fedobs")
        ports, servers = _fed_pair(P, P, planes=True)
        for name, s in servers.items():
            s.scheduler.global_usage = P["usage"].UsageBook(
                name, P["usage"].GlobalLimits(max_submit_jobs_per_user=9),
                n_shards=2, publish_slack=0)
        fc = east = None
        try:
            east = P["client"].CtldClient(f"127.0.0.1:{ports['east']}")
            for part in ("batch", "gpu", "gpu", "debug"):
                assert east.submit(_pb_spec(P, partition=part,
                                            user="u")).job_id
            fc = query.FederatedClient.connect(
                f"127.0.0.1:{ports['east']}")
            assert fc is not None
            jobs = {shard: sorted(j.partition for j in r.jobs)
                    for shard, r in fc.jobs(max_staleness=0.5)}
            assert jobs == {"east": ["batch", "debug"],
                            "west": ["gpu", "gpu"]}
            epochs = fc.map_epochs()
            usage = {shard: json.loads(r.payload)["user"]
                     for shard, r in fc.usage()}
            doc = fedobs.cluster_doc(fc.stats(), max_staleness=0.5)
            assert sorted(doc["shards"]) == ["east", "west"]
            servers["west"].stop()
            degraded = fc.cluster()
            assert sorted(degraded.replies) == ["east"]
            assert sorted(degraded.errors) == ["west"]
            return jobs, epochs, usage, sorted(doc["shards"]), \
                [n.name for _s, r in degraded for n in r.nodes]
        finally:
            if fc is not None:
                fc.close()
            _stop((east,), servers)
    both(scenario)


def test_lease_taken_mid_solve_is_never_placed_onto():
    """A lease granted while a cycle's solve runs (between the solve
    closure and its commit) marks the nodes with a ``ResReduceEvent``:
    the commit revalidates and refuses every placement onto them, in
    both packages alike."""
    def scenario(P):
        c = P["ctld"]
        shard = P["fsim"].SimShard("east", {"batch": 4}, **P["dev"])
        for i in range(8):
            shard.submit(c.JobSpec(
                name=f"l{i}", partition="batch", sim_runtime=50.0,
                res=c.ResourceSpec(cpu=4.0, mem_bytes=1 << 30,
                                   memsw_bytes=1 << 30)), 0.0)
        gen = shard.scheduler.cycle_phases(1.0)
        fn = next(gen)
        leased = set()
        try:
            while True:
                result = fn()
                if not leased:
                    req = c.ResourceSpec(cpu=1.0).encode(shard.meta.layout)
                    names, _e, _s = shard.fed.lease_nodes(
                        "mid", "batch", 2, req, 0.0, 1.0)
                    leased = {shard.meta.node_by_name(n).node_id
                              for n in names}
                fn = gen.send(result)
        except StopIteration:
            pass
        running = {j.spec.name: sorted(j.node_ids)
                   for j in shard.scheduler.running.values()}
        assert running
        assert not any(set(n) & leased for n in running.values())
        pending = {j.spec.name: j.pending_reason.name
                   for j in shard.scheduler.pending.values()}
        return running, pending, sorted(leased)
    both(scenario)
