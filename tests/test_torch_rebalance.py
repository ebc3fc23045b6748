"""The port's elastic federation (``fed/rebalance.py``, ``fed/usage.py``)
against the JAX package's, on the CPU (the cases of
``tests/test_rebalance.py``).

Every scenario runs once on each package from the same inputs and the two
records are compared exactly: the detector's decisions, the successor
maps, the migration results, every job's outcome by name (ids renumber on
import), the usage books, the admissions under the global limits, the
RPC replies and the WAL files byte for byte.  The JAX test's own
assertions run on both.  The two invariants held:

* a migration, a source SIGKILL mid-handoff included, never loses a job
  and never runs one twice;
* the global MaxJobs/MaxSubmitJobs limits hold cluster-wide: exactly the
  single controller's admissions at staleness 0, and never overshot under
  bounded-staleness gossip.
"""

import json
import socket

import pytest

import cranesched_tpu.ctld as jctld
import cranesched_tpu.ctld.auth as jauth
import cranesched_tpu.ctld.wal as jwal
import cranesched_tpu.fed.rebalance as jrebalance
import cranesched_tpu.fed.shard as jshard
import cranesched_tpu.fed.shardmap as jshardmap
import cranesched_tpu.fed.sim as jfsim
import cranesched_tpu.fed.usage as jusage
import cranesched_tpu.ha.snapshot as jsnapshot
import cranesched_tpu.rpc as jrpc
import cranesched_tpu.rpc.client as jclient
import cranesched_tpu.rpc.crane_pb2 as jpb
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.ctld.auth as tauth
import cranesched_tpu_torch.ctld.wal as twal
import cranesched_tpu_torch.fed.rebalance as trebalance
import cranesched_tpu_torch.fed.shard as tshard
import cranesched_tpu_torch.fed.shardmap as tshardmap
import cranesched_tpu_torch.fed.sim as tfsim
import cranesched_tpu_torch.fed.usage as tusage
import cranesched_tpu_torch.ha.snapshot as tsnapshot
import cranesched_tpu_torch.rpc as trpc
import cranesched_tpu_torch.rpc.client as tclient
import cranesched_tpu_torch.rpc.crane_pb2 as tpb

JAX = dict(name="jax", ctld=jctld, auth=jauth, wal=jwal,
           rebalance=jrebalance, shard=jshard, shardmap=jshardmap,
           fsim=jfsim, usage=jusage, snapshot=jsnapshot, rpc=jrpc,
           client=jclient, pb=jpb, dev={})
PORT = dict(name="port", ctld=tctld, auth=tauth, wal=twal,
            rebalance=trebalance, shard=tshard, shardmap=tshardmap,
            fsim=tfsim, usage=tusage, snapshot=tsnapshot, rpc=trpc,
            client=tclient, pb=tpb, dev={"device": "cpu"})


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on each package; the records must be
    equal.  Returns the port's."""
    jrec = scenario(JAX, *args)
    trec = scenario(PORT, *args)
    assert trec == jrec
    return trec


def _spec(P, i, partition="batch", user="u", runtime=5.0, cpu=2.0):
    c = P["ctld"]
    return c.JobSpec(name=f"mig{i:03d}", user=user, partition=partition,
                     res=c.ResourceSpec(cpu=cpu, mem_bytes=1 << 30,
                                        memsw_bytes=1 << 30),
                     sim_runtime=runtime)


def _fc(P, shards, tmp_path=None, **kw):
    wal_dir = None
    if tmp_path is not None:
        wal_dir = tmp_path / P["name"]
        wal_dir.mkdir()
        wal_dir = str(wal_dir)
    return P["fsim"].FederatedCluster(shards, wal_dir=wal_dir, **kw,
                                      **P["dev"])


def _wal_bytes(fc):
    return {n: (open(s.wal_path, "rb").read() if s.wal_path else b"")
            for n, s in sorted(fc.shards.items())}


def _outcome(fc):
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
# hot-shard detector
# ---------------------------------------------------------------------------

def test_detector_cold_start_and_single_shard_decide_none():
    def scenario(P):
        det = P["rebalance"].HotShardDetector()
        out = [det.decide(0.0, ["east", "west"])]
        for t in range(10):
            det.observe("east", float(t), submit_p99_ms=1e9)
        out += [det.decide(10.0, ["east"]),
                det.decide(10.0, ["east", "west"])]
        assert out == [None, None, "east"]
        return out, det.stats()
    both(scenario)


def test_detector_needs_sustained_signal_and_any_signal_latches():
    def scenario(P):
        R = P["rebalance"]
        det = R.HotShardDetector(R.DetectorConfig(sustain=3))
        det.observe("east", 0.0, submit_p99_ms=100.0)
        det.observe("east", 1.0, submit_p99_ms=100.0)
        det.observe("east", 2.0, submit_p99_ms=0.0)
        first = det.decide(2.0, ["east", "west"])
        assert first is None
        for t in (3.0, 4.0, 5.0):
            det.observe("east", t, lock_held_share=0.9)
        second = det.decide(5.0, ["east", "west"])
        assert second == "east"
        return first, second, det.stats()
    both(scenario)


def test_detector_flapping_in_dead_zone_never_storms():
    def scenario(P):
        R = P["rebalance"]
        det = R.HotShardDetector(R.DetectorConfig(
            submit_p99_hot_ms=50.0, cool_ratio=0.6, sustain=3,
            cooldown_s=100.0))
        latched = []
        for t in range(20):
            val = 100.0 if t % 2 == 0 else 40.0
            latched.append(det.observe("east", float(t),
                                       submit_p99_ms=val))
        assert det.decide(20.0, ["east", "west"]) is None
        for t in range(21, 24):
            det.observe("east", float(t), submit_p99_ms=100.0)
        det.observe("east", 24.0, submit_p99_ms=40.0)
        assert det.decide(24.0, ["east", "west"]) == "east"
        det.observe("east", 25.0, submit_p99_ms=5.0)
        assert det.decide(25.0, ["east", "west"]) is None
        return latched, det.stats()
    both(scenario)


def test_detector_cooldown_after_migration():
    def scenario(P):
        R = P["rebalance"]
        det = R.HotShardDetector(R.DetectorConfig(sustain=1,
                                                  cooldown_s=300.0))
        det.observe("east", 0.0, slo_burn=5.0)
        assert det.decide(0.0, ["east", "west"]) == "east"
        det.migrated(0.0)
        det.observe("east", 1.0, slo_burn=5.0)
        assert det.decide(1.0, ["east", "west"]) is None
        det.observe("east", 301.0, slo_burn=5.0)
        assert det.decide(301.0, ["east", "west"]) == "east"
        return det.stats()
    both(scenario)


# ---------------------------------------------------------------------------
# shard map versioning
# ---------------------------------------------------------------------------

def test_with_partition_moved_bumps_epoch_and_validates():
    def scenario(P):
        sm = P["shardmap"]
        m = sm.ShardMap([sm.ShardSpec("east", ("batch", "debug")),
                         sm.ShardSpec("west", ("gpu",))])
        m2 = m.with_partition_moved("batch", "west")
        assert m2.epoch == m.epoch + 1
        assert m2.shard_for_partition("batch") == "west"
        assert m2.shard_for_partition("debug") == "east"
        assert m.shard_for_partition("batch") == "east"
        errors = []
        for args, match in ((("nope", "west"), "nope"),
                            (("gpu", "west"), "already"),
                            (("batch", "south"), "unknown")):
            with pytest.raises(ValueError, match=match) as info:
                m.with_partition_moved(*args)
            errors.append(str(info.value))
        return m2.doc(), m2.epoch, errors
    both(scenario)


def test_configured_partition_owned_by_no_shard_is_an_error():
    def scenario(P):
        sm = P["shardmap"]
        errors = []
        with pytest.raises(ValueError, match="orphan") as info:
            sm.ShardMap([sm.ShardSpec("east", ("batch",))],
                        configured_partitions=("batch", "orphan"))
        errors.append(str(info.value))
        with pytest.raises(ValueError, match="orphan") as info:
            sm.ShardMap.from_config(
                {"Shards": [{"name": "east", "partitions": ["batch"]}]},
                configured_partitions=("batch", "orphan"))
        errors.append(str(info.value))
        return errors
    both(scenario)


# ---------------------------------------------------------------------------
# live migration drills (sim federation)
# ---------------------------------------------------------------------------

def _storm(P, fc, n=24, runtime=6.0):
    names = []
    for i in range(n):
        part = "gpu" if i % 3 == 0 else "batch"
        spec = _spec(P, i, partition=part, runtime=runtime + (i % 4))
        fc.submit(spec, 0.0)
        names.append(spec.name)
    return names


def test_live_migration_mid_storm_exactly_once(tmp_path):
    def scenario(P):
        fc = _fc(P, {"east": {"batch": 3}, "west": {"gpu": 3}}, tmp_path)
        names = _storm(P, fc)
        for _ in range(3):
            fc.tick()
        east = fc.shards["east"].scheduler
        assert east.running, "drill needs in-flight jobs to hand off"
        moved = len(east.pending) + len(east.running)
        res = fc.migrate("batch", "west")
        assert res["committed"] and res["jobs_imported"] == moved
        assert fc.shard_map.epoch == 1
        assert fc.shard_map.shard_for_partition("batch") == "west"
        assert not east.pending and not east.running
        shard, jid = fc.submit(_spec(P, 900, partition="batch"), fc.now)
        assert shard == "west" and jid > 0
        fc.run_until_drained(max_cycles=2000)
        audit = fc.ledger_by_name(names + ["mig900"])
        assert audit["lost"] == [] and audit["doubled"] == []
        assert audit["still_live"] == []
        return res, _outcome(fc), audit, _wal_bytes(fc)
    both(scenario)


def test_source_sigkill_mid_handoff_resolves_to_commit(tmp_path):
    def scenario(P):
        fc = _fc(P, {"east": {"batch": 3}, "west": {"gpu": 3}}, tmp_path)
        names = _storm(P, fc)
        for _ in range(3):
            fc.tick()
        res = fc.migrate("batch", "west",
                         on_exported=lambda payload: fc.kill("east"))
        assert res["committed"] is False
        assert res["jobs_imported"] > 0
        assert fc.shard_map.shard_for_partition("batch") == "west"
        fc.recover("east")
        settled = fc.resolve_migrations("east")
        assert [r["resolution"] for r in settled] == ["commit"]
        east = fc.shards["east"].scheduler
        assert not east.pending and not east.running
        fc.run_until_drained(max_cycles=2000)
        audit = fc.ledger_by_name(names)
        assert audit["lost"] == [] and audit["doubled"] == []
        assert audit["still_live"] == []
        return res, settled, _outcome(fc), _wal_bytes(fc)
    both(scenario)


def test_dest_dead_at_import_stays_sealed_then_resolves(tmp_path):
    def scenario(P):
        fc = _fc(P, {"east": {"batch": 3}, "west": {"gpu": 3}}, tmp_path)
        names = _storm(P, fc, n=12)
        for _ in range(2):
            fc.tick()
        with pytest.raises(RuntimeError):
            fc.migrate("batch", "west",
                       on_exported=lambda payload: fc.kill("west"))
        assert fc.shard_map.epoch == 0
        assert fc.shard_map.shard_for_partition("batch") == "east"
        assert "batch" in fc.shards["east"].scheduler.sealed_partitions
        assert len(fc.coordinator.pending_resolution) == 1
        first = fc.resolve_migrations("east")
        assert [r["resolution"] for r in first] == ["pending"]
        assert "batch" in fc.shards["east"].scheduler.sealed_partitions
        fc.recover("west")
        second = fc.resolve_migrations("east")
        assert [r["resolution"] for r in second] == ["abort"]
        sealed = fc.shards["east"].scheduler.sealed_partitions
        assert "batch" not in sealed
        assert fc.coordinator.pending_resolution == []
        fc.run_until_drained(max_cycles=2000)
        audit = fc.ledger_by_name(names)
        assert audit["lost"] == [] and audit["doubled"] == []
        assert audit["still_live"] == []
        return first, second, _outcome(fc), _wal_bytes(fc)
    both(scenario)


def test_sealed_partition_refuses_new_submits(tmp_path):
    def scenario(P):
        fc = _fc(P, {"east": {"batch": 2}, "west": {"gpu": 2}}, tmp_path)
        fc.submit(_spec(P, 0), 0.0)
        east = fc.shards["east"]
        moving = east.fed.seal_partition("mig:t", "batch", "west", 0.0)
        refused = east.scheduler.submit(_spec(P, 1), 0.0)
        assert refused == 0
        east.fed.abort_migration("mig:t", "batch", 0.0)
        again = east.scheduler.submit(_spec(P, 2), 0.0)
        assert again > 0
        return moving, refused, again, _wal_bytes(fc)
    both(scenario)


def test_replayed_source_filters_committed_jobs(tmp_path):
    def scenario(P):
        fc = _fc(P, {"east": {"batch": 2}, "west": {"gpu": 2}}, tmp_path)
        names = _storm(P, fc, n=8)
        fc.tick()
        fc.migrate("batch", "west")
        fc.kill("east")
        fc.recover("east")
        east = fc.shards["east"].scheduler
        assert not east.pending and not east.running
        assert "batch" in fc.shards["east"].fed.migrated_away
        migs = P["wal"].WriteAheadLog.replay_migrations(
            fc.shards["east"].wal_path)
        assert any(e["ev"] == "fed_migrate_commit" for e in migs.values())
        fc.run_until_drained(max_cycles=2000)
        audit = fc.ledger_by_name(names)
        assert audit["lost"] == [] and audit["doubled"] == []
        return migs, _outcome(fc), _wal_bytes(fc)
    both(scenario)


# ---------------------------------------------------------------------------
# cluster-wide accounting
# ---------------------------------------------------------------------------

def _submit_round_robin(P, fc, n, user="u", pump_each=False):
    admitted = 0
    parts = ["batch", "gpu"]
    for i in range(n):
        spec = _spec(P, i, partition=parts[i % 2], user=user,
                     runtime=50.0)
        _, jid = fc.submit(spec, 0.0)
        if jid:
            admitted += 1
        if pump_each:
            fc.pump_usage(0.0)
    return admitted


def _books(fc):
    return {n: s.scheduler.global_usage.stats()
            for n, s in sorted(fc.shards.items())}


def test_global_submit_limit_bit_exact_vs_oracle_at_staleness_zero():
    def scenario(P):
        limits = P["usage"].GlobalLimits(max_submit_jobs_per_user=5)
        fc = _fc(P, {"east": {"batch": 2}, "west": {"gpu": 2}},
                 global_limits=limits, publish_slack=0)
        admitted = _submit_round_robin(P, fc, 12, pump_each=True)
        assert admitted == 5
        oracle = P["fsim"].SimShard("solo", {"batch": 2, "gpu": 2},
                                    global_limits=limits, publish_slack=0,
                                    **P["dev"])
        solo = sum(1 if oracle.submit(
            _spec(P, i, partition=("batch", "gpu")[i % 2], runtime=50.0),
            0.0) else 0 for i in range(12))
        assert solo == admitted == 5
        return admitted, _books(fc)
    both(scenario)


def test_global_limit_never_overshoots_under_bounded_staleness():
    def scenario(P):
        limits = P["usage"].GlobalLimits(max_submit_jobs_per_user=6)
        fc = _fc(P, {"east": {"batch": 2}, "west": {"gpu": 2}},
                 global_limits=limits, publish_slack=1)
        first = _submit_round_robin(P, fc, 20, pump_each=False)
        assert 0 < first <= 6
        fc.pump_usage(0.0)
        second = _submit_round_robin(P, fc, 20, pump_each=False)
        total = sum(len(s.scheduler.pending) + len(s.scheduler.running)
                    for s in fc.shards.values())
        assert total <= 6
        return first, second, total, _books(fc)
    both(scenario)


def test_global_max_jobs_gates_running_not_just_submits():
    def scenario(P):
        limits = P["usage"].GlobalLimits(max_jobs_per_user=2)
        fc = _fc(P, {"east": {"batch": 4}, "west": {"gpu": 4}},
                 global_limits=limits, publish_slack=1)
        for i in range(8):
            fc.submit(_spec(P, i, partition=("batch", "gpu")[i % 2],
                            runtime=100.0, cpu=1.0), 0.0)
            fc.pump_usage(0.0)
        for _ in range(5):
            fc.tick()
            fc.pump_usage(fc.now)
        running = sum(len(s.scheduler.running)
                      for s in fc.shards.values())
        assert 0 < running <= 2
        return running, _outcome(fc), _books(fc)
    both(scenario)


def test_usage_book_stale_summary_never_rolls_backwards():
    def scenario(P):
        U = P["usage"]
        book = U.UsageBook("east",
                           U.GlobalLimits(max_submit_jobs_per_user=10),
                           n_shards=2)
        new = {"shard": "west", "durable_seq": 9, "time": 2.0,
               "user": {"u": {"jobs": 0, "submit_jobs": 4}}}
        old = {"shard": "west", "durable_seq": 3, "time": 1.0,
               "user": {"u": {"jobs": 0, "submit_jobs": 1}}}
        book.ingest(new, 2.0)
        book.ingest(old, 3.0)
        assert book._remote["west"]["durable_seq"] == 9
        kept = book.check_submit("u", "")
        book.forget("west")
        assert book.staleness(10.0) == 0.0
        return kept, book.stats()
    both(scenario)


def test_migrated_jobs_keep_their_global_slots(tmp_path):
    def scenario(P):
        limits = P["usage"].GlobalLimits(max_submit_jobs_per_user=8)
        fc = _fc(P, {"east": {"batch": 2}, "west": {"gpu": 2}}, tmp_path,
                 global_limits=limits, publish_slack=0)
        for i in range(4):
            fc.submit(_spec(P, i, runtime=50.0), 0.0)
            fc.pump_usage(0.0)
        fc.migrate("batch", "west")
        fc.pump_usage(0.0)
        east = fc.shards["east"].scheduler.global_usage
        west = fc.shards["west"].scheduler.global_usage
        assert east._user.get("u") is None or \
            east._user["u"].submit_jobs == 0
        assert west._user["u"].submit_jobs == 4
        admitted = _submit_round_robin(P, fc, 8, pump_each=True)
        assert admitted == 4
        return admitted, _books(fc), _wal_bytes(fc)
    both(scenario)


def test_fair_share_takes_remote_account_service():
    """Remote running-job counts per account enter the priority's
    service sum (``extra_service``): an account busy on the other shard
    sinks in this shard's queue.  The priorities, the order and the
    placements are the JAX package's to the bit."""
    def scenario(P):
        limits = P["usage"].GlobalLimits(max_submit_jobs_per_user=1000)
        fc = _fc(P, {"east": {"batch": 1}, "west": {"gpu": 4}},
                 global_limits=limits, publish_slack=0,
                 config_kw={"priority_type": "multifactor"})
        c = P["ctld"]
        for i in range(8):
            fc.submit(c.JobSpec(
                name=f"busy{i}", user="u", account="hog",
                partition="gpu", res=c.ResourceSpec(
                    cpu=8.0, mem_bytes=1 << 30, memsw_bytes=1 << 30),
                sim_runtime=500.0), 0.0)
        fc.tick(1.0)
        fc.pump_usage(1.0)
        for i in range(6):
            acct = "hog" if i % 2 == 0 else "light"
            fc.submit(c.JobSpec(
                name=f"q{i}", user=f"u{i}", account=acct,
                partition="batch", res=c.ResourceSpec(
                    cpu=float(4 + i), mem_bytes=(1 + i) << 30,
                    memsw_bytes=(1 + i) << 30),
                sim_runtime=5.0), 1.0)
        east = fc.shards["east"].scheduler
        remote = east.global_usage.remote_account_jobs()
        assert remote == {"hog": 8}
        fc.tick(2.0)
        prio = {j.spec.name: j.priority for col in (east.pending,
                                                    east.running)
                for j in col.values()}
        hog = [prio[f"q{i}"] for i in (0, 2, 4)]
        light = [prio[f"q{i}"] for i in (1, 3, 5)]
        assert max(hog) < min(light)
        return remote, prio, _outcome(fc)
    both(scenario)


# ---------------------------------------------------------------------------
# RPC surface
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


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


def _fed_pair(P, auth_by_name=None, limits=None):
    ports = {"east": _free_port(), "west": _free_port()}
    sm = P["shardmap"]
    shard_map = sm.ShardMap([
        sm.ShardSpec("east", ("batch", "debug"),
                     address=f"127.0.0.1:{ports['east']}"),
        sm.ShardSpec("west", ("gpu",),
                     address=f"127.0.0.1:{ports['west']}"),
    ])
    servers = {}
    for name in ("east", "west"):
        sched = _shard_sched(P, name, shard_map.spec(name).partitions)
        P["shard"].FedShardPlane(sched, name)
        if limits is not None:
            sched.global_usage = P["usage"].UsageBook(name, limits,
                                                      n_shards=2)
        server, bound = P["rpc"].serve(
            sched, tick_mode=True, address=f"127.0.0.1:{ports[name]}",
            shard_name=name, shard_map=shard_map,
            auth=(auth_by_name or {}).get(name))
        assert bound == ports[name]
        servers[name] = server
    return ports, servers


def _pb_spec(P, user="u", partition="batch", cpu=1.0, **kw):
    pb = P["pb"]
    return pb.JobSpec(user=user, partition=partition,
                      res=pb.ResourceSpec(cpu=cpu, mem_bytes=1 << 30,
                                          memsw_bytes=1 << 30),
                      sim_runtime=30.0, **kw)


def _stop(clients, servers):
    for c in clients:
        if c is not None:
            c.close()
    for s in servers.values():
        s.stop()


def test_forwarded_submit_identity_checked_exactly_once(tmp_path):
    def scenario(P):
        auths = {n: P["auth"].AuthManager(
            str(tmp_path / f"{P['name']}-{n}.tokens.json"))
            for n in ("east", "west")}
        ports, servers = _fed_pair(P, auth_by_name=auths)
        clients = []
        try:
            root = P["client"].CtldClient(f"127.0.0.1:{ports['east']}",
                                          token=auths["east"].root_token)
            clients.append(root)
            token = root.issue_token("u").token
            user_east = P["client"].CtldClient(
                f"127.0.0.1:{ports['east']}", token=token)
            clients.append(user_east)
            reply = user_east.submit(_pb_spec(P, partition="gpu"))
            assert reply.error == "" and reply.job_id > 0
            assert reply.shard == "west"
            assert servers["west"].scheduler.pending
            anon = P["client"].CtldClient(f"127.0.0.1:{ports['west']}")
            clients.append(anon)
            fake = anon.submit(_pb_spec(P, partition="gpu"),
                               forwarded=True, forwarded_from="mars")
            assert "authentication required" in fake.error
            return reply.job_id, reply.shard, fake.error
        finally:
            _stop(clients, servers)
    both(scenario)


def test_map_epoch_stamped_on_replies_and_fetch_usage():
    def scenario(P):
        limits = P["usage"].GlobalLimits(max_submit_jobs_per_user=100)
        ports, servers = _fed_pair(P, limits=limits)
        cli = None
        try:
            cli = P["client"].CtldClient(f"127.0.0.1:{ports['east']}")
            m = cli.query_shard_map()
            assert m.map_epoch == 0
            r = cli.submit(_pb_spec(P))
            assert r.job_id > 0 and r.map_epoch == 0
            usage = cli.fetch_usage()
            assert usage.ok and usage.shard == "east"
            doc = json.loads(usage.payload)
            assert doc["user"]["u"]["submit_jobs"] == 1
            doc.pop("time")
            return r.job_id, doc, usage.durable_seq
        finally:
            _stop((cli,), servers)
    both(scenario)


def test_migrate_partition_rpc_end_to_end():
    def scenario(P):
        ports, servers = _fed_pair(P)
        east = west = None
        try:
            east = P["client"].CtldClient(f"127.0.0.1:{ports['east']}")
            west = P["client"].CtldClient(f"127.0.0.1:{ports['west']}")
            names = set()
            for i in range(3):
                r = east.submit(_pb_spec(P, name=f"rpc{i}"))
                assert r.job_id > 0
                names.add(f"rpc{i}")
            reply = east.migrate_partition("batch", "west")
            assert reply.ok, reply.error
            assert reply.jobs_moved == 3 and reply.map_epoch == 1
            assert east.query_shard_map().map_epoch == 1
            assert west.query_shard_map().map_epoch == 1
            wsched = servers["west"].scheduler
            moved = {j.spec.name for j in wsched.pending.values()}
            assert names <= moved
            assert not servers["east"].scheduler.pending
            wrong = west.migrate_partition("debug", "west")
            assert not wrong.ok and "east" in wrong.error
            q = west.migrate_partition("", "", phase="query",
                                       mid=reply.mid)
            bogus = west.migrate_partition("", "", phase="query",
                                           mid="mig:none")
            assert q.adopted and q.jobs_moved == 3 and not bogus.adopted
            # the dest's next cycle places the adopted jobs on the
            # imported nodes
            west.tick(5.0)
            placed = sorted(
                (j.spec.name, wsched.meta.nodes[j.node_ids[0]].name)
                for j in wsched.running.values())
            assert [n for n, _ in placed] == sorted(names)
            return (reply.mid, reply.jobs_moved,
                    wrong.error.rsplit(":", 1)[0], sorted(moved), placed)
        finally:
            _stop((east, west), servers)
    both(scenario)


# ---------------------------------------------------------------------------
# delivery-confirmed throttle, slack clamping, ambiguity-safe resolution
# ---------------------------------------------------------------------------

def test_publish_throttle_releases_only_on_slowest_peer_ack():
    def scenario(P):
        U = P["usage"]
        book = U.UsageBook("a", U.GlobalLimits(
            max_submit_jobs_per_user=100), n_shards=3, publish_slack=2,
            peers=("b", "c"))
        book.note_submit("u", "")
        book.note_submit("u", "")
        answers = [book.check_submit("u", "")]
        book.publish(0.0)
        answers.append(book.check_submit("u", ""))
        book.publish(1.0, peer="b")
        answers.append(book.check_submit("u", ""))
        book.publish(2.0, peer="c")
        answers.append(book.check_submit("u", ""))
        assert all("overdue" in a for a in answers[:3])
        assert answers[3] == ""
        return answers, book.stats()
    both(scenario)


def test_effective_publish_slack_clamps_unsatisfiable_config():
    def scenario(P):
        U = P["usage"]
        limits = U.GlobalLimits(max_jobs_per_user=10)
        out = [U.effective_publish_slack(limits, 3, 8),
               U.effective_publish_slack(limits, 3, 4),
               U.effective_publish_slack(U.GlobalLimits(), 3, 8),
               U.effective_publish_slack(limits, 1, 8),
               U.effective_publish_slack(limits, 3, 0)]
        assert out == [(4, 8), (4, 4), (8, 8), (8, 8), (0, 0)]
        return out
    both(scenario)


def test_import_call_death_after_durable_adopt_commits_not_doubles(
        tmp_path):
    def scenario(P):
        fc = _fc(P, {"east": {"batch": 3}, "west": {"gpu": 3}}, tmp_path)
        names = _storm(P, fc, n=12)
        for _ in range(2):
            fc.tick()
        handle = fc.handles["west"]
        real_import = handle.import_

        def import_then_die(payload, now):
            real_import(payload, now)
            raise OSError("connection reset mid-reply")

        handle.import_ = import_then_die
        result = fc.migrate("batch", "west")
        handle.import_ = real_import
        assert result["committed"] is True
        assert fc.shard_map.shard_for_partition("batch") == "west"
        east = fc.shards["east"].scheduler
        assert not any(j.spec.partition == "batch"
                       for j in list(east.pending.values())
                       + list(east.running.values()))
        fc.run_until_drained(max_cycles=2000)
        audit = fc.ledger_by_name(names)
        assert audit["lost"] == [] and audit["doubled"] == []
        assert audit["still_live"] == []
        return result, _outcome(fc), _wal_bytes(fc)
    both(scenario)


def test_dest_restart_after_snapshot_prune_keeps_imported_partition(
        tmp_path):
    def scenario(P):
        S = P["snapshot"]
        fc = _fc(P, {"east": {"batch": 2}, "west": {"gpu": 2}}, tmp_path)
        names = _storm(P, fc, n=8)
        fc.tick()
        result = fc.migrate("batch", "west")
        west = fc.shards["west"]
        doc = S.capture_snapshot(west.scheduler)
        west.scheduler.wal.rotate()
        S.SnapshotStore(west.wal_path).save(doc)
        west.scheduler.wal.prune_segments(doc["seq"])
        assert P["wal"].WriteAheadLog.replay_migrations(
            west.wal_path) == {}
        fc.kill("west")
        fc.recover("west")
        west = fc.shards["west"]
        assert "batch" in west.meta.partitions
        assert west.fed.has_import(result["mid"])
        fc.run_until_drained(max_cycles=2000)
        audit = fc.ledger_by_name(names)
        assert audit["lost"] == [] and audit["doubled"] == []
        assert audit["still_live"] == []
        return result, doc["fed"], _outcome(fc)
    both(scenario)


@pytest.mark.parametrize("victim", ["source", "dest"])
def test_migration_under_sigkill_then_restart_from_wal(tmp_path, victim):
    """A SIGKILL of the source (after its export) or of the destination
    (after it adopted) and a restart from the WAL alone: every job lands
    exactly once by name, the dest's imported nodes come back with their
    ids, and its next cycle places onto them."""
    def scenario(P):
        fc = _fc(P, {"east": {"batch": 3}, "west": {"gpu": 3}}, tmp_path)
        names = _storm(P, fc, n=18, runtime=20.0)
        for _ in range(2):
            fc.tick()
        if victim == "source":
            res = fc.migrate("batch", "west",
                             on_exported=lambda p: fc.kill("east"))
            fc.recover("east")
            settled = fc.resolve_migrations("east")
        else:
            res = fc.migrate("batch", "west")
            settled = []
            before = [(n.name, n.node_id) for n in
                      fc.shards["west"].meta.nodes.values()]
            fc.kill("west")
            fc.recover("west")
            after = [(n.name, n.node_id) for n in
                     fc.shards["west"].meta.nodes.values()]
            assert after == before
        fc.run_until_drained(max_cycles=2000)
        audit = fc.ledger_by_name(names)
        assert audit["lost"] == [] and audit["doubled"] == []
        assert audit["still_live"] == []
        west = fc.shards["west"]
        on_imported = sorted(
            j.spec.name for j in west.scheduler.history.values()
            if j.node_ids and west.meta.nodes[
                j.node_ids[0]].name.startswith("east-"))
        assert on_imported
        return res, settled, on_imported, _outcome(fc), _wal_bytes(fc)
    both(scenario)


def test_migrated_meta_and_wal_records_match(tmp_path):
    """The migration's four WAL records (begin, import, commit) and the
    HA snapshot's ``fed`` document, read back through each package's
    ``replay_migrations``, are the same on both sides."""
    def scenario(P):
        fc = _fc(P, {"east": {"batch": 2}, "west": {"gpu": 2}}, tmp_path)
        _storm(P, fc, n=10)
        fc.tick()
        fc.migrate("batch", "west")
        W = P["wal"].WriteAheadLog
        return ({n: W.replay_migrations(s.wal_path)
                 for n, s in sorted(fc.shards.items())},
                {n: s.fed.snapshot_doc()
                 for n, s in sorted(fc.shards.items())},
                {n: W.replay_fed(s.wal_path)
                 for n, s in sorted(fc.shards.items())})
    rec = both(scenario)
    assert {e["ev"] for e in rec[0]["east"].values()} == {
        "fed_migrate_commit"}
    assert {e["ev"] for e in rec[0]["west"].values()} == {
        "fed_migrate_import"}


def test_sim_plane_mirrors_an_imported_partition():
    """ROADMAP C7: a port server with a simulated node plane gives every
    node an import created a craned and re-arms the imported running
    jobs, so the destination's next tick places onto the new nodes and
    the moved jobs end on time; the JAX server adopts them into the
    scheduler only (no craned for the new nodes)."""
    def scenario(P):
        ports = {"east": _free_port(), "west": _free_port()}
        sm = P["shardmap"]
        shard_map = sm.ShardMap([
            sm.ShardSpec("east", ("batch",),
                         address=f"127.0.0.1:{ports['east']}"),
            sm.ShardSpec("west", ("gpu",),
                         address=f"127.0.0.1:{ports['west']}")])
        servers, clients = {}, []
        sim_mod = __import__(P["ctld"].__name__.replace("ctld", "craned")
                             + ".sim", fromlist=["SimCluster"])
        try:
            for name in ("east", "west"):
                sched = _shard_sched(P, name,
                                     shard_map.partitions_of(name))
                P["shard"].FedShardPlane(sched, name)
                sim = sim_mod.SimCluster(sched)
                sim.wire(sched)
                servers[name], _ = P["rpc"].serve(
                    sched, sim=sim, tick_mode=True,
                    address=f"127.0.0.1:{ports[name]}", shard_name=name,
                    shard_map=shard_map)
            east = P["client"].CtldClient(f"127.0.0.1:{ports['east']}")
            west = P["client"].CtldClient(f"127.0.0.1:{ports['west']}")
            clients += [east, west]
            for i in range(3):
                assert east.submit(_pb_spec(P, name=f"m{i}")).job_id
            east.tick(1.0)
            assert east.submit(_pb_spec(P, name="m3", cpu=2.0)).job_id
            reply = east.migrate_partition("batch", "west")
            assert reply.ok and reply.jobs_moved == 4
            ws = servers["west"]
            created = [n for n in ws.scheduler.meta.nodes.values()
                       if n.name.startswith("east-")]
            return ([n.node_id in ws.sim.craneds for n in created],
                    ws, west)
        except BaseException:
            for c in clients:
                c.close()
            for s in servers.values():
                s.stop()
            raise

    jmirrored, jserver, jclient_ = scenario(JAX)
    tmirrored, tserver, tclient_ = scenario(PORT)
    try:
        assert jmirrored == [False, False]
        assert tmirrored == [True, True]
        # the port's destination places the pending job on the imported
        # nodes and lets the re-armed running jobs end at their runtime
        tclient_.tick(5.0)
        sched = tserver.scheduler
        m3 = next(j for j in sched.running.values() if j.spec.name == "m3")
        assert sched.meta.nodes[m3.node_ids[0]].name.startswith("east-")
        tclient_.tick(32.0)
        done = sorted(j.spec.name for j in sched.history.values())
        assert done == ["m0", "m1", "m2"]
    finally:
        for c in (jclient_, tclient_):
            c.close()
        for s in (jserver, tserver):
            s.stop()
