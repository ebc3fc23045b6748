"""The port's federation-wide observability (``obs/fedobs.py``, the
federated job-trace spans) against the JAX package's, on the CPU (the
federation cases of ``tests/test_flight.py``).

Each case runs on both packages from the same inputs and compares the
records exactly: the ``fed_forwarded`` span of a forwarded submit, the
arbiter's ``arbiter_reserve`` -> ``arbiter_confirm`` -> ``placed`` spans,
the cluster SLO merge against a single controller holding every sample,
the breach counter's edge trigger, the metric-snapshot merge by kind,
``cluster_doc`` over a fan-out with a dead and a garbled shard, the
promotion re-seed's synthetic spans kept out of the cluster SLO, the
follower's event log re-seeded through ``ingest``, and the per-shard
profiler capture directories.
"""

import json
import socket
import types

import pytest

import cranesched_tpu.ctld as jctld
import cranesched_tpu.fed.arbiter as jarbiter
import cranesched_tpu.fed.shardmap as jshardmap
import cranesched_tpu.fed.sim as jfsim
import cranesched_tpu.obs as jobs
import cranesched_tpu.obs.events as jevents
import cranesched_tpu.obs.fedobs as jfedobs
import cranesched_tpu.obs.introspect as jintrospect
import cranesched_tpu.obs.jobtrace as jjobtrace
import cranesched_tpu.obs.slo as jslo
import cranesched_tpu.rpc as jrpc
import cranesched_tpu.rpc.client as jclient
import cranesched_tpu.rpc.crane_pb2 as jpb
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.fed.arbiter as tarbiter
import cranesched_tpu_torch.fed.shardmap as tshardmap
import cranesched_tpu_torch.fed.sim as tfsim
import cranesched_tpu_torch.obs as tobs
import cranesched_tpu_torch.obs.events as tevents
import cranesched_tpu_torch.obs.fedobs as tfedobs
import cranesched_tpu_torch.obs.introspect as tintrospect
import cranesched_tpu_torch.obs.jobtrace as tjobtrace
import cranesched_tpu_torch.obs.slo as tslo
import cranesched_tpu_torch.rpc as trpc
import cranesched_tpu_torch.rpc.client as tclient
import cranesched_tpu_torch.rpc.crane_pb2 as tpb

JAX = dict(name="jax", ctld=jctld, arbiter=jarbiter, shardmap=jshardmap,
           fsim=jfsim, obs=jobs, events=jevents, fedobs=jfedobs,
           introspect=jintrospect, jobtrace=jjobtrace, slo=jslo, rpc=jrpc,
           client=jclient, pb=jpb, dev={})
PORT = dict(name="port", ctld=tctld, arbiter=tarbiter, shardmap=tshardmap,
            fsim=tfsim, obs=tobs, events=tevents, fedobs=tfedobs,
            introspect=tintrospect, jobtrace=tjobtrace, slo=tslo,
            rpc=trpc, client=tclient, pb=tpb, dev={"device": "cpu"})


def both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on each package; the records must be
    equal.  Returns the port's."""
    jrec = scenario(JAX, *args)
    trec = scenario(PORT, *args)
    assert trec == jrec
    return trec


# ---------------------------------------------------------------------------
# federated spans: fed_forwarded + the arbiter pair
# ---------------------------------------------------------------------------

def test_fed_edges_stay_off_the_lifecycle_schema():
    def scenario(P):
        jt = P["jobtrace"]
        assert set(jt.FED_EDGES).isdisjoint(jt.SPAN_EDGES)
        assert jt.FED_EDGES == ("fed_forwarded", "arbiter_reserve",
                                "arbiter_confirm")
        return jt.FED_EDGES, jt.SPAN_EDGES
    both(scenario)


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


def test_forwarded_submit_stamps_fed_forwarded_span():
    def scenario(P):
        pb = P["pb"]
        sm = P["shardmap"]
        ports = {"east": _free_port(), "west": _free_port()}
        shard_map = sm.ShardMap([
            sm.ShardSpec("east", ("batch",),
                         address=f"127.0.0.1:{ports['east']}"),
            sm.ShardSpec("west", ("gpu",),
                         address=f"127.0.0.1:{ports['west']}"),
        ])
        servers = {}
        east = None
        try:
            for name in ("east", "west"):
                sched = _shard_sched(P, name,
                                     shard_map.partitions_of(name))
                server, bound = P["rpc"].serve(
                    sched, tick_mode=True,
                    address=f"127.0.0.1:{ports[name]}",
                    shard_name=name, shard_map=shard_map)
                assert bound == ports[name]
                servers[name] = server
            east = P["client"].CtldClient(f"127.0.0.1:{ports['east']}")
            res = pb.ResourceSpec(cpu=1.0, mem_bytes=1 << 30,
                                  memsw_bytes=1 << 30)
            reply = east.submit(pb.JobSpec(res=res, sim_runtime=30.0,
                                           partition="gpu"))
            assert reply.shard == "west" and not reply.error
            doc = servers["west"].scheduler.jobtrace.timeline(
                reply.job_id)
            assert doc is not None
            spans = doc["incarnations"][0]["spans"]
            by_edge = {s["edge"]: s for s in spans}
            assert "fed_forwarded" in by_edge and "submit" in by_edge
            fwd = by_edge["fed_forwarded"]
            assert fwd["t"] <= by_edge["submit"]["t"] + 1e-6
            assert fwd["skew"] >= 0.0
            local = east.submit(pb.JobSpec(res=res, sim_runtime=30.0,
                                           partition="batch"))
            ldoc = servers["east"].scheduler.jobtrace.timeline(
                local.job_id)
            ledges = {s["edge"]
                      for s in ldoc["incarnations"][0]["spans"]}
            assert "fed_forwarded" not in ledges
            text = "\n".join(P["jobtrace"].render_waterfall(doc))
            assert "fed_forwarded" in text
            return sorted(by_edge), sorted(ledges), reply.job_id
        finally:
            if east is not None:
                east.close()
            for server in servers.values():
                server.stop()
    both(scenario)


def test_arbiter_gang_spans_reserve_confirm_placed(tmp_path):
    def scenario(P):
        c = P["ctld"]
        wal_dir = tmp_path / P["name"]
        wal_dir.mkdir()
        fc = P["fsim"].FederatedCluster(
            {"east": {"batch": 2}, "west": {"gpu": 2}},
            wal_dir=str(wal_dir), **P["dev"])
        fc.submit_gang(P["arbiter"].GangRequest(
            name="g1", node_num=4, partitions=("batch", "gpu"),
            spec=c.JobSpec(user="u",
                           res=c.ResourceSpec(cpu=1.0, mem_bytes=1 << 30,
                                              memsw_bytes=1 << 30),
                           sim_runtime=5.0)))
        fc.run_until_drained()
        assert fc.arbiter.stats["commits"] == 1
        seen = []
        for sname, shard in sorted(fc.shards.items()):
            for job in shard.scheduler.history.values():
                if not job.spec.name.startswith("g1@"):
                    continue
                doc = shard.scheduler.jobtrace.timeline(job.job_id)
                assert doc is not None, job.spec.name
                spans = doc["incarnations"][0]["spans"]
                by_edge = {s["edge"]: s for s in spans}
                for edge in ("arbiter_reserve", "arbiter_confirm",
                             "placed"):
                    assert edge in by_edge, (job.spec.name,
                                             sorted(by_edge))
                assert (by_edge["arbiter_reserve"]["t"]
                        <= by_edge["arbiter_confirm"]["t"]
                        <= by_edge["placed"]["t"])
                assert (doc["incarnations"][0]["fencing_epoch"]
                        == shard.scheduler.fencing_epoch)
                seen.append((sname, job.spec.name,
                             [(s["edge"], s["t"]) for s in spans]))
        assert len(seen) == 2
        return seen
    both(scenario)


# ---------------------------------------------------------------------------
# cluster-level SLO merge vs the single-controller oracle
# ---------------------------------------------------------------------------

def _slo_spec(P, name, windows=(3600.0,)):
    return P["slo"].SloSpec(name, "submit", "dispatched", 99.0, 0.5,
                            windows)


def _feed(rec, samples, base):
    for job_id, lat in samples:
        t0 = base + job_id * 1e-3
        rec.stamp(job_id, 0, "submit", t0)
        rec.stamp(job_id, 0, "dispatched", t0 + lat)


def test_two_shard_burn_merge_matches_single_controller_oracle():
    def scenario(P):
        S, J = P["slo"], P["jobtrace"]
        base = 1_000_000.0
        now = base + 100.0
        lats = [2.0 if i % 16 == 0 else 0.05 for i in range(200)]
        oracle = S.SloEngine([_slo_spec(P, "e2e-oracle")])
        _feed(J.JobTraceRecorder(capacity=1024, slo=oracle),
              list(enumerate(lats)), base)
        ora_row = oracle.evaluate(now)[0]
        shard_rows = {}
        for shard, beg in (("east", 0), ("west", 1)):
            eng = S.SloEngine([_slo_spec(P, "e2e-oracle")])
            _feed(J.JobTraceRecorder(capacity=1024, slo=eng),
                  [(i, lats[i]) for i in range(beg, 200, 2)], base)
            shard_rows[shard] = eng.evaluate(now)
        clu = P["fedobs"].ClusterSlo().merge(shard_rows)
        assert len(clu) == 1
        row = clu[0]
        assert row["shards"] == ["east", "west"]
        for wk, win in ora_row["windows"].items():
            cwin = row["windows"][wk]
            assert cwin["count"] == win["count"] == 200
            assert cwin["shard_counts"] == {"east": 100, "west": 100}
            assert cwin["burn_rate"] == pytest.approx(
                win["burn_rate"], abs=1e-3)
            assert cwin["breaching"] == win["breaching"]
            assert cwin["observed_is_max_over_shards"] is True
            assert cwin["observed"] >= win["observed"] - 1e-9
        return clu, ora_row, shard_rows
    both(scenario)


def test_cluster_breach_counter_edge_triggers_once_per_onset():
    def scenario(P):
        name = "flight-breach-edge"
        reg = P["obs"].REGISTRY
        breaches = reg.counter("crane_fed_slo_breaches_total")
        before = breaches.value(slo=name)

        def table(burn):
            return {"s1": [{"name": name, "from": "submit",
                            "to": "dispatched", "p": 99.0,
                            "target_seconds": 0.5,
                            "windows": {"60": {
                                "count": 100, "observed": 1.0,
                                "burn_rate": burn,
                                "breaching": burn >= 1.0}}}]}

        clu = P["fedobs"].ClusterSlo()
        rows = [clu.merge(table(2.0))]
        assert rows[0][0]["windows"]["60"]["breaching"]
        assert breaches.value(slo=name) == before + 1
        rows.append(clu.merge(table(3.0)))
        assert breaches.value(slo=name) == before + 1
        rows.append(clu.merge(table(0.0)))
        assert not rows[-1][0]["windows"]["60"]["breaching"]
        rows.append(clu.merge(table(2.0)))
        assert breaches.value(slo=name) == before + 2
        gauge = reg.gauge("crane_fed_slo_burn_rate").value(
            slo=name, window="60")
        assert gauge == pytest.approx(2.0, abs=1e-3)
        return rows, breaches.value(slo=name) - before, gauge
    both(scenario)


def test_merge_metric_snapshots_by_kind():
    snaps = {
        "east": {
            "crane_jobs_total": {"type": "counter",
                                 "values": {"{}": 5.0}},
            "crane_lat": {"type": "histogram",
                          "values": {'{edge="submit"}':
                                     {"count": 4, "sum": 2.0}}},
            "crane_queue_depth": {"type": "gauge",
                                  "values": {"{}": 7.0}},
        },
        "west": {
            "crane_jobs_total": {"type": "counter",
                                 "values": {"{}": 3.0}},
            "crane_lat": {"type": "histogram",
                          "values": {'{edge="submit"}':
                                     {"count": 1, "sum": 0.5}}},
            "crane_queue_depth": {"type": "gauge",
                                  "values": {'{part="gpu"}': 2.0}},
        },
    }

    def scenario(P):
        out = P["fedobs"].merge_metric_snapshots(snaps)
        assert out["crane_jobs_total"]["values"] == {"{}": 8.0}
        assert out["crane_lat"]["values"] == {
            '{edge="submit"}': {"count": 5, "sum": 2.5}}
        assert out["crane_queue_depth"]["values"] == {
            '{shard="east"}': 7.0,
            '{shard="west",part="gpu"}': 2.0}
        return out
    both(scenario)


def test_cluster_doc_staleness_and_degraded_shards():
    now = 5_000.0
    good_json = json.dumps({
        "watchdog": {"now": now - 4.0},
        "slo": [{"name": "e2e", "from": "submit", "to": "dispatched",
                 "p": 99.0, "target_seconds": 0.5,
                 "windows": {"60": {"count": 10, "observed": 0.1,
                                    "burn_rate": 0.0,
                                    "breaching": False}}}],
        "metrics": {"crane_jobs_total": {
            "type": "counter", "values": {"{}": 2.0}}},
        "flight": {"stalls_total": 1, "last_stall": None},
    })

    def scenario(P):
        good = types.SimpleNamespace(json=good_json, durable_seq=7)
        bad = types.SimpleNamespace(json="not json{", durable_seq=0)
        fanout = types.SimpleNamespace(
            replies={"east": good, "bad": bad}, errors={"west": "down"})
        doc = P["fedobs"].cluster_doc(fanout, now=now, max_staleness=1.5)
        assert doc["max_staleness"] == 1.5
        east = doc["shards"]["east"]
        assert east["durable_seq"] == 7
        assert east["staleness_s"] == pytest.approx(4.0, abs=0.01)
        assert east["flight"]["stalls_total"] == 1
        assert doc["errors"]["west"] == "down"
        assert doc["errors"]["bad"] == "unparseable stats reply"
        assert "bad" not in doc["shards"]
        assert doc["slo"][0]["name"] == "e2e"
        assert doc["slo"][0]["windows"]["60"]["count"] == 10
        assert doc["metrics"]["crane_jobs_total"]["values"] == \
            {"{}": 2.0}
        return doc
    both(scenario)


def _recovered_job(job_id, submit_t, start_t):
    return types.SimpleNamespace(
        job_id=job_id, requeue_count=0, submit_time=submit_t,
        start_time=start_t,
        status=types.SimpleNamespace(is_terminal=False),
        end_time=None)


def test_promotion_reseed_excludes_synthetic_spans_from_cluster_slo():
    def scenario(P):
        S, J = P["slo"], P["jobtrace"]
        base = 2_000_000.0
        now = base + 50.0
        eng_a = S.SloEngine([_slo_spec(P, "promo-e2e")])
        _feed(J.JobTraceRecorder(capacity=256, slo=eng_a),
              [(i, 0.1) for i in range(20)], base)
        eng_b = S.SloEngine([_slo_spec(P, "promo-e2e")])
        rec_b = J.JobTraceRecorder(capacity=256, slo=eng_b)
        for jid in range(100, 110):
            rec_b.seed_recovered(
                _recovered_job(jid, base - 3600.0, base - 1800.0), now)
        tl = rec_b.timeline(100)["incarnations"][0]
        assert {s["edge"] for s in tl["spans"]} >= {
            "submit", "eligible", "placed", "dispatched"}
        assert all(s.get("synthetic") for s in tl["spans"])
        row_b = eng_b.evaluate(now)[0]
        assert all(w["count"] == 0 for w in row_b["windows"].values())
        rec_b.stamp(999, 0, "submit", now - 1.0)
        rec_b.stamp(999, 0, "dispatched", now - 0.9)
        row_b = eng_b.evaluate(now)[0]
        row_a = eng_a.evaluate(now)[0]
        clu = P["fedobs"].ClusterSlo().merge({"a": [row_a],
                                              "b": [row_b]})
        for wk, win in clu[0]["windows"].items():
            assert win["count"] == row_a["windows"][wk]["count"] + 1
            assert win["shard_counts"]["b"] == 1
            assert not win["breaching"]
        return clu, tl
    both(scenario)


def test_follower_event_log_reseeds_via_ingest():
    def scenario(P):
        E = P["events"]
        leader = E.EventLog()
        leader.emit("leader_elected", detail="epoch 3")
        leader.emit_node_transition("down", "n0", now=10.0)
        leader.emit("flight_stall", severity="error",
                    detail="cycle wedged")
        records = leader.since()
        follower = E.EventLog()
        assert all(follower.ingest(r) for r in records)
        assert not any(follower.ingest(r) for r in records)
        assert follower.remote_seq == records[-1]["seq"]
        got = follower.since()
        assert [r["type"] for r in got] == [
            "leader_elected", "node_down", "flight_stall"]
        assert [r["severity"] for r in got] == ["info", "warning",
                                                "error"]
        promoted = follower.emit("leader_elected", detail="epoch 4")
        assert promoted["seq"] > got[-1]["seq"]
        strip = ("time",)
        return ([{k: v for k, v in r.items() if k not in strip}
                 for r in got], promoted["seq"])
    both(scenario)


def test_profiler_capture_dirs_never_collide_across_shards(tmp_path):
    def scenario(P):
        PW = P["introspect"].ProfilerWindow
        base = tmp_path / P["name"]
        base.mkdir()
        east = PW(base_dir=str(base), namespace="east")
        west = PW(base_dir=str(base), namespace=lambda: "west")
        ok1, d1 = east.request(1)
        ok2, d2 = west.request(1)
        assert ok1 and ok2
        assert d1 != d2
        assert "capture-east-" in d1 and "capture-west-" in d2
        east._armed = 0
        east._active_dir = ""
        ok3, d3 = east.request(1)
        assert ok3 and d3 != d1
        weird = PW(base_dir=str(base), namespace=lambda: 1 / 0)
        ok4, d4 = weird.request(1)
        assert ok4 and "capture-" in d4 and "capture--" not in d4
        # a directory is capture-[<namespace>-]<ms>-<pid>-<seq>: the
        # record keeps the tag, not the millisecond each run read from
        # the wall clock (the two packages' runs fall in different ones)
        return [d.replace(str(base), "").split("-")[:-3]
                for d in (d1, d2, d3, d4)]
    both(scenario)


def test_scheduler_namespaces_its_captures_by_shard_name(tmp_path):
    """A shard's scheduler arms its profiler window under its shard
    name, so two shards of one process write to distinct directories."""
    def scenario(P):
        fc = P["fsim"].FederatedCluster(
            {"east": {"batch": 1}, "west": {"gpu": 1}}, **P["dev"])
        dirs = []
        for name in ("east", "west"):
            win = fc.shards[name].scheduler.profiler_window
            win.base_dir = str(tmp_path / P["name"])
            ok, d = win.request(1)
            assert ok and f"capture-{name}-" in d
            dirs.append(d.rsplit("/", 1)[1].split("-")[:2])
        return dirs
    both(scenario)
