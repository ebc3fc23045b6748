"""The port's ``crane`` commands (``cranesched_tpu_torch/cli.py``) against
the JAX package's ``cli.py``.

Each case of the JAX CLI tests runs once on a JAX server with the JAX
CLI and once on a port server with the port's CLI, from the same
scripted session, and the records are compared: each command's exit code
and its standard output and error, byte for byte, apart from these
fields (compared by shape, not value):

- ``cstats --cycles`` and ``--metrics``: the table's rows (the cycle
  thread runs freely, so their count and times are the wall clock's);
  the header's words are compared (its widths follow the rows).
- ``cstats --metrics`` of the compile family (``crane_jit_compiles_total``
  in the JAX package, where the port counts its kernel builds as
  ``crane_build_total``): its rows, whose labels and values are each
  package's process-wide registry, fed by every test in the process;
  their TYPE column and the header are compared.
- ``cevents``: the TIME column (events stamped with ``time.time()``).
- ``cprofile``: the capture directory, the package's own.
- ``cflight`` on a live stall: the phase times and the threads' stacks.

Cases: ``tests/test_rpc_cli.py`` (:140, :156, :170, :281, :306),
``tests/test_acctmgr_rpc.py:97``, ``tests/test_obs.py:200``,
``tests/test_flight.py`` (:665, :696, :721), ``tests/test_introspect.py``
(:650, :716) and the ``_stream_session`` watchdog of
``tests/test_interactive_io.py:171``; then one session run with the
port's CLI against the JAX server and the JAX CLI against the port's
server, which must print what each server's own CLI prints.  The runs
of ``python -m ...cli`` as a subprocess are in
``tests/test_torch_cli_procs.py``.
"""

import json
import re
import time
import types

import pytest

import cranesched_tpu.cli as jcli
import cranesched_tpu.craned.sim as jsim
import cranesched_tpu.ctld as jctld
import cranesched_tpu.ctld.accounting as jacct
import cranesched_tpu.ctld.wal as jwal
import cranesched_tpu.ha.follower as jfollower
import cranesched_tpu.obs.flight as jflight
import cranesched_tpu.rpc as jrpc
import cranesched_tpu.rpc.cfored as jcfored
import cranesched_tpu_torch.cli as tcli
import cranesched_tpu_torch.craned.sim as tsim
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.ctld.accounting as tacct
import cranesched_tpu_torch.ctld.wal as twal
import cranesched_tpu_torch.ha.follower as tfollower
import cranesched_tpu_torch.obs.flight as tflight
import cranesched_tpu_torch.rpc as trpc
import cranesched_tpu_torch.rpc.cfored as tcfored
from cranesched_tpu_torch.rpc import crane_pb2 as pb

JAX = types.SimpleNamespace(
    name="jax", cli=jcli, ctld=jctld, sim=jsim, acct=jacct, wal=jwal,
    follower=jfollower, flight=jflight, rpc=jrpc, cfored=jcfored, kw={},
    compiles="crane_jit_compiles_total")
PORT = types.SimpleNamespace(
    name="port", cli=tcli, ctld=tctld, sim=tsim, acct=tacct, wal=twal,
    follower=tfollower, flight=tflight, rpc=trpc, cfored=tcfored,
    kw={"device": "cpu"}, compiles="crane_build_total")


def both(scenario, *args):
    """Run ``scenario(P, *args)`` on each package; the records must be
    equal.  Returns the port's."""
    jrec = scenario(JAX, *args)
    trec = scenario(PORT, *args)
    assert trec == jrec
    return trec


def _wait(pred, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


class Ctld:
    """A scheduler of package ``P`` on a simulated plane, served over
    gRPC (tick mode unless ``cycle_interval`` is given)."""

    def __init__(self, P, nodes=4, cpu=8, mem_gb=16, accounts=False,
                 wal=None, cycle_interval=None, **server_kw):
        ctld = P.ctld
        meta = ctld.MetaContainer()
        for i in range(nodes):
            meta.add_node(f"cn{i:02d}", meta.layout.encode(
                cpu=cpu, mem_bytes=mem_gb << 30, memsw_bytes=mem_gb << 30,
                is_capacity=True))
            meta.craned_up(i)
        kw = dict(P.kw)
        if accounts:
            mgr = P.acct.AccountManager()
            mgr.users["root"] = P.acct.User(
                name="root", admin_level=P.acct.AdminLevel.ROOT)
            kw["accounts"] = mgr
        if wal is not None:
            kw["wal"] = wal
        self.sched = ctld.JobScheduler(
            meta, ctld.SchedulerConfig(backfill=False), **kw)
        self.sim = P.sim.SimCluster(self.sched)
        self.sim.wire(self.sched)
        if cycle_interval is None:
            server_kw["tick_mode"] = True
        else:
            server_kw["cycle_interval"] = cycle_interval
        self.server, self.port = P.rpc.serve(self.sched, sim=self.sim,
                                             **server_kw)
        self.addr = f"127.0.0.1:{self.port}"
        self.client = P.rpc.CtldClient(self.addr)

    def close(self):
        self.client.close()
        self.server.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_cli(cli, capsys, addr, *argv):
    """(exit code, stdout, stderr) of one ``crane`` command."""
    capsys.readouterr()
    rc = cli.main(["--server", addr, *argv])
    out = capsys.readouterr()
    return rc, out.out, out.err


def job_spec(cpu=2.0, runtime=30.0, **kw):
    return pb.JobSpec(res=pb.ResourceSpec(cpu=cpu, mem_bytes=1 << 30,
                                          memsw_bytes=1 << 30),
                      sim_runtime=runtime, **kw)


def _column_masked(text, column):
    """``text`` with one column of a ``_fmt_table`` table replaced by
    ``*`` (columns start where the header's words start)."""
    lines = text.splitlines()
    for i, line in enumerate(lines):
        m = re.search(rf"(?:^|  ){column}(?:  |$)", line)
        if m is None:
            continue
        start = m.start() + (2 if line[m.start()] == " " else 0)
        nxt = re.search(r"  \S", line[start + len(column):])
        end = None if nxt is None else start + len(column) + nxt.start() + 2
        out = lines[:i]
        for row in lines[i:]:
            out.append(row[:start] + "*" + ("" if end is None
                                              else "  " + row[end:]))
        return "\n".join(out)
    raise AssertionError(f"no column {column!r} in {text!r}")


# ---------------------------------------------------------------------------
# tests/test_rpc_cli.py
# ---------------------------------------------------------------------------

def test_cli_roundtrip(capsys):
    def scenario(P):
        with Ctld(P) as c:
            rec = [run_cli(P.cli, capsys, c.addr, "cbatch", "--cpu", "2",
                           "--mem", "1G", "--job-name", "clitest",
                           "--sim-runtime", "20")]
            assert rec[0][0] == 0 and "Submitted batch job 1" in rec[0][1]
            c.client.tick(0.0)
            rec.append(run_cli(P.cli, capsys, c.addr, "cqueue"))
            assert "clitest" in rec[-1][1] and "Running" in rec[-1][1]
            rec.append(run_cli(P.cli, capsys, c.addr, "cinfo"))
            assert rec[-1][0] == 0 and "cn00" in rec[-1][1]
            c.client.tick(21.0)
            rec.append(run_cli(P.cli, capsys, c.addr, "cacct"))
            assert rec[-1][0] == 0 and "Completed" in rec[-1][1]
            rec.append(run_cli(P.cli, capsys, c.addr, "cstep", "1"))
            rec.append(run_cli(P.cli, capsys, c.addr, "ceff", "1"))
            return rec
    both(scenario)


def test_cli_array_and_dependency_flags(capsys):
    def scenario(P):
        with Ctld(P) as c:
            rec = [run_cli(P.cli, capsys, c.addr, "cbatch", "--array",
                           "0-3%2", "--cpu", "1", "--sim-runtime", "5"),
                   run_cli(P.cli, capsys, c.addr, "cbatch", "--dependency",
                           "afterok:1", "--cpu", "1", "--sim-runtime",
                           "5"),
                   run_cli(P.cli, capsys, c.addr, "cbatch", "--gres",
                           "gpu:a100:2", "--cpu", "1")]
            assert rec[0][0] == 0 and rec[1][0] == 0
            job = c.sched.job_info(2)
            assert job.spec.dependencies[0].job_id == 1
            parent = c.sched.job_info(1)
            assert parent.spec.array.max_concurrent == 2
            with pytest.raises(SystemExit) as exc:
                P.cli.main(["--server", c.addr, "cbatch", "--dependency",
                            "afterok"])
            rec.append(str(exc.value))
            rec.append((job.spec.dependencies[0].job_id,
                        parent.spec.array.max_concurrent,
                        parent.spec.array.end))
            return rec
    both(scenario)


def test_cli_cancel_and_control(capsys):
    def scenario(P):
        with Ctld(P) as c:
            rec = [run_cli(P.cli, capsys, c.addr, "cbatch", "--cpu", "1",
                           "--sim-runtime", "100")]
            c.client.tick(0.0)
            for argv in (("ccontrol", "suspend", "1"),
                         ("ccontrol", "resume", "1"),
                         ("ccontrol", "modify", "1", "priority=5"),
                         ("ccontrol", "modify", "1", "bogus=1"),
                         ("ccancel", "1"), ("ccancel", "999")):
                rec.append(run_cli(P.cli, capsys, c.addr, *argv))
            assert [r[0] for r in rec[1:3]] == [0, 0]
            assert rec[5][0] == 0
            assert rec[6][0] == 1 and "no such job" in rec[6][2]
            return rec
    both(scenario)


def test_requeue_rpc_and_cli(capsys):
    def scenario(P):
        with Ctld(P) as c:
            jid = c.client.submit(job_spec(runtime=100.0)).job_id
            c.client.tick(0.0)
            assert c.client.requeue(jid).ok
            c.client.tick(1.0)
            rec = [run_cli(P.cli, capsys, c.addr, "crequeue", str(jid))]
            assert rec[0][0] == 0
            assert c.client.query_jobs().jobs[0].status == "Pending"
            rec.append(run_cli(P.cli, capsys, c.addr, "crequeue", "999"))
            assert rec[1][0] == 1 and "999" in rec[1][2]
            rec.append(run_cli(P.cli, capsys, c.addr, "cqueue"))
            return rec
    both(scenario)


def test_job_summary_rpc_and_cli(capsys):
    def scenario(P):
        with Ctld(P) as c:
            c.client.submit(job_spec(runtime=5.0, user="alice"))
            c.client.submit(job_spec(runtime=100.0, user="bob"))
            held = c.client.submit(job_spec(runtime=100.0,
                                            user="bob")).job_id
            c.client.hold(held)
            c.client.tick(0.0)
            c.client.tick(6.0)
            rec = [run_cli(P.cli, capsys, c.addr, "csummary"),
                   run_cli(P.cli, capsys, c.addr, "csummary", "-u", "bob")]
            assert "RUNNING" in rec[0][1] and "# total 3" in rec[0][1]
            assert rec[1][0] == 0 and "# total 2" in rec[1][1]
            rec.append(run_cli(P.cli, capsys, c.addr, "cqueue",
                               "--history", "--limit", "2"))
            assert "# limited to 2" in rec[-1][1]
            return rec
    both(scenario)


# ---------------------------------------------------------------------------
# tests/test_acctmgr_rpc.py:97
# ---------------------------------------------------------------------------

def test_cacctmgr_cli(capsys):
    def scenario(P):
        with Ctld(P, nodes=2, accounts=True) as c:
            rec = [run_cli(P.cli, capsys, c.addr, "cacctmgr", "add_qos",
                           "fast", "--actor", "root", "--set",
                           "priority=500"),
                   run_cli(P.cli, capsys, c.addr, "cacctmgr", "show",
                           "--actor", "root"),
                   run_cli(P.cli, capsys, c.addr, "cacctmgr", "add_qos",
                           "nope", "--actor", "nobody"),
                   run_cli(P.cli, capsys, c.addr, "cacctmgr", "add_qos",
                           "x", "--actor", "root", "--set", "nokey")]
            assert rec[0][0] == 0
            assert rec[1][0] == 0 and '"fast"' in rec[1][1] \
                and "500" in rec[1][1]
            assert rec[2][0] == 1 and rec[3][0] == 2
            return rec
    both(scenario)


# ---------------------------------------------------------------------------
# tests/test_obs.py:200
# ---------------------------------------------------------------------------

def test_cstats_cli_cycles_and_metrics(capsys):
    def scenario(P):
        with Ctld(P, cycle_interval=0.05) as c:
            c.client.submit(pb.JobSpec(
                res=pb.ResourceSpec(cpu=1.0, mem_bytes=1 << 30,
                                    memsw_bytes=1 << 30),
                time_limit=3600, partition="default", user="alice",
                sim_runtime=30.0))
            assert _wait(lambda: len(c.sched.cycle_trace) > 0)
            rc, out, err = run_cli(P.cli, capsys, c.addr, "cstats",
                                   "--cycles")
            assert rc == 0 and "SOLVER" in out and "LOCK_MS" in out
            assert "MESH" in out
            rec = [(rc, out.splitlines()[0].split(), err)]
            rc, out, err = run_cli(P.cli, capsys, c.addr, "cstats",
                                   "--metrics")
            assert rc == 0 and "crane_cycles_total" in out
            rec.append((rc, out.splitlines()[0].split(), err))
            return rec
    both(scenario)


def test_cstats_spans_prints_the_newest_cycle_tree(capsys):
    """The port's ``cstats --spans`` (the JAX CLI has no such flag): the
    newest trace row's span tree, one line a span, indented by depth,
    with its start, duration and self time; before any cycle there is
    nothing to print."""
    with Ctld(PORT) as c:
        rc, out, err = run_cli(tcli, capsys, c.addr, "cstats", "--spans")
        assert (rc, out) == (1, "") and "no cycle spans" in err
        for _ in range(3):
            c.client.submit(job_spec())
        c.client.tick(0.0)
        row = c.sched.cycle_trace.snapshot(last=1)[0]
        rc, out, err = run_cli(tcli, capsys, c.addr, "cstats", "--spans")
    assert (rc, err) == (0, "")
    lines = out.splitlines()
    assert lines[0].startswith(f"cycle {row['cycle']} now=0.0 ")
    assert lines[1].split() == ["SPAN", "START_MS", "MS", "SELF_MS"]
    spans = row["spans"]
    assert [ln.split()[0] for ln in lines[2:]] == [s[0] for s in spans]
    assert [s[0] for s in spans[:3]] == ["lock_wait", "sim_advance",
                                         "cycle"]
    for ln, (name, parent, start, end) in zip(lines[2:], spans):
        depth = 0
        while parent >= 0:
            depth, parent = depth + 1, spans[parent][1]
        assert ln.startswith("  " * depth + name + " ")
        _name, t, ms, self_ms = ln.split()
        assert float(t) == pytest.approx(start, abs=1e-3)
        assert float(ms) == pytest.approx(end - start, abs=2e-3)
        assert 0.0 <= float(self_ms) <= float(ms) + 1e-3


# ---------------------------------------------------------------------------
# tests/test_flight.py:665, :696, :721 (cflight)
# ---------------------------------------------------------------------------

def test_cflight_renders_bench_probe_diagnosis(tmp_path, capsys):
    def scenario(P):
        doc = {"device_acquisition": {
            "acquired": False,
            "phases": ["jax_import", "backend_init", "first_trace"],
            "diagnosis": "the TPU probe hung in phase 'first_trace'",
            "stacks": "Thread 0x01 (most recent call first):\n  ...",
        }}
        path = tmp_path / f"BENCH_{P.name}.json"
        path.write_text(json.dumps(doc))
        args = types.SimpleNamespace(file=str(path), tail=32)
        capsys.readouterr()
        rec = [P.cli.cmd_cflight(args), capsys.readouterr().out]
        assert rec[0] == 1
        assert "jax_import->backend_init->first_trace" in rec[1]
        assert "harvested probe stacks" in rec[1]
        ok = {"device_acquisition": {"acquired": True,
                                     "phases": ["a", "b"]}}
        path.write_text(json.dumps(ok))
        rec += [P.cli.cmd_cflight(args), capsys.readouterr().out]
        assert rec[2] == 0
        wrapper = {"n": 10, "cmd": "python bench.py", "rc": 0,
                   "parsed": {"detail": doc}}
        path.write_text(json.dumps(wrapper))
        rec += [P.cli.cmd_cflight(args), capsys.readouterr().out]
        assert rec[4] == 1 and "hung in phase 'first_trace'" in rec[5]
        return rec
    both(scenario)


def test_cflight_renders_acquisition_phase_stamps(tmp_path, capsys):
    def scenario(P):
        doc = {"device_acquisition": {
            "acquired": False,
            "phases": ["env_preflight", "jax_import", "backend_init"],
            "phase_stamps": [
                {"phase": "env_preflight", "t": 100.0},
                {"phase": "jax_import", "t": 100.25},
                {"phase": "backend_init", "t": 101.5},
            ],
            "diagnosis": "wedged in backend_init",
        }}
        path = tmp_path / f"BENCH_{P.name}.json"
        path.write_text(json.dumps(doc))
        args = types.SimpleNamespace(file=str(path), tail=32)
        capsys.readouterr()
        rc = P.cli.cmd_cflight(args)
        out = capsys.readouterr().out
        assert rc == 1
        assert "stamp jax_import" in out and "+0.250s" in out
        assert "stamp backend_init" in out and "+1.500s" in out
        return rc, out
    both(scenario)


def test_cflight_renders_live_stall():
    def scenario(P):
        fr = P.flight.FlightRecorder()
        fr.stamp("cycle_begin")
        fr.arm(0.05, label="cycle")
        deadline = time.monotonic() + 5.0
        while fr.stalls_total == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        lines = P.cli._render_flight(fr.report())
        fr.close()
        text = "\n".join(lines)
        assert "cycle_begin" in text
        assert "LAST STALL label='cycle'" in text
        assert "-- thread MainThread" in text
        # the times and the stacks are the run's own
        return ([ln.split()[0] for ln in lines[0].splitlines()[:2]],
                [ln.split()[0] for ln in lines[1:]
                 if ln.startswith(("#", "LAST", "  phase", "  --"))])
    both(scenario)


# ---------------------------------------------------------------------------
# tests/test_introspect.py:650 (cevents from a follower) and :716
# ---------------------------------------------------------------------------

def test_cevents_served_from_follower_e2e(tmp_path, capsys):
    def scenario(P):
        wal = P.wal.WriteAheadLog(str(tmp_path / f"{P.name}-leader.wal"))
        leader = Ctld(P, nodes=3, wal=wal)
        standby = Ctld(P, nodes=3, standby=True, peer_address=leader.addr)
        follower = P.follower.HaFollower(
            standby.server, leader.addr,
            str(tmp_path / f"{P.name}-standby.wal"),
            poll_interval=999.0, miss_threshold=99)
        try:
            s1 = leader.sched
            s1.events.emit("fencing_rejection", "error", node="cn00",
                           detail="push fenced: epoch 1 < current 2")
            s1.events.emit_node_transition("down", "cn01", now=100.0)
            s1.events.emit_node_transition("up", "cn01", now=130.0)
            s1._slo_event("submit-to-dispatch", 60.0, 3.5, True)
            assert follower.poll_once()
            rec = []
            for argv in (("cevents", "--severity", "error"),
                         ("cevents", "--type", "node_flap"),
                         ("cevents", "--after", "99"),
                         ("cevents", "--severity", "warning",
                          "--limit", "2")):
                rc, out, err = run_cli(P.cli, capsys, standby.addr, *argv)
                rec.append((rc, _column_masked(out, "TIME") if out
                            else out, err))
            assert rec[0][0] == 0
            assert "fencing_rejection" in rec[0][1] \
                and "slo_breach" in rec[0][1]
            assert "node_flap" not in rec[0][1]
            assert rec[2][0] == 1
            return rec
        finally:
            follower.stop()
            standby.close()
            leader.close()
            wal.close()
    both(scenario)


def test_explain_profile_and_metrics_filter_over_rpc(tmp_path, capsys):
    def scenario(P):
        with Ctld(P, nodes=3) as c:
            spec = job_spec(cpu=1.0, runtime=50.0, held=True)
            held = c.client.submit(spec).job_id
            rec = [run_cli(P.cli, capsys, c.addr, "cexplain", str(held)),
                   run_cli(P.cli, capsys, c.addr, "cexplain", str(held),
                           "--json"),
                   run_cli(P.cli, capsys, c.addr, "cexplain", "999")]
            assert rec[0][0] == 0 and "blocked at: held" in rec[0][1]
            assert json.loads(rec[1][1])["reason"] == "Held"
            d = str(tmp_path / P.name / "prof")
            rc, out, err = run_cli(P.cli, capsys, c.addr, "cprofile",
                                   "-n", "2", "--dir", d)
            assert rc == 0 and d in out
            assert c.sched.profiler_window.status()["armed"] == 2
            rec.append((rc, out.replace(d, "<dir>"), err))
            rec.append(run_cli(P.cli, capsys, c.addr, "cprofile"))
            assert rec[-1][0] == 1 and "in progress" in rec[-1][2]
            # the compile family: crane_jit_* here, crane_build_* in the
            # port (it compiles kernels, not jit entry points)
            rc, out, err = run_cli(P.cli, capsys, c.addr, "cstats",
                                   "--metrics", P.compiles)
            assert rc == 0 and P.compiles in out
            assert "crane_cycles_total" not in out
            lines = out.splitlines()
            rec.append((rc, lines[0].split(),
                        {row.split()[1] for row in lines[1:]}, err))
            rec.append(run_cli(P.cli, capsys, c.addr, "cstats",
                               "--metrics", "crane_nope"))
            assert rec[-1][0] == 1 and "no metric family" in rec[-1][2]
            return rec
    both(scenario)


# ---------------------------------------------------------------------------
# tests/test_interactive_io.py:171 (the crun watchdog)
# ---------------------------------------------------------------------------

def test_stream_session_watchdog_ends_wait_when_job_dies_unconnected():
    def scenario(P):
        cfored = P.cfored.CforedServer()
        cfored.start()
        try:
            sess = cfored.expect(7, 0)
            t0 = time.time()
            rc = P.cli._stream_session(sess, cancel=lambda: None,
                                       status_poll=lambda: (True, 17))
            took = time.time() - t0
            assert took < 10.0
            return rc
        finally:
            cfored.stop()
    assert both(scenario) == 17


# ---------------------------------------------------------------------------
# the parsers, and the port's CLI on a JAX server and the other way round
# ---------------------------------------------------------------------------

def test_parsers_match():
    from cranesched_tpu_torch import craned_main
    from cranesched_tpu_torch.utils import gres
    assert tcli._parse_gres is gres.parse_gres is craned_main._parse_gres
    for text in ("gpu:a100:2,fpga::1", "gpu:4"):
        assert tcli._parse_gres(text) == jcli._parse_gres(text)
    for bad in ("gpu", "gpu:a:b:c", "gpu:x", "gpu:0"):
        for cli in (jcli, tcli):
            with pytest.raises(SystemExit):
                cli._parse_gres(bad)
    for text in ("64G", "512m", "1.5k", "1024", "2TB"):
        assert tcli._parse_mem(text) == jcli._parse_mem(text)
    for text in ("0-9", "0-9:2", "0-9%2", "5", "1-7:3%4"):
        assert tcli._parse_array(text) == jcli._parse_array(text)
    for text in ("afterok:12", "after:12+30,afterany:3"):
        assert tcli._parse_dependency(text) == \
            jcli._parse_dependency(text)


def _session(cli, server_pkg, capsys):
    """One session of ``cli`` against a server of ``server_pkg``."""
    with Ctld(server_pkg) as c:
        rec = []

        def run(*argv):
            rec.append(run_cli(cli, capsys, c.addr, *argv))
        run("cbatch", "--cpu", "2", "--mem", "1G", "-J", "a",
            "--sim-runtime", "20")
        run("cbatch", "--cpu", "8", "-N", "2", "-J", "gang",
            "--sim-runtime", "50")
        run("cbatch", "--cpu", "1", "--hold", "-J", "held")
        c.client.tick(0.0)
        run("cqueue")
        run("cqueue", "-u", "nobody")
        run("cinfo")
        run("csummary")
        run("cexplain", "3")
        run("cnode", "drain", "cn03")
        run("cnode", "drain", "nope")
        run("cresv", "create", "m", "--nodelist", "cn00", "--start",
            "100", "--end", "200")
        run("cresv", "delete", "m")
        run("cresv", "create", "m")
        c.client.tick(21.0)
        run("cacct")
        run("cinfo")
        rc, out, err = run_cli(cli, capsys, c.addr, "cevents", "--type",
                               "node_drain")
        rec.append((rc, _column_masked(out, "TIME"), err))
        return rec


@pytest.mark.parametrize("cli_pkg, server_pkg", [(PORT, JAX), (JAX, PORT)],
                         ids=["port-cli-jax-server", "jax-cli-port-server"])
def test_cli_across_packages(cli_pkg, server_pkg, capsys):
    own = _session(server_pkg.cli, server_pkg, capsys)
    mixed = _session(cli_pkg.cli, server_pkg, capsys)
    assert mixed == own
    assert own[0][1] == "Submitted batch job 1\n"
