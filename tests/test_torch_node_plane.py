"""The port's real node plane end to end, against the JAX package's: a
ctld gRPC server with the push dispatcher, and craned daemons running
real supervisor processes (handshake, output files, status upcalls,
cancel / suspend signals, ping-timeout failure detection).

Each case of ``tests/test_real_node_plane.py`` runs once on a JAX plane
and once on a port plane, in directories of their own, and the outcomes
are compared: statuses, exit codes, requeue counts, node names, output
file contents and step records.  The suspend case waits for the output
to stop growing after the suspend and then holds its size for a second,
where the JAX file reads it once after a fixed sleep (a write could land
between the suspend and that read).

*Wire interop*: a JAX ``CranedDaemon`` registers with the port's ctld
and runs a job, and a port craned does the same with the JAX ctld; the
two packages' ``crane_pb2`` are byte-identical, so they speak one
protocol.

The harness (``Stack``, ``plane``, ``wait_for``) is shared with the
other node-plane files.
"""

import contextlib
import time
import types

import cranesched_tpu.craned.daemon as jdaemon
import cranesched_tpu.ctld as jctld
import cranesched_tpu.ctld.defs as jdefs
import cranesched_tpu.rpc as jrpc
import cranesched_tpu.rpc.dispatcher as jdisp
import cranesched_tpu_torch.craned.daemon as tdaemon
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.ctld.defs as tdefs
import cranesched_tpu_torch.rpc as trpc
import cranesched_tpu_torch.rpc.dispatcher as tdisp

JAX = types.SimpleNamespace(ctld=jctld, defs=jdefs, rpc=jrpc, disp=jdisp,
                            daemon=jdaemon, kw={}, name="jax")
PORT = types.SimpleNamespace(ctld=tctld, defs=tdefs, rpc=trpc, disp=tdisp,
                             daemon=tdaemon, kw={"device": "cpu"},
                             name="port")


def wait_for(pred, timeout=15.0, interval=0.05):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return False


class Stack:
    """One ctld (scheduler + dispatcher + gRPC server) of package ``S``
    with craneds of package ``craned_pkg`` (``S``'s own by default).
    ``config``: SchedulerConfig fields; other keywords go to every
    craned."""

    def __init__(self, S, tmp_path, craned_pkg=None, config=None,
                 **craned_kw):
        self.S = S
        self.craned_pkg = craned_pkg or S
        self.tmp_path = tmp_path
        tmp_path.mkdir(parents=True, exist_ok=True)
        self.sched = S.ctld.JobScheduler(
            S.ctld.MetaContainer(),
            S.ctld.SchedulerConfig(**(config or dict(
                backfill=False, craned_timeout=3.0))),
            **S.kw)
        self.dispatcher = S.disp.GrpcDispatcher(self.sched)
        self.dispatcher.wire(self.sched)
        self.server, port = S.rpc.serve(
            self.sched, cycle_interval=0.15, dispatcher=self.dispatcher)
        self.ctld_addr = f"127.0.0.1:{port}"
        self.craned_kw = craned_kw
        self.craneds = []

    def add_craned(self, name, **kw):
        args = dict(cpu=4.0, mem_bytes=4 << 30, workdir=str(self.tmp_path),
                    ping_interval=0.5,
                    cgroup_root=str(self.tmp_path / "nocgroup"))
        args.update(self.craned_kw)
        args.update(kw)
        d = self.craned_pkg.daemon.CranedDaemon(name, self.ctld_addr,
                                                **args)
        d.start()
        self.craneds.append(d)
        # one at a time: node ids follow the order of registration, and
        # a gang's node order (ties go to the lowest id) with them
        assert self.ready(d), f"craned {name} did not register"
        return d

    def ready(self, *daemons):
        ready = self.craned_pkg.daemon.CranedState.READY
        return wait_for(lambda: all(d.state == ready for d in daemons))

    def status(self, jid):
        return self.sched.job_info(jid).status.name

    def wait_status(self, jid, name, timeout=15.0):
        return wait_for(lambda: self.status(jid) == name, timeout)

    def close(self):
        for d in self.craneds:
            d.stop()
        self.dispatcher.close()
        self.server.stop()


@contextlib.contextmanager
def plane(S, tmp_path, **kw):
    stack = Stack(S, tmp_path / S.name, **kw)
    try:
        yield stack
    finally:
        stack.close()


def both(scenario, tmp_path, **kw):
    """Run ``scenario(stack)`` on a JAX plane and on a port plane and
    return both outcomes."""
    out = {}
    for S in (JAX, PORT):
        with plane(S, tmp_path, **kw) as stack:
            out[S.name] = scenario(stack)
    return out["jax"], out["port"]


def _job_record(stack, jid):
    job = stack.sched.job_info(jid)
    names = [stack.sched.meta.nodes[n].name for n in job.node_ids]
    return (job.status.name, job.exit_code, job.requeue_count, names)


# ---------------- the cases of tests/test_real_node_plane.py ----------------


def _runs_and_writes_output(st):
    d = st.add_craned("rn00")
    assert st.ready(d)
    assert wait_for(lambda: st.sched.meta.nodes
                    and st.sched.meta.node_by_name("rn00").alive)
    out = st.tmp_path / "out_%j.txt"
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0),
        script="echo hello-from-$CRANE_JOB_ID; echo line2",
        output_path=str(out)), now=time.time())
    assert jid > 0
    assert st.wait_status(jid, "COMPLETED")
    text = (st.tmp_path / f"out_{jid}.txt").read_text()
    assert f"hello-from-{jid}" in text and "line2" in text
    node = st.sched.meta.node_by_name("rn00")
    assert (node.avail == node.total).all()
    return _job_record(st, jid), text


def test_real_job_runs_and_writes_output(tmp_path):
    jax, port = both(_runs_and_writes_output, tmp_path)
    assert port == jax


def _failing_script(st):
    d = st.add_craned("rn01")
    assert st.ready(d)
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0), script="exit 7"),
        now=time.time())
    assert st.wait_status(jid, "FAILED")
    assert st.sched.job_info(jid).exit_code == 7
    return _job_record(st, jid)


def test_failing_script_reports_exit_code(tmp_path):
    jax, port = both(_failing_script, tmp_path)
    assert port == jax


def _cancel_kills(st):
    d = st.add_craned("rn02")
    assert st.ready(d)
    marker = st.tmp_path / "never.txt"
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0),
        script=f"sleep 60; touch {marker}"), now=time.time())
    assert st.wait_status(jid, "RUNNING")
    assert wait_for(lambda: (jid, 0) in d._steps)
    st.sched.cancel(jid, now=time.time())
    assert st.wait_status(jid, "CANCELLED")
    assert wait_for(lambda: not d._steps)
    assert not marker.exists()
    return _job_record(st, jid)


def test_cancel_kills_real_process(tmp_path):
    jax, port = both(_cancel_kills, tmp_path)
    assert port == jax


def _time_limit(st):
    d = st.add_craned("rn03")
    assert st.ready(d)
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0), script="sleep 30",
        time_limit=1), now=time.time())
    assert st.wait_status(jid, "EXCEED_TIME_LIMIT", timeout=20.0)
    return _job_record(st, jid)


def test_time_limit_enforced_by_supervisor(tmp_path):
    jax, port = both(_time_limit, tmp_path)
    assert port == jax


def _size(path):
    return path.stat().st_size if path.exists() else 0


def _steady_size(path, quiet=0.5, timeout=10.0):
    """The file's size once it has not changed for ``quiet`` seconds."""
    size, since = _size(path), time.time()
    deadline = time.time() + timeout
    while time.time() < deadline:
        time.sleep(0.05)
        now_size = _size(path)
        if now_size != size:
            size, since = now_size, time.time()
        elif time.time() - since >= quiet:
            return size
    raise AssertionError(f"{path} kept growing for {timeout} s")


def _suspend_resume(st):
    d = st.add_craned("rn04")
    assert st.ready(d)
    stamp = st.tmp_path / "stamp.txt"
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0),
        script=f"for i in 1 2 3 4 5; do date +%s%N >> {stamp}; "
               "sleep 0.2; done"), now=time.time())
    assert st.wait_status(jid, "RUNNING")
    assert wait_for(lambda: _size(stamp) > 0)
    st.sched.suspend(jid, now=time.time())
    # a write may land between the suspend and the signal: wait until
    # the output stops growing, then it must hold for a second
    size_at_suspend = _steady_size(stamp)
    time.sleep(1.0)
    assert _size(stamp) == size_at_suspend
    assert st.status(jid) == "SUSPENDED"
    st.sched.resume(jid, now=time.time())
    assert st.wait_status(jid, "COMPLETED")
    assert _size(stamp) > size_at_suspend
    return _job_record(st, jid), len(stamp.read_text().splitlines())


def test_suspend_resume_real_process(tmp_path):
    jax, port = both(_suspend_resume, tmp_path)
    assert port == jax and port[1] == 5


def _gang(st):
    d1, d2 = st.add_craned("gn00"), st.add_craned("gn01")
    assert st.ready(d1, d2)
    out = st.tmp_path / "gang.txt"
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=4.0), node_num=2,
        script=f"echo ran-on-$CRANE_JOB_NODELIST >> {out}"),
        now=time.time())
    assert st.wait_status(jid, "COMPLETED")
    assert wait_for(lambda: out.exists()
                    and out.read_text().count("ran-on-") == 2)
    return _job_record(st, jid), sorted(out.read_text().splitlines())


def test_two_craneds_gang_job(tmp_path):
    jax, port = both(_gang, tmp_path)
    assert port == jax


def _gang_one_fails(st):
    d1, d2 = st.add_craned("fn00"), st.add_craned("fn01")
    assert st.ready(d1, d2)
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=4.0), node_num=2,
        script='[ "$CRANE_NODE_NAME" = fn00 ] && exit 3; sleep 60'),
        now=time.time())
    assert st.wait_status(jid, "FAILED", timeout=20.0)
    assert st.sched.job_info(jid).exit_code == 3
    assert wait_for(lambda: not d1._steps and not d2._steps)
    for name in ("fn00", "fn01"):
        node = st.sched.meta.node_by_name(name)
        assert (node.avail == node.total).all()
    return _job_record(st, jid)


def test_gang_one_node_fails_kills_the_rest(tmp_path):
    jax, port = both(_gang_one_fails, tmp_path)
    assert port == jax


def _ping_timeout(st):
    d = st.add_craned("pn00")
    assert st.ready(d)
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0), script="sleep 60",
        time_limit=300), now=time.time())
    assert st.wait_status(jid, "RUNNING")
    assert wait_for(lambda: (jid, 0) in d._steps)
    d.stop(graceful=False)
    assert wait_for(
        lambda: not st.sched.meta.node_by_name("pn00").alive,
        timeout=15.0)
    job = st.sched.job_info(jid)
    assert job.status.name == "PENDING" and job.requeue_count == 1
    return job.status.name, job.requeue_count


def test_ping_timeout_marks_node_down_and_requeues(tmp_path):
    jax, port = both(_ping_timeout, tmp_path)
    assert port == jax


def _calloc_steps(st):
    d = st.add_craned("an00")
    assert st.ready(d)
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=4.0), alloc_only=True,
        time_limit=300), now=time.time())
    assert st.wait_status(jid, "RUNNING")
    assert wait_for(lambda: jid in d._allocs)
    assert not d._steps
    out = st.tmp_path / "steps.txt"
    share = st.S.ctld.ResourceSpec(cpu=1.0)
    ids = [st.sched.submit_step(jid, st.S.ctld.StepSpec(
        name=name, res=share, script=script), now=time.time())
        for name, script in (("ok", f"echo step0 >> {out}; exit 0"),
                             ("fail", "exit 9"),
                             ("ok2", f"echo step2 >> {out}; exit 0"))]
    assert ids == [0, 1, 2]
    job = st.sched.job_info(jid)
    assert wait_for(lambda: all(job.steps[s].status.is_terminal
                                for s in ids), timeout=20.0)
    steps = [(job.steps[s].spec.name, job.steps[s].status.name,
              job.steps[s].exit_code) for s in ids]
    assert steps == [("ok", "COMPLETED", 0), ("fail", "FAILED", 9),
                     ("ok2", "COMPLETED", 0)]
    assert out.read_text().count("step") == 2
    assert jid in st.sched.running and jid in d._allocs
    assert st.sched.free_allocation(jid, now=time.time())
    assert st.status(jid) == "COMPLETED"
    assert wait_for(lambda: jid not in d._allocs)
    node = st.sched.meta.node_by_name("an00")
    assert wait_for(lambda: (node.avail == node.total).all())
    return _job_record(st, jid), steps, sorted(
        out.read_text().splitlines())


def test_calloc_allocation_runs_three_real_steps(tmp_path):
    jax, port = both(_calloc_steps, tmp_path)
    assert port == jax


def _gang_env(st):
    daemons = [st.add_craned(f"gv{i:02d}", cpu=4.0) for i in range(4)]
    assert st.ready(*daemons)
    out = st.tmp_path / "gang_env.txt"
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=2.0), node_num=4,
        script=(f"echo $CRANE_NODE_RANK/$CRANE_NNODES"
                f"@$CRANE_JOB_NODELIST@$CRANE_RENDEZVOUS"
                f"@$CRANE_NODE_NAME >> {out}")),
        now=time.time())
    assert st.wait_status(jid, "COMPLETED", timeout=20.0)
    assert wait_for(lambda: out.exists()
                    and len(out.read_text().splitlines()) == 4)
    ranks, nodelists, rdv = {}, set(), set()
    for line in sorted(out.read_text().splitlines()):
        rank_part, nodelist, endpoint, node_name = line.split("@")
        rank, nnodes = rank_part.split("/")
        assert nnodes == "4"
        ranks[int(rank)] = node_name
        nodelists.add(nodelist)
        rdv.add(endpoint)
    assert set(ranks) == {0, 1, 2, 3}
    assert nodelists == {"gv[00-03]"}
    assert len(rdv) == 1
    endpoint = rdv.pop()
    host, port = endpoint.split(":")
    assert host == ranks[0] and port.isdigit()
    # the rendezvous port is a hash of (job, step, incarnation): the
    # same in both packages
    return _job_record(st, jid), ranks, endpoint


def test_gang_rendezvous_env_lets_members_enumerate_each_other(tmp_path):
    jax, port = both(_gang_env, tmp_path)
    assert port == jax


# ---------------- wire interop ----------------


def _interop(st):
    d = st.add_craned("xn00")
    assert st.ready(d)
    out = st.tmp_path / "x_%j.txt"
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0),
        script="echo interop-$CRANE_JOB_ID-$CRANE_NODE_NAME",
        output_path=str(out)), now=time.time())
    assert st.wait_status(jid, "COMPLETED")
    bad = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0), script="exit 5"),
        now=time.time())
    assert st.wait_status(bad, "FAILED")
    return (_job_record(st, jid), _job_record(st, bad),
            (st.tmp_path / f"x_{jid}.txt").read_text())


def test_jax_craned_runs_a_job_for_the_port_ctld(tmp_path):
    with plane(PORT, tmp_path, craned_pkg=JAX) as st:
        mixed = _interop(st)
    with plane(JAX, tmp_path / "ref") as st:
        ref = _interop(st)
    assert mixed == ref
    assert mixed[0][0] == "COMPLETED" and mixed[1][:2] == ("FAILED", 5)
    assert mixed[2] == "interop-1-xn00\n"


def test_port_craned_runs_a_job_for_the_jax_ctld(tmp_path):
    with plane(JAX, tmp_path, craned_pkg=PORT) as st:
        mixed = _interop(st)
    with plane(PORT, tmp_path / "ref") as st:
        ref = _interop(st)
    assert mixed == ref
    assert mixed[0][0] == "COMPLETED" and mixed[1][:2] == ("FAILED", 5)
    assert mixed[2] == "interop-1-xn00\n"


def test_supervisor_is_the_ports_and_loads_no_torch(tmp_path):
    """The port's craned spawns ``-m cranesched_tpu_torch.craned.
    supervisor`` with its own package first on PYTHONPATH, and the
    supervisor process maps no torch library."""
    import os

    import cranesched_tpu_torch

    with plane(PORT, tmp_path) as st:
        d = st.add_craned("sv00")
        assert st.ready(d)
        jid = st.sched.submit(st.S.ctld.JobSpec(
            res=st.S.ctld.ResourceSpec(cpu=1.0), script="sleep 30"),
            now=time.time())
        assert wait_for(lambda: (jid, 0) in d._steps)
        pid = d._steps[(jid, 0)].pid
        with open(f"/proc/{pid}/cmdline", "rb") as fh:
            argv = fh.read().decode().split("\0")
        with open(f"/proc/{pid}/environ", "rb") as fh:
            env = dict(kv.split("=", 1) for kv in
                       fh.read().decode().split("\0") if "=" in kv)
        with open(f"/proc/{pid}/maps") as fh:
            maps = fh.read()
        st.sched.cancel(jid, now=time.time())
        assert st.wait_status(jid, "CANCELLED")
    assert argv[1:3] == ["-m", "cranesched_tpu_torch.craned.supervisor"]
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(cranesched_tpu_torch.__file__)))
    assert env["PYTHONPATH"].split(os.pathsep)[0] == root
    assert "libtorch" not in maps and "/torch/" not in maps
