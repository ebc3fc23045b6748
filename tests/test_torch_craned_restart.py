"""Craned restart re-adoption on the port's node plane, against the JAX
package's: the four cases of ``tests/test_craned_restart.py``, each run
on a JAX plane and on a port plane (``test_torch_node_plane.Stack``),
with statuses, exit codes, node names, output files and the restarted
craned's pools compared.  Supervisors are separate processes that
survive a craned crash; a restarted craned reattaches to them from its
durable step registry, and delivers the outcomes of steps that finished
while it was down."""

import time

from test_torch_node_plane import both, wait_for

CONFIG = dict(backfill=False, craned_timeout=30.0)


def _running(st, jid):
    return (jid in st.sched.running
            and st.sched.running[jid].status.name == "RUNNING")


def _terminal(st, jid):
    job = st.sched.job_info(jid)
    return job is not None and job.status.is_terminal


def _readopts(st):
    d1 = st.add_craned("rr00")
    assert st.ready(d1)
    assert wait_for(lambda: st.sched.meta.nodes
                    and st.sched.meta.node_by_name("rr00").alive)
    out = st.tmp_path / "radopt_%j.txt"
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0),
        script="sleep 3; echo survived-$CRANE_JOB_ID",
        output_path=str(out), time_limit=60.0), now=time.time())
    assert wait_for(lambda: _running(st, jid), timeout=10.0)
    assert wait_for(lambda: (jid, 0) in d1._steps, timeout=10.0)
    # the craned crashes; the supervisor keeps running
    d1.stop(graceful=False, orphan_supervisors=True)
    d2 = st.add_craned("rr00")
    assert st.ready(d2)
    assert (jid, 0) in d2._steps, "step not re-adopted"
    assert wait_for(lambda: _terminal(st, jid), timeout=20.0)
    job = st.sched.job_info(jid)
    assert job.status.name == "COMPLETED", job.exit_code
    text = (st.tmp_path / f"radopt_{jid}.txt").read_text()
    assert f"survived-{jid}" in text
    return job.status.name, job.exit_code, job.requeue_count, text


def test_restarted_craned_readopts_live_supervisor(tmp_path):
    jax, port = both(_readopts, tmp_path, config=CONFIG)
    assert port == jax


def _rededucts(st):
    d1 = st.add_craned("rr03")
    d1.gres = {("gpu", ""): 2}
    d1._gres_free = {("gpu", ""): [0, 1]}
    assert st.ready(d1)
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=2.0), script="sleep 300; echo done",
        time_limit=600.0), now=time.time())
    assert wait_for(lambda: (jid, 0) in d1._steps, timeout=10.0)
    alloc = d1._allocs[jid]
    # a GRES hold set by hand and persisted: the registry format is what
    # is under test (the plane's layout has no gpu dimension)
    with d1._lock:
        alloc.gres_held = {("gpu", ""): [0]}
        d1._gres_free[("gpu", "")] = [1]
        d1._persist_registry_locked()
    held_cores = alloc.cores_held
    d1.stop(graceful=False, orphan_supervisors=True)
    d2 = st.add_craned("rr03", gres={("gpu", ""): 2})
    assert jid in d2._allocs
    assert d2._allocs[jid].cores_held == held_cores
    for core in held_cores:
        assert core not in d2._cores_free
    assert d2._gres_free[("gpu", "")] == [1]
    readopted = (sorted(d2._cores_free), dict(d2._gres_free))
    assert st.ready(d2)
    st.sched.cancel(jid, now=time.time())
    assert wait_for(lambda: _terminal(st, jid), timeout=25.0)
    assert wait_for(lambda: sorted(d2._cores_free) == list(range(4)),
                    timeout=5.0)
    assert wait_for(
        lambda: sorted(d2._gres_free[("gpu", "")]) == [0, 1],
        timeout=5.0)
    return (list(held_cores), readopted,
            st.sched.job_info(jid).status.name)


def test_restarted_craned_rededucts_alloc_pools(tmp_path):
    jax, port = both(_rededucts, tmp_path, config=CONFIG)
    assert port == jax


def _finished_while_down(st):
    d1 = st.add_craned("rr01")
    assert st.ready(d1)
    assert wait_for(lambda: st.sched.meta.nodes
                    and st.sched.meta.node_by_name("rr01").alive)
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0), script="sleep 1; exit 7",
        time_limit=60.0), now=time.time())
    assert wait_for(lambda: _running(st, jid), timeout=10.0)
    assert wait_for(lambda: (jid, 0) in d1._steps, timeout=10.0)
    pid = d1._steps[(jid, 0)].pid
    d1.stop(graceful=False, orphan_supervisors=True)
    # the step finishes while no craned is up: its supervisor's durable
    # report waits in the registry
    assert wait_for(lambda: _gone(pid), timeout=10.0)
    d2 = st.add_craned("rr01")
    assert st.ready(d2)
    assert wait_for(lambda: _terminal(st, jid), timeout=15.0)
    job = st.sched.job_info(jid)
    assert job.status.name == "FAILED"
    assert job.exit_code == 7, "durable report lost its exit code"
    return job.status.name, job.exit_code, job.requeue_count


def _gone(pid):
    """The process has exited (no entry, or a zombie left unreaped)."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] == "Z"
    except OSError:
        return True


def test_outcome_of_step_finished_while_craned_down_is_delivered(tmp_path):
    jax, port = both(_finished_while_down, tmp_path, config=CONFIG)
    assert port == jax


def _killable(st):
    d1 = st.add_craned("rr02")
    assert st.ready(d1)
    assert wait_for(lambda: st.sched.meta.nodes
                    and st.sched.meta.node_by_name("rr02").alive)
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0), script="sleep 600",
        time_limit=900.0), now=time.time())
    assert wait_for(lambda: _running(st, jid), timeout=10.0)
    assert wait_for(lambda: (jid, 0) in d1._steps, timeout=10.0)
    d1.stop(graceful=False, orphan_supervisors=True)
    d2 = st.add_craned("rr02")
    assert st.ready(d2)
    assert (jid, 0) in d2._steps
    assert st.sched.cancel(jid, now=time.time())
    assert wait_for(lambda: _terminal(st, jid), timeout=20.0)
    assert st.sched.job_info(jid).status.name == "CANCELLED"
    return st.sched.job_info(jid).status.name


def test_readopted_step_still_killable(tmp_path):
    jax, port = both(_killable, tmp_path, config=CONFIG)
    assert port == jax
