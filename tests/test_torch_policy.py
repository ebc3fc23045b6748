"""Accounts/QoS and licenses in the port's scheduler against the JAX
scheduler: the scheduler-level cases of ``tests/test_accounting.py`` and
``tests/test_licenses_preempt.py``.  Each scenario runs once per package
on the same inputs and returns what a user sees (submit results, started
lists, statuses, pending reasons, usage counters, license seats); the
two records must be equal, and the port's must show the documented
behaviour.  The ``AccountManager`` is each package's own copy."""

import numpy as np
import pytest

import cranesched_tpu.craned.sim as jsim
import cranesched_tpu.ctld as jctld
import cranesched_tpu.ctld.accounting as jacct
import cranesched_tpu_torch.craned.sim as tsim
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.ctld.accounting as tacct

JAX = (jctld, jacct, jsim)
PORT = (tctld, tacct, tsim)


def _setup(env, qos_kw=None, qos=None):
    ctld, acct, _ = env
    mgr = acct.AccountManager()
    mgr.users["root"] = acct.User(name="root", uid=0,
                                  admin_level=acct.AdminLevel.ROOT)
    if qos is None:
        mgr.add_qos("root", acct.Qos(name="normal", priority=100,
                                     **(qos_kw or {})))
        mgr.add_account("root", acct.Account(
            name="hpc", allowed_qos={"normal"}, default_qos="normal"))
    else:
        for q in qos:
            mgr.add_qos("root", acct.Qos(**q))
        mgr.add_account("root", acct.Account(
            name="hpc", allowed_qos={q["name"] for q in qos},
            default_qos=qos[-1]["name"]))
    mgr.add_user("root", acct.User(name="alice", uid=1001), "hpc")
    mgr.add_user("root", acct.User(name="bob", uid=1002), "hpc")
    return mgr


def _cluster(env, mgr=None, num_nodes=4, cpu=8, config=None):
    ctld, _, sim = env
    meta = ctld.MetaContainer()
    for i in range(num_nodes):
        meta.add_node(f"cn{i:02d}", meta.layout.encode(
            cpu=cpu, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True))
        meta.craned_up(i)
    cfg = dict(config or dict(backfill=False))
    kw = {}
    if ctld is jctld:
        cfg["solver"] = "device"
    else:
        kw["device"] = "cpu"
    sched = ctld.JobScheduler(meta, ctld.SchedulerConfig(**cfg),
                              accounts=mgr, **kw)
    cluster = sim.SimCluster(sched)
    cluster.wire(sched)
    return sched, cluster


def _spec(env, user="alice", account="hpc", cpu=1.0, runtime=50.0, **kw):
    ctld = env[0]
    return ctld.JobSpec(user=user, account=account,
                        res=ctld.ResourceSpec(cpu=cpu, mem_bytes=1 << 30,
                                              memsw_bytes=1 << 30),
                        sim_runtime=runtime, **kw)


def _state(sched, ids):
    return [(str(sched.job_info(j).status.value),
             str(sched.job_info(j).pending_reason.value)) for j in ids]


# ---- submit-time enforcement ----

def _unknown_user(env):
    mgr = _setup(env)
    sched, _ = _cluster(env, mgr)
    out = [sched.submit(_spec(env, user="mallory"), now=0.0)]
    mgr.add_account("root", env[1].Account(
        name="other", default_qos="normal", allowed_qos={"normal"}))
    out.append(sched.submit(_spec(env, account="other"), now=0.0))
    return out


def _blocked(env):
    mgr = _setup(env)
    sched, _ = _cluster(env, mgr)
    mgr.block_user("root", "alice", "hpc")
    out = [sched.submit(_spec(env), now=0.0),
           sched.submit(_spec(env, user="bob"), now=0.0)]
    mgr.block_account("root", "hpc")
    out.append(sched.submit(_spec(env, user="bob"), now=1.0))
    return out


def _max_submit(env):
    mgr = _setup(env, dict(max_submit_jobs_per_user=2))
    sched, _ = _cluster(env, mgr)
    out = [sched.submit(_spec(env), now=0.0) for _ in range(3)]
    out.append(sched.submit(_spec(env, user="bob"), now=0.0))
    j = sched.submit(_spec(env, user="bob"), now=0.0)
    sched.cancel(j, now=0.5)
    out += [j, sched.submit(_spec(env, user="bob"), now=1.0)]
    return out


def _max_wall(env):
    mgr = _setup(env, dict(max_wall=3600))
    sched, _ = _cluster(env, mgr)
    return [sched.submit(_spec(env, time_limit=7200), now=0.0),
            sched.submit(_spec(env, time_limit=1800), now=0.0)]


def _packed_shape(env):
    mgr = _setup(env)
    sched, _ = _cluster(env, mgr)
    task = env[0].ResourceSpec(cpu=0.5)
    return [sched.submit(_spec(env, ntasks=10, node_num=2,
                               ntasks_per_node_max=2, task_res=task),
                         now=0.0),
            sched.submit(_spec(env, ntasks=4, node_num=2,
                               ntasks_per_node_max=2, task_res=task),
                         now=0.0)]


_SUBMIT = {
    "unknown_user": (_unknown_user, [0, 0]),
    "blocked": (_blocked, [0, 1, 0]),
    "max_submit": (_max_submit, [1, 2, 0, 3, 4, 5]),
    "max_wall": (_max_wall, [0, 1]),
    "packed_shape": (_packed_shape, [0, 1]),
}


@pytest.mark.parametrize("case", sorted(_SUBMIT))
def test_submit_time_limits_match_jax(case):
    fn, want = _SUBMIT[case]
    j, t = fn(JAX), fn(PORT)
    assert j == t
    assert t == want


# ---- schedule-time enforcement ----

def _max_jobs_per_user(env):
    mgr = _setup(env, dict(max_jobs_per_user=1))
    sched, cluster = _cluster(env, mgr)
    j1 = sched.submit(_spec(env, runtime=10.0), now=0.0)
    j2 = sched.submit(_spec(env, runtime=10.0), now=0.0)
    out = [sched.schedule_cycle(now=0.0), _state(sched, [j1, j2])]
    cluster.advance_to(11.0)
    out += [sched.schedule_cycle(now=11.0), _state(sched, [j1, j2])]
    cluster.run_until_drained(start=12.0)
    out.append(sorted(str(j.status.value) for j in sched.history.values()))
    return out


def _max_cpus_per_user(env):
    mgr = _setup(env, dict(max_cpus_per_user=4.0))
    sched, cluster = _cluster(env, mgr)
    ids = [sched.submit(_spec(env, cpu=2.0, runtime=20.0), now=0.0)
           for _ in range(4)]
    out = [sched.schedule_cycle(now=0.0), _state(sched, ids)]
    cluster.run_until_drained(start=1.0)
    return out + [len(sched.history)]


def _max_tres_per_account(env):
    ctld = env[0]
    cap = ctld.MetaContainer().layout.encode(
        cpu=4.0, mem_bytes=1 << 40, memsw_bytes=1 << 40).astype(np.int64)
    mgr = _setup(env, dict(max_tres_per_account=cap))
    sched, _ = _cluster(env, mgr)
    ids = [sched.submit(_spec(env, user=u, cpu=2.0, runtime=30.0), now=0.0)
           for u in ("alice", "bob", "bob")]
    return [sorted(sched.schedule_cycle(now=0.0)), _state(sched, ids)]


def _qos_priority(env):
    mgr = _setup(env, qos=[dict(name="high", priority=1000),
                           dict(name="low", priority=0)])
    sched, _ = _cluster(env, mgr, num_nodes=1, cpu=4)
    lo = sched.submit(_spec(env, cpu=4.0, runtime=10.0, qos="low"), now=0.0)
    hi = sched.submit(_spec(env, cpu=4.0, runtime=10.0, qos="high"),
                      now=1.0)
    return [lo, hi, sched.schedule_cycle(now=2.0)]


def _qos_deleted_mid_run(env):
    mgr = _setup(env, dict(max_jobs_per_user=2))
    sched, cluster = _cluster(env, mgr)
    sched.submit(_spec(env, runtime=500.0), now=0.0)
    sched.submit(_spec(env, runtime=10.0), now=0.0)
    out = [sched.schedule_cycle(now=0.0)]
    mgr.accounts["hpc"].allowed_qos.discard("normal")
    mgr.qos["normal"].reference_count = 0
    mgr.delete_qos("root", "normal")
    cluster.advance_to(11.0)
    out.append(sched.schedule_cycle(now=11.0))
    return out + [sched.account_meta._user[("normal", "alice")].jobs]


_SCHEDULE = {
    "max_jobs_per_user": (_max_jobs_per_user, lambda t: (
        t[0] == [1] and t[1][1] == ("Pending", "QOSResourceLimit")
        and t[2] == [2] and t[4] == ["Completed"] * 2)),
    "max_cpus_per_user": (_max_cpus_per_user, lambda t: (
        len(t[0]) == 2 and t[2] == 4
        and sum(r == "QOSResourceLimit" for _, r in t[1]) == 2)),
    "max_tres_per_account": (_max_tres_per_account, lambda t: (
        t[0] == [1, 2] and t[1][2] == ("Pending", "QOSResourceLimit"))),
    "qos_priority": (_qos_priority, lambda t: t[2] == [t[1]]),
    "qos_deleted_mid_run": (_qos_deleted_mid_run, lambda t: t[2] == 1),
}


@pytest.mark.parametrize("case", sorted(_SCHEDULE))
def test_schedule_time_limits_match_jax(case):
    fn, check = _SCHEDULE[case]
    j, t = fn(JAX), fn(PORT)
    assert j == t
    assert check(t), t


# ---- licenses ----

def _license_legality(env):
    sched, _ = _cluster(env)
    sched.licenses.configure("matlab", 4)
    return [sched.submit(_spec(env, licenses=lic), now=0.0)
            for lic in ({"nope": 1}, {"matlab": 5}, {"matlab": 4})]


def _license_gating(env, incremental=True):
    sched, cluster = _cluster(env, num_nodes=8, config=dict(
        backfill=False, incremental=incremental))
    sched.licenses.configure("matlab", 3)
    a = sched.submit(_spec(env, licenses={"matlab": 2}, runtime=10.0),
                     now=0.0)
    b = sched.submit(_spec(env, licenses={"matlab": 2}, runtime=10.0),
                     now=0.0)
    out = [sched.schedule_cycle(now=0.0), _state(sched, [a, b]),
           sched.licenses.licenses["matlab"].in_use]
    cluster.advance_to(11.0)
    out.append(sched.schedule_cycle(now=11.0))
    cluster.run_until_drained(start=12.0)
    return out + [sched.licenses.licenses["matlab"].in_use]


def _license_gating_rebuild(env):
    return _license_gating(env, incremental=False)


def _license_freed_on_cancel(env):
    sched, _ = _cluster(env)
    sched.licenses.configure("lic", 1)
    a = sched.submit(_spec(env, licenses={"lic": 1}, runtime=500.0),
                     now=0.0)
    out = [sched.schedule_cycle(now=0.0),
           sched.licenses.licenses["lic"].in_use]
    sched.cancel(a, now=1.0)
    sched.schedule_cycle(now=2.0)
    return out + [sched.licenses.licenses["lic"].in_use]


_LICENSES = {
    "legality": (_license_legality, lambda t: t == [0, 0, 1]),
    "gating": (_license_gating, lambda t: (
        t[0] == [1] and t[1][1] == ("Pending", "Licenses") and t[2] == 2
        and t[3] == [2] and t[4] == 0)),
    "gating_rebuild": (_license_gating_rebuild, lambda t: (
        t[0] == [1] and t[1][1] == ("Pending", "Licenses")
        and t[3] == [2])),
    "freed_on_cancel": (_license_freed_on_cancel,
                        lambda t: t == [[1], 1, 0]),
}


@pytest.mark.parametrize("case", sorted(_LICENSES))
def test_licenses_match_jax(case):
    fn, check = _LICENSES[case]
    j, t = fn(JAX), fn(PORT)
    assert j == t
    assert check(t), t


def test_license_manager_copy_matches_jax():
    """The port's LicenseManager is the JAX package's: the same seat
    arithmetic, epochs and sync reconciliation."""
    from cranesched_tpu.ctld.licenses import LicenseManager as J
    from cranesched_tpu_torch.ctld.licenses import LicenseManager as T

    def drive(cls):
        m = cls()
        m.configure("a", 4)
        m.configure("r", 10, remote=True)
        out = [m.legal({"a": 5}), m.legal({"zz": 1}), m.malloc({"a": 3}),
               m.sufficient({"a": 2}), m.malloc({"a": 2})]
        m.sync({"r": (12, 5), "a": (99, 99), "new": (3, 1)})
        m.free({"a": 3})
        m.restore({"r": 2})
        return out + [m.epoch] + sorted(
            (k, v.total, v.in_use, v.external_used, v.remote, v.free)
            for k, v in m.licenses.items())

    assert drive(J) == drive(T)
