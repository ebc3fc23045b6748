"""The port's preemption (``models/preempt.py``, ``models/preempt_time.py``
and the scheduler's ``_try_preemption``) against the JAX package, bit for
bit on the CPU:

* ``solve_preempt`` on random victim pools (shared and exclusive
  preemptors, padding rows) and ``solve_preempt_timed`` on the cases of
  ``tests/test_preempt_time.py`` and random ones, unit and geometric
  grids: decisions, start buckets, evictions and the final victim mask;
* the segmented exclusive sums against the literal ``[M, N, R]``
  one-hot formulation the JAX package uses;
* the vectorised victim rows and ``can_prey`` against the JAX package's
  nested loops;
* scheduler cycles in ``requeue`` and ``cancel`` modes with backfill on
  and off against the JAX scheduler: started and evicted sets, statuses,
  requeue counts, deferred claims and the ledger; and the exclusive,
  packed and future-start preemptor scenarios.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cranesched_tpu.craned.sim as jsim
import cranesched_tpu.ctld as jctld
import cranesched_tpu.ctld.accounting as jacct
import cranesched_tpu.models.preempt as jp
import cranesched_tpu.models.preempt_time as jpt
import cranesched_tpu_torch.craned.sim as tsim
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.ctld.accounting as tacct
import cranesched_tpu_torch.models.preempt as tp
import cranesched_tpu_torch.models.preempt_time as tpt
from cranesched_tpu_torch.models.solver_time import TimeGrid

R = 3
JAX = (jctld, jacct, jsim)
PORT = (tctld, tacct, tsim)


def _t(x, dtype=None):
    out = torch.from_numpy(np.ascontiguousarray(x))
    return out if dtype is None else out.to(dtype)


def _random_pool(rng, N, V, pad=0):
    """Victim rows in the caller's order (sorted), the avail they leave,
    and ``pad`` invalid rows at the end."""
    total = rng.integers(8, 33, (N, R)).astype(np.int64) * 16
    vids, vnodes, vallocs = [], [], []
    usage = np.zeros((N, R), np.int64)
    for pos in range(V):
        for b in rng.choice(N, size=int(rng.integers(1, 3)), replace=False):
            a = np.maximum(np.minimum(rng.integers(1, 9, R),
                                      total[b] - usage[b]), 0)
            vids.append(pos)
            vnodes.append(int(b))
            vallocs.append(a)
            usage[b] += a
    avail = total - usage
    avail -= np.minimum(rng.integers(0, 4, (N, R)), avail)
    M = len(vids) + pad
    rows = dict(vid=np.zeros(M, np.int32), node=np.full(M, -1, np.int32),
                alloc=np.zeros((M, R), np.int32), valid=np.zeros(M, bool))
    rows["vid"][:len(vids)] = vids
    rows["node"][:len(vids)] = vnodes
    rows["alloc"][:len(vids)] = np.stack(vallocs)
    rows["valid"][:len(vids)] = True
    return total.astype(np.int32), avail.astype(np.int32), rows


def _preemptors(rng, J, N, V, K, ex_share=0.3):
    return dict(
        req=rng.integers(4, 24, (J, R)).astype(np.int32),
        node_num=rng.integers(1, K + 1, J).astype(np.int32),
        time_limit=rng.integers(60, 7200, J).astype(np.int32),
        part_mask=rng.random((J, N)) > 0.15,
        exclusive=rng.random(J) < ex_share,
        can_prey=rng.random((J, V)) > 0.3,
        valid=rng.random(J) > 0.05)


_ROW_KEYS = ("vid", "node", "alloc", "valid")
_JOB_KEYS = ("req", "node_num", "time_limit", "part_mask", "exclusive",
             "can_prey", "valid")


@pytest.mark.parametrize("seed", range(6))
def test_solve_preempt_matches_jax(seed):
    rng = np.random.default_rng(seed)
    N, V, J, K = 12, 10, 8, 2
    total, avail, rows = _random_pool(rng, N, V, pad=3)
    jobs = _preemptors(rng, J, N, V, K)
    alive = rng.random(N) > 0.1
    cost = rng.integers(0, 1000, N).astype(np.int32)
    jd, jv = jp.solve_preempt(
        avail, total, alive, cost,
        jp.VictimRows(*(jnp.asarray(rows[k]) for k in _ROW_KEYS)),
        jp.PreemptorBatch(*(jnp.asarray(jobs[k]) for k in _JOB_KEYS)),
        num_victims=V, max_nodes=K)
    td, tv = tp.solve_preempt(
        _t(avail), _t(total), _t(alive), _t(cost),
        tp.VictimRows(*(_t(rows[k]) for k in _ROW_KEYS)),
        tp.PreemptorBatch(*(_t(jobs[k]) for k in _JOB_KEYS)),
        num_victims=V, max_nodes=K)
    for what, a, b in (("placed", jd.placed, td.placed),
                       ("nodes", jd.nodes, td.nodes),
                       ("evict", jd.evict, td.evict),
                       ("victim_alive", jv, tv)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_segmented_sums_equal_the_literal_onehot_form():
    """Per row, the sum over the earlier rows on its node: the port's
    node-sorted segmented cumulative sum against the JAX package's
    ``[M, N, R]`` one-hot cumsum and gather, with rows off the node
    range grouped at node 0 as the JAX package's clipped gather does."""
    rng = np.random.default_rng(11)
    N, M = 9, 80
    node = rng.integers(-1, N + 1, M).astype(np.int32)   # some off-range
    alloc = rng.integers(0, 50, (M, R)).astype(np.int32)
    chosen = rng.random(M) < 0.6
    onehot = node[:, None] == np.arange(N)[None, :]
    contrib = np.where(chosen[:, None, None],
                       onehot[:, :, None] * alloc[:, None, :], 0)
    cum_excl = np.cumsum(contrib, axis=0) - contrib
    want = cum_excl[np.arange(M), np.clip(node, 0, N - 1)]
    seg = tp.NodeSegments(_t(node), N)
    x = torch.where(_t(chosen & (node >= 0) & (node < N))[:, None],
                    _t(alloc), 0)
    got = seg.exclusive_cumsum(x, torch.int64).numpy()
    np.testing.assert_array_equal(got, want)
    # and over a time axis, as the timed solve uses it
    live = rng.random((M, 5)) < 0.7
    xt = np.where((chosen & (node >= 0) & (node < N))[:, None, None]
                  & live[:, :, None], alloc[:, None, :], 0)
    c4 = onehot[:, :, None, None] * xt[:, None, :, :]
    want_t = (np.cumsum(c4, axis=0) - c4)[np.arange(M),
                                          np.clip(node, 0, N - 1)]
    got_t = seg.exclusive_cumsum(_t(xt), torch.int32).numpy()
    np.testing.assert_array_equal(got_t, want_t)


# ------------------------------------------------------------ timed


def _timed_rows(entries, pad=0):
    m = max(len(entries), 1) + pad
    out = dict(vid=np.zeros(m, np.int32), node=np.zeros(m, np.int32),
               alloc=np.zeros((m, R), np.int32), valid=np.zeros(m, bool),
               end=np.zeros(m, np.int32))
    for i, (v, nd, al, eb) in enumerate(entries):
        out["vid"][i], out["node"][i], out["alloc"][i] = v, nd, al
        out["end"][i], out["valid"][i] = eb, True
    return out


def _timed_jobs(entries, n, V):
    j = len(entries)
    out = dict(req=np.zeros((j, R), np.int32), node_num=np.zeros(j, np.int32),
               time_limit=np.zeros(j, np.int32),
               part_mask=np.ones((j, n), bool), exclusive=np.zeros(j, bool),
               can_prey=np.zeros((j, V), bool), valid=np.ones(j, bool))
    for i, e in enumerate(entries):
        out["req"][i] = e["req"]
        out["node_num"][i] = e.get("node_num", 1)
        out["time_limit"][i] = e["dur"]
        out["exclusive"][i] = e.get("ex", False)
        for v in e.get("prey", ()):
            out["can_prey"][i, v] = True
    return out


def _timed_both(ta, total, alive, cost, rows, jobs, V, K, edges=None):
    jd, jv = jpt.solve_preempt_timed(
        jnp.asarray(ta), jnp.asarray(total), jnp.asarray(alive),
        jnp.asarray(cost),
        jpt.TimedVictimRows(
            rows=jp.VictimRows(*(jnp.asarray(rows[k]) for k in _ROW_KEYS)),
            end_bucket=jnp.asarray(rows["end"])),
        jpt.TimedPreemptorBatch(*(jnp.asarray(jobs[k]) for k in _JOB_KEYS)),
        num_victims=V, max_nodes=K,
        edges=None if edges is None else jnp.asarray(edges))
    tta = _t(ta).clone()
    td, tv = tpt.solve_preempt_timed(
        tta, _t(total), _t(alive), _t(cost).clone(),
        tpt.TimedVictimRows(
            rows=tp.VictimRows(*(_t(rows[k]) for k in _ROW_KEYS)),
            end_bucket=_t(rows["end"])),
        tpt.TimedPreemptorBatch(*(_t(jobs[k]) for k in _JOB_KEYS)),
        num_victims=V, max_nodes=K,
        edges=None if edges is None else _t(edges))
    for what, a, b in (("placed", jd.placed, td.placed),
                       ("start", jd.start_bucket, td.start_bucket),
                       ("nodes", jd.nodes, td.nodes),
                       ("evict", jd.evict, td.evict),
                       ("victim_alive", jv, tv)):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    return td, tv


def _unit_cases():
    T = 8
    full = np.full((1, R), 10, np.int32)
    # evict + wait: a non-preemptable job frees at bucket 2
    ta1 = np.full((1, T, R), 2, np.int32)
    ta1[0, 2:] = 6
    # no needless eviction: the victim ends at 1 anyway
    ta2 = np.zeros((1, T, R), np.int32)
    ta2[0, 1:] = 10
    # immediate eviction on node 0
    ta3 = np.zeros((2, T, R), np.int32)
    ta3[0], ta3[1] = 2, 1
    return {
        "evict_plus_wait": (ta1, full, [(0, 0, [4] * R, T + 5)],
                            [dict(req=[8] * R, dur=2, prey={0})], 1,
                            (True, 2, True)),
        "no_needless_eviction": (ta2, full, [(0, 0, [4] * R, 1)],
                                 [dict(req=[8] * R, dur=3, prey={0})], 1,
                                 (True, 1, False)),
        "immediate_eviction": (ta3, np.full((2, R), 10, np.int32),
                               [(0, 0, [8] * R, T + 1)],
                               [dict(req=[6] * R, dur=4, prey={0})], 1,
                               (True, 0, True)),
        "unschedulable": (np.full((1, 4, R), 1, np.int32),
                          np.full((1, R), 4, np.int32),
                          [(0, 0, [1] * R, 5)],
                          [dict(req=[4] * R, dur=1, prey={0})], 1,
                          (False, 2**30, False)),
    }


@pytest.mark.parametrize("case", sorted(_unit_cases()))
def test_timed_cases_match_jax(case):
    ta, total, victims, jobs, V, want = _unit_cases()[case]
    n = ta.shape[0]
    td, _ = _timed_both(ta, total, np.ones(n, bool), np.zeros(n, np.int32),
                        _timed_rows(victims), _timed_jobs(jobs, n, V), V, 1)
    assert (bool(td.placed[0]), int(td.start_bucket[0]),
            bool(td.evict[0, 0])) == want


@pytest.mark.parametrize("seed,grid", [(0, "unit"), (1, "unit"),
                                       (2, "unit"), (3, "unit"),
                                       (4, "geometric"), (5, "geometric")])
def test_timed_random_matches_jax(seed, grid):
    rng = np.random.default_rng(seed)
    n, T, V, J = 6, 8, 7, 10
    total = np.full((n, R), 12, np.int32)
    ta = np.repeat(total[:, None, :], T, axis=1).astype(np.int32)
    entries = []
    for v in range(V):
        for nd in rng.choice(n, size=int(rng.integers(1, 3)), replace=False):
            al = [int(rng.integers(1, 4))] * R
            eb = int(rng.integers(1, T + 3))
            entries.append((v, int(nd), al, eb))
            ta[nd, :min(eb, T)] -= np.asarray(al, np.int32)
    assert (ta >= 0).all()
    rows = _timed_rows(entries, pad=2)
    jobs = _timed_jobs([dict(
        req=[int(rng.integers(2, 10))] * R,
        node_num=int(rng.integers(1, 3)), dur=int(rng.integers(1, T)),
        prey=set(int(v) for v in rng.choice(V, size=rng.integers(0, V),
                                            replace=False)),
        ex=bool(rng.random() < 0.15)) for _ in range(J)], n, V)
    edges = None
    if grid == "geometric":
        edges = TimeGrid(T, 1.0, horizon=40.0, linear_head=4).edges.astype(
            np.int32)
    cost = rng.integers(0, 40, n).astype(np.int32)
    td, _ = _timed_both(ta, total, rng.random(n) > 0.1, cost, rows, jobs,
                        V, 2, edges=edges)
    assert td.placed.any()


# ------------------------------------------------------ the scheduler


def _accounts(acct):
    mgr = acct.AccountManager()
    mgr.users["root"] = acct.User(name="root",
                                  admin_level=acct.AdminLevel.ROOT)
    mgr.add_qos("root", acct.Qos(name="normal", priority=10))
    mgr.add_qos("root", acct.Qos(name="low", priority=0))
    mgr.add_qos("root", acct.Qos(name="mid", priority=100,
                                 preempt={"low"}))
    mgr.add_qos("root", acct.Qos(name="high", priority=1000,
                                 preempt={"low", "mid"}))
    mgr.add_account("root", acct.Account(
        name="hpc", allowed_qos={"low", "mid", "high", "normal"},
        default_qos="low"))
    mgr.add_user("root", acct.User(name="alice", uid=1), "hpc")
    return mgr


def _cluster(env, num_nodes, cpu=8.0, **cfg):
    ctld, acct, sim = env
    meta = ctld.MetaContainer()
    rng = np.random.default_rng(0)
    for i in range(num_nodes):
        meta.add_node(f"n{i:02d}", meta.layout.encode(
            cpu=cpu if cpu else float(rng.integers(8, 33)),
            mem_bytes=32 << 30, memsw_bytes=32 << 30, is_capacity=True))
        meta.craned_up(i)
    kw = {}
    if ctld is jctld:
        cfg["solver"] = "device"
    else:
        kw["device"] = "cpu"
    sched = ctld.JobScheduler(meta, ctld.SchedulerConfig(**cfg),
                              accounts=_accounts(acct), **kw)
    cluster = sim.SimCluster(sched)
    cluster.wire(sched)
    return sched, cluster


def _spec(env, qos, cpu=8.0, **kw):
    ctld = env[0]
    return ctld.JobSpec(user="alice", account="hpc", qos=qos,
                        res=ctld.ResourceSpec(cpu=cpu, mem_bytes=1 << 30,
                                              memsw_bytes=1 << 30), **kw)


def _record(sched):
    jobs = {**sched.pending, **sched.running, **sched.history}
    return dict(
        jobs={jid: (str(j.status.value), str(j.pending_reason.value),
                    j.requeue_count, sorted(j.node_ids),
                    list(j.task_layout)) for jid, j in sorted(jobs.items())},
        avail=np.stack([n.avail for _, n in sorted(
            sched.meta.nodes.items())]).tolist(),
        deferred=dict(sched._deferred_evictions),
        preempted=sched._cur_trace.get("preempted", 0))


def _burst(env, mode, backfill):
    """A cluster full of low-QoS work (some gangs), then a burst of mid
    and high preemptors (gangs of 2-4 among them) that do not fit."""
    sched, cluster = _cluster(env, 24, cpu=0, preempt_mode=mode,
                              backfill=backfill, time_resolution=60.0,
                              time_buckets=16)
    rng = np.random.default_rng(3)
    for _ in range(70):
        assert sched.submit(_spec(
            env, "low", cpu=float(rng.integers(2, 9)),
            node_num=int(rng.integers(1, 3)),
            time_limit=int(rng.integers(300, 1800)),
            sim_runtime=float(rng.integers(200, 1800))), now=0.0) > 0
    for _ in range(6):
        assert sched.submit(_spec(env, "normal", cpu=4.0, time_limit=600,
                                  sim_runtime=500.0), now=0.0) > 0
    out = [sched.schedule_cycle(now=1.0), _record(sched)]
    for i in range(14):
        qos = "high" if i % 2 else "mid"
        assert sched.submit(_spec(
            env, qos, cpu=float(rng.integers(4, 17)),
            node_num=int(rng.integers(1, 5)) if i % 3 == 0 else 1,
            time_limit=int(rng.integers(120, 900)),
            sim_runtime=float(rng.integers(60, 600))), now=5.0) > 0
    for now in (10.0, 250.0, 700.0, 1300.0):
        cluster.advance_to(now)
        out += [sched.schedule_cycle(now=now), _record(sched)]
    return out


@pytest.mark.parametrize("mode", ["requeue", "cancel"])
@pytest.mark.parametrize("backfill", [False, True],
                         ids=["immediate", "backfill"])
def test_preemption_cycles_match_jax_scheduler(mode, backfill):
    j, t = _burst(JAX, mode, backfill), _burst(PORT, mode, backfill)
    for i, (a, b) in enumerate(zip(j, t)):
        assert a == b, f"step {i} differs"
    records = t[1::2]
    assert sum(r["preempted"] for r in records) > 0
    states = {s for r in records for s, *_ in r["jobs"].values()}
    if mode == "requeue":
        assert any(reason == "Preempted" and rq > 0
                   for r in records for _, reason, rq, *_ in
                   r["jobs"].values())
    else:
        assert "Cancelled" in states


def _exclusive(env):
    sched, cluster = _cluster(env, 2, preempt_mode="requeue",
                              backfill=False)
    lo = [sched.submit(_spec(env, "low", cpu=2.0, sim_runtime=1e9),
                       now=0.0) for _ in range(2)]
    out = [sched.schedule_cycle(now=1.0)]
    hi = sched.submit(_spec(env, "high", cpu=1.0, exclusive=True,
                            node_num=2, sim_runtime=10.0), now=2.0)
    return out + [lo, hi, sched.schedule_cycle(now=3.0), _record(sched)]


def _packed(env):
    sched, cluster = _cluster(env, 2, preempt_mode="requeue",
                              backfill=False)
    lo = sched.submit(_spec(env, "low", cpu=6.0, sim_runtime=1e9), now=0.0)
    out = [sched.schedule_cycle(now=1.0)]
    hi = sched.submit(_spec(env, "high", cpu=1.0,
                            task_res=env[0].ResourceSpec(cpu=2.0), ntasks=4,
                            ntasks_per_node_max=4, node_num=2,
                            sim_runtime=10.0), now=2.0)
    return out + [lo, hi, sched.schedule_cycle(now=3.0), _record(sched)]


def _composes_with_backfill(env):
    sched, cluster = _cluster(env, 1, preempt_mode="requeue", backfill=True,
                              time_buckets=32)
    lo = sched.submit(_spec(env, "low", time_limit=1800,
                            sim_runtime=1800.0), now=0.0)
    out = [sched.schedule_cycle(now=1.0)]
    hi = sched.submit(_spec(env, "high", time_limit=600, sim_runtime=10.0),
                      now=2.0)
    out += [lo, hi, sched.schedule_cycle(now=3.0), _record(sched)]
    lo2 = sched.submit(_spec(env, "low", time_limit=300, sim_runtime=30.0),
                       now=4.0)
    return out + [lo2, sched.schedule_cycle(now=5.0), _record(sched)]


def _future_start(env, cancel_preemptor):
    """The preemptor needs the whole node: only after a non-preemptable
    job ends AND the low victim dies.  The eviction is deferred to its
    start bucket; a cancelled preemptor releases the claim."""
    sched, cluster = _cluster(env, 1, preempt_mode="cancel", backfill=True,
                              time_buckets=16)
    a = sched.submit(_spec(env, "normal", cpu=6.0, time_limit=120,
                           sim_runtime=120.0), now=0.0)
    b = sched.submit(_spec(env, "low", cpu=2.0, time_limit=100000,
                           sim_runtime=100000.0), now=0.0)
    out = [sorted(sched.schedule_cycle(now=0.0))]
    hi = sched.submit(_spec(env, "high", time_limit=50, sim_runtime=50.0),
                      now=1.0)
    out += [sched.schedule_cycle(now=1.0), _record(sched)]
    cluster.advance_to(60.0)
    out += [sched.schedule_cycle(now=60.0), _record(sched)]
    if cancel_preemptor:
        sched.cancel(hi, now=61.0)
    cluster.advance_to(125.0)
    out += [sched.schedule_cycle(now=125.0), _record(sched), a, b, hi]
    return out


_SCENARIOS = {
    "exclusive": _exclusive,
    "packed": _packed,
    "composes_with_backfill": _composes_with_backfill,
    "future_start": lambda env: _future_start(env, False),
    "future_start_withdrawn": lambda env: _future_start(env, True),
}


@pytest.mark.parametrize("case", sorted(_SCENARIOS))
def test_preemptor_scenarios_match_jax_scheduler(case):
    j, t = _SCENARIOS[case](JAX), _SCENARIOS[case](PORT)
    assert j == t
    rec = t[-1] if isinstance(t[-1], dict) else None
    if case == "exclusive":
        lo, hi, started = t[1], t[2], t[3]
        assert hi in started
        assert all(rec["jobs"][j][0] == "Pending" for j in lo)
        assert rec["jobs"][hi][3] == [0, 1]
    elif case == "packed":
        hi, started = t[2], t[3]
        assert hi in started and sorted(rec["jobs"][hi][4]) == [2, 2]
        assert min(min(row) for row in rec["avail"]) >= 0
    elif case == "composes_with_backfill":
        # an immediate start by eviction, not a reservation; a low job
        # without preemption rights still only reserves
        lo, hi, lo2 = t[1], t[2], t[5]
        assert hi in t[3]
        assert t[4]["jobs"][lo][:2] == ("Pending", "Preempted")
        assert rec["jobs"][lo2][0] == "Pending" and lo2 not in t[6]
    else:
        first, at60, final = t[2], t[4], t[6]
        a, b, hi = t[7:]
        assert first["deferred"] and first["jobs"][b][0] == "Running"
        assert first["jobs"][hi][1] == "Priority"
        assert at60["jobs"][b][0] == "Running"
        if case == "future_start":
            assert hi in t[5] and final["jobs"][b][0] == "Cancelled"
        else:
            assert not final["deferred"]
            assert final["jobs"][b][0] == "Running"


# ---------------------------------------- vectorised victim rows


def _nested_loops(sched, cands, prey_sets, victims, now):
    """The JAX package's literal loops (``_try_preemption``): rows per
    (victim, node), ``can_prey`` per (preemptor, victim), release
    buckets per row."""
    rows = [(vi, n, alloc) for vi, v in enumerate(victims)
            for n, alloc in zip(v.node_ids, sched._job_alloc(v))]
    out = dict(vid=np.array([r[0] for r in rows], np.int32),
               node=np.array([r[1] for r in rows], np.int32),
               alloc=np.array([r[2] for r in rows], np.int32))
    can_prey = np.zeros((len(cands), len(victims)), bool)
    for i, prey in enumerate(prey_sets):
        for vi, v in enumerate(victims):
            can_prey[i, vi] = v.qos_name in prey
    out["can_prey"] = can_prey
    T = sched.config.time_buckets
    out["end"] = np.array([min(int(sched._grid.release_bucket(max(
        (victims[vi].start_time or now) + victims[vi].spec.time_limit - now,
        0.0))), T + 1) for vi, _, _ in rows], np.int32)
    return out


def test_victim_rows_and_can_prey_equal_the_nested_loops():
    sched, cluster = _cluster(PORT, 16, cpu=0, preempt_mode="requeue",
                              time_buckets=16)
    rng = np.random.default_rng(9)
    for i in range(40):
        if i == 25:
            sched.schedule_cycle(now=50.0)
        qos = ("low", "mid", "normal")[i % 3]
        sched.submit(_spec(PORT, qos, cpu=float(rng.integers(1, 5)),
                           node_num=int(rng.integers(1, 4)),
                           time_limit=int(rng.integers(60, 3000)),
                           task_res=(PORT[0].ResourceSpec(cpu=0.5)
                                     if i % 5 == 0 else None),
                           ntasks=(4 if i % 5 == 0 else None),
                           ntasks_per_node_max=(4 if i % 5 == 0 else 1),
                           sim_runtime=1e6), now=float(i))
    sched.schedule_cycle(now=90.0)
    for i in range(6):
        sched.submit(_spec(PORT, ("mid", "high")[i % 2], cpu=30.0,
                           node_num=1 + i % 3), now=100.0)
    cands = [j for j in sched.pending.values()
             if sched.accounts.qos[j.qos_name].preempt]
    prey_sets = [sched.accounts.qos[j.qos_name].preempt for j in cands]
    prey = set().union(*prey_sets)
    victims = sorted((j for j in sched.running.values()
                      if j.qos_name in prey),
                     key=lambda v: (v.qos_priority, -(v.start_time or 0.0)))
    assert len(cands) == 6 and len(victims) > 10
    assert len({v.start_time for v in victims}) > 1
    got = sched._preempt_inputs(cands, prey_sets, victims, now=400.0)
    want = _nested_loops(sched, cands, prey_sets, victims, now=400.0)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    assert got["can_prey"].any() and not got["can_prey"].all()
