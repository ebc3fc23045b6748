"""The port's device-resident cluster state (``ctld/resident.py``).

The resident path must be invisible to scheduling semantics: over a
randomized event script the port's scheduler with resident state on
must produce the same placements, pending reasons and ledger as with it
off, and as the JAX package's scheduler.  Plus the residency contract:
rebuild → patch / ledger modes and their byte counts, ``stage()``
pre-copies, ``mark_diverged`` after a commit-time rejection, ownership
transfer on acquire, and key invalidation (mask-table generation, node
count, backend label).
"""

import numpy as np
import pytest

from cranesched_tpu import ctld as jctld
from cranesched_tpu.craned.sim import SimCluster as JSimCluster
from cranesched_tpu_torch import ctld as tctld
from cranesched_tpu_torch.craned.sim import SimCluster as TSimCluster
from cranesched_tpu_torch.ctld.resident import (
    ResidentClusterState,
    full_state_bytes,
    padded_rows,
    patch_row_bytes,
)


def _cluster(pkg, num_nodes=8, resident=True, parts=None):
    meta = pkg.MetaContainer()
    for i in range(num_nodes):
        meta.add_node(f"n{i:02d}", meta.layout.encode(
            cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True),
            partitions=(parts[i],) if parts else ("default",))
        meta.craned_up(i)
    cfg = dict(backfill=False, resident_state=resident)
    kw = {}
    if pkg is jctld:
        cfg["solver"] = "device"
        sim_cls = JSimCluster
    else:
        kw["device"] = "cpu"
        sim_cls = TSimCluster
    sched = pkg.JobScheduler(meta, pkg.SchedulerConfig(**cfg), **kw)
    sim = sim_cls(sched)
    sim.wire(sched)
    return sched, sim


def _spec(pkg, cpu=1.0, **kw):
    return pkg.JobSpec(res=pkg.ResourceSpec(cpu=cpu, mem_bytes=1 << 30,
                                            memsw_bytes=1 << 30), **kw)


def _state(sched):
    avail, _, alive = sched.meta.snapshot()
    return ({jid: str(job.pending_reason.value)
             for jid, job in sched.pending.items()},
            sorted(sched.running), sorted(sched.history),
            np.asarray(avail).copy(), np.asarray(alive).copy())


def _same_state(a, b, where):
    assert a[:3] == b[:3], where
    assert np.array_equal(a[3], b[3]) and np.array_equal(a[4], b[4]), where


def _mode(sched):
    return sched.stats["last_cycle"].get("resident")


def test_steady_state_patch_bytes_and_staging():
    """After the first rebuild every churn cycle ships only the dirty
    rows (pre-copied by stage()), within the padded-row byte bound."""
    sched, sim = _cluster(tctld, num_nodes=64)
    n, r = 64, sched.meta.layout.num_dims
    modes = []
    for t in range(1, 13):
        sched.submit(_spec(tctld, sim_runtime=1000.0), now=float(t))
        sim.advance_to(float(t))
        sched.schedule_cycle(now=float(t))
        last = sched.stats["last_cycle"]
        modes.append(last["resident"])
        if last["resident"] == "patch":
            assert last["h2d_bytes"] == (
                padded_rows(last["h2d_rows"], n) * patch_row_bytes(r)
                + 4 * n)
            assert last["h2d_bytes"] < full_state_bytes(n, r)
            assert last["patch_overlap"], f"t={t}: delta not staged"
    assert modes[0] == "rebuild"
    assert all(m == "patch" for m in modes[1:]), modes
    res = sched._resident
    assert res.full_rebuilds == 1 and res.overlap_share() == 1.0
    # the resident tensors are the host ledger
    avail, _, _ = sched.meta.snapshot()
    assert np.array_equal(res._state.avail.numpy(), avail)


def test_ledger_mode_when_nothing_moved():
    """A cycle that follows a zero-placement commit has an empty delta:
    only the [N] cost ledger ships ("ledger" mode, 4*N bytes)."""
    sched, sim = _cluster(tctld, num_nodes=4)
    for _ in range(4):   # one per node: the cost spreads them
        sched.submit(_spec(tctld, sim_runtime=1e6), now=1.0)
    assert len(sched.schedule_cycle(now=1.0)) == 4
    assert _mode(sched) == "rebuild"
    # a whole node's cpu fits nowhere now: no commit, no dirty row
    sched.submit(_spec(tctld, cpu=8.0, sim_runtime=1e6), now=2.0)
    assert sched.schedule_cycle(now=2.0) == []
    assert _mode(sched) == "patch"   # the first cycle's commit
    sched.submit(_spec(tctld, cpu=8.0, sim_runtime=1e6), now=3.0)
    assert sched.schedule_cycle(now=3.0) == []
    assert _mode(sched) == "ledger"
    assert sched.stats["last_cycle"]["h2d_bytes"] == 4 * 4
    assert sched._resident.ledger_cycles == 1


def _parity_script(seed, ticks=25):
    """One event script against the JAX scheduler (resident on), the
    port with resident state on, and the port with it off."""
    sides = [_cluster(jctld), _cluster(tctld),
             _cluster(tctld, resident=False)]
    ops = np.random.default_rng(seed)
    for t in range(1, ticks + 1):
        now = float(t)
        specs = []
        for _ in range(int(ops.integers(0, 4))):
            r = np.random.default_rng(int(ops.integers(0, 2**31)))
            specs.append(dict(cpu=float(r.integers(1, 5)),
                              node_num=int(r.integers(1, 3)),
                              time_limit=int(r.integers(60, 3600)),
                              sim_runtime=float(r.integers(1, 6))))
        pend = sorted(sides[0][0].pending)
        cancel = (int(pend[int(ops.integers(0, len(pend)))])
                  if pend and ops.random() < 0.3 else None)
        drain = ((int(ops.integers(0, 8)), bool(ops.integers(0, 2)))
                 if ops.random() < 0.2 else None)
        for (sched, sim), pkg in zip(sides, (jctld, tctld, tctld)):
            for kw in specs:
                sched.submit(_spec(pkg, **kw), now=now)
            if cancel is not None:
                sched.cancel(cancel, now=now)
            if drain is not None:
                sched.meta.drain(*drain)
        started = []
        for sched, sim in sides:
            sim.advance_to(now)
            started.append(sched.schedule_cycle(now=now))
        assert started[0] == started[1] == started[2], f"t={t}"
        ref = _state(sides[0][0])
        for sched, _ in sides[1:]:
            _same_state(ref, _state(sched), f"t={t}")
    return sides[1][0]


@pytest.mark.parametrize("seed", [7, 11])
def test_randomized_parity_resident_vs_rebuild_vs_jax(seed):
    sched = _parity_script(seed)
    assert sched._resident.patch_cycles > 0
    assert sched._resident.full_rebuilds == 1


def test_commit_rejection_marks_diverged():
    """A job cancelled while its placement is in flight: the device
    subtracted its resources, the host never allocated them.  The rows
    must be force-patched so the next cycles match the JAX scheduler."""
    sides = [(_cluster(jctld), jctld), (_cluster(tctld), tctld)]
    for (sched, sim), pkg in sides:
        for _ in range(6):
            sched.submit(_spec(pkg, cpu=4.0, sim_runtime=50.0), now=0.0)
        gen = sched.cycle_phases(now=1.0)
        solve = next(gen)
        result = solve()
        assert sched.cancel(2, now=1.0)    # placed by the solve
        try:
            fn = gen.send(result)
            while True:
                fn = gen.send(fn())
        except StopIteration:
            pass
    port = sides[1][0][0]
    assert port._resident._diverged, "rejected rows not marked"
    for t in (2.0, 3.0, 60.0):
        out = []
        for (sched, sim), pkg in sides:
            sim.advance_to(t)
            sched.submit(_spec(pkg, cpu=2.0, sim_runtime=5.0), now=t)
            out.append(sched.schedule_cycle(now=t))
        assert out[0] == out[1], f"t={t}"
        _same_state(_state(sides[0][0][0]), _state(port), f"t={t}")
    avail, _, _ = port.meta.snapshot()
    assert np.array_equal(port._resident._state.avail.numpy(), avail)


def test_acquire_transfers_ownership_and_mid_solve_dirt_survives():
    sched, sim = _cluster(tctld)
    sched.submit(_spec(tctld, sim_runtime=5.0), now=1.0)
    sched.schedule_cycle(now=1.0)
    res = sched._resident
    before = res._state
    assert before is not None
    avail, total, alive = sched.meta.snapshot()
    cost0 = np.zeros(len(sched.meta.nodes), np.int32)
    state, mode = res.acquire(avail, total, alive, cost0, key=res._key)
    assert res._state is None and mode == "patch"
    assert state is before          # patched in place, never copied
    res._note_dirty(3)              # a mutation lands mid-solve
    res.adopt(state)
    assert res._state is state and 3 in res._pending


def test_mask_generation_and_node_count_force_rebuild():
    sched, sim = _cluster(tctld)
    for t in (1.0, 2.0):
        sched.submit(_spec(tctld, sim_runtime=100.0), now=t)
        sched.schedule_cycle(now=t)
    assert _mode(sched) == "patch"
    # a reservation bumps resv_epoch -> new mask-table generation
    assert sched.meta.create_reservation(
        "resv", "default", ["n00"], start_time=100.0, end_time=200.0)
    sched.submit(_spec(tctld, sim_runtime=100.0), now=3.0)
    sched.schedule_cycle(now=3.0)
    assert _mode(sched) == "rebuild"
    # a new node changes N
    node = sched.meta.add_node("n99", sched.meta.layout.encode(
        cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30, is_capacity=True))
    sched.meta.craned_up(node.node_id)
    sched.submit(_spec(tctld, sim_runtime=100.0), now=4.0)
    sched.schedule_cycle(now=4.0)
    assert _mode(sched) == "rebuild"
    assert sched._resident.full_rebuilds == 3
    avail, _, _ = sched.meta.snapshot()
    assert np.array_equal(sched._resident._state.avail.numpy(), avail)


def test_backend_key_switch_and_disabled_state():
    meta = tctld.MetaContainer()
    for i in range(2):
        meta.add_node(f"n{i}", meta.layout.encode(
            cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True))
        meta.craned_up(i)
    import torch
    res = ResidentClusterState(meta, torch.device("cpu"))
    avail, total, alive = (np.asarray(x).copy() for x in meta.snapshot())
    cost0 = np.zeros(2, np.int32)
    state, mode = res.acquire(avail, total, alive, cost0,
                              key=("cuda", 2, 3, 0))
    assert mode == "rebuild"
    res.adopt(state)
    state, mode = res.acquire(avail, total, alive, cost0,
                              key=("other", 2, 3, 0))
    assert mode == "rebuild" and res.full_rebuilds == 2
    # resident_state=False: no listener, nothing kept, no trace fields
    sched, sim = _cluster(tctld, resident=False)
    sched.submit(_spec(tctld, sim_runtime=1.0), now=1.0)
    sched.schedule_cycle(now=1.0)
    assert _mode(sched) is None and sched._resident._state is None
