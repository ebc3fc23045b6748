"""The port's entry points run on the card unless asked for the CPU, and
accept every field of the JAX package's ``SchedulerConfig``.

Here there is no CUDA device, so every entry point given no ``device``
must raise; with ``device="cpu"`` it runs.  What the port carries (every
field of the JAX package's ``SchedulerConfig``, every solver name with
``"sharded"``, packed and exclusive jobs, licenses, accounts,
topologies, preemption modes, reservations named by a job, arrays,
dependencies, begin times, allocation-only jobs and submit hooks) is
accepted; an unknown solver name is invalid.
"""

import numpy as np
import pytest
import torch

from cranesched_tpu_torch import convert
from cranesched_tpu_torch.ctld import (
    JobScheduler,
    JobSpec,
    MetaContainer,
    ResourceSpec,
    SchedulerConfig,
)
from cranesched_tpu_torch.ctld.defs import ArraySpec, Dependency
from cranesched_tpu_torch.models import gpu_solver
from cranesched_tpu_torch.models.solver import make_cluster_state


def _meta(n=4):
    meta = MetaContainer()
    for i in range(n):
        meta.add_node(f"n{i}", meta.layout.encode(
            cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True))
        meta.craned_up(i)
    return meta


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default runs there")


def test_entry_points_raise_without_cuda():
    _no_cuda()
    arr = np.ones((2, 3), np.int32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_cluster_state(arr, arr, np.ones(2, bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.cluster_state(arr, arr, np.ones(2, bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.job_batch(arr, np.ones(2), np.ones(2), np.ones((2, 2)),
                          np.ones(2, bool))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        JobScheduler(_meta(), SchedulerConfig(backfill=False))
    # the explicit CPU request runs
    state = make_cluster_state(arr, arr, np.ones(2, bool), device="cpu")
    assert state.device.type == "cpu"
    JobScheduler(_meta(), SchedulerConfig(backfill=False), device="cpu")


@pytest.mark.parametrize("kw,item", [
    (dict(backfill=False, solver="sharded"), "A10"),
    (dict(dispatch_workers=8), None),
    (dict(cycle_idle_sleep=5.0), None),
])
def test_unsupported_config_raises(kw, item):
    """Every knob the port once refused is accepted as given: the sharded
    solver since its ROADMAP item (A10) landed, the real node plane's
    dispatch pool and the server loop's idle sleep since the dispatcher
    and the server are in the port (item None).  An unknown solver name
    is invalid."""
    from cranesched_tpu_torch.ctld.scheduler import SOLVERS
    cfg = SchedulerConfig(**kw)
    assert all(getattr(cfg, k) == v for k, v in kw.items())
    if item == "A10":
        assert "sharded" in SOLVERS
    with pytest.raises(ValueError, match="solver"):
        SchedulerConfig(solver="tpu")


def test_every_jax_config_field_is_accepted_with_its_default():
    """Every field of the JAX package's SchedulerConfig exists in the
    port's with the same default, and a JAX config of the planes and
    solver names (with the defaults of the server's knobs) builds."""
    import dataclasses

    from cranesched_tpu.ctld.scheduler import SchedulerConfig as JaxConfig

    port = {f.name: f for f in dataclasses.fields(SchedulerConfig)}
    for f in dataclasses.fields(JaxConfig):
        assert f.name in port, f.name
        if f.name == "solver":
            continue   # the port's default stays on its kernel ("cuda")
        if f.default is not dataclasses.MISSING:
            assert port[f.name].default == f.default, f.name
    cfg = SchedulerConfig(cycle_trace_ring=8, job_trace=False,
                          job_trace_capacity=16,
                          slo=(("s", "submit", "dispatched", 99.0, 5.0,
                                (60.0,)),),
                          dispatch_workers=None, cycle_idle_sleep=30.0)
    sched = JobScheduler(_meta(), cfg, device="cpu")
    assert sched.jobtrace is None and sched.slo_engine is not None
    for solver in ("auto", "native", "device", "pallas", "cuda"):
        assert SchedulerConfig(solver=solver).solver == solver


@pytest.mark.parametrize("mode", ["off", "requeue", "cancel"])
def test_preempt_modes_accepted(mode):
    """Preemption is in the port: the JAX package's three modes are
    accepted with backfill on and off; anything else is invalid."""
    for backfill in (True, False):
        assert SchedulerConfig(backfill=backfill,
                               preempt_mode=mode).preempt_mode == mode
    with pytest.raises(ValueError, match="preempt_mode"):
        SchedulerConfig(preempt_mode="suspend")


def test_default_config_runs_the_backfill_cycle():
    """SchedulerConfig() with no overrides: the backfill defaults of the
    JAX package, and a cycle on the CPU that places jobs."""
    cfg = SchedulerConfig()
    assert cfg.backfill and cfg.backfill_max_jobs == 1024
    assert (cfg.time_resolution, cfg.time_buckets) == (60.0, 64)
    assert cfg.time_horizon is None
    sched = JobScheduler(_meta(), cfg, device="cpu")
    for _ in range(6):
        assert sched.submit(JobSpec(res=_RES, time_limit=600), now=0.0)
    assert len(sched.schedule_cycle(now=1.0)) == 6
    assert sched.stats["last_cycle"]["solver"] == "backfill"


def test_config_keeps_the_reference_defaults():
    cfg = SchedulerConfig(backfill=False)
    assert cfg.incremental and cfg.resident_state
    assert cfg.solver == "cuda" and cfg.max_nodes_per_job == 8
    assert (cfg.max_streams, cfg.block_jobs) == (4, 256)
    assert cfg.cycle_trace_ring == 64 and cfg.job_trace
    assert cfg.job_trace_capacity == 4096 and cfg.slo == ()
    assert cfg.dispatch_workers is None and cfg.cycle_idle_sleep == 30.0


_RES = ResourceSpec(cpu=1.0, mem_bytes=1 << 30)


@pytest.mark.parametrize("spec,started", [
    (JobSpec(res=_RES, reservation="r"), True),
    (JobSpec(res=_RES, array=ArraySpec(0, 3)), False),
    (JobSpec(res=_RES, dependencies=(Dependency(1),)), False),
    (JobSpec(res=_RES, begin_time=10.0), False),
    (JobSpec(res=_RES, alloc_only=True), True),
], ids=["reservation", "array", "dependencies", "begin_time",
        "alloc_only"])
def test_out_of_slice_spec_raises(spec, started):
    """The specs that were outside the port until the lifecycle slice
    are accepted now: a job in a reservation and an allocation start at
    once; an array template stays pending while its first child starts;
    a dependent waits for job 1 and a begin time for its edge."""
    meta = _meta()
    sched = JobScheduler(meta, SchedulerConfig(backfill=False),
                         device="cpu")
    assert meta.create_reservation("r", "default", ["n0", "n1"], 0.0,
                                   100.0) is not None
    first = sched.submit(JobSpec(res=_RES, time_limit=50), now=0.0)
    jid = sched.submit(spec, now=0.0)
    assert jid == first + 1
    out = sched.schedule_cycle(now=1.0)
    assert (jid in out) == started
    if spec.array is not None:
        assert len(out) == 2 and sched.job_info(out[1]).array_parent_id \
            == jid
    if spec.dependencies:
        assert sched.pending[jid].pending_reason.name == "DEPENDENCY"
    if spec.begin_time is not None:
        assert sched.pending[jid].pending_reason.name == "BEGIN_TIME"
        assert sched.schedule_cycle(now=10.0) == [jid]


def test_out_of_slice_scheduler_features_raise():
    """A submit hook is accepted: it rewrites the spec or rejects it."""
    import dataclasses

    meta = _meta()
    sched = JobScheduler(
        meta, SchedulerConfig(backfill=False), device="cpu",
        submit_hook=lambda spec: (None if spec.name == "no" else
                                  dataclasses.replace(spec, time_limit=9)))
    assert sched.submit(JobSpec(res=_RES, name="no"), now=0.0) == 0
    jid = sched.submit(JobSpec(res=_RES), now=0.0)
    assert jid > 0 and sched.pending[jid].spec.time_limit == 9


@pytest.mark.parametrize("spec", [
    JobSpec(res=_RES, licenses={"lic": 1}),
    JobSpec(res=_RES, task_res=_RES),
    JobSpec(res=_RES, ntasks=2, ntasks_per_node_max=2),
    JobSpec(res=_RES, exclusive=True),
    JobSpec(res=_RES, ntasks_per_node_max=2),
], ids=["licenses", "task_res", "ntasks", "exclusive",
        "ntasks_per_node_max"])
def test_packed_and_licensed_specs_accepted(spec):
    """Packed and exclusive jobs and licenses are in the port: they are
    submitted and placed."""
    sched = JobScheduler(_meta(), SchedulerConfig(backfill=False),
                         device="cpu")
    sched.licenses.configure("lic", 2)
    jid = sched.submit(spec, now=0.0)
    assert jid > 0
    assert sched.schedule_cycle(now=1.0) == [jid]
    assert sched.stats["last_cycle"]["solver"] in ("packed", "cuda")


def test_accounts_topology_and_preemption_accepted():
    """Accounts, a topology and a preempt_mode no longer raise."""
    from cranesched_tpu_torch.ctld.accounting import (
        Account, AccountManager, AdminLevel, Qos, User)
    from cranesched_tpu_torch.topo import Topology

    mgr = AccountManager()
    mgr.users["root"] = User(name="root", admin_level=AdminLevel.ROOT)
    mgr.add_qos("root", Qos(name="normal", preempt={"normal"}))
    mgr.add_account("root", Account(name="hpc", allowed_qos={"normal"},
                                    default_qos="normal"))
    mgr.add_user("root", User(name="alice", uid=1), "hpc")
    meta = _meta()
    meta.set_topology(Topology.uniform_blocks(4, 2))
    sched = JobScheduler(meta, SchedulerConfig(preempt_mode="requeue"),
                         device="cpu", accounts=mgr)
    jid = sched.submit(JobSpec(res=_RES, user="alice", account="hpc",
                               node_num=2), now=0.0)
    assert jid > 0 and sched.pending[jid].qos_name == "normal"
    assert sched.schedule_cycle(now=1.0) == [jid]
    assert sched.stats["last_cycle"]["solver"] == "topo"
    assert sched.running[jid].topo_block in ("block0", "block1")


def test_invalid_specs_still_rejected_with_zero():
    sched = JobScheduler(_meta(), SchedulerConfig(backfill=False),
                         device="cpu")
    assert sched.submit(JobSpec(res=_RES, partition="nope"), now=0.0) == 0
    assert sched.submit(JobSpec(res=_RES, node_num=9), now=0.0) == 0
    assert sched.submit(JobSpec(res=ResourceSpec(cpu=64.0)), now=0.0) == 0
    assert sched.submit(JobSpec(res=ResourceSpec(
        cpu=1.0, gres={("gpu", "x"): 1})), now=0.0) == 0
    assert sched.submit(JobSpec(res=_RES), now=0.0) == 1


def test_kernel_wrapper_validates_before_launch():
    """A CUDA-side call is checked on the host; here the checks run on
    CPU tensors passed straight to the validator."""
    jobs = torch.zeros((1, 2, 7), dtype=torch.int32)
    nelig = torch.zeros(1, dtype=torch.int32)
    elig = torch.zeros((1, 4), dtype=torch.bool)
    cpu_total = torch.ones(4)
    avail = torch.zeros((4, 3), dtype=torch.int32)
    cost = torch.zeros(4, dtype=torch.int32)
    owned = (torch.arange(4, dtype=torch.int32)[None],
             torch.full((1,), 4, dtype=torch.int32))
    gpu_solver._check(jobs, nelig, elig, cpu_total, avail, cost, 2, *owned)
    with pytest.raises(TypeError):
        gpu_solver._check(jobs, nelig, elig, cpu_total, avail.float(),
                          cost, 2, *owned)
    with pytest.raises(ValueError):
        gpu_solver._check(jobs[:, :, :6].contiguous(), nelig, elig,
                          cpu_total, avail, cost, 2, *owned)
    with pytest.raises(ValueError):
        gpu_solver._check(jobs, nelig, elig, cpu_total, avail, cost, 5,
                          *owned)
    with pytest.raises(ValueError):   # one owned row per stream
        gpu_solver._check(jobs, nelig, elig, cpu_total, avail, cost, 2,
                          owned[0][:, :2].repeat(2, 1), owned[1])
    with pytest.raises(ValueError):
        gpu_solver._check(jobs, nelig, elig, cpu_total, avail.t(), cost, 2,
                          *owned)
