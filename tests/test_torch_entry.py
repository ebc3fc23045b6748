"""The port's entry points run on the card unless asked for the CPU, and
refuse loudly what slice 1 does not carry.

Here there is no CUDA device, so every entry point given no ``device``
must raise; with ``device="cpu"`` it runs.  Out-of-slice configuration
and job specs raise ``NotImplementedError`` naming their ROADMAP item
instead of being accepted or rejected as invalid.
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
    (dict(), "A7"),                          # backfill stays the default
    (dict(backfill=False, preempt_mode="requeue"), "A8"),
    (dict(backfill=False, solver="device"), "A8"),
])
def test_unsupported_config_raises(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        SchedulerConfig(**kw)


def test_config_keeps_the_reference_defaults():
    cfg = SchedulerConfig(backfill=False)
    assert cfg.incremental and cfg.resident_state
    assert cfg.solver == "cuda" and cfg.max_nodes_per_job == 8
    assert (cfg.max_streams, cfg.block_jobs) == (4, 256)


_RES = ResourceSpec(cpu=1.0, mem_bytes=1 << 30)


@pytest.mark.parametrize("spec", [
    JobSpec(res=_RES, reservation="r"),
    JobSpec(res=_RES, licenses={"lic": 1}),
    JobSpec(res=_RES, array=ArraySpec(0, 3)),
    JobSpec(res=_RES, dependencies=(Dependency(1),)),
    JobSpec(res=_RES, begin_time=10.0),
    JobSpec(res=_RES, task_res=_RES),
    JobSpec(res=_RES, ntasks=3),
    JobSpec(res=_RES, exclusive=True),
    JobSpec(res=_RES, ntasks_per_node_max=2),
    JobSpec(res=_RES, alloc_only=True),
], ids=["reservation", "licenses", "array", "dependencies", "begin_time",
        "task_res", "ntasks", "exclusive", "ntasks_per_node_max",
        "alloc_only"])
def test_out_of_slice_spec_raises(spec):
    sched = JobScheduler(_meta(), SchedulerConfig(backfill=False),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        sched.submit(spec, now=0.0)
    assert not sched.pending


def test_out_of_slice_scheduler_features_raise():
    meta = _meta()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        JobScheduler(meta, SchedulerConfig(backfill=False), device="cpu",
                     accounts=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        JobScheduler(meta, SchedulerConfig(backfill=False), device="cpu",
                     submit_hook=lambda spec: spec)
    sched = JobScheduler(meta, SchedulerConfig(backfill=False),
                         device="cpu")
    meta.topology = object()   # any attached topology
    sched.submit(JobSpec(res=_RES), now=0.0)
    with pytest.raises(NotImplementedError, match="topology"):
        sched.schedule_cycle(now=1.0)


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
    gpu_solver._check(jobs, nelig, elig, cpu_total, avail, cost, 2)
    with pytest.raises(TypeError):
        gpu_solver._check(jobs, nelig, elig, cpu_total, avail.float(),
                          cost, 2)
    with pytest.raises(ValueError):
        gpu_solver._check(jobs[:, :, :6].contiguous(), nelig, elig,
                          cpu_total, avail, cost, 2)
    with pytest.raises(ValueError):
        gpu_solver._check(jobs, nelig, elig, cpu_total, avail, cost, 5)
    with pytest.raises(ValueError):
        gpu_solver._check(jobs, nelig, elig, cpu_total, avail.t(), cost, 2)
