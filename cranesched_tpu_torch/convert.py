"""Carry the JAX package's values into the port.

Each function takes the fields of one of the JAX package's structures as
numpy arrays (the caller converts with ``np.asarray``; this module never
imports JAX) and returns the port's object on ``device``.  ``device``
defaults to the CUDA card, as every entry point of the port does; pass
``device="cpu"`` to stay on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from cranesched_tpu_torch.device import resolve_device
from cranesched_tpu_torch.models.priority import (
    PendingPriorityAttrs,
    RunningPriorityAttrs,
)
from cranesched_tpu_torch.models.solver import (
    ClusterState,
    FactoredJobBatch,
    JobBatch,
    make_cluster_state,
    normalize_cost_ledger,
)
from cranesched_tpu_torch.models.solver_time import (
    TimedClusterState,
    TimedJobBatch,
    TimeGrid,
)


def _t(x, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x)).to(device=dev, dtype=dtype)


def cluster_state(avail, total, alive, cost=None,
                  device=None) -> ClusterState:
    """ClusterState from (avail, total, alive, cost); a float cost seed
    is rounded into the int32 ledger, an integer one is taken as is."""
    return make_cluster_state(avail, total, alive, cost, device=device)


def job_batch(req, node_num, time_limit, part_mask, valid,
              device=None) -> JobBatch:
    dev = resolve_device(device)
    return JobBatch(req=_t(req, torch.int32, dev),
                    node_num=_t(node_num, torch.int32, dev),
                    time_limit=_t(time_limit, torch.int32, dev),
                    part_mask=_t(part_mask, torch.bool, dev),
                    valid=_t(valid, torch.bool, dev))


def factored_job_batch(req, node_num, time_limit, valid, job_class,
                       class_masks, device=None) -> FactoredJobBatch:
    """FactoredJobBatch with its host mirrors (``job_class_np``,
    ``class_rows_np``) taken from the same arrays."""
    dev = resolve_device(device)
    job_class_np = np.asarray(job_class, np.int32)
    class_rows_np = np.asarray(class_masks, bool)
    return FactoredJobBatch(
        req=_t(req, torch.int32, dev),
        node_num=_t(node_num, torch.int32, dev),
        time_limit=_t(time_limit, torch.int32, dev),
        valid=_t(valid, torch.bool, dev),
        job_class=_t(job_class_np, torch.int32, dev),
        class_masks=_t(class_rows_np, torch.bool, dev),
        job_class_np=job_class_np, class_rows_np=class_rows_np)


def timed_cluster_state(time_avail, total, alive, cost,
                        device=None) -> TimedClusterState:
    """TimedClusterState from the JAX one's fields (cost as the int32
    ledger, or a float seed that is rounded into it)."""
    dev = resolve_device(device)
    n = np.shape(time_avail)[0]
    return TimedClusterState(
        time_avail=_t(time_avail, torch.int32, dev),
        total=_t(total, torch.int32, dev),
        alive=_t(alive, torch.bool, dev),
        cost=normalize_cost_ledger(np.asarray(cost), n, dev))


def timed_job_batch(req, node_num, time_limit, part_mask, valid,
                    device=None) -> TimedJobBatch:
    dev = resolve_device(device)
    return TimedJobBatch(req=_t(req, torch.int32, dev),
                         node_num=_t(node_num, torch.int32, dev),
                         time_limit=_t(time_limit, torch.int32, dev),
                         part_mask=_t(part_mask, torch.bool, dev),
                         valid=_t(valid, torch.bool, dev))


def time_grid(edges, resolution: float) -> TimeGrid:
    """The port's TimeGrid with the JAX grid's edges."""
    return TimeGrid.from_edges(edges, resolution)


def pending_priority_attrs(age, qos_prio, part_prio, node_num, cpus, mem,
                           account, valid,
                           device=None) -> PendingPriorityAttrs:
    dev = resolve_device(device)
    return PendingPriorityAttrs(
        age=_t(age, torch.int32, dev),
        qos_prio=_t(qos_prio, torch.int32, dev),
        part_prio=_t(part_prio, torch.int32, dev),
        node_num=_t(node_num, torch.int32, dev),
        cpus=_t(cpus, torch.float32, dev),
        mem=_t(mem, torch.float32, dev),
        account=_t(account, torch.int32, dev),
        valid=_t(valid, torch.bool, dev))


def running_priority_attrs(qos_prio, part_prio, node_num, cpus, mem,
                           account, run_time, valid,
                           device=None) -> RunningPriorityAttrs:
    dev = resolve_device(device)
    return RunningPriorityAttrs(
        qos_prio=_t(qos_prio, torch.int32, dev),
        part_prio=_t(part_prio, torch.int32, dev),
        node_num=_t(node_num, torch.int32, dev),
        cpus=_t(cpus, torch.float32, dev),
        mem=_t(mem, torch.float32, dev),
        account=_t(account, torch.int32, dev),
        run_time=_t(run_time, torch.int32, dev),
        valid=_t(valid, torch.bool, dev))
