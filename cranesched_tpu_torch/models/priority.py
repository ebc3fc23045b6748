"""Vectorized multi-factor job priority (port of
``cranesched_tpu/models/priority.py``).

    priority = W_age * age_f + W_partition * part_f + W_jobsize * size_f
             + W_fairshare * fshare_f + W_qos * qos_f

per pending job, as masked tensor reductions in float32:

* factor bounds        = masked min/max over the pending/running SoA,
* per-account service  = a sum over running jobs into a dense account
                         axis, accumulated sequentially in job order,
* the factors          = elementwise normalizations.

Semantics (pinned to the JAX package, which pins them to the reference):
age is clipped to ``max_age`` before its bounds; age bounds come from
pending jobs only, the other bounds from pending AND running jobs; a
running job's service value is the sum of three normalized size terms,
each 1.0 on a degenerate bound, times its run time; a factor with a
degenerate bound is 0; jobs sort by descending priority with ties to the
lowest job index.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

FLOAT_MAX = 3.4e38
_THIRD = float(np.float32(1.0 / 3.0))


@dataclasses.dataclass(frozen=True)
class PriorityWeights:
    """Static priority configuration (defaults mirror the JAX package)."""

    age: float = 500.0
    partition: float = 1000.0
    job_size: float = 0.0
    fair_share: float = 10000.0
    qos: float = 1000000.0
    favor_small: bool = True
    max_age: int = 14 * 24 * 3600


@dataclasses.dataclass
class PendingPriorityAttrs:
    """Per-pending-job attributes (SoA, padded).

    age: int32[J] seconds since submit; qos_prio, part_prio, node_num:
    int32[J]; cpus, mem: f32[J]; account: int32[J] dense account index;
    valid: bool[J]."""

    age: torch.Tensor
    qos_prio: torch.Tensor
    part_prio: torch.Tensor
    node_num: torch.Tensor
    cpus: torch.Tensor
    mem: torch.Tensor
    account: torch.Tensor
    valid: torch.Tensor


@dataclasses.dataclass
class RunningPriorityAttrs:
    """Per-running-job attributes (same fields as pending, plus
    run_time int32[R])."""

    qos_prio: torch.Tensor
    part_prio: torch.Tensor
    node_num: torch.Tensor
    cpus: torch.Tensor
    mem: torch.Tensor
    account: torch.Tensor
    run_time: torch.Tensor
    valid: torch.Tensor


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _masked_min(x, mask):
    # FLOAT_MAX when nothing is selected (e.g. an empty running batch)
    return torch.where(mask, x, _f32(FLOAT_MAX, x)).amin(
        dim=0, keepdim=False) if x.numel() else _f32(FLOAT_MAX, x)


def _masked_max(x, mask):
    return torch.where(mask, x, _f32(-FLOAT_MAX, x)).amax(
        dim=0, keepdim=False) if x.numel() else _f32(-FLOAT_MAX, x)


def _norm(value, lo, hi):
    """(value - lo) / (hi - lo), or 0 when the bound is degenerate."""
    return torch.where(hi > lo, (value - lo)
                       / torch.clamp(hi - lo, min=1e-30), 0.0)


def _norm_or_one(value, lo, hi):
    """Like _norm but 1.0 on a degenerate bound (service-value terms)."""
    return torch.where(hi > lo, (value - lo)
                       / torch.clamp(hi - lo, min=1e-30), 1.0)


def _segment_sum_in_order(values: torch.Tensor, segments: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
    """float32 per-segment sums, each accumulated sequentially in element
    order.  The order is part of the result in float32; ``index_add_`` on
    CUDA sums with atomics in an order that changes from run to run, so
    the fold runs on the host (``np.add.at`` is unbuffered and in order,
    the same fold the JAX package's scatter-add performs)."""
    out = np.zeros(num_segments, np.float32)
    np.add.at(out, segments.cpu().numpy(), values.cpu().numpy())
    return torch.from_numpy(out).to(values.device)


def multifactor_priority(pending: PendingPriorityAttrs,
                         running: RunningPriorityAttrs,
                         weights: PriorityWeights, num_accounts: int,
                         extra_service: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """f32[J] priorities for the pending batch; invalid (padding) rows
    get -inf so a descending sort pushes them last.

    ``extra_service`` (f32[num_accounts], optional) adds out-of-band
    service units into the per-account service sum before the
    fair-share normalization; an account with positive extra service is
    present even with no local running job."""
    p_ok = pending.valid
    r_ok = running.valid

    def _u(x):
        return torch.clamp(x, min=0).to(torch.float32)

    age = _u(torch.clamp(pending.age, max=weights.max_age))
    p_qos = _u(pending.qos_prio)
    p_part = _u(pending.part_prio)
    p_nodes = _u(pending.node_num)
    p_cpus = _u(pending.cpus)
    p_mem = _u(pending.mem)
    r_qos = _u(running.qos_prio)
    r_part = _u(running.part_prio)
    r_nodes = _u(running.node_num)
    r_cpus = _u(running.cpus)
    r_mem = _u(running.mem)

    def both(p, r, fn, pick):
        return pick(fn(p, p_ok), fn(r, r_ok))

    age_min, age_max = _masked_min(age, p_ok), _masked_max(age, p_ok)
    qos_min = both(p_qos, r_qos, _masked_min, torch.minimum)
    qos_max = both(p_qos, r_qos, _masked_max, torch.maximum)
    part_min = both(p_part, r_part, _masked_min, torch.minimum)
    part_max = both(p_part, r_part, _masked_max, torch.maximum)
    nodes_min = both(p_nodes, r_nodes, _masked_min, torch.minimum)
    nodes_max = both(p_nodes, r_nodes, _masked_max, torch.maximum)
    cpus_min = both(p_cpus, r_cpus, _masked_min, torch.minimum)
    cpus_max = both(p_cpus, r_cpus, _masked_max, torch.maximum)
    mem_min = both(p_mem, r_mem, _masked_min, torch.minimum)
    mem_max = both(p_mem, r_mem, _masked_max, torch.maximum)

    # per-account service value from running jobs
    service_val = (_norm_or_one(r_cpus, cpus_min, cpus_max)
                   + _norm_or_one(r_nodes, nodes_min, nodes_max)
                   + _norm_or_one(r_mem, mem_min, mem_max))
    service_val = torch.where(
        r_ok, service_val * running.run_time.to(torch.float32), 0.0)
    acc_service = _segment_sum_in_order(
        service_val,
        torch.where(r_ok, running.account.to(torch.int64), num_accounts),
        num_accounts + 1)[:num_accounts]
    if extra_service is not None:
        acc_service = acc_service + torch.clamp(
            extra_service.to(torch.float32), min=0.0)

    # accounts present = pending accounts ∪ running accounts
    dev = p_ok.device
    acc_present = torch.zeros(num_accounts + 1, dtype=torch.bool,
                              device=dev)
    acc_present[torch.where(p_ok, pending.account.to(torch.int64),
                            num_accounts)] = True
    acc_present[torch.where(r_ok, running.account.to(torch.int64),
                            num_accounts)] = True
    acc_present = acc_present[:num_accounts]
    if extra_service is not None:
        acc_present = acc_present | (extra_service > 0)
    sv_min = _masked_min(acc_service, acc_present)
    sv_max = _masked_max(acc_service, acc_present)

    # per-pending-job factors
    age_f = _norm(age, age_min, age_max)
    qos_f = _norm(p_qos, qos_min, qos_max)
    part_f = _norm(p_part, part_min, part_max)
    size_f = (_norm(p_cpus, cpus_min, cpus_max)
              + _norm(p_nodes, nodes_min, nodes_max)
              + _norm(p_mem, mem_min, mem_max))
    # the mean of the three terms is a multiply by the float32 reciprocal
    # of 3: that is the reference's arithmetic as compiled (XLA rewrites
    # a division by a constant into a multiply by its reciprocal), and
    # it rounds differently from a true division
    if weights.favor_small:
        size_f = 1.0 - size_f * _THIRD
    else:
        size_f = size_f * _THIRD
    job_service = acc_service[pending.account.to(torch.int64)]
    fshare_f = torch.where(sv_max > sv_min,
                           1.0 - (job_service - sv_min)
                           / torch.clamp(sv_max - sv_min, min=1e-30), 0.0)

    priority = (weights.age * age_f + weights.partition * part_f
                + weights.job_size * size_f + weights.fair_share * fshare_f
                + weights.qos * qos_f)
    return torch.where(p_ok, priority, float("-inf"))


def priority_order(priority: torch.Tensor) -> torch.Tensor:
    """Descending-priority permutation, ties to the lowest job index."""
    return torch.argsort(-priority, stable=True)
