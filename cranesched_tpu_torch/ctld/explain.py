"""Pending-reason explainability: decompose WHY a job is not running
(the port's copy of ``cranesched_tpu/ctld/explain.py``).

``pending_reason`` tells an operator the last reason the cycle stamped
on a job; this module recomputes the FIRST FAILING GATE from current
state, in the exact order the scheduling cycle applies them, and names
the binding constraint — down to the resource dimension a job is
queued on or the topology block fragmentation splitting its gang.

Gate order (mirrors the cycle: PendingTable gates, then the
eligibility mask ``_mask_for`` builds from the factored class rows,
then the per-node fit the solver evaluates, then placement):

    held -> begin_time -> dependency -> license -> qos_limit
    -> eligibility (partition/include/exclude/reservation)
    -> alive -> capacity (total, never-satisfiable)
    -> resources (avail, per-dimension shortfall)
    -> topology (block fragmentation for gangs)
    -> priority (feasible now; lost the race)

The result is a JSON-friendly dict: every gate with its pass/fail and
detail (the ``checks`` list), plus the first failure's ``gate``,
``reason`` (a PendingReason value, matching what the cycle would
stamp) and human ``detail``.  Surfaced as ``cexplain <job>`` and the
``explain_json`` field of QueryJobSummary.  Read-only: the one trial
mutation (QoS run-limit malloc) is rolled back immediately under the
same lock.  Callers hold the server lock.
"""

from __future__ import annotations

import numpy as np

from cranesched_tpu_torch.ctld.defs import PendingReason
from cranesched_tpu_torch.ops.resources import (
    CPU_SCALE,
    DIM_CPU,
    NUM_BASE_DIMS,
    gres_key_str,
)

_BASE_DIM_NAMES = ("cpu", "mem", "memsw")


def dim_names(layout) -> list:
    """Human names for every resource dimension in layout order."""
    return list(_BASE_DIM_NAMES) + [gres_key_str(p)
                                    for p in layout.gres_pairs]


def _fmt_dim(d: int, amount: int, names: list) -> str:
    if d == DIM_CPU:
        return "%g cpu" % (amount / CPU_SCALE)
    if d < NUM_BASE_DIMS:
        return "%d MiB %s" % (amount, names[d])
    return "%d %s" % (amount, names[d])


def explain_pending(sched, job_id: int, now: float) -> dict:
    """First-failing-gate decomposition for one job.  ``sched`` is the
    JobScheduler; the caller holds the server lock."""
    out = {"job_id": int(job_id), "time": float(now), "state": "",
           "reason": "", "gate": "", "detail": "", "checks": []}
    checks = out["checks"]

    def gate(name: str, ok: bool, detail: str = "") -> bool:
        checks.append({"gate": name, "ok": bool(ok), "detail": detail})
        if not ok and not out["gate"]:
            out["gate"] = name
            out["detail"] = detail
        return ok

    def finish(reason) -> dict:
        out["reason"] = (reason.value if isinstance(reason, PendingReason)
                         else str(reason))
        return out

    job = sched.pending.get(job_id)
    if job is None:
        other = sched.running.get(job_id) or sched.history.get(job_id)
        if other is None:
            out["detail"] = "no such job"
            out["gate"] = "exists"
            return out
        out["state"] = other.status.name
        out["detail"] = "job is %s, not pending" % other.status.name
        return out
    out["state"] = job.status.name
    pr = job.pending_reason
    out["pending_reason"] = (pr.value if isinstance(pr, PendingReason)
                             else str(pr or ""))
    spec = job.spec

    if spec.array is not None:
        out["gate"] = "array_template"
        out["detail"] = ("array template: children run in its place "
                         "(%d tasks left)" % len(job.array_remaining))
        return out

    # -- PendingTable gates, in table order --
    if not gate("held", not job.held,
                "job is held (operator release required)"
                if job.held else ""):
        return finish(PendingReason.HELD)

    future = spec.begin_time is not None and spec.begin_time > now
    if not gate("begin_time", not future,
                "begin time %.0fs away" % ((spec.begin_time or 0.0) - now)
                if future else ""):
        return finish(PendingReason.BEGIN_TIME)

    dep = sched._deps_runnable(job, now)
    unmet = [str(d) for d, v in (job.dep_state or {}).items()
             if v is None or v > now]
    if not gate("dependency", dep is None,
                "waiting on job(s) %s" % ", ".join(unmet)
                if dep is not None else ""):
        return finish(dep)

    short = []
    for name, need in (spec.licenses or {}).items():
        lic = sched.licenses.licenses.get(name)
        if lic is not None and lic.free < need:
            short.append("%s: need %d, free %d" % (name, need, lic.free))
    if not gate("license", not short, "; ".join(short)):
        return finish(PendingReason.LICENSE)

    # -- QoS run limits (trial malloc, rolled back immediately) --
    qos_err = ""
    if (sched.accounts is not None and sched.account_meta is not None
            and job.qos_name and not job.run_usage_taken):
        qos = sched.accounts.qos.get(job.qos_name)
        if qos is not None:
            qos_err = sched.account_meta.check_and_malloc_run(
                spec.user, spec.account, qos, spec) or ""
            if not qos_err:
                sched.account_meta.free_run(spec.user, spec.account,
                                            job.qos_name, spec)
    if not gate("qos_limit", not qos_err, qos_err):
        return finish(PendingReason.QOS_LIMIT)

    # -- eligibility mask (what the factored [C, N] class row encodes) --
    mask = np.asarray(sched._mask_for(job, now), bool)
    if not int(mask.sum()):
        if spec.partition not in sched.meta.partitions:
            d = "unknown partition %r" % spec.partition
        else:
            pm = sched.meta.partition_mask(
                spec.partition, spec.include_nodes, spec.exclude_nodes)
            if not int(pm.sum()):
                d = ("partition/include/exclude constraints rule out "
                     "every node")
            elif spec.reservation:
                resv = sched.meta.reservations.get(spec.reservation)
                d = ("reservation %r %s" % (
                    spec.reservation,
                    "does not exist" if resv is None
                    else "is not active now or holds no nodes"))
            else:
                d = ("active reservations carve out every otherwise-"
                     "eligible node")
        gate("eligibility", False, d)
        return finish(PendingReason.CONSTRAINT)
    gate("eligibility", True, "%d eligible nodes" % int(mask.sum()))

    avail, total, alive = sched.meta.snapshot()
    eligible = mask & alive
    node_num = int(spec.node_num)
    if not gate("alive", int(eligible.sum()) >= max(node_num, 1),
                "only %d of %d eligible nodes are up/schedulable "
                "(gang needs %d)" % (int(eligible.sum()),
                                     int(mask.sum()), node_num)
                if int(eligible.sum()) < max(node_num, 1) else ""):
        return finish(PendingReason.CONSTRAINT)

    req = np.asarray(sched._job_row(job)[0], np.int64)
    names = dim_names(sched.meta.layout)
    dims = [d for d in range(req.shape[0]) if req[d] > 0]

    # capacity: could the job EVER fit on node_num eligible nodes?
    cap_ok = eligible & np.all(total >= req[None, :], axis=1)
    if int(cap_ok.sum()) < node_num:
        counts = sorted(
            (int((eligible & (total[:, d] >= req[d])).sum()), d)
            for d in dims)
        cnt, d = counts[0] if counts else (0, DIM_CPU)
        gate("capacity", False,
             "needs %s per node but only %d eligible nodes have that "
             "capacity at all (gang needs %d) — never satisfiable as "
             "the cluster stands" % (_fmt_dim(d, int(req[d]), names),
                                     cnt, node_num))
        return finish(PendingReason.CONSTRAINT)
    gate("capacity", True)

    # resources: does it fit RIGHT NOW, and which dimension binds?
    feasible = eligible & np.all(avail >= req[None, :], axis=1)
    n_fit = int(feasible.sum())
    if n_fit < node_num:
        counts = sorted(
            (int((eligible & (avail[:, d] >= req[d])).sum()), d)
            for d in dims)
        cnt, d = counts[0] if counts else (0, DIM_CPU)
        gate("resources", False,
             "waiting on %s: %d/%d needed nodes can fit now "
             "(binding dimension, %d nodes free on it)" % (
                 names[d], n_fit, node_num, cnt))
        return finish(PendingReason.RESOURCE)
    gate("resources", True, "%d nodes fit now (gang needs %d)"
         % (n_fit, node_num))

    # topology: a feasible gang may still be split across blocks
    topo = sched._active_topology()
    if topo is not None and node_num > 1:
        blocks = np.asarray(topo.block_of_node)
        inb = feasible & (blocks >= 0)
        per_block = np.bincount(blocks[inb],
                                minlength=topo.num_blocks)
        best = int(per_block.max(initial=0))
        if not gate("topology", best >= node_num,
                    "block fragmentation: largest block has %d feasible "
                    "nodes, gang needs %d (cross-block spanning fallback "
                    "may still place it)" % (best, node_num)
                    if best < node_num else ""):
            return finish(PendingReason.RESOURCE)

    out["gate"] = "priority"
    out["detail"] = ("feasible now: waiting on the priority order, the "
                     "schedule batch cut, or the next cycle")
    return finish(PendingReason.PRIORITY)
