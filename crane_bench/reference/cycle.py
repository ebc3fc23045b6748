"""One scheduling cycle in plain NumPy: priority, order, placement.

What it transcribes, and where the port keeps the same rule:

* Candidates are the pending jobs in job-id order, cut to
  ``schedule_batch_size`` before the sort (``ctld/scheduler.py``
  ``_cycle_body``).
* Priority is MultiFactorPriority in float32 (``models/priority.py``): the
  age, partition, job-size, fair-share and QoS factors, each normalized over
  its bounds, a degenerate bound giving 0; jobs sort by descending priority,
  ties to the lowest candidate index.
* The immediate fit is the greedy solve (``models/solver.py``): for each job
  in order, the ``node_num`` cheapest nodes of its partition on which the
  request fits now, by an int32 ledger in 1/16 cpu-seconds, ties to the lowest
  node index; each pick adds ``round(f32(limit) * f32(cpu) * 16 / f32(node
  cpu))`` to the node's cost.  The cost seed is the same expression over every
  running job's remaining time (``ctld/runledger.py``).
* The backfill head (``models/solver_time.py``): the first
  ``backfill_max_jobs`` of the order on a grid of ``time_buckets`` buckets of
  ``time_resolution`` seconds; each job takes the earliest bucket at which
  enough nodes fit it for its whole window and holds it (a start now, or a
  reservation later).  The tail is the greedy solve against the minimum over
  the horizon of the head's time map, with the head's ledger.

Partitions are disjoint, so each is solved on its own, its jobs in the
global order.  A job class (request, node count, and on the time axis the
limit) that found no room stays without room for the rest of the pass, since
a pass only takes resources away; so such jobs are skipped without a scan.

``low=True`` computes the cost increments and the priority in bfloat16, the
precision below the float32 the program states: the control that the check
must refuse.
"""

from __future__ import annotations

import numpy as np

f32 = np.float32
COST_SCALE = 16
CPU_SCALE = 256
FLOAT_MAX = 3.4e38
THIRD = float(np.float32(1.0 / 3.0))


def to_bf16(x) -> np.ndarray:
    """float32 values rounded to bfloat16 (to nearest, ties to even)."""
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    bits = a.view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).reshape(a.shape)


class Arith:
    """float32 arithmetic, or with ``low`` bfloat16 after every step."""

    def __init__(self, low: bool = False):
        self.low = low

    def q(self, x):
        return to_bf16(x) if self.low else np.asarray(x, np.float32)

    def dcost(self, time_limit, req_cpu, cpu_total) -> np.ndarray:
        """int64 ledger increment for the picked nodes (``cpu_total`` the
        nodes' cpu units as float32)."""
        v = self.q(f32(time_limit) * f32(req_cpu))
        v = self.q(v * f32(COST_SCALE))
        v = self.q(v / cpu_total)
        return np.round(v).astype(np.int64)


def _fma32(x, y: float, z) -> np.ndarray:
    """float32 ``x * y + z`` rounded once (round to odd in float64, then
    the cast)."""
    p = np.asarray(x, np.float32).astype(np.float64) * float(np.float32(y))
    zz = np.broadcast_to(np.asarray(z, np.float32).astype(np.float64),
                         p.shape)
    s = p + zz
    t = s - p
    err = (p - (s - t)) + (zz - t)
    bits = s.view(np.int64)
    inexact = (err != 0) & np.isfinite(s) & ((bits & 1) == 0)
    step = np.where((err > 0) == (s > 0), 1, -1)
    return np.where(inexact, bits + step, bits).view(np.float64).astype(
        np.float32)


def _bounds(x, y=None):
    """(min, max) over x (and y), FLOAT_MAX / -FLOAT_MAX when empty."""
    lo, hi = f32(FLOAT_MAX), f32(-FLOAT_MAX)
    for a in (x, y):
        if a is not None and a.size:
            lo, hi = min(lo, a.min()), max(hi, a.max())
    return f32(lo), f32(hi)


def _norm(ar: Arith, v, lo, hi, degenerate: float):
    if hi > lo:
        return ar.q((v - lo) / max(f32(hi - lo), f32(1e-30)))
    return np.full(v.shape, degenerate, np.float32)


def priority(ar: Arith, weights: dict, now: float, pend: dict,
             run: dict) -> np.ndarray:
    """float32 priorities of the candidates.

    ``pend``: submit (s), qos, part_prio, node_num, cpus (cores x nodes),
    mem (MiB x nodes), account, each an array over the candidates; ``run``
    the same without submit, plus start (s), over the running jobs."""
    age = np.maximum(now - pend["submit"], 0.0).astype(np.int32)
    age = np.maximum(np.minimum(age, int(weights["max_age"])), 0).astype(
        np.float32)
    cols = {}
    for key in ("qos", "part_prio", "node_num", "cpus", "mem"):
        cols[key] = (np.maximum(np.asarray(pend[key], np.float32), 0),
                     np.maximum(np.asarray(run[key], np.float32), 0))
    age_lo, age_hi = _bounds(age)
    b = {key: _bounds(*cols[key]) for key in cols}

    r_cpus, r_nodes, r_mem = (cols[k][1] for k in ("cpus", "node_num",
                                                   "mem"))
    service = ar.q(ar.q(_norm(ar, r_cpus, *b["cpus"], 1.0)
                        + _norm(ar, r_nodes, *b["node_num"], 1.0))
                   + _norm(ar, r_mem, *b["mem"], 1.0))
    run_time = np.maximum(now - run["start"], 0.0).astype(np.int32)
    service = ar.q(service * run_time.astype(np.float32))
    n_acct = int(max(np.max(pend["account"], initial=-1),
                     np.max(run["account"], initial=-1))) + 1
    acc = np.zeros(n_acct, np.float32)
    np.add.at(acc, np.asarray(run["account"], np.int64), service)
    present = np.zeros(n_acct, bool)
    present[np.asarray(pend["account"], np.int64)] = True
    present[np.asarray(run["account"], np.int64)] = True
    sv_lo, sv_hi = _bounds(acc[present])

    p = {k: cols[k][0] for k in cols}
    age_f = _norm(ar, age, age_lo, age_hi, 0.0)
    qos_f = _norm(ar, p["qos"], *b["qos"], 0.0)
    part_f = _norm(ar, p["part_prio"], *b["part_prio"], 0.0)
    size_f = ar.q(ar.q(_norm(ar, p["cpus"], *b["cpus"], 0.0)
                       + _norm(ar, p["node_num"], *b["node_num"], 0.0))
                  + _norm(ar, p["mem"], *b["mem"], 0.0))
    job_service = acc[np.asarray(pend["account"], np.int64)]
    if sv_hi > sv_lo:
        fshare_f = ar.q(f32(1.0) - ar.q((job_service - sv_lo)
                                        / max(f32(sv_hi - sv_lo),
                                              f32(1e-30))))
    else:
        fshare_f = np.zeros(age.shape, np.float32)

    head = ar.q(ar.q(f32(weights["age"]) * age_f)
                + ar.q(f32(weights["partition"]) * part_f))
    if weights["favor_small"]:
        mean = ar.q(_fma32(size_f, -THIRD, 1.0))
        head = ar.q(_fma32(mean, weights["job_size"], head))
    else:
        head = ar.q(_fma32(size_f, float(f32(THIRD)
                                         * f32(weights["job_size"])), head))
    out = ar.q(head + ar.q(f32(weights["fair_share"]) * fshare_f))
    return ar.q(out + ar.q(f32(weights["qos"]) * qos_f))


def _cheapest(cost, idx, k):
    """The k cheapest of the candidate rows ``idx`` (ascending), ties to the
    lowest row."""
    c = cost[idx]
    if k == 1:
        return idx[np.argmin(c)][None]
    return idx[np.argsort(c, kind="stable")[:k]]


class Partition:
    """One partition's share of the cycle: its nodes (ascending ids) and
    local copies of their free resources and ledger."""

    def __init__(self, nodes, avail, cost, cpu_total):
        self.nodes = nodes
        self.avail = avail[nodes].copy()
        self.cost = cost[nodes].copy()
        self.cpu_total = cpu_total[nodes]


def greedy(ar: Arith, part: Partition, avail, jobs, max_nodes: int,
           starts: dict) -> None:
    """The immediate fit of ``jobs`` (dicts of arrays, in order) against
    ``avail`` (the partition's [Np, R] free resources, updated in place) and
    ``part.cost``; started jobs go into ``starts`` as id -> node ids."""
    failed = set()
    for jid, req, k, tl in zip(jobs["job_id"], jobs["req"], jobs["node_num"],
                               jobs["time_limit"]):
        k = int(k)
        key = (req.tobytes(), k)
        if k > max_nodes or key in failed:
            continue
        fit = (avail >= req).all(axis=1)
        idx = np.flatnonzero(fit)
        if idx.size < k:
            failed.add(key)
            continue
        sel = _cheapest(part.cost, idx, k)
        avail[sel] -= req
        part.cost[sel] += ar.dcost(tl, req[0], part.cpu_total[sel])
        starts[int(jid)] = tuple(sorted(int(n) for n in part.nodes[sel]))


def backfill_head(ar: Arith, part: Partition, ta, edges, jobs,
                  max_nodes: int, starts: dict) -> int:
    """The time-axis solve of ``jobs`` over ``ta`` ([R, Np, T], one plane a
    resource dimension, updated in place): a job that fits now starts, one
    that fits later holds a reservation.  Returns the number of
    reservations.

    A node whose most free resources over the horizon (``top``, kept as
    nodes are taken) cannot hold the request is left out of the scan: it
    fits in no bucket."""
    R, n, T = ta.shape
    first = np.arange(T)
    top = ta.max(axis=2).T.copy()              # [Np, R]
    failed = np.zeros((0, R + 2), np.int64)   # (req..., node_num, limit)
    reserved = 0
    for jid, req, k, tl in zip(jobs["job_id"], jobs["req"], jobs["node_num"],
                               jobs["time_limit"]):
        k = int(k)
        if k > max_nodes:
            continue
        row = np.concatenate([req, [k, tl]])
        if (failed <= row).all(axis=1).any():
            continue
        rows = np.flatnonzero((top >= req).all(axis=1))
        can = None
        if rows.size >= k:
            ends = np.minimum(np.searchsorted(
                edges, edges[:T] + max(int(tl), 1), side="left"), T)
            whole = rows.size == n
            fits = None
            for d in range(R):
                if req[d] <= 0:
                    continue   # a plane never below 0 holds a zero request
                plane = ta[d] if whole else ta[d][rows]
                f = plane >= req[d]
                fits = f if fits is None else fits & f
            if fits is None:
                fits = np.ones((rows.size, T), bool)
            csum = np.zeros((rows.size, T + 1), np.int32)
            np.cumsum(fits, axis=1, out=csum[:, 1:])
            ok = (csum[:, ends] - csum[:, first]) == (ends - first)[None, :]
            can = ok.sum(axis=0) >= k
        if can is None or not can.any():
            failed = np.vstack([failed, row[None, :]])
            continue
        s = int(np.argmax(can))
        sel = rows[_cheapest(part.cost[rows], np.flatnonzero(ok[:, s]), k)]
        for d in range(R):
            ta[d][sel, s:ends[s]] -= req[d]
            top[sel, d] = ta[d][sel].max(axis=1)
        part.cost[sel] += ar.dcost(tl, req[0], part.cpu_total[sel])
        if s == 0:
            starts[int(jid)] = tuple(sorted(int(n) for n in part.nodes[sel]))
        else:
            reserved += 1
    return reserved


def time_map(part: Partition, node_index, rows: dict, now: float, edges,
             T: int) -> np.ndarray:
    """[R, Np, T] free resources per bucket (int32, a plane a dimension):
    the free resources now plus each running allocation released from the
    first bucket edge at or past its remaining time (never bucket 0)."""
    local = node_index[rows["node"]]
    mine = local >= 0
    rem = np.maximum(rows["end"][mine] - now, 0.0)
    eb = np.minimum(np.maximum(np.searchsorted(edges, rem, side="left"), 1),
                    T)
    keep = eb < T
    rel = np.zeros((len(part.nodes), T, part.avail.shape[1]), np.int64)
    np.add.at(rel, (local[mine][keep], eb[keep]), rows["alloc"][mine][keep])
    ta = part.avail[:, None, :] + np.cumsum(rel, axis=1)
    return np.ascontiguousarray(ta.transpose(2, 0, 1)).astype(np.int32)


def cost_seed(ar: Arith, rows: dict, now: float, num_nodes: int,
              cpu_cores) -> np.ndarray:
    """int64[N] ledger seed: each running allocation's remaining seconds x
    cpus x 16 / node cores, in float32, rounded, summed per node."""
    rem = np.maximum(rows["end"] - now, 0.0).astype(np.float32)
    cpus = (rows["alloc"][:, 0] / CPU_SCALE).astype(np.float32)
    total = np.maximum(cpu_cores[rows["node"]], 1e-9).astype(np.float32)
    d = ar.q(ar.q(ar.q(rem * cpus) * f32(COST_SCALE)) / total)
    d = np.round(d).astype(np.int64)
    out = np.zeros(num_nodes, np.int64)
    np.add.at(out, rows["node"], d)
    return out


def run_cycle(state: dict, sched: dict, weights: dict, low: bool = False
              ) -> dict:
    """One cycle from ``state`` (see ``reference.state.at_tick``) under the
    configuration's ``scheduler`` settings.  Returns the candidates' ids (in
    id order, cut to the batch size) and in priority order, their priorities
    (in candidate order), the started jobs (id -> sorted node ids) and the
    number of reservations."""
    ar = Arith(low)
    cand = state["cand"]
    limit = int(sched.get("schedule_batch_size", 100_000))
    cand = {k: v[:limit] for k, v in cand.items()}
    pri = priority(ar, weights, state["now"], cand, state["run"])
    order = np.argsort(-pri, kind="stable")
    ordered = {k: v[order] for k, v in cand.items()}
    max_nodes = max(1, min(int(ordered["node_num"].max(initial=1)),
                           int(sched.get("max_nodes_per_job", 8))))
    backfill = bool(sched.get("backfill", True))
    bf_max = max(1, int(sched.get("backfill_max_jobs", 1024)))
    T = int(sched.get("time_buckets", 64))
    edges = np.round(np.arange(T + 1) * float(
        sched.get("time_resolution", 60.0))).astype(np.int64)
    num_nodes = state["avail"].shape[0]
    cost0 = cost_seed(ar, state["rows"], state["now"], num_nodes,
                      state["cpu_cores"])
    cpu_units = np.maximum(state["totals"][:, 0], 1).astype(np.float32)

    starts: dict = {}
    reserved = 0
    for p, nodes in enumerate(state["part_nodes"]):
        part = Partition(nodes, state["avail"], cost0, cpu_units)
        mine = ordered["part"] == p
        if not backfill:
            greedy(ar, part, part.avail, {k: v[mine] for k, v in
                                          ordered.items()},
                   max_nodes, starts)
            continue
        index = np.full(num_nodes, -1, np.int64)
        index[nodes] = np.arange(len(nodes))
        ta = time_map(part, index, state["rows"], state["now"], edges, T)
        pos = np.arange(len(order))
        head = mine & (pos < bf_max)
        reserved += backfill_head(ar, part, ta, edges,
                                  {k: v[head] for k, v in ordered.items()},
                                  max_nodes, starts)
        tail = mine & (pos >= bf_max)
        if tail.any():
            greedy(ar, part, ta.min(axis=2).T.astype(np.int64),
                   {k: v[tail] for k, v in ordered.items()}, max_nodes,
                   starts)
    return {"candidates": cand["job_id"], "order": ordered["job_id"],
            "priority": pri, "starts": starts, "reserved": reserved}
