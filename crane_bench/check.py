"""How ``correct`` is decided: the program's answers held against the plain
reference (``crane_bench/reference``), once the window has closed.

Each number compared is a count of answers that differ, and each limit is 0:

* ``start_mismatch``: over the checked ticks (the cold cycle, the settle
  tick, ``SAMPLE_TICKS`` window ticks drawn from the seed and the window's
  last tick), the jobs that the program started and the reference did not,
  or the reverse, or on other nodes.  It covers the candidates and their
  order (a job started out of order takes another's nodes), the backfill
  head's starts and the tail's greedy placement.
* ``reserve_gap``: over the same ticks, the difference between the
  reservations the backfill head holds (the trace row's ``backfilled``) and
  the reference's.
* ``priority_mismatch``: pending jobs after the last tick whose priority is
  not the reference's to the bit.
* ``running_mismatch``: jobs running after the last tick in one and not the
  other, or on nodes the log does not give them.
* ``free_mismatch``: nodes whose free resources after the last commit differ.
* ``infeasible``: over every tick of the log, not only the checked ones,
  the starts that could not have been made (off their partition, on too few
  or too many distinct nodes, before their submit) and the nodes a commit
  left with free resources below 0.
* ``wal_gap``: acknowledged submits missing from the log, or recorded with
  another request or submit time (every submit of the window and
  ``SAMPLE_SUBMITS`` of set-up's, drawn from the seed, are compared field by
  field), and reported starts missing from it, at another time, or started
  twice.
"""

from __future__ import annotations

import time

import numpy as np

from crane_bench.reference import cycle as ref_cycle
from crane_bench.reference import state as ref_state
from crane_bench.reference import wal as ref_wal

SAMPLE_TICKS = 3
# set-up submits whose records are compared field by field (the window's
# all are; the rest of set-up's only for presence)
SAMPLE_SUBMITS = 2000
LIMITS = {"start_mismatch": 0, "reserve_gap": 0, "priority_mismatch": 0,
          "running_mismatch": 0, "free_mismatch": 0, "infeasible": 0,
          "wal_gap": 0}


def checked_ticks(ticks: list, seed: int) -> list[int]:
    """Indices of the ticks whose cycles the reference recomputes."""
    window = [i for i, t in enumerate(ticks) if t["phase"] == "window"]
    head = [i for i, t in enumerate(ticks) if t["phase"] in ("cold",
                                                             "settle")]
    if not window:
        return head
    rng = np.random.default_rng([int(seed), 2])
    pool = window[:-1]
    pick = sorted(rng.choice(pool, size=min(SAMPLE_TICKS, len(pool)),
                             replace=False).tolist()) if pool else []
    return head + pick + [window[-1]]


def detailed_submits(jobs: dict, ticks: list, seed: int) -> set:
    """Ids of the submits compared field by field: every one the window
    sent, and a sample of set-up's drawn from the seed."""
    window = [i for i, t in enumerate(ticks) if t["phase"] == "window"]
    ids = jobs["job_id"]
    first = window[0] if window else len(ticks)
    late = (jobs["submit_tick"] >= first) & (ids > 0)
    early = np.flatnonzero(~late & (ids > 0))
    rng = np.random.default_rng([int(seed), 3])
    pick = rng.choice(early, size=min(SAMPLE_SUBMITS, early.size),
                      replace=False)
    return set(ids[late].tolist()) | set(ids[pick].tolist())


def wal_gaps(log: dict, jobs: dict, ticks: list, detailed: set) -> int:
    """Acknowledged submits and reported starts that the log lacks or
    records otherwise."""
    gaps = 0
    sub = log["submit"]
    for i in np.flatnonzero(jobs["job_id"] > 0):
        jid = int(jobs["job_id"][i])
        if jid not in sub:
            gaps += 1
            continue
        if jid not in detailed:
            continue
        want = (float(jobs["submit_now"][i]), float(jobs["cpu"][i]),
                int(jobs["mem_gib"][i]) << 30, int(jobs["nodes"][i]),
                int(jobs["time_limit"][i]), f"p{int(jobs['part'][i])}",
                float(jobs["runtime"][i]))
        gaps += sub[jid] is None or tuple(sub[jid]) != want
    reported = {}
    for t in ticks:
        for jid in t["started"]:
            gaps += jid in reported
            reported[jid] = t["now"]
    starts = log["start"]
    for jid, now in reported.items():
        rec = starts.get(jid)
        gaps += rec is None or float(rec[0]) != float(now)
    gaps += sum(1 for jid in starts if jid not in reported)
    return gaps + log["torn"]


def _start_diff(program: dict, reference: dict) -> int:
    diff = 0
    for jid in set(program) | set(reference):
        a, b = program.get(jid), reference.get(jid)
        diff += a is None or b is None or tuple(sorted(a)) != tuple(b)
    return diff


def compare(cfg: dict, cluster, jobs: dict, ticks: list, final: dict,
            wal_path: str, seed: int, low: bool = False) -> dict:
    """The compared numbers of one run.  ``final`` holds what the program
    shows after the last tick: ``running`` (id -> node ids), ``free``
    (int[N, 3]) and ``priority`` (pending id -> float).  With ``low`` the
    checked ticks' starts, reservations and priorities are the reference's
    own in bfloat16 (the control) instead of the program's."""
    t0 = time.perf_counter()
    detailed = detailed_submits(jobs, ticks, seed)
    log = ref_wal.read(wal_path, detailed.__contains__)
    t_wal = time.perf_counter() - t0
    tl = ref_state.Timeline(cluster, jobs, log["start"],
                            [t["now"] for t in ticks])
    sched, weights = cfg["scheduler"], cfg["priority_weights"]
    out = dict.fromkeys(LIMITS, 0)
    out["wal_gap"] = wal_gaps(log, jobs, ticks, detailed)
    picks = checked_ticks(ticks, seed)
    last = len(ticks) - 1
    tick_s = []
    for i in picks:
        t_tick = time.perf_counter()
        st = tl.at_tick(i)
        want = ref_cycle.run_cycle(st, sched, weights)
        if low:
            got = ref_cycle.run_cycle(st, sched, weights, low=True)
            starts, reserved = got["starts"], got["reserved"]
            pri = dict(zip(got["candidates"].tolist(),
                           got["priority"].tolist()))
        else:
            starts = {jid: log["start"].get(jid, (None, ()))[1]
                      for jid in ticks[i]["started"]}
            row = ticks[i].get("row") or {}
            reserved = int(row.get("backfilled", 0))
            pri = final["priority"]
        out["start_mismatch"] += _start_diff(starts, want["starts"])
        out["reserve_gap"] += abs(reserved - want["reserved"])
        if i == last:
            ids = want["candidates"].tolist()
            ref_pri = dict(zip(ids, want["priority"].tolist()))
            pending = [jid for jid in ids if jid not in want["starts"]]
            out["priority_mismatch"] = sum(
                1 for jid in pending
                if jid not in pri
                or np.float32(pri[jid]) != np.float32(ref_pri[jid]))
        tick_s.append(round(time.perf_counter() - t_tick, 2))
    if low:
        # the control replaces the checked ticks' answers only
        for key in ("running_mismatch", "free_mismatch", "infeasible",
                    "wal_gap"):
            out[key] = None
    else:
        out["infeasible"] = tl.infeasible()
        alive = tl.running_after(last)
        ref_running = set(tl.ids[alive].tolist())
        prog = final["running"]
        out["running_mismatch"] = len(ref_running ^ set(prog)) + sum(
            1 for jid, nodes in prog.items()
            if tuple(nodes) != tuple(log["start"].get(jid, (None, ()))[1]))
        out["free_mismatch"] = int(
            (np.asarray(final["free"]) != tl.free_after(last)).any(
                axis=1).sum())
    out["_ticks_checked"] = picks
    out["_seconds"] = {"wal_read": t_wal, "ticks": tick_s,
                       "total": time.perf_counter() - t0}
    out["_wal_records"] = log["counts"]
    return out


def verdict(numbers: dict) -> tuple[bool, dict]:
    """``correct`` and the compared numbers beside their limits.  A number
    that is None was not compared (the control replaces only the checked
    ticks' answers) and is left out."""
    checks = {k: {"value": int(numbers[k]), "limit": LIMITS[k]}
              for k in LIMITS if numbers[k] is not None}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
