"""The controller's state before a tick, worked out from the benchmark's own
inputs and the starts the program reported.

Inputs: the cluster draws, every submitted job (its request, the virtual time
and tick at which it was sent, its acknowledged id) and, for every started
job, its start time and nodes as the write-ahead log holds them.  From these
alone: a job runs from its start until ``start + runtime`` (or its time limit,
where the runtime is longer: the simulated node plane kills it there), ends are
delivered at the first tick at or past them, a job is pending from the tick
after its submit until the tick that starts it, and a node's free resources
are its total less every running allocation on it.

This follows the program tick by tick from its own placements (each tick's
starts come from the log); ``check.py`` checks the first tick, which starts
from the inputs alone, and the final running set and free resources, which
hold the bookkeeping this file redoes, by themselves.  ``infeasible`` holds
every start of the log, at every tick, to what a start has to be: on as many
distinct nodes as the job asks, each in its partition, no earlier than the
tick after its submit, and leaving no node's free resources below 0.
"""

from __future__ import annotations

import numpy as np

CPU_SCALE = 256
MIB = 1 << 20
GIB = 1 << 30


class Timeline:
    """Per-job arrays over every acknowledged job, ascending by id."""

    def __init__(self, cluster, jobs: dict, starts: dict, tick_nows):
        ok = jobs["job_id"] > 0
        order = np.argsort(jobs["job_id"][ok], kind="stable")
        j = {k: np.asarray(v)[ok][order] for k, v in jobs.items()}
        self.job = j
        self.ids = j["job_id"]
        n = len(self.ids)
        self.req = np.zeros((n, 3), np.int64)
        self.req[:, 0] = j["cpu"] * CPU_SCALE
        self.req[:, 1] = (j["mem_gib"] * GIB + MIB - 1) // MIB
        self.tick_nows = np.asarray(tick_nows, np.float64)
        tick_of = {float(t): i for i, t in enumerate(self.tick_nows)}
        big = np.iinfo(np.int64).max
        self.start_tick = np.full(n, big, np.int64)
        self.start_now = np.full(n, np.inf)
        pos = {int(jid): i for i, jid in enumerate(self.ids)}
        rows_job, rows_node = [], []
        for jid, (t, nodes) in starts.items():
            i = pos.get(int(jid))
            if i is None:
                continue
            self.start_tick[i] = tick_of.get(float(t), -1)
            self.start_now[i] = float(t)
            for node in nodes:
                rows_job.append(i)
                rows_node.append(int(node))
        rows_job = np.asarray(rows_job, np.int64)
        rows_node = np.asarray(rows_node, np.int64)
        # a node index the cluster does not have is only ever infeasible
        off = (rows_node < 0) | (rows_node >= cluster.num_nodes)
        self.off_cluster = np.unique(rows_job[off])
        self.rows_job, self.rows_node = rows_job[~off], rows_node[~off]
        tl = j["time_limit"].astype(np.float64)
        rt = j["runtime"].astype(np.float64)
        self.end_now = self.start_now + np.where(rt > tl, tl, rt)
        self.totals = cluster.totals()
        self.node_part = np.asarray(cluster.part, np.int64)
        self.cpu_cores = self.totals[:, 0] / float(CPU_SCALE)
        self.part_nodes = [np.flatnonzero(cluster.part == p)
                           for p in range(cluster.num_partitions)]

    def running_after(self, i: int) -> np.ndarray:
        """Mask of jobs running once tick ``i`` has committed."""
        now = self.tick_nows[i]
        return (self.start_tick <= i) & (self.end_now > now)

    def free_after(self, i: int) -> np.ndarray:
        """int64[N, 3] free resources once tick ``i`` has committed."""
        return self._free(self.running_after(i))

    def infeasible(self) -> int:
        """Starts in the log that could not have been made (off their
        partition, on a node that does not exist, on too few or too many
        distinct nodes, before their submit, at no tick), plus, over every
        tick, the nodes whose free resources its commit left below 0."""
        n, nodes = len(self.ids), len(self.totals)
        started = self.start_now < np.inf
        bad = started & ((self.start_tick < 0)
                         | (self.start_tick < self.job["submit_tick"]))
        bad[self.off_cluster] = True
        rj, rn = self.rows_job, self.rows_node
        bad[rj[self.node_part[rn] != self.job["part"][rj]]] = True
        count = np.bincount(rj, minlength=n)
        distinct = np.bincount(np.unique(rj * nodes + rn) // nodes,
                               minlength=n)
        bad |= started & ((count != self.job["nodes"]) | (distinct != count))
        over = sum(int((self.free_after(i) < 0).any(axis=1).sum())
                   for i in range(len(self.tick_nows)))
        return int(bad.sum()) + over

    def _free(self, running) -> np.ndarray:
        keep = running[self.rows_job]
        free = self.totals.copy()
        np.subtract.at(free, self.rows_node[keep],
                       self.req[self.rows_job[keep]])
        return free

    def at_tick(self, i: int) -> dict:
        """The cycle's inputs at tick ``i``: candidates (pending, by id),
        running jobs' priority attributes and allocation rows, free
        resources."""
        now = float(self.tick_nows[i])
        j = self.job
        running = (self.start_tick < i) & (self.end_now > now)
        pending = (j["submit_tick"] <= i) & (self.start_tick >= i)
        nn = j["nodes"]

        def attrs(mask):
            return {
                "qos": np.zeros(int(mask.sum()), np.int32),
                "part_prio": np.zeros(int(mask.sum()), np.int32),
                "account": np.zeros(int(mask.sum()), np.int64),
                "node_num": nn[mask].astype(np.int32),
                "cpus": (self.req[mask, 0] / 256.0 * nn[mask]),
                "mem": (self.req[mask, 1].astype(np.float64) * nn[mask]),
            }

        cand = attrs(pending)
        cand.update(job_id=self.ids[pending], req=self.req[pending],
                    time_limit=j["time_limit"][pending],
                    part=j["part"][pending], submit=j["submit_now"][pending])
        run = attrs(running)
        run["start"] = self.start_now[running]
        keep = running[self.rows_job]
        rj = self.rows_job[keep]
        rows = {"node": self.rows_node[keep], "alloc": self.req[rj],
                "end": self.start_now[rj]
                + j["time_limit"][rj].astype(np.float64)}
        return {"now": now, "cand": cand, "run": run, "rows": rows,
                "avail": self._free(running), "totals": self.totals,
                "cpu_cores": self.cpu_cores, "part_nodes": self.part_nodes}
