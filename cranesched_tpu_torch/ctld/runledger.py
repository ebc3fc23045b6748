"""Incremental per-cycle state for running allocations.

Round 2 rebuilt two O(running-jobs) Python structures EVERY cycle:
``_initial_cost`` (the MinCpuTimeRatioFirst cost seed, reference
NodeRater JobScheduler.h:499-516) and ``_timed_state``'s release rows
(the TimeAvailResMap feed).  Fine at 10k running jobs; fatal at the
reference's 2M-concurrent envelope (BASELINE.md).

This ledger maintains one flat numpy row per (job, node) allocation,
updated O(nodes-of-job) on start/finish/suspend/resume events; the
per-cycle products are O(rows) vectorized numpy (no Python loop over
jobs):

* ``cost0(now)``  — per-node int32 cost seed.  Bit-identical to the
  old per-job loop: the same float32 expression
  ``round(f32(remaining) * f32(cpus) * f32(SCALE) / f32(cpu_total))``
  is evaluated per row (IEEE elementwise == the scalar loop), then
  summed per node in int64.
* ``timed_rows(now, res, T)`` — (node, alloc, end_bucket) release rows
  for the backfill grid.

Suspension: a suspended job's effective end grows with wall time
(suspended time is credited back), so its REMAINING time is the
constant ``end0 - suspend_time``; rows flip to a stored constant
remaining on suspend and flip back (with the credit applied) on
resume — no per-cycle special-casing.
"""

from __future__ import annotations

import numpy as np

from cranesched_tpu_torch.models.solver import COST_SCALE
from cranesched_tpu_torch.ops.resources import CPU_SCALE, DIM_CPU


class RunLedger:
    """Flat SoA of live (job, node) allocation rows."""

    def __init__(self, num_dims: int, capacity: int = 256):
        self._dims = num_dims
        self._cap = capacity
        n = capacity
        self.node = np.zeros(n, np.int32)
        self.alloc = np.zeros((n, num_dims), np.int64)
        self.cpus = np.zeros(n, np.float32)       # allocated cpus
        self.cpu_total = np.ones(n, np.float32)   # node cpu capacity
        self.end_time = np.zeros(n, np.float64)   # running rows
        self.rem_const = np.zeros(n, np.float64)  # suspended rows
        self.active = np.zeros(n, bool)
        self.suspended = np.zeros(n, bool)
        self._free: list[int] = list(range(n))
        self._rows_of: dict[int, list[int]] = {}  # job_id -> rows

    def __contains__(self, job_id: int) -> bool:
        return job_id in self._rows_of

    def _grow(self) -> None:
        old = self._cap
        self._cap *= 2
        for name in ("node", "cpus", "cpu_total", "end_time",
                     "rem_const", "active", "suspended"):
            arr = getattr(self, name)
            grown = np.zeros(self._cap, arr.dtype)
            grown[:old] = arr
            setattr(self, name, grown)
        grown = np.zeros((self._cap, self._dims), np.int64)
        grown[:old] = self.alloc
        self.alloc = grown
        self.cpu_total[old:] = 1.0
        self._free.extend(range(old, self._cap))

    def add(self, job_id: int, node_ids, allocs, end_time: float,
            node_cpu_totals) -> None:
        """Register a started job: one row per (node, alloc)."""
        if job_id in self._rows_of:
            self.remove(job_id)
        rows = []
        for node_id, alloc, cpu_total in zip(node_ids, allocs,
                                             node_cpu_totals):
            if not self._free:
                self._grow()
            i = self._free.pop()
            rows.append(i)
            self.node[i] = node_id
            self.alloc[i] = alloc
            self.cpus[i] = np.float32(float(alloc[DIM_CPU]) / CPU_SCALE)
            self.cpu_total[i] = np.float32(
                max(float(cpu_total) / CPU_SCALE, 1e-9))
            self.end_time[i] = end_time
            self.active[i] = True
            self.suspended[i] = False
        self._rows_of[job_id] = rows

    def add_batch(self, entries) -> None:
        """Register a whole just-started set in one call: ``entries``
        is a list of ``add`` argument tuples.  Capacity is ensured once
        for the batch (no mid-loop doubling churn) and the row fill
        runs with hoisted array refs — the commit-phase batching
        counterpart of meta.malloc_resource_batch."""
        need = sum(len(e[1]) for e in entries)
        while len(self._free) < need:
            self._grow()
        node, alloc = self.node, self.alloc
        cpus, cpu_total = self.cpus, self.cpu_total
        end, active, susp = self.end_time, self.active, self.suspended
        free_pop = self._free.pop
        for job_id, node_ids, allocs, end_time, node_cpu_totals in \
                entries:
            if job_id in self._rows_of:
                self.remove(job_id)
            rows = []
            for node_id, a, ct in zip(node_ids, allocs,
                                      node_cpu_totals):
                i = free_pop()
                rows.append(i)
                node[i] = node_id
                alloc[i] = a
                cpus[i] = np.float32(float(a[DIM_CPU]) / CPU_SCALE)
                cpu_total[i] = np.float32(
                    max(float(ct) / CPU_SCALE, 1e-9))
                end[i] = end_time
                active[i] = True
                susp[i] = False
            self._rows_of[job_id] = rows

    def remove(self, job_id: int) -> None:
        for i in self._rows_of.pop(job_id, ()):
            self.active[i] = False
            self.suspended[i] = False
            self._free.append(i)

    def suspend(self, job_id: int, now: float) -> None:
        """Remaining time freezes at (end - now) while suspended."""
        for i in self._rows_of.get(job_id, ()):
            self.rem_const[i] = self.end_time[i] - now
            self.suspended[i] = True

    def resume(self, job_id: int, now: float) -> None:
        """The credit: the end moves out to now + frozen remaining."""
        for i in self._rows_of.get(job_id, ()):
            self.end_time[i] = now + self.rem_const[i]
            self.suspended[i] = False

    def set_end_time(self, job_id: int, end_time: float) -> None:
        """Rebase the expected release (ccontrol modify time_limit) —
        without this, every later time map would plan reservations
        against the stale release bucket.  A suspended row keeps
        freezing from the NEW end."""
        for i in self._rows_of.get(job_id, ()):
            if self.suspended[i]:
                # preserve the frozen-remaining semantics relative to
                # the new deadline: shift the stored remaining by the
                # same delta the end moved
                self.rem_const[i] += end_time - self.end_time[i]
            self.end_time[i] = end_time

    # -- the per-cycle products (vectorized, no Python per-job loop) --

    def remaining(self, now: float) -> np.ndarray:
        """Seconds left per ACTIVE row (>= 0), suspended rows constant."""
        rem = np.where(self.suspended, self.rem_const,
                       self.end_time - now)
        return np.maximum(rem, 0.0)

    def cost0(self, now: float, num_nodes: int) -> np.ndarray:
        """Per-node int32 cost seed; bit-identical to the per-job loop
        it replaces (same float32 expression per row, int64 sum)."""
        mask = self.active
        rem = self.remaining(now)[mask].astype(np.float32)
        dcost = np.round(rem * self.cpus[mask]
                         * np.float32(COST_SCALE)
                         / self.cpu_total[mask]).astype(np.int64)
        out = np.zeros(num_nodes, np.int64)
        np.add.at(out, self.node[mask], dcost)
        return out.astype(np.int32)

    def timed_rows(self, now: float, resolution: float, T: int,
                   grid=None
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(nodes[M,1], allocs[M,R], end_buckets[M]) for the backfill
        grid; overdue rows release no earlier than bucket 1.  With a
        TimeGrid the release bucket follows its (possibly geometric)
        edges; the bare (resolution, T) path is the uniform special
        case kept for existing callers."""
        mask = self.active
        M = int(mask.sum())
        if M == 0:
            return (np.full((1, 1), -1, np.int32),
                    np.zeros((1, self._dims), np.int32),
                    np.full(1, T, np.int32))
        rem = self.remaining(now)[mask]
        if grid is not None:
            eb = np.minimum(grid.release_bucket(rem), T).astype(np.int32)
        else:
            eb = np.maximum(np.ceil(rem / resolution), 1).astype(np.int32)
        return (self.node[mask].astype(np.int32).reshape(-1, 1),
                self.alloc[mask].astype(np.int32),
                eb)
