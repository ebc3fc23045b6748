"""Simulated craned cluster with a virtual clock (port of
``cranesched_tpu/craned/sim.py``).

Plays the node daemons for integration tests and the chip smoke run: no
processes, no sleeping — a priority queue of completion events driven by
``advance_to(now)``.  A job runs for its ``sim_runtime``; past its time
limit it is killed at the limit and reports ExceedTimeLimit; terminate
requests kill immediately and report Cancelled.
"""

from __future__ import annotations

import dataclasses
import heapq

from cranesched_tpu_torch.ctld.defs import Job, JobStatus
from cranesched_tpu_torch.ctld.scheduler import JobScheduler


@dataclasses.dataclass(order=True)
class _Completion:
    time: float
    job_id: int = dataclasses.field(compare=False)
    status: JobStatus = dataclasses.field(compare=False)
    exit_code: int = dataclasses.field(compare=False)
    # incarnation token: a stale event from a dispatch that predates a
    # requeue must not complete the job's NEW run
    requeue_count: int = dataclasses.field(compare=False, default=0)


class SimCraned:
    """One simulated node daemon: tracks its running jobs."""

    def __init__(self, node_id: int):
        self.node_id = node_id
        self.steps: set[int] = set()

    def alloc_step(self, job_id: int) -> None:
        self.steps.add(job_id)

    def free_step(self, job_id: int) -> None:
        self.steps.discard(job_id)


class SimCluster:
    """All simulated craneds + the shared virtual event queue.

    Wire-up: ``cluster.wire(scheduler)``; then alternate
    ``scheduler.schedule_cycle(now)`` / ``cluster.advance_to(now)``.
    """

    def __init__(self, scheduler: JobScheduler,
                 default_runtime: float = 60.0):
        self.scheduler = scheduler
        self.default_runtime = default_runtime
        self.craneds: dict[int, SimCraned] = {
            node_id: SimCraned(node_id)
            for node_id in scheduler.meta.nodes
        }
        self._events: list[_Completion] = []
        # job_id -> the nodes it was last dispatched to, so a kill or a
        # completion frees those craneds without a scan of all of them
        self._job_nodes: dict[int, list[int]] = {}
        self.now = 0.0

    def wire(self, scheduler) -> None:
        """Attach the dispatch seams."""
        scheduler.dispatch = self.dispatch
        scheduler.dispatch_terminate = self.terminate

    def dispatch(self, job: Job, node_ids: list[int]) -> None:
        """Register the job on every allocated node and schedule its
        completion."""
        for node_id in node_ids:
            self.craneds[node_id].alloc_step(job.job_id)
        self._job_nodes[job.job_id] = list(node_ids)
        runtime = (job.spec.sim_runtime if job.spec.sim_runtime is not None
                   else self.default_runtime)
        start = job.start_time if job.start_time is not None else self.now
        if runtime > job.spec.time_limit:
            heapq.heappush(self._events, _Completion(
                start + job.spec.time_limit, job.job_id,
                JobStatus.EXCEED_TIME_LIMIT, 124, job.requeue_count))
        else:
            status = (JobStatus.COMPLETED if job.spec.sim_exit_code == 0
                      else JobStatus.FAILED)
            heapq.heappush(self._events, _Completion(
                start + runtime, job.job_id, status,
                job.spec.sim_exit_code, job.requeue_count))

    def terminate(self, job_id: int, now: float | None = None,
                  incarnation: int | None = None,
                  skip_node: int | None = None) -> None:
        """Immediate kill + Cancelled upcall.  ``now`` is the ctld-side
        cancel time; ``incarnation`` guards the kill."""
        job = self.scheduler.running.get(job_id)
        if job is None:
            return
        if incarnation is not None and job.requeue_count != incarnation:
            return
        when = self.now if now is None else max(now, self.now)
        self._remove_step(job_id)
        self.scheduler.step_status_change(job_id, JobStatus.CANCELLED,
                                          130, when,
                                          incarnation=job.requeue_count)

    def advance_to(self, now: float) -> int:
        """Deliver every completion due at or before ``now``; returns the
        number of status changes sent."""
        self.now = max(self.now, now)
        sent = 0
        while self._events and self._events[0].time <= now:
            ev = heapq.heappop(self._events)
            job = self.scheduler.running.get(ev.job_id)
            # skip jobs already killed and stale pre-requeue events
            if job is None or job.requeue_count != ev.requeue_count:
                continue
            self._remove_step(ev.job_id)
            self.scheduler.step_status_change(ev.job_id, ev.status,
                                              ev.exit_code, ev.time,
                                              incarnation=ev.requeue_count)
            sent += 1
        return sent

    def next_event_time(self) -> float | None:
        return self._events[0].time if self._events else None

    def _remove_step(self, job_id: int) -> None:
        for node_id in self._job_nodes.pop(job_id, ()):
            self.craneds[node_id].free_step(job_id)

    def run_until_drained(self, start: float = 0.0, cycle_s: float = 1.0,
                          max_cycles: int = 100_000) -> float:
        """Alternate cycles and clock advances until no pending/running
        jobs remain.  When a cycle places nothing the clock jumps to the
        next completion.  Held jobs never drain."""
        now = start
        sched = self.scheduler
        for _ in range(max_cycles):
            self.advance_to(now)
            started = sched.schedule_cycle(now)
            if not sched.pending and not sched.running and not self._events:
                return now
            if started:
                now += cycle_s
                continue
            nxt = self.next_event_time()
            if nxt is None:
                if all(j.held for j in sched.pending.values()):
                    return now  # only held jobs remain
                raise RuntimeError(
                    f"stuck at t={now}: {len(sched.pending)} pending, "
                    "nothing running, no future events")
            now = max(nxt, now + cycle_s)
        raise RuntimeError("simulation did not drain")
