"""Simulated craned cluster with a virtual clock (port of
``cranesched_tpu/craned/sim.py``).

Plays the node daemons for integration tests and the chip smoke run: no
processes, no sleeping — a priority queue of completion events driven by
``advance_to(now)``.  A job runs for its ``sim_runtime``; past its time
limit it is killed at the limit and reports ExceedTimeLimit; terminate
requests kill immediately and report Cancelled.  Steps of an allocation
complete on their own ``sim_runtime``; suspend pulls a job's completion
and resume puts it back with the remaining runtime.
"""

from __future__ import annotations

import dataclasses
import heapq

from cranesched_tpu_torch.ctld.defs import Job, JobStatus, StepStatus
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
    # step-level completion (None = the whole job / its batch step)
    step_id: int | None = dataclasses.field(compare=False, default=None)


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
        # suspended jobs: job_id -> (remaining runtime, status, exit
        # code, incarnation)
        self._frozen: dict[int, tuple] = {}
        self.now = 0.0

    def wire(self, scheduler) -> None:
        """Attach every dispatch seam (the allocation free keeps the
        scheduler's default, a terminate)."""
        scheduler.dispatch = self.dispatch
        scheduler.dispatch_step = self.dispatch_step
        scheduler.dispatch_terminate = self.terminate
        scheduler.dispatch_terminate_step = self.terminate_step
        scheduler.dispatch_suspend = self.suspend
        scheduler.dispatch_resume = self.resume

    def dispatch(self, job: Job, node_ids: list[int]) -> None:
        """Register the job on every allocated node and schedule its
        completion."""
        for node_id in node_ids:
            self.craneds[node_id].alloc_step(job.job_id)
        self._job_nodes[job.job_id] = list(node_ids)
        trace = getattr(self.scheduler, "jobtrace", None)
        if trace is not None:
            # the simulated node plane is synchronous and shares the
            # ctld clock: stamp the node-side edges inline, skew 0
            start = (job.start_time if job.start_time is not None
                     else self.now)
            node = node_ids[0] if node_ids else -1
            for edge in ("craned_received", "cgroup_ready",
                         "step_start"):
                trace.stamp(job.job_id, job.requeue_count, edge, start,
                            node_id=node)
        if job.spec.alloc_only:
            return  # the allocation just sits; steps arrive separately
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

    def dispatch_step(self, job: Job, step) -> None:
        """Schedule one step's completion on its own sim_runtime."""
        runtime = (step.spec.sim_runtime
                   if step.spec.sim_runtime is not None
                   else self.default_runtime)
        start = step.start_time if step.start_time is not None else self.now
        status = (JobStatus.COMPLETED if step.spec.sim_exit_code == 0
                  else JobStatus.FAILED)
        heapq.heappush(self._events, _Completion(
            start + runtime, job.job_id, status, step.spec.sim_exit_code,
            job.requeue_count, step_id=step.step_id))

    def terminate_step(self, job_id: int, step_id: int,
                       now: float | None = None) -> None:
        """Kill exactly one step: drop its completion and deliver a
        Cancelled step report."""
        job = self.scheduler.running.get(job_id)
        if job is None:
            return
        when = self.now if now is None else max(now, self.now)
        for i, ev in enumerate(self._events):
            if ev.job_id == job_id and ev.step_id == step_id:
                self._events.pop(i)
                heapq.heapify(self._events)
                break
        self.scheduler.step_report(job_id, step_id, StepStatus.CANCELLED,
                                   130, when,
                                   incarnation=job.requeue_count)

    def suspend(self, job_id: int, now: float) -> None:
        """Freeze: pull the job's completion and keep its remaining
        runtime."""
        job = self.scheduler.running.get(job_id)
        rqc = job.requeue_count if job is not None else 0
        for i, ev in enumerate(self._events):
            if ev.job_id == job_id and ev.requeue_count == rqc:
                self._events.pop(i)
                heapq.heapify(self._events)
                self._frozen[job_id] = (max(ev.time - now, 0.0),
                                        ev.status, ev.exit_code,
                                        ev.requeue_count)
                return

    def resume(self, job_id: int, now: float) -> None:
        frozen = self._frozen.pop(job_id, None)
        if frozen is None:
            return
        remaining, status, exit_code, rqc = frozen
        heapq.heappush(self._events, _Completion(
            now + remaining, job_id, status, exit_code, rqc))

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
        self._frozen.pop(job_id, None)
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
            if ev.step_id is not None:
                # one step of a live allocation
                self.scheduler.step_report(
                    ev.job_id, ev.step_id, StepStatus(ev.status.value),
                    ev.exit_code, ev.time, incarnation=ev.requeue_count)
                sent += 1
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
        next completion, begin time or dependency delay.  Held jobs
        never drain."""
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
            horizons = []
            nxt = self.next_event_time()
            if nxt is not None:
                horizons.append(nxt)
            horizons.extend(j.spec.begin_time
                            for j in sched.pending.values()
                            if j.spec.begin_time is not None
                            and j.spec.begin_time > now and not j.held)
            for j in sched.pending.values():
                if j.held:
                    continue
                times = [v for v in j.dep_state.values()
                         if v is not None and v != float("inf")
                         and v > now]
                if times:
                    horizons.append(max(times) if not j.spec.deps_is_or
                                    else min(times))
            if not horizons:
                if all(j.held for j in sched.pending.values()):
                    return now  # only held jobs remain
                raise RuntimeError(
                    f"stuck at t={now}: {len(sched.pending)} pending, "
                    "nothing running, no future events")
            now = max(min(horizons), now + cycle_s)
        raise RuntimeError("simulation did not drain")
