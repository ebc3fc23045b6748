"""The real craned: node daemon running actual job steps.

Mirrors the reference's node plane (reference: src/Craned/Core/ —
CtldClient registration/ping FSM CtldClient.h:35-90, JobManager
JobManager.h:94-358, StepInstance fork/exec + pipe handshake
StepInstance.cpp:146-201; supervisor spawning Supervisor.cpp:34):

* registration FSM: DISCONNECTED → REGISTERING → READY, driven by a ping
  thread (reference kCranedPingIntervalSec = 10, PublicHeader.h:145);
  ping failures reconnect and re-register.
* a gRPC ``Craned`` service receives pushed work from ctld
  (ExecuteStep/TerminateStep/SuspendStep/ResumeStep — reference
  CranedServer.cpp:32-577).
* each step spawns a REAL ``csupervisor`` process with the stdin pipe
  handshake (init JSON → READY → GO), optional cgroup-v2 attachment, and
  a watcher thread that turns the supervisor's exit report into a
  StepStatusChange upcall to ctld.

The port's copy of ``cranesched_tpu/craned/daemon.py``,
with the port's imports.
"""

from __future__ import annotations

import enum
import json
import logging
import os
import re
import subprocess
import sys
import threading
import time
from concurrent import futures

import grpc

from cranesched_tpu_torch.craned.cgroup import (
    make_cgroups,
    write_pid_to_cgroup,
)
from cranesched_tpu_torch.obs import REGISTRY as _OBS
from cranesched_tpu_torch.rpc import crane_pb2 as pb
from cranesched_tpu_torch.rpc.client import make_client
from cranesched_tpu_torch.rpc.consts import CRANED_SERVICE
from cranesched_tpu_torch.utils.gres import gres_key_pair, gres_key_str


class CranedState(enum.Enum):
    """Reference CtldClientStateMachine states (CtldClient.h:90)."""

    DISCONNECTED = "Disconnected"
    REGISTERING = "Registering"
    READY = "Ready"


# node-plane metrics (naming: ARCHITECTURE.md "Observability")
_STATE_ORD = {CranedState.DISCONNECTED: 0, CranedState.REGISTERING: 1,
              CranedState.READY: 2}
_MET_STATE = _OBS.gauge(
    "crane_craned_state",
    "registration FSM state (0=disconnected 1=registering 2=ready)")
_MET_CTLD_RTT = _OBS.histogram(
    "crane_craned_ctld_seconds",
    "register/ping round trip to ctld (label op)")
_MET_SPAWN = _OBS.histogram(
    "crane_supervisor_spawn_seconds",
    "supervisor fork to GO-handshake-complete wall time")
_MET_CGROUP = _OBS.histogram(
    "crane_cgroup_op_seconds",
    "cgroup create/destroy wall time (label op)")
_MET_FENCED = _OBS.counter(
    "crane_craned_fenced_total",
    "pushed orders refused by the fencing-epoch latch")


class _Alloc:
    """One job allocation on this node (reference JobInD — cgroup + GRES
    held for the job, steps spawned inside it; JobManager.h:53).

    ``implicit`` allocations are created on the fly by a batch
    ExecuteStep and torn down when their last step exits; explicit ones
    (AllocJob) live until FreeJob."""

    def __init__(self, job_id: int, incarnation: int, gres_held,
                 env: dict, procs_path, implicit: bool,
                 cores_held: tuple[int, ...] = (), user: str = ""):
        self.job_id = job_id
        self.incarnation = incarnation
        self.gres_held = gres_held or {}
        self.env = env
        # cgroup.procs path(s): one for v2, one per controller for v1
        self.procs_path = procs_path
        self.implicit = implicit
        # cpuset-pinned core ids (returned to the node pool on free)
        self.cores_held = tuple(cores_held)
        # owning user (the ssh-access gate: PAM asks 'does USER have a
        # live allocation here?', reference Pam.cpp:37-112)
        self.user = user


class _Step:
    def __init__(self, job_id: int, proc: subprocess.Popen | None,
                 incarnation: int = 0, step_id: int = 0,
                 control_path: str = "", report_path: str = "",
                 pid: int | None = None):
        self.job_id = job_id
        self.step_id = step_id
        self.proc = proc             # None for re-adopted supervisors
        self.incarnation = incarnation
        self.cancelled = False
        # re-adoption surface (reference Craned.cpp:1345-1449): the
        # FIFO takes control verbs when the stdin pipe died with a
        # previous craned; the report file carries the terminal outcome
        self.control_path = control_path
        self.report_path = report_path
        self.pid = pid if pid is not None else (
            proc.pid if proc is not None else 0)
        # /proc starttime ticks of the supervisor: disambiguates PID
        # reuse across a craned restart (same pid, different process)
        self.start_ticks: int | None = None


class CranedDaemon:
    def __init__(self, name: str, ctld_address: str,
                 cpu: float = 8.0, mem_bytes: int = 16 << 30,
                 partitions=("default",), workdir: str = "/tmp",
                 ping_interval: float = 5.0,
                 cgroup_root: str = "/sys/fs/cgroup",
                 health_program: str = "",
                 health_interval: float = 30.0,
                 gres: dict | None = None,
                 gres_devices: dict | None = None,
                 token: str = "",
                 prolog: str = "", epilog: str = "",
                 tls=None, tls_name: str = "ctld",
                 container_runtime: str | None = None,
                 pam_alias: bool = False,
                 metrics_port: int | None = None):
        self.name = name
        self.ctld_address = ctld_address
        self.cpu = cpu
        self.mem_bytes = mem_bytes
        self.partitions = tuple(partitions)
        self.workdir = workdir
        self.ping_interval = ping_interval
        # periodic node health program (reference HealthCheck config,
        # Craned.cpp:731-751): nonzero exit drains the node at ctld
        self.health_program = health_program
        self.health_interval = health_interval
        self.healthy = True
        # task prolog/epilog scripts run by the supervisor around every
        # step (reference config.yaml:121-133); a failing prolog fails
        # the step AND drains this node (policy: a broken node setup
        # must not eat the queue job by job); a failing epilog only
        # drains
        self.prolog = prolog
        self.epilog = epilog
        # GRES slot identity (reference DeviceManager, DeviceManager.h:
        # 26-80: concrete slot ids assigned at step start, vendor env
        # injection).  Slot ids live in a node-global index space per
        # GRES NAME (a node with gpu:a100:2 + gpu:h100:1 exposes gpu ids
        # 0,1,2) so two types never alias the same physical device.
        # keys normalized once: accept "name:type" strings or pairs
        self.gres = {
            (gres_key_pair(k) if isinstance(k, str) else tuple(k)): v
            for k, v in (gres or {}).items()}
        self._gres_free: dict[tuple, list[int]] = {}
        next_id: dict[str, int] = {}
        # NB: loop vars must not shadow the ``name`` parameter — the
        # steps-dir path below binds the daemon name lexically
        for (gname, typ), count in sorted(self.gres.items()):
            base = next_id.get(gname, 0)
            self._gres_free[(gname, typ)] = list(range(base,
                                                       base + count))
            next_id[gname] = base + count
        # GRES slot -> device file (reference config.yaml:139-160 maps
        # slots to /dev nodes; DeviceManager resolves major:minor for
        # the cgroup/eBPF ACL).  Keys like gres: name[:type] -> ordered
        # device path list, aligned with that pair's slot ids.
        self._gres_slot_dev: dict[tuple[tuple, int], str] = {}
        for key, paths in (gres_devices or {}).items():
            pair = gres_key_pair(key) if isinstance(key, str) \
                else tuple(key)
            for slot, path in zip(self._gres_free.get(pair, ()), paths):
                self._gres_slot_dev[(pair, slot)] = path
        # OCI runtime CLI for container steps (reference CriClient /
        # ContainerInstance; podman and docker share the verb surface).
        # None = auto-detect; "" = containers unsupported on this node
        if container_runtime is None:
            import shutil as _shutil
            container_runtime = (_shutil.which("podman")
                                 or _shutil.which("docker") or "")
        self.container_runtime = container_runtime
        # publish /var/run/crane/pam.sock (real daemon deployments)
        self.pam_alias = pam_alias
        # Prometheus /metrics endpoint: None = off, 0 = ephemeral port
        self.metrics_port = metrics_port
        self._metrics_server = None
        # node-local structured event ring (obs/events.py is per-
        # process by design): containment drills read warnings like
        # cgroup_adopt_fallback here instead of grepping the daemon log
        from cranesched_tpu_torch.obs.events import EventLog
        self.events = EventLog(capacity=128)
        self.state = CranedState.DISCONNECTED
        self.node_id: int | None = None
        self.cgroups = make_cgroups(cgroup_root)
        # cpuset core pool: whole cores handed to integral-cpu
        # allocations (reference CpuSet pinning, PublicHeader.h:555)
        self._cores_free = list(range(int(cpu)))
        # utils.pki.TlsConfig: dial the ctld over TLS (presenting this
        # node's cert when the internal surface requires mTLS), serve
        # the push surface over TLS, and hand supervisors the CA for
        # their cfored dial-back
        self.tls = tls
        # cluster-secret token for the ctld's craned-internal surface
        # (auth-enabled clusters refuse unauthenticated registration).
        # The dial pins the control-plane identity ("ctld" — the name
        # its cert is issued under) so no other cluster cert can
        # impersonate it
        if tls is not None and not (tls.cert and tls.key):
            # half-configured TLS (CA only) would register fine over
            # TLS but serve a PLAINTEXT push surface that a TLS ctld
            # dispatcher can never reach — every dispatched job would
            # fail.  Refuse at startup instead
            raise ValueError(
                "craned TLS needs a node cert+key (cpki issue "
                f"{name}), not just the CA")
        # comma-separated address list = HA ctld pair: the client
        # rotates to the standby on UNAVAILABLE / not-leader refusals,
        # so registration and status upcalls survive a failover
        self._ctld = make_client(
            ctld_address, timeout=10.0, token=token,
            tls=tls.pinned(tls_name) if tls is not None else None)
        # highest fencing epoch seen from any ctld (0 = pre-HA ctld,
        # no fencing).  Stale-leader pushes carry a lower epoch and are
        # refused — the split-brain half of the HA design
        self._fencing_epoch = 0
        # allocations (job-level: cgroup + GRES) and the steps running
        # inside them, keyed (job_id, step_id)
        self._allocs: dict[int, _Alloc] = {}
        self._steps: dict[tuple[int, int], _Step] = {}
        # kills that race an in-flight spawn handshake: recorded only
        # while a spawn for that (job, step) is actually in progress (a
        # kill for a step that already finished is a no-op and must NOT
        # poison a future re-dispatch of the same ids).  Keyed with the
        # spawning incarnation so an incarnation-guarded kill can be
        # matched against the spawn it was aimed at; the latch value is
        # the guarded incarnation, or None for a wildcard (user-cancel)
        # kill.  A wildcard latch subsumes any guarded one.
        self._spawning: dict[tuple[int, int], int] = {}
        self._pending_kills: dict[tuple[int, int], int | None] = {}
        # job_id -> (new time limit, incarnation) latched when a
        # ChangeTimeLimit beats the supervisor spawn (same race shape
        # as _pending_kills); applied at spawn registration
        self._pending_limits: dict[int, tuple[float, int]] = {}
        # same race shape at the allocation level: a FreeJob that
        # arrives while an AllocJob is still in flight must latch so
        # the late allocation is torn down, not leaked
        self._allocating: dict[int, int] = {}
        self._pending_frees: dict[int, int | None] = {}
        # per-job trace spans (obs/jobtrace.py craned half): local
        # lifecycle spans recorded while the push's crane-trace context
        # is live, shipped back inside the final StepStatusChange
        self._trace_ctx: dict[tuple[int, int], dict] = {}
        # last measured ping RTT = the clock-skew bound stamped on
        # every re-based span (0.0 until the first ping completes)
        self._last_rtt = 0.0
        self._lock = threading.Lock()
        self._server: grpc.Server | None = None
        self._crashed = False   # crash-simulation flag (stop graceful=False)
        # durable step registry (reference Craned.cpp:1345-1449): a
        # restarted craned re-adopts live supervisors from here instead
        # of orphaning them.  Per-craned-name dir so colocated test
        # daemons never cross-adopt.
        self._steps_dir = os.path.join(workdir,
                                       f".crane_steps_{self.name}")
        os.makedirs(self._steps_dir, exist_ok=True)
        self._registry_path = os.path.join(self._steps_dir,
                                           "registry.json")
        self._stop = threading.Event()
        self.address = ""

    # ---- the Craned service (ctld -> craned push) ----

    def _fenced(self, request) -> str:
        """Fencing guard for every pushed order: latch the highest
        epoch ever seen and refuse anything older.  A deposed leader's
        in-flight dispatch (built before it lost the lease) carries the
        old epoch and dies here instead of double-running a job the new
        leader already re-placed.  Epoch 0 = a pre-HA ctld: no check
        (and nothing to latch)."""
        epoch = getattr(request, "fencing_epoch", 0)
        if epoch == 0:
            return ""
        with self._lock:
            if epoch > self._fencing_epoch:
                self._fencing_epoch = epoch
            elif epoch < self._fencing_epoch:
                _MET_FENCED.inc()
                return (f"fenced: request epoch {epoch} < "
                        f"latched {self._fencing_epoch}")
        return ""

    def AllocJob(self, request, context):
        """Create the allocation only (the AllocJobs half): cgroup +
        GRES hold, no supervisor until steps arrive."""
        if err := self._fenced(request):
            return pb.OkReply(ok=False, error=err)
        self._trace_begin(request, context)
        job_id = request.job_id
        with self._lock:
            self._allocating[job_id] = request.incarnation
        try:
            self._ensure_alloc(request, implicit=False)
            return pb.OkReply(ok=True)
        except Exception as exc:
            return pb.OkReply(ok=False, error=str(exc))
        finally:
            with self._lock:
                if self._allocating.get(job_id) == request.incarnation:
                    self._allocating.pop(job_id, None)
                lat = self._pending_frees.get(job_id, "absent")
                apply_free = (lat != "absent"
                              and (lat is None
                                   or lat == request.incarnation))
                if apply_free:
                    self._pending_frees.pop(job_id, None)
            if apply_free:
                # a FreeJob raced our in-flight create: honor it now
                self._free_job(job_id, request.incarnation)

    def ExecuteStep(self, request, context):
        if err := self._fenced(request):
            return pb.OkReply(ok=False, error=err)
        self._trace_begin(request, context)
        key = (request.job_id, request.step_id)
        try:
            self._spawn_step(request)
            return pb.OkReply(ok=True)
        except Exception as exc:  # report, never crash the RPC
            return pb.OkReply(ok=False, error=str(exc))
        finally:
            with self._lock:
                # only clear OUR spawn record: a slow stale-incarnation
                # handler must not clobber the record (and latched kill)
                # of a newer incarnation's in-flight spawn
                if self._spawning.get(key) == request.incarnation:
                    self._spawning.pop(key, None)
                    # drop only a latch aimed at our (now finished) spawn
                    # — wildcard included: the kill was a no-op against a
                    # step that never registered, and a future
                    # re-dispatch must not be poisoned
                    self._pending_kills.pop(key, None)
            self._maybe_teardown_alloc(request.job_id)

    def TerminateStep(self, request, context):
        """Kill one step (step_id present) or every step of the job."""
        if err := self._fenced(request):
            return pb.OkReply(ok=False, error=err)
        guard = (request.incarnation if request.HasField("incarnation")
                 else None)
        targets = []
        with self._lock:
            if request.HasField("step_id"):
                keys = [(request.job_id, request.step_id)]
            else:
                keys = [k for k in self._steps if k[0] == request.job_id]
                keys += [k for k in self._spawning
                         if k[0] == request.job_id and k not in keys]
            for key in keys:
                step = self._steps.get(key)
                if step is not None and (guard is None
                                         or guard == step.incarnation):
                    step.cancelled = True
                    targets.append(step)
                    continue
                # no registered step of the targeted incarnation — maybe
                # the kill raced an in-flight ExecuteStep handshake for
                # it: latch so it applies the moment the step registers.
                # (Checked even when a DIFFERENT incarnation's step is
                # registered: a stale step can coexist with the new
                # incarnation's spawn on the same node.)
                spawn_inc = self._spawning.get(key)
                if spawn_inc is not None and (guard is None
                                              or guard == spawn_inc):
                    # a wildcard latch (None) subsumes any guarded one
                    if self._pending_kills.get(key, "absent") is not None:
                        self._pending_kills[key] = guard
                # else: the step already finished (or never started) —
                # the kill is a no-op
        for step in targets:
            self._send_verb(step, "TERM")
        return pb.OkReply(ok=True)

    def FreeJob(self, request, context):
        """Release the allocation: kill remaining steps, then drop the
        cgroup and GRES (the FreeJobs half)."""
        if err := self._fenced(request):
            return pb.OkReply(ok=False, error=err)
        guard = (request.incarnation if request.HasField("incarnation")
                 else None)
        self._free_job(request.job_id, guard)
        return pb.OkReply(ok=True)

    def _free_job(self, job_id: int, guard: int | None) -> None:
        with self._lock:
            # a latched time-limit update dies with the job (spawn
            # failures would otherwise leak the entry)
            self._pending_limits.pop(job_id, None)
            alloc = self._allocs.get(job_id)
            if alloc is None:
                # maybe the AllocJob is still in flight: latch the free
                # so the late allocation is torn down on arrival
                alloc_inc = self._allocating.get(job_id)
                if alloc_inc is not None and (guard is None
                                              or guard == alloc_inc):
                    if self._pending_frees.get(job_id,
                                               "absent") is not None:
                        self._pending_frees[job_id] = guard
                return
            if guard is not None and guard != alloc.incarnation:
                return
            alloc.implicit = True  # teardown once the last step exits
            steps = [s for (j, _), s in self._steps.items()
                     if j == job_id]
            # steps whose ExecuteStep spawn is still in flight must die
            # too: latch the kill exactly like TerminateStep does, else
            # a step spawned concurrently with the free survives on
            # resources ctld already returned to the ledger
            for key, spawn_inc in self._spawning.items():
                if key[0] != job_id:
                    continue
                if guard is None or guard == spawn_inc:
                    if self._pending_kills.get(key, "absent") is not None:
                        self._pending_kills[key] = guard
        for step in steps:
            step.cancelled = True
            self._send_verb(step, "TERM")
        self._maybe_teardown_alloc(job_id)

    def ChangeTimeLimit(self, request, context):
        """Propagate a new job deadline to the batch supervisor
        (reference ChangeJobTimeConstraint, CranedServer.cpp handler):
        the LIMIT verb rebases the supervisor's deadline to the given
        total seconds from step start.  Only step 0 carries the JOB
        time limit; other steps keep their own StepSpec limits.

        The update can arrive BEFORE the supervisor registers (ctld
        marks the job Running at dispatch; ExecuteStep and this RPC ride
        separate workers) — latch it and apply at spawn registration, or
        the modified deadline would be silently lost to the race."""
        if err := self._fenced(request):
            return pb.OkReply(ok=False, error=err)
        with self._lock:
            step = self._steps.get((request.job_id, 0))
            if (step is not None and request.incarnation
                    and step.incarnation != request.incarnation):
                step = None
            if step is None:
                # latch ONLY while the spawn is actually in flight
                # (mirrors _pending_kills); a limit for a step that is
                # neither registered nor spawning has nothing to attach
                # to — refusing keeps the latch map bounded, and the
                # ctld's spec carries the new limit to any future
                # incarnation's init anyway
                if (request.job_id, 0) in self._spawning:
                    self._pending_limits[request.job_id] = (
                        request.time_limit, request.incarnation)
                    return pb.OkReply(ok=True)
                return pb.OkReply(ok=False, error="no such step")
        self._send_verb(step, f"LIMIT {request.time_limit}")
        return pb.OkReply(ok=True)

    def SuspendStep(self, request, context):
        if err := self._fenced(request):
            return pb.OkReply(ok=False, error=err)
        return self._freeze(request.job_id, True)

    def ResumeStep(self, request, context):
        if err := self._fenced(request):
            return pb.OkReply(ok=False, error=err)
        return self._freeze(request.job_id, False)

    def _freeze(self, job_id: int, frozen: bool):
        with self._lock:
            steps = [s for (j, _), s in self._steps.items() if j == job_id]
        if not steps:
            return pb.OkReply(ok=False, error="no such step")
        # the supervisors ALWAYS get the verb: it pauses the time-limit
        # clock (and SIGSTOPs the group, harmless if also frozen); the
        # cgroup freezer additionally freezes when available
        if frozen:
            for step in steps:
                self._send_verb(step, "STOP")
            self.cgroups.freeze(job_id, True)
        else:
            self.cgroups.freeze(job_id, False)
            for step in steps:
                self._send_verb(step, "CONT")
        return pb.OkReply(ok=True)

    def _send_verb(self, step: _Step, verb: str) -> None:
        if step.proc is None:
            # re-adopted supervisor: the stdin pipe died with the old
            # craned; verbs travel over the FIFO instead
            if not step.control_path:
                return
            try:
                fd = os.open(step.control_path,
                             os.O_WRONLY | os.O_NONBLOCK)
                try:
                    os.write(fd, f"{verb}\n".encode())
                finally:
                    os.close(fd)
            except OSError:
                pass
            return
        try:
            step.proc.stdin.write(f"{verb}\n".encode())
            step.proc.stdin.flush()
        except (BrokenPipeError, ValueError, OSError):
            pass

    # ---- per-job trace spans (obs/jobtrace.py craned half) ----

    def _trace_begin(self, request, context) -> None:
        """Open the local span list when the push carried crane-trace
        metadata (``job_id/incarnation/epoch/base_seq``) and stamp
        ``craned_received``.  Span times are re-based onto the ctld
        clock via the push's ``now`` anchor (span_t = anchor + local
        elapsed since receive); the residual skew is bounded by the
        last measured ping RTT and shipped with every span."""
        if context is None:
            return
        try:
            md = dict(context.invocation_metadata() or ())
        except Exception:
            return
        raw = md.get("crane-trace")
        if not raw:
            return
        try:
            job_id, incarnation, _epoch, base_seq = (
                int(x) for x in raw.split("/"))
        except ValueError:
            return
        if (job_id != request.job_id
                or incarnation != getattr(request, "incarnation", 0)):
            return   # metadata for another push: drop, never mislabel
        ctx = {"base": base_seq, "anchor": float(request.now),
               "t0": time.perf_counter(), "skew": self._last_rtt,
               "spans": []}
        with self._lock:
            self._trace_ctx[(job_id, incarnation)] = ctx
        self._trace_mark(job_id, incarnation, "craned_received")

    def _trace_mark(self, job_id: int, incarnation: int,
                    edge: str) -> None:
        """Append one span to the job's live trace context (no-op when
        the push carried no context, e.g. AllocSteps pushes)."""
        with self._lock:
            ctx = self._trace_ctx.get((job_id, incarnation))
            if ctx is None:
                return
            if any(s["edge"] == edge for s in ctx["spans"]):
                return   # spawn retry: the edge already happened once
            ctx["spans"].append({
                "edge": edge,
                "seq": ctx["base"] + len(ctx["spans"]),
                "t": ctx["anchor"]
                + (time.perf_counter() - ctx["t0"]),
                "node_id": (self.node_id
                            if self.node_id is not None else -1),
                "skew": ctx["skew"]})

    def _trace_take(self, job_id: int, incarnation: int) -> list[dict]:
        """Pop the job's local spans for the ship-back (empty when no
        context was propagated)."""
        with self._lock:
            ctx = self._trace_ctx.pop((job_id, incarnation), None)
        return ctx["spans"] if ctx else []

    # ---- step spawning (StepInstance::SpawnSupervisor analog) ----

    def _ensure_alloc(self, request, implicit: bool) -> "_Alloc":
        """Create (or reuse) the job's allocation: GRES hold + cgroup.
        Idempotent per incarnation; a stale-incarnation allocation is NOT
        reused (the caller's request fails and the dispatcher retries)."""
        job_id = request.job_id
        spec = request.spec
        with self._lock:
            alloc = self._allocs.get(job_id)
            if alloc is not None:
                if alloc.incarnation == request.incarnation:
                    if not implicit:
                        alloc.implicit = False
                    return alloc
                raise RuntimeError(
                    "retryable: allocation of a previous incarnation "
                    "still tearing down")
        # GRES first: nothing else to clean up if the pool can't satisfy
        # CRANE_JOB_NODELIST = the whole gang (compressed);
        # CRANE_NODE_NAME = this node (the SLURMD_NODENAME analog)
        env = {"CRANE_JOB_NAME": spec.name,
               "CRANE_JOB_NODELIST": request.nodelist or self.name,
               "CRANE_NODE_NAME": self.name}
        gres_held = self._assign_gres(spec, env)
        if gres_held is None:
            # a re-dispatch can overlap the previous incarnation's
            # teardown by a few seconds — the dispatcher retries these
            raise RuntimeError("retryable: insufficient free GRES slots")
        cores = self._assign_cores(spec.res.cpu)
        if cores:
            env["CRANE_CPUSET"] = ",".join(map(str, cores))
        # kernel-enforced device isolation: with a configured device
        # map, EVERY allocation gets deny-all + plumbing + its own held
        # GRES devices (a job without GRES must not open another job's
        # accelerator; env-var scoping alone is advisory — reference
        # cgroup_dev_bpf.c:40)
        allow_rules = None
        if self._gres_slot_dev and self.cgroups.supports_devices:
            allow_rules = tuple(
                rule for pair, slots in gres_held.items()
                for slot in slots
                if (rule := self._device_rule(pair, slot)) is not None)
        alloc = _Alloc(job_id, request.incarnation, gres_held, env,
                       None, implicit, cores_held=cores,
                       user=spec.user)
        with self._lock:
            raced = self._allocs.get(job_id)
            if raced is not None and raced.incarnation == \
                    request.incarnation:
                # two concurrent creates for the same incarnation: keep
                # the first, roll ours back
                winner = raced
            else:
                self._allocs[job_id] = alloc
                winner = alloc
            if winner is alloc:
                # cgroup creation belongs to the WINNER only, and
                # under the lock: a racing loser that already created
                # it would overwrite cpuset.cpus with cores it is
                # about to return to the pool and widen devices.allow
                # with slots it never keeps — kernel state pointing at
                # resources the ledger thinks are free
                t0 = time.perf_counter()
                alloc.procs_path = self.cgroups.create(
                    job_id, cpu=spec.res.cpu,
                    mem_bytes=spec.res.mem_bytes,
                    memsw_bytes=spec.res.memsw_bytes,
                    cpuset_cpus=(",".join(map(str, cores))
                                 if cores else ""),
                    allow_devices=allow_rules)
                _MET_CGROUP.observe(time.perf_counter() - t0,
                                    op="create")
                self._persist_registry_locked()
        if winner is not alloc:
            self._release_gres(gres_held)
            self._release_cores(cores)
            return winner
        self._trace_mark(job_id, request.incarnation, "cgroup_ready")
        return alloc

    def _maybe_teardown_alloc(self, job_id: int) -> None:
        """Tear down an implicit allocation once nothing lives in it."""
        with self._lock:
            alloc = self._allocs.get(job_id)
            if alloc is None or not alloc.implicit:
                return
            busy = (any(j == job_id for (j, _) in self._steps)
                    or any(j == job_id for (j, _) in self._spawning))
            if busy:
                return
            self._allocs.pop(job_id, None)
            self._persist_registry_locked()
        self._release_gres(alloc.gres_held)
        self._release_cores(alloc.cores_held)
        t0 = time.perf_counter()
        self.cgroups.destroy(job_id)
        _MET_CGROUP.observe(time.perf_counter() - t0, op="destroy")

    def _spawn_step(self, request) -> None:
        job_id = request.job_id
        step_id = request.step_id
        key = (job_id, step_id)
        spec = request.spec
        with self._lock:
            self._spawning[key] = request.incarnation
        # a batch ExecuteStep with no prior AllocJob creates the
        # allocation implicitly (torn down with its last step)
        alloc = self._ensure_alloc(request, implicit=True)
        step_spec = (request.step if request.HasField("step") else None)
        script = (step_spec.script if step_spec and step_spec.script
                  else spec.script)
        output_path = (step_spec.output_path
                       if step_spec and step_spec.output_path
                       else spec.output_path)
        time_limit = (step_spec.time_limit
                      if step_spec and step_spec.time_limit
                      else spec.time_limit)
        step_env = dict(alloc.env)
        step_env["CRANE_STEP_ID"] = str(step_id)
        if step_spec and step_spec.name:
            step_env["CRANE_STEP_NAME"] = step_spec.name
        # container step fields (reference ContainerInstance,
        # TaskManager.h:353): a step-level image wins over the job's
        image = (step_spec.container_image
                 if step_spec and step_spec.container_image
                 else spec.container_image)
        mounts = list(step_spec.container_mounts
                      if step_spec and step_spec.container_mounts
                      else spec.container_mounts)
        if image and not self.container_runtime:
            # fail loudly at spawn, not with a cryptic exec error: the
            # dispatcher reports this step Failed to ctld
            raise RuntimeError(
                "container step needs an OCI runtime (podman/docker) "
                "on this node — none configured or found")
        if self.container_runtime:
            # cattach and in-step tooling find the runtime + the
            # primary container's deterministic name
            step_env["CRANE_CONTAINER_RUNTIME"] = self.container_runtime
            step_env["CRANE_CONTAINER_NAME"] = \
                f"crane-j{job_id}-s{step_id}"
        # gang rendezvous env (the PMIx fork-env role, Pmix.h:54-57):
        # every member can enumerate the gang and find the coordinator.
        # Per-REQUEST values (rank differs per node; a step's span can
        # be a subset of the allocation's).
        rdzv_serve_port = 0
        if request.nodelist:
            step_env["CRANE_JOB_NODELIST"] = request.nodelist
            step_env["CRANE_NODE_RANK"] = str(request.node_rank)
            step_env["CRANE_NNODES"] = str(request.nnodes)
            step_env["CRANE_NTASKS"] = str(request.ntasks)
            if request.rendezvous:
                step_env["CRANE_RENDEZVOUS"] = request.rendezvous
                if request.rendezvous_token:
                    step_env["CRANE_RENDEZVOUS_TOKEN"] = \
                        request.rendezvous_token
                if self.tls is not None:
                    # TLS cluster: rank-0 serves the fence/modex with
                    # its node cert, members verify with the cluster
                    # CA (config consistency across craneds is a
                    # cluster invariant, as with the reference's
                    # config CRC check)
                    step_env["CRANE_RENDEZVOUS_CA"] = self.tls.ca
                # the rank-0 supervisor HOSTS the gang's fence/modex
                # service at the advertised port (the PMIx-server
                # role, Pmix.h:44)
                if request.node_rank == 0 and request.nnodes > 1:
                    rdzv_serve_port = int(
                        request.rendezvous.rsplit(":", 1)[1])
        step_env["CRANE_NTASKS_ON_NODE"] = str(request.tasks_on_node
                                               or 1)
        # the supervisor must import this package regardless of workdir
        import cranesched_tpu_torch
        import os
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(cranesched_tpu_torch.__file__)))
        env = dict(os.environ)
        env["PYTHONPATH"] = pkg_root + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH")
            else "")
        t_spawn = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "cranesched_tpu_torch.craned.supervisor"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            cwd=self.workdir, env=env)
        cfored = ((step_spec.interactive_address
                   if step_spec and step_spec.interactive_address
                   else spec.interactive_address) or "")
        # "tls://[identity@]host:port" convention: the hub serves TLS,
        # so the supervisor must dial back with the cluster CA (which
        # rides this craned's --tls-ca; a TLS hub against a CA-less
        # craned fails the handshake — loudly, not silently
        # downgraded).  The optional identity@ prefix carries the
        # hub cert's issued name so the dial-back pins it (rejecting
        # other cluster certs that would validate via loopback SANs).
        cfored_tls = cfored.startswith("tls://")
        cfored_authority = ""
        if cfored_tls:
            cfored = cfored[len("tls://"):]
            if "@" in cfored:
                cfored_authority, cfored = cfored.split("@", 1)
        cfored_token = ((step_spec.interactive_token
                         if step_spec and step_spec.interactive_token
                         else spec.interactive_token) or "")
        use_pty = bool((step_spec.pty if step_spec else False)
                       or spec.pty)
        base = os.path.join(
            self._steps_dir,
            f"j{job_id}_s{step_id}_i{request.incarnation}")
        control_path = base + ".ctl"
        report_path = base + ".rpt"
        for stale in (control_path, report_path):
            try:
                os.unlink(stale)
            except OSError:
                pass
        try:
            os.mkfifo(control_path)
        except OSError:
            control_path = ""   # no FIFO support: stdin verbs only
        init = dict(
            job_id=job_id, step_id=step_id, script=script,
            output_path=output_path,
            time_limit=time_limit,
            env=step_env,
            cfored=cfored, cfored_token=cfored_token, pty=use_pty,
            prolog=self.prolog, epilog=self.epilog,
            cgroup_procs=alloc.procs_path,
            control_path=control_path, report_path=report_path,
            tls_ca=(self.tls.ca
                    if cfored_tls and self.tls is not None else ""),
            tls_authority=cfored_authority,
            # rank-0's rendezvous service serves with this node's
            # cluster cert when the cluster runs TLS: the per-gang
            # bearer token and modex payloads never ride plaintext
            # node-to-node (members dial with CRANE_RENDEZVOUS_CA)
            rendezvous_tls=(
                {"ca": self.tls.ca, "cert": self.tls.cert,
                 "key": self.tls.key}
                if rdzv_serve_port and self.tls is not None
                and self.tls.cert else None),
            container=self._container_doc(
                job_id, step_id, image, mounts, alloc,
                step_spec.res if step_spec and step_spec.HasField("res")
                else spec.res) if image else None,
            rendezvous_serve=rdzv_serve_port,
            rendezvous_token=request.rendezvous_token or "",
            x11=bool(step_spec.x11 if step_spec and step_spec.x11
                     else spec.x11),
            x11_cookie=(step_spec.x11_cookie
                        if step_spec and step_spec.x11_cookie
                        else spec.x11_cookie) or "")
        try:
            proc.stdin.write((json.dumps(init) + "\n").encode())
            proc.stdin.flush()
            ready = proc.stdout.readline().strip()
            if ready != b"READY":
                raise RuntimeError(
                    f"supervisor handshake failed: {ready!r}")
            proc.stdin.write(b"GO\n")
            proc.stdin.flush()
            _MET_SPAWN.observe(time.perf_counter() - t_spawn)
            self._trace_mark(job_id, request.incarnation, "step_start")
        except Exception:
            # every spawn failure must leak nothing: kill AND REAP the
            # process (a cgroup rmdir in the implicit-alloc teardown
            # races a dying member otherwise).  The alloc's GRES/cgroup
            # are rolled back by _maybe_teardown_alloc (implicit) or
            # kept for the allocation (explicit).
            proc.kill()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                pass
            raise
        step = _Step(job_id, proc, incarnation=request.incarnation,
                     step_id=step_id, control_path=control_path,
                     report_path=report_path)
        step.start_ticks = self._proc_start_ticks(proc.pid)
        with self._lock:
            existing = self._steps.get(key)
            # a slow stale spawn must not clobber an already-registered
            # NEWER incarnation (incarnations only grow); conversely,
            # registering over an older stale step evicts it
            stale_self = (existing is not None
                          and existing.incarnation > request.incarnation)
            if not stale_self:
                self._steps[key] = step
                self._persist_registry_locked()
            if self._spawning.get(key) == request.incarnation:
                self._spawning.pop(key, None)
            # consume a latched kill only if it was aimed at US (guarded
            # with our incarnation) or at whatever runs (wildcard None) —
            # a kill latched for a different concurrent spawn stays
            lat = self._pending_kills.get(key, "absent")
            killed_already = (not stale_self and lat != "absent"
                              and (lat is None
                                   or lat == request.incarnation))
            if killed_already:
                self._pending_kills.pop(key, None)
        if stale_self:
            # ctld has moved past this incarnation: kill our own spawn
            step.cancelled = True
            self._send_verb(step, "TERM")
        elif existing is not None:
            # we evicted an older registered step: kill it too (its
            # watcher sees the registry no longer points at it and will
            # neither pop our entry nor destroy the shared cgroup)
            existing.cancelled = True
            self._send_verb(existing, "TERM")
        if killed_already:
            step.cancelled = True
            self._send_verb(step, "TERM")
        if step_id == 0 and not stale_self:
            with self._lock:
                latched = self._pending_limits.pop(job_id, None)
                if (latched is not None and latched[1]
                        and latched[1] != request.incarnation):
                    latched = None   # stale: meant for another run
            if latched is not None:
                self._send_verb(step, f"LIMIT {latched[0]}")
        threading.Thread(target=self._watch_step, args=(step,),
                         daemon=True).start()

    def _assign_gres(self, spec, env: dict):
        """Pick concrete slot ids for the step's GRES request and inject
        vendor-style env (reference DeviceManager.h:26-51 maps vendors to
        CUDA_VISIBLE_DEVICES / HIP_VISIBLE_DEVICES / ...).  Returns the
        held slots, or None when the local pool cannot satisfy."""
        wanted = {gres_key_pair(key): count
                  for key, count in (spec.res.gres or {}).items()}
        if not wanted:
            return {}
        with self._lock:
            for pair, count in wanted.items():
                if len(self._gres_free.get(pair, ())) < count:
                    return None
            held = {}
            per_name: dict[str, list[int]] = {}
            for pair, count in sorted(wanted.items()):
                slots = [self._gres_free[pair].pop(0)
                         for _ in range(count)]
                held[pair] = slots
                name, typ = pair
                env[f"CRANE_GRES_{name.upper()}"
                    + (f"_{typ.upper()}" if typ else "")] = \
                    ",".join(map(str, slots))
                per_name.setdefault(name, []).extend(slots)
            if "gpu" in per_name:
                env["CUDA_VISIBLE_DEVICES"] = \
                    ",".join(map(str, sorted(per_name["gpu"])))
        return held

    def _release_gres(self, held: dict) -> None:
        with self._lock:
            for pair, slots in (held or {}).items():
                pool = self._gres_free.setdefault(pair, [])
                pool.extend(slots)
                pool.sort()

    def _assign_cores(self, cpu: float) -> tuple[int, ...]:
        """Whole-core cpuset pinning: an integral-cpu allocation takes
        concrete cores from the node pool (fractional requests share
        via quota only — the reference's fractional CpuSet mode).  An
        empty pool is NOT an error: quota still caps the job, pinning
        is an isolation upgrade, not a scheduling constraint."""
        n = int(cpu)
        if n < 1 or n != cpu or not self.cgroups.supports_cpuset:
            return ()
        with self._lock:
            if len(self._cores_free) < n:
                return ()
            cores = tuple(self._cores_free[:n])
            del self._cores_free[:n]
        return cores

    def _release_cores(self, cores) -> None:
        if not cores:
            return
        with self._lock:
            self._cores_free.extend(cores)
            self._cores_free.sort()

    def _container_doc(self, job_id: int, step_id: int, image: str,
                       mounts: list, alloc, res) -> dict:
        """Init-JSON container block.  The supervisor's cgroup holds
        only the runtime CLI (the workload lives under the runtime
        daemon), so the job's limits are RESTATED as runtime flags and
        its held GRES device nodes cross via --device — otherwise a
        container job gets env vars pointing at devices that don't
        exist inside, and no kernel limit at all."""
        devices = [path for pair, slots in alloc.gres_held.items()
                   for slot in slots
                   if (path := self._gres_slot_dev.get((pair, slot)))
                   is not None]
        return dict(
            runtime=self.container_runtime, image=image, mounts=mounts,
            name=f"crane-j{job_id}-s{step_id}",
            cpu=res.cpu or 0, mem_bytes=res.mem_bytes or 0,
            cpuset=alloc.env.get("CRANE_CPUSET", ""),
            devices=devices,
            cgroup_parent=(f"crane/job_{job_id}"
                           if self.cgroups.enabled else ""))

    def _device_rule(self, pair, slot: int) -> str | None:
        """'c MAJ:MIN rwm' for a held GRES slot's device node, from the
        configured device map (reference DeviceManager major:minor
        resolution for the cgroup ACL)."""
        path = self._gres_slot_dev.get((pair, slot))
        if path is None:
            return None
        import stat as _stat
        try:
            st = os.stat(path)
        except OSError:
            return None
        kind = "b" if _stat.S_ISBLK(st.st_mode) else "c"
        return (f"{kind} {os.major(st.st_rdev)}:"
                f"{os.minor(st.st_rdev)} rwm")

    def _watch_step(self, step: _Step) -> None:
        """SIGCHLD/reporting path (supervisor exit -> StepStatusChange)."""
        report = step.proc.stdout.readline().strip().decode()
        step.proc.wait()
        if self._crashed:
            # crash simulation only: a dead craned reports nothing and
            # must leave the durable registry intact for the next
            # incarnation to recover.  A GRACEFUL stop still reports
            # every step's terminal outcome.
            return
        self._finish_step(step, report)

    def _watch_adopted(self, step: _Step) -> None:
        """Watcher for a re-adopted supervisor (not our child): poll the
        durable report file and the pid until the outcome lands."""
        while not self._crashed:
            try:
                with open(step.report_path) as fh:
                    report = fh.read().strip()
                self._finish_step(step, report)
                return
            except OSError:
                pass
            if not self._pid_is_step(step):
                # died without a report; grace for an in-flight rename
                time.sleep(0.3)
                try:
                    with open(step.report_path) as fh:
                        report = fh.read().strip()
                except OSError:
                    report = ""
                if not self._crashed:
                    self._finish_step(step, report)
                return
            time.sleep(0.2)

    def _finish_step(self, step: _Step, report: str) -> None:
        # recovery can finish steps before registration completed; the
        # status change needs a node identity to be aggregated per-node
        while self.node_id is None and not self._stop.is_set():
            time.sleep(0.1)
        key = (step.job_id, step.step_id)
        with self._lock:
            # only clean up if the registry still points at OUR step — a
            # re-dispatched incarnation may have replaced the entry
            mine = self._steps.get(key) is step
            if mine:
                self._steps.pop(key, None)
                self._persist_registry_locked()
        for path in (step.control_path, step.report_path):
            if path:
                try:
                    os.unlink(path)
                except OSError:
                    pass
        if mine:
            # implicit allocations die with their last step; explicit
            # ones wait for FreeJob (their GRES/cgroup belong to the
            # allocation, not the step)
            self._maybe_teardown_alloc(step.job_id)
        # lifecycle-hook outcomes ride the report line: a failing
        # epilog is a suffix (job outcome unchanged, node drains); a
        # failing prolog is its own report (step failed before the user
        # command ran, node drains)
        hook_drain = ""
        # efficiency sample rides the report tail (strip FIRST: it is
        # always the last token group)
        cpu_seconds, max_rss = 0.0, 0
        m = re.search(r" USAGE cpu=([\d.]+) rss=(\d+)$", report)
        if m:
            cpu_seconds, max_rss = float(m.group(1)), int(m.group(2))
            report = report[: m.start()]
        if report.endswith(" EPILOGFAIL"):
            report = report[: -len(" EPILOGFAIL")]
            hook_drain = "epilog failed"
        if step.cancelled or report == "KILLED":
            status, code = "Cancelled", 130
        elif report == "TIMEOUT":
            status, code = "ExceedTimeLimit", 124
        elif report.startswith("PROLOGFAIL"):
            status, code = "Failed", 222
            hook_drain = "prolog failed"
        elif report.startswith("EXIT "):
            code = int(report.split()[1])
            status = "Completed" if code == 0 else "Failed"
        else:  # supervisor died without a report
            status, code = "Failed", 255
        if hook_drain and self.node_id is not None:
            # drain policy: report unhealthy so ctld stops placing work
            # here until the operator fixes the hook and RESUMES (cnode
            # resume clears it).  self.healthy is deliberately NOT
            # touched: the periodic health program's state machine only
            # reports on its OWN transitions, so a passing probe cannot
            # auto-undrain a hook-failure drain.
            try:
                self._ctld.craned_health(self.node_id, False,
                                         hook_drain)
            except (grpc.RpcError, ValueError):
                pass
        try:
            self._ctld.step_status_change(step.job_id, status, code,
                                          time.time(),
                                          node_id=self.node_id
                                          if self.node_id is not None
                                          else -1,
                                          incarnation=step.incarnation,
                                          step_id=step.step_id,
                                          cpu_seconds=cpu_seconds,
                                          max_rss_bytes=max_rss,
                                          spans=self._trace_take(
                                              step.job_id,
                                              step.incarnation))
        except (grpc.RpcError, ValueError):
            pass  # ctld down / client closed: the ping timeout + WAL
                  # reconcile at re-registration

    # ---- durable step registry + re-adoption ----

    @staticmethod
    def _proc_start_ticks(pid: int) -> int | None:
        """The process's starttime (clock ticks since boot, stat field
        22) — the standard PID-reuse disambiguator."""
        try:
            with open(f"/proc/{pid}/stat", "rb") as fh:
                data = fh.read().decode("latin-1")
            rest = data.rsplit(")", 1)[1].split()
            return int(rest[19])
        except (OSError, IndexError, ValueError):
            return None

    def _pid_is_step(self, step: _Step) -> bool:
        """Is step.pid alive AND the same process we recorded?  A
        recycled pid (or an EPERM from someone else's process with that
        pid) must read as dead, not as our supervisor."""
        if step.pid <= 0:
            return False
        try:
            os.kill(step.pid, 0)
        except ProcessLookupError:
            return False
        except PermissionError:
            return False   # someone else's process: not our supervisor
        except OSError:
            return False
        if step.start_ticks is None:
            return True    # pre-upgrade registry row: best effort
        return self._proc_start_ticks(step.pid) == step.start_ticks

    def _persist_registry_locked(self) -> None:
        """Rewrite the registry to match self._steps + self._allocs
        (caller holds the lock).  Tiny file, atomic rename — a torn
        write can never be loaded.  Allocations persist too so a
        restarted craned re-deducts their GRES slots and pinned cores
        from the pools — otherwise a re-adopted job's kernel pins
        alias the resources handed to the next dispatch."""
        rows = [dict(job_id=s.job_id, step_id=s.step_id,
                     incarnation=s.incarnation, pid=s.pid,
                     start_ticks=s.start_ticks,
                     control=s.control_path, report=s.report_path,
                     cancelled=s.cancelled)
                for s in self._steps.values()]
        allocs = [dict(job_id=a.job_id, incarnation=a.incarnation,
                       gres={gres_key_str(pair): slots
                             for pair, slots in a.gres_held.items()},
                       cores=list(a.cores_held),
                       procs=a.procs_path, env=a.env,
                       implicit=a.implicit, user=a.user)
                  for a in self._allocs.values()]
        tmp = self._registry_path + ".tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as fh:
                json.dump({"steps": rows, "allocs": allocs}, fh)
            os.replace(tmp, self._registry_path)
        except OSError:
            pass

    def _recover_steps(self) -> None:
        """Re-adopt supervisors that survived a craned restart
        (reference Craned.cpp:1345-1449): live pids get an adopted
        watcher (control via FIFO); finished ones report their durable
        outcome; vanished ones report Failed.  Runs BEFORE registration
        so the re-register reconcile sees these steps as present."""
        try:
            with open(self._registry_path, encoding="utf-8") as fh:
                doc = json.load(fh)
        except (OSError, json.JSONDecodeError, ValueError):
            return
        # pre-alloc-persistence registries were a bare step list
        rows = doc if isinstance(doc, list) else doc.get("steps", [])
        for arow in ([] if isinstance(doc, list)
                     else doc.get("allocs", [])):
            alloc = _Alloc(
                int(arow["job_id"]), int(arow.get("incarnation", 0)),
                {gres_key_pair(k): list(v)
                 for k, v in (arow.get("gres") or {}).items()},
                arow.get("env") or {}, arow.get("procs"),
                bool(arow.get("implicit", True)),
                cores_held=tuple(arow.get("cores") or ()),
                user=arow.get("user", ""))
            with self._lock:
                self._allocs[alloc.job_id] = alloc
                # re-deduct from the pools (ignore already-missing
                # entries: the pool was rebuilt fresh at __init__)
                for pair, slots in alloc.gres_held.items():
                    pool = self._gres_free.get(pair, [])
                    for slot in slots:
                        if slot in pool:
                            pool.remove(slot)
                for core in alloc.cores_held:
                    if core in self._cores_free:
                        self._cores_free.remove(core)
        finished = []
        for row in rows:
            step = _Step(int(row["job_id"]), None,
                         incarnation=int(row.get("incarnation", 0)),
                         step_id=int(row.get("step_id", 0)),
                         control_path=row.get("control", ""),
                         report_path=row.get("report", ""),
                         pid=int(row.get("pid", 0)))
            step.cancelled = bool(row.get("cancelled", False))
            ticks = row.get("start_ticks")
            step.start_ticks = int(ticks) if ticks is not None else None
            alive = self._pid_is_step(step)
            has_report = step.report_path and os.path.exists(
                step.report_path)
            if alive or has_report:
                with self._lock:
                    self._steps[(step.job_id, step.step_id)] = step
                if alive and not has_report:
                    threading.Thread(target=self._watch_adopted,
                                     args=(step,), daemon=True).start()
                else:
                    finished.append(step)
            else:
                # no pid, no report: the outcome is unrecoverable
                finished.append(step)
        with self._lock:
            self._persist_registry_locked()
        for step in finished:
            report = ""
            if step.report_path:
                try:
                    with open(step.report_path) as fh:
                        report = fh.read().strip()
                except OSError:
                    report = ""
            threading.Thread(target=self._finish_step,
                             args=(step, report), daemon=True).start()

    # ---- ssh-to-node gate (the CranedForPam surface) ----
    #
    # Reference: CranedForPamServer over a unix socket
    # (Crane.proto:1671-1677) consumed by the PAM module
    # (src/Misc/Pam/Pam.cpp:37-112 — account phase: allow ssh only if
    # the user has a job here; session phase: migrate the sshd process
    # into the job's cgroup).  The wire here is a newline protocol a
    # dependency-free C client (native/pam_crane.c) can speak:
    #
    #   ACCESS <user>\n        -> OK <job_id> | DENY <reason>
    #   ADOPT <user> <pid>\n   -> OK <job_id> (+ ENV K=V lines + END)

    def _pam_find_alloc(self, user: str):
        with self._lock:
            allocs = [a for a in self._allocs.values()
                      if a.user == user]
        # newest allocation wins (the reference adopts into the most
        # recent job when several qualify)
        return max(allocs, key=lambda a: a.job_id, default=None)

    def _pam_handle(self, line: str) -> str:
        parts = line.split()
        if len(parts) >= 2 and parts[0] == "ACCESS":
            alloc = self._pam_find_alloc(parts[1])
            if alloc is None:
                return f"DENY no running job of {parts[1]} here\n"
            return f"OK {alloc.job_id}\n"
        if len(parts) >= 3 and parts[0] == "ADOPT":
            alloc = self._pam_find_alloc(parts[1])
            if alloc is None:
                return f"DENY no running job of {parts[1]} here\n"
            try:
                pid = int(parts[2])
            except ValueError:
                return "DENY bad pid\n"
            if not write_pid_to_cgroup(alloc.procs_path, pid):
                # cgroup unavailable = access still granted, but the
                # best-effort fallback is no longer silent: the gap
                # lands in the node's structured event log (and the
                # daemon log) so containment drills can assert on it
                self.events.emit(
                    "cgroup_adopt_fallback", "warning",
                    node=self.name, job_id=alloc.job_id,
                    detail=f"pid {pid} adopted into job "
                           f"{alloc.job_id} without cgroup "
                           "containment (cgroupfs unavailable)")
                logging.getLogger("cranesched.craned").warning(
                    "PAM ADOPT: pid %d joined job %d WITHOUT cgroup "
                    "containment (no writable cgroup.procs)",
                    pid, alloc.job_id)
            out = [f"OK {alloc.job_id}\n"]
            for key, value in sorted(alloc.env.items()):
                # the frame is newline-delimited: an env value carrying
                # a newline (user-chosen job names reach CRANE_JOB_NAME)
                # must not forge protocol lines
                if any(c in key or c in str(value)
                       for c in ("\n", "\r")):
                    continue
                out.append(f"ENV {key}={value}\n")
            out.append("END\n")
            return "".join(out)
        return "DENY bad request\n"

    def _pam_serve_conn(self, conn) -> None:
        import socket as _socket
        try:
            conn.settimeout(5.0)
            data = b""
            while not data.endswith(b"\n") and len(data) < 4096:
                chunk = conn.recv(256)
                if not chunk:
                    break
                data += chunk
            reply = self._pam_handle(
                data.decode("utf-8", "replace").strip())
            conn.sendall(reply.encode())
        except (OSError, _socket.timeout):
            pass
        finally:
            conn.close()

    def _pam_loop(self, sock) -> None:
        # thread per connection: one stalled client must not
        # head-of-line-block every ssh login on the node
        while not self._stop.is_set():
            try:
                conn, _ = sock.accept()
            except OSError:
                # transient accept failures (EMFILE bursts) must not
                # kill the gate — the fail-closed client would then
                # deny every ssh until craned restarts.  Only a closed
                # socket (shutdown) ends the loop.
                if self._stop.is_set() or sock.fileno() < 0:
                    return
                time.sleep(0.2)
                continue
            threading.Thread(target=self._pam_serve_conn,
                             args=(conn,), daemon=True).start()

    def _start_pam_socket(self) -> str | None:
        import socket as _socket
        path = os.path.join(self._steps_dir, "pam.sock")
        try:
            os.unlink(path)
        except OSError:
            pass
        try:
            sock = _socket.socket(_socket.AF_UNIX,
                                  _socket.SOCK_STREAM)
            sock.bind(path)
            # root-only: sshd's PAM stack runs as root; users must not
            # probe who runs what through this side door
            os.chmod(path, 0o600)
            sock.listen(8)
        except OSError:
            return None
        self._pam_sock = sock
        threading.Thread(target=self._pam_loop, args=(sock,),
                         daemon=True).start()
        # best-effort well-known alias (the C client's DEFAULT_SOCKET):
        # daemon deployments (craned_main) get a stable path without
        # socket= config; embedded/test daemons never touch /var/run
        if self.pam_alias:
            alias = "/var/run/crane/pam.sock"
            try:
                os.makedirs(os.path.dirname(alias), exist_ok=True)
                if os.path.islink(alias) or os.path.exists(alias):
                    os.unlink(alias)
                os.symlink(path, alias)
            except OSError:
                pass
        return path

    # ---- lifecycle: serve + register + ping ----

    _RPCS = {
        "AllocJob": (pb.ExecuteStepRequest, pb.OkReply),
        "ExecuteStep": (pb.ExecuteStepRequest, pb.OkReply),
        "TerminateStep": (pb.JobIdRequest, pb.OkReply),
        "FreeJob": (pb.JobIdRequest, pb.OkReply),
        "SuspendStep": (pb.JobIdRequest, pb.OkReply),
        "ResumeStep": (pb.JobIdRequest, pb.OkReply),
        "ChangeTimeLimit": (pb.TimeLimitRequest, pb.OkReply),
    }

    @property
    def state(self) -> CranedState:
        return self._state

    @state.setter
    def state(self, value: CranedState) -> None:
        # every FSM transition lands in the gauge, so a flapping node
        # is visible from /metrics without log spelunking
        self._state = value
        _MET_STATE.set(_STATE_ORD.get(value, -1), node=self.name)

    def start(self, address: str = "127.0.0.1:0") -> int:
        handlers = {
            name: grpc.unary_unary_rpc_method_handler(
                getattr(self, name),
                request_deserializer=req.FromString,
                response_serializer=reply.SerializeToString)
            for name, (req, reply) in self._RPCS.items()
        }
        from cranesched_tpu_torch.rpc.interceptors import MetricsInterceptor
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=4),
            interceptors=(MetricsInterceptor(plane="craned"),))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(CRANED_SERVICE,
                                                  handlers),))
        if self.tls is not None and self.tls.cert:
            import dataclasses as _dc

            from cranesched_tpu_torch.utils.pki import server_credentials
            # the push surface takes orders (ExecuteStep/Terminate/
            # Free): under TLS it always demands a cluster-CA client
            # cert, or any network peer could drive jobs on this node
            # directly, bypassing the ctld's auth entirely (the ctld
            # dispatcher presents its cert)
            port = self._server.add_secure_port(
                address, server_credentials(
                    _dc.replace(self.tls, require_client_cert=True)))
        else:
            port = self._server.add_insecure_port(address)
        self._server.start()
        self.address = f"127.0.0.1:{port}"
        # recovery BEFORE the registration FSM: re-adopted steps must be
        # in the registry when the re-register reconcile runs, or the
        # expectations exchange would treat them as dead
        self._recover_steps()
        self.pam_socket = self._start_pam_socket()
        if self.metrics_port is not None:
            from cranesched_tpu_torch.obs import serve_metrics
            self._metrics_server = serve_metrics(self.metrics_port)
            self.metrics_port = self._metrics_server.server_address[1]
        threading.Thread(target=self._fsm_loop, daemon=True).start()
        if self.health_program:
            threading.Thread(target=self._health_loop,
                             daemon=True).start()
        return port

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_interval):
            if self.state != CranedState.READY or self.node_id is None:
                continue
            try:
                result = subprocess.run(
                    ["bash", "-c", self.health_program],
                    capture_output=True, text=True, timeout=60)
                healthy = result.returncode == 0
                message = (result.stdout or result.stderr).strip()[:200]
            except (OSError, subprocess.SubprocessError) as exc:
                healthy, message = False, str(exc)[:200]
            if healthy != self.healthy:
                try:
                    self._ctld.craned_health(self.node_id, healthy,
                                             message)
                    # only acknowledge the transition once the ctld has
                    # it — a lost report retries next interval
                    self.healthy = healthy
                except (grpc.RpcError, ValueError):
                    pass

    def _register(self) -> bool:
        try:
            total = pb.ResourceSpec(cpu=self.cpu,
                                    mem_bytes=self.mem_bytes,
                                    memsw_bytes=self.mem_bytes)
            for pair, count in self.gres.items():
                total.gres[gres_key_str(pair)] = count
            reply = self._ctld._call(
                "CranedRegister",
                pb.CranedRegisterRequest(
                    name=self.name, total=total,
                    partitions=list(self.partitions),
                    address=self.address),
                pb.CranedRegisterReply)
        except grpc.RpcError:
            return False
        if not reply.ok and reply.error:
            # surface the refusal reason once per change — without this
            # an auth-misconfigured craned retries forever silently
            if reply.error != getattr(self, "_last_refusal", None):
                self._last_refusal = reply.error
                print(f"craned {self.name}: registration refused: "
                      f"{reply.error}", file=sys.stderr, flush=True)
        if reply.ok:
            self.node_id = reply.node_id
            # learn the ctld's fencing epoch (only ever upward: a
            # stale leader answering the register must not lower it)
            with self._lock:
                if reply.fencing_epoch > self._fencing_epoch:
                    self._fencing_epoch = reply.fencing_epoch
            # kill stale local steps ctld no longer expects (reference
            # Configure expectations: ctld tells the craned what should
            # be running; anything else died with our old registration)
            expected = set(reply.expected_jobs)
            with self._lock:
                stale = [s for (j, _), s in self._steps.items()
                         if j not in expected]
                stale_allocs = [j for j in self._allocs
                                if j not in expected]
                for j in stale_allocs:
                    # mark for teardown once the stale steps die
                    self._allocs[j].implicit = True
            for step in stale:
                step.cancelled = True
                self._send_verb(step, "TERM")
            for j in stale_allocs:
                self._maybe_teardown_alloc(j)
            return True
        return False

    def _fsm_loop(self) -> None:
        """Registration/ping FSM (reference CtldClient.h:90:
        Disconnected → ... → Ready; ping misses reconnect)."""
        while not self._stop.is_set():
            if self.state != CranedState.READY:
                self.state = CranedState.REGISTERING
                t0 = time.perf_counter()
                registered = self._register()
                _MET_CTLD_RTT.observe(time.perf_counter() - t0,
                                      op="register")
                if registered:
                    self.state = CranedState.READY
                else:
                    self.state = CranedState.DISCONNECTED
                    self._stop.wait(self.ping_interval)
                    continue
            if self._stop.wait(self.ping_interval):
                return
            t0 = time.perf_counter()
            try:
                ok = self._ctld.craned_ping(self.node_id).ok
            except grpc.RpcError:
                ok = False
            rtt = time.perf_counter() - t0
            _MET_CTLD_RTT.observe(rtt, op="ping")
            if ok:
                self._last_rtt = rtt
            if not ok:
                self.state = CranedState.DISCONNECTED

    def stop(self, graceful: bool = True,
             orphan_supervisors: bool = False) -> None:
        """graceful=False mimics a node crash: no kills, no reports —
        ctld must detect the death via missed pings.
        orphan_supervisors leaves the supervisor processes RUNNING (the
        realistic craned-crash shape: supervisors are separate
        processes), so a new daemon on the same workdir can re-adopt
        them."""
        self._stop.set()
        if getattr(self, "_pam_sock", None) is not None:
            try:
                self._pam_sock.close()
            except OSError:
                pass
        if not graceful:
            self._crashed = True
            self._ctld.close()   # closed first: no report can escape
        with self._lock:
            steps = list(self._steps.values())
        for step in steps:
            if graceful:
                self._send_verb(step, "TERM")
            elif step.proc is not None and not orphan_supervisors:
                step.proc.kill()  # crash simulation: the user workload
                                  # is deliberately orphaned
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server = None
        if self._server is not None:
            self._server.stop(grace=0.5)
        if graceful:
            self._ctld.close()
