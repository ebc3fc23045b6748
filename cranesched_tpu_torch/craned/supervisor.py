"""csupervisor: one process per job step (run as
``python -m cranesched_tpu_torch.craned.supervisor``).

Mirrors the reference's Supervisor process (reference:
src/Craned/Supervisor/Supervisor.cpp:34 InitFromStdin — config arrives on
the stdin pipe after a fork handshake; TaskManager owns the user process,
its termination/deadline timers and status propagation,
TaskManager.h:541-784).  Protocol here:

  stdin   <- one JSON line: {job_id, script, output_path, time_limit,
             env, cgroup_procs?}
  stdout  -> "READY"                 (handshake: ChildProcessReady analog)
  stdin   <- "GO" | control verbs: "TERM", "STOP", "CONT"
  stdout  -> "EXIT <code>" | "TIMEOUT" | "KILLED"

The user command runs as ``bash -c script`` in its own session so control
verbs signal the whole process group without touching the supervisor
(the reference freezes/kills via cgroups for the same isolation).
Suspended wall time extends the deadline (time-limit credit,
reference JobScheduler.cpp:118-126).

The port's copy of ``cranesched_tpu/craned/supervisor.py``,
with the port's imports.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time


def _substitute(pattern: str, job_id: int) -> str:
    return pattern.replace("%j", str(job_id))


def _run_hook(script: str, env: dict, out_fh=None) -> int:
    """Run a prolog/epilog script with SAFE fds: stdin closed and
    stdout/stderr to the step's output file (or devnull) — NEVER the
    supervisor's own stdout/stdin, which are the one-line report pipe
    and the control-verb pipe (a chatty hook would corrupt both)."""
    sink = out_fh if out_fh is not None else subprocess.DEVNULL
    return subprocess.run(["bash", "-c", script], env=env,
                          stdin=subprocess.DEVNULL, stdout=sink,
                          stderr=sink).returncode


class _InteractiveIO:
    """Streams the child's stdout/stderr to the client's embedded
    CraneFored service and feeds stdin back (the reference's
    CforedClient role, CforedClient.h:28-95).

    Ordering contract: the final ``exited`` chunk is enqueued only
    after BOTH output readers hit EOF, so the client provably receives
    every output byte before the exit status (CforedClient.h:60-63)."""

    def __init__(self, address: str, job_id: int, step_id: int,
                 use_pty: bool, token: str = "", tls_ca: str = "",
                 tls_authority: str = ""):
        self.address = address
        self.job_id = job_id
        self.step_id = step_id
        self.use_pty = use_pty
        self.token = token
        # cluster CA path: when set, the dial-back to the cfored hub is
        # TLS-verified (the stream token never travels plaintext).
        # tls_authority pins the hub cert's issued name — without it,
        # ANY cluster-issued cert validates as the hub on loopback
        # hosts (every cert carries localhost SANs)
        self.tls_ca = tls_ca
        self.tls_authority = tls_authority
        self._q: queue.Queue = queue.Queue()
        self._readers: list[threading.Thread] = []
        self._call = None
        self._child = None
        self._pty_master = None

    def spawn(self, argv: list, env: dict) -> subprocess.Popen:
        if self.use_pty:
            import pty
            master, slave = pty.openpty()
            self._pty_master = master
            child = subprocess.Popen(
                argv, stdin=slave, stdout=slave,
                stderr=slave, env=env, start_new_session=True)
            os.close(slave)
            t = threading.Thread(target=self._read_fd,
                                 args=(master, "out"), daemon=True)
            t.start()
            self._readers = [t]
        else:
            child = subprocess.Popen(
                argv, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                env=env, start_new_session=True)
            self._readers = [
                threading.Thread(target=self._read_pipe,
                                 args=(child.stdout, "out"), daemon=True),
                threading.Thread(target=self._read_pipe,
                                 args=(child.stderr, "err"), daemon=True),
            ]
            for t in self._readers:
                t.start()
        self._child = child
        self._connect()
        return child

    def _read_pipe(self, fh, name: str) -> None:
        for chunk in iter(lambda: fh.read1(65536), b""):
            self._q.put((name, chunk))

    def _read_fd(self, fd: int, name: str) -> None:
        while True:
            try:
                chunk = os.read(fd, 65536)
            except OSError:   # EIO at pty EOF
                return
            if not chunk:
                return
            self._q.put((name, chunk))

    def _connect(self) -> None:
        import grpc
        from cranesched_tpu_torch.rpc import crane_pb2 as pb
        from cranesched_tpu_torch.rpc.consts import CFORED_SERVICE

        if self.tls_ca:
            from cranesched_tpu_torch.utils.pki import (TlsConfig,
                                                  secure_channel)
            tls = TlsConfig(ca=self.tls_ca)
            if self.tls_authority:
                tls = tls.pinned(self.tls_authority)
            channel = secure_channel(self.address, tls)
        else:
            channel = grpc.insecure_channel(self.address)

        def requests():
            # the header presents the per-submission stream secret —
            # the hub rejects streams that cannot (anyone reaching the
            # client's port could otherwise claim the session)
            yield pb.StepIOChunk(job_id=self.job_id,
                                 step_id=self.step_id,
                                 token=self.token)
            while True:
                item = self._q.get()
                if item is None:
                    return
                if isinstance(item, tuple):
                    name, data = item
                    yield pb.StepIOChunk(job_id=self.job_id,
                                         step_id=self.step_id,
                                         stream=name, data=data)
                else:  # the final exited chunk
                    yield item
                    return

        self._call = channel.stream_stream(
            f"/{CFORED_SERVICE}/StepIO",
            request_serializer=pb.StepIOChunk.SerializeToString,
            response_deserializer=pb.StepIOChunk.FromString)(requests())

        def stdin_loop():
            import grpc as _grpc
            try:
                for chunk in self._call:
                    if chunk.stdin_eof:
                        self._close_stdin()
                    elif chunk.data:
                        self._write_stdin(chunk.data)
            except _grpc.RpcError:
                pass

        threading.Thread(target=stdin_loop, daemon=True).start()

    def _write_stdin(self, data: bytes) -> None:
        try:
            if self._pty_master is not None:
                os.write(self._pty_master, data)
            elif self._child and self._child.stdin:
                self._child.stdin.write(data)
                self._child.stdin.flush()
        except (BrokenPipeError, OSError, ValueError):
            pass

    def _close_stdin(self) -> None:
        try:
            if self._pty_master is not None:
                os.write(self._pty_master, b"\x04")  # EOT on the pty
            elif self._child and self._child.stdin:
                self._child.stdin.close()
        except (BrokenPipeError, OSError, ValueError):
            pass

    def finish(self, exit_code: int) -> None:
        """Drain the readers, then send the exited chunk.

        The join has a short grace rather than waiting for pipe EOF
        unconditionally: a backgrounded grandchild that inherited the
        pipes would otherwise stall every such step for the full
        timeout.  Ordering therefore covers all output written by the
        step before it exited (plus the grace window); output a
        detached grandchild produces later is dropped — the same
        boundary the reference draws by killing the step's cgroup."""
        from cranesched_tpu_torch.rpc import crane_pb2 as pb
        deadline = time.monotonic() + 2.0
        for t in self._readers:
            t.join(timeout=max(deadline - time.monotonic(), 0.05))
        self._q.put(pb.StepIOChunk(job_id=self.job_id,
                                   step_id=self.step_id, exited=True,
                                   exit_code=exit_code))
        if self._call is not None:
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline and not self._call.done():
                time.sleep(0.05)


class _X11Forwarder:
    """X11 forwarding for interactive steps (reference
    SetupX11forwarding_, CforedClient.h:29-66): a DISPLAY listener on
    the compute node; every accepted X connection becomes its own
    StepIO stream (first chunk stream="x11") that the client-side hub
    relays to the user's real X display.  The cookie (xauth list
    output) is installed into a job-private XAUTHORITY so job-side
    clients authenticate against the relayed display."""

    def __init__(self, address: str, job_id: int, step_id: int,
                 token: str, tls_ca: str = "", tls_authority: str = ""):
        import socket as _socket
        self.address = address
        self.job_id = job_id
        self.step_id = step_id
        self.token = token
        self.tls_ca = tls_ca
        self.tls_authority = tls_authority
        # probe conventional display ports (X display N <=> TCP
        # 6000+N) like real X servers do — deriving N from an
        # arbitrary ephemeral port can go negative on hosts with a
        # lowered ip_local_port_range
        self._sock = None
        for n in range(20, 220):
            s = _socket.socket()
            try:
                s.bind(("127.0.0.1", 6000 + n))
            except OSError:
                s.close()
                continue
            s.listen(16)
            self._sock = s
            self.port = 6000 + n
            self.display = f"127.0.0.1:{n}"
            break
        if self._sock is None:
            raise OSError("no free X display port in 6020-6219")
        self._conn_id = 0
        self._channel = None

    def start(self) -> None:
        threading.Thread(target=self._accept_loop,
                         daemon=True).start()

    def _grpc_channel(self):
        import grpc
        if self._channel is None:
            if self.tls_ca:
                from cranesched_tpu_torch.utils.pki import (TlsConfig,
                                                      secure_channel)
                tls = TlsConfig(ca=self.tls_ca)
                if self.tls_authority:
                    tls = tls.pinned(self.tls_authority)
                self._channel = secure_channel(self.address, tls)
            else:
                self._channel = grpc.insecure_channel(self.address)
        return self._channel

    def _accept_loop(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            self._conn_id += 1
            threading.Thread(target=self._relay,
                             args=(conn, self._conn_id),
                             daemon=True).start()

    def _relay(self, conn, conn_id: int) -> None:
        import queue as _queue

        import grpc
        from cranesched_tpu_torch.rpc import crane_pb2 as pb
        from cranesched_tpu_torch.rpc.consts import CFORED_SERVICE

        sendq: _queue.Queue = _queue.Queue()
        sendq.put(pb.StepIOChunk(job_id=self.job_id,
                                 step_id=self.step_id,
                                 token=self.token, stream="x11",
                                 x11_conn=conn_id))

        def requests():
            while True:
                item = sendq.get()
                if item is None:
                    return
                yield item

        def pump_to_hub():
            try:
                while data := conn.recv(65536):
                    sendq.put(pb.StepIOChunk(data=data))
            except OSError:
                pass
            finally:
                sendq.put(None)

        stub = self._grpc_channel().stream_stream(
            f"/{CFORED_SERVICE}/StepIO",
            request_serializer=lambda m: m.SerializeToString(),
            response_deserializer=pb.StepIOChunk.FromString)
        call = stub(requests())
        threading.Thread(target=pump_to_hub, daemon=True).start()
        try:
            for chunk in call:
                if chunk.data:
                    conn.sendall(chunk.data)
                if chunk.exited:
                    break
        except (grpc.RpcError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def install_cookie(self, cookie: str, env: dict,
                       workdir: str) -> None:
        """xauth add the user's cookie for the relayed display into a
        job-private authority file (best-effort: no xauth binary =
        cookie-less display, servers in open mode still work)."""
        if not cookie:
            return
        import shutil
        if shutil.which("xauth") is None:
            return
        xauth_file = os.path.join(
            workdir, f".crane_xauth_{self.job_id}_{self.step_id}")
        env["XAUTHORITY"] = xauth_file
        parts = cookie.split()
        # accept both "proto hexkey" and full "display proto hexkey"
        proto, hexkey = (parts[-2], parts[-1]) if len(parts) >= 2 \
            else ("MIT-MAGIC-COOKIE-1", parts[0])
        try:
            subprocess.run(
                ["xauth", "-f", xauth_file, "add", self.display,
                 proto, hexkey],
                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                timeout=15, check=False)
        except (OSError, subprocess.SubprocessError):
            pass   # cookie install is best-effort by contract

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass


def _child_argv(script: str, env: dict, container: dict | None,
                interactive: bool = False, pty: bool = False) -> list:
    """argv of the step's child: plain ``bash -c`` for process steps,
    or the OCI runtime command for container steps (the reference's
    ProcInstance vs ContainerInstance split, TaskManager.h:293-466).

    podman and docker share this verb surface.  The job's CRANE_* env
    and accelerator-visibility vars cross the boundary explicitly
    (--env); everything else in the supervisor env stays on the host
    side.

    Isolation composition: the supervisor's cgroup holds only the
    runtime CLI — the container workload lives under the runtime
    daemon's cgroup — so the job's limits are restated as runtime
    flags (--cpus/--memory/--cpuset-cpus, --cgroup-parent where the
    driver honors it) and the job's held GRES device nodes cross via
    --device (env vars alone would point at nodes absent from the
    container)."""
    if not container or not container.get("image"):
        return ["bash", "-c", script]
    argv = [container["runtime"], "run", "--rm",
            "--name", container["name"]]
    if interactive:
        argv.append("-i")
        if pty:
            argv.append("-t")
    if container.get("cpu"):
        argv.append(f"--cpus={container['cpu']}")
    if container.get("mem_bytes"):
        argv.append(f"--memory={int(container['mem_bytes'])}b")
    if container.get("cpuset"):
        argv.append(f"--cpuset-cpus={container['cpuset']}")
    if container.get("cgroup_parent"):
        argv.append(f"--cgroup-parent={container['cgroup_parent']}")
    for dev in container.get("devices") or ():
        argv += ["--device", dev]
    for mount in container.get("mounts") or ():
        argv += ["-v", mount]
    for key in sorted(env):
        if key.startswith("CRANE_") or key.endswith("_VISIBLE_DEVICES")\
                or key.startswith("ASCEND_RT_"):
            argv += ["--env", f"{key}={env[key]}"]
    argv += [container["image"], "bash", "-c", script]
    return argv


def _container_rm(container: dict | None) -> None:
    """Force-remove the step's named container (idempotent).  Called
    before run (a stale same-name container from a previous
    incarnation blocks the new one) and on every kill path: killing
    the runtime CLI's process group does NOT kill the container —
    dockerd owns it, and conmon setsids away — so the workload would
    survive on resources the craned already freed."""
    if not container or not container.get("image"):
        return
    try:
        subprocess.run(
            [container["runtime"], "rm", "-f", container["name"]],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        pass


def main() -> int:
    init = json.loads(sys.stdin.readline())
    job_id = init["job_id"]
    script = init.get("script") or "true"
    time_limit = float(init.get("time_limit") or 0) or None
    env = dict(os.environ, **(init.get("env") or {}),
               CRANE_JOB_ID=str(job_id))

    interactive = None
    if init.get("cfored"):
        interactive = _InteractiveIO(
            init["cfored"], job_id,
            int(init.get("step_id") or 0),
            bool(init.get("pty")),
            token=init.get("cfored_token") or "",
            tls_ca=init.get("tls_ca") or "",
            tls_authority=init.get("tls_authority") or "")

    print("READY", flush=True)
    go = sys.stdin.readline().strip()
    if go != "GO":
        return 1

    def report(line: str) -> None:
        """Terminal report: the stdout line feeds the live craned's
        watcher; the report FILE (atomic rename) survives a craned
        restart so a new incarnation can recover the outcome."""
        rp = init.get("report_path") or ""
        if rp:
            try:
                with open(rp + ".tmp", "w") as fh:
                    fh.write(line + "\n")
                os.replace(rp + ".tmp", rp)
            except OSError:
                pass
        print(line, flush=True)

    out = None
    if interactive is None:
        out_path = _substitute(init.get("output_path") or "/dev/null",
                               job_id)
        if out_path != "/dev/null":
            os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        out = open(out_path, "ab", buffering=0)

    # task prolog (reference RunPrologOrEpiLog + config.yaml:121-133):
    # runs with the step's env BEFORE the user command; a failing
    # prolog fails the step with a distinguishable report so the craned
    # can apply the drain policy (a broken node setup must not eat the
    # whole queue job by job)
    prolog = init.get("prolog") or ""
    if prolog:
        rc = _run_hook(prolog, env, out)
        if rc != 0:
            report(f"PROLOGFAIL {rc}")
            return 0

    # rank-0 of a multi-node gang hosts the fence/modex service at the
    # advertised rendezvous port (the PMIx-server role, Pmix.h:44).
    # Lives and dies with this supervisor; a bind failure (port taken
    # on this host) degrades to no service — members' fences then time
    # out with a legible error rather than hanging forever
    rdzv = None
    if init.get("rendezvous_serve"):
        from cranesched_tpu_torch.rpc.rendezvous import RendezvousServer
        rdzv_tls = None
        if init.get("rendezvous_tls"):
            from cranesched_tpu_torch.utils.pki import TlsConfig
            rdzv_tls = TlsConfig(**init["rendezvous_tls"])
        rdzv = RendezvousServer(
            token=init.get("rendezvous_token") or "",
            nranks=int(env.get("CRANE_NNODES") or 1),
            tls=rdzv_tls)
        try:
            rdzv.start(f"0.0.0.0:{init['rendezvous_serve']}")
        except Exception as exc:
            print(f"rendezvous bind failed: {exc}", file=sys.stderr)
            rdzv = None

    x11 = None
    if init.get("x11") and init.get("cfored"):
        try:
            x11 = _X11Forwarder(
                init["cfored"], job_id,
                int(init.get("step_id") or 0),
                token=init.get("cfored_token") or "",
                tls_ca=init.get("tls_ca") or "",
                tls_authority=init.get("tls_authority") or "")
            x11.install_cookie(init.get("x11_cookie") or "", env,
                               os.getcwd())
            env["DISPLAY"] = x11.display
            x11.start()
        except OSError as exc:
            print(f"x11 forwarding unavailable: {exc}",
                  file=sys.stderr)
            x11 = None

    container = init.get("container")
    argv = _child_argv(script, env, container,
                       interactive=interactive is not None,
                       pty=bool(init.get("pty")))
    _container_rm(container)  # stale same-name container blocks run
    if interactive is not None:
        child = interactive.spawn(argv, env)
    else:
        child = subprocess.Popen(
            argv, stdout=out, stderr=out, env=env,
            start_new_session=True)
    # optional cgroup attachment (the craned pre-created the cgroup
    # and passed its cgroup.procs path(s); best-effort when cgroupfs
    # is unavailable)
    from cranesched_tpu_torch.craned.cgroup import write_pid_to_cgroup
    write_pid_to_cgroup(init.get("cgroup_procs"), child.pid)

    state = {"suspended_at": None, "suspended_total": 0.0,
             "terminated": False, "time_limit": time_limit}
    start = time.monotonic()

    def handle_verb(verb: str) -> None:
        try:
            if verb == "TERM":
                state["terminated"] = True
                os.killpg(child.pid, signal.SIGTERM)

                def _escalate():
                    if child.poll() is None:
                        os.killpg(child.pid, signal.SIGKILL)
                    # the container outlives its CLI (dockerd/conmon
                    # own it): remove it or the workload survives on
                    # freed resources and the name blocks re-dispatch
                    _container_rm(container)
                escalate = threading.Timer(5.0, _escalate)
                escalate.daemon = True  # never delays supervisor exit
                escalate.start()
            elif verb == "STOP":
                os.killpg(child.pid, signal.SIGSTOP)
                state["suspended_at"] = time.monotonic()
            elif verb == "CONT":
                if state["suspended_at"] is not None:
                    state["suspended_total"] += (
                        time.monotonic() - state["suspended_at"])
                    state["suspended_at"] = None
                os.killpg(child.pid, signal.SIGCONT)
            elif verb.startswith("LIMIT "):
                # deadline update (ccontrol modify time_limit; the
                # ChangeJobTimeConstraint analog): total seconds
                # from step start, 0 = unlimited
                try:
                    new_limit = float(verb.split(None, 1)[1])
                except ValueError:
                    return
                state["time_limit"] = new_limit or None
        except ProcessLookupError:
            pass

    def control_loop():
        for line in sys.stdin:
            handle_verb(line.strip())

    threading.Thread(target=control_loop, daemon=True).start()

    # second control channel for craned-restart re-adoption (reference
    # Craned.cpp:1345-1449 reconnects supervisors): the stdin pipe dies
    # with the craned process, so verbs can also arrive over a FIFO
    # that any future craned incarnation can open by path.  O_RDWR
    # keeps a writer open so reads block instead of seeing EOF.
    control_path = init.get("control_path") or ""
    if control_path:
        def fifo_loop():
            try:
                fd = os.open(control_path, os.O_RDWR)
            except OSError:
                return
            with os.fdopen(fd, "r") as fh:
                for line in fh:
                    handle_verb(line.strip())

        threading.Thread(target=fifo_loop, daemon=True).start()

    while True:
        try:
            code = child.wait(timeout=0.2)
            break
        except subprocess.TimeoutExpired:
            pass
        limit = state["time_limit"]
        if limit is None or state["suspended_at"] is not None:
            continue
        elapsed = (time.monotonic() - start) - state["suspended_total"]
        if elapsed > limit:
            try:
                os.killpg(child.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            child.wait()
            _container_rm(container)
            if rdzv is not None:
                rdzv.stop()   # releases parked fences: their handler
                              # threads are non-daemon and would pin
                              # this process past its own exit
            if interactive is not None:
                interactive.finish(124)
            suffix = ""
            if init.get("epilog"):
                if _run_hook(init["epilog"], env, out) != 0:
                    suffix = " EPILOGFAIL"
            report("TIMEOUT" + suffix)
            return 0

    if rdzv is not None:
        rdzv.stop()   # see the timeout path: parked fences must not
                      # pin the supervisor's exit
    if interactive is not None:
        # readers drained + exited chunk sent BEFORE the craned report:
        # the client always has the full output when the exit lands
        interactive.finish(130 if state["terminated"] else code)

    # task epilog: always runs once the user command ended (killed or
    # not); its failure never changes the job's outcome but is reported
    # so the craned can drain the node (reference epilog policy)
    epilog_suffix = ""
    epilog = init.get("epilog") or ""
    if epilog:
        if _run_hook(epilog, env, out) != 0:
            epilog_suffix = " EPILOGFAIL"

    usage_suffix = _usage_suffix(init)
    if state["terminated"]:
        report("KILLED" + epilog_suffix + usage_suffix)
    else:
        report(f"EXIT {code}{epilog_suffix}{usage_suffix}")
    return 0


def _usage_suffix(init: dict) -> str:
    """Efficiency sample at step end (the ceff data source; reference
    answers ceff through the plugin daemon, Crane.proto:1615-1617):
    cpu-seconds and peak RSS from the job cgroup where one exists,
    else from getrusage(RUSAGE_CHILDREN).  Always the LAST report
    tokens; a failure to sample reports nothing rather than failing
    the step."""
    import resource
    cpu = 0.0
    rss = 0
    try:
        ru = resource.getrusage(resource.RUSAGE_CHILDREN)
        cpu = ru.ru_utime + ru.ru_stime
        rss = ru.ru_maxrss * 1024   # Linux reports KiB
    except OSError:
        pass
    procs = init.get("cgroup_procs")
    for pp in ([procs] if isinstance(procs, str) else procs or []):
        d = os.path.dirname(pp)
        # v2 unified dir or the v1 memory/cpu controller dirs
        for fname, kind in (("memory.peak", "rss"),
                            ("memory.max_usage_in_bytes", "rss"),
                            ("cpu.stat", "cpu")):
            path = os.path.join(d, fname)
            try:
                with open(path) as fh:
                    text = fh.read()
            except OSError:
                continue
            if kind == "rss":
                try:
                    rss = max(rss, int(text.strip()))
                except ValueError:
                    pass
            else:
                for line in text.splitlines():
                    if line.startswith("usage_usec"):
                        try:
                            cpu = max(cpu,
                                      int(line.split()[1]) / 1e6)
                        except (ValueError, IndexError):
                            pass
    if cpu <= 0 and rss <= 0:
        return ""
    return f" USAGE cpu={cpu:.3f} rss={rss}"


if __name__ == "__main__":
    sys.exit(main())
