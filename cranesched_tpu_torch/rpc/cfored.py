"""Client-embedded interactive I/O hub: the cfored role.

The reference runs a standalone user-side ``cfored`` daemon holding a
bidi ``CforedStream`` to ctld plus per-step ``StepIOStream``s from
supervisors (reference: protos/Crane.proto:794-900,1679;
src/Craned/Supervisor/CforedClient.h:28-95).  Here the hub is embedded
in the submitting client (crun/calloc): it hosts the ``CraneFored``
gRPC service, the submitting spec carries its address, and each
supervisor connects back with one ``StepIO`` bidi stream.

Ordering contract (CforedClient.h:60-63 — output drained before exit
status): the supervisor sends the final ``exited`` chunk only after
both output pipes reached EOF, so by construction a client that reads
the stream in order has seen every output byte before the exit code.

The port's copy of ``cranesched_tpu/rpc/cfored.py``,
with the port's imports.
"""

from __future__ import annotations

import queue
import threading
from concurrent import futures

import grpc

from cranesched_tpu_torch.rpc import crane_pb2 as pb
from cranesched_tpu_torch.rpc.consts import CFORED_SERVICE


class StepIOSession:
    """One supervisor's live stream, as seen by the client.

    ``read()`` yields (stream-name, bytes) chunks until the step exits;
    ``exit_code`` is set once the final chunk arrived.  ``send_stdin``/
    ``close_stdin`` feed the response direction.
    """

    def __init__(self, job_id: int, step_id: int):
        self.job_id = job_id
        self.step_id = step_id
        self.exit_code: int | None = None
        self._out: queue.Queue = queue.Queue()
        self._stdin: queue.Queue = queue.Queue()
        self.exited = threading.Event()
        # ordering observability: bytes received before the exited
        # chunk — equals the total output iff the drained-before-exit
        # contract held (chunks arrive in stream order)
        self.bytes_received = 0
        self.bytes_at_exit: int | None = None

    # -- client side --

    def read(self, timeout: float | None = None):
        """Yield (stream, bytes) until the exited chunk; sets exit_code."""
        while True:
            item = self._out.get(timeout=timeout)
            if item is None:
                return
            yield item

    def send_stdin(self, data: bytes) -> None:
        self._stdin.put(pb.StepIOChunk(data=data))

    def close_stdin(self) -> None:
        self._stdin.put(pb.StepIOChunk(stdin_eof=True))

    def abort(self, exit_code: int) -> None:
        """Client-side liveness fallback: end the session when no
        supervisor will ever stream (the job died before dispatch, a
        stale cancel landed, the node vanished pre-connect).  No-op if
        the stream already finished."""
        if self.exited.is_set():
            return
        self.exit_code = exit_code
        self.exited.set()
        self._out.put(None)
        self._stdin.put(None)

    # -- handler side --

    def _push_output(self, chunk) -> None:
        if chunk.exited:
            if self.exited.is_set():
                return  # already aborted client-side
            self.exit_code = chunk.exit_code
            self.bytes_at_exit = self.bytes_received
            self.exited.set()
            self._out.put(None)
            self._stdin.put(None)  # unblock the response generator
        elif chunk.data:
            self.bytes_received += len(chunk.data)
            self._out.put((chunk.stream or "out", chunk.data))

    def _stdin_iter(self):
        while True:
            item = self._stdin.get()
            if item is None:
                return
            yield item


class CforedServer:
    """Hosts CraneFored; hands incoming supervisor streams to waiters.

    ``expect(job_id, step_id)`` registers interest and returns the
    session (created on first use from either side, so the supervisor
    connecting before/after expect() both work).

    ``secret`` is the hub-wide stream credential: it exists before any
    submission (no job-id ordering problem), every spec this client
    submits carries it (``interactive_token``), and the first chunk of
    every incoming stream must present it — without it, any peer that
    can reach the port could claim a session (read the user's stdin,
    forge the exit status).  Empty = open hub (tests, trusted loopback).
    """

    def __init__(self, secret: str | None = None, tls=None,
                 x_display: str | None = None):
        import secrets as _secrets
        self.secret = (_secrets.token_urlsafe(16) if secret is None
                       else secret)
        # where X11 relay streams land (reference SetupX11forwarding_
        # counterpart): the USER'S display — $DISPLAY by default
        self.x_display = x_display
        # utils.pki.TlsConfig: the hub serves TLS and supervisors dial
        # back with the cluster CA (their side rides the craned's
        # config) — the stream secret stops being sniffable in flight
        self.tls = tls
        self._sessions: dict[tuple[int, int], StepIOSession] = {}
        self._lock = threading.Lock()
        self._server: grpc.Server | None = None
        self.address = ""

    def _session(self, job_id: int, step_id: int) -> StepIOSession:
        with self._lock:
            key = (job_id, step_id)
            sess = self._sessions.get(key)
            if sess is None:
                sess = self._sessions[key] = StepIOSession(job_id,
                                                           step_id)
            return sess

    expect = _session

    def StepIO(self, request_iterator, context):
        """Bidi handler: a thread drains the supervisor's output chunks
        into the session; this generator yields stdin chunks back."""
        import grpc as _grpc
        first = next(request_iterator, None)
        if first is None:
            return
        if self.secret and first.token != self.secret:
            context.abort(_grpc.StatusCode.PERMISSION_DENIED,
                          "bad stream token")
        if first.stream == "x11":
            # a whole-stream X11 relay channel (one per X connection
            # the job opened against the forwarded DISPLAY)
            yield from self._x11_stream(request_iterator, context)
            return
        sess = self._session(first.job_id, first.step_id)
        sess._push_output(first)

        def drain():
            try:
                for chunk in request_iterator:
                    sess._push_output(chunk)
            except grpc.RpcError:
                pass
            finally:
                if not sess.exited.is_set():
                    # supervisor died mid-stream: release both sides
                    sess.exit_code = sess.exit_code or 255
                    sess.exited.set()
                    sess._out.put(None)
                    sess._stdin.put(None)

        threading.Thread(target=drain, daemon=True).start()
        yield from sess._stdin_iter()

    def _connect_x_display(self):
        """Socket to the user's X server from $DISPLAY grammar:
        ':N[.s]' / 'unix:N' -> /tmp/.X11-unix/XN; 'host:N' ->
        TCP host:6000+N."""
        import os
        import socket as _socket
        display = self.x_display or os.environ.get("DISPLAY", "")
        if not display:
            raise OSError("no DISPLAY to relay X11 to")
        host, _, num = display.rpartition(":")
        number = int(num.split(".")[0] or 0)
        if host in ("", "unix"):
            s = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
            s.connect(f"/tmp/.X11-unix/X{number}")
            return s
        return _socket.create_connection((host, 6000 + number),
                                         timeout=10)

    def _x11_stream(self, request_iterator, context):
        """Relay one X connection: incoming chunks -> X server; X
        server bytes -> response chunks.  Ends when either side
        closes."""
        try:
            xsock = self._connect_x_display()
        except OSError as exc:
            context.abort(grpc.StatusCode.FAILED_PRECONDITION,
                          f"X display unavailable: {exc}")
            return

        def pump_to_x():
            try:
                for chunk in request_iterator:
                    if chunk.data:
                        xsock.sendall(chunk.data)
            except (grpc.RpcError, OSError):
                pass
            finally:
                try:
                    xsock.shutdown(2)
                except OSError:
                    pass

        threading.Thread(target=pump_to_x, daemon=True).start()
        try:
            while data := xsock.recv(65536):
                yield pb.StepIOChunk(data=data)
        except OSError:
            pass
        finally:
            try:
                xsock.close()
            except OSError:
                pass
        yield pb.StepIOChunk(exited=True)

    def start(self, address: str | None = None,
              host_for_clients: str = "127.0.0.1") -> str:
        """Bind and advertise.  When ``host_for_clients`` is not
        loopback the listen socket must be reachable on that interface,
        so the bind follows it (0.0.0.0); plain loopback stays bound to
        loopback."""
        if address is None:
            address = ("127.0.0.1:0"
                       if host_for_clients in ("127.0.0.1", "localhost")
                       else "0.0.0.0:0")
        handler = grpc.stream_stream_rpc_method_handler(
            self.StepIO,
            request_deserializer=pb.StepIOChunk.FromString,
            response_serializer=pb.StepIOChunk.SerializeToString)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(
                CFORED_SERVICE, {"StepIO": handler}),))
        if self.tls is not None:
            from cranesched_tpu_torch.utils.pki import server_credentials
            port = self._server.add_secure_port(
                address, server_credentials(self.tls))
        else:
            port = self._server.add_insecure_port(address)
        self._server.start()
        # tls://<identity>@ marks the advertised address so craneds
        # know the supervisor must dial back with the cluster CA AND
        # can pin the hub's issued cert name — without the pin, any
        # cluster-issued cert validates as the hub on loopback hosts
        # (every cert carries localhost SANs for single-host setups)
        scheme = ""
        if self.tls is not None:
            from cranesched_tpu_torch.utils.pki import cert_identity
            ident = cert_identity(self.tls.cert) if self.tls.cert else ""
            scheme = f"tls://{ident}@" if ident else "tls://"
        self.address = f"{scheme}{host_for_clients}:{port}"
        return self.address

    def stop(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5)
