"""Interactive step I/O and X11 forwarding on the port's node plane
(``cranesched_tpu_torch/rpc/cfored.py``, the supervisor's StepIO stream),
against the JAX package's: the cfored cases of
``tests/test_interactive_io.py`` and ``tests/test_x11.py``, each run on a
JAX plane with the JAX hub and on a port plane with the port's hub, and
the streamed bytes, exit codes and job records compared.  The case that
drives the JAX ``cli`` (the crun watchdog) comes with the port's CLI
(ROADMAP.md A15).
"""

import socket
import threading
import time

import grpc
import pytest

import cranesched_tpu.rpc.cfored as jcfored
import cranesched_tpu_torch.rpc.cfored as tcfored
from cranesched_tpu_torch.rpc import crane_pb2 as pb
from cranesched_tpu_torch.rpc.consts import CFORED_SERVICE
from test_torch_node_plane import JAX, PORT, plane, wait_for

CFORED = {"jax": jcfored, "port": tcfored}


def _with_hub(scenario, tmp_path, **hub_kw):
    out = {}
    for S in (JAX, PORT):
        hub = CFORED[S.name].CforedServer(**hub_kw)
        hub.start()
        try:
            with plane(S, tmp_path, cpu=8.0, mem_bytes=8 << 30) as st:
                out[S.name] = scenario(st, hub)
        finally:
            hub.stop()
    return out["jax"], out["port"]


def collect(sess, timeout=20.0):
    outs = {"out": b"", "err": b""}
    for name, data in sess.read(timeout=timeout):
        outs[name] += data
    return outs, sess.exit_code


def _job(st, hub, script, **kw):
    return st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0), script=script,
        interactive_address=hub.address, interactive_token=hub.secret,
        **kw), now=time.time())


def _streams(st, hub):
    d = st.add_craned("io00")
    assert st.ready(d)
    jid = _job(st, hub, "echo to-stdout; echo to-stderr >&2; exit 4")
    outs, code = collect(hub.expect(jid, 0))
    assert outs == {"out": b"to-stdout\n", "err": b"to-stderr\n"}
    assert code == 4
    assert st.wait_status(jid, "FAILED")
    assert st.sched.job_info(jid).exit_code == 4
    return outs, code, st.sched.job_info(jid).exit_code


def test_interactive_crun_streams_without_shared_storage(tmp_path):
    jax, port = _with_hub(_streams, tmp_path)
    assert port == jax


def _stdin(st, hub):
    d = st.add_craned("io01")
    assert st.ready(d)
    jid = _job(st, hub, "while read line; do echo got:$line; done")
    sess = hub.expect(jid, 0)
    sess.send_stdin(b"alpha\n")
    sess.send_stdin(b"beta\n")
    sess.close_stdin()
    outs, code = collect(sess)
    assert outs["out"] == b"got:alpha\ngot:beta\n" and code == 0
    return outs, code


def test_stdin_roundtrip(tmp_path):
    jax, port = _with_hub(_stdin, tmp_path)
    assert port == jax


def _drained(st, hub):
    d = st.add_craned("io02")
    assert st.ready(d)
    n = 20000
    jid = _job(st, hub, f"seq 1 {n}; exit 0")
    sess = hub.expect(jid, 0)
    text = b"".join(data for _, data in sess.read(timeout=30.0))
    lines = text.decode().split()
    assert len(lines) == n and lines[-1] == str(n)
    assert sess.exit_code == 0
    # every output byte reached the hub strictly before the exit chunk
    assert sess.bytes_at_exit == len(text)
    return text, sess.exit_code, sess.bytes_at_exit


def test_output_drained_before_exit_status(tmp_path):
    jax, port = _with_hub(_drained, tmp_path)
    assert port == jax


def _step_cancel(st, hub):
    d = st.add_craned("io03")
    assert st.ready(d)
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=4.0), alloc_only=True,
        time_limit=300), now=time.time())
    assert st.wait_status(jid, "RUNNING")
    sid = st.sched.submit_step(jid, st.S.ctld.StepSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0),
        script="echo started; sleep 60",
        interactive_address=hub.address,
        interactive_token=hub.secret), now=time.time())
    sess = hub.expect(jid, sid)
    got = next(iter(sess.read(timeout=20.0)))
    assert got == ("out", b"started\n")
    assert st.sched.cancel_step(jid, sid, now=time.time())
    for _ in sess.read(timeout=20.0):
        pass
    assert sess.exit_code == 130
    assert wait_for(lambda: st.sched.job_info(jid)
                    .steps[sid].status.value == "Cancelled")
    assert jid in st.sched.running
    assert st.sched.free_allocation(jid, now=time.time())
    return got, sess.exit_code, st.sched.job_info(jid).steps[sid].status.value


def test_interactive_step_in_allocation_and_cancel(tmp_path):
    jax, port = _with_hub(_step_cancel, tmp_path)
    assert port == jax


@pytest.mark.parametrize("cfored", [jcfored, tcfored],
                         ids=["jax", "port"])
def test_stream_without_secret_is_rejected(cfored):
    """A stream that cannot present the hub secret is refused, by both
    packages' hubs."""
    hub = cfored.CforedServer()
    hub.start()
    try:
        assert hub.secret
        channel = grpc.insecure_channel(hub.address)
        call = channel.stream_stream(
            f"/{CFORED_SERVICE}/StepIO",
            request_serializer=pb.StepIOChunk.SerializeToString,
            response_deserializer=pb.StepIOChunk.FromString)(
            iter([pb.StepIOChunk(job_id=1, step_id=0, token="wrong")]))
        with pytest.raises(grpc.RpcError) as exc:
            next(iter(call))
        assert exc.value.code() == grpc.StatusCode.PERMISSION_DENIED
        channel.close()
    finally:
        hub.stop()


class FakeXServer:
    """Accepts 'X connections' and acks everything it receives."""

    def __init__(self):
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(4)
        self.port = self._sock.getsockname()[1]
        self.received = []
        threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,),
                             daemon=True).start()

    def _serve(self, conn):
        try:
            while data := conn.recv(65536):
                self.received.append(data)
                conn.sendall(b"xserver-ack:" + data)
        except OSError:
            pass
        finally:
            conn.close()

    def close(self):
        self._sock.close()


def _x11(st, hub, xserver):
    d = st.add_craned("x0")
    assert st.ready(d)
    script = (
        "python3 - <<'PY'\n"
        "import os, socket\n"
        "host, num = os.environ['DISPLAY'].split(':')\n"
        "s = socket.create_connection((host, 6000 + int(num)),"
        " timeout=15)\n"
        "s.sendall(b'x11-hello')\n"
        "print('REPLY:' + s.recv(200).decode())\n"
        "PY\n")
    jid = _job(st, hub, script, x11=True, time_limit=60)
    sess = hub.expect(jid, 0)
    got = []
    done = threading.Event()

    def drain():
        for _, data in sess.read(timeout=25.0):
            got.append(data)
        done.set()

    threading.Thread(target=drain, daemon=True).start()
    assert done.wait(timeout=25.0)
    text = b"".join(got).decode()
    assert "REPLY:xserver-ack:x11-hello" in text, text
    assert sess.exit_code == 0
    assert st.wait_status(jid, "COMPLETED", timeout=10.0)
    return text, sess.exit_code


def test_x11_relay_end_to_end(tmp_path):
    xserver = FakeXServer()
    try:
        jax, port = _with_hub(
            lambda st, hub: _x11(st, hub, xserver), tmp_path,
            x_display=f"127.0.0.1:{xserver.port - 6000}")
        assert port == jax
        assert b"".join(xserver.received).count(b"x11-hello") == 2
    finally:
        xserver.close()
