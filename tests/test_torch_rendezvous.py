"""Gang rendezvous on the port (``cranesched_tpu_torch/rpc/rendezvous.py``,
``cranesched_tpu_torch/coord.py``): the cases of
``tests/test_rendezvous.py``, each run with the port's server and client,
and across packages (a JAX client on the port's server, a port client on
the JAX server), every pairing held to the JAX file's outcomes; the real
two-craned gang runs once per package.

*ROADMAP.md C4*, a deliberate difference: the JAX client dials with no
``wait_for_ready``, so a member that reaches ``coord fence`` before the
rank-0 supervisor has bound the service fails at once (UNAVAILABLE)
though its caller gave it a timeout.  That is the cause of the JAX
file's ``test_real_gang_cross_node_fence`` flake under load.  The port's
client waits for the channel within the call's deadline;
``test_fence_before_rank0_listens`` shows both behaviours.
"""

import contextlib
import socket
import threading
import time

import grpc
import pytest

import cranesched_tpu.rpc.rendezvous as jrdzv
import cranesched_tpu_torch.rpc.rendezvous as trdzv
from test_torch_node_plane import JAX, PORT, plane, wait_for

PAIRS = {"port": (trdzv, trdzv), "jax-server-port-client": (jrdzv, trdzv),
         "port-server-jax-client": (trdzv, jrdzv)}


@pytest.fixture(params=sorted(PAIRS))
def service(request):
    srv_mod, cli_mod = PAIRS[request.param]
    server = srv_mod.RendezvousServer(token="s3cret")
    port = server.start("127.0.0.1:0")
    clients = []

    def client(token="s3cret"):
        c = cli_mod.RendezvousClient(f"127.0.0.1:{port}", token=token)
        clients.append(c)
        return c

    yield client
    for c in clients:
        c.close()
    server.stop()


def test_fence_allgather_and_epochs(service):
    n = 4
    results = [None] * n

    def member(rank):
        results[rank] = service().fence("ready", rank, n,
                                        data=f"r{rank}".encode())

    threads = [threading.Thread(target=member, args=(r,))
               for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert all(r == [b"r0", b"r1", b"r2", b"r3"] for r in results)
    # the name is reusable: a completed fence opens a new epoch
    c = service()
    out = []
    t = threading.Thread(target=lambda: out.append(c.fence("ready", 0, 2)))
    t.start()
    time.sleep(0.2)
    assert not out  # still waiting on rank 1 of the new epoch
    service().fence("ready", 1, 2)
    t.join(timeout=10)
    assert out and out[0] == [b"", b""]


def test_fence_rejects_bad_participants(service):
    c = service()
    with pytest.raises(RuntimeError, match="bad rank"):
        c.fence("f", 3, 2)
    # duplicate rank in one epoch (the parked rank is released with a
    # shutdown error at teardown)

    def parked():
        with contextlib.suppress(RuntimeError, grpc.RpcError):
            service().fence("g", 0, 2)

    threading.Thread(target=parked, daemon=True).start()
    time.sleep(0.2)
    with pytest.raises(RuntimeError, match="duplicate rank"):
        service().fence("g", 0, 2)


def test_fence_timeout_is_legible(service):
    with pytest.raises(RuntimeError,
                       match=r"fence timeout \(1/2 arrived\)"):
        service().fence("lonely", 0, 2, timeout=0.5)


def test_modex_put_get(service):
    c = service()
    assert c.get("missing") is None
    got = []
    t = threading.Thread(
        target=lambda: got.append(c.get("addr", timeout=10.0)))
    t.start()
    time.sleep(0.2)
    service().put("addr", b"10.0.0.5:9999")
    t.join(timeout=10)
    assert got == [b"10.0.0.5:9999"]


def test_token_gates_everything(service):
    rogue = service(token="wrong")
    with pytest.raises(grpc.RpcError):
        rogue.put("k", b"v")
    with pytest.raises((grpc.RpcError, RuntimeError)):
        rogue.fence("f", 0, 1)


def test_fence_timeout_then_retry_succeeds(service):
    c = service()
    with pytest.raises(RuntimeError, match="fence timeout"):
        c.fence("slow", 0, 2, timeout=0.4)
    out = []
    t = threading.Thread(target=lambda: out.append(
        c.fence("slow", 0, 2, data=b"a", timeout=15)))
    t.start()
    time.sleep(0.2)
    service().fence("slow", 1, 2, data=b"b", timeout=15)
    t.join(timeout=10)
    assert out == [[b"a", b"b"]]


def test_stale_epoch_put_and_fence_rejected():
    server = trdzv.RendezvousServer(token="s3cret", epoch=2)
    port = server.start("127.0.0.1:0")
    try:
        stale = trdzv.RendezvousClient(f"127.0.0.1:{port}",
                                       token="s3cret", epoch=1)
        with pytest.raises(RuntimeError, match="stale epoch 1"):
            stale.put("addr", b"10.0.0.5:9")
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="stale epoch 1"):
            stale.fence("boot", 0, 2, timeout=30.0)
        assert time.monotonic() - t0 < 5.0
        stale.close()
        cur = trdzv.RendezvousClient(f"127.0.0.1:{port}", token="s3cret",
                                     epoch=2)
        cur.put("addr", b"10.0.0.5:9")
        legacy = trdzv.RendezvousClient(f"127.0.0.1:{port}",
                                        token="s3cret")
        legacy.put("other", b"x")
        assert cur.get("other") == b"x"
        cur.close()
        legacy.close()
    finally:
        server.stop()


def test_server_restart_mid_fence():
    server = trdzv.RendezvousServer(token="s3cret", epoch=1)
    port = server.start("127.0.0.1:0")
    parked_err = []

    def parked():
        c = trdzv.RendezvousClient(f"127.0.0.1:{port}", token="s3cret",
                                   epoch=1)
        try:
            c.fence("step", 0, 2, timeout=30.0)
        except (RuntimeError, grpc.RpcError) as e:
            parked_err.append(str(e))
        finally:
            c.close()

    t = threading.Thread(target=parked)
    t.start()
    time.sleep(0.3)
    server.stop()
    t.join(timeout=10)
    assert parked_err and "shutting down" in parked_err[0]
    server2 = trdzv.RendezvousServer(token="s3cret", epoch=2)
    port2 = server2.start("127.0.0.1:0")
    try:
        old = trdzv.RendezvousClient(f"127.0.0.1:{port2}", token="s3cret",
                                     epoch=1)
        with pytest.raises(RuntimeError, match="stale epoch 1"):
            old.fence("step", 0, 2, timeout=30.0)
        old.close()
        results = [None, None]

        def member(rank):
            c = trdzv.RendezvousClient(f"127.0.0.1:{port2}",
                                       token="s3cret", epoch=2)
            try:
                results[rank] = c.fence("step", rank, 2,
                                        data=f"r{rank}".encode(),
                                        timeout=15.0)
            finally:
                c.close()

        threads = [threading.Thread(target=member, args=(r,))
                   for r in range(2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=10)
        assert results == [[b"r0", b"r1"], [b"r0", b"r1"]]
    finally:
        server2.stop()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_fence_before_rank0_listens():
    """C4: rank 1 calls ``fence`` before rank 0's service is bound.  The
    JAX client fails at once with UNAVAILABLE; the port's waits for the
    channel and completes the fence once rank 0 listens."""
    port = _free_port()
    address = f"127.0.0.1:{port}"
    jc = jrdzv.RendezvousClient(address, token="t")
    t0 = time.monotonic()
    with pytest.raises(grpc.RpcError) as info:
        jc.fence("boot", 1, 2, data=b"r1", timeout=30.0)
    assert info.value.code() == grpc.StatusCode.UNAVAILABLE
    assert time.monotonic() - t0 < 5.0
    jc.close()

    results = [None, None]
    clients = [trdzv.RendezvousClient(address, token="t")
               for _ in range(2)]

    def member(rank):
        results[rank] = clients[rank].fence(
            "boot", rank, 2, data=f"r{rank}".encode(), timeout=30.0)

    early = threading.Thread(target=member, args=(1,))
    early.start()
    # rank 1's call is in flight, waiting for a listener
    time.sleep(1.0)
    assert results[1] is None and early.is_alive()
    server = trdzv.RendezvousServer(token="t", nranks=2)
    assert server.start(address) == port
    try:
        member(0)
        early.join(timeout=30)
        assert results == [[b"r0", b"r1"], [b"r0", b"r1"]]
    finally:
        for c in clients:
            c.close()
        server.stop()


def _resolvable_pair():
    """Two distinct node names that resolve to this host's IPv4 loopback
    or address: a gang's rendezvous address is '<rank-0 name>:port'."""
    names = []
    for name in ("runsc", "vm", "localhost", socket.gethostname()):
        try:
            addr = socket.gethostbyname(name)
        except OSError:
            continue
        if name not in names and (addr.startswith("127.")
                                  or addr == socket.gethostbyname(
                                      socket.gethostname())):
            names.append(name)
    if len(names) < 2:
        pytest.skip("fewer than two host names resolve here")
    return names[:2]


def _gang_fence(st):
    names = _resolvable_pair()
    daemons = [st.add_craned(name) for name in names]
    assert st.ready(*daemons)
    pkg = "cranesched_tpu_torch" if st.S is PORT else "cranesched_tpu"
    script = (
        f"exec > {st.tmp_path}/gang_rank_$CRANE_NODE_RANK.log 2>&1\n"
        "echo rank=$CRANE_NODE_RANK\n"
        f"python -m {pkg}.coord fence ready "
        "--data r$CRANE_NODE_RANK --timeout 30 || exit 9\n"
        "echo fenced-$CRANE_NODE_RANK\n")
    jid = st.sched.submit(st.S.ctld.JobSpec(
        res=st.S.ctld.ResourceSpec(cpu=1.0), node_num=2, script=script,
        time_limit=90), now=time.time())
    assert wait_for(lambda: st.sched.job_info(jid).status.is_terminal,
                    timeout=45.0)
    logs = {}
    for r in (0, 1):
        p = st.tmp_path / f"gang_rank_{r}.log"
        logs[r] = p.read_text() if p.exists() else "<missing>"
    job = st.sched.job_info(jid)
    return job.status.name, job.exit_code, logs


def test_real_gang_cross_node_fence(tmp_path):
    """Two craneds, one node_num=2 gang: each member fences through the
    coord CLI, so the job completes only if the cross-node barrier
    works.  On the port the members may reach the fence before rank 0
    listens (C4); the JAX run is retried for its race, which a loaded
    host meets more than once in a row."""
    config = dict(backfill=False, craned_timeout=30.0)
    with plane(PORT, tmp_path, config=config) as st:
        port = _gang_fence(st)
    assert port[:2] == ("COMPLETED", 0), port
    for r in (0, 1):
        assert f"fenced-{r}" in port[2][r], port
        assert "0:r0" in port[2][r] and "1:r1" in port[2][r], port
    jax = None
    for attempt in range(5):
        with plane(JAX, tmp_path / f"try{attempt}", config=config) as st:
            jax = _gang_fence(st)
        if jax[0] == "COMPLETED":
            break
    assert jax == port
