"""AuthN/AuthZ and transport security over the port's RPC surface: the
cases of ``tests/test_auth.py`` and ``tests/test_tls.py`` against the
port's server (``cranesched_tpu_torch/rpc/server.py``), its
``AuthManager`` (``ctld/auth.py``) and its cluster PKI (``utils/pki.py``).

Reference: every external RPC verifies a per-user mTLS certificate
against the claimed uid (CheckCertAndUIDAllowed_, CtldGrpcServer.h:568,
used at :698+) before RBAC.  Here the minimum viable equivalent: ctld-
issued bearer tokens in gRPC metadata, owner-or-admin on job mutations,
authenticated accounting actor, a cluster secret for the craned-internal
surface, and TLS anchored in a cluster CA with optional mTLS.  The TLS
cases need the ``cryptography`` package (skipped one by one without it);
the JAX file's real-node-plane TLS case comes with the node plane
(ROADMAP.md A9b).
"""

import grpc
import pytest

from cranesched_tpu_torch.craned.sim import SimCluster
from cranesched_tpu_torch.ctld import (
    JobScheduler,
    MetaContainer,
    SchedulerConfig,
)
from cranesched_tpu_torch.ctld.auth import AuthManager
from cranesched_tpu_torch.rpc import CtldClient, crane_pb2 as pb, serve
from cranesched_tpu_torch.utils import pki


@pytest.fixture()
def secured(tmp_path):
    meta = MetaContainer()
    for i in range(2):
        meta.add_node(f"cn{i}", meta.layout.encode(
            cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True))
        meta.craned_up(i)
    sched = JobScheduler(meta, SchedulerConfig(backfill=False),
                         device="cpu")
    sim = SimCluster(sched)
    sim.wire(sched)
    auth = AuthManager(str(tmp_path / "tokens.json"))
    server, port = serve(sched, sim=sim, tick_mode=True, auth=auth)
    addr = f"127.0.0.1:{port}"
    root = CtldClient(addr, token=auth.root_token)
    clients = [root]

    def client_for(user):
        token = root.issue_token(user).token
        c = CtldClient(addr, token=token)
        clients.append(c)
        return c

    yield sched, auth, root, client_for, addr
    for c in clients:
        c.close()
    server.stop()


def spec(user, runtime=100.0):
    return pb.JobSpec(user=user,
                      res=pb.ResourceSpec(cpu=1.0, mem_bytes=1 << 30),
                      sim_runtime=runtime)


def test_unauthenticated_requests_refused(secured, tmp_path):
    sched, auth, root, client_for, addr = secured
    anon = CtldClient(addr)
    try:
        r = anon.submit(spec("anyone"))
        assert r.job_id == 0 and "authentication required" in r.error
        assert not anon.cancel(1).ok
        assert not anon.acct_mgr("root", "show").ok
        # the read surface is closed too (information disclosure):
        # queries abort UNAUTHENTICATED rather than leaking the queue
        for call in (lambda: anon.query_jobs(include_history=True),
                     lambda: anon.query_cluster(),
                     lambda: anon.query_steps(1),
                     lambda: anon.query_stats()):
            try:
                call()
                raise AssertionError("anonymous query succeeded")
            except grpc.RpcError as exc:
                assert exc.code() == grpc.StatusCode.UNAUTHENTICATED
        # Tick denial is explicit, never a silent empty cycle
        assert "permission" in anon.tick(1.0).error             or "authentication" in anon.tick(1.0).error
    finally:
        anon.close()


def test_cross_user_cancel_refused(secured):
    sched, auth, root, client_for, addr = secured
    alice = client_for("alice")
    mallory = client_for("mallory")
    jid = alice.submit(spec("alice")).job_id
    assert jid > 0
    root.tick(0.0)
    # mallory cannot touch alice's job — the acceptance bar
    r = mallory.cancel(jid)
    assert not r.ok and "permission denied" in r.error
    assert not mallory.suspend(jid).ok
    assert not mallory.hold(jid).ok
    assert sched.job_info(jid).status.value == "Running"
    # alice can; root (admin) also can
    assert alice.suspend(jid).ok
    assert root.resume(jid).ok
    assert alice.cancel(jid).ok


def test_submit_identity_must_match_spec_user(secured):
    sched, auth, root, client_for, addr = secured
    alice = client_for("alice")
    r = alice.submit(spec("bob"))       # claiming someone else
    assert r.job_id == 0 and "permission denied" in r.error
    assert root.submit(spec("bob")).job_id > 0   # admin may act for bob


def test_acctmgr_actor_is_authenticated_identity(secured):
    sched, auth, root, client_for, addr = secured
    from cranesched_tpu_torch.ctld.accounting import AccountManager, User, \
        AdminLevel
    sched.accounts = AccountManager()
    sched.accounts.users["root"] = User(name="root",
                                        admin_level=AdminLevel.ROOT)
    alice = client_for("alice")
    # the request CLAIMS root but the authenticated identity is alice:
    # the privileged mutation must be refused
    r = alice.acct_mgr("root", "add_qos", {"name": "q", "priority": 5})
    assert not r.ok and "permission" in r.error
    assert root.acct_mgr("ignored-claim", "add_qos",
                         {"name": "q", "priority": 5}).ok
    assert "q" in sched.accounts.qos


def test_steps_and_allocation_ownership(secured):
    sched, auth, root, client_for, addr = secured
    alice = client_for("alice")
    mallory = client_for("mallory")
    jid = alice.submit(pb.JobSpec(
        user="alice", res=pb.ResourceSpec(cpu=4.0, mem_bytes=1 << 30),
        alloc_only=True, time_limit=600)).job_id
    root.tick(0.0)
    assert not mallory.submit_step(
        jid, pb.StepSpec(name="x", sim_runtime=5.0)).step_id >= 0
    assert not mallory.free_allocation(jid).ok
    sid = alice.submit_step(jid, pb.StepSpec(
        name="mine", sim_runtime=5.0)).step_id
    assert sid == 0
    assert not mallory.cancel_step(jid, sid).ok
    assert alice.cancel_step(jid, sid).ok
    assert alice.free_allocation(jid).ok


def test_admin_only_surfaces(secured):
    sched, auth, root, client_for, addr = secured
    alice = client_for("alice")
    assert not alice.create_reservation("r", "default", ["cn0"],
                                        0.0, 100.0).ok
    assert not alice.modify_node("cn0", "drain").ok
    assert not alice.issue_token("eve").ok
    assert root.create_reservation("r", "default", ["cn0"],
                                   0.0, 100.0).ok
    assert root.modify_node("cn0", "drain").ok


def test_craned_internal_needs_cluster_secret(secured):
    sched, auth, root, client_for, addr = secured
    alice = client_for("alice")
    total = pb.ResourceSpec(cpu=4.0, mem_bytes=8 << 30)
    assert not alice.craned_register("evil", total).ok
    craned = CtldClient(addr, token=auth.craned_token)
    try:
        reply = craned.craned_register("cn99", total)
        assert reply.ok
        assert craned.craned_ping(reply.node_id).ok
    finally:
        craned.close()


def test_revoked_token_stops_working(secured):
    sched, auth, root, client_for, addr = secured
    alice = client_for("alice")
    jid = alice.submit(spec("alice")).job_id
    assert jid > 0
    assert root.revoke_token("alice").ok
    r = alice.submit(spec("alice"))
    assert r.job_id == 0 and "authentication required" in r.error


def test_tokens_persist_across_restart(tmp_path):
    path = str(tmp_path / "tok.json")
    a1 = AuthManager(path)
    t = a1.issue("root", "alice")
    a2 = AuthManager(path)                 # restart
    assert a2.identity((("crane-token", t),)) == "alice"
    assert a2.root_token == a1.root_token
    assert a2.craned_token == a1.craned_token


def test_per_node_craned_token_is_bound_to_its_node(secured):
    """ADVICE r3: a per-node token (@craned/<name>) must not be able to
    impersonate other nodes on the internal surface."""
    sched, auth, root, client_for, addr = secured
    t0 = auth.issue_craned("root", "cn0")
    cn0 = CtldClient(addr, token=t0)
    try:
        # registering as its own name works, as another name is refused
        total = pb.ResourceSpec(cpu=4.0, mem_bytes=8 << 30)
        assert not cn0.craned_register("cn1", total).ok
        r = cn0.craned_register("cn0", total)
        assert r.ok
        assert cn0.craned_ping(r.node_id).ok          # own node_id: ok
        other = sched.meta.node_by_name("cn1").node_id
        assert not cn0.craned_ping(other).ok          # foreign: denied
    finally:
        cn0.close()


def test_token_table_stores_hashes_not_plaintext(tmp_path):
    """ADVICE r3: a leaked table file must not contain usable tokens."""
    import json as _json
    path = str(tmp_path / "tok.json")
    a = AuthManager(path)
    t = a.issue("root", "alice")
    with open(path, encoding="utf-8") as fh:
        table = _json.load(fh)
    assert t not in table                     # no plaintext row
    assert a.root_token not in table
    assert all(len(k) == 64 for k in table)   # sha256 hex keys only
    # and the hashes still authenticate
    assert a.identity((("crane-token", t),)) == "alice"


def test_legacy_plaintext_table_migrates_to_hashes(tmp_path):
    import json as _json
    path = str(tmp_path / "tok.json")
    with open(path, "w", encoding="utf-8") as fh:
        _json.dump({"OLDROOT": "root", "OLDSECRET": "@craned",
                    "ALICETOK": "alice"}, fh)
    a = AuthManager(path)
    assert a.root_token == "OLDROOT"          # daemon creds recovered
    assert a.craned_token == "OLDSECRET"
    assert a.identity((("crane-token", "ALICETOK"),)) == "alice"
    with open(path, encoding="utf-8") as fh:
        table = _json.load(fh)
    assert "ALICETOK" not in table            # rewritten as hash


def test_node_bound_token_cannot_use_unresolvable_node_id(secured):
    """Fail closed: a per-node token sending an unknown or -1 node_id
    (the whole-job report form) must be denied, not skipped past the
    binding check."""
    sched, auth, root, client_for, addr = secured
    t0 = auth.issue_craned("root", "cn0")
    cn0 = CtldClient(addr, token=t0)
    try:
        assert not cn0.craned_ping(999).ok       # unknown node id
        r = cn0.step_status_change(1, "FAILED", 1, 0.0, node_id=-1)
        assert not r.ok and "bound to node" in r.error
    finally:
        cn0.close()


def test_revoking_bootstrap_identity_rotates_keyring(tmp_path):
    """Revoking '@craned' must survive a restart: the keyring credential
    rotates, so the old secret cannot resurrect via bootstrap."""
    path = str(tmp_path / "tok.json")
    a1 = AuthManager(path)
    old = a1.craned_token
    assert a1.revoke("root", "@craned") >= 1
    assert a1.identity((("crane-token", old),)) is None
    assert a1.craned_token != old                 # rotated in-session
    a2 = AuthManager(path)                        # restart
    assert a2.identity((("crane-token", old),)) is None
    assert a2.craned_token == a1.craned_token


def test_legacy_migration_persists_keyring_across_two_restarts(tmp_path):
    import json as _json
    path = str(tmp_path / "tok.json")
    with open(path, "w", encoding="utf-8") as fh:
        _json.dump({"OLDROOT": "root", "OLDSECRET": "@craned"}, fh)
    a1 = AuthManager(path)                        # migration restart
    a2 = AuthManager(path)                        # second restart
    assert a2.root_token == "OLDROOT"             # not silently rotated
    assert a2.craned_token == "OLDSECRET"


# ---------------- transport security (tests/test_tls.py) ----------------

@pytest.fixture(scope="module")
def cluster_pki(tmp_path_factory):
    """One CA + certs for ctld, a craned, and a user (mTLS client)."""
    pytest.importorskip(
        "cryptography",
        reason="cluster-PKI tests need the cryptography package")
    d = str(tmp_path_factory.mktemp("pki"))
    ca, ca_key = pki.create_ca(d)
    ctld_cert, ctld_key = pki.issue_cert(d, "ctld", ca, ca_key)
    node_cert, node_key = pki.issue_cert(d, "cn0", ca, ca_key)
    user_cert, user_key = pki.issue_cert(d, "alice", ca, ca_key)
    rogue_dir = str(tmp_path_factory.mktemp("rogue"))
    rogue_ca, rogue_ca_key = pki.create_ca(rogue_dir, cn="rogue-ca")
    rogue_cert, rogue_key = pki.issue_cert(rogue_dir, "mallory",
                                           rogue_ca, rogue_ca_key)
    return {
        "ca": ca, "ctld": (ctld_cert, ctld_key),
        "node": (node_cert, node_key), "user": (user_cert, user_key),
        "rogue_ca": rogue_ca, "rogue": (rogue_cert, rogue_key),
    }


def _sim_server(cluster_pki, require_client=False):
    meta = MetaContainer()
    meta.add_node("cn0", meta.layout.encode(
        cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
        is_capacity=True))
    meta.craned_up(0)
    sched = JobScheduler(meta, SchedulerConfig(backfill=False),
                         device="cpu")
    sim = SimCluster(sched)
    sim.wire(sched)
    cert, key = cluster_pki["ctld"]
    tls = pki.TlsConfig(ca=cluster_pki["ca"], cert=cert, key=key,
                        require_client_cert=require_client)
    server, port = serve(sched, sim=sim, tick_mode=True, tls=tls)
    return sched, server, f"127.0.0.1:{port}"


def _spec(runtime=5.0):
    return pb.JobSpec(user="alice",
                      res=pb.ResourceSpec(cpu=1.0, mem_bytes=1 << 30),
                      sim_runtime=runtime)


def test_tls_handshake_and_roundtrip(cluster_pki):
    sched, server, addr = _sim_server(cluster_pki)
    client = CtldClient(addr, tls=pki.TlsConfig(ca=cluster_pki["ca"]))
    try:
        jid = client.submit(_spec()).job_id
        assert jid > 0
        client.tick(1.0)
        jobs = client.query_jobs(job_ids=[jid]).jobs
        assert jobs and jobs[0].status == "Running"
    finally:
        client.close()
        server.stop()


def test_plaintext_client_refused_by_tls_server(cluster_pki):
    sched, server, addr = _sim_server(cluster_pki)
    client = CtldClient(addr, timeout=3.0)  # insecure dial
    try:
        with pytest.raises(grpc.RpcError):
            client.submit(_spec())
    finally:
        client.close()
        server.stop()


def test_wrong_ca_refused(cluster_pki):
    sched, server, addr = _sim_server(cluster_pki)
    client = CtldClient(addr, timeout=3.0,
                        tls=pki.TlsConfig(ca=cluster_pki["rogue_ca"]))
    try:
        with pytest.raises(grpc.RpcError):
            client.submit(_spec())
    finally:
        client.close()
        server.stop()


def test_mtls_requires_cluster_client_cert(cluster_pki):
    """The internal-surface mode: the server verifies peers against
    the cluster CA.  No cert -> handshake refused; a cert from another
    CA -> refused; a cluster-issued cert -> accepted."""
    sched, server, addr = _sim_server(cluster_pki, require_client=True)
    ca = cluster_pki["ca"]
    bare = CtldClient(addr, timeout=3.0, tls=pki.TlsConfig(ca=ca))
    ucert, ukey = cluster_pki["user"]
    rcert, rkey = cluster_pki["rogue"]
    rogue = CtldClient(addr, timeout=3.0,
                       tls=pki.TlsConfig(ca=ca, cert=rcert, key=rkey))
    good = CtldClient(addr, timeout=5.0,
                      tls=pki.TlsConfig(ca=ca, cert=ucert, key=ukey))
    try:
        with pytest.raises(grpc.RpcError):
            bare.submit(_spec())
        with pytest.raises(grpc.RpcError):
            rogue.submit(_spec())
        assert good.submit(_spec()).job_id > 0
    finally:
        for c in (bare, rogue, good):
            c.close()
        server.stop()


def test_user_cert_cannot_impersonate_ctld(cluster_pki):
    """Every issued cert gets loopback SANs (single-host convenience),
    so a user's cfored-hub cert would verify as "127.0.0.1" — identity
    pinning (override_authority="ctld", the CLI default) is what stops
    a user serving on a shared host from harvesting bearer tokens."""
    meta = MetaContainer()
    meta.add_node("cn0", meta.layout.encode(
        cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
        is_capacity=True))
    sched = JobScheduler(meta, SchedulerConfig(backfill=False),
                         device="cpu")
    ucert, ukey = cluster_pki["user"]  # alice's legitimate cluster cert
    server, port = serve(
        sched, tick_mode=True,
        tls=pki.TlsConfig(ca=cluster_pki["ca"], cert=ucert, key=ukey))
    addr = f"127.0.0.1:{port}"
    pinned = CtldClient(addr, timeout=3.0, tls=pki.TlsConfig(
        ca=cluster_pki["ca"], override_authority="ctld"))
    unpinned = CtldClient(addr, timeout=3.0,
                          tls=pki.TlsConfig(ca=cluster_pki["ca"]))
    try:
        # without pinning the loopback SAN verifies — the trap
        assert unpinned.query_cluster() is not None
        # the pinned dial (CLI behavior) refuses alice-as-ctld
        with pytest.raises(grpc.RpcError):
            pinned.query_cluster()
    finally:
        pinned.close()
        unpinned.close()
        server.stop()
