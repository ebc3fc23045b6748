"""The ssh-to-node gate on the port's craned: the daemon's line protocol
on its root-only unix socket (ACCESS / ADOPT) and ``native/pam_crane.c``,
the C client, built as it is with gcc.  The cases of
``tests/test_pam_gate.py``, each run on a JAX plane and on a port plane
(``test_torch_node_plane.Stack``) over a fake cgroup v1 tree, with the
replies, the adopted pid's cgroup file and the helper's exit codes
compared."""

import os
import shutil
import socket
import subprocess
import tempfile
import time

import pytest

import cranesched_tpu.craned.cgroup as jcg
import cranesched_tpu_torch.craned.cgroup as tcg
from test_torch_node_plane import both, wait_for

CGROUP = {"jax": jcg, "port": tcg}

PAM_SRC = os.path.join(os.path.dirname(__file__), os.pardir,
                       "native", "pam_crane.c")
CONFIG = dict(backfill=False, craned_timeout=30.0)


@pytest.fixture(scope="module")
def pam_helper(tmp_path_factory):
    if shutil.which("gcc") is None:
        pytest.skip("no C compiler for the PAM helper")
    out = str(tmp_path_factory.mktemp("pam") / "crane_pam_helper")
    subprocess.run(["gcc", "-O2", "-o", out, PAM_SRC],
                   check=True, timeout=120)
    return out


def _fake_v1_tree(cg_module, root):
    for c in cg_module.CgroupV1.CONTROLLERS:
        os.makedirs(os.path.join(root, c), exist_ok=True)
    for ctl, val in (("cpuset.cpus", "0-3"), ("cpuset.mems", "0")):
        with open(os.path.join(root, "cpuset", ctl), "w") as fh:
            fh.write(val)
    return root


def _ask(sock_path: str, request: str) -> str:
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(sock_path)
    s.sendall(request.encode())
    data = b""
    while chunk := s.recv(4096):
        data += chunk
    s.close()
    return data.decode()


def _gate(st):
    """A craned on a fake cgroup v1 tree with its PAM socket up, and a
    running job of alice's on it."""
    cgroot = _fake_v1_tree(CGROUP[st.craned_pkg.name],
                           str(st.tmp_path / "cg"))
    # the socket lives in the workdir, and a unix socket's path has at
    # most 107 bytes: a short directory beside the test's
    workdir = tempfile.mkdtemp(prefix="pam", dir=st.tmp_path.parent.parent)
    d = st.add_craned("pg0", cgroup_root=cgroot, workdir=workdir)
    assert st.ready(d)
    assert d.pam_socket, "pam socket did not come up"
    jid = st.sched.submit(st.S.ctld.JobSpec(
        user="alice", res=st.S.ctld.ResourceSpec(cpu=1.0),
        script="sleep 60", time_limit=120), now=time.time())
    assert wait_for(lambda: jid in st.sched.running
                    and st.sched.running[jid].status.name == "RUNNING"
                    and st.sched.running[jid].steps)
    # the allocation lands on the craned just before RUNNING shows
    assert wait_for(lambda: _ask(d.pam_socket, "ACCESS alice\n")
                    == f"OK {jid}\n")
    return d, jid, cgroot


def _access(st):
    d, jid, _ = _gate(st)
    replies = [_ask(d.pam_socket, req) for req in
               ("ACCESS alice\n", "ACCESS mallory\n", "garbage\n")]
    assert replies[0] == f"OK {jid}\n"
    assert replies[1].startswith("DENY") and replies[2].startswith("DENY")
    return replies


def test_access_gated_by_job_ownership(tmp_path):
    jax, port = both(_access, tmp_path, config=CONFIG)
    assert port == jax


def _adopt(st):
    d, jid, cgroot = _gate(st)
    probe = subprocess.Popen(["sleep", "30"])
    try:
        lines = _ask(d.pam_socket,
                     f"ADOPT alice {probe.pid}\n").splitlines()
        assert lines[0] == f"OK {jid}" and lines[-1] == "END"
        env = dict(line[4:].split("=", 1) for line in lines[1:-1]
                   if line.startswith("ENV "))
        assert env.get("CRANE_JOB_NAME") is not None
        procs = os.path.join(cgroot, "cpu", "crane", f"job_{jid}",
                             "cgroup.procs")
        with open(procs) as fh:
            assert fh.read().strip() == str(probe.pid)
        return lines[0], lines[-1], sorted(env)
    finally:
        probe.kill()


def test_adopt_moves_pid_into_job_cgroup(tmp_path):
    jax, port = both(_adopt, tmp_path, config=CONFIG)
    assert port == jax


def test_pam_exec_helper_binary(tmp_path, pam_helper):
    """The C client end to end, as pam_exec invokes it, against both
    packages' craneds."""
    def scenario(st):
        d, _, _ = _gate(st)

        def helper(user, ptype="account"):
            # under an intermediate parent: on open_session the helper
            # adopts getppid() into the job cgroup
            return subprocess.run(
                ["sh", "-c", '"$1" "$2"; exit $?', "sshd-standin",
                 pam_helper, d.pam_socket],
                env={"PAM_USER": user, "PAM_TYPE": ptype},
                timeout=10).returncode

        codes = [helper("alice"), helper("mallory"), helper("root"),
                 helper("alice", "open_session")]
        assert codes == [0, 1, 0, 0]
        return codes

    jax, port = both(scenario, tmp_path, config=CONFIG)
    assert port == jax


@pytest.mark.parametrize("workdir,alias", [(None, True), ("own", False)])
def test_craned_main_publishes_the_alias_on_the_default_workdir_only(
        tmp_path, monkeypatch, workdir, alias):
    """C5: ``/var/run/crane/pam.sock`` is one path for the whole host, so
    only a craned on the default workdir links it; one on a workdir of
    its own keeps its socket there."""
    import cranesched_tpu_torch.craned.daemon as daemon
    from cranesched_tpu_torch import craned_main

    seen = {}

    class Stop(Exception):
        pass

    class Recorder:
        def __init__(self, *args, **kwargs):
            seen.update(kwargs)
            raise Stop

    monkeypatch.setattr(daemon, "CranedDaemon", Recorder)
    argv = ["--name", "n0", "--ctld", "127.0.0.1:1"]
    if workdir:
        argv += ["--workdir", str(tmp_path / workdir)]
    with pytest.raises(Stop):
        craned_main.main(argv)
    assert seen["pam_alias"] is alias
    assert seen["workdir"] == (str(tmp_path / workdir) if workdir
                               else "/tmp")
