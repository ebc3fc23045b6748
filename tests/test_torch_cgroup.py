"""The port's cgroup v1/v2 backends (``cranesched_tpu_torch/craned/
cgroup.py``) against the JAX package's: the cases of
``tests/test_cgroup.py`` on fake cgroupfs trees under ``tmp_path``, each
run once per package, with the whole tree (every file and its value)
compared after create / freeze / destroy.  The two cases that need root
and a writable v1 devices hierarchy keep the JAX file's skip conditions.
"""

import os
import subprocess
import time
import types

import pytest

import cranesched_tpu.craned.cgroup as jcg
import cranesched_tpu_torch.craned.cgroup as tcg

JAX = types.SimpleNamespace(cg=jcg, name="jax")
PORT = types.SimpleNamespace(cg=tcg, name="port")


def _fake_v1_tree(S, root):
    for c in S.cg.CgroupV1.CONTROLLERS:
        os.makedirs(os.path.join(root, c), exist_ok=True)
    for ctl, val in (("cpuset.cpus", "0-7"), ("cpuset.mems", "0")):
        with open(os.path.join(root, "cpuset", ctl), "w") as fh:
            fh.write(val)
    return root


def _fake_v2_tree(root, controllers="cpu memory cpuset"):
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "cgroup.controllers"), "w") as fh:
        fh.write(controllers)
    return root


def _read(path):
    with open(path) as fh:
        return fh.read()


def _tree(root):
    """{relative path: content} of every file, plus every directory."""
    out = {}
    for dirpath, dirnames, filenames in os.walk(root):
        rel = os.path.relpath(dirpath, root)
        out[rel + "/"] = None
        for f in filenames:
            out[os.path.join(rel, f)] = _read(os.path.join(dirpath, f))
    return out


def _per_package(tmp_path, scenario):
    out = {}
    for S in (JAX, PORT):
        root = str(tmp_path / S.name)
        out[S.name] = scenario(S, root)
    assert out["port"] == out["jax"]
    return out["port"]


def test_detect_v2_vs_v1(tmp_path):
    def scenario(S, root):
        v2root = _fake_v2_tree(os.path.join(root, "v2"), "cpu memory")
        v1root = _fake_v1_tree(S, os.path.join(root, "v1"))
        got = (S.cg.make_cgroups(v2root).version,
               S.cg.make_cgroups(v1root).version,
               S.cg.make_cgroups(os.path.join(root, "absent")).enabled)
        assert got == (2, 1, False)
        return got
    _per_package(tmp_path, scenario)


def test_v1_create_writes_all_controllers(tmp_path):
    def scenario(S, root):
        _fake_v1_tree(S, root)
        cg = S.cg.CgroupV1(root)
        assert cg.enabled and cg.supports_devices and cg.supports_cpuset
        procs = cg.create(7, cpu=2.0, mem_bytes=1 << 30,
                          memsw_bytes=2 << 30, cpuset_cpus="0,1",
                          allow_devices=("c 195:0 rwm",))
        by_controller = {p.split(os.sep)[-4]: p for p in procs}
        assert set(by_controller) == {"cpu", "memory", "freezer",
                                      "cpuset", "devices"}
        d = os.path.join(root, "cpu", "crane", "job_7")
        assert _read(os.path.join(d, "cpu.cfs_quota_us")) == "200000"
        assert _read(os.path.join(d, "cpu.cfs_period_us")) == "100000"
        m = os.path.join(root, "memory", "crane", "job_7")
        assert _read(os.path.join(m, "memory.limit_in_bytes")) == \
            str(1 << 30)
        assert _read(os.path.join(m, "memory.memsw.limit_in_bytes")) == \
            str(2 << 30)
        cs = os.path.join(root, "cpuset", "crane", "job_7")
        assert _read(os.path.join(cs, "cpuset.cpus")) == "0,1"
        assert _read(os.path.join(cs, "cpuset.mems")) == "0"
        dv = os.path.join(root, "devices", "crane", "job_7")
        assert _read(os.path.join(dv, "devices.deny")) == "a"
        assert _read(os.path.join(dv, "devices.allow")) == "c 195:0 rwm"
        return sorted(os.path.relpath(p, root) for p in procs), _tree(root)
    _per_package(tmp_path, scenario)


def test_v1_no_device_map_means_no_acl(tmp_path):
    def scenario(S, root):
        _fake_v1_tree(S, root)
        procs = S.cg.CgroupV1(root).create(3, cpu=1.0, allow_devices=None)
        assert not any("devices" in p.split(os.sep) for p in procs)
        assert not os.path.isdir(
            os.path.join(root, "devices", "crane", "job_3"))
        return sorted(os.path.relpath(p, root) for p in procs), _tree(root)
    _per_package(tmp_path, scenario)


def test_v1_freeze_and_destroy(tmp_path):
    def scenario(S, root):
        _fake_v1_tree(S, root)
        cg = S.cg.CgroupV1(root)
        cg.create(9, cpu=1.0)
        assert cg.freeze(9, True)
        frozen = _tree(root)
        assert frozen[os.path.join("freezer", "crane", "job_9",
                                   "freezer.state")] == "FROZEN"
        assert cg.freeze(9, False)
        thawed = _tree(root)
        assert cg.destroy(9)
        for c in S.cg.CgroupV1.CONTROLLERS:
            assert not os.path.isdir(os.path.join(root, c, "crane",
                                                  "job_9"))
        return frozen, thawed, _tree(root)
    _per_package(tmp_path, scenario)


def test_v2_cpuset_and_kill_teardown(tmp_path):
    def scenario(S, root):
        _fake_v2_tree(root)
        cg = S.cg.CgroupV2(root)
        procs = cg.create(5, cpu=1.5, mem_bytes=1 << 30,
                          memsw_bytes=2 << 30, cpuset_cpus="2-3")
        assert len(procs) == 1
        d = os.path.join(root, "crane", "job_5")
        assert _read(os.path.join(d, "cpuset.cpus")) == "2-3"
        created = _tree(root)
        assert cg.freeze(5, True)
        frozen = _tree(root)
        assert cg.destroy(5)
        assert not os.path.isdir(d)
        return ([os.path.relpath(p, root) for p in procs], created,
                frozen, _tree(root))
    _per_package(tmp_path, scenario)


def test_write_pid_to_cgroup_matches(tmp_path):
    def scenario(S, root):
        _fake_v2_tree(root)
        procs = S.cg.CgroupV2(root).create(11, cpu=1.0)
        S.cg.write_pid_to_cgroup(procs, 4242)
        return _tree(root)
    tree = _per_package(tmp_path, scenario)
    assert tree[os.path.join("crane", "job_11", "cgroup.procs")] == "4242"


REAL_DEV = "/sys/fs/cgroup/devices"
_REAL_OK = (os.path.isdir(REAL_DEV) and os.access(REAL_DEV, os.W_OK)
            and os.geteuid() == 0)


@pytest.mark.skipif(
    not (_REAL_OK and os.path.exists("/dev/loop0")
         and os.path.exists("/dev/loop1")),
    reason="needs root + v1 devices hierarchy + loop devices")
def test_daemon_enforces_gres_device_isolation(tmp_path):
    """A job holding GRES slot 0 (backed by /dev/loop0) can open its
    own device but is kernel-denied the slot it does not hold, through
    the port's node plane."""
    from cranesched_tpu_torch.craned.daemon import CranedDaemon, CranedState
    from cranesched_tpu_torch.ctld import (
        JobScheduler,
        JobSpec,
        JobStatus,
        MetaContainer,
        ResourceSpec,
        SchedulerConfig,
    )
    from cranesched_tpu_torch.ops.resources import ResourceLayout
    from cranesched_tpu_torch.rpc import serve
    from cranesched_tpu_torch.rpc.dispatcher import GrpcDispatcher

    meta = MetaContainer(
        layout=ResourceLayout.from_gres_names([("gpu", "")]))
    sched = JobScheduler(meta, SchedulerConfig(backfill=False),
                         device="cpu")
    dispatcher = GrpcDispatcher(sched)
    dispatcher.wire(sched)
    server, port = serve(sched, cycle_interval=0.15,
                         dispatcher=dispatcher)
    d = CranedDaemon(
        "gn0", f"127.0.0.1:{port}", cpu=4.0, mem_bytes=4 << 30,
        workdir=str(tmp_path), ping_interval=0.5,
        cgroup_root="/sys/fs/cgroup", gres={("gpu", ""): 2},
        gres_devices={"gpu": ["/dev/loop0", "/dev/loop1"]})
    d.start()
    try:
        deadline = time.time() + 15
        while time.time() < deadline and d.state != CranedState.READY:
            time.sleep(0.05)
        assert d.state == CranedState.READY
        out = tmp_path / "probe_%j.txt"
        script = (
            "sleep 0.3\n"
            "head -c0 /dev/loop$CRANE_GRES_GPU 2>/dev/null "
            "&& echo MINE-OK || echo MINE-FAIL\n"
            "other=$((1-CRANE_GRES_GPU))\n"
            "head -c1 /dev/loop$other 2>/dev/null "
            "&& echo LEAK || echo DENIED\n")
        jid = sched.submit(JobSpec(
            res=ResourceSpec(cpu=1.0, gres={("gpu", ""): 1}),
            script=script, output_path=str(out)), now=time.time())
        deadline = time.time() + 20
        while time.time() < deadline:
            j = sched.job_info(jid)
            if j is not None and j.status == JobStatus.COMPLETED:
                break
            time.sleep(0.05)
        text = (tmp_path / f"probe_{jid}.txt").read_text()
        assert "MINE-OK" in text, text
        assert "DENIED" in text and "LEAK" not in text, text
    finally:
        d.stop()
        dispatcher.close()
        server.stop()


@pytest.mark.skipif(not _REAL_OK,
                    reason="needs root + a writable v1 devices hierarchy")
def test_real_kernel_device_denial():
    """A process inside a crane job cgroup with deny-all (+ /dev/null)
    cannot open a denied device node; the port's backend tears it
    down."""
    cg = tcg.CgroupV1("/sys/fs/cgroup")
    job_id = 987655
    try:
        d = os.path.join(REAL_DEV, "crane", f"job_{job_id}")
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "devices.deny"), "w") as fh:
            fh.write("a")
        with open(os.path.join(d, "devices.allow"), "w") as fh:
            fh.write("c 1:3 rwm")
        probe = ("import os\n"
                 f"open('{os.path.join(d, 'cgroup.procs')}','w')"
                 ".write(str(os.getpid()))\n"
                 "open('/dev/null','rb').read(0)\n"
                 "try:\n"
                 "    open('/dev/urandom','rb').read(1)\n"
                 "    print('OPENED')\n"
                 "except PermissionError:\n"
                 "    print('DENIED')\n")
        out = subprocess.run(["python3", "-c", probe],
                             capture_output=True, text=True, timeout=30)
        assert "DENIED" in out.stdout, (out.stdout, out.stderr)
    finally:
        cg.destroy(job_id)
