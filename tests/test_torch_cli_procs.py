"""The port's ``crane`` commands as processes of their own, against the
JAX package's: ``python -m <package>.cli`` run as a subprocess.

- ``tests/test_gres_crun.py:144``: ``crun`` streams a real step's output
  over the embedded CraneFored hub from a craned of the same package,
  and the step's exit code becomes the command's.
- ``tests/test_utils_native.py:122``: ``ctld_main`` (the port's with
  ``--device cpu``) and ``craned_main`` as processes, driven by
  ``cinfo``, ``cbatch`` and ``cacct`` subprocesses until two real jobs
  complete.

Each case runs once per package and the records are compared: exit
codes and what the commands print (no field is masked: every value
printed is a job id, a node name, a state or an exit code).  The port's
commands also load no torch: one of them runs through a ``python -c``
wrapper that reports whether ``torch`` is in ``sys.modules`` after
``cli.main``.
"""

import os
import pathlib
import subprocess
import sys
import time
import types

import cranesched_tpu.craned.daemon as jdaemon
import cranesched_tpu.ctld as jctld
import cranesched_tpu.rpc as jrpc
import cranesched_tpu.rpc.dispatcher as jdisp
import cranesched_tpu_torch.craned.daemon as tdaemon
import cranesched_tpu_torch.ctld as tctld
import cranesched_tpu_torch.rpc as trpc
import cranesched_tpu_torch.rpc.dispatcher as tdisp

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX = types.SimpleNamespace(
    name="jax", pkg="cranesched_tpu", ctld=jctld, rpc=jrpc, disp=jdisp,
    daemon=jdaemon, kw={}, ctld_args=())
PORT = types.SimpleNamespace(
    name="port", pkg="cranesched_tpu_torch", ctld=tctld, rpc=trpc,
    disp=tdisp, daemon=tdaemon, kw={"device": "cpu"},
    ctld_args=("--device", "cpu"))
ENV = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))


def both(scenario, *args):
    jrec = scenario(JAX, *args)
    trec = scenario(PORT, *args)
    assert trec == jrec
    return trec


def crane(P, addr, *argv, **kw):
    return subprocess.run(
        [sys.executable, "-m", f"{P.pkg}.cli", "--server", addr, *argv],
        capture_output=True, text=True, env=ENV, cwd=REPO, timeout=60,
        stdin=subprocess.DEVNULL, **kw)


def test_crun_streams_real_output(tmp_path):
    def scenario(P):
        tmp = tmp_path / P.name
        tmp.mkdir()
        sched = P.ctld.JobScheduler(
            P.ctld.MetaContainer(), P.ctld.SchedulerConfig(backfill=False),
            **P.kw)
        dispatcher = P.disp.GrpcDispatcher(sched)
        dispatcher.wire(sched)
        server, port = P.rpc.serve(sched, cycle_interval=0.15,
                                   dispatcher=dispatcher)
        d = P.daemon.CranedDaemon("crn0", f"127.0.0.1:{port}", cpu=4.0,
                                  mem_bytes=4 << 30, workdir=str(tmp),
                                  ping_interval=0.3,
                                  cgroup_root=str(tmp / "nocg"))
        d.start()
        try:
            deadline = time.time() + 10
            while (d.state != P.daemon.CranedState.READY
                   and time.time() < deadline):
                time.sleep(0.05)
            r = crane(P, f"127.0.0.1:{port}", "crun",
                      "echo streamed-$CRANE_JOB_ID; exit 4", "--cpu", "1")
            assert "streamed-1" in r.stdout
            assert r.returncode == 4
            return r.returncode, r.stdout
        finally:
            d.stop()
            dispatcher.close()
            server.stop()
    both(scenario)


_NO_TORCH = ("import sys\n"
             "from {pkg} import cli\n"
             "rc = cli.main(sys.argv[1:])\n"
             "print('torch loaded:', 'torch' in sys.modules)\n"
             "sys.exit(rc)\n")


def test_ctld_main_and_craned_main_end_to_end(tmp_path):
    def scenario(P):
        tmp = tmp_path / P.name
        tmp.mkdir()
        cfg = tmp / "config.yaml"
        cfg.write_text(f"""
ClusterName: t
Listen: 127.0.0.1:0
Wal: {tmp}/ctld.wal
Partitions: [{{name: default}}]
""")
        ctld = subprocess.Popen(
            [sys.executable, "-m", f"{P.pkg}.ctld_main", "-c", str(cfg),
             "--cycle-interval", "0.2", *P.ctld_args],
            stdout=subprocess.PIPE, text=True, env=ENV, cwd=REPO)
        rec = []
        try:
            line = ctld.stdout.readline()
            port = int(line.split("port")[1].split()[0])
            addr = f"127.0.0.1:{port}"
            craned = subprocess.Popen(
                [sys.executable, "-m", f"{P.pkg}.craned_main",
                 "--name", "mn0", "--ctld", addr,
                 "--cpu", "4", "--memory", "4G", "--workdir", str(tmp),
                 "--ping-interval", "0.5",
                 "--cgroup-root", str(tmp / "nocg")],
                stdout=subprocess.PIPE, text=True, env=ENV, cwd=REPO)
            try:
                deadline = time.time() + 30
                while time.time() < deadline:
                    q = crane(P, addr, "cinfo")
                    if "mn0" in q.stdout:
                        break
                    time.sleep(0.3)
                assert "mn0" in q.stdout, \
                    f"craned never registered:\n{q.stdout}"
                for _ in range(2):
                    r = crane(P, addr, "cbatch", "--cpu", "1")
                    rec.append((r.returncode, r.stdout))
                assert rec[0][1] == "Submitted batch job 1\n"
                deadline = time.time() + 30
                done = False
                while time.time() < deadline:
                    q = crane(P, addr, "cacct")
                    if q.stdout.count("Completed") >= 2:
                        done = True
                        break
                    time.sleep(0.5)
                assert done, f"jobs never completed; last cacct:\n{q.stdout}"
                # the wall column of a real run is its own
                rec.append([row.split()[:5]
                            for row in q.stdout.splitlines()])
                w = subprocess.run(
                    [sys.executable, "-c", _NO_TORCH.format(pkg=P.pkg),
                     "--server", addr, "cqueue", "--history"],
                    capture_output=True, text=True, env=ENV, cwd=REPO,
                    timeout=60)
                assert w.returncode == 0, w.stderr
                rec.append(w.stdout.splitlines()[:-1])
                if P is PORT:
                    assert w.stdout.splitlines()[-1] == \
                        "torch loaded: False"
            finally:
                craned.terminate()
                craned.wait(timeout=10)
        finally:
            ctld.terminate()
            ctld.wait(timeout=10)
        return rec
    both(scenario)
