"""The control plane end to end on the port, outcome for outcome against
the JAX package: every case of ``tests/test_ctld_e2e.py`` (submit ->
cycle -> dispatch -> status change -> free, over the simulated craned
cluster).

The JAX file's source runs twice: as it is, and with the JAX package's
name replaced by the port's, the scheduler placed on the CPU and the
JAX package's default solver (``"auto"``) in every config.  Each
run keeps the file's own assertions; the clusters that ``make_cluster``
built are recorded, and after the case every job's status, exit code,
requeue count, pending reason and node names, and every node's
availability, are compared between the two runs.
"""

import pathlib
import types

import numpy as np
import pytest

SRC = pathlib.Path(__file__).with_name("test_ctld_e2e.py").read_text()
BUILD = "JobScheduler(meta, config or SchedulerConfig())"
assert SRC.count(BUILD) == 1


def _load(port: bool):
    src = SRC
    if port:
        src = src.replace("cranesched_tpu", "cranesched_tpu_torch").replace(
            BUILD, "JobScheduler(meta, config or SchedulerConfig(), "
                   "device='cpu')")
    name = "port" if port else "jax"
    mod = types.ModuleType(f"ctld_e2e_{name}")
    exec(compile(src, f"test_ctld_e2e.py[{name}]", "exec"), mod.__dict__)
    if port:
        # the JAX package's default solver, "auto" (the C++ solver on the
        # CPU, as there); the port's own default is its kernel
        config = mod.SchedulerConfig
        mod.SchedulerConfig = lambda **kw: config(**{"solver": "auto",
                                                     **kw})
    built = []
    make = mod.make_cluster

    def make_cluster(*a, **kw):
        out = make(*a, **kw)
        built.append(out)
        return out

    mod.make_cluster = make_cluster
    mod.built = built
    return mod


JAX_MOD, PORT_MOD = _load(False), _load(True)
CASES = sorted(n for n in vars(JAX_MOD) if n.startswith("test_"))


def _outcome(built):
    out = []
    for meta, sched, _cluster in built:
        jobs = {}
        for table in (sched.pending, sched.running, sched.history):
            for jid in list(table):
                job = sched.job_info(jid)
                jobs[jid] = (job.status.name, job.exit_code,
                             job.requeue_count,
                             getattr(job.pending_reason, "name",
                                     str(job.pending_reason)),
                             [meta.nodes[n].name for n in job.node_ids])
        avail = {node.name: np.asarray(node.avail).tolist()
                 for node in meta.nodes.values()}
        out.append((sorted(jobs.items()), sorted(avail.items())))
    return out


@pytest.mark.parametrize("case", CASES)
def test_case_matches_jax(case):
    for mod in (JAX_MOD, PORT_MOD):
        mod.built.clear()
        getattr(mod, case)()
    assert PORT_MOD.built, "the case built no cluster"
    assert _outcome(PORT_MOD.built) == _outcome(JAX_MOD.built)
