"""The real craned's features on the port, case for case with the JAX
package: the real-craned cases of ``test_hooks.py``,
``test_health_power_stats.py:115-200``, ``test_modify_job.py``,
``test_gres_crun.py:84-143``, ``test_container_steps.py``
(``_child_argv`` always; the runtime cases under the JAX file's skips),
``test_job_trace.py:203-269`` (node-side spans stitched across ctld and
craned), ``test_obs.py:303`` (the craned's metrics) and
``test_tls.py::test_real_plane_all_tls``.

Each JAX file's source is loaded twice: as it is, and with the JAX
package's name replaced by the port's and every scheduler and config
build placed on the CPU.  A case runs the JAX function, then the port's,
each in a directory of its own with its fixtures built afresh; both are
held to the file's own assertions (statuses, exit codes, output
contents, hook drains, spans, metric series).  The schedulers each run
built are recorded, and once the case and its fixtures are done, every
job's status, exit code, requeue count and node names, its steps'
records and its output file (the run's directory masked), and every
node's liveness, drain flags, power state and free resources, are
compared between the two runs; wall-clock fields by type.  A skip mark or an
``importorskip`` of the JAX file skips the case as it does there.
"""

import contextlib
import inspect
import pathlib

import numpy as np
import pytest

HERE = pathlib.Path(__file__).parent

CASES = {
    "hooks": [
        "test_prolog_and_epilog_run_around_the_step",
        "test_failing_prolog_fails_step_and_drains_node",
        "test_failing_epilog_drains_but_preserves_job_outcome",
        "test_node_events_fan_out",
        "test_chatty_hooks_cannot_corrupt_the_report_protocol",
        "test_operator_resume_clears_hook_drain",
    ],
    "health_power_stats": [
        "test_real_craned_health_program",
        "test_step_usage_flows_to_ceff_data",
    ],
    "modify_job": [
        "test_real_supervisor_survives_old_deadline_after_extension",
        "test_real_supervisor_still_enforces_new_deadline",
    ],
    "gres_crun": ["test_gres_slot_identity_and_env_injection"],
    "container_steps": [
        "test_child_argv_contract",
        "test_batch_container_job",
        "test_interactive_container_streams_through_cfored",
        "test_cattach_overlap_step",
        "test_container_without_runtime_fails_cleanly",
    ],
    "job_trace": ["test_grpc_propagation_craned_spans_merge"],
    "obs": ["test_craned_daemon_metrics"],
    "tls": ["test_real_plane_all_tls"],
}


def _recorded(built, port):
    """A wrapper of a scheduler class that records each instance in
    ``built``; the port's instances default to the CPU."""
    def wrap(cls):
        def make(*args, **kw):
            if port:
                kw.setdefault("device", "cpu")
            sched = cls(*args, **kw)
            built.append(sched)
            return sched
        return make
    return wrap


def _load(stem: str, port: bool):
    """The namespace of ``tests/test_<stem>.py`` (the port's variant when
    ``port``), or the skip that its import raised.  ``_built`` in it
    lists the schedulers that the file's ``JobScheduler(...)`` calls
    made."""
    src = (HERE / f"test_{stem}.py").read_text()
    src = src.replace("JobScheduler(", "_recorded(JobScheduler)(")
    if port:
        src = (src.replace("cranesched_tpu", "cranesched_tpu_torch")
                  .replace(".build()", ".build(device='cpu')"))
    built = []
    ns = {"__name__": f"{'port' if port else 'jax'}_{stem}",
          "__file__": str(HERE / f"test_{stem}.py"),
          "_recorded": _recorded(built, port), "_built": built}
    try:
        exec(compile(src, f"test_{stem}.py[{'port' if port else 'jax'}]",
                     "exec"), ns)
    except pytest.skip.Exception as exc:
        return exc
    return ns


MODULES = {stem: {False: _load(stem, False), True: _load(stem, True)}
           for stem in CASES}


def _skip_marks(fn):
    for mark in getattr(fn, "pytestmark", []):
        if mark.name == "skipif" and mark.args and mark.args[0]:
            pytest.skip(mark.kwargs.get("reason", "skipif"))
        if mark.name == "skip":
            pytest.skip(mark.kwargs.get("reason", "skip"))


def _wall(value):
    """A wall-clock field, compared by type."""
    return type(value).__name__


def _outcome(built, tmp_path):
    """Every job of every scheduler in ``built``: status, exit code,
    requeue count, node names, its steps' records and its output file's
    text with ``tmp_path`` masked; and every node's liveness, drain
    flags, power state and free resources."""
    out = []
    for sched in built:
        names = {i: n.name for i, n in sched.meta.nodes.items()}
        jobs = {}
        for table in (sched.pending, sched.running, sched.history):
            for jid in list(table):
                job = sched.job_info(jid)
                steps = [(sid, st.status.name, st.exit_code,
                          [names[n] for n in st.node_ids],
                          st.cancel_requested, _wall(st.start_time),
                          _wall(st.end_time))
                         for sid, st in sorted(job.steps.items())]
                text = None
                if job.spec.output_path:
                    path = pathlib.Path(job.spec.output_path.replace(
                        "%j", str(jid)))
                    if path.is_file():
                        text = path.read_text(errors="replace").replace(
                            str(tmp_path), "<tmp>")
                jobs[jid] = (job.status.name, job.exit_code,
                             job.requeue_count,
                             [names[n] for n in job.node_ids], steps, text)
        nodes = [(n.name, n.alive, n.drained, n.health_drained,
                  n.power_state, np.asarray(n.avail).tolist())
                 for n in sched.meta.nodes.values()]
        out.append((sorted(jobs.items()), nodes))
    return out


def _run(ns, name, tmp_path, tmp_path_factory):
    """Call the case with its fixtures (``tmp_path``, the file's own)
    built as pytest would, and torn down after it; returns its
    outcome (``_outcome``)."""
    fn = ns[name]
    _skip_marks(fn)
    tmp_path.mkdir(parents=True, exist_ok=True)
    ns["_built"].clear()
    cache = {}
    with contextlib.ExitStack() as stack:
        def resolve(arg):
            if arg == "tmp_path":
                return tmp_path
            if arg == "tmp_path_factory":
                return tmp_path_factory
            if arg not in cache:
                fixture = ns[arg]
                func = getattr(fixture, "__wrapped__", fixture)
                value = func(*[resolve(a) for a in
                               inspect.signature(func).parameters])
                if inspect.isgenerator(value):
                    gen = value
                    value = next(gen)
                    stack.callback(next, gen, None)
                cache[arg] = value
            return cache[arg]

        fn(*[resolve(a) for a in inspect.signature(fn).parameters])
    return _outcome(ns["_built"], tmp_path)


@pytest.mark.parametrize(
    "stem,name", [(stem, name) for stem, names in CASES.items()
                  for name in names],
    ids=[f"{stem}-{name[5:]}" for stem, names in CASES.items()
         for name in names])
def test_case_on_both_packages(stem, name, tmp_path, tmp_path_factory):
    outcomes = []
    for port in (False, True):
        ns = MODULES[stem][port]
        if isinstance(ns, pytest.skip.Exception):
            pytest.skip(str(ns))
        outcomes.append(_run(ns, name, tmp_path / ("port" if port
                                                   else "jax"),
                             tmp_path_factory))
    jax, port = outcomes
    assert port == jax


def test_port_variants_reach_no_jax_module():
    """The port's variant of each file names the port's modules only."""
    for stem in CASES:
        ns = MODULES[stem][True]
        if isinstance(ns, pytest.skip.Exception):
            continue
        for value in ns.values():
            module = getattr(value, "__module__", "") or ""
            assert not module.startswith("cranesched_tpu."), (stem, value)
