"""The port stands alone: it imports neither JAX nor the JAX package.

A subprocess installs a ``sys.meta_path`` finder that refuses ``jax``,
``jaxlib``, ``flax`` and the top-level ``cranesched_tpu`` (not
``cranesched_tpu_torch``), imports every module of the port and runs a
16-node scheduling cycle on the CPU.  ``chip_smoke.py`` is checked by an
AST scan of its imports.
"""

import ast
import pathlib
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "cranesched_tpu_torch"
BLOCKED = ("jax", "jaxlib", "flax", "cranesched_tpu")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


_CHILD = textwrap.dedent("""
    import importlib, sys

    BLOCKED = {blocked!r}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked import: " + name)
            return None

    for name in list(sys.modules):
        if name.split(".")[0] in BLOCKED:
            del sys.modules[name]
    sys.meta_path.insert(0, Refuse())

    for mod in {mods!r}:
        importlib.import_module(mod)

    from cranesched_tpu_torch.craned.sim import SimCluster
    from cranesched_tpu_torch.ctld import (JobScheduler, JobSpec,
        MetaContainer, ResourceSpec, SchedulerConfig)

    meta = MetaContainer()
    for i in range(16):
        meta.add_node("n%d" % i, meta.layout.encode(
            cpu=8, mem_bytes=16 << 30, memsw_bytes=16 << 30,
            is_capacity=True), partitions=("p%d" % (i % 2),))
        meta.craned_up(i)
    sched = JobScheduler(meta, SchedulerConfig(backfill=False),
                         device="cpu")
    sim = SimCluster(sched)
    sim.wire(sched)
    for j in range(40):
        assert sched.submit(JobSpec(
            res=ResourceSpec(cpu=2.0, mem_bytes=1 << 30),
            partition="p%d" % (j % 2), node_num=1 + j % 2,
            sim_runtime=30.0), now=0.0) > 0
    started = sched.schedule_cycle(now=1.0)
    assert started, "nothing placed"
    end = sim.run_until_drained(start=2.0)
    assert not sched.pending and not sched.running
    assert all((n.avail == n.total).all() for n in meta.nodes.values())
    leaked = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    assert not leaked, leaked
    print("OK", len(started), end)
""")


def test_port_imports_without_jax_and_runs_a_cycle():
    mods = _port_modules()
    assert "cranesched_tpu_torch.ctld.scheduler" in mods
    assert "cranesched_tpu_torch.models.gpu_solver" in mods
    code = _CHILD.format(blocked=BLOCKED, mods=mods)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("OK")


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_chip_smoke_imports_nothing_of_jax():
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert "cranesched_tpu_torch" in roots
    assert not roots & set(BLOCKED), roots & set(BLOCKED)


def test_port_sources_import_nothing_of_jax():
    for path in PORT.rglob("*.py"):
        bad = _imported_roots(path) & set(BLOCKED)
        assert not bad, f"{path}: {bad}"
