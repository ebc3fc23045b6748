"""``BENCHMARK.json`` and the files it names, found by name.

A cell ``<config>.<traffic>`` reads ``configs/<config>.json``,
``traffic/<traffic>.json`` and ``cells/<config>.<traffic>.json`` (how many
steps its window takes); a metric ``<name>`` is read by
``metrics/<name>.py``, whose ``read(ctx)`` returns a number or None (nothing
to read in this run).  Adding a cell or a metric adds files and entries; no
file here changes.

A file that sets a key the harness does not act on is refused, so that no
file can say what the run does not do.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json", encoding="utf-8") as fh:
        return json.load(fh)


def workload(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


# the keys each kind of file may set: those the harness acts on, and the
# ones that only describe (name, source, why, ...)
CONFIG_KEYS = {"name", "source", "deployment", "nodes", "partitions",
               "pending", "node_cpu", "node_mem_gib", "job_cpu",
               "job_mem_gib", "job_nodes", "time_limit_s", "runtime_s",
               "scheduler", "priority_weights", "wal", "guarantees",
               "assumed"}
WAL_KEYS = {"fsync", "setup_group_jobs"}
TRAFFIC_KEYS = {"name", "step_s", "settle_s", "warm_steps", "submit_chunk",
                "why"}
CELL_KEYS = {"name", "step_wall_s", "traced_step_wall_s", "why"}


def _load(path: Path, allowed: set) -> dict:
    with open(path, encoding="utf-8") as fh:
        doc = json.load(fh)
    unknown = set(doc) - allowed
    if unknown:
        raise ValueError(f"{path.name}: keys the harness does not act on: "
                         f"{sorted(unknown)}")
    return doc


def load_config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for cfg in bench["configs"]:
        if cfg["name"] == name:
            doc = _load(root / cfg["file"], CONFIG_KEYS)
            unknown = set(doc["wal"]) - WAL_KEYS
            if unknown:
                raise ValueError(f"{name}: WAL keys the harness does not act "
                                 f"on: {sorted(unknown)}")
            return doc
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def load_traffic(name: str) -> dict:
    return _load(HERE / "traffic" / f"{name}.json", TRAFFIC_KEYS)


def load_cell(name: str) -> dict:
    """``cells/<name>.json``: the wall time of one step, by which the
    window's fixed count of steps is sized (untraced and traced)."""
    return _load(HERE / "cells" / f"{name}.json", CELL_KEYS)


def window_steps(cell: dict, seconds: float, trace: bool) -> int:
    """The window's steps: ``seconds`` over the cell's step wall time,
    rounded, at least 1.  Every run of a cell at one length does the same
    steps, so every run of a seed does the same work."""
    step = cell["traced_step_wall_s" if trace else "step_wall_s"]
    return max(1, round(float(seconds) / float(step)))


def metric_reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    mod_name = "crane_bench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``trace`` off, its per-layer metrics with it on."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell])
            and m["moves"] in reported]
