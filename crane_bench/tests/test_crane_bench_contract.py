"""The benchmark's files against the rules they are written to: no JAX and
nothing of the JAX package anywhere under ``crane_bench/`` (and nothing of
the program under ``crane_bench/reference/``), ``BENCHMARK.json``'s names,
units and keys, and every name resolving to its file."""

from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from crane_bench import spec

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "crane_bench"
FORBIDDEN = {"jax", "jaxlib", "flax", "cranesched_tpu"}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|head)"
                   r"|_dim$|_rank$|expansion|per_tok", re.I)


def _imports(path: Path) -> set[str]:
    """Top-level names of every module the file imports."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    return sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_jax_anywhere(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & (FORBIDDEN | {"cranesched_tpu_torch"})
    # the reference may use only the standard library and numpy
    allowed = {"__future__", "numpy", "json", "re", "crane_bench"}
    assert _imports(path) <= allowed


def test_forbidden_check_compares_whole_names():
    from crane_bench.run import forbidden_modules

    assert "cranesched_tpu_torch" not in forbidden_modules()
    assert "cranesched_tpu" not in forbidden_modules()


def _bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_benchmark_keys_and_names():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(b["command"]) <= 32
    assert all(LINE.match(w) and not w.startswith("/") and ".." not in w
               for w in b["command"])
    assert b["paths"] == ["crane_bench"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"])
        assert LINE.match(c["why"]) and len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        assert c["file"].startswith("crane_bench/")
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert LINE.match(w["why"])
        names.append(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and LINE.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    assert len(names) == len(set(names))
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_cell_reports_its_metrics():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        got = [m["name"] for m in spec.metrics_for(b, w["name"], False)]
        assert "setup_s" in got and len(got) >= 2
        assert spec.metrics_for(b, w["name"], True)
    for m in b["per_layer"]:
        for cell in m.get("workloads", []):
            assert cell in e2e[m["moves"]].get("workloads", [cell])


@pytest.mark.parametrize("name", [m["name"] for m in _bench()["end_to_end"]
                                  + _bench()["per_layer"]])
def test_metric_reader_resolves(name):
    assert callable(spec.metric_reader(name))


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_workload_resolves(cell):
    b = _bench()
    w = spec.workload(b, cell)
    cfg = spec.load_config(b, w["config"])
    traffic = spec.load_traffic(w["traffic"])
    assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
    assert cfg["scheduler"]["schedule_batch_size"] >= cfg["pending"]
    steps = spec.load_cell(cell)
    assert steps["name"] == cell
    for trace in (False, True):
        assert spec.window_steps(steps, b["run_seconds"], trace) >= 10


@pytest.mark.parametrize("kind,doc", [
    ("traffic", {"name": "t", "step_s": 1.0, "settle_s": 900.0,
                 "warm_steps": 2, "submit_chunk": 1000,
                 "replenish": "started"}),
    ("config", {"name": "c", "wal": {"fsync": True, "archive": True}}),
    ("cell", {"name": "x.t", "step_wall_s": 1.0, "loop": "open"}),
])
def test_a_key_the_harness_does_not_act_on_is_refused(kind, doc, tmp_path,
                                                      monkeypatch):
    if kind == "config":
        (tmp_path / "c.json").write_text(json.dumps(doc))
        bench = {"configs": [{"name": "c", "file": "c.json"}]}
        with pytest.raises(ValueError, match="archive"):
            spec.load_config(bench, "c", root=tmp_path)
        return
    folder = {"traffic": "traffic", "cell": "cells"}[kind]
    (tmp_path / folder).mkdir()
    (tmp_path / folder / f"{doc['name']}.json").write_text(json.dumps(doc))
    monkeypatch.setattr(spec, "HERE", tmp_path)
    load = spec.load_traffic if kind == "traffic" else spec.load_cell
    with pytest.raises(ValueError, match="does not act on"):
        load(doc["name"])


def test_window_is_a_fixed_count_of_steps():
    cell = {"step_wall_s": 2.3, "traced_step_wall_s": 3.1}
    assert spec.window_steps(cell, 40, False) == 17
    assert spec.window_steps(cell, 40, True) == 13
    assert spec.window_steps(cell, 0.1, False) == 1


def test_files_under_paths_are_named_from_names():
    ok = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]*$")
    for p in BENCH_DIR.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        assert all(ok.match(part) for part in p.relative_to(ROOT).parts), p
